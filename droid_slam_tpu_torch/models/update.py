"""Update operator: ConvGRU + flow/confidence heads + graph aggregation
(PyTorch).

Counterpart of the JAX package's ``models/update.py``, with the same module
names (so parameters carry across by name) and the same channel orders: GRU
input concat [ctx, corr, flow], upsample-mask channels k*64 + i*8 + j.
The heads' ``delta``, ``weight`` and ``eta`` pass through :func:`grad_clip`
(the identity forward), as in the JAX package.
Public tensors are NHWC; the convolutions run NCHW inside. The
computation dtype is the dtype of the module's parameters (``.to(dtype)``);
delta, weight and eta come back float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_sum

Tensor = torch.Tensor

GRAD_CLIP = 0.01


class GradClip(torch.autograd.Function):
    """Identity forward; the backward zeroes gradient entries with
    |g| > 0.01 or NaN (reference modules/clipping.py:7-17, the JAX
    package's ``models/update.py::grad_clip``): the stabiliser that lets
    gradients flow back through the unrolled BA iterations."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        bad = (g.abs() > GRAD_CLIP) | torch.isnan(g)
        return torch.where(bad, torch.zeros_like(g), g)


def grad_clip(x: Tensor) -> Tensor:
    return GradClip.apply(x)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """Stride-1 conv with SAME padding (flax's default)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class ConvGRU(nn.Module):
    """3×3 gated conv update with a global-context path (modules/gru.py:24-29):
    a sigmoid-gated spatial mean of the hidden state feeds 1×1 convs added to
    every gate pre-activation. NCHW."""

    def __init__(self, h_planes: int = 128, i_planes: int = 128 + 128 + 64):
        super().__init__()
        h = h_planes
        self.w = _conv(h, h, 1)
        self.convz = _conv(h + i_planes, h, 3)
        self.convz_glo = _conv(h, h, 1)
        self.convr = _conv(h + i_planes, h, 3)
        self.convr_glo = _conv(h, h, 1)
        self.convq = _conv(h + i_planes, h, 3)
        self.convq_glo = _conv(h, h, 1)

    def forward(self, net: Tensor, inp: Tensor) -> Tensor:
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)

        net_inp = torch.cat([net, inp], dim=1)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1)) + self.convq_glo(glo))
        return (1.0 - z) * net + z * q


def cvx_upsample(data: Tensor, mask: Tensor) -> Tensor:
    """Convex 8× upsampling of 1/8-resolution fields (droid_net.py:22-36).

    data [B, ht, wd, dim]; mask [B, ht, wd, 9*8*8] with channel index
    k*64 + i*8 + j → [B, 8*ht, 8*wd, dim].
    """
    b, ht, wd, dim = data.shape
    mask = torch.softmax(mask.reshape(b, ht, wd, 9, 8, 8), dim=3)
    pad = F.pad(data, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack(
        [pad[:, dy : dy + ht, dx : dx + wd, :] for dy in range(3) for dx in range(3)],
        dim=3,
    )  # [B, ht, wd, 9, dim]
    up = torch.einsum("bhwkij,bhwkd->bhwijd", mask, nbrs)
    up = up.permute(0, 1, 3, 2, 4, 5)  # [B, ht, 8, wd, 8, dim]
    return up.reshape(b, 8 * ht, 8 * wd, dim)


def upsample_disp(disp: Tensor, mask: Tensor) -> Tensor:
    """disp [B, ht, wd] → [B, 8ht, 8wd] (droid_net.py:38-42)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]


class GraphAgg(nn.Module):
    """Per-source-keyframe aggregation of the GRU hidden states
    (droid_net.py:45-76): scatter-mean the per-edge states onto their source
    frame over all ``num_frames`` rows (invalid edges go to a dump row),
    then emit per-frame BA damping ``eta`` and the 8× upsampling mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 128, 3)
        self.conv2 = _conv(128, 128, 3)
        self.eta = _conv(128, 1, 3)
        self.upmask = _conv(128, 8 * 8 * 9, 1)

    def forward(
        self, net: Tensor, ii: Tensor, num_frames: int, edge_valid: Optional[Tensor] = None
    ):
        # net [N, 128, H, W] NCHW; ii [N] source frame ids in [0, num_frames)
        n, ch, ht, wd = net.shape
        net = F.relu(self.conv1(net))
        seg = ii if edge_valid is None else torch.where(edge_valid, ii, num_frames)
        # scatter-mean accumulated in float32 whatever the compute dtype, in
        # an order fixed by the inputs; the counts are exact in any order
        sums = segment_sum(seg, net.reshape(n, -1).float(), num_frames)
        counts = sums.new_zeros(num_frames + 1).index_add_(0, seg, sums.new_ones(n))
        mean = sums / counts[:num_frames].clamp(min=1.0)[:, None]
        net = mean.to(net.dtype).reshape(num_frames, ch, ht, wd)

        net = F.relu(self.conv2(net))
        eta = 0.01 * F.softplus(grad_clip(self.eta(net).float()))[:, 0]  # [F, H, W]
        upmask = _nhwc(self.upmask(net))  # [F, H, W, 576]
        return eta, upmask


class UpdateModule(nn.Module):
    """One operator iteration (droid_net.py:79-144): encode correlation and
    motion features, run the ConvGRU, decode a flow revision ``delta`` and a
    confidence ``weight``; with ``ii`` also aggregate per-frame damping and
    upsampling masks over the factor graph. Heads are natively 2-channel."""

    def __init__(self):
        super().__init__()
        self.corr_enc1 = _conv(196, 128, 1)
        self.corr_enc2 = _conv(128, 128, 3)
        self.flow_enc1 = _conv(4, 128, 7)
        self.flow_enc2 = _conv(128, 64, 3)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta1 = _conv(128, 128, 3)
        self.delta2 = _conv(128, 2, 3)
        self.weight1 = _conv(128, 128, 3)
        self.weight2 = _conv(128, 2, 3)
        self.agg = GraphAgg()

    def forward(
        self,
        net: Tensor,  # [N, H, W, 128] hidden state per edge
        inp: Tensor,  # [N, H, W, 128] context features per edge
        corr: Tensor,  # [N, H, W, 196] correlation features
        flow: Tensor,  # [N, H, W, 4] motion features
        ii: Optional[Tensor] = None,
        num_frames: Optional[int] = None,
        edge_valid: Optional[Tensor] = None,
    ):
        dt = self.corr_enc1.weight.dtype
        net, inp, corr, flow = (_nchw(x.to(dt)) for x in (net, inp, corr, flow))
        corr = F.relu(self.corr_enc2(F.relu(self.corr_enc1(corr))))
        flow = F.relu(self.flow_enc2(F.relu(self.flow_enc1(flow))))
        net = self.gru(net, torch.cat([inp, corr, flow], dim=1))

        delta = grad_clip(self.delta2(F.relu(self.delta1(net))).float())
        weight = torch.sigmoid(grad_clip(self.weight2(F.relu(self.weight1(net))).float()))
        outs = (_nhwc(net), _nhwc(delta), _nhwc(weight))
        if ii is None:
            return outs
        eta, upmask = self.agg(net, ii, num_frames, edge_valid)
        return outs + (eta, upmask)
