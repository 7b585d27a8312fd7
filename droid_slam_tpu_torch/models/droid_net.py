"""DroidNet: feature/context encoders + update operator, and the training
unroll (PyTorch).

Counterpart of the JAX package's ``models/droid_net.py``: fnet (matching
features), cnet (context, split into the tanh hidden init and the relu
context), the update operator, and :meth:`DroidNet.forward`, the unrolled
training forward (per step: correlation lookup, update operator, two
differentiable DBA steps, reprojection). The module names match the JAX
parameter tree, so :func:`..models.weights.params_from_jax` maps parameters
by name.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import ba as ba_ops
from ..ops import projective as pops
from ..ops.corr import CorrPyramid
from .extractor import BasicEncoder
from .update import UpdateModule, upsample_disp

Tensor = torch.Tensor

# ImageNet statistics (droid_net.py:160-162)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: Tensor) -> Tensor:
    """RGB [..., H, W, 3] in [0, 255] → ImageNet-normalised float32."""
    x = images.float() / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    return (x - mean) / std


class TrainingOutputs(NamedTuple):
    poses: Tensor  # [S, B, F, 7] per-step pose estimates
    disps_up: Tensor  # [S, B, F, H, W] per-step upsampled disparities
    residuals: Tensor  # [S, B*N, h, w, 2] per-step masked flow residuals


class DroidNet(nn.Module):
    """fnet + cnet + update operator (droid_net.py:147-152).

    With gradients on, :meth:`forward` recomputes the update operator and
    each differentiable BA step in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``remat``): the 15-step
    unroll otherwise keeps every step's convolution and BA activations
    alive."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()

    def context(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """images [B, H, W, 3] RGB 0-255 → (net [B,h,w,128] tanh hidden
        init, inp [B,h,w,128] relu context), float32."""
        ctx = self.cnet(normalize_images(images)).float()
        net, inp = ctx.split(ctx.shape[-1] // 2, dim=-1)
        return torch.tanh(net), torch.relu(inp)

    def features(self, images: Tensor) -> Tensor:
        """images [B, H, W, 3] RGB 0-255 → fmaps [B, h, w, 128] float32."""
        return self.fnet(normalize_images(images)).float()

    def extract_features(self, images: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """images [B, H, W, 3] RGB 0-255 → (fmaps [B, h, w, 128], net
        [B, h, w, 128] tanh hidden init, inp [B, h, w, 128] relu context)."""
        return (self.features(images),) + self.context(images)

    @staticmethod
    def _run(fn, *args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(
        self,
        Gs: Tensor,  # [B, F, 7] initial poses
        images: Tensor,  # [B, F, H, W, 3] RGB 0-255
        disps: Tensor,  # [B, F, h, w] initial inverse depths (1/8 res)
        intrinsics: Tensor,  # [B, F, 4] at 1/8 resolution
        ii: Tensor,  # [N] int64 edge list shared across the batch
        jj: Tensor,  # [N]
        num_steps: int = 12,
        fixedp: int = 2,
        edge_valid: Optional[Tensor] = None,  # [N] bool: padding mask of randomised graphs
    ) -> TrainingOutputs:
        """Unrolled training forward (droid_net.py:173-224): per step the
        correlation lookup, the update operator, 2 differentiable DBA steps
        and the reprojection. Poses, disparities and coordinates are
        detached between steps; the hidden state is not, and gradients flow
        through each step's BA."""
        B, F = images.shape[:2]
        N = ii.shape[0]
        dev = images.device
        if edge_valid is None:
            edge_valid = torch.ones(N, dtype=torch.bool, device=dev)
        valid_b = edge_valid.repeat(B)  # [B*N]
        ev = edge_valid.float()[None, :, None, None, None]

        fmaps, net0, inp0 = self.extract_features(images.reshape((B * F,) + images.shape[2:]))
        h, w = fmaps.shape[1:3]
        fmaps, net0, inp0 = (x.reshape(B, F, h, w, -1) for x in (fmaps, net0, inp0))

        # per-edge state, flattened over (batch, edge)
        net = net0[:, ii].reshape(B * N, h, w, -1)
        inp = inp0[:, ii].reshape(B * N, h, w, -1)
        corr_fn = CorrPyramid.build(
            fmaps[:, ii].reshape(B * N, h, w, -1), fmaps[:, jj].reshape(B * N, h, w, -1)
        )

        coords0 = pops.coords_grid(h, w, device=dev)
        # GraphAgg's segments: edge (b, k) has source frame b·F + ii[k]
        ii_b = (torch.arange(B, device=dev)[:, None] * F + ii).reshape(-1)

        def transform(G, d):
            return pops.projective_transform_batched(G, d, intrinsics, ii, jj)

        coords1, _ = transform(Gs, disps)
        target = coords1

        poses_out, disps_out, resid_out = [], [], []
        for _ in range(num_steps):
            Gs, disps, coords1, target = (x.detach() for x in (Gs, disps, coords1, target))

            corr = corr_fn(coords1.reshape(B * N, h, w, 2))
            resd = (target - coords1).reshape(B * N, h, w, 2)
            flow = (coords1 - coords0).reshape(B * N, h, w, 2)
            motion = torch.cat([flow, resd], dim=-1).clamp(-64.0, 64.0)

            net, delta, weight, eta, upmask = self._run(
                self.update, net, inp, corr, motion, ii_b, B * F, valid_b
            )

            target = coords1 + delta.reshape(B, N, h, w, 2)
            weight_b = weight.reshape(B, N, h, w, 2) * ev
            eta_b = eta.reshape(B, F, h, w)

            for _ in range(2):
                Gs, disps = self._run(ba_ops.bundle_adjust, target, weight_b, eta_b, Gs, disps,
                                      intrinsics, ii, jj, fixedp)

            coords1, valid = transform(Gs, disps)
            residual = valid * ev * (target - coords1)

            poses_out.append(Gs)
            disps_out.append(
                upsample_disp(disps.reshape(B * F, h, w), upmask).reshape(B, F, 8 * h, 8 * w)
            )
            resid_out.append(residual.reshape(B * N, h, w, 2))

        return TrainingOutputs(
            poses=torch.stack(poses_out),
            disps_up=torch.stack(disps_out),
            residuals=torch.stack(resid_out),
        )


def init_params(seed: int = 0) -> Dict[str, Tensor]:
    """Seeded random parameters for :class:`DroidNet` (a state dict):
    conv weights N(0, 1/fan_in), as flax's lecun-normal scale, and zero
    biases, drawn from a ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in DroidNet().named_parameters():
        if name.endswith("weight"):
            fan_in = p[0].numel()
            state[name] = torch.randn(p.shape, generator=g) / fan_in**0.5
        else:
            state[name] = torch.zeros(p.shape)
    return state
