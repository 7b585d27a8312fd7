"""Feature / context encoders (PyTorch).

Counterpart of the JAX package's ``models/extractor.py``: a 7×7 stride-2
stem, three stages of two residual blocks (strides 1/2/2, widths 32/64/128)
and a 1×1 projection head, total stride 8. Public tensors are NHWC; the
convolutions run NCHW inside.

Instance norm has no affine parameters and eps 1e-5 (torch
``InstanceNorm2d``); stride-2 3×3 convs pad (1, 1) and the 7×7 stem (3, 3),
symmetrically, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DIM = 32


def _norm(norm_fn: str, x: torch.Tensor) -> torch.Tensor:
    if norm_fn == "instance":
        return F.instance_norm(x, eps=1e-5)
    if norm_fn == "none":
        return x
    raise ValueError(f"unsupported norm_fn: {norm_fn}")


class ResidualBlock(nn.Module):
    """Two 3×3 convs + skip (extractor.py:6-55), NCHW."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Conv2d(in_planes, planes, 1, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_norm(self.norm_fn, self.conv1(x)))
        y = F.relu(_norm(self.norm_fn, self.conv2(y)))
        if self.downsample is not None:
            x = _norm(self.norm_fn, self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 residual encoder: [B, H, W, 3] → [B, H/8, W/8, output_dim]."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3)
        in_planes = DIM
        for i, (dim, stride) in enumerate([(DIM, 1), (2 * DIM, 2), (4 * DIM, 2)]):
            setattr(self, f"layer{i + 1}_0", ResidualBlock(in_planes, dim, norm_fn, stride))
            setattr(self, f"layer{i + 1}_1", ResidualBlock(dim, dim, norm_fn, 1))
            in_planes = dim
        self.conv2 = nn.Conv2d(in_planes, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_norm(self.norm_fn, self.conv1(x)))
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_0")(x)
            x = getattr(self, f"layer{i + 1}_1")(x)
        return self.conv2(x).permute(0, 2, 3, 1)
