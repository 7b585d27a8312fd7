"""DroidNet: feature/context encoders + update operator (PyTorch).

Counterpart of the JAX package's ``models/droid_net.py``: fnet (matching
features), cnet (context, split into the tanh hidden init and the relu
context) and the update operator. The module names match the JAX
parameter tree. The training unroll (``DroidNet.forward`` of the port) is
not copied: no cell of the benchmark trains.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops import lie
from .extractor import BasicEncoder
from .update import UpdateModule

Tensor = torch.Tensor

# ImageNet statistics (droid_net.py:160-162)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: Tensor) -> Tensor:
    """RGB [..., H, W, 3] in [0, 255] → ImageNet-normalised float32."""
    x = images.float() / 255.0
    mean = lie.constant(IMAGENET_MEAN, x)
    std = lie.constant(IMAGENET_STD, x)
    return (x - mean) / std


class DroidNet(nn.Module):
    """fnet + cnet + update operator (droid_net.py:147-152)."""

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
