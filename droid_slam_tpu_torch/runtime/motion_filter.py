"""Motion filter of the host-driven engine: keyframe selection by the
predicted flow magnitude (PyTorch).

Counterpart of the JAX package's ``runtime/motion_filter.py``. On every
input frame the matching encoder runs; one ConvGRU step against the last
keyframe with zero-flow coords estimates the flow; if its mean magnitude
exceeds the threshold the frame becomes a keyframe, and only then does the
context encoder run (motion_filter.py:74-93). Everything here is f32:
encoders, stored features and the probe, whose lookup is
:func:`..ops.corr.corr_lookup` on one edge (the f32 ``corr_level`` kernel
on a CUDA tensor). The probe's mean comes back to the host as one float,
the engine's per-frame blocking read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import corr as corr_ops
from ..ops import lie
from ..ops import projective as pops

Tensor = torch.Tensor


def _encode_frame(net, image: Tensor) -> Tensor:
    """fnet over every rig image: image [rig, H, W, 3] → [rig, h, w, 128]
    f32."""
    return net.features(image)


def _encode_context(net, image: Tensor) -> Tuple[Tensor, Tensor]:
    """cnet over the left image [rig, H, W, 3] → (net tanh, inp relu), each
    [h, w, 128] f32."""
    hidden, inp = net.context(image[:1])
    return hidden[0], inp[0]


def _motion_probe(update_op, fmap_prev: Tensor, net_prev: Tensor, inp_prev: Tensor,
                  fmap_new: Tensor) -> Tensor:
    """One zero-flow GRU iteration of the f32 ``update_op`` against the last
    keyframe: fmaps [h, w, 128] → the mean predicted flow magnitude, a
    0-dim tensor (motion_filter.py:74-83)."""
    h, w = fmap_prev.shape[:2]
    coords0 = pops.coords_grid(h, w, device=fmap_prev.device)[None]
    corr = corr_ops.corr_lookup(fmap_prev[None], fmap_new[None], coords0)
    zero_flow = torch.zeros((1, h, w, 4), device=fmap_prev.device)
    _, delta, _ = update_op(net_prev[None], inp_prev[None], corr, zero_flow)
    return delta.norm(dim=-1).mean()


class MotionFilter:
    """``net`` is the f32 :class:`..models.droid_net.DroidNet`; keyframes go
    to ``video`` (:class:`.video.VideoState`)."""

    def __init__(self, net, video, thresh: float = 2.4):
        self.net = net
        self.video = video
        self.thresh = thresh
        # features of the last keyframe
        self._net: Optional[Tensor] = None
        self._inp: Optional[Tensor] = None
        self._fmap: Optional[Tensor] = None

    def _append(self, tstamp, image, pose, disp, depth, intrinsics, fmap) -> None:
        net, inp = _encode_context(self.net, image)
        self._net, self._inp, self._fmap = net, inp, fmap
        self.video.append(tstamp, image, pose, disp, depth, intrinsics / 8.0, fmap, net, inp)

    @torch.no_grad()
    def track(self, tstamp: float, image: Tensor, depth: Optional[Tensor] = None,
              intrinsics: Optional[Tensor] = None) -> None:
        """image [rig, H, W, 3] uint8 on the video's device, depth [H, W]
        or None, intrinsics [4] f32 at full resolution."""
        fmap = _encode_frame(self.net, image)
        if self.video.counter == 0:
            self._append(tstamp, image, lie.identity((), device=fmap.device), 1.0, depth,
                         intrinsics, fmap)
            return
        delta = float(_motion_probe(self.net.update, self._fmap[0], self._net, self._inp, fmap[0]))
        if delta > self.thresh:
            self._append(tstamp, image, None, None, depth, intrinsics, fmap)
