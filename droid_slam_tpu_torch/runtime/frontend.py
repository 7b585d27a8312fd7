"""Frontend of the host-driven engine: local sliding-window tracking
(PyTorch).

Counterpart of the JAX package's ``runtime/frontend.py``. Initialisation
once ``warmup`` keyframes exist (neighbourhood edges and 8 iterations,
proximity edges and 8 more, droid_frontend.py:78-113); then per keyframe
(droid_frontend.py:35-76): retire aged edges, add proximity edges, 4 + 2
operator iterations around the keep/cull distance test (one blocking read
of the distance), and the motion model's seed of the next slot.
"""

from __future__ import annotations

import torch

from .factor_graph import FactorGraph
from .fused import _edge_slots


class DroidFrontend:
    """``update_op`` is the update operator in the compute dtype; the graph's
    per-edge hidden state stays f32. ``capture`` (CUDA) replays each
    operator iteration whose key the graph has seen as one CUDA graph
    (:meth:`.factor_graph.FactorGraph.update`)."""

    def __init__(self, update_op, video, config, capture: bool = False):
        self.video = video
        self.config = config
        # the edge store holds the initialisation's neighbourhood, which
        # appends past max_factors as in the reference; the fused engine's
        # store has the same size
        self.graph = FactorGraph(
            video,
            update_op,
            max_factors=config.max_factors,
            edge_pad=_edge_slots(config),
            inactive_pad=config.inactive_pad,
            window_pad=config.window_pad,
            upsample=config.upsample,
            schur_pair_floor=config.schur_pair_floor,
            capture=capture,
        )

        self.t1 = 0  # keyframes the frontend has tracked
        self.is_initialized = False

    def _seed_next(self, mean_disp: torch.Tensor) -> None:
        """Motion model: the slot after the last keyframe starts at its
        pose, with a flat disparity."""
        v = self.video
        v.set_pose(self.t1, v.poses[self.t1 - 1])
        v.set_disp(self.t1, mean_disp)

    def _update(self) -> None:
        """Per-keyframe tracking update (droid_frontend.py:35-76)."""
        cfg = self.config
        g = self.graph
        v = self.video
        self.t1 += 1

        if g.num_active > 0:
            g.rm_factors(g.age > cfg.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5,
            max(self.t1 - cfg.frontend_window, 0),
            rad=cfg.frontend_radius,
            nms=cfg.frontend_nms,
            thresh=cfg.frontend_thresh,
            beta=cfg.beta,
            remove=True,
        )

        # the RGB-D prior seeds the new keyframe's disparity
        sens = v.disps_sens[self.t1 - 1]
        v.set_disp(self.t1 - 1, torch.where(sens > 0, sens, v.disps[self.t1 - 1]))

        for _ in range(cfg.frontend_iters1):
            g.update(None, None, use_inactive=True)

        # keep/cull test on the distance between the last two tracked frames
        d = float(v.distance([self.t1 - 3], [self.t1 - 2], beta=cfg.beta, bidirectional=True)[0])
        if d < cfg.keyframe_thresh:
            g.rm_keyframe(self.t1 - 2)
            v.counter -= 1
            self.t1 -= 1
        else:
            for _ in range(cfg.frontend_iters2):
                g.update(None, None, use_inactive=True)

        self._seed_next(v.disps[self.t1 - 1].mean())
        active_ii = g.ii[g.valid]
        if len(active_ii):
            v.dirty[int(active_ii.min()) : self.t1] = True

    def _initialize(self) -> None:
        """Bootstrap once ``warmup`` keyframes exist (droid_frontend.py:78-113)."""
        g = self.graph
        v = self.video
        self.t1 = v.counter

        g.add_neighborhood_factors(0, self.t1, r=3)
        for _ in range(8):
            g.update(1, use_inactive=True)
        # the reference's default beta (0.25) here, not config.beta
        g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=self.config.frontend_thresh, remove=False)
        for _ in range(8):
            g.update(1, use_inactive=True)

        self._seed_next(v.disps[self.t1 - 4 : self.t1].mean())
        self.is_initialized = True
        v.dirty[: self.t1] = True
        g.rm_factors((g.ii < self.config.warmup - 4) & g.valid, store=True)

    def __call__(self) -> None:
        if not self.is_initialized and self.video.counter == self.config.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()
