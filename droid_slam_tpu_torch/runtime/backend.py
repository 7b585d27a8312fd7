"""Backend: global bundle adjustment over the whole keyframe history
(PyTorch).

Counterpart of the JAX package's ``runtime/backend.py``: a fresh low-memory
factor graph capped at 16·t edges, proximity edges over all keyframes,
then ``update_lowmem``, on one device or edge-sharded over a process
group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .factor_graph import CaptureStats, FactorGraph


def _chunk_ceil(n: int, chunk: int = 256, floor: int = 64) -> int:
    """Round up to a multiple of the update-op chunk (at least ``floor``):
    the edge store's size, whose per-edge hidden is the backend's largest
    allocation."""
    return max(-(-max(n, 1) // chunk) * chunk, floor)


class DroidBackend:
    """Global BA over ``video``'s keyframes with ``update_op`` (the
    :class:`..models.update.UpdateModule` in the compute dtype).

    ``mesh`` (optional) is a ``torch.distributed`` process group, the
    counterpart of the JAX package's mesh with a ``"ba"`` axis: every
    global-BA solve then runs edge-sharded over its ranks
    (:mod:`..parallel.sharded_ba`), each rank running this backend on the
    same state, eagerly. ``capture`` (CUDA, without ``mesh``) replays each
    pass's steps after its first as one CUDA graph; each pass's graphs go
    with its factor graph, and ``stats`` sums what they cost and ran."""

    def __init__(self, update_op, video, config, mesh=None, capture: bool = False):
        self.update_op = update_op
        self.video = video
        self.config = config
        self.mesh = mesh
        self.capture = capture
        self.stats = CaptureStats()

    def __call__(self, steps: int = 12) -> Tuple[int, int]:
        """Run ``steps`` global-BA iterations; returns (edges, chunks): the
        number of proximity edges and of update-operator chunks per step."""
        cfg = self.config
        v = self.video
        t = v.counter

        # monocular without a depth prior: fix the gauge first
        if not cfg.stereo and float(v.disps_sens[:t].sum()) == 0.0:
            v.normalize()

        size = _chunk_ceil(16 * t, cfg.backend_chunk)
        graph = FactorGraph(
            v,
            self.update_op,
            max_factors=size,
            # proximity with remove=False appends at most budget + 2 edges
            edge_pad=size + 32,
            inactive_pad=cfg.inactive_pad,
            window_pad=cfg.window_pad,
            upsample=cfg.upsample,
            net_dtype=getattr(torch, cfg.compute_dtype),
            schur_pair_floor=cfg.schur_pair_floor,
            capture=self.capture,
        )
        graph.add_proximity_factors(
            rad=cfg.backend_radius,
            nms=cfg.backend_nms,
            thresh=cfg.backend_thresh,
            beta=cfg.beta,
        )
        n_edges = graph.num_active
        n_chunks = graph.update_lowmem(steps=steps, mesh=self.mesh)
        graph.clear_edges()
        self.stats.merge(graph.stats)
        return n_edges, n_chunks
