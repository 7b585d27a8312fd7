"""Float row sums by segment id, in an order fixed by the inputs.

The BA's block scatters (``ops/ba.py``) and GraphAgg's scatter-mean
(``models/update.py``) add rows of a float tensor into segments. On a CUDA
tensor ``index_add_`` adds with atomics, so the order of the additions, and
with it the last bits of every sum, changes from run to run; the global BA
amplifies those bits into different proximity edges, and two ``terminate``
calls on one tracked state gave different trajectories.

:func:`segment_sum` adds in an order that depends on the inputs alone. On a
CPU tensor it is :func:`segment_sum_ref`, ``index_add_``, which adds each
segment's rows one after another in index order (the CPU tests compare it
with the JAX package bit for bit). On a CUDA tensor it is
``index_put_(accumulate=True)``, which sorts the ids and then sums each
segment's run of rows without atomics, so two runs on the same inputs give
the same bits (PyTorch lists it among the deterministic CUDA operations;
``chip_smoke.py`` phase 3c holds it to that at the paths' shapes). The CUDA
sums run inside a ``segment_sum`` profiler range, which is how a profile
reads their device time.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _dump(idx: Tensor, n_seg: int) -> Tensor:
    """ids outside [0, n_seg) moved to the dump row n_seg."""
    return torch.where((idx >= 0) & (idx < n_seg), idx, n_seg)


def segment_sum_ref(idx: Tensor, src: Tensor, n_seg: int) -> Tensor:
    """``index_add_`` of the rows into zeros, ids outside [0, n_seg) going
    to a dump row that is dropped: row after row in index order on the CPU,
    with atomics (in no fixed order) on a CUDA tensor."""
    out = src.new_zeros((n_seg + 1,) + src.shape[1:])
    out.index_add_(0, _dump(idx, n_seg), src)
    return out[:n_seg]


def segment_sum(idx: Tensor, src: Tensor, n_seg: int) -> Tensor:
    """out[s] = Σ src[k] over the k with idx[k] == s, in an order fixed by
    the inputs; ids outside [0, n_seg) are dropped.

    idx [K] int64, src [K, ...] float → [n_seg, ...] of src's dtype.
    """
    if src.device.type == "cpu":
        return segment_sum_ref(idx, src, n_seg)
    with torch.profiler.record_function("segment_sum"):
        out = src.new_zeros((n_seg + 1,) + src.shape[1:])
        out.index_put_((_dump(idx, n_seg),), src, accumulate=True)
        return out[:n_seg]
