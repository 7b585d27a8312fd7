"""Training-time frame-graph construction (numpy on the host).

Counterpart of the JAX package's ``train/graph_utils.py`` (reference
geom/graph_utils.py): radius-r neighbourhood edges plus the greedy closest
covisible pairs by induced-flow distance, which randomise the graphs of
training (train.py:91-99).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

from ..data.rgbd_utils import compute_distance_matrix_flow


def graph_to_edge_list(graph: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ii, jj, kk = [], [], []
    for s, u in enumerate(graph):
        for v in graph[u]:
            ii.append(u)
            jj.append(v)
            kk.append(s)
    return (
        np.asarray(ii, np.int32),
        np.asarray(jj, np.int32),
        np.asarray(kk, np.int32),
    )


def keyframe_indicies(graph: Dict) -> np.ndarray:
    return np.asarray([u for u in graph], np.int32)


def neighbourhood_graph(n: int, r: int) -> Tuple[np.ndarray, np.ndarray]:
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    d = np.abs(ii - jj)
    keep = (d >= 1) & (d <= r)
    return ii[keep], jj[keep]


def _adjacency(N: int, ii: np.ndarray, jj: np.ndarray) -> "OrderedDict":
    """Edge arrays → per-source adjacency dict (every frame keyed, possibly
    with an empty list — the trainer samples sources from the keys)."""
    graph = OrderedDict((i, []) for i in range(N))
    for i, j in zip(ii.tolist(), jj.tolist()):
        graph[i].append(j)
    return graph


def build_frame_graph(
    poses_c2w: np.ndarray,  # [F, 7] camera-to-world (dataset convention)
    disps: np.ndarray,  # [F, H, W] full-res inverse depth
    intrinsics: np.ndarray,  # [F, 4] full-res
    num: int = 16,
    thresh: float = 24.0,
    r: int = 2,
) -> "OrderedDict":
    """Radius edges + the globally closest covisible pairs up to ``num``
    edges total (semantics of reference graph_utils.py:37-68).

    Without NMS, picking pairs one argmin at a time is just an ascending
    sort of the candidate distances — so the selection is one vectorised
    argsort instead of a greedy loop (argsort's first-index tie-break equals
    repeated argmin's)."""
    N = len(poses_c2w)
    d = compute_distance_matrix_flow(
        poses_c2w, disps[:, 3::8, 3::8], intrinsics / 8.0
    )

    ii, jj = neighbourhood_graph(N, r)
    d[ii, jj] = np.inf
    np.fill_diagonal(d, np.inf)

    order = np.argsort(d, axis=None, kind="stable")[: max(num - len(ii), 0)]
    picks = order[d.flat[order] < thresh]

    graph = _adjacency(N, ii, jj)
    for i, j in zip(*np.unravel_index(picks, d.shape)):
        graph[int(i)].append(int(j))
    return graph


def build_frame_graph_v2(
    poses_c2w: np.ndarray,
    disps: np.ndarray,
    intrinsics: np.ndarray,
    num: int = 16,
    thresh: float = 24.0,
    r: int = 2,
) -> "OrderedDict":
    """NMS variant (graph_utils.py:72-112): greedy closest pairs by the
    blended tonly+β·full flow distance, suppressing the 3×3 neighborhood of
    every accepted edge; runs until no candidate beats `thresh` (the
    reference's loop ignores `num`, kept for signature parity)."""
    from ..data.rgbd_utils import compute_distance_matrix_flow2

    N = len(poses_c2w)
    d = compute_distance_matrix_flow2(
        poses_c2w, disps[:, 3::8, 3::8], intrinsics / 8.0
    )

    ii, jj = neighbourhood_graph(N, r)
    d[ii, jj] = np.inf
    np.fill_diagonal(d, np.inf)
    graph = _adjacency(N, ii, jj)

    # NMS makes each pick depend on the previous suppressions, so selection
    # stays a loop; each step is one argmin + a vectorised 3×3 mask write
    while np.min(d) < thresh:
        i, j = np.unravel_index(np.argmin(d), d.shape)
        graph[int(i)].append(int(j))
        d[max(i - 1, 0) : i + 2, max(j - 1, 0) : j + 2] = np.inf

    return graph
