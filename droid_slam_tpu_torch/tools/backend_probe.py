"""One global-BA step at reference scale: the port's backend probe.

Counterpart of ``backend_scale_probe`` in the JAX repo's ``bench.py``: a
synthetic map of ``t`` keyframes (jittered poses, random disparities,
features and hidden states) with about 16·t edges (the temporal
neighbourhood and random long-range pairs, both directions), then
``FactorGraph.update_lowmem``: AltCorr, the update operator over chunks of
edges and the block-sparse GN solve, as terminate runs them at an
ETH3D-like scale. The draws come from ``np.random.default_rng(5)`` in the
JAX probe's order, so the edge list is the JAX probe's; the graph is sized
as the JAX probe sizes it (a power-of-two edge store), not as the port's
backend does.

  python -m droid_slam_tpu_torch.tools.backend_probe [--t 200] [--image_size 240 320] [--device cpu] \\
      [--no-capture]

It runs on CUDA unless ``device`` names another device. There the warm
call's step is captured into a CUDA graph, and the timed steps are its
replays; ``--no-capture`` runs every step eagerly (the CPU always does).
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, NamedTuple

import numpy as np


def _pow2ceil(n: int, floor: int = 64) -> int:
    """The JAX backend's edge-store size: the next power of two (at least
    ``floor``); the port's backend rounds to whole chunks instead."""
    return max(int(2 ** np.ceil(np.log2(max(n, 1)))), floor)


class ProbeArrays(NamedTuple):
    """The probe's host draws: pose increments [t, 6] (buffer rows past t
    zero), disparities [B, h, w], features [B, 1, h, w, 128], hidden and
    context [B, h, w, 128], and the edge list (ii, jj) before deduplication."""

    tw: np.ndarray
    disps: np.ndarray
    fmaps: np.ndarray
    nets: np.ndarray
    inps: np.ndarray
    ii: np.ndarray
    jj: np.ndarray


def probe_arrays(t: int, buffer: int, h: int, w: int) -> ProbeArrays:
    """Every random draw of the probe, in the JAX probe's order."""
    rng = np.random.default_rng(5)
    tw = np.zeros((buffer, 6), np.float32)
    tw[:t] = np.cumsum(0.01 * rng.standard_normal((t, 6)), axis=0).astype(np.float32)
    disps = (0.5 + rng.random((buffer, h, w))).astype(np.float32)
    fmaps = rng.standard_normal((buffer, 1, h, w, 128)).astype(np.float32)
    nets = np.tanh(rng.standard_normal((buffer, h, w, 128))).astype(np.float32)
    inps = rng.standard_normal((buffer, h, w, 128)).astype(np.float32)

    # 16·t edges: the temporal neighbourhood and random long-range pairs,
    # both directions
    ii, jj = [], []
    for i in range(t):
        for d in (1, 2):
            if i - d >= 0:
                ii.extend([i, i - d])
                jj.extend([i - d, i])
    n_rand = 8 * t - len(ii) // 2
    a = rng.integers(0, t, 2 * n_rand)
    b = rng.integers(0, t, 2 * n_rand)
    keep = np.abs(a - b) > 2
    ii.extend(a[keep][:n_rand])
    jj.extend(b[keep][:n_rand])
    ii.extend(b[keep][:n_rand])
    jj.extend(a[keep][:n_rand])
    return ProbeArrays(tw, disps, fmaps, nets, inps, np.asarray(ii, np.int32), np.asarray(jj, np.int32))


def unique_edges(arrays: ProbeArrays) -> int:
    """The number of distinct (i, j) pairs: what the graph holds once
    ``add_factors`` has dropped the repeats."""
    return len(set(zip(arrays.ii.tolist(), arrays.jj.tolist())))


def build_probe(t: int = 200, image_size=(240, 320), device=None, params=None,
                compute_dtype: str = "bfloat16", capture: bool = True):
    """The probe's video and factor graph on ``device``: returns (graph,
    video). ``params`` is a :class:`..models.droid_net.DroidNet` state dict
    (default: ``init_params(1)``); the update operator runs in
    ``compute_dtype``. ``capture`` as :class:`..runtime.factor_graph.FactorGraph`
    takes it."""
    import torch

    from ..models.droid_net import DroidNet, init_params
    from ..ops import lie
    from ..runtime import DroidConfig
    from ..runtime.droid import resolve_device
    from ..runtime.factor_graph import FactorGraph
    from ..runtime.video import VideoState

    dev = resolve_device(device)
    cfg = DroidConfig(image_size=tuple(image_size), buffer=t + 8, window_pad=64, compute_dtype=compute_dtype)
    h, w = cfg.feat_size
    net = DroidNet()
    net.load_state_dict(params if params is not None else init_params(1))
    update_op = net.update.to(device=dev, dtype=getattr(torch, compute_dtype)).eval()

    x = probe_arrays(t, cfg.buffer, h, w)
    v = VideoState(cfg, dev)
    v.counter = t
    v.poses = lie.retr(lie.identity((cfg.buffer,), device=dev), torch.from_numpy(x.tw).to(dev))
    v.disps = torch.from_numpy(x.disps).to(dev)
    W = image_size[1]
    v.intrinsics = torch.tensor([W / 8, W / 8, w / 2, h / 2], dtype=torch.float32,
                                device=dev).expand(cfg.buffer, 4).clone()
    v.fmaps = torch.from_numpy(x.fmaps).to(dev)
    v.nets = torch.from_numpy(x.nets).to(dev)
    v.inps = torch.from_numpy(x.inps).to(dev)

    size = _pow2ceil(16 * t)
    graph = FactorGraph(v, update_op, max_factors=size, edge_pad=size, inactive_pad=16,
                        window_pad=cfg.window_pad, capture=capture)
    graph.add_factors(x.ii, x.jj)
    return graph, v


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


TIMED_STEPS = 2


def backend_scale_probe(t: int = 200, image_size=(240, 320), device=None, params=None, profile=None,
                        capture: bool = True) -> Dict:
    """One warm ``update_lowmem(steps=1)``, then TIMED_STEPS timed steps;
    returns the seconds per step, the keyframes and edges, the
    update-operator chunks per step, the kernel launches of the timed steps
    as the wrappers count them (``launches``) and as the card ran them
    (``device_launches``: a captured launch runs on every replay), the
    update operator in bf16 as in the JAX probe's default config, the
    warm call's seconds and, of them, its capture's (``capture_s``), the
    graphs captured, their pool bytes and the replays, and on a CUDA
    device the peak of allocated memory over the whole probe. With
    ``capture`` (CUDA) the warm call runs its step eagerly and captures it,
    so that every timed step is one replay. ``profile``, when given, is
    called last with a function that runs one more step, and what it
    returns is the row's ``"profile"``."""
    import torch

    from ..ops import kernels
    from ..runtime.droid import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        graph, v = build_probe(t, image_size, dev, params, capture=capture)
        n_edges = graph.num_active
        t0 = time.perf_counter()
        graph.update_lowmem(steps=1)  # cuDNN's first calls, the kernels' build, the capture
        _sync(dev)
        warm_s = time.perf_counter() - t0
        stats = copy.deepcopy(graph.stats)  # the warm call's
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        chunks = graph.update_lowmem(steps=TIMED_STEPS)
        _sync(dev)
        dt = (time.perf_counter() - t0) / TIMED_STEPS
        launches = kernels.launches_since(before)
        replays = graph.stats.replays - stats.replays
        replayed = {k: n - stats.replayed_launches.get(k, 0) for k, n in graph.stats.replayed_launches.items()}
        device_launches = {k: launches.get(k, 0) + replayed.get(k, 0) for k in set(launches) | set(replayed)}
        profiled = profile(lambda: graph.update_lowmem(steps=1)) if profile is not None else None
    return {
        "backend_step_s": round(dt, 3),
        "backend_keyframes": t,
        "backend_edges": int(n_edges),
        "backend_chunks": int(chunks),
        "steps": TIMED_STEPS,
        "launches": launches,
        "device_launches": device_launches,
        "capture": graph.capture,
        "warm_s": round(warm_s, 3),
        "capture_s": round(stats.capture_s, 3),
        "graphs": stats.graphs,
        "pool_bytes": stats.pool_bytes,
        "replays": replays,
        "peak_allocated_gb": (round(torch.cuda.max_memory_allocated(dev) / 1e9, 3)
                              if dev.type == "cuda" else None),
        "profile": profiled,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=200, help="keyframes")
    ap.add_argument("--image_size", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--device", default=None, help="device (default: cuda)")
    ap.add_argument("--capture", action=argparse.BooleanOptionalAction, default=True,
                    help="replay the timed steps as a CUDA graph (default; CUDA only)")
    args = ap.parse_args(argv)
    row = backend_scale_probe(args.t, tuple(args.image_size), args.device, capture=args.capture)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
