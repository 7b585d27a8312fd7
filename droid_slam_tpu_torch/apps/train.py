"""Training entry point of the port, single process.

The port's counterpart of the JAX package's ``apps/train.py`` (reference
train.py) on procedurally rendered clips: per batch the ground-truth poses
are inverted to world→camera and the estimate starts at [P0, P1, P1, ...]
(train.py:86-88,95-101), half the batches draw a randomised covisibility
graph padded to a fixed length (train.py:91-99), and random restarts run
further passes from the last estimate whose gradients add up before one
optimizer step (train.py:102-118).

Usage:
  python -m droid_slam_tpu_torch.apps.train --synthetic [--name droid]
      [--batch 4] [--steps 250000] [--crop 384 512] [--ckpt weights.msgpack]
      [--resume checkpoints/droid_state_001000.pt] [--device cpu]

It runs on CUDA unless ``--device`` names another device. TartanAir
(``--datapath``) needs the file readers of ROADMAP.md's queue 1 item 3, and
several processes (``--num_processes``) the distributed backend of item 6;
both exit with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, ContextManager, Dict, List, Optional

import numpy as np
import torch


def pad_graph(ii, jj, n_edges: int):
    """Pad an edge list to a fixed length with a validity mask."""
    n = len(ii)
    if n > n_edges:
        raise ValueError(f"{n} edges do not fit {n_edges} slots")
    ii_p = np.zeros(n_edges, np.int64)
    jj_p = np.zeros(n_edges, np.int64)
    valid = np.zeros(n_edges, bool)
    ii_p[:n] = ii
    jj_p[:n] = jj
    valid[:n] = True
    return ii_p, jj_p, valid


def neighbour_graph(n_frames: int):
    """The default graph: every ordered pair with 1 ≤ |i−j| ≤ 2 (train.py:96-99)."""
    pairs = [(i, j) for i in range(n_frames) for j in range(n_frames) if i != j and abs(i - j) <= 2]
    return np.array([i for i, _ in pairs], np.int64), np.array([j for _, j in pairs], np.int64)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the port's DroidNet.")
    ap.add_argument("--name", default="droid", help="experiment name")
    ap.add_argument("--ckpt", help="parameters to start from: the JAX package's .msgpack, a "
                    "reference .pth or a parameter checkpoint of this trainer")
    ap.add_argument("--resume", help="full train state of this trainer (.pt): parameters, "
                    "optimizer state and step")
    ap.add_argument("--schedule", default="onecycle", choices=["onecycle", "constant", "cosine"])
    ap.add_argument("--lr_final", type=float, default=5e-6, help="cosine schedule floor")
    ap.add_argument("--state_every", type=int, default=0,
                    help="save the full train state every N steps (0 = off)")
    ap.add_argument("--datapath", default=None, help="TartanAir root (not ported yet)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on procedurally rendered scenes (data/synthetic.py)")
    ap.add_argument("--varied_frac", type=float, default=0.7,
                    help="synthetic: fraction of clips from the varied curriculum")
    ap.add_argument("--pool", type=int, default=256, help="synthetic: clips rendered ahead")
    ap.add_argument("--ckpt_every", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=250000)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--n_frames", type=int, default=7)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--w1", type=float, default=10.0)
    ap.add_argument("--w2", type=float, default=0.01)
    ap.add_argument("--w3", type=float, default=0.05)
    ap.add_argument("--edges", type=int, default=24)
    ap.add_argument("--restart_prob", type=float, default=0.2)
    ap.add_argument("--clip", type=float, default=2.5)
    ap.add_argument("--crop", type=int, nargs=2, default=[384, 512])
    ap.add_argument("--seed", type=int, default=12345,
                    help="seed of the randomised-graph and restart draws")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--device", default=None, help="training device (default: cuda)")
    return ap


def train(args: argparse.Namespace, db, device, log=print) -> List[Dict]:
    """The training loop over ``db.clips(args.batch)`` until ``args.steps``
    optimizer steps. Returns one record per step: the restart passes, the
    last pass's metrics, whether every gradient entry of the sum was
    finite, and the step's wall time (ended by a device synchronise)."""
    return _train(args, db, device, log)


def _train(args: argparse.Namespace, db, device, log=print,
           step_context: Optional[Callable[[int], ContextManager]] = None) -> List[Dict]:
    """:func:`train`, with ``step_context(step)``, where given, entered
    around each step's passes and update (a profiler); ``step`` counts
    from 1."""
    from ..models.droid_net import DroidNet, init_params
    from ..ops import lie
    from ..train import checkpoints
    from ..train.graph_utils import build_frame_graph, graph_to_edge_list
    from ..train.trainer import TrainConfig, init_state, make_train_step
    from ..utils.logger import Logger
    from ..utils.profiling import StageTimers

    cfg = TrainConfig(
        lr=args.lr, steps=args.steps, n_frames=args.n_frames, num_iters=args.iters, clip=args.clip,
        w1=args.w1, w2=args.w2, w3=args.w3, restart_prob=args.restart_prob,
        schedule=args.schedule, lr_final=args.lr_final,
    )
    N = args.n_frames
    base_ii, base_jj = neighbour_graph(N)
    n_edges = max(len(base_ii), args.edges + 4 * N)  # the static pad

    model = DroidNet()
    model.load_state_dict(init_params(0))
    model.to(device)
    state = init_state(model, cfg)
    if args.resume:
        state = checkpoints.restore_train_state(args.resume, state)
        log(f"resumed the train state of {args.resume} (step {state['step']})")
    elif args.ckpt:
        model.load_state_dict(checkpoints.load_params(args.ckpt))
    step_fn = make_train_step(cfg, base_ii, base_jj)

    rng = np.random.default_rng(args.seed)  # the graph and restart draws
    logger = Logger(args.name, total_steps=state["step"])
    timers = StageTimers()
    history = []
    if state["step"] >= args.steps:
        return history
    for batch in db.clips(args.batch):
        # poses: the dataset's camera→world to world→camera (train.py:86-88)
        Ps = lie.inv(torch.from_numpy(batch["poses"])).numpy()
        Gs0 = Ps.copy()
        Gs0[:, 1:] = Ps[:, 1:2]
        if rng.random() < 0.5:
            graph = build_frame_graph(batch["poses"][0], batch["disps"][0], batch["intrinsics"][0],
                                      num=args.edges)
            gi, gj, _ = graph_to_edge_list(graph)
        else:
            gi, gj = base_ii, base_jj
        ii_p, jj_p, valid = pad_graph(gi, gj, n_edges)
        h, w = batch["images"].shape[2] // 8, batch["images"].shape[3] // 8
        train_batch = {
            "images": batch["images"], "poses": Ps, "disps": batch["disps"],
            "intrinsics": batch["intrinsics"], "poses_init": Gs0,
            "disps_init": np.ones((batch["images"].shape[0], N, h, w), np.float32),
            "ii": ii_p, "jj": jj_p, "edge_valid": valid,
        }

        # random restarts: the passes' gradients add up and one optimizer
        # step follows; only a finite estimate initialises the next pass
        t0 = time.perf_counter()
        context = step_context(state["step"] + 1) if step_context else contextlib.nullcontext()
        with context, timers.time("step", sync=True):
            grads_sum, passes, r = None, 0, -1.0
            while r < args.restart_prob:
                r = rng.random()
                grads, metrics, out = step_fn.grad(state["model"], train_batch)
                passes += 1
                grads_sum = grads if grads_sum is None else {k: grads_sum[k] + g for k, g in grads.items()}
                poses_re = out.poses[-1]
                disps_re = out.disps_up[-1][:, :, 3::8, 3::8]
                if bool(torch.isfinite(poses_re).all() and torch.isfinite(disps_re).all()):
                    train_batch = {**train_batch, "poses_init": poses_re,
                                   "disps_init": disps_re.clamp(1e-3, 10.0)}
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads_sum.values()]).all())
            state = step_fn.apply(state, grads_sum)
        step = state["step"]
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(dict(step=step, passes=passes, metrics=metrics, grads_finite=finite,
                            wall_s=time.perf_counter() - t0, n_valid_edges=int(valid.sum())))
        logger.push(metrics)

        if step % args.ckpt_every == 0:
            path = f"checkpoints/{args.name}_{step:06d}.pth"
            checkpoints.save_params(path, state["model"])
            log(f"saved {path}")
        if args.state_every and step % args.state_every == 0:
            path = f"checkpoints/{args.name}_state_{step:06d}.pt"
            checkpoints.save_train_state(path, state)
            log(f"saved {path}")
        if step >= args.steps:
            break
    log(timers.report())
    return history


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = parser()
    args = ap.parse_args(argv)
    if args.num_processes > 1:
        ap.error("--num_processes > 1 needs the port's distributed backend, not ported yet "
                 "(ROADMAP.md, queue 1, item 6); train in one process")
    if args.datapath or not args.synthetic:
        ap.error("TartanAir (--datapath) needs the port's file readers, not ported yet "
                 "(ROADMAP.md, queue 1, item 3); the port trains with --synthetic")

    from ..data.synthetic import SyntheticDataset
    from ..runtime.droid import resolve_device

    device = resolve_device(args.device)
    db = SyntheticDataset(n_frames=args.n_frames, image_size=tuple(args.crop), seed=0,
                          pool=args.pool, varied_frac=args.varied_frac)
    print("dataset: procedural synthetic scenes")
    return train(args, db, device)


if __name__ == "__main__":
    main()
