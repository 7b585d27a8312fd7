"""Training entry point of the port.

The port's counterpart of the JAX package's ``apps/train.py`` (reference
train.py), on TartanAir (``--datapath``: :class:`..data.dataset.TartanAir`,
clips sampled along each scene's covisibility graph with a mean flow
between ``--fmin`` and ``--fmax``, augmented and cropped to ``--crop``) or
on procedurally rendered clips (``--synthetic``): per batch the ground-truth poses
are inverted to world→camera and the estimate starts at [P0, P1, P1, ...]
(train.py:86-88,95-101), half the batches draw a randomised covisibility
graph padded to a fixed length (train.py:91-99), and random restarts run
further passes from the last estimate whose gradients add up before one
optimizer step (train.py:102-118).

Usage:
  python -m droid_slam_tpu_torch.apps.train --datapath <TartanAir root> [--name droid]
      [--fmin 8.0] [--fmax 96.0] [--cache_dir DIR]
      [--batch 4] [--steps 250000] [--crop 384 512] [--ckpt weights.msgpack]
      [--resume checkpoints/droid_state_001000.pt] [--device cpu]
      [--num_processes N --process_id K --coordinator HOST:PORT]
  python -m droid_slam_tpu_torch.apps.train --synthetic [--pool 256] ...

It runs on CUDA unless ``--device`` names another device. With
``--num_processes`` N > 1, N processes (one per ``--process_id``) train
data-parallel over a ``torch.distributed`` group that meets at
``tcp://HOST:PORT``: NCCL on CUDA (process k on ``cuda:{k % cards}``),
gloo on the CPU. Each process samples its own clips (the dataset seeded
with its id) for its batch / N rows; the graph and restart draws use the
shared ``--seed``, so every process runs the same passes; rank 0's
randomised graph is broadcast; one gradient all-reduce precedes each
optimizer step; rank 0 logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import time
from typing import Callable, ContextManager, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective or a rendezvous of a multi-process run waits for the
# other processes: the JAX trainer's rendezvous timeout
DIST_TIMEOUT_S = 3600.0


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
    ap.add_argument("--datapath", default=None,
                    help="TartanAir root (<root>/<env>/<env>/<Easy|Hard>/<P###>/{image_left,depth_left,"
                    "pose_left.txt})")
    ap.add_argument("--fmin", type=float, default=8.0, help="TartanAir: least mean flow between clip frames")
    ap.add_argument("--fmax", type=float, default=96.0, help="TartanAir: largest mean flow between clip frames")
    ap.add_argument("--cache_dir", default=None,
                    help="TartanAir: where the covisibility graphs are cached (default: data/cache/ of the "
                    "package)")
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
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT where the processes meet (with --num_processes > 1)")
    ap.add_argument("--num_processes", type=int, default=1,
                    help="data-parallel processes; the batch divides over them")
    ap.add_argument("--process_id", type=int, default=0, help="this process's rank")
    ap.add_argument("--device", default=None, help="training device (default: cuda)")
    return ap


def train(args: argparse.Namespace, db, device, log=print, group=None) -> List[Dict]:
    """The training loop over ``db.clips(args.batch / D)`` until
    ``args.steps`` optimizer steps, D the size of ``group`` (a
    ``torch.distributed`` process group that carries ``device``; None for
    one process). Returns one record per step: the restart passes, the
    last pass's metrics (the global batch's), whether every gradient entry
    of the reduced sum was finite, and the step's wall time (ended by a
    device synchronise)."""
    return _train(args, db, device, log, group=group)


def _broadcast_graph(ii, jj, valid, group, device):
    """Rank 0's padded graph on every rank: a randomised graph is built
    from each rank's own clips."""
    g = torch.as_tensor(np.stack([ii, jj, valid.astype(np.int64)]), device=device)
    dist.broadcast(g, src=dist.get_process_group_ranks(group)[0], group=group)
    g = g.cpu().numpy()
    return g[0], g[1], g[2].astype(bool)


def _train(args: argparse.Namespace, db, device, log=print,
           step_context: Optional[Callable[[int], ContextManager]] = None, group=None) -> List[Dict]:
    """:func:`train`, with ``step_context(step)``, where given, entered
    around each step's passes and update (a profiler); ``step`` counts
    from 1."""
    from ..models.droid_net import DroidNet, init_params
    from ..ops import lie
    from ..parallel.groups import check_device
    from ..train import checkpoints
    from ..train.graph_utils import build_frame_graph, graph_to_edge_list
    from ..train.trainer import (
        TrainConfig,
        allreduce_gradients,
        init_state,
        make_train_step,
        reduce_metrics,
        rendezvous,
        replicate_for_mesh,
    )
    from ..utils.logger import Logger
    from ..utils.profiling import StageTimers

    n_ranks, rank = 1, 0
    if group is not None:
        check_device(group, device)
        n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    if args.batch % n_ranks:
        raise ValueError(f"--batch {args.batch} does not divide over {n_ranks} processes")
    local_batch = args.batch // n_ranks
    is_main = rank == 0

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
    if group is not None:
        replicate_for_mesh(model, group)
    step_fn = make_train_step(cfg, base_ii, base_jj)

    # the graph and restart draws: the shared seed, so every rank takes the
    # same branches and runs the same passes (a rank that ran another
    # number of passes would leave the others in the all-reduce)
    rng = np.random.default_rng(args.seed)
    logger = Logger(args.name, total_steps=state["step"]) if is_main else None
    timers = StageTimers()
    history = []
    if state["step"] >= args.steps:
        return history
    for n_batch, batch in enumerate(db.clips(local_batch)):
        if group is not None and n_batch:
            # one-sided work (rank 0's checkpoints and logging, a slow
            # render) must not let a rank post the next collective long
            # before the others arrive
            rendezvous(f"train_step_{state['step']}", group, timeout_s=DIST_TIMEOUT_S)
        # poses: the dataset's camera→world to world→camera (train.py:86-88)
        Ps = lie.inv(torch.from_numpy(batch["poses"])).numpy()
        Gs0 = Ps.copy()
        Gs0[:, 1:] = Ps[:, 1:2]
        randomized = rng.random() < 0.5
        if randomized:
            graph = build_frame_graph(batch["poses"][0], batch["disps"][0], batch["intrinsics"][0],
                                      num=args.edges)
            gi, gj, _ = graph_to_edge_list(graph)
        else:
            gi, gj = base_ii, base_jj
        ii_p, jj_p, valid = pad_graph(gi, gj, n_edges)
        if group is not None and randomized:
            ii_p, jj_p, valid = _broadcast_graph(ii_p, jj_p, valid, group, device)
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
            grads_sum, passes, r, counts = None, 0, -1.0, {}
            while r < args.restart_prob:
                r = rng.random()
                grads, metrics, out = step_fn.grad(state["model"], train_batch, counts, mesh=group)
                passes += 1
                grads_sum = grads if grads_sum is None else {k: grads_sum[k] + g for k, g in grads.items()}
                poses_re = out.poses[-1]
                disps_re = out.disps_up[-1][:, :, 3::8, 3::8]
                if bool(torch.isfinite(poses_re).all() and torch.isfinite(disps_re).all()):
                    train_batch = {**train_batch, "poses_init": poses_re,
                                   "disps_init": disps_re.clamp(1e-3, 10.0)}
            if group is not None:
                grads_sum = allreduce_gradients(grads_sum, group)
                metrics = reduce_metrics(metrics, counts, group)
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads_sum.values()]).all())
            state = step_fn.apply(state, grads_sum)
        step = state["step"]
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(dict(step=step, passes=passes, metrics=metrics, grads_finite=finite,
                            wall_s=time.perf_counter() - t0, n_valid_edges=int(valid.sum())))
        if group is not None:
            log(f"rank {rank} step {step}: passes {passes}, valid edges {int(valid.sum())}, "
                f"loss {metrics['loss']:.6f}")
        if is_main:
            logger.push(metrics)
        if is_main and step % args.ckpt_every == 0:
            path = f"checkpoints/{args.name}_{step:06d}.pth"
            checkpoints.save_params(path, state["model"])
            log(f"saved {path}")
        if args.state_every and step % args.state_every == 0:
            path = f"checkpoints/{args.name}_state_{step:06d}.pt"
            if is_main:
                checkpoints.save_train_state(path, state)
                log(f"saved {path}")
            if group is not None:  # every rank waits for the file
                rendezvous(f"state_{step}", group, timeout_s=DIST_TIMEOUT_S)
        if step >= args.steps:
            break
    if is_main:
        log(timers.report())
    return history


def dataset(args: argparse.Namespace):
    """The clips of ``args``: TartanAir under ``--datapath`` or rendered
    scenes. Each process samples its own: the dataset is seeded with its
    id."""
    if args.datapath:
        from ..data.dataset import dataset_factory

        db = dataset_factory(["tartan"], datapath=args.datapath, n_frames=args.n_frames, fmin=args.fmin,
                             fmax=args.fmax, crop_size=tuple(args.crop), seed=args.process_id,
                             cache_dir=args.cache_dir)
        if args.process_id == 0:
            print(f"dataset: {len(db)} clips")
        return db
    from ..data.synthetic import SyntheticDataset

    db = SyntheticDataset(n_frames=args.n_frames, image_size=tuple(args.crop), seed=args.process_id,
                          pool=args.pool, varied_frac=args.varied_frac)
    if args.process_id == 0:
        print("dataset: procedural synthetic scenes")
    return db


def init_group(args: argparse.Namespace, device: torch.device):
    """The default process group of ``--num_processes`` processes at
    ``tcp://--coordinator``: NCCL for a CUDA device, gloo for the CPU, with a
    timeout of DIST_TIMEOUT_S seconds."""
    cuda = device.type == "cuda"
    kw = dict(device_id=device) if cuda else {}
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kw,
    )
    return dist.group.WORLD


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = parser()
    args = ap.parse_args(argv)
    if args.num_processes > 1:
        if not args.coordinator:
            ap.error("--num_processes > 1 needs --coordinator HOST:PORT")
        if not 0 <= args.process_id < args.num_processes:
            ap.error(f"--process_id {args.process_id} out of range for {args.num_processes} processes")
    if args.batch % args.num_processes:
        ap.error(f"--batch {args.batch} does not divide over {args.num_processes} processes")
    if bool(args.datapath) == bool(args.synthetic):
        ap.error("name one dataset: --datapath <TartanAir root> or --synthetic")
    if args.datapath and not os.path.isdir(args.datapath):
        ap.error(f"--datapath {args.datapath} is not a directory")

    from ..runtime.droid import resolve_device

    device = resolve_device(args.device)
    group = None
    if args.num_processes > 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device(f"cuda:{args.process_id % torch.cuda.device_count()}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        group = init_group(args, device)
    try:
        db = dataset(args)
        return train(args, db, device, group=group)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
