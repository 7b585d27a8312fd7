"""Multi-process global BA on a tracked session, on the port.

Counterpart of the JAX repo's ``tools/mp_backend.py`` and its launcher
``tools/mp_backend.sh``, in one program. The launcher (``main``) serves a
``TCPStore`` on a port the kernel picks, spawns one process per rank that
joins it, and holds the store until every rank has exited. Each rank
tracks the same 24-frame synthetic sequence (96×128, f32, the shipped
weights), so all ranks hold the same state, then runs the global backend
twice from one snapshot of the video:

* single-device: ``DroidBackend(update_op, video, config)(8)``, the oracle;
* distributed: ``DroidBackend(..., mesh=group)(8)``, edge-sharded over the
  ranks (:mod:`..parallel.sharded_ba`), one all-reduce of the pose system
  per GN iteration;

and holds the distributed poses and disparities to the oracle's within
5e-3 and the scale-corrected ATE of the keyframes within 1e-3 (the JAX
tool's bounds).

  python -m droid_slam_tpu_torch.tools.mp_backend [--num_processes 2] [--device cpu]

The ranks run on CUDA over NCCL, rank k on ``cuda:k``, unless ``--device
cpu`` asks for gloo on the CPU. NCCL puts no two ranks on one GPU, so
more ranks than cards are refused.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np

FRAMES = 24
SIZE = (96, 128)
STEPS = 8
POSE_TOL = DISP_TOL = 5e-3  # the sharded GN sums in another order, over 8 steps
ATE_TOL = 1e-3
TIMEOUT_S = 600.0
SHIPPED_WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "droid_synth.msgpack"


def run_rank(rank: int, world: int, store_port: int, device: str) -> dict:
    """One rank's work (module docstring); raises RuntimeError when a bound
    does not hold. Returns the rank's readings."""
    import torch
    import torch.distributed as dist

    from ..apps.evaluate import synthetic_streams
    from ..eval.ate import Trajectory, ate_rmse
    from ..ops import lie
    from ..runtime import Droid, DroidConfig
    from ..runtime.backend import DroidBackend
    from ..train.trainer import rendezvous

    def log(msg: str):
        print(f"[rank {rank}] {msg}", flush=True)  # one write: the ranks share the output

    cuda = device != "cpu"
    dev = torch.device(f"cuda:{rank}") if cuda else torch.device("cpu")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", store_port, is_master=False, timeout=timeout)
    kw = {}
    if cuda:
        torch.cuda.set_device(dev)
        kw = dict(device_id=dev)
    dist.init_process_group("nccl" if cuda else "gloo", store=store, world_size=world, rank=rank,
                            timeout=timeout, **kw)
    group = dist.group.WORLD
    try:
        config = DroidConfig(image_size=SIZE, buffer=64, warmup=8, compute_dtype="float32")
        track, _, ref = synthetic_streams(7, FRAMES, SIZE)
        droid = Droid(config, weights=str(SHIPPED_WEIGHTS), device=dev)
        for t, image, intrinsics in track:
            droid.track(t, image, intrinsics=intrinsics)
        droid.sync()
        v = droid._sync_fused_state()
        t = v.counter
        log(f"tracked {FRAMES} frames -> {t} keyframes")

        names = ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps")
        snapshot = {k: getattr(v, k).clone() for k in names}
        dirty0 = v.dirty.copy()

        def restore():
            for k, val in snapshot.items():
                setattr(v, k, val.clone())
            v.dirty = dirty0.copy()

        def gauge_ate():
            """Scale-corrected ATE of the keyframe trajectory."""
            est = lie.inv(v.poses[:t]).cpu().numpy()
            return float(ate_rmse(ref, Trajectory.from_poses(v.tstamp[:t].cpu().numpy(), est),
                                  correct_scale=True, max_dt=0.25)["ate_rmse"])

        update_op = droid._update_op
        with torch.no_grad():
            restore()
            DroidBackend(update_op, v, config)(STEPS)
            poses_single, disps_single = v.poses[:t].cpu().numpy(), v.disps[:t].cpu().numpy()
            ate_single = gauge_ate()
            log(f"single-device backend: ATE {ate_single:.4f}")

            rendezvous("backend_mesh_enter", group, timeout_s=TIMEOUT_S)
            restore()
            runs = DroidBackend(update_op, v, config, mesh=group)(STEPS)
            poses_mesh, disps_mesh = v.poses[:t].cpu().numpy(), v.disps[:t].cpu().numpy()
            ate_mesh = gauge_ate()
        log(f"{world}-process distributed backend: ATE {ate_mesh:.4f} ({runs[0]} edges, {runs[1]} chunks)")

        perr = float(np.abs(poses_mesh - poses_single).max())
        derr = float(np.abs(disps_mesh - disps_single).max())
        log(f"pose parity {perr:.2e}, disp parity {derr:.2e}, ATE delta {abs(ate_mesh - ate_single):.2e}")
        failed = [f"{name} {got:.3e} (bound {tol})" for name, got, tol in (
            ("poses", perr, POSE_TOL), ("disparities", derr, DISP_TOL),
            ("ATE", abs(ate_mesh - ate_single), ATE_TOL)) if not got < tol]
        if failed:
            raise RuntimeError(f"rank {rank}: the distributed backend differs from the single-device one: "
                               + ", ".join(failed))
        log("MP_BACKEND_RUN_OK")
        return dict(keyframes=t, pose_diff=perr, disp_diff=derr, ate_single=ate_single, ate_mesh=ate_mesh)
    finally:
        dist.destroy_process_group()


def launch(world: int, device: str) -> int:
    """Start ``world`` ranks around one store; returns 0 when every rank
    passed, else 1."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mp.spawn(run_rank, args=(world, store.port, device), nprocs=world)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"mp_backend: {e}", file=sys.stderr)
        return 1
    finally:
        del store  # released only once no rank can still join it
    print("MP_BACKEND_DONE", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_processes", type=int, default=2, help="ranks, one process each")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL, rank k on cuda:k; cpu: gloo")
    args = ap.parse_args(argv)
    if args.num_processes < 1:
        ap.error("--num_processes must be at least 1")
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            print("mp_backend: no CUDA device; run with --device cpu for gloo ranks on the CPU", file=sys.stderr)
            return 1
        if args.num_processes > cards:
            print(f"mp_backend: {args.num_processes} ranks need {args.num_processes} CUDA devices and this "
                  f"machine has {cards}: NCCL puts no two ranks on one GPU. Run with --device cpu for gloo "
                  "ranks on the CPU.", file=sys.stderr)
            return 1
    return launch(args.num_processes, args.device)


if __name__ == "__main__":
    sys.exit(main())
