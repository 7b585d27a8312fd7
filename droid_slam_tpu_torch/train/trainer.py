"""Training step: unrolled DroidNet forward → differentiable DBA → three
losses → gradient guards, clipping and AdamW on a learning-rate schedule
(PyTorch).

Counterpart of the JAX package's ``train/trainer.py`` (reference train.py).
The optimizer computes what the JAX package's optax chain computes:
non-finite gradient entries zeroed, then ``clip_by_global_norm`` (scale by
clip/norm when norm ≥ clip, no epsilon), then AdamW (decoupled decay on the
old parameter, eps outside the square root: torch's ``AdamW``) with the
learning rate of optax's schedules written out.

Data parallelism runs over a ``torch.distributed`` process group, the
counterpart of the JAX trainer's mesh with a ``"dp"`` axis: each rank
trains on its contiguous block of the batch rows (:func:`shard_batch_for_mesh`),
the parameters start as rank 0's (:func:`replicate_for_mesh`), and the
gradient all-reduce that XLA inserts in the JAX package is one collective
of one flat f32 buffer per optimizer step (:func:`allreduce_gradients`),
ahead of the optimizer, so the non-finite zeroing and the clip see the
global gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.droid_net import DroidNet, TrainingOutputs
from ..ops import lie
from ..parallel.groups import carries, check_device
from . import losses as L

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainConfig:
    lr: float = 2.5e-4  # train.py:156
    steps: int = 250000
    n_frames: int = 7
    num_iters: int = 15  # unroll steps (train.py:161)
    fixedp: int = 2
    clip: float = 2.5  # gradient-norm clip (train.py:125,160)
    weight_decay: float = 1e-5
    w1: float = 10.0  # geodesic (train.py:163)
    w2: float = 0.01  # residual
    w3: float = 0.05  # flow
    restart_prob: float = 0.2
    pct_start: float = 0.01
    # "onecycle" (the reference's, train.py:157) from scratch, "constant" for
    # low-lr fine-tunes, "cosine" to decay lr → lr_final over `steps`
    schedule: str = "onecycle"
    lr_final: float = 5e-6  # cosine schedule floor


def _cosine_interpolate(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def learning_rate(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at each update count (0 for the first update), as
    optax's ``constant_schedule``, ``cosine_decay_schedule`` and
    ``cosine_onecycle_schedule`` give it. The warm-up spans at least one
    step: optax's onecycle divides by the interval's length, and a
    ``steps·pct_start`` below 1 would give a NaN rate at step 0."""
    steps = max(cfg.steps, 2)
    pct = min(max(cfg.pct_start, 1.0 / steps), 0.5)
    if cfg.schedule == "constant":
        return lambda count: cfg.lr
    if cfg.schedule == "cosine":
        alpha = cfg.lr_final / cfg.lr

        def cosine(count):
            decay = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
            return cfg.lr * ((1.0 - alpha) * decay + alpha)

        return cosine
    if cfg.schedule != "onecycle":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    # optax's piecewise cosine interpolation between the accumulated values
    # at 0, int(pct·steps) and steps; init = peak/25, final = init/1e4
    div, final_div = 25.0, 1e4
    bounds = (0, int(pct * steps), int(steps))
    values = np.cumprod([cfg.lr / div, div, 1.0 / (div * final_div)]).tolist()

    def onecycle(count):
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                frac = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                return _cosine_interpolate(values[k], values[k + 1], frac)
        return values[2]

    return onecycle


class Optimizer:
    """optax's ``chain(zero_nonfinite, clip_by_global_norm(clip),
    adamw(schedule, weight_decay))`` over named parameters, on torch's
    ``AdamW`` (b1 0.9, b2 0.999, eps 1e-8, optax's defaults)."""

    def __init__(self, cfg: TrainConfig, named_params: Iterable[Tuple[str, Tensor]]):
        self.names, self.params = zip(*named_params)
        self.clip = cfg.clip
        self.schedule = learning_rate(cfg)
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=cfg.weight_decay)

    def step(self, grads: Mapping[str, Tensor]) -> None:
        """One update from gradients keyed by parameter name."""
        g = [grads[n] for n in self.names]
        # one bad batch (a degenerate scene, non-finite through the BA) must
        # not poison the parameters; inf too, or the clip scales by clip/inf
        g = [torch.where(torch.isfinite(x), x, torch.zeros_like(x)) for x in g]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        for p, x in zip(self.params, g):
            p.grad = torch.where(norm < self.clip, x, x / norm * self.clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module) -> Optimizer:
    return Optimizer(cfg, model.named_parameters())


def init_state(model: DroidNet, cfg: TrainConfig) -> Dict[str, Any]:
    """The train state: the model (its parameters), the optimizer and the
    count of optimizer steps taken."""
    return {"model": model, "optimizer": make_optimizer(cfg, model), "step": 0}


def batch_tensors(batch: Mapping[str, Any], device) -> Dict[str, Tensor]:
    """A host batch (numpy arrays or tensors) on ``device``: edge lists as
    int64, the validity mask as bool, images as they are (uint8 or float),
    the rest float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in ("ii", "jj"):
            t = t.long()
        elif k == "edge_valid":
            t = t.bool()
        elif k != "images":
            t = t.float()
        out[k] = t.to(device)
    return out


def make_train_step(cfg: TrainConfig, ii: np.ndarray, jj: np.ndarray):
    """The train step ``train_step(state, batch) → (state, metrics, out)``
    with its two halves: ``train_step.grad(model, batch) → (grads,
    metrics, out)`` (forward and backward, no update: the restart passes
    add their gradients up, train.py:102-118) and ``train_step.apply(state,
    grads) → state`` (one optimizer update; ``step`` counts batches).

    The batch may carry a randomised graph ``ii``/``jj``/``edge_valid``
    padded to one length; ``ii``/``jj`` given here are the default graph.
    ``train_step.grad``'s optional ``counts`` dict receives the
    denominators of the ratio metrics (:func:`reduce_metrics`).

    ``train_step.grad(..., mesh=group)`` (a process group of D ranks, each
    on its equal share of the global batch) returns the gradient of the
    rank's part of the global mean loss, its local mean loss / D, which
    :func:`allreduce_gradients` sums. Every loss term is a mean over a
    count that grows with the batch, so each entry's gradient is then the
    one the whole batch gives it. Dividing after the reduction instead
    would not do: the update operator's ``grad_clip`` zeroes the entries
    of its gradient above 0.01, and the gradient of the local mean is D
    times the whole batch's in every entry, so it would zero others. The
    metrics stay the local batch's."""
    ii = torch.as_tensor(np.asarray(ii), dtype=torch.long)
    jj = torch.as_tensor(np.asarray(jj), dtype=torch.long)

    def loss_fn(model: DroidNet, batch: Mapping[str, Any], counts: Optional[Dict[str, Tensor]] = None):
        dev = next(model.parameters()).device
        b = batch_tensors(batch, dev)
        images = b["images"]  # [B, F, H, W, 3] RGB
        Ps = b["poses"]  # [B, F, 7] ground truth, world→camera
        disps_gt = b["disps"]  # [B, F, H, W] ground-truth inverse depth (full res)
        intrinsics = b["intrinsics"]  # [B, F, 4] full res
        g_ii = b.get("ii", ii.to(dev))
        g_jj = b.get("jj", jj.to(dev))
        g_valid = b.get("edge_valid", torch.ones(g_ii.shape, dtype=torch.bool, device=dev))

        out = model(b["poses_init"], images, b["disps_init"], intrinsics / 8.0, g_ii, g_jj,
                    num_steps=cfg.num_iters, fixedp=cfg.fixedp, edge_valid=g_valid)

        geo, geo_m = L.geodesic_loss(Ps, out.poses, g_ii, g_jj, do_scale=False, edge_valid=g_valid)
        res, res_m = L.residual_loss(out.residuals, edge_valid=g_valid.repeat(images.shape[0]))
        # the flow loss at full resolution with full-resolution intrinsics,
        # as the reference (train.py:112)
        flo, flo_m = L.flow_loss(Ps, disps_gt, out.poses, out.disps_up, intrinsics, counts=counts)
        total = cfg.w1 * geo + cfg.w2 * res + cfg.w3 * flo
        return total, ({"loss": total, **geo_m, **res_m, **flo_m}, out)

    def grad_step(model: DroidNet, batch: Mapping[str, Any], counts: Optional[Dict[str, Tensor]] = None,
                  mesh=None):
        names, params = zip(*model.named_parameters())
        total, (metrics, out) = loss_fn(model, batch, counts)
        share = total if mesh is None else total / dist.get_world_size(mesh)
        grads = torch.autograd.grad(share, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(zip(names, grads)), metrics, TrainingOutputs(*(x.detach() for x in out))

    def apply_step(state: Dict[str, Any], grads: Mapping[str, Tensor]) -> Dict[str, Any]:
        state["optimizer"].step(grads)
        state["step"] += 1
        return state

    def train_step(state, batch):
        grads, metrics, out = grad_step(state["model"], batch)
        return apply_step(state, grads), metrics, out

    train_step.grad = grad_step
    train_step.apply = apply_step
    return train_step


def make_initial_batch(rng: np.random.Generator, batch: int, n_frames: int,
                       image_size: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """A random batch with the trainer's initialisation conventions
    (train.py:95-101): Gs starts at [P0, P1, P1, ...], disp0 = 1."""
    H, W = image_size
    h, w = H // 8, W // 8
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (batch, n_frames, 1))
    tw = 0.03 * rng.standard_normal((batch, n_frames, 6)).astype(np.float32)
    poses = lie.retr(torch.from_numpy(poses), torch.from_numpy(tw)).numpy()

    init = poses.copy()
    init[:, 1:] = init[:, 1:2]
    return {
        "images": rng.integers(0, 255, (batch, n_frames, H, W, 3)).astype(np.uint8),
        "poses": poses,
        "disps": (0.5 + rng.random((batch, n_frames, H, W))).astype(np.float32),
        "intrinsics": np.tile(np.array([W, W, W / 2, H / 2], np.float32), (batch, n_frames, 1)),
        "poses_init": init,
        "disps_init": np.ones((batch, n_frames, h, w), np.float32),
    }


# -----------------------------------------------------------------------------
# data parallelism over a process group (the JAX trainer's mesh helpers)
# -----------------------------------------------------------------------------

_REPLICATED_KEYS = {"ii", "jj", "edge_valid"}  # the graph, shared across the batch


def shard_batch_for_mesh(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """The rows of a global batch that this rank trains on: rank r of D
    takes the contiguous block [r·B/D, (r+1)·B/D) of every per-sample key
    (the layout of the JAX package's ``shard_batch_for_mesh``); the graph
    keys are shared. ``mesh`` is a process group; B must divide by D. In
    ``apps/train.py`` each rank draws its own local batch instead."""
    D, r = dist.get_world_size(mesh), dist.get_rank(mesh)
    out = {}
    for k, v in batch.items():
        if k in _REPLICATED_KEYS:
            out[k] = v
            continue
        if v.shape[0] % D:
            raise ValueError(f"batch of {v.shape[0]} rows ({k}) does not divide over {D} ranks")
        n = v.shape[0] // D
        out[k] = v[r * n : (r + 1) * n]
    return out


def host_local_slice(arr, local_rows: Optional[int] = None):
    """This rank's rows of an output of its own grad step: the output
    itself. In the JAX package a jitted output may span other processes'
    devices and this picks the local rows; a rank of the port computes
    only its own rows, so this is the identity (``local_rows`` is checked,
    where given)."""
    if local_rows is not None and arr.shape[0] != local_rows:
        raise ValueError(f"{arr.shape[0]} rows, expected this rank's {local_rows}")
    return arr


def rendezvous(name: str, group=None, timeout_s: float = 3600.0) -> None:
    """A barrier of the group's ranks that fails after ``timeout_s``
    seconds instead of waiting for ever: gloo's monitored barrier, which
    names the rank that did not arrive, or NCCL's barrier on this rank's
    device, under the group's own timeout. ``name`` labels the failure."""
    try:
        if carries(group, "cpu"):
            dist.monitored_barrier(group=group, timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(f"rendezvous {name!r} failed: {e}") from e


def _flat(tensors, device) -> Tensor:
    return torch.cat([t.detach().reshape(-1).to(device=device, dtype=torch.float32) for t in tensors])


def _unflat(flat: Tensor, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at : at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def replicate_for_mesh(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every rank's model takes rank 0's parameters and buffers: one
    broadcast of one flat f32 buffer (the JAX package places the state
    replicated on the mesh)."""
    state = list(model.state_dict().values())
    dev = state[0].device
    check_device(mesh, dev)
    flat = _flat(state, dev)
    src = dist.get_process_group_ranks(mesh if mesh is not None else dist.group.WORLD)[0]
    dist.broadcast(flat, src=src, group=mesh)
    with torch.no_grad():
        for t, v in zip(state, _unflat(flat, state)):
            t.copy_(v)
    return model


def allreduce_gradients(grads: Mapping[str, Tensor], mesh) -> Dict[str, Tensor]:
    """The sum over the group's ranks of each gradient: one all-reduce
    (SUM) of one flat f32 buffer. Each rank's gradient is that of its part
    of the global mean loss (``train_step.grad(..., mesh=)``), so the sum
    is the gradient of the global mean. Summing a step's restart passes
    first and reducing once is linear, so it gives what the JAX package's
    per-pass reduction gives, up to float order."""
    names = list(grads)
    tensors = [grads[k] for k in names]
    check_device(mesh, tensors[0].device)
    flat = _flat(tensors, tensors[0].device)
    dist.all_reduce(flat, group=mesh)
    return dict(zip(names, _unflat(flat, tensors)))


# metrics whose denominator is a count that differs across ranks (the valid
# pixels of flow_loss); every other metric is a mean over an equal count
RATIO_METRICS = {"f_error": "valid_px", "1px": "valid_px"}


def reduce_metrics(metrics: Mapping[str, Tensor], counts: Mapping[str, Tensor], mesh) -> Dict[str, Tensor]:
    """The global batch's metrics from each rank's, in one all-reduce: a
    mean over the ranks for the means over equal counts (the masked means
    of the losses share one denominator when the local batches are equal),
    and for the ratio metrics (:data:`RATIO_METRICS`) the summed numerators
    over the summed denominators from ``counts``."""
    names = list(metrics)
    dev = metrics[names[0]].device
    check_device(mesh, dev)
    dens = sorted(set(RATIO_METRICS.values()))
    parts = [metrics[k] * counts[RATIO_METRICS[k]] if k in RATIO_METRICS else metrics[k] for k in names]
    flat = _flat(parts + [counts[d] for d in dens], dev)
    dist.all_reduce(flat, group=mesh)
    den = dict(zip(dens, flat[len(names):]))
    D = dist.get_world_size(mesh)
    return {k: (flat[i] / den[RATIO_METRICS[k]].clamp(min=1) if k in RATIO_METRICS else flat[i] / D)
            for i, k in enumerate(names)}
