"""Edge-sharded global bundle adjustment over a ``torch.distributed``
process group, with a distributed Schur reduction (PyTorch).

Counterpart of the JAX package's ``parallel/sharded_ba.py``, which runs the
same recipe over a ``jax.sharding.Mesh`` axis with ``shard_map``. Here the
mesh is a process group of D ranks; rank r is shard r and holds the whole
replicated state (poses, disparities, the edges' targets and weights) on
its own device:

* rank r owns the contiguous keyframes [r·fd, (r+1)·fd), fd = ceil(F/D) of
  the counter F, and every edge whose source keyframe it owns, so each
  depth block C_k, w_k, E_k is rank-local;
* the per-edge linearisation (:func:`..ops.ba.build_edge_blocks`), the
  pose system H, v and the Schur complement S = E Q Eᵀ run on the local
  edges only;
* ONE ``all_reduce`` of one flat f32 buffer that holds (H − S, v − v_schur)
  combines the damped Gauss-Newton system (the JAX package's two psums
  compute the same sum);
* the damped Cholesky solve is replicated (it is small), the depth
  back-substitution dz = Q (w − Eᵀ dx) is rank-local, and ONE
  ``all_gather_into_tensor`` assembles the owned dz rows in the
  concatenated [D·fd, hw] layout (the JAX package's tiled ``all_gather``).

Every float scatter goes through :func:`..ops.segment.segment_sum`, in an
order fixed by the inputs, so a sharded solve repeats bit for bit. The
sharded solve computes in f32 throughout: the JAX package's sharded path
has no ``schur_dtype``, while its single-device twin
(:func:`..ops.ba.ba_solve`, which the backend calls without a mesh) stores
E in the compute dtype; the port keeps that difference.

The JAX package's power-of-two padding of the per-shard edge and pair
lists is for XLA's static shapes; the port keeps only the real rows. Its
placement and compile machinery (``_put``, ``host_replicated``, the
AOT-then-barrier sequence) has no counterpart: the plan's index tensors go
to the rank's device once per graph (:meth:`ShardedBAPlan.place`, the
counterpart of ``place_plan_constants``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ba as ba_ops
from ..ops import lie
from ..ops import projective as pops
from .groups import all_gather_rows, check_device

Tensor = torch.Tensor


def edge_owners(ii: np.ndarray, n_shards: int, num_frames: int) -> np.ndarray:
    """The shard that owns each edge: the one owning its source keyframe,
    clip(ii // fd, 0, D − 1) with fd = ceil(num_frames / D)."""
    fd = -(-num_frames // n_shards)
    return np.clip(np.asarray(ii) // fd, 0, n_shards - 1)


class PlacedPlan(NamedTuple):
    """A plan's index tensors on one device."""

    ii: Tensor  # [Ne] int64 global frame ids
    jj: Tensor  # [Ne]
    perm: Tensor  # [Ne] int64 original edge index
    pairs: ba_ops.SchurPairs  # local block ids


class ShardedBAPlan(NamedTuple):
    """One shard's part of the host-built layout: the edges whose source
    keyframe the shard owns, in the order of the edge store, and its local
    Schur pair list. Pair lists address LOCAL block ids: 0..fd−1 the owned
    window rows, fd..fd+Ne−1 the local edges. Every rank builds the same
    layout from the same host lists and keeps its own shard's rows."""

    shard: int
    n_shards: int
    frames_per_shard: int  # fd
    f0: int  # first owned frame
    ii: np.ndarray  # [Ne] int64
    jj: np.ndarray  # [Ne]
    perm: np.ndarray  # [Ne] original edge index (gathers target and weight)
    pair_a: np.ndarray  # [NP] int64 local block ids
    pair_b: np.ndarray  # [NP]

    @staticmethod
    def build(ii: np.ndarray, jj: np.ndarray, valid: np.ndarray, n_shards: int, num_frames: int,
              t0: int, t1: int, shard: int) -> "ShardedBAPlan":
        """``shard``'s plan of D = ``n_shards`` for the edge store's host
        lists ii/jj/valid [N]; ``num_frames`` is the keyframe counter,
        [t0, t1) the optimised poses."""
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} out of range for {n_shards} shards")
        ii = np.asarray(ii, np.int64)
        jj = np.asarray(jj, np.int64)
        fd = -(-num_frames // n_shards)
        owner = edge_owners(ii, n_shards, num_frames)
        idx = np.nonzero(np.asarray(valid, bool) & (owner == shard))[0]
        f0 = shard * fd
        s_ii, s_jj = ii[idx], jj[idx]

        # local Schur blocks: [owned window rows (fd)] + [local edges]
        own = f0 + np.arange(fd)
        blk_k = np.concatenate([own, s_ii])
        blk_p = np.concatenate([own, s_jj])
        blk_ok = (
            np.concatenate([(own >= t0) & (own < t1) & (own < num_frames), np.ones(len(idx), bool)])
            & (blk_p >= t0) & (blk_p < t1)
        )
        pa, pb = ba_ops.pair_schedule(blk_k, blk_ok)
        return ShardedBAPlan(
            shard=shard, n_shards=n_shards, frames_per_shard=fd, f0=f0, ii=s_ii, jj=s_jj,
            perm=idx.astype(np.int64), pair_a=pa.astype(np.int64), pair_b=pb.astype(np.int64),
        )

    def place(self, device) -> PlacedPlan:
        """The index tensors on ``device``: per graph, not per GN step."""
        def put(x):
            return torch.as_tensor(x, dtype=torch.long, device=device)

        return PlacedPlan(put(self.ii), put(self.jj), put(self.perm),
                          ba_ops.SchurPairs(put(self.pair_a), put(self.pair_b),
                                            torch.ones(len(self.pair_a), dtype=torch.bool, device=device)))



def _local_iteration(group, plan: ShardedBAPlan, c: PlacedPlan, target: Tensor, weight: Tensor,
                     poses: Tensor, disps: Tensor, intrinsics0: Tensor, disps_sens: Tensor,
                     eta: Tensor, t0: int, t1: int, window: int, lm: float, ep: float,
                     alpha: float) -> Tuple[Tensor, Tensor]:
    """One GN iteration on this rank (``local_iteration`` of the JAX
    package): target/weight are the local edges' rows; the rest is the
    replicated state."""
    F = poses.shape[0]
    h, w = disps.shape[-2:]
    hw = h * w
    fd = plan.frames_per_shard
    f0 = plan.f0
    Pw = window
    dev = poses.device
    dtype = poses.dtype
    D = plan.n_shards

    blocks = ba_ops.build_edge_blocks(
        target, weight, poses, disps, intrinsics0.expand(F, 4), c.ii, c.jj,
        min_depth=pops.MIN_DEPTH_NATIVE,
    )

    # ---- pose system: rank-local partial sums, window-relative ----
    ii_r = c.ii - t0
    jj_r = c.jj - t0
    H = (
        ba_ops._scatter_mat(blocks.Hii, ii_r, ii_r, Pw, Pw)
        + ba_ops._scatter_mat(blocks.Hij, ii_r, jj_r, Pw, Pw)
        + ba_ops._scatter_mat(blocks.Hji, jj_r, ii_r, Pw, Pw)
        + ba_ops._scatter_mat(blocks.Hjj, jj_r, jj_r, Pw, Pw)
    )
    v = ba_ops._scatter_vec(blocks.vi, ii_r, Pw) + ba_ops._scatter_vec(blocks.vj, jj_r, Pw)

    # ---- owned depth blocks (every edge of an owned frame is local) ----
    k_local = c.ii - f0  # [Ne] in [0, fd)
    C_own = ba_ops._scatter_vec(blocks.Ck, k_local, fd)  # [fd, hw]
    w_own = ba_ops._scatter_vec(blocks.wk, k_local, fd)
    E_win = ba_ops._scatter_vec(blocks.Ei, k_local, fd)  # [fd, 6, hw]

    own_frames = f0 + torch.arange(fd, device=dev)
    own_ok = own_frames < F
    safe = own_frames.clamp(max=F - 1)
    sens_own = disps_sens[safe].reshape(fd, hw)
    disps_own = disps[safe].reshape(fd, hw)
    eta_own = eta[safe].reshape(fd, hw)

    m = (sens_own > 0).to(dtype)
    C = C_own + m * alpha + (1.0 - m) * eta_own
    w_rhs = w_own - m * alpha * (disps_own - sens_own)

    in_window = own_ok & (own_frames >= t0) & (own_frames < t1)
    touched = torch.zeros(fd, dtype=torch.bool, device=dev)
    touched[k_local.clamp(0, fd - 1)] = True
    in_kx = (in_window | (touched & own_ok)).to(dtype)
    Q = in_kx[:, None] / torch.where(C == 0.0, torch.ones_like(C), C)

    # ---- local Schur blocks and their pair products ----
    E_blocks = torch.cat([E_win, blocks.Ej])  # [fd + Ne, 6, hw]
    blk_k = torch.cat([torch.arange(fd, device=dev), k_local])
    k_safe = blk_k.clamp(0, fd - 1)
    blk_p = torch.cat([own_frames, c.jj])
    blk_ok = (
        torch.cat([in_window, torch.ones_like(c.ii, dtype=torch.bool)])
        & (blk_p >= t0) & (blk_p < t1)
    )
    okf = blk_ok[:, None].to(dtype)
    Qk = Q[k_safe] * okf
    S_pairs = ba_ops._pair_products(E_blocks, Qk, c.pairs)
    S = ba_ops._scatter_mat(S_pairs, blk_p[c.pairs.pair_a] - t0, blk_p[c.pairs.pair_b] - t0, Pw, Pw)
    v_blocks = torch.bmm(E_blocks, ((Q * w_rhs)[k_safe] * okf)[..., None])[..., 0]
    v_schur = ba_ops._scatter_vec(v_blocks, blk_p - t0, Pw)

    # ---- THE collective: one all-reduce of the combined damped-GN system.
    # H and S enter the solve only as H − S (and v, v_schur as v − v_schur)
    n_mat = Pw * Pw * 36
    system = torch.cat([(H - S).reshape(-1), (v - v_schur).reshape(-1)])
    dist.all_reduce(system, group=group)
    A_blk = system[:n_mat].reshape(Pw, Pw, 6, 6)
    rhs_v = system[n_mat:].reshape(Pw, 6)

    # ---- replicated damped solve ----
    live = (torch.arange(Pw, device=dev) < (t1 - t0)).to(dtype)
    live6 = live.repeat_interleave(6)
    Am = A_blk.permute(0, 2, 1, 3).reshape(Pw * 6, Pw * 6)
    A = Am * live6[:, None] * live6[None, :] + torch.diag(1.0 - live6)
    eye = torch.eye(Pw * 6, dtype=dtype, device=dev)
    Ad = A + (ep + lm * A) * eye * live6[:, None]
    rhs = (rhs_v * live[:, None]).reshape(Pw * 6, 1)
    dx = ba_ops.cholesky_solve(Ad, rhs)
    dx = dx + ba_ops.cholesky_solve(Ad, rhs - torch.matmul(Ad, dx))  # f32 refinement
    dx = dx.reshape(Pw, 6) * live[:, None]

    # ---- rank-local depth back-substitution ----
    dx_blocks = dx[(blk_p - t0).clamp(0, Pw - 1)] * okf
    w_corr = torch.bmm(dx_blocks[:, None, :], E_blocks)[:, 0]  # [fd + Ne, hw]
    dz_own = Q * (w_rhs - ba_ops._scatter_vec(w_corr, blk_k, fd))  # [fd, hw]

    # disjoint contiguous ownership: the concatenated gather is the global dz
    dz_all = dz_own.new_empty((D * fd, hw))
    all_gather_rows(dz_all, dz_own, group)
    if D * fd >= F:
        dz = dz_all[:F]
    else:  # buffer frames past the owned ranges hold no edges: dz = 0
        dz = torch.cat([dz_all, dz_all.new_zeros((F - D * fd, hw))])

    # ---- retractions (replicated); the clamp comes once, after the loop
    poses = lie.retr(poses, ba_ops._window_rows(dx, t0, F))
    disps = disps + dz.reshape(F, h, w)
    return poses, disps


def sharded_ba_solve(
    mesh,
    plan: ShardedBAPlan,
    target: Tensor,  # [N, h, w, 2] in the edge store's order
    weight: Tensor,
    eta: Tensor,  # [F, h, w]
    poses: Tensor,
    disps: Tensor,
    intrinsics0: Tensor,
    disps_sens: Tensor,
    t0: int,
    t1: int,
    window: int,
    iterations: int = 2,
    constants: Optional[PlacedPlan] = None,
    lm: float = 1e-5,
    ep: float = 1e-2,
    alpha: float = 0.05,
) -> Tuple[Tensor, Tensor]:
    """``iterations`` sharded GN iterations, then the disparities clamped
    once at 0.001 (:func:`..ops.ba.ba_solve`'s semantics); the backend's
    distributed counterpart of the global BA (droid.cpp:680-798).

    ``mesh`` is a ``torch.distributed`` process group whose size is the
    plan's shard count and whose rank is the plan's shard; its backend must
    carry the state's device (:func:`.groups.check_device`). Every rank
    passes the same replicated state and returns the same poses and
    disparities. ``constants`` is :meth:`ShardedBAPlan.place`'s output,
    hoisted out of a loop over GN steps of one graph."""
    check_device(mesh, poses.device)
    size, rank = dist.get_world_size(mesh), dist.get_rank(mesh)
    if size != plan.n_shards or rank != plan.shard:
        raise ValueError(f"plan for shard {plan.shard} of {plan.n_shards} on rank {rank} of a group of {size}")
    c = constants if constants is not None else plan.place(poses.device)
    # this shard's rows of the per-edge data, gathered on the device
    # (shard_edge_data_device of the JAX package)
    target_l = target[c.perm].float()
    weight_l = weight[c.perm].float()
    for _ in range(iterations):
        poses, disps = _local_iteration(
            mesh, plan, c, target_l, weight_l, poses, disps, intrinsics0, disps_sens, eta,
            t0, t1, window, lm, ep, alpha,
        )
    return poses, disps.clamp(min=0.001)


def sharded_ba_iteration(mesh, plan: ShardedBAPlan, target: Tensor, weight: Tensor, eta: Tensor,
                         poses: Tensor, disps: Tensor, intrinsics0: Tensor, disps_sens: Tensor,
                         t0: int, t1: int, window: int, **kw) -> Tuple[Tensor, Tensor]:
    """One sharded iteration (and the clamp): :func:`sharded_ba_solve` with
    ``iterations=1``."""
    return sharded_ba_solve(mesh, plan, target, weight, eta, poses, disps, intrinsics0, disps_sens,
                            t0, t1, window, iterations=1, **kw)
