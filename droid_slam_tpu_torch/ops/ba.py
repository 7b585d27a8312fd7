"""Gauss-Newton bundle adjustment of the SLAM runtime (PyTorch).

Counterpart of the JAX package's ``ops/ba.py`` pieces that the runtime
runs: per-edge linearisation (:func:`build_edge_blocks`), range-masked
block scatters, the windowed pose system, and two Schur-complement
iterations:

* :func:`ba_iteration_dense_window` — the fused tracking step's: the
  pose-depth coupling scattered into a dense window. ``t0``, ``t1`` and
  ``kf0`` are 0-dim tensors, so the iteration never reads to the host.
* :func:`ba_iteration` / :func:`ba_solve` — the global backend's and the
  trajectory filler's: a block-sparse Schur complement over a pair
  schedule that the host builds once per graph (:class:`SchurPairs`);
  ``t0`` and ``t1`` are host integers.

The damped solve is an f32 Cholesky plus one refinement step, and a failed
factorisation yields a zero update (droid.cpp:568-578). Poses [t0, t1) are
optimised, poses below t0 held fixed.

The training path's differentiable BA (:func:`bundle_adjust`, over
:func:`schur_solve`) is batched over a leading dimension, where the JAX
package vmaps; :func:`cholesky_solve` carries the analytic backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import lie
from . import projective as pops
from .segment import segment_sum

Tensor = torch.Tensor


class _CholeskySolve(torch.autograd.Function):
    """x = H⁻¹ b with the analytic backward of the solve (geom/chol.py:21-30):
    db = H⁻¹ g, dH = −x dbᵀ. Where the factorisation fails, x, db and dH
    are zero."""

    @staticmethod
    def forward(ctx, H: Tensor, b: Tensor) -> Tensor:
        H = 0.5 * (H + H.transpose(-1, -2))
        L, info = torch.linalg.cholesky_ex(H)
        x = torch.cholesky_solve(b, L)
        ok = (info == 0)[..., None, None] & torch.isfinite(x).all(dim=(-2, -1), keepdim=True)
        x = torch.where(ok, x, torch.zeros_like(x))
        ctx.save_for_backward(L, x, ok)
        return x

    @staticmethod
    def backward(ctx, g: Tensor):
        L, x, ok = ctx.saved_tensors
        db = torch.where(ok, torch.cholesky_solve(g, L), torch.zeros_like(g))
        return -torch.matmul(x, db.transpose(-1, -2)), db


def cholesky_solve(H: Tensor, b: Tensor) -> Tensor:
    """Solve H x = b for SPD H [..., n, n], b [..., n, k]. Returns zeros
    where the factorisation fails (geom/chol.py:5-19), with zero gradients
    there too. H is symmetrised first, as JAX's Cholesky does; the backward
    is the solve's analytic one (``ops/ba.py:57-85`` of the JAX package)."""
    return _CholeskySolve.apply(H, b)


class EdgeBlocks(NamedTuple):
    """Per-edge Gauss-Newton blocks. N edges, HW pixels at 1/8 resolution."""

    Hii: Tensor  # [N, 6, 6]
    Hij: Tensor  # [N, 6, 6]
    Hji: Tensor  # [N, 6, 6]
    Hjj: Tensor  # [N, 6, 6]
    vi: Tensor  # [N, 6]
    vj: Tensor  # [N, 6]
    Ei: Tensor  # [N, 6, HW]  pose-i / depth-ii coupling
    Ej: Tensor  # [N, 6, HW]  pose-j / depth-ii coupling
    Ck: Tensor  # [N, HW]     depth-block diagonal
    wk: Tensor  # [N, HW]     depth rhs


def build_edge_blocks(
    target: Tensor,
    weight: Tensor,
    poses: Tensor,
    disps: Tensor,
    intrinsics: Tensor,
    ii: Tensor,
    jj: Tensor,
    edge_valid: Optional[Tensor] = None,
    min_depth: float = pops.MIN_DEPTH_NATIVE,
) -> EdgeBlocks:
    """Linearise the reprojection factors of each edge
    (src/droid_kernels_cpu.cc:67-300): weights scaled by 1e-3, zeroed where
    the transformed depth is below ``min_depth``; stereo self edges
    (ii == jj) drop out of every pose block but stay in the depth system.

    target/weight [N, H, W, 2]; poses [F, 7]; disps [F, H, W];
    intrinsics [F, 4]; ii/jj [N] int64 in range. Computed on [N, hw] planes.
    """
    N = ii.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    dtype = poses.dtype

    Gij = pops.relative_poses(poses, ii, jj)  # [N, 7]
    t = lie.translation(Gij)
    R = lie.to_matrix(Gij)[..., :3, :3]  # [N, 3, 3]

    def col(v, k):
        return v[:, k, None]

    tx, ty, tz = col(t, 0), col(t, 1), col(t, 2)

    grid = pops.coords_grid(ht, wd, dtype=dtype, device=poses.device).reshape(hw, 2)
    gx, gy = grid[:, 0][None], grid[:, 1][None]
    intr_i = intrinsics[ii]
    intr_j = intrinsics[jj]
    X0 = (gx - col(intr_i, 2)) / col(intr_i, 0)
    Y0 = (gy - col(intr_i, 3)) / col(intr_i, 1)
    d0 = disps[ii].reshape(N, hw)

    def rot(k):
        return R[:, k, 0, None] * X0 + R[:, k, 1, None] * Y0 + R[:, k, 2, None]

    X1 = rot(0) + tx * d0
    Y1 = rot(1) + ty * d0
    Z1 = rot(2) + tz * d0

    fx, fy, cx, cy = (col(intr_j, k) for k in range(4))
    zi = 1.0 / torch.where(Z1 < 0.5 * min_depth, torch.ones_like(Z1), Z1)
    x1 = fx * X1 * zi + cx
    y1 = fy * Y1 * zi + cy
    valid = (Z1 > min_depth).to(dtype)

    tflat = target.reshape(N, hw, 2)
    wflat = weight.reshape(N, hw, 2)
    ru = tflat[..., 0] - x1
    rv = tflat[..., 1] - y1
    wu = 0.001 * valid * wflat[..., 0]
    wv = 0.001 * valid * wflat[..., 1]
    if edge_valid is not None:
        ev = edge_valid.to(dtype)[:, None]
        wu = wu * ev
        wv = wv * ev

    # Jp rows (au, 0, bu), (0, av, bv); Ja columns per twist component
    au = fx * zi
    bu = -fx * X1 * zi * zi
    av = fy * zi
    bv = -fy * Y1 * zi * zi
    zero = torch.zeros_like(d0)
    Jju = torch.stack([au * d0, zero, bu * d0, bu * Y1, au * Z1 - bu * X1, -au * Y1], dim=1)
    Jjv = torch.stack([zero, av * d0, bv * d0, -av * Z1 + bv * Y1, -bv * X1, av * X1], dim=1)

    # depth Jacobian: Jz = Jp · (t, 1)
    Jzu = au * tx + bu * tz
    Jzv = av * ty + bv * tz

    # Ji = −A · Jj, A = [[Rᵀ, 0], [−Rᵀ[t]×, Rᵀ]] (the matrix form of adjT)
    Rt = R.transpose(-1, -2)
    o3 = torch.zeros_like(R)
    tx_, ty_, tz_ = t.unbind(-1)
    zz = torch.zeros_like(tx_)
    t_cross = torch.stack(
        [
            torch.stack([zz, -tz_, ty_], -1),
            torch.stack([tz_, zz, -tx_], -1),
            torch.stack([-ty_, tx_, zz], -1),
        ],
        dim=-2,
    )
    A = torch.cat(
        [torch.cat([Rt, o3], dim=-1), torch.cat([-torch.matmul(Rt, t_cross), Rt], dim=-1)],
        dim=-2,
    )
    Jiu = -torch.matmul(A, Jju)
    Jiv = -torch.matmul(A, Jjv)

    nself = (ii != jj).to(dtype)[:, None]
    wpu = (wu * nself)[:, None, :]
    wpv = (wv * nself)[:, None, :]
    wJiu, wJiv = wpu * Jiu, wpv * Jiv
    wJju, wJjv = wpu * Jju, wpv * Jjv

    def gram(wa_u, wa_v, b_u, b_v):
        return torch.matmul(wa_u, b_u.transpose(1, 2)) + torch.matmul(wa_v, b_v.transpose(1, 2))

    Hii = gram(wJiu, wJiv, Jiu, Jiv)
    Hij = gram(wJiu, wJiv, Jju, Jjv)
    Hji = gram(wJju, wJjv, Jiu, Jiv)
    Hjj = gram(wJju, wJjv, Jju, Jjv)

    vi = (wJiu * ru[:, None]).sum(-1) + (wJiv * rv[:, None]).sum(-1)
    vj = (wJju * ru[:, None]).sum(-1) + (wJjv * rv[:, None]).sum(-1)

    Ei = wJiu * Jzu[:, None, :] + wJiv * Jzv[:, None, :]
    Ej = wJju * Jzu[:, None, :] + wJjv * Jzv[:, None, :]

    Ck = wu * Jzu * Jzu + wv * Jzv * Jzv
    wk = wu * ru * Jzu + wv * rv * Jzv

    return EdgeBlocks(Hii, Hij, Hji, Hjj, vi, vj, Ei, Ej, Ck, wk)


def _scatter_rows(blocks: Tensor, idx: Tensor, ok: Tensor, n_seg: int) -> Tensor:
    """Sum rows of ``blocks`` [N, ...] into [n_seg, ...] at ``idx``; rows
    with ``ok`` false are dropped. Accumulates in f32, in an order fixed by
    the inputs on either device (:func:`.segment.segment_sum`)."""
    return segment_sum(torch.where(ok, idx, n_seg), blocks.float(), n_seg).to(blocks.dtype)


def _scatter_mat(blocks: Tensor, ii: Tensor, jj: Tensor, n: int, m: int) -> Tensor:
    """Scatter-add [N, ...] blocks into a dense [n, m, ...] grid, dropping
    out-of-range (ii, jj) (geom/ba.py:12-14)."""
    ok = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    flat = _scatter_rows(blocks, ii * m + jj, ok, n * m)
    return flat.reshape((n, m) + blocks.shape[1:])


def _scatter_vec(blocks: Tensor, ii: Tensor, n: int) -> Tensor:
    return _scatter_rows(blocks, ii, (ii >= 0) & (ii < n), n)


def _assemble_pose_system(blocks: EdgeBlocks, ii_r: Tensor, jj_r: Tensor, P: int, t0, t1):
    """Scatter the per-edge 6×6 blocks into the dense windowed pose system.
    Rows past the live window [0, t1-t0) get identity so the damped solve
    returns zeros there. Returns (Hm [P6, P6], v [P, 6], live [P], live6)."""
    H = (
        _scatter_mat(blocks.Hii, ii_r, ii_r, P, P)
        + _scatter_mat(blocks.Hij, ii_r, jj_r, P, P)
        + _scatter_mat(blocks.Hji, jj_r, ii_r, P, P)
        + _scatter_mat(blocks.Hjj, jj_r, jj_r, P, P)
    )
    v = _scatter_vec(blocks.vi, ii_r, P) + _scatter_vec(blocks.vj, jj_r, P)
    dtype = blocks.Hii.dtype
    live = (torch.arange(P, device=ii_r.device) < (t1 - t0)).to(dtype)
    live6 = live.repeat_interleave(6)
    Hm = H.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    Hm = Hm * live6[:, None] * live6[None, :] + torch.diag(1.0 - live6)
    return Hm, v * live[:, None], live, live6


def _place_rows(rows: Tensor, start: Tensor, total: int) -> Tensor:
    """Zeros [total, ...] with ``rows`` [K, ...] written at ``start`` (clamped
    so the block fits, as a dynamic update slice does)."""
    K = rows.shape[0]
    out = rows.new_zeros((total + K,) + rows.shape[1:])
    at = start.clamp(0, total) + torch.arange(K, device=rows.device)
    return out.index_copy_(0, at, rows)[:total]


def ba_iteration_dense_window(
    poses: Tensor,
    disps: Tensor,
    intrinsics: Tensor,  # [4]
    disps_sens: Tensor,
    target: Tensor,  # [N, H, W, 2]
    weight: Tensor,
    eta: Tensor,  # [F, H, W]
    ii: Tensor,  # [N]
    jj: Tensor,
    edge_valid: Tensor,  # [N] bool
    t0: Tensor,  # 0-dim — first optimised pose
    t1: Tensor,  # 0-dim — one past the last optimised pose
    kf0: Tensor,  # 0-dim — first depth frame of the window
    window: int,  # static pose-window pad (Pw)
    kwin: int,  # static depth-window pad (Ka)
    lm: float = 1e-4,
    ep: float = 0.1,
    alpha: float = 0.05,
    schur_dtype: torch.dtype = torch.float32,
):
    """One GN iteration with a dense windowed Schur complement
    (``ops/ba.py::ba_iteration_dense_window`` of the JAX package).

    The pose-depth coupling is scattered into a dense E [kwin, window·6, HW]
    and S = Σ_k E_k Q_k E_kᵀ is one contraction. ``schur_dtype`` is the
    storage dtype of E; the contractions accumulate in f32. The RGB-D prior
    adds ``alpha`` to the depth diagonal where ``disps_sens`` > 0. Every
    valid edge must satisfy kf0 ≤ ii < kf0 + kwin.
    """
    F = poses.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    Pw = window
    dev = poses.device
    dtype = poses.dtype
    sd = schur_dtype

    blocks = build_edge_blocks(
        target, weight, poses, disps, intrinsics.expand(F, 4), ii, jj,
        edge_valid=edge_valid, min_depth=pops.MIN_DEPTH_NATIVE,
    )

    ii_r = ii - t0
    jj_r = jj - t0
    Hm, v, live, live6 = _assemble_pose_system(blocks, ii_r, jj_r, Pw, t0, t1)

    # ---- depth system over the kwin-frame window ----
    k_rel = ii - kf0
    ks = torch.arange(kwin, device=dev)
    kframes = kf0 + ks
    in_window = (kframes >= t0) & (kframes < t1) & (kframes < F)
    touched = ((k_rel.clamp(0, kwin - 1)[None, :] == ks[:, None]) & edge_valid[None, :]).any(dim=1)
    in_kx = in_window | (touched & (kframes < F))

    safe_k = kframes.clamp(max=F - 1)
    sens_w = disps_sens[safe_k].reshape(kwin, hw)
    disps_w = disps[safe_k].reshape(kwin, hw)
    eta_w = eta[safe_k].reshape(kwin, hw)

    C = _scatter_vec(blocks.Ck, k_rel, kwin)
    w_rhs = _scatter_vec(blocks.wk, k_rel, kwin)
    m = (sens_w > 0).to(dtype)
    C = C + m * alpha + (1.0 - m) * eta_w
    w_rhs = w_rhs - m * alpha * (disps_w - sens_w)
    Q = in_kx.to(dtype)[:, None] / torch.where(C == 0.0, torch.ones_like(C), C)

    # ---- dense windowed E: edge couplings scattered to (k, p) cells ----
    in_k = edge_valid & (k_rel >= 0) & (k_rel < kwin)
    k_cell = k_rel.clamp(0, kwin - 1) * Pw
    # the Ei rows, then the Ej rows, each in edge order
    cells = [torch.where(in_k & (p_rel >= 0) & (p_rel < Pw), k_cell + p_rel, kwin * Pw)
             for p_rel in (ii_r, jj_r)]
    E = segment_sum(torch.cat(cells), torch.cat([blocks.Ei, blocks.Ej]).to(sd).float(), kwin * Pw)
    E = E.to(sd).reshape(kwin, Pw * 6, hw) * live6[None, :, None].to(sd)

    EQ = E * Q[:, None, :].to(sd)
    E32, EQ32 = E.float(), EQ.float()
    S = torch.einsum("kux,kvx->uv", EQ32, E32)
    v_schur = torch.einsum("kux,kx->u", EQ32, w_rhs.to(sd).float())

    A = Hm - S * live6[:, None] * live6[None, :]
    eye = torch.eye(Pw * 6, dtype=dtype, device=dev)
    Ad = A + (ep + lm * A) * eye * live6[:, None]
    rhs = (v.reshape(Pw * 6) - v_schur).reshape(Pw * 6, 1)
    dx = cholesky_solve(Ad, rhs)
    dx = dx + cholesky_solve(Ad, rhs - torch.matmul(Ad, dx))  # f32 refinement
    dx6 = dx.reshape(Pw * 6) * live6

    dz = Q * (w_rhs - torch.einsum("kux,u->kx", E32, dx6.to(sd).float()))

    poses = lie.retr(poses, _place_rows(dx6.reshape(Pw, 6), t0, F))
    disps = disps + _place_rows(dz, kf0, F).reshape(F, ht, wd)
    return poses, disps


# -----------------------------------------------------------------------------
# training-path BA (differentiable, batched; geom/ba.py)
# -----------------------------------------------------------------------------


def _scatter_mat_batched(blocks: Tensor, b: Tensor, r: Tensor, c: Tensor, B: int, n: int,
                         m: int) -> Tensor:
    """Scatter-add [K, ...] blocks into [B, n, m, ...] at (b, r, c), dropping
    out-of-range (r, c): :func:`_scatter_mat` per batch element."""
    ok = (r >= 0) & (c >= 0) & (r < n) & (c < m)
    flat = _scatter_rows(blocks, (b * n + r) * m + c, ok, B * n * m)
    return flat.reshape((B, n, m) + blocks.shape[1:])


def _scatter_vec_batched(blocks: Tensor, b: Tensor, r: Tensor, B: int, n: int) -> Tensor:
    ok = (r >= 0) & (r < n)
    return _scatter_rows(blocks, b * n + r, ok, B * n).reshape((B, n) + blocks.shape[1:])


def schur_solve(H: Tensor, E: Tensor, C: Tensor, v: Tensor, w: Tensor, ep: float = 0.1,
                lm: float = 1e-4) -> Tuple[Tensor, Tensor]:
    """Dense Schur-complement solve (geom/chol.py:46-73), batched over
    leading dims.

    H [..., P, P, 6, 6]; E [..., P, M, 6, HW]; C, w [..., M, HW]; v [..., P, 6].
    Returns (dx [..., P, 6], dz [..., M, HW]).
    """
    P = H.shape[-4]
    M, HW = C.shape[-2:]
    lead = H.shape[:-4]
    Hm = H.transpose(-3, -2).reshape(lead + (P * 6, P * 6))
    Em = E.transpose(-3, -2).reshape(lead + (P * 6, M * HW))
    Q = (1.0 / C).reshape(lead + (1, M * HW))

    eye = torch.eye(P * 6, dtype=Hm.dtype, device=Hm.device)
    Hm = Hm + (ep + lm * Hm) * eye

    vm = v.reshape(lead + (P * 6, 1))
    wm = w.reshape(lead + (M * HW, 1))

    Qc = Q.transpose(-1, -2)  # [..., M·HW, 1]
    S = Hm - torch.matmul(Em, Qc * Em.transpose(-1, -2))
    rhs = vm - torch.matmul(Em, Qc * wm)

    dx = cholesky_solve(S, rhs)
    dz = Qc * (wm - torch.matmul(Em.transpose(-1, -2), dx))
    return dx.reshape(lead + (P, 6)), dz.reshape(lead + (M, HW))


def bundle_adjust(
    target: Tensor,
    weight: Tensor,
    eta: Tensor,
    poses: Tensor,
    disps: Tensor,
    intrinsics: Tensor,
    ii: Tensor,
    jj: Tensor,
    fixedp: int = 1,
    ep: float = 0.1,
    lm: float = 1e-4,
    motion_only: bool = False,
    min_depth: float = pops.MIN_DEPTH,
) -> Tuple[Tensor, Tensor]:
    """One differentiable DBA step over frames [fixedp, F) of each batch
    element (geom/ba.py:31-106), batched over the leading dim B where the
    JAX package vmaps ``ops/ba.py::bundle_adjust``.

    target/weight [B, N, H, W, 2]; eta [B, F, H, W] (damping of every frame:
    frames without edges keep their depths, their Schur rows being zero);
    poses [B, F, 7]; disps [B, F, H, W]; intrinsics [B, F, 4]; ii/jj [N]
    int64, one graph for the batch. All F frames are depth columns (a
    static shape; columns of frames without edges are zero). With
    ``motion_only`` only the poses move.
    """
    B, F = poses.shape[:2]
    N = ii.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    dev = poses.device
    frame0 = torch.arange(B, device=dev)[:, None] * F
    blocks = build_edge_blocks(
        target.reshape((B * N,) + target.shape[2:]), weight.reshape((B * N,) + weight.shape[2:]),
        poses.reshape(B * F, 7), disps.reshape(B * F, ht, wd), intrinsics.reshape(B * F, 4),
        (frame0 + ii).reshape(-1), (frame0 + jj).reshape(-1), min_depth=min_depth,
    )

    P = F - fixedp
    b = torch.arange(B, device=dev).repeat_interleave(N)
    ii_b, jj_b = ii.repeat(B), jj.repeat(B)
    ii_r, jj_r = ii_b - fixedp, jj_b - fixedp

    H = (
        _scatter_mat_batched(blocks.Hii, b, ii_r, ii_r, B, P, P)
        + _scatter_mat_batched(blocks.Hij, b, ii_r, jj_r, B, P, P)
        + _scatter_mat_batched(blocks.Hji, b, jj_r, ii_r, B, P, P)
        + _scatter_mat_batched(blocks.Hjj, b, jj_r, jj_r, B, P, P)
    )
    v = _scatter_vec_batched(blocks.vi, b, ii_r, B, P) + _scatter_vec_batched(blocks.vj, b, jj_r, B, P)
    fixed = poses.new_zeros((B, fixedp, 6))

    if motion_only:
        Hm = H.transpose(-3, -2).reshape(B, P * 6, P * 6)
        eye = torch.eye(P * 6, dtype=Hm.dtype, device=dev)
        Hm = Hm + (ep + lm * Hm) * eye
        dx = cholesky_solve(Hm, v.reshape(B, P * 6, 1)).reshape(B, P, 6)
        return lie.retr(poses, torch.cat([fixed, dx], dim=1)), disps

    # depth columns over all frames
    E = (_scatter_mat_batched(blocks.Ei, b, ii_r, ii_b, B, P, F)
         + _scatter_mat_batched(blocks.Ej, b, jj_r, ii_b, B, P, F))
    C = _scatter_vec_batched(blocks.Ck, b, ii_b, B, F)
    w = _scatter_vec_batched(blocks.wk, b, ii_b, B, F)
    C = C + eta.reshape(B, F, hw) + 1e-7

    dx, dz = schur_solve(H, E, C, v, w, ep=ep, lm=lm)

    poses = lie.retr(poses, torch.cat([fixed, dx], dim=1))
    disps = disps + dz.reshape(B, F, ht, wd)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, disps.clamp(min=0.0)


# -----------------------------------------------------------------------------
# block-sparse Schur BA (global backend, trajectory filler)
# -----------------------------------------------------------------------------


def pair_schedule(blk_k: np.ndarray, blk_ok: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All ordered block pairs (a, b) with blk_k[a] == blk_k[b], both valid
    (droid.cpp:613-645). Order: groups by ascending keyframe, a-major within
    a group, block ids ascending — the nested-loop enumeration's order."""
    ids = np.nonzero(blk_ok)[0]
    if ids.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(blk_k[ids], kind="stable")
    sid = ids[order]  # block ids sorted by keyframe, ascending within groups
    _, starts, counts = np.unique(blk_k[ids][order], return_index=True, return_counts=True)

    # a: each block of a size-n group repeated n times (a-major order)
    a_idx = np.repeat(sid, np.repeat(counts, counts))
    # b: the group tiled n times, aligned with the flattened pair order
    seg_len = counts * counts
    total = int(seg_len.sum())
    seg_off = np.repeat(np.cumsum(seg_len) - seg_len, seg_len)
    within = np.arange(total) - seg_off
    b_idx = sid[np.repeat(starts, seg_len) + within % np.repeat(counts, seg_len)]
    return a_idx, b_idx


class SchurPairs(NamedTuple):
    """Block-pair schedule of the block-sparse Schur product.

    Blocks are the rows of E = concat(Ei_window [window], Ej_edges [N]):
    block b couples the inverse depths of keyframe k(b) with pose p(b).
    S[p(a), p(b)] += E_a · diag(Q_k) · E_bᵀ for every ordered pair (a, b)
    with k(a) == k(b), both poses inside [t0, t1). The JAX package pads the
    list to a power of two for compile reuse; the port keeps only the pairs.
    """

    pair_a: Tensor  # [NP] int64 block index
    pair_b: Tensor  # [NP] int64 block index

    @staticmethod
    def build(ii: np.ndarray, jj: np.ndarray, edge_valid: np.ndarray, t0: int, t1: int,
              window: int, device=None) -> "SchurPairs":
        """ii/jj/edge_valid: [N] host edge lists. Window rows are block ids
        [0, window); edge e is block window + e."""
        if t1 - t0 > window:
            raise ValueError(f"BA window span {t1 - t0} > static window pad {window}")
        blk_k = np.concatenate([np.arange(t0, t0 + window), ii])
        blk_p = np.concatenate([np.arange(t0, t0 + window), jj])
        blk_ok = (
            np.concatenate([np.arange(window) < t1 - t0, np.asarray(edge_valid, bool)])
            & (blk_p >= t0) & (blk_p < t1)
        )
        pa, pb = pair_schedule(blk_k, blk_ok)
        return SchurPairs(torch.as_tensor(pa, device=device), torch.as_tensor(pb, device=device))


def _pair_products(E_blocks: Tensor, Qk: Tensor, pairs: SchurPairs, chunk: int = 2048) -> Tensor:
    """S_pair[n] = E[a_n] · diag(Q[k(a_n)]) · E[b_n]ᵀ → [NP, 6, 6] f32, in
    chunks of ``chunk`` pairs to bound the two gathered [chunk, 6, HW]
    copies. E_blocks [NB, 6, HW] and Qk [NB, HW] are in the Schur storage
    dtype; E·Q rounds to it, the product accumulates in f32."""
    out = [E_blocks.new_zeros((0, 6, 6), dtype=torch.float32)]
    for s in range(0, pairs.pair_a.shape[0], chunk):
        a = pairs.pair_a[s : s + chunk]
        b = pairs.pair_b[s : s + chunk]
        Ea = E_blocks[a] * Qk[a][:, None, :]
        out.append(torch.bmm(Ea.float(), E_blocks[b].float().transpose(1, 2)))
    return torch.cat(out)


class BAProblem(NamedTuple):
    """Inputs of :func:`ba_iteration` besides the state."""

    target: Tensor  # [N, H, W, 2]
    weight: Tensor  # [N, H, W, 2]
    eta: Tensor  # [F, H, W] per-frame damping
    ii: Tensor  # [N] int64, in range
    jj: Tensor  # [N]
    edge_valid: Tensor  # [N] bool
    t0: int  # first optimised pose
    t1: int  # one past the last optimised pose
    pairs: SchurPairs


def _damp(A: Tensor, lm: float, ep: float, live6: Tensor) -> Tensor:
    """((1+lm)·diag + ep) damping of the live rows (droid.cpp:559-579)."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return A + (ep + lm * A) * eye * live6[:, None]


def _window_rows(rows: Tensor, t0: int, total: int) -> Tensor:
    """Zeros [total, ...] with ``rows`` [K, ...] at t0 (clamped so the block
    fits, as a dynamic update slice does)."""
    return _place_rows(rows, torch.as_tensor(t0, device=rows.device), total)


def ba_iteration(
    poses: Tensor,
    disps: Tensor,
    intrinsics: Tensor,  # [4]
    disps_sens: Tensor,
    prob: BAProblem,
    window: int,
    lm: float = 1e-4,
    ep: float = 0.1,
    alpha: float = 0.05,
    motion_only: bool = False,
    schur_dtype: torch.dtype = torch.float32,
):
    """One Gauss-Newton iteration with the block-sparse Schur complement
    (``ops/ba.py::ba_iteration`` of the JAX package, droid.cpp:743-795).

    poses [F, 7], disps/disps_sens [F, H, W]; ``window`` is the padded size
    of the pose window [t0, t1). Depths of the window's frames and of every
    frame that is the source of a valid edge are updated. ``schur_dtype``
    is the storage dtype of the E blocks; their products accumulate in f32.
    With ``motion_only`` only the poses move (no refinement solve, as in
    the JAX package).
    """
    F = poses.shape[0]
    ht, wd = disps.shape[-2:]
    hw = ht * wd
    t0, t1 = prob.t0, prob.t1
    P = window
    dev = poses.device
    dtype = poses.dtype
    sd = schur_dtype

    blocks = build_edge_blocks(
        prob.target, prob.weight, poses, disps, intrinsics.expand(F, 4), prob.ii, prob.jj,
        edge_valid=prob.edge_valid, min_depth=pops.MIN_DEPTH_NATIVE,
    )
    Hm, v, live, live6 = _assemble_pose_system(blocks, prob.ii - t0, prob.jj - t0, P, t0, t1)

    if motion_only:
        dx = cholesky_solve(_damp(Hm, lm, ep, live6), v.reshape(P * 6, 1)).reshape(P, 6)
        return lie.retr(poses, _window_rows(dx * live[:, None], t0, F)), disps

    # ---- depth system over all frames ----
    frames = torch.arange(F, device=dev)
    in_window = (frames >= t0) & (frames < t1)
    touched = ((prob.ii[None, :] == frames[:, None]) & prob.edge_valid[None, :]).any(dim=1)
    in_kx = in_window | touched  # frames whose depths are updated

    m = (disps_sens.reshape(F, hw) > 0).to(dtype)
    C = _scatter_vec(blocks.Ck, prob.ii, F) + m * alpha + (1.0 - m) * prob.eta.reshape(F, hw)
    w = _scatter_vec(blocks.wk, prob.ii, F) - m * alpha * (disps - disps_sens).reshape(F, hw)
    Q = in_kx.to(dtype)[:, None] / torch.where(C == 0.0, torch.ones_like(C), C)

    # ---- block-sparse Schur complement ----
    # E block rows: the window's accumulated Ei rows, then per-edge Ej rows
    Ei_acc = _scatter_vec(blocks.Ei, prob.ii, F)  # [F, 6, HW]
    s0 = min(max(t0, 0), F)  # a window past the buffer reads zero rows
    Ei_win = torch.cat([Ei_acc, Ei_acc.new_zeros((P, 6, hw))])[s0 : s0 + P]
    E_blocks = torch.cat([Ei_win, blocks.Ej]).to(sd)  # [P+N, 6, HW]

    win = t0 + torch.arange(P, device=dev)
    blk_k = torch.cat([win, prob.ii])
    blk_p = torch.cat([win, prob.jj])
    blk_ok = (
        torch.cat([torch.arange(P, device=dev) < (t1 - t0), prob.edge_valid])
        & (blk_p >= t0) & (blk_p < t1)
    )
    okf = blk_ok[:, None].to(dtype)
    k_safe = blk_k.clamp(0, F - 1)  # rows of invalid blocks are zeroed below
    Qk = (Q[k_safe] * okf).to(sd)

    S_pairs = _pair_products(E_blocks, Qk, prob.pairs)  # f32 accumulation
    S = _scatter_mat(S_pairs, blk_p[prob.pairs.pair_a] - t0, blk_p[prob.pairs.pair_b] - t0, P, P)

    # v −= E Q w per block, scattered to the block's pose row
    qw = ((Q * w)[k_safe] * okf).to(sd)
    v_blocks = torch.bmm(E_blocks.float(), qw.float()[..., None])[..., 0]
    v = v - _scatter_vec(v_blocks, blk_p - t0, P)

    Sm = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    Ad = _damp(Hm - Sm * live6[:, None] * live6[None, :], lm, ep, live6)
    rhs = v.reshape(P * 6, 1)
    dx = cholesky_solve(Ad, rhs)
    dx = dx + cholesky_solve(Ad, rhs - torch.matmul(Ad, dx))  # f32 refinement
    dx = dx.reshape(P, 6) * live[:, None]

    # ---- back-substitute depths: dz = Q (w − Eᵀ dx) ----
    dx_pose = dx[(blk_p - t0).clamp(0, P - 1)] * okf
    w_corr = torch.bmm(dx_pose.to(sd).float()[:, None, :], E_blocks.float())[:, 0]  # [P+N, HW]
    dz = Q * (w - _scatter_vec(w_corr, blk_k, F))

    poses = lie.retr(poses, _window_rows(dx, t0, F))
    disps = disps + dz.reshape(F, ht, wd)
    return poses, disps


def ba_solve(
    poses: Tensor,
    disps: Tensor,
    intrinsics: Tensor,
    disps_sens: Tensor,
    prob: BAProblem,
    window: int,
    iterations: int = 2,
    lm: float = 1e-4,
    ep: float = 0.1,
    motion_only: bool = False,
    schur_dtype: torch.dtype = torch.float32,
):
    """``iterations`` GN iterations, then disparities clamped at 0.001
    unless ``motion_only`` (depth_video.py:190-209)."""
    for _ in range(iterations):
        poses, disps = ba_iteration(
            poses, disps, intrinsics, disps_sens, prob, window,
            lm=lm, ep=ep, motion_only=motion_only, schur_dtype=schur_dtype,
        )
    if not motion_only:
        disps = disps.clamp(min=0.001)
    return poses, disps
