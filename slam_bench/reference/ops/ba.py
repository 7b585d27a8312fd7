"""Gauss-Newton bundle adjustment of the SLAM runtime (PyTorch).

Counterpart of the JAX package's ``ops/ba.py`` pieces that the runtime
runs: per-edge linearisation (:func:`build_edge_blocks`), range-masked
block scatters, the windowed pose system, and one Schur-complement
iteration, :func:`ba_iteration_dense_window`, the fused tracking step's:
the pose-depth coupling scattered into a dense window. ``t0``, ``t1`` and
``kf0`` are 0-dim tensors, so the iteration never reads to the host. (The
global backend's block-sparse Schur BA is not copied: no cell of the
benchmark runs terminate.)

The damped solve is an f32 Cholesky plus one refinement step, and a failed
factorisation yields a zero update (droid.cpp:568-578). Poses [t0, t1) are
optimised, poses below t0 held fixed.

The training path's differentiable BA is not copied: no cell of the
benchmark trains.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
        if H.is_cuda and H.dim() == 2:
            # one system on the card (the tracking step's window): two
            # triangular solves, bit for bit cholesky_solve's, without the
            # scratch its cuSOLVER call allocates stream-ordered, which a
            # conditional node's body in a CUDA graph cannot hold
            x = torch.linalg.solve_triangular(L.mT, torch.linalg.solve_triangular(L, b, upper=False), upper=True)
        else:
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
    motion_only: bool = False,
    schur_dtype: torch.dtype = torch.float32,
):
    """One GN iteration with a dense windowed Schur complement
    (``ops/ba.py::ba_iteration_dense_window`` of the JAX package).

    The pose-depth coupling is scattered into a dense E [kwin, window·6, HW]
    and S = Σ_k E_k Q_k E_kᵀ is one contraction. ``schur_dtype`` is the
    storage dtype of E; the contractions accumulate in f32. The RGB-D prior
    adds ``alpha`` to the depth diagonal where ``disps_sens`` > 0. Every
    valid edge must satisfy kf0 ≤ ii < kf0 + kwin. With ``motion_only``
    only the poses move: the damped pose system alone is solved, with no
    refinement step, as in the JAX package.
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

    if motion_only:
        dx = cholesky_solve(_damp(Hm, lm, ep, live6), v.reshape(Pw * 6, 1)).reshape(Pw, 6)
        return lie.retr(poses, _place_rows(dx * live[:, None], t0, F)), disps

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


def _damp(A: Tensor, lm: float, ep: float, live6: Tensor) -> Tensor:
    """((1+lm)·diag + ep) damping of the live rows (droid.cpp:559-579)."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return A + (ep + lm * A) * eye * live6[:, None]
