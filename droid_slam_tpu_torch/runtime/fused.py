"""Per-frame fused tracking step (PyTorch).

Counterpart of the JAX package's ``runtime/fused.py``: all tracking state
(keyframe buffers, factor-graph slots, the inactive edge ring, per-frame
damping) lives on the device in one :class:`SLAMState`, and
``track_step(state, ...)`` runs motion filter + keyframe append + graph
maintenance (aged-edge culling, proximity/NMS edge selection, keyframe
removal) + operator iterations + windowed dense-Schur BA.

JAX's ``lax.cond`` / ``fori_loop`` become Python control flow. The host
reads the device only for the per-frame branches: the motion-filter
decision and the keyframe-cull test. The keyframe count, the frontend's
frame count and the initialised flag are host integers, because every
change to them follows one of those branches. Graph edits, the greedy
proximity picks and the BA window arithmetic stay masked tensor code.

Semantics follow droid_frontend.py / factor_graph.py / motion_filter.py of
the reference, with the dense windowed Schur BA of the JAX package. Writes
that JAX drops with ``mode="drop"`` (an index equal to the buffer length)
go to a dump row here; gathers for masked candidates use clamped indices.
The state is updated in place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from ..models.update import upsample_disp
from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import lie
from ..ops import projective as pops
from .video import _frame_distance, persist_window, read_window

Tensor = torch.Tensor
_BIG = 10**6


def _n_greedy(max_factors: int) -> int:
    """Static number of greedy proximity picks (each adds 2 edges)."""
    return max_factors // 2 + 1


@dataclasses.dataclass
class SLAMState:
    """All tracking state. Tensors live on the tracking device."""

    # keyframe video (depth_video.py:24-45 layout)
    tstamp: Tensor  # [B]
    images: Tensor  # [B, H, W, 3] uint8
    poses: Tensor  # [B, 7]
    disps: Tensor  # [B, h, w]
    disps_sens: Tensor  # [B, h, w]
    intrinsics: Tensor  # [B, 4] (1/8 res)
    fmaps: Tensor  # [B, rig, h, w, 128] compute dtype (rig 2 in stereo)
    nets: Tensor  # [B, h, w, 128] compute dtype
    inps: Tensor  # [B, h, w, 128] compute dtype
    # f32 features of the last keyframe, for the motion-filter probe only:
    # keyframe decisions must not depend on the compute dtype
    pfmap: Tensor  # [rig, h, w, 128] f32
    pnet: Tensor  # [h, w, 128] f32
    pinp: Tensor  # [h, w, 128] f32
    # factor graph (padded slots)
    ii: Tensor  # [Nmax] int64
    jj: Tensor
    age: Tensor
    valid: Tensor  # [Nmax] bool
    enet: Tensor  # [Nmax, h, w, 128] compute dtype
    target: Tensor  # [Nmax, h, w, 2]
    weight: Tensor
    # inactive edge ring
    inac_ii: Tensor  # [K]
    inac_jj: Tensor
    inac_valid: Tensor
    inac_target: Tensor
    inac_weight: Tensor
    inac_next: Tensor  # 0-dim int64 ring pointer
    damping: Tensor  # [B, h, w]
    disps_up: Tensor  # [B, H, W], or [1, 1, 1] unless config.upsample
    # host counters
    counter: int = 0  # keyframe count
    t1: int = 0  # frames tracked by the frontend
    is_init: bool = False


def _edge_slots(config) -> int:
    """Static capacity of the active edge store: sized to the init
    neighbourhood (6·warmup − 12 edges, factor_graph.py:102-107) or
    max_factors, whichever is larger, rounded up to a multiple of 8."""
    init_peak = 6 * config.warmup - 12 + (config.warmup if config.stereo else 0)
    return -(-max(config.max_factors, init_peak) // 8) * 8


def init_state(config, device) -> SLAMState:
    B = config.buffer
    H, W = config.image_size
    h, w = config.feat_size
    rig = 2 if config.stereo else 1
    Nmax = _edge_slots(config)
    K = config.inactive_pad
    cdt = getattr(torch, config.compute_dtype)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    long = torch.int64
    return SLAMState(
        tstamp=zeros(B),
        images=zeros(B, H, W, 3, dtype=torch.uint8),
        poses=lie.identity((B,), device=device),
        disps=torch.ones((B, h, w), device=device),
        disps_sens=zeros(B, h, w),
        intrinsics=zeros(B, 4),
        fmaps=zeros(B, rig, h, w, 128, dtype=cdt),
        nets=zeros(B, h, w, 128, dtype=cdt),
        inps=zeros(B, h, w, 128, dtype=cdt),
        pfmap=zeros(rig, h, w, 128),
        pnet=zeros(h, w, 128),
        pinp=zeros(h, w, 128),
        ii=zeros(Nmax, dtype=long),
        jj=zeros(Nmax, dtype=long),
        age=zeros(Nmax, dtype=long),
        valid=zeros(Nmax, dtype=torch.bool),
        enet=zeros(Nmax, h, w, 128, dtype=cdt),
        target=zeros(Nmax, h, w, 2),
        weight=zeros(Nmax, h, w, 2),
        inac_ii=zeros(K, dtype=long),
        inac_jj=zeros(K, dtype=long),
        inac_valid=zeros(K, dtype=torch.bool),
        inac_target=zeros(K, h, w, 2),
        inac_weight=zeros(K, h, w, 2),
        inac_next=zeros(dtype=long),
        damping=torch.full((B, h, w), 1e-6, device=device),
        disps_up=zeros(B, H, W) if config.upsample else zeros(1, 1, 1),
    )


def _set_rows(buf: Tensor, idx: Tensor, src) -> Tensor:
    """buf[idx] = src, dropping rows whose idx equals len(buf) (JAX's
    ``.at[idx].set(..., mode="drop")``)."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    if not torch.is_tensor(src):
        src = torch.full((idx.shape[0],) + buf.shape[1:], src, dtype=buf.dtype, device=buf.device)
    return ext.index_copy_(0, idx, src.to(buf.dtype))[:n]


def _bidir_distance(st: SLAMState, ii: Tensor, jj: Tensor, beta: float) -> Tensor:
    d1 = _frame_distance(st.poses, st.disps, st.intrinsics[0], ii, jj, beta)
    d2 = _frame_distance(st.poses, st.disps, st.intrinsics[0], jj, ii, beta)
    return 0.5 * (d1 + d2)


# -----------------------------------------------------------------------------
# masked graph edits
# -----------------------------------------------------------------------------


def _rm_factors(st: SLAMState, drop: Tensor, store: bool) -> None:
    """Deactivate edges; optionally move them to the inactive ring
    (factor_graph.py:138-162)."""
    if store:
        K = st.inac_ii.shape[0]
        order = torch.cumsum(drop.long(), 0) - 1
        dst = torch.where(drop, (st.inac_next + order) % K, K)
        st.inac_ii = _set_rows(st.inac_ii, dst, st.ii)
        st.inac_jj = _set_rows(st.inac_jj, dst, st.jj)
        st.inac_valid = _set_rows(st.inac_valid, dst, True)
        st.inac_target = _set_rows(st.inac_target, dst, st.target)
        st.inac_weight = _set_rows(st.inac_weight, dst, st.weight)
        st.inac_next = (st.inac_next + drop.sum()) % K
    st.valid = st.valid & ~drop


def _add_edges(
    st: SLAMState,
    cand_ii: Tensor,  # [C]
    cand_jj: Tensor,
    cand_ok: Tensor,  # [C] bool
    evict: bool,  # LRU-evict to make room (frontend remove=True)
    budget: Optional[int] = None,  # eviction threshold (config.max_factors)
) -> None:
    """Masked add_factors (factor_graph.py:86-135): dedup against existing
    edges and within the batch, optionally evict the oldest, write new
    slots. With ``evict`` the active count is held at ``budget``."""
    Nmax = st.ii.shape[0]
    B = st.poses.shape[0]
    C = cand_ii.shape[0]
    dev = cand_ii.device

    def member(valid, ii, jj):
        return (valid[None] & (ii[None] == cand_ii[:, None]) & (jj[None] == cand_jj[:, None])).any(1)

    dup = member(st.valid, st.ii, st.jj) | member(st.inac_valid, st.inac_ii, st.inac_jj)
    same = (cand_ii[:, None] == cand_ii[None, :]) & (cand_jj[:, None] == cand_jj[None, :])
    ar = torch.arange(C, device=dev)
    earlier = same & (ar[None, :] < ar[:, None]) & cand_ok[None, :]
    ok = cand_ok & ~dup & ~earlier.any(1)

    if evict:
        cap = budget if budget is not None else Nmax
        need = (st.valid.sum() + ok.sum() - cap).clamp(min=0)
        age_key = torch.where(st.valid, st.age, -1)
        evict_order = torch.argsort(-age_key, stable=True)  # oldest valid first
        evict_rank = torch.empty_like(evict_order).scatter_(
            0, evict_order, torch.arange(Nmax, device=dev)
        )
        _rm_factors(st, st.valid & (evict_rank < need), store=True)

    # assign candidates to free slots (invalid-first stable order)
    slot_order = torch.argsort(st.valid.long(), stable=True)
    ranks = torch.cumsum(ok.long(), 0) - 1
    write = ok & (ranks < Nmax - st.valid.sum())
    slots = torch.where(write, slot_order[ranks.clamp(0, Nmax - 1)], Nmax)

    # new-edge state: hidden from the source keyframe, target = reprojection
    ci = cand_ii.clamp(0, B - 1)
    cj = cand_jj.clamp(0, B - 1)
    tgt, _ = pops.projective_transform(st.poses, st.disps, st.intrinsics, ci, cj)

    st.ii = _set_rows(st.ii, slots, cand_ii)
    st.jj = _set_rows(st.jj, slots, cand_jj)
    st.age = _set_rows(st.age, slots, 0)
    st.valid = _set_rows(st.valid, slots, True)
    st.enet = _set_rows(st.enet, slots, st.nets[ci])
    st.target = _set_rows(st.target, slots, tgt)
    st.weight = _set_rows(st.weight, slots, 0.0)


def _rm_keyframe(st: SLAMState, ix: int) -> None:
    """Remove keyframe ix: shift buffers down, drop/reindex edges
    (factor_graph.py:166-195)."""
    B = st.poses.shape[0]
    idx = torch.arange(B, device=st.poses.device)
    src = torch.where(idx >= ix, (idx + 1).clamp(max=B - 1), idx)
    for name in ("tstamp", "images", "poses", "disps", "disps_sens", "intrinsics",
                 "fmaps", "nets", "inps", "damping"):
        setattr(st, name, getattr(st, name)[src])
    if st.disps_up.shape[0] == B:
        st.disps_up = st.disps_up[src]

    touching = st.valid & ((st.ii == ix) | (st.jj == ix))
    st.valid = st.valid & ~touching
    st.ii = torch.where(st.ii > ix, st.ii - 1, st.ii)
    st.jj = torch.where(st.jj > ix, st.jj - 1, st.jj)
    inac_touching = st.inac_valid & ((st.inac_ii == ix) | (st.inac_jj == ix))
    st.inac_valid = st.inac_valid & ~inac_touching
    st.inac_ii = torch.where(st.inac_ii > ix, st.inac_ii - 1, st.inac_ii)
    st.inac_jj = torch.where(st.inac_jj > ix, st.inac_jj - 1, st.inac_jj)


# -----------------------------------------------------------------------------
# proximity edge selection (NMS + greedy, factor_graph.py:317-381)
# -----------------------------------------------------------------------------


def _suppression_radius(i, j, nms: int):
    return ((i - j).abs() - 2).clamp(max=nms).clamp(min=0)


def _proximity_candidates(
    st: SLAMState,
    t0: int,  # candidate source range [t0, t)
    t1r: int,  # candidate target range [t1r, t)
    rows: int,  # static pad of the source range
    cols: int,  # static pad of the target range
    rad: int,
    nms: int,
    thresh: float,
    beta: float,
    max_factors: int,
    stereo: bool = False,
):
    """Distance-ranked greedy proximity edges with NMS, as masked tensors.

    Returns (cand_ii, cand_jj, cand_ok) of static length
    rows·(rad+1)·2 [+ rows in stereo] + 2·n_greedy. Greedy picks stop when
    the running directed-edge count (base + picks) would exceed
    ``max_factors``.
    """
    t = st.counter
    B = st.poses.shape[0]
    dev = st.poses.device
    inf = float("inf")
    i_abs = t0 + torch.arange(rows, device=dev)
    j_abs = t1r + torch.arange(cols, device=dev)
    i_ok = i_abs < t
    j_ok = j_abs < t
    ii_g = i_abs[:, None].expand(rows, cols).reshape(-1)
    jj_g = j_abs[None, :].expand(rows, cols).reshape(-1)

    d = _bidir_distance(st, ii_g.clamp(0, B - 1), jj_g.clamp(0, B - 1), beta)
    d = torch.where((i_ok[:, None] & j_ok[None, :]).reshape(-1), d, inf)
    d = torch.where(ii_g - rad < jj_g, inf, d)  # only i ≥ j + rad candidates
    d = torch.where(d > 100.0, inf, d)

    # suppress around every existing (active + inactive) edge
    ex_i = torch.cat([st.ii, st.inac_ii])
    ex_j = torch.cat([st.jj, st.inac_jj])
    ex_ok = torch.cat([st.valid, st.inac_valid])
    ex_r = _suppression_radius(ex_i, ex_j, nms)
    ex_ball = ((ii_g[None] - ex_i[:, None]).abs() + (jj_g[None] - ex_j[:, None]).abs()) <= ex_r[:, None]
    d = torch.where((ex_ball & ex_ok[:, None]).any(0), inf, d)

    # base edges per source row: in stereo the self edge (i, i) first, then
    # the temporal neighbours (i, j), j ∈ [i−rad−1, i) ascending, both
    # directions, with their cells suppressed
    doff = torch.arange(rad + 1, 0, -1, device=dev)
    bi = i_abs[:, None].expand(rows, rad + 1)
    bj = bi - doff[None, :]
    bok = i_ok[:, None] & (bj >= 0)
    base_ii = torch.stack([bi, bj], -1).reshape(rows, -1)
    base_jj = torch.stack([bj, bi], -1).reshape(rows, -1)
    base_ok = torch.stack([bok, bok], -1).reshape(rows, -1)
    if stereo:
        base_ii = torch.cat([i_abs[:, None], base_ii], 1)
        base_jj = torch.cat([i_abs[:, None], base_jj], 1)
        base_ok = torch.cat([i_ok[:, None], base_ok], 1)
    base_ii, base_jj, base_ok = base_ii.reshape(-1), base_jj.reshape(-1), base_ok.reshape(-1)
    base_cell = (ii_g[None] == base_ii[:, None]) & (jj_g[None] == base_jj[:, None]) & base_ok[:, None]
    d = torch.where(base_cell.any(0), inf, d)
    if stereo:
        d = torch.where(ii_g == jj_g, inf, d)  # no greedy self edges

    # greedy selection, budget-gated like the host loop (base edges count)
    cnt = base_ok.sum()
    picks_i, picks_j, picks_ok = [], [], []
    for _ in range(_n_greedy(max_factors)):
        k = torch.argmin(d)
        si, sj = ii_g[k], jj_g[k]
        ok = (d[k] <= thresh) & (cnt <= max_factors)
        ball = ((ii_g - si).abs() + (jj_g - sj).abs()) <= _suppression_radius(si, sj, nms)
        d = torch.where(ok & ball, inf, d)
        cnt = cnt + 2 * ok.long()
        picks_i.append(si)
        picks_j.append(sj)
        picks_ok.append(ok)
    gi, gj, gok = torch.stack(picks_i), torch.stack(picks_j), torch.stack(picks_ok)

    return (
        torch.cat([base_ii, gi, gj]),
        torch.cat([base_jj, gj, gi]),
        torch.cat([base_ok, gok, gok]),
    )


# -----------------------------------------------------------------------------
# the track step
# -----------------------------------------------------------------------------


def build_track_step(net, config):
    """Return ``track_step(state, tstamp, image, intrinsics, disp_sens)`` for
    a :class:`..models.droid_net.DroidNet` on the tracking device."""
    cdt = getattr(torch, config.compute_dtype)
    # the motion-filter probe runs the f32 operator, so keyframe decisions
    # do not depend on the compute dtype (motion_filter.py:83)
    update32 = net.update
    update_op = update32 if cdt == torch.float32 else copy.deepcopy(update32).to(cdt)

    h, w = config.feat_size
    Nmax = config.max_factors
    Pw = config.window_pad
    Ka = Pw + 8
    warmup = config.warmup
    beta = config.beta
    stereo = config.stereo

    # ---------------- one operator iteration (factor_graph.py:199-251) -----

    def update_iteration(st: SLAMState, fixed_t0: int) -> None:
        ii, jj, valid = st.ii, st.jj, st.valid
        B = st.poses.shape[0]
        dev = ii.device

        min_ii = torch.where(valid, ii, _BIG).min()
        max_any = torch.where(valid, torch.maximum(ii, jj), -1).max()
        if fixed_t0 > 0:
            t0 = torch.full((), fixed_t0, dtype=torch.int64, device=dev)
        else:
            t0 = (min_ii + 1).clamp(min=1)
        t1 = max_any + 1
        # never let the BA window outgrow window_pad: poses older than
        # t1 - Pw freeze (sliding-window semantics)
        t0 = torch.maximum(t0, t1 - Pw)
        kf0 = (torch.minimum(min_ii, t0) - 1).clamp(0, B - 1)

        coords0 = pops.coords_grid(h, w, device=dev)
        coords1, _ = pops.projective_transform(st.poses, st.disps, st.intrinsics, ii, jj)
        motn = torch.cat([coords1 - coords0, st.target - coords1], -1).clamp(-64.0, 64.0)

        # stereo self edges (i, i) match the left image against the right
        rig2 = (ii == jj).long() if stereo else 0
        corr = corr_ops.corr_lookup(st.fmaps[ii, 0], st.fmaps[jj, rig2], coords1)

        k_rel = (ii - kf0).clamp(0, Ka - 1)
        net_e, delta, wgt, eta_win, upmask = update_op(
            st.enet, st.inps[ii], corr, motn, k_rel, Ka, valid
        )
        target = coords1 + delta
        st.enet = net_e.to(st.enet.dtype)
        st.target = target
        st.weight = wgt

        # persist damping at frames touched by active edges
        touched = torch.zeros(Ka, dtype=torch.int64, device=dev).index_add_(0, k_rel, valid.long()) > 0
        st.damping = persist_window(st.damping, eta_win, touched, kf0)

        # BA over active + inactive edges
        inac_ok = st.inac_valid & (st.inac_ii >= t0 - 3) & (st.inac_jj >= t0 - 3)
        ba_ii = torch.cat([st.inac_ii, ii])
        ba_jj = torch.cat([st.inac_jj, jj])
        ba_ok = torch.cat([inac_ok, valid])
        ba_tgt = torch.cat([st.inac_target, target])
        ba_wgt = torch.cat([st.inac_weight, wgt])
        kf0_ba = torch.where(ba_ok, ba_ii, _BIG).min().clamp(0, B - 1)
        eta_full = 0.2 * st.damping + 1e-7

        poses, disps = st.poses, st.disps
        for _ in range(2):
            poses, disps = ba_ops.ba_iteration_dense_window(
                poses, disps, st.intrinsics[0], st.disps_sens,
                ba_tgt, ba_wgt, eta_full, ba_ii, ba_jj, ba_ok,
                t0, t1, kf0_ba, Pw, Ka, schur_dtype=cdt,
            )
        st.poses = poses
        st.disps = disps.clamp(min=0.001)
        st.age = st.age + valid.long()

        if config.upsample:
            # full-res disparity maintenance (depth_video.py:126-130)
            up_win = upsample_disp(read_window(st.disps, kf0, Ka), upmask.float())
            st.disps_up = persist_window(st.disps_up, up_win, touched, kf0)

    # ------------------------------ track step -----------------------------

    def append_keyframe(st, tstamp, image, intrinsics, disp_sens, fmap32):
        # the context and the stored image are the left image's
        net32, inp32 = net.context(image[:1])
        ix = st.counter
        st.tstamp[ix] = tstamp
        st.images[ix] = image[0]
        if ix == 0:
            st.poses[ix] = lie.identity((), device=st.poses.device)
            st.disps[ix] = 1.0
        st.disps_sens[ix] = disp_sens
        st.intrinsics[ix] = intrinsics / 8.0
        st.fmaps[ix] = fmap32.to(cdt)
        st.nets[ix] = net32[0].to(cdt)
        st.inps[ix] = inp32[0].to(cdt)
        st.pfmap, st.pnet, st.pinp = fmap32, net32[0], inp32[0]
        st.counter = ix + 1

    def init_branch(st):
        """Initialisation over the first ``warmup`` keyframes
        (droid_frontend.py:78-113)."""
        t1 = st.counter
        dev = st.poses.device
        # in stereo the neighbourhood leaves out |a − b| = 1, as the JAX
        # package's fused.py:642-645 does
        c = 1 if stereo else 0
        pairs = [(a, b) for a in range(warmup) for b in range(warmup) if c < abs(a - b) <= 3]
        cand = torch.tensor(pairs, dtype=torch.int64, device=dev)
        _add_edges(st, cand[:, 0], cand[:, 1], torch.ones(len(pairs), dtype=torch.bool, device=dev),
                   evict=False)
        for _ in range(8):
            update_iteration(st, 1)

        ci, cj, cok = _proximity_candidates(
            st, 0, 0, warmup, warmup, rad=2, nms=2, thresh=config.frontend_thresh,
            beta=beta, stereo=stereo, max_factors=Nmax,
        )
        _add_edges(st, ci, cj, cok, evict=False)
        for _ in range(8):
            update_iteration(st, 1)

        # motion model: seed the next keyframe from the last one
        if t1 < st.poses.shape[0]:
            st.poses[t1] = st.poses[t1 - 1]
            st.disps[t1] = st.disps[t1 - 4 : t1].mean()
        _rm_factors(st, st.valid & (st.ii < warmup - 4), store=True)
        st.is_init = True
        st.t1 = t1

    def update_branch(st):
        """Per-keyframe frontend update (droid_frontend.py:35-76)."""
        t1 = st.t1 + 1
        st.t1 = t1
        dev = st.poses.device

        _rm_factors(st, st.valid & (st.age > config.max_age), store=True)
        ci, cj, cok = _proximity_candidates(
            st, t1 - 5, max(t1 - config.frontend_window, 0), 5, config.frontend_window,
            rad=config.frontend_radius, nms=config.frontend_nms,
            thresh=config.frontend_thresh, beta=beta, stereo=stereo, max_factors=Nmax,
        )
        _add_edges(st, ci, cj, cok, evict=True, budget=Nmax)

        # RGB-D prior seeds the new keyframe disparity
        sens = st.disps_sens[t1 - 1]
        st.disps[t1 - 1] = torch.where(sens > 0, sens, st.disps[t1 - 1])

        for _ in range(config.frontend_iters1):
            update_iteration(st, 0)

        # keyframe keep/cull test: a host read
        pair = torch.tensor([t1 - 3, t1 - 2], device=dev)
        d = _bidir_distance(st, pair[:1], pair[1:], beta)[0]
        if float(d) < config.keyframe_thresh:
            _rm_keyframe(st, t1 - 2)
            st.counter -= 1
            st.t1 -= 1
        else:
            for _ in range(config.frontend_iters2):
                update_iteration(st, 0)

        # motion model: seed the next keyframe from the last one
        t1n = st.t1
        if t1n < st.poses.shape[0]:
            st.poses[t1n] = st.poses[t1n - 1]
            st.disps[t1n] = st.disps[t1n - 1].mean()

    def track_step(
        st: SLAMState,
        tstamp: float,
        image: Tensor,  # [rig, H, W, 3] uint8 (left, right)
        intrinsics: Tensor,  # [4] full-res
        disp_sens: Tensor,  # [h, w] inverse-depth prior (zeros if none)
    ) -> None:
        # ---- motion filter (motion_filter.py:45-93), f32 ----
        # fnet over every rig image (all are stored); the probe compares the
        # left images
        fmap32 = net.features(image)  # [rig, h, w, 128]
        if st.counter > 0:
            coords0 = pops.coords_grid(h, w, device=fmap32.device)[None]
            corr = corr_ops.corr_lookup(st.pfmap[0][None], fmap32[0][None], coords0)
            zero_flow = torch.zeros((1, h, w, 4), device=fmap32.device)
            _, delta, _ = update32(st.pnet[None], st.pinp[None], corr, zero_flow)
            delta = float(delta.norm(dim=-1).mean())  # the per-frame host read
        else:
            delta = 1e9
        # capacity gate: at counter == buffer keyframing stops
        has_room = st.counter < st.poses.shape[0]
        if (st.counter == 0 or delta > config.filter_thresh) and has_room:
            append_keyframe(st, tstamp, image, intrinsics, disp_sens, fmap32)

        if not st.is_init and st.counter == warmup:
            init_branch(st)
        elif st.is_init and st.t1 < st.counter:
            update_branch(st)

    return track_step
