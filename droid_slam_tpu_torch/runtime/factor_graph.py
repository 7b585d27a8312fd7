"""Covisibility factor graph over keyframes (PyTorch).

Counterpart of the JAX package's ``runtime/factor_graph.py``, the graph of
the host-driven engine's frontend, the global backend and the trajectory
filler:

* canonical edge bookkeeping (ii, jj, age, validity, the inactive ring)
  lives on the host in numpy, padded to static capacities, copied from the
  JAX package line for line so that edge order and slot assignment match;
* per-edge device state (GRU hidden ``net``, flow ``target``, confidence
  ``weight``) lives in [edge_pad, ...] tensors; adds and removals are masked
  writes (:func:`_add_edges`, :func:`_deactivate_edges`);
* the host engine's edits: keyframe removal (:meth:`FactorGraph.rm_keyframe`,
  which shifts every video buffer and the damping down), neighbourhood
  edges and confidence filtering;
* :meth:`FactorGraph.update` is one operator iteration with the fused
  correlation lookup (:func:`..ops.corr.corr_lookup`, the ``corr_level``
  kernel on a CUDA tensor) and the block-sparse BA: the host engine's
  frontend iteration and the filler's motion-only step. The JAX package
  computes the same function as an all-pairs volume
  (``droid_slam_tpu/ops/corr.py:186-201``).
  :meth:`FactorGraph.update_lowmem` is the backend's global-BA iteration,
  with the split correlation lookup (:class:`..ops.corr.AltCorr`) over
  chunks of edges.

Both paths take a stereo rig (``config.stereo``): a self edge (i, i)
matches keyframe i's left image against its right one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.update import upsample_disp
from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import projective as pops
from .fused import _set_rows
from .video import persist_window, read_window

Tensor = torch.Tensor


@dataclasses.dataclass
class EdgeState:
    """Per-edge device state, [edge_pad] slots."""

    ii: Tensor  # [Nmax] int64
    jj: Tensor
    valid: Tensor  # [Nmax] bool
    net: Tensor  # [Nmax, h, w, 128] store dtype
    target: Tensor  # [Nmax, h, w, 2] f32
    weight: Tensor  # [Nmax, h, w, 2] f32

    def prefix(self, n: int) -> "EdgeState":
        return EdgeState(*(getattr(self, f.name)[:n] for f in dataclasses.fields(self)))


@dataclasses.dataclass
class InactiveState:
    ii: Tensor  # [Kmax] int64
    jj: Tensor
    valid: Tensor
    target: Tensor  # [Kmax, h, w, 2]
    weight: Tensor


def _empty_edges(n: int, h: int, w: int, device, net_dtype=torch.float32) -> EdgeState:
    # the per-edge hidden dominates backend memory; the backend stores it in
    # the compute dtype. target/weight stay f32: they carry the sub-pixel
    # coordinates the BA residuals need
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EdgeState(
        ii=zeros(n, dtype=torch.int64),
        jj=zeros(n, dtype=torch.int64),
        valid=zeros(n, dtype=torch.bool),
        net=zeros(n, h, w, 128, dtype=net_dtype),
        target=zeros(n, h, w, 2),
        weight=zeros(n, h, w, 2),
    )


def _empty_inactive(k: int, h: int, w: int, device) -> InactiveState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return InactiveState(
        ii=zeros(k, dtype=torch.int64),
        jj=zeros(k, dtype=torch.int64),
        valid=zeros(k, dtype=torch.bool),
        target=zeros(k, h, w, 2),
        weight=zeros(k, h, w, 2),
    )


# -----------------------------------------------------------------------------
# masked edits of the device state (factor_graph.py:96-161)
# -----------------------------------------------------------------------------


def _add_edges(graph: EdgeState, video, slots: Tensor, new_ii: Tensor, new_jj: Tensor) -> None:
    """Write new edges into ``slots``: hidden state from the source keyframe,
    target = the current reprojection, weight 0 (factor_graph.py:110-135).
    In place."""
    target, _ = pops.projective_transform(video.poses, video.disps, video.intrinsics, new_ii, new_jj)
    graph.ii[slots] = new_ii
    graph.jj[slots] = new_jj
    graph.valid[slots] = True
    graph.net[slots] = video.nets[new_ii].to(graph.net.dtype)
    graph.target[slots] = target
    graph.weight[slots] = 0.0


def _deactivate_edges(graph: EdgeState, inactive: InactiveState, drop: Tensor, dst: Tensor,
                      store: Tensor) -> None:
    """Move edges from the active store to the inactive ring
    (factor_graph.py:138-162); ``dst`` is each stored edge's ring slot.
    In place."""
    K = inactive.ii.shape[0]
    safe_dst = torch.where(store & drop, dst, K)  # K is dropped
    inactive.ii = _set_rows(inactive.ii, safe_dst, graph.ii)
    inactive.jj = _set_rows(inactive.jj, safe_dst, graph.jj)
    inactive.valid = _set_rows(inactive.valid, safe_dst, True)
    inactive.target = _set_rows(inactive.target, safe_dst, graph.target)
    inactive.weight = _set_rows(inactive.weight, safe_dst, graph.weight)
    graph.valid &= ~drop


# -----------------------------------------------------------------------------
# host-side factor graph
# -----------------------------------------------------------------------------


class FactorGraph:
    """Host orchestrator around the padded device state.

    ``update_op`` is the :class:`..models.update.UpdateModule` in the
    compute dtype (its parameters' dtype).
    """

    def __init__(
        self,
        video,
        update_op,
        max_factors: int = 48,
        inactive_pad: int = 96,
        window_pad: int = 64,
        upsample: bool = False,
        edge_pad: Optional[int] = None,
        net_dtype: torch.dtype = torch.float32,
    ):
        self.video = video
        self.update_op = update_op
        # max_factors is the eviction/budget threshold; with remove=False
        # edges are appended past it up to the static capacity edge_pad
        self.max_factors = max_factors
        self.edge_pad = edge_pad if edge_pad is not None else 2 * max_factors
        self.window_pad = window_pad
        self.upsample = upsample
        self.device = video.poses.device

        h, w = video.config.feat_size
        self.h, self.w = h, w

        # host-canonical edge bookkeeping
        self.ii = np.zeros(self.edge_pad, np.int32)
        self.jj = np.zeros(self.edge_pad, np.int32)
        self.age = np.zeros(self.edge_pad, np.int32)
        self.valid = np.zeros(self.edge_pad, bool)

        self.inactive_pad = inactive_pad
        self.ii_inac = np.zeros(inactive_pad, np.int32)
        self.jj_inac = np.zeros(inactive_pad, np.int32)
        self.valid_inac = np.zeros(inactive_pad, bool)
        self.inac_next = 0  # ring pointer for inactive slot reuse

        self.bad_edges: set = set()

        self.edges = _empty_edges(self.edge_pad, h, w, self.device, net_dtype)
        self.inactive = _empty_inactive(inactive_pad, h, w, self.device)
        self.damping = torch.full((video.config.buffer, h, w), 1e-6, device=self.device)

    def _dev(self, a: np.ndarray) -> Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # ------------------------------------------------------------- queries

    @property
    def edge_set(self) -> set:
        active = {(int(i), int(j)) for i, j, v in zip(self.ii, self.jj, self.valid) if v}
        inac = {(int(i), int(j)) for i, j, v in zip(self.ii_inac, self.jj_inac, self.valid_inac) if v}
        return active | inac

    @property
    def num_active(self) -> int:
        return int(self.valid.sum())

    # ---------------------------------------------------------------- edits

    def add_factors(self, ii, jj, remove: bool = False) -> None:
        """Add edges (dedup; LRU eviction by age when ``remove`` —
        factor_graph.py:86-135)."""
        ii = np.asarray(ii, np.int32).reshape(-1)
        jj = np.asarray(jj, np.int32).reshape(-1)

        existing = self.edge_set
        keep = [k for k in range(len(ii)) if (int(ii[k]), int(jj[k])) not in existing]
        # also dedup within the batch
        seen = set()
        uniq = []
        for k in keep:
            key = (int(ii[k]), int(jj[k]))
            if key not in seen:
                seen.add(key)
                uniq.append(k)
        ii, jj = ii[uniq], jj[uniq]
        if len(ii) == 0:
            return

        free = np.nonzero(~self.valid)[0]
        if remove:
            # the active count is held at max_factors: evict the oldest so
            # that count + new <= max_factors (factor_graph.py:102-107)
            need = int(self.valid.sum()) + len(ii) - self.max_factors
            if need > 0:
                active_slots = np.nonzero(self.valid)[0]
                order = active_slots[np.argsort(-self.age[active_slots], kind="stable")]
                self._deactivate(order[:need], store=True)
                free = np.nonzero(~self.valid)[0]
        n_write = min(len(ii), len(free))
        ii, jj = ii[:n_write], jj[:n_write]
        slots = free[:n_write]

        self.ii[slots] = ii
        self.jj[slots] = jj
        self.age[slots] = 0
        self.valid[slots] = True
        _add_edges(self.edges, self.video, self._dev(slots), self._dev(ii), self._dev(jj))

    def _alloc_inactive(self, n: int) -> np.ndarray:
        """Ring-allocate n inactive slots (oldest entries are overwritten)."""
        slots = (self.inac_next + np.arange(n)) % self.inactive_pad
        self.inac_next = int((self.inac_next + n) % self.inactive_pad)
        return slots.astype(np.int64)

    def _deactivate(self, slots: np.ndarray, store: bool) -> None:
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return
        drop = np.zeros(self.edge_pad, bool)
        drop[slots] = True
        dst = np.zeros(self.edge_pad, np.int64)
        store_mask = np.zeros(self.edge_pad, bool)
        # store at most the ring's size: the newest inactive_pad edges of
        # the batch (the rest would be overwritten at once); all deactivate
        store_slots = slots[-self.inactive_pad:] if store else slots[:0]
        if store:
            inac_slots = self._alloc_inactive(len(store_slots))
            dst[store_slots] = inac_slots
            store_mask[store_slots] = True
            self.ii_inac[inac_slots] = self.ii[store_slots]
            self.jj_inac[inac_slots] = self.jj[store_slots]
            self.valid_inac[inac_slots] = True
        self.valid[slots] = False
        _deactivate_edges(
            self.edges, self.inactive, torch.as_tensor(drop, device=self.device),
            self._dev(dst), torch.as_tensor(store_mask, device=self.device),
        )

    def rm_factors(self, mask: np.ndarray, store: bool = False) -> None:
        """mask: [edge_pad] bool over slots (only valid slots count)."""
        self._deactivate(np.nonzero(mask & self.valid)[0], store=store)

    def filter_edges(self) -> None:
        """Remove the edges farther than 2 keyframes apart whose mean
        confidence is below 1e-3, and remember them as bad edges
        (factor_graph.py:71-78). As in the reference, no engine calls it;
        it serves users who drive the graph directly."""
        conf = self.edges.weight.mean(dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001) & self.valid
        for s in np.nonzero(mask)[0]:
            self.bad_edges.add((int(self.ii[s]), int(self.jj[s])))
        self.rm_factors(mask, store=False)

    def rm_keyframe(self, ix: int) -> None:
        """Remove keyframe ix (factor_graph.py:166-195): every video buffer
        and the per-frame damping move down one slot from ix (the last slot
        keeps its value), the edges touching ix are dropped and the rest
        reindexed, active, inactive and bad alike."""
        v = self.video
        B = v.poses.shape[0]
        idx = torch.arange(B, device=self.device)
        src = torch.where(idx >= ix, (idx + 1).clamp(max=B - 1), idx)
        for name in ("tstamp", "images", "poses", "disps", "disps_sens", "disps_up",
                     "intrinsics", "fmaps", "nets", "inps"):
            setattr(v, name, getattr(v, name)[src])
        # the damping is indexed by keyframe too: left behind, frame k + 1's
        # damping would apply to frame k after the removal
        self.damping = self.damping[src]

        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.valid_inac &= ~m
        self.ii_inac = np.where(self.ii_inac > ix, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac > ix, self.jj_inac - 1, self.jj_inac)
        self.inactive.ii = self._dev(self.ii_inac)
        self.inactive.jj = self._dev(self.jj_inac)
        self.inactive.valid = torch.as_tensor(self.valid_inac, device=self.device)

        self.bad_edges = {(i - (i > ix), j - (j > ix)) for (i, j) in self.bad_edges
                          if i != ix and j != ix}

        m = ((self.ii == ix) | (self.jj == ix)) & self.valid
        self.ii = np.where(self.ii > ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj > ix, self.jj - 1, self.jj)
        self.edges.ii = self._dev(self.ii)
        self.edges.jj = self._dev(self.jj)
        self.rm_factors(m, store=False)

    def clear_edges(self) -> None:
        self.rm_factors(self.valid.copy(), store=False)

    def _sync_device_edges(self) -> None:
        self.edges.ii = self._dev(self.ii)
        self.edges.jj = self._dev(self.jj)
        self.edges.valid = torch.as_tensor(self.valid, device=self.device)

    # --------------------------------------------------------------- update

    def update(
        self,
        t0: Optional[int] = None,
        t1: Optional[int] = None,
        itrs: int = 2,
        use_inactive: bool = False,
        EP: float = 1e-7,
        motion_only: bool = False,
    ) -> None:
        """One operator iteration (factor_graph.py:199-251): reproject, the
        fused correlation lookup, ConvGRU update, block-sparse BA (lm 1e-4,
        ep 0.1, f32 Schur storage). Marks the keyframes from the first
        active source to t1 dirty."""
        if self.num_active == 0:
            return
        active_ii = self.ii[self.valid]
        active_jj = self.jj[self.valid]
        if t0 is None:
            t0 = max(1, int(active_ii.min()) + 1)
        if t1 is None:
            t1 = max(int(active_ii.max()), int(active_jj.max())) + 1
        if t1 - t0 > self.window_pad:
            raise ValueError(f"BA window {t1 - t0} > window_pad {self.window_pad}")
        kf0 = max(0, min(int(active_ii.min()), t0) - 1)
        agg_frames = self.window_pad + 8
        self._sync_device_edges()

        if use_inactive:
            inac_ok = self.valid_inac & (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            ba_ii = np.concatenate([self.ii_inac, self.ii])
            ba_jj = np.concatenate([self.jj_inac, self.jj])
            ba_valid = np.concatenate([inac_ok, self.valid])
        else:
            ba_ii, ba_jj, ba_valid = self.ii, self.jj, self.valid
        pairs = ba_ops.SchurPairs.build(ba_ii, ba_jj, ba_valid, t0, t1, self.window_pad,
                                        device=self.device)

        v, g = self.video, self.edges
        ii, jj, valid = g.ii, g.jj, g.valid
        coords0 = pops.coords_grid(self.h, self.w, device=self.device)
        coords1, _ = pops.projective_transform(v.poses, v.disps, v.intrinsics, ii, jj)
        motn = torch.cat([coords1 - coords0, g.target - coords1], -1).clamp(-64.0, 64.0)
        # stereo self edges (i, i) match the left image against the right
        rig2 = (ii == jj).long() if v.config.stereo else 0
        corr = corr_ops.corr_lookup(v.fmaps[ii, 0], v.fmaps[jj, rig2], coords1)

        k_rel = (ii - kf0).clamp(0, agg_frames - 1)
        net, delta, weight, eta_win, upmask = self.update_op(
            g.net, v.inps[ii], corr, motn, k_rel, agg_frames, valid
        )
        target = coords1 + delta
        g.net = net.to(g.net.dtype)
        g.target = target
        g.weight = weight

        # persist damping at frames touched by active edges (only)
        touched = torch.zeros(agg_frames, dtype=torch.int64, device=self.device)
        touched = touched.index_add_(0, k_rel, valid.long()) > 0
        kf0_t = torch.as_tensor(kf0, device=self.device)
        self.damping = persist_window(self.damping, eta_win, touched, kf0_t)

        if use_inactive:
            inac = self.inactive
            ok = torch.as_tensor(ba_valid, device=self.device)
            ba = (torch.cat([inac.ii, ii]), torch.cat([inac.jj, jj]), ok,
                  torch.cat([inac.target, target]), torch.cat([inac.weight, weight]))
        else:
            ba = (ii, jj, valid, target, weight)
        prob = ba_ops.BAProblem(
            target=ba[3], weight=ba[4], eta=0.2 * self.damping + EP,
            ii=ba[0], jj=ba[1], edge_valid=ba[2], t0=t0, t1=t1, pairs=pairs,
        )
        v.poses, v.disps = ba_ops.ba_solve(
            v.poses, v.disps, v.intrinsics[0], v.disps_sens, prob, self.window_pad,
            iterations=itrs, motion_only=motion_only,
        )

        if self.upsample:
            up_win = upsample_disp(read_window(v.disps, kf0_t, agg_frames), upmask.float())
            v.disps_up = persist_window(v.disps_up, up_win, touched, kf0_t)

        self.age[self.valid] += 1
        v.dirty[int(active_ii.min()) : t1] = True

    def _lowmem_step(self, edges: EdgeState, pairs, t0: int, t1: int, window: int, chunk: int,
                     itrs: int, EP: float, lm: float = 1e-5, ep_ba: float = 1e-2) -> None:
        """One global-BA iteration (factor_graph.py:255-302): the update
        operator over chunks of ``chunk`` edges with on-the-fly split
        correlation, the graph aggregation over all edges at once, then the
        block-sparse BA with lm 1e-5, ep 1e-2 and the E blocks stored in
        the compute dtype. Updates ``edges``, the video and the damping in
        place."""
        v = self.video
        ii, jj, valid = edges.ii, edges.jj, edges.valid
        N = ii.shape[0]
        B = v.poses.shape[0]
        cdt = self.update_op.corr_enc1.weight.dtype

        coords0 = pops.coords_grid(self.h, self.w, device=self.device)
        coords1, _ = pops.projective_transform(v.poses, v.disps, v.intrinsics, ii, jj)
        motn = torch.cat([coords1 - coords0, edges.target - coords1], -1).clamp(-64.0, 64.0)

        # the correlation reads the compute-dtype keyframe features, with
        # the rig flattened: keyframe k's image r is map rig·k + r, and a
        # stereo self edge (i, i) reads the right image of i
        rig = v.fmaps.shape[1]
        alt = corr_ops.AltCorr.build(v.fmaps.reshape(B * rig, self.h, self.w, 128).to(cdt))
        c1 = rig * ii
        c2 = rig * jj + (ii == jj).long() if rig == 2 else jj
        nets, targets, weights = [], [], []
        for s in range(0, N, chunk):
            e = slice(s, s + chunk)
            corr = alt(coords1[e], c1[e], c2[e])
            net_c, delta, weight = self.update_op(edges.net[e], v.inps[ii[e]], corr, motn[e])
            nets.append(net_c)
            targets.append(coords1[e] + delta)
            weights.append(weight)
        net = torch.cat(nets)
        edges.net = net.to(edges.net.dtype)
        edges.target = torch.cat(targets).float()
        edges.weight = torch.cat(weights).float()

        # graph aggregation over all edges at once (damping + upmask)
        eta_all, upmask = self.update_op.agg(net.permute(0, 3, 1, 2), ii, B, valid)
        touched = torch.zeros(B, dtype=torch.int64, device=self.device)
        touched = touched.index_add_(0, ii.clamp(0, B - 1), valid.long()) > 0
        self.damping = torch.where(touched[:, None, None], eta_all, self.damping)

        prob = ba_ops.BAProblem(
            target=edges.target, weight=edges.weight, eta=0.2 * self.damping + EP,
            ii=ii, jj=jj, edge_valid=valid, t0=t0, t1=t1, pairs=pairs,
        )
        v.poses, v.disps = ba_ops.ba_solve(
            v.poses, v.disps, v.intrinsics[0], v.disps_sens, prob, window,
            iterations=itrs, lm=lm, ep=ep_ba, schur_dtype=cdt,
        )
        if self.upsample:
            up_all = upsample_disp(v.disps, upmask.float())
            v.disps_up = torch.where(touched[:, None, None], up_all, v.disps_up)

    def update_lowmem(self, t0: int = 1, t1: Optional[int] = None, itrs: int = 2, steps: int = 8,
                      EP: float = 1e-7) -> int:
        """``steps`` global-BA iterations with on-the-fly correlation
        (factor_graph.py:255-302), over the edge slots up to the highest
        valid one. The JAX package rounds that prefix up to whole chunks
        for its static shapes; the slots past it are invalid and change
        nothing, so the port's last chunk is just shorter. Returns the
        number of chunks per step (0 if nothing ran)."""
        cfg = self.video.config
        # cap the chunk by the correlation working set, as the JAX package
        # does: about 1.2 GB of a [chunk, h, w, h·w] block in the compute
        # dtype (256 at 30×40 in bf16)
        hw = self.h * self.w
        bytes_per = 2 if cfg.compute_dtype == "bfloat16" else 4
        cap = max(32, int(2 ** np.floor(np.log2(max(1.2e9 / (hw * hw * bytes_per), 32)))))
        chunk = min(cfg.backend_chunk, cap)
        t = self.video.counter
        if t1 is None:
            t1 = t
        if t1 - t0 <= 0:
            return 0  # nothing to optimise (a run with ≤ 1 keyframe)
        window = max(min(-(-(t1 - t0) // 32) * 32, cfg.buffer), 1)

        self._sync_device_edges()
        occupied = np.nonzero(self.valid)[0]
        if len(occupied) == 0:
            return 0
        n_used = int(occupied.max()) + 1
        edges = self.edges.prefix(n_used)
        pairs = ba_ops.SchurPairs.build(
            self.ii[:n_used], self.jj[:n_used], self.valid[:n_used], t0, t1, window,
            device=self.device,
        )
        for _ in range(steps):
            self._lowmem_step(edges, pairs, t0, t1, window, chunk, itrs, EP)
        self.video.dirty[:t] = True
        # write the per-edge state back (the slots past n_used are invalid)
        for name in ("net", "target", "weight"):
            full = getattr(self.edges, name)
            full[:n_used] = getattr(edges, name)
        return -(-n_used // chunk)

    # --------------------------------------------------- edge construction

    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3) -> None:
        """Edges between the keyframes of [t0, t1) at most ``r`` apart
        (factor_graph.py:304-314); in stereo also not 1 apart."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1), indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
        c = 1 if self.video.config.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(
        self,
        t0: int = 0,
        t1: int = 0,
        rad: int = 2,
        nms: int = 2,
        beta: float = 0.25,
        thresh: float = 16.0,
        remove: bool = False,
    ) -> None:
        """Distance-ranked greedy edge selection with Chebyshev-ball NMS
        (factor_graph.py:317-381), on the host over the [t, t] distance
        matrix."""
        t = self.video.counter
        if t - t0 <= 0 or t - t1 <= 0:
            return
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)

        d = self.video.distance(ii, jj, beta=beta, bidirectional=True).astype(np.float64)
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf
        d = d.reshape(len(ix), len(jx))

        def suppress(i, j):
            """NMS ball around a chosen edge."""
            r = max(min(abs(i - j) - 2, nms), 0)
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= r:
                        i1, j1 = i + di, j + dj
                        if t0 <= i1 < t and t1 <= j1 < t:
                            d[i1 - t0, j1 - t1] = np.inf

        for (i, j) in self.edge_set | self.bad_edges:
            suppress(i, j)

        es = []
        for i in range(t0, t):
            if self.video.config.stereo:
                es.append((i, i))
                if t1 <= i < t:
                    d[i - t0, i - t1] = np.inf
            for j in range(max(i - rad - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                if t1 <= j < t:
                    d[i - t0, j - t1] = np.inf

        flat = d.reshape(-1)
        order = np.argsort(flat)
        for k in order:
            if flat[k] > thresh:
                continue
            if len(es) > self.max_factors:
                break
            i = int(ii[k])
            j = int(jj[k])
            es.append((i, j))
            es.append((j, i))
            suppress(i, j)

        if es:
            es_arr = np.asarray(es, np.int32)
            self.add_factors(es_arr[:, 0], es_arr[:, 1], remove)
