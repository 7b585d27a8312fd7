"""The comparison that decides ``correct``: the plain reference
(``slam_bench/reference/``, float32, no hand kernel, nothing captured) run
on the benchmark's own inputs, and the numbers by which the program's
outputs may differ from it.

The reference imports nothing of the program. It reads the shipped
weights with its own msgpack reader and encodes every image it needs with
its own networks. It follows the program step by step: a tracked frame
from the program's state before that frame. Over whole sequences, bf16
and f32 tracking part by far more than any one step shows (a knife-edge
amplification through the BA and the proximity edges; PERF.md gives the
readings), so only the steps separate a sound run from the
lower-precision control. The program's state that a step starts from is
the program's own (poses, disparities, the factor graph, the GRU's hidden
state per edge, the damping); what the program derived from the images
(the stored features and the probe's features) the reference encodes
again. What the program carries from step to step is held apart: the
window's keyframes against the ground truth (:func:`ate`), and every
session against the first and against a replay (:func:`replay_gap`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np

_TINY = 1e-9  # keeps a ratio defined where its denominator is 0


def reference_droid(fields: Dict, weights: str, device, compute_dtype: str = "float32"):
    from slam_bench.reference.models.weights import load_weights
    from slam_bench.reference.runtime.config import DroidConfig
    from slam_bench.reference.runtime.droid import Droid

    cfg = DroidConfig(**{**fields, "compute_dtype": compute_dtype})
    return Droid(cfg, params=load_weights(str(weights)), device=device)


@contextlib.contextmanager
def precision(mode: str):
    """``float32``: the reference as it is. ``fp8``: the control, in which
    every convolution of the update operator (the part the configuration
    runs in bfloat16) takes its input and weights rounded to float8 e4m3
    with one scale per tensor, as an fp8 kernel would."""
    if mode == "float32":
        yield "float32"
        return
    if mode != "fp8":
        raise ValueError(f"unknown precision {mode!r}")
    import torch

    def q(t):
        scale = t.detach().abs().amax().float().clamp(min=1e-12) / 448.0
        return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)

    def hook(module, args):
        if not isinstance(module, torch.nn.Conv2d) or module.weight.dtype != torch.bfloat16:
            return None
        if not getattr(module, "_fp8_weights", False):
            module.weight.data = q(module.weight.data)
            module._fp8_weights = True
        return (q(args[0]),) + tuple(args[1:])

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield "bfloat16"  # the update operator's copy runs in bf16, the rest in f32
    finally:
        handle.remove()


def centers_w2c(poses: np.ndarray) -> np.ndarray:
    """Camera centres of world→camera poses [N, 7] (t, q_xyzw)."""
    from scipy.spatial.transform import Rotation

    R = Rotation.from_quat(poses[:, 3:7].astype(np.float64)).as_matrix()
    return -np.einsum("nji,nj->ni", R, poses[:, :3].astype(np.float64))


def _extent(c: np.ndarray) -> float:
    return float(np.linalg.norm(c - c[:1], axis=1).max()) + _TINY


def umeyama(src: np.ndarray, dst: np.ndarray):
    """(s, R, t) of the similarity that best maps points ``src`` [N, 3]
    onto ``dst`` (least squares, Umeyama 1991); (1, I, 0) for fewer than 3
    points."""
    if len(src) < 3:
        return 1.0, np.eye(3), np.zeros(3)
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    cov = b.T @ a / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (a ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, md - s * R @ ms


def keyframe_numbers(prog: Dict, ref: Dict, prefix: str, align: bool = True) -> List[Tuple[str, float]]:
    """Numbers over the keyframes of both sides, matched by frame:
    ``<prefix>keyframes_apart``, the share of keyframes that one side has
    and the other not; ``<prefix>pose_gap``, the largest distance between
    matched camera centres, after the similarity that best maps the
    program's centres onto the reference's (a monocular run fixes no
    scale; ``align=False`` leaves them as they are), over the extent of
    the reference's path; ``<prefix>disp_gap``, Σ|Δ disparity| /
    Σ|reference disparity| over the matched keyframes, the program's
    disparities divided by that similarity's scale."""
    tp = np.round(np.asarray(prog["tstamps"], np.float64), 3)
    tr = np.round(np.asarray(ref["tstamps"], np.float64), 3)
    common, ip, ir = np.intersect1d(tp, tr, return_indices=True)
    apart = (len(tp) + len(tr) - 2 * len(common)) / max(len(tr), 1)
    out = [(prefix + "keyframes_apart", float(apart))]
    if len(common) == 0:
        return out + [(prefix + "pose_gap", float("inf")), (prefix + "disp_gap", float("inf"))]
    cp = centers_w2c(np.asarray(prog["poses"])[ip])
    cr = centers_w2c(np.asarray(ref["poses"])[ir])
    s, R, t = umeyama(cp, cr) if align else (1.0, np.eye(3), np.zeros(3))
    if not (np.isfinite(s) and s > 0):
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    pose_gap = float(np.linalg.norm(cr - (s * cp @ R.T + t), axis=1).max()) / _extent(cr)
    dp = np.asarray(prog["disps"], np.float64)[ip] / s
    dr = np.asarray(ref["disps"], np.float64)[ir]
    disp_gap = float(np.abs(dp - dr).sum() / (np.abs(dr).sum() + _TINY))
    out += [(prefix + "pose_gap", pose_gap if np.isfinite(pose_gap) else float("inf")),
            (prefix + "disp_gap", disp_gap if np.isfinite(disp_gap) else float("inf"))]
    return out


def aligned_medians(prog: Dict, ref: Dict, prefix: str) -> List[Tuple[str, float]]:
    """The medians over matched keyframes, after the similarity that best
    maps the program's centres onto the reference's, of each keyframe's
    centre gap over the extent of the reference's path
    (``<prefix>pose_med``) and of its mean |Δ disparity| over its mean
    reference disparity (``<prefix>disp_med``), the program's disparities
    divided by the similarity's scale."""
    tp = np.round(np.asarray(prog["tstamps"], np.float64), 3)
    tr = np.round(np.asarray(ref["tstamps"], np.float64), 3)
    common, ip, ir = np.intersect1d(tp, tr, return_indices=True)
    if len(common) == 0:
        return [(prefix + "pose_med", float("inf")), (prefix + "disp_med", float("inf"))]
    cp = centers_w2c(np.asarray(prog["poses"])[ip])
    cr = centers_w2c(np.asarray(ref["poses"])[ir])
    s, R, t = umeyama(cp, cr)
    if not (np.isfinite(s) and s > 0):
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    pose = float(np.median(np.linalg.norm(cr - (s * cp @ R.T + t), axis=1))) / _extent(cr)
    dp = np.asarray(prog["disps"], np.float64)[ip] / s
    dr = np.asarray(ref["disps"], np.float64)[ir]
    disp = float(np.median(np.abs(dp - dr).mean(axis=(1, 2)) / (np.abs(dr).mean(axis=(1, 2)) + _TINY)))
    fin = lambda x: x if np.isfinite(x) else float("inf")  # noqa: E731
    return [(prefix + "pose_med", fin(pose)), (prefix + "disp_med", fin(disp))]


def ate(state: Dict, gt_c2w: np.ndarray) -> float:
    """The absolute trajectory error of keyframes ``state`` (world→camera
    poses) against the ground truth's camera-to-world poses ``gt_c2w``
    [F, 7] at the keyframes' frames: the root mean square distance between
    the true centres and the program's, mapped by the similarity that best
    fits them to the truth (a monocular run fixes no scale), over the
    extent of the true path (inf where not finite)."""
    idx = np.round(np.asarray(state["tstamps"], np.float64)).astype(np.int64)
    if len(idx) == 0:
        return float("inf")
    c = centers_w2c(np.asarray(state["poses"]))
    g = np.asarray(gt_c2w, np.float64)[idx, :3]
    s, R, t = umeyama(c, g)
    if not np.isfinite(s):
        return float("inf")
    err = float(np.sqrt(np.mean(np.sum((g - (s * c @ R.T + t)) ** 2, axis=1)))) / _extent(g)
    return err if np.isfinite(err) else float("inf")


def keyframe_state(droid_like) -> Dict[str, np.ndarray]:
    """The keyframe outputs of a Droid (the program's or the reference's)."""
    return {"tstamps": droid_like.tstamps.float().cpu().numpy(),
            "poses": droid_like.poses.float().cpu().numpy(),
            "disps": droid_like.disps.float().cpu().numpy()}


# ---------------------------------------------------------------------------
# a tracked frame, followed from the program's state
# ---------------------------------------------------------------------------

# the tracking state the reference takes from the program; the features
# (fmaps, nets, inps and the probe's pfmap, pnet, pinp) it encodes again
_STATE_FIELDS = ("tstamp", "poses", "disps", "disps_sens", "intrinsics", "ii", "jj", "age", "valid", "enet",
                 "target", "weight", "inac_ii", "inac_jj", "inac_valid", "inac_target", "inac_weight",
                 "inac_next", "damping", "disps_up", "counter", "t1", "is_init")


def state_snapshot(st) -> Dict[str, object]:
    """Host copies of a fused tracking state (the program's SLAMState):
    the fields the reference takes and the keyframes' images."""
    snap = {f: getattr(st, f).detach().cpu().clone() for f in _STATE_FIELDS}
    snap["images"] = st.images[: int(snap["counter"])].cpu().clone()
    return snap


def _load_state(d, snap) -> None:
    """Write the program's state ``snap`` into the reference Droid ``d``'s
    fused state, the features encoded again from the keyframes' images."""
    import torch

    st = d._state
    for f in _STATE_FIELDS:
        getattr(st, f).copy_(snap[f].to(getattr(st, f).dtype))
    n = int(snap["counter"])
    st.images[:n] = snap["images"].to(st.images.device)
    for s0 in range(0, n, 16):
        img = st.images[s0:min(n, s0 + 16)]
        st.fmaps[s0:s0 + len(img), 0] = d.net.features(img).to(st.fmaps.dtype)
        net, inp = d.net.context(img)
        st.nets[s0:s0 + len(img)] = net.to(st.nets.dtype)
        st.inps[s0:s0 + len(img)] = inp.to(st.inps.dtype)
    if n > 0:
        last = st.images[n - 1:n]
        st.pfmap.copy_(d.net.features(last)[0:1].float())
        net, inp = d.net.context(last)
        st.pnet.copy_(net[0].float())
        st.pinp.copy_(inp[0].float())
    d._initialized = bool(snap["is_init"])
    torch.cuda.synchronize() if st.poses.is_cuda else None


def rows(snap) -> Dict[str, np.ndarray]:
    n = int(snap["counter"])
    return {"tstamps": snap["tstamp"][:n].numpy().astype(np.float64), "poses": snap["poses"][:n].numpy(),
            "disps": snap["disps"][:n].numpy()}


def ref_track_step(d, before, k: int, inputs) -> Dict[str, object]:
    """The reference Droid ``d`` tracks frame ``k`` from the program's state
    ``before``; returns its state after the frame (host copies)."""
    _load_state(d, before)
    d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])
    return state_snapshot(d._state)


def step_numbers(before, prog, ref) -> List[Tuple[str, float]]:
    """One tracked frame's step, the program's against the reference's,
    both from the same state ``before``: ``step_keyframes_apart``, the
    share of keyframes one side has and the other not after the step;
    ``step_pose_gap``, the largest distance between matched keyframes'
    camera centres over the largest move of a centre in the reference's
    step; ``step_disp_gap``, Σ|Δ disparity| over Σ|the reference step's
    change of disparity|. A keyframe the step appended is matched to the
    row where the motion model had seeded it."""
    b, p, r = rows(before), rows(prog), rows(ref)
    tp, tr = np.round(p["tstamps"], 3), np.round(r["tstamps"], 3)
    common, ip, ir = np.intersect1d(tp, tr, return_indices=True)
    apart = (len(tp) + len(tr) - 2 * len(common)) / max(len(tr), 1)
    out = [("step_keyframes_apart", float(apart))]
    if len(common) == 0:
        return out + [("step_pose_gap", 0.0 if len(tr) == 0 else float("inf")), ("step_disp_gap", 0.0)]
    tb = list(np.round(b["tstamps"], 3))
    n_b = len(tb)
    ib = np.asarray([tb.index(t) if t in tb else n_b for t in common])
    b_poses = before["poses"].numpy()
    b_disps = before["disps"].numpy().astype(np.float64)
    cb = centers_w2c(b_poses[ib])
    cp = centers_w2c(p["poses"][ip])
    cr = centers_w2c(r["poses"][ir])
    num = float(np.linalg.norm(cp - cr, axis=1).max())
    den = float(np.linalg.norm(cr - cb, axis=1).max())
    pose_gap = 0.0 if num == 0 else num / max(den, _TINY)
    dp = p["disps"][ip].astype(np.float64)
    dr = r["disps"][ir].astype(np.float64)
    num = float(np.abs(dp - dr).sum())
    den = float(np.abs(dr - b_disps[ib]).sum())
    disp_gap = 0.0 if num == 0 else num / max(den, _TINY)
    fin = lambda x: x if np.isfinite(x) else float("inf")  # noqa: E731
    return out + [("step_pose_gap", fin(pose_gap)), ("step_disp_gap", fin(disp_gap))]


def init_unmoved(before, prog, ref) -> float:
    """The step that initialises the map, the program's against the
    reference's, both from the same state ``before``: of the keyframes
    that the reference's step moves (a pose or a disparity changed), the
    share that the program's step leaves bit for bit as they were (0 where
    the reference moves none). A sound step moves every one; a step that
    returns its state unchanged reads 1."""
    b, p, r = rows(before), rows(prog), rows(ref)
    tb, tp, tr = (np.round(x["tstamps"], 3) for x in (b, p, r))
    common = np.intersect1d(np.intersect1d(tb, tp), tr)
    moved = still = 0
    for t in common:
        ib, ip, ir = (int(np.nonzero(x == t)[0][0]) for x in (tb, tp, tr))
        if np.array_equal(r["poses"][ir], b["poses"][ib]) and np.array_equal(r["disps"][ir], b["disps"][ib]):
            continue
        moved += 1
        still += np.array_equal(p["poses"][ip], b["poses"][ib]) and np.array_equal(p["disps"][ip], b["disps"][ib])
    return still / moved if moved else 0.0


def replay_gap(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    """0 where two keyframe states are the same bit for bit, else the
    largest absolute difference (inf where their keyframes differ)."""
    if not np.array_equal(a["tstamps"], b["tstamps"]):
        return float("inf")
    return float(max(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max(initial=0.0)
                     for k in ("poses", "disps")))


def limits(numbers: List[Tuple[str, float]], table: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """Each number beside its limit from the cell's ``check`` table."""
    return [(n, v, float(table[n])) for n, v in numbers]
