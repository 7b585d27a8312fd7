"""The tracking step's linearisation and its pose and depth systems
(``ops/ba.py::linearize_window``, ``csrc/ba_window.cu``).

* On the CPU: the wrapper runs the plain stages, bit for bit the
  composition the dense-window step ran before (the benchmark's frozen
  ``build_edge_blocks`` and ``_assemble_pose_system``, and the depth
  system's inline code); the wrapper's checks and the entry point's
  arity, on meta tensors.
* On the card (``cuda``): the kernels against the plain stages at the
  cells' shapes, bitwise over repeats and under a CUDA graph's replay,
  and the wrapper's refusals. This module imports no JAX, so that on the
  card's machine these run as ``python -m pytest
  tests/test_torch_ba_window.py -m cuda --noconftest``.
"""

import pytest
import torch

import chip_smoke
from droid_slam_tpu_torch.ops import ba, kernels

KINDS = ("mono", "rgbd", "stereo", "full", "end", "init")
SMALL = dict(N=96 + 50, Pw=64, Ka=72, F=96, h=6, w=8)  # the cells' rows and windows at 6x8 features


def _case(kind, dev="cpu", seed=5, **shape):
    return chip_smoke.ba_window_case(torch, ba, kind, torch.device(dev), seed, **{**SMALL, **shape})


# ---------------------------------------------------------------------------
# the CPU route: the parent's stages
# ---------------------------------------------------------------------------


def _parent(c):
    """The dense-window step's linearisation and systems as the step wrote
    them inline: the frozen copy's build_edge_blocks and
    _assemble_pose_system, then the depth system's lines."""
    from slam_bench.reference.ops import ba as frozen

    poses, disps, ii, jj, valid = c["poses"], c["disps"], c["ii"], c["jj"], c["edge_valid"]
    t0, t1, kf0, Pw, kwin = c["t0"], c["t1"], c["kf0"], c["window"], c["kwin"]
    F = poses.shape[0]
    hw = disps[0].numel()
    blocks = frozen.build_edge_blocks(c["target"], c["weight"], poses, disps, c["intrinsics"].expand(F, 4), ii, jj,
                                      edge_valid=valid, min_depth=0.25)
    Hm, v, live, live6 = frozen._assemble_pose_system(blocks, ii - t0, jj - t0, Pw, t0, t1)
    k_rel = ii - kf0
    ks = torch.arange(kwin)
    kframes = kf0 + ks
    in_window = (kframes >= t0) & (kframes < t1) & (kframes < F)
    touched = ((k_rel.clamp(0, kwin - 1)[None, :] == ks[:, None]) & valid[None, :]).any(dim=1)
    in_kx = in_window | (touched & (kframes < F))
    safe_k = kframes.clamp(max=F - 1)
    sens_w = c["disps_sens"][safe_k].reshape(kwin, hw)
    disps_w = disps[safe_k].reshape(kwin, hw)
    eta_w = c["eta"][safe_k].reshape(kwin, hw)
    C = frozen._scatter_vec(blocks.Ck, k_rel, kwin)
    w_rhs = frozen._scatter_vec(blocks.wk, k_rel, kwin)
    m = (sens_w > 0).float()
    C = C + m * 0.05 + (1.0 - m) * eta_w
    w_rhs = w_rhs - m * 0.05 * (disps_w - sens_w)
    Q = in_kx.float()[:, None] / torch.where(C == 0.0, torch.ones_like(C), C)
    return dict(Hm=Hm, v=v, live6=live6, Ei=blocks.Ei, Ej=blocks.Ej, Q=Q, w_rhs=w_rhs)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_route_is_the_parent_code_bit_for_bit(kind):
    c = _case(kind)
    got = ba.linearize_window(**c)._asdict()
    want = _parent(c)
    assert float(got["Hm"].abs().max()) > 0 and float(got["Q"].abs().max()) > 0
    assert all(torch.equal(got[k], want[k]) for k in want), [k for k in want if not torch.equal(got[k], want[k])]


# ---------------------------------------------------------------------------
# the wrapper's checks, on meta tensors (the kernel route without a card)
# ---------------------------------------------------------------------------


def _meta_args(N=146, F=96, h=30, w=40):
    f32 = dict(dtype=torch.float32, device="meta")
    i64 = dict(dtype=torch.int64, device="meta")
    return dict(poses=torch.empty((F, 7), **f32), disps=torch.empty((F, h, w), **f32),
                intrinsics=torch.empty(4, **f32), disps_sens=torch.empty((F, h, w), **f32),
                target=torch.empty((N, h, w, 2), **f32), weight=torch.empty((N, h, w, 2), **f32),
                eta=torch.empty((F, h, w), **f32), ii=torch.empty(N, **i64), jj=torch.empty(N, **i64),
                edge_valid=torch.empty(N, dtype=torch.bool, device="meta"), t0=torch.empty((), **i64),
                t1=torch.empty((), **i64), kf0=torch.empty((), **i64), window=64, kwin=72)


def _recording_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    monkeypatch.setattr(kernels, "launch", lambda name, dev, *args, **kw: calls.append((name, args)))
    return calls


def test_wrapper_launches_the_entry_point_once_with_its_arity(monkeypatch):
    calls = _recording_launch(monkeypatch)
    out = ba.linearize_window(**_meta_args())
    assert [name for name, _ in calls] == ["ba_window"]
    # every argument but the stream, which kernels.launch appends
    assert len(calls[0][1]) == len(kernels.KERNELS["ba_window"][2]) - 1
    assert out.Hm.shape == (384, 384) and out.Ei.shape == (146, 6, 1200) and out.Q.shape == (72, 1200)


BAD_INPUTS = {
    "poses_f64": lambda a: a.update(poses=a["poses"].double()),
    "poses_shape": lambda a: a.update(poses=a["poses"][:, :6]),
    "intrinsics_per_frame": lambda a: a.update(intrinsics=a["poses"][:, :4]),
    "target_strided": lambda a: a.update(target=a["target"].transpose(1, 2)),
    "weight_rows": lambda a: a.update(weight=a["weight"][:-1]),
    "eta_shape": lambda a: a.update(eta=a["eta"][:, :-1]),
    "ii_int32": lambda a: a.update(ii=a["ii"].int()),
    "jj_other_device": lambda a: a.update(jj=torch.zeros(146, dtype=torch.int64)),
    "mask_float": lambda a: a.update(edge_valid=a["edge_valid"].float()),
    "t1_not_0dim": lambda a: a.update(t1=a["t1"].reshape(1)),
    "window_too_wide": lambda a: a.update(window=171),
    "no_depth_frames": lambda a: a.update(kwin=0),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch, bad):
    calls = _recording_launch(monkeypatch)
    args = _meta_args()
    BAD_INPUTS[bad](args)
    with pytest.raises(ValueError, match="linearize_window"):
        ba.linearize_window(**args)
    assert not calls


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The CUDA device a ``cuda`` test runs on; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", chip_smoke.BA_WINDOW_CASES)
def test_card_kernels_match_the_plain_stages_bitwise_over_repeats(cuda_device, kind, h, w):
    c = _case(kind, "cuda", 13, h=h, w=w)
    before = kernels.launch_counts()
    runs = [chip_smoke.ba_window_run(ba, c) for _ in range(3)]
    assert kernels.launches_since(before) == {"ba_window": 3}
    want = chip_smoke.ba_window_run(ba, c, ba.linearize_window_ref)
    torch.cuda.synchronize()
    got = runs[0]
    assert torch.equal(got["live6"], want["live6"])
    for k, ref in want.items():
        assert float((got[k] - ref).abs().max()) <= chip_smoke.KERNEL_TOL * float(ref.abs().max()), k
    assert all(torch.equal(r[k], got[k]) for r in runs[1:] for k in got)


@pytest.mark.cuda
def test_card_kernels_replay_in_a_cuda_graph(cuda_device):
    """Static grids, bounds read on the device, no allocation inside: the
    call captures, and a replay after new bounds and poses are copied in
    gives the eager call's bits."""
    c = _case("mono", "cuda", 17, h=30, w=40)
    static = {k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
    chip_smoke.ba_window_run(ba, static)  # builds and warms
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ba.linearize_window(**static)
    other = _case("stereo", "cuda", 19, h=30, w=40)
    for k in ("poses", "disps", "target", "t0", "t1", "kf0", "ii", "jj", "edge_valid"):
        static[k].copy_(other[k])
    g.replay()
    want = chip_smoke.ba_window_run(ba, static)
    torch.cuda.synchronize()
    assert all(torch.equal(getattr(out, k), want[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["poses_f64", "target_strided", "ii_int32", "jj_on_the_cpu", "window_too_wide"])
def test_card_wrapper_refuses_what_the_kernels_do_not_take(cuda_device, bad):
    c = _case("mono", "cuda", 3, h=30, w=40)
    change = {"poses_f64": dict(poses=c["poses"].double()), "target_strided": dict(target=c["target"].transpose(1, 2)),
              "ii_int32": dict(ii=c["ii"].int()), "jj_on_the_cpu": dict(jj=c["jj"].cpu()),
              "window_too_wide": dict(window=171)}[bad]
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="linearize_window"):
        ba.linearize_window(**{**c, **change})
    assert kernels.launches_since(before) == {}
