"""Each metric's arithmetic on a fixed synthetic event list."""

import pytest

from slam_bench import costs, harness

MS = 1_000_000  # ns


def stretch():
    # a 10 ms range; kernels at [1, 3), [2, 4) (overlapping), [6, 7) and one
    # that starts before the range; idle [4, 6) and [7, 10)
    records = [("conv_fprop_bf16", 1 * MS, 3 * MS), ("corr_level_tile_kernel", 2 * MS, 4 * MS),
               ("elementwise_add", 6 * MS, 7 * MS), ("early", -2 * MS, 0)]
    recs = [r for r in records if r[2] > 0]
    return harness.Stretch(records=recs, start_ns=0, end_ns=10 * MS, units=2)


def test_busy_is_the_union_of_intervals():
    s = stretch()
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s() == pytest.approx(0.004)
    assert s.device_s() == pytest.approx(0.005)
    gaps = dict(s.idle_gaps())
    assert gaps["after elementwise_add"] == pytest.approx(0.003)
    assert gaps["after corr_level_tile_kernel"] == pytest.approx(0.002)
    assert gaps["after stretch start"] == pytest.approx(0.001)


def _metric(name, trace):
    return harness.load_module("metrics", name).read(trace)


def test_readers():
    t = harness.Trace(kind="track", stretch=stretch(), host_ms=[5.0, 1.0, 3.0])
    assert _metric("device.idle.track", t) == pytest.approx(60.0)
    assert _metric("fused.device_ms_per_frame", t) == pytest.approx(2.5)
    assert _metric("droid.track_host_ms", t) == pytest.approx(3.0)
    assert _metric("models.conv_share.track", t) == pytest.approx(40.0)
    # no work counted: the roofline and the MFU read nothing
    assert _metric("kernels.corr_level_roofline", t) is None
    assert _metric("track_mfu", t) is None


def test_roofline_and_mfu():
    # corr_level ran 2 ms; 3.35e9 bytes need 1 ms, 989e9 bf16 ops 1 ms, 67e9
    # f32 ops 1 ms more: the operations (2 ms) set the bound, 100%
    work = {"corr_level": {"bytes": 3.35e9, "ops": {"bfloat16": 989e9, "float32": 67e9}},
            "flops": {"bfloat16": 989e9}}
    t = harness.Trace(kind="track", stretch=stretch(), work=work)
    assert _metric("kernels.corr_level_roofline", t) == pytest.approx(100.0)
    assert _metric("track_mfu", t) == pytest.approx(10.0)  # 1 ms at peak over a 10 ms stretch
    work["corr_level"]["ops"] = {"bfloat16": 0}
    assert _metric("kernels.corr_level_roofline", t) == pytest.approx(50.0)


def test_p95():
    assert harness.p95(range(1, 101)) == pytest.approx(95.05)
    assert harness.p95([7.0]) == 7.0


def test_conv_kernel_names():
    conv = ["sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_cudnn",
            "fft2d_r2c_32x32<float, false, 1u, false>", "sm80_xmma_gemm_cf32cf32_cf32f32_f32_nn_n",
            "implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false, false, true>"]
    other = ["sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_cublas", "corr_level_tile_kernel",
             "void at::native::elementwise_kernel<128, 2>", "getrf_wo_pivot_params_"]
    assert all(harness.CONV_KERNEL.search(n) for n in conv)
    assert not any(harness.CONV_KERNEL.search(n) for n in other)
