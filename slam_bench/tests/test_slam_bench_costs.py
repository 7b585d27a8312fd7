"""The yardstick's arithmetic against hand-worked values and against the
reference network's own layers."""

import pytest

from slam_bench import costs


def test_bound_picks_the_slower_side():
    ms, by = costs.bound(3.35e9, 0, "bfloat16")
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = costs.bound(0, 67e9, "float32")
    assert ms == pytest.approx(1.0) and by == "operations"


def test_lookup_work_by_hand():
    # one edge, a 2x2 map, C = 1, radius 0 (support 2x2, 1 tap), 1 level,
    # bf16 features: f1 4 px x 2 B, f2 4 px x 2 B, coords 4 x 8 B, taps 4 x 4 B
    nbytes, ops = costs.lookup_work(1, 2, 2, 2, c=1, radius=0, levels=1)
    assert nbytes == 8 + 8 + 32 + 16
    assert ops == 4 * (2 * 1 * 4 + 12 * 1)
    assert costs.lookup_dots(1, 2, 2, c=1, radius=0, levels=1) == 4 * 2 * 4


def test_lookup_work_agrees_with_the_copied_cost(torch_cpu):
    torch = torch_cpu
    n, h, w, c = 3, 6, 8, 16
    f1 = torch.zeros(n, h * w, c, dtype=torch.bfloat16)
    f2 = torch.zeros(n, h, w, c, dtype=torch.bfloat16)
    # every support point in the map: coords well inside
    coords = torch.full((n, h * w, 2), 3.5)
    coords[..., 1] = 3.0
    b, o = costs.corr_level_cost(torch, f1, f2, coords, radius=1)
    b2, o2 = costs.lookup_work(n, h, w, 2, c=c, radius=1, levels=1)
    assert (b, o) == (b2, o2)


def _hook_flops(torch, module, *inputs):
    """2 x multiply-adds of every Conv2d the module runs, from the shapes
    PyTorch hands the hooks."""
    total = []

    def hook(m, args, out):
        if isinstance(m, torch.nn.Conv2d):
            cin = m.in_channels // m.groups
            k = m.kernel_size[0] * m.kernel_size[1]
            total.append(2 * cin * k * out.numel())

    h = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("size", [(48, 64), (30, 44)])
def test_encoder_flops_match_the_layers(torch_cpu, size):
    torch = torch_cpu
    from slam_bench.reference.models.extractor import BasicEncoder

    H, W = size
    x = torch.zeros(1, H, W, 3)
    assert costs.encoder_flops(H, W, 128) == _hook_flops(torch, BasicEncoder(128), x)
    assert costs.encoder_flops(H, W, 256) == _hook_flops(torch, BasicEncoder(256, norm_fn="none"), x)


@pytest.mark.parametrize("edges,frames", [(1, 0), (5, 3)])
def test_update_flops_match_the_layers(torch_cpu, edges, frames):
    torch = torch_cpu
    from slam_bench.reference.models.update import UpdateModule

    h, w = 6, 8
    m = UpdateModule()
    args = [torch.zeros(edges, h, w, 128), torch.zeros(edges, h, w, 128), torch.zeros(edges, h, w, 196),
            torch.zeros(edges, h, w, 4)]
    if frames:
        args += [torch.arange(edges) % frames, frames]
    assert costs.update_flops(edges, h, w, frames) == _hook_flops(torch, m, *args)


def test_peak_seconds_by_type():
    assert costs.peak_seconds({"bfloat16": 989e12, "float32": 67e12}) == pytest.approx(2.0)
