"""The frozen renderer and the generators: one seed repeats bit for bit,
two seeds differ, and the frozen copy is the port's renderer as it was."""

import numpy as np
import pytest

from slam_bench import harness, render

BIG_SEED = 2**31 + 12345  # a run's seed may exceed 32 signed bits


@pytest.mark.parametrize("name,args", [("handheld", dict(frames=6, t_sigma=0.04, r_sigma=0.01))])
def test_generator_repeats_per_seed_and_differs_across_seeds(name, args):
    gen = harness.load_module("generators", name)
    a = gen.generate(BIG_SEED, image_size=(24, 32), workers=3, **args)
    b = gen.generate(BIG_SEED, image_size=(24, 32), workers=2, **args)
    c = gen.generate(BIG_SEED + 1, image_size=(24, 32), **args)
    for k in ("images", "poses", "intrinsics"):
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["images"], c["images"])
    assert a["images"].dtype == np.uint8 and a["images"].shape == (6, 24, 32, 3)


def test_handheld_is_render_sequence():
    a = harness.load_module("generators", "handheld").generate(7, image_size=(24, 32), frames=5,
                                                               t_sigma=0.04, r_sigma=0.01)
    b = render.render_sequence(np.random.default_rng(7), n_frames=5, image_size=(24, 32))
    for k in ("images", "poses", "intrinsics"):
        assert np.array_equal(a[k], b[k]), k


def test_the_copy_draws_as_the_ports_renderer():
    from droid_slam_tpu_torch.data import synthetic

    for seed in (3, BIG_SEED):
        a = render.render_sequence(np.random.default_rng(seed), n_frames=5, image_size=(24, 32))
        b = synthetic.render_sequence(np.random.default_rng(seed), n_frames=5, image_size=(24, 32))
        for k in ("images", "poses", "depths", "intrinsics"):
            assert np.array_equal(a[k], b[k]), (seed, k)
