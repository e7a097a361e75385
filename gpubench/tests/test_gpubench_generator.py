"""The seeded inputs: traffic schedules, images and weights."""

import numpy as np
import torch

from gpubench import harness
from gpubench.generator import arrivals, picks
from gpubench.reference import model as ref
from gpubench.weights import make_weights

import small

BIG = 2**31 + 12345


def test_poisson_arrivals_are_seeded_and_keep_their_rate():
    p = {"rate_img_s": 1000}
    a, b = arrivals(p, 20.0, BIG), arrivals(p, 20.0, BIG)
    assert np.array_equal(a, b) and not np.array_equal(a, arrivals(p, 20.0, BIG + 1))
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 20.0
    assert abs(len(a) - 20000) < 5 * np.sqrt(20000)


def test_picks_are_seeded():
    assert np.array_equal(picks(100, 16, BIG), picks(100, 16, BIG))
    assert picks(100, 16, BIG).max() < 16


def test_images_are_seeded_and_differ_in_their_statistics():
    ctx = harness.Ctx("s", small.TRAIN, {}, BIG, 1.0, False, torch.device("cpu"), 0.0)
    x = harness.seeded_images(ctx, 8, stream=2)
    assert x.dtype == np.uint8 and x.shape == (8, 96, 96, 3)
    assert np.array_equal(x, harness.seeded_images(ctx, 8, stream=2))
    means = x.reshape(8, -1).mean(axis=1)
    assert means.std() > 10.0  # photographs differ in brightness, noise would not


def test_weights_are_seeded_and_cover_the_spec():
    spec = ref.param_spec(small.TRAIN)
    a, b = make_weights(spec, BIG, "cpu"), make_weights(spec, BIG, "cpu")
    assert [k for k, _s, _i in spec] == list(a)
    for name, shape, init in spec:
        assert tuple(a[name].shape) == tuple(shape)
        assert torch.equal(a[name], b[name])
        if init[0] == "fan_out":
            std = np.sqrt(2.0 / init[1]) / 0.87962566103423978
            assert float(a[name].abs().max()) <= 2 * std + 1e-7
