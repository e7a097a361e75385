"""The port's augmentations against the JAX package on the CPU: each of the
24 AutoAugment ops at levels 0-10 (both signs of a signed op) on seeded RGB
arrays of odd sizes against JAX's Pillow op, bit for bit; AutoAugment and
RandAugment at seeds 0-3 on a batch (the same ops and signs, the same
pixels); ``TfPreprocessTransform`` from the fixtures' bytes (the same crop
boxes, the same pixels); mixup and random erasing on JAX's own draws,
regenerated from its keys.

Images are (3, H, W) uint8 tensors in the port and (H, W, 3) Pillow images
in the JAX package."""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import scouter_tpu.data.auto_augment as jax_aa
from scouter_tpu.data.extra_augment import mixup as jax_mixup
from scouter_tpu.data.extra_augment import one_hot_smooth as jax_one_hot_smooth
from scouter_tpu.data.extra_augment import random_erasing as jax_random_erasing
from scouter_tpu.data.tf_pre import TfPreprocessTransform as JaxTfPre
from scouter_tpu.data.tf_pre import center_crop_box as jax_center_crop_box
from scouter_tpu.data.tf_pre import random_crop_box as jax_random_crop_box
from scouter_tpu_torch.data import TfPreprocessTransform
from scouter_tpu_torch.data import auto_augment as aa
from scouter_tpu_torch.data.extra_augment import mixup, one_hot_smooth, random_erasing
from scouter_tpu_torch.data.tf_pre import CROP_PADDING, center_crop_box, random_crop_box

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
SIZES = ((32, 32), (37, 29), (23, 48))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rgb_arrays(h, w, seed=0):
    """A full-range image, a low-contrast one and one with a saturated
    region (autocontrast's and equalize's tables reach 255 there)."""
    rng = np.random.RandomState(seed + h * w)
    full = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    low = (rng.rand(h, w, 3) * 60 + 90).astype(np.uint8)
    sat = full.copy()
    sat[rng.rand(h, w) < 0.3] = 255
    return full, low, sat


def chw(arr):
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))


def hwc(t):
    return t.permute(1, 2, 0).numpy()


def fixed_sign(value):
    """A ``random.Random`` whose ``random()`` returns ``value``: 0 keeps a
    signed op's magnitude, 1 negates it."""
    rng = random.Random(0)
    rng.random = lambda: value
    return rng


@pytest.mark.parametrize("name", sorted(jax_aa._OPS))
def test_op_matches_pillow_at_every_level(name):
    assert set(aa._OPS) == set(jax_aa._OPS)
    jax_fn, jax_to_arg = jax_aa._OPS[name]
    signs = (0.0, 1.0) if name in aa.SIGNED_OPS else (None,)
    for h, w in SIZES:
        for arr in rgb_arrays(h, w):
            img, t = Image.fromarray(arr), chw(arr)
            for level in range(11):
                for sign in signs:
                    if sign is None:
                        arg = jax_to_arg(level)
                        assert aa._OPS[name][1](level) == arg
                    else:
                        arg = jax_to_arg(level, fixed_sign(sign))
                        assert aa._OPS[name][1](level, fixed_sign(sign)) == arg
                    want = np.asarray(jax_fn(img, arg))
                    np.testing.assert_array_equal(hwc(aa._OPS[name][0](t, arg)), want,
                                                  err_msg=f"{name} {level} {sign} {h}x{w}")


def test_signed_ops_are_those_whose_level_takes_the_rng():
    signed = set()
    for name, (_, to_arg) in jax_aa._OPS.items():
        try:
            to_arg(5, random.Random(0))
            signed.add(name)
        except TypeError:
            pass
    assert signed == set(aa.SIGNED_OPS)


def test_batched_op_takes_one_argument_per_image():
    arrs = [rgb_arrays(37, 29, s)[0] for s in range(3)]
    batch = torch.stack([chw(a) for a in arrs])
    for name, args in (("Rotate", [0.0, 12.0, -27.0]), ("Posterize", [0, 4, 8]),
                       ("Contrast", [0.1, 1.0, 1.9]), ("TranslateXRel", [0.1, -0.3, 0.0])):
        got = aa._OPS[name][0](batch, args)
        for i, (a, arg) in enumerate(zip(arrs, args)):
            want = np.asarray(jax_aa._OPS[name][0](Image.fromarray(a), arg))
            np.testing.assert_array_equal(hwc(got[i]), want, err_msg=f"{name} {i}")


def test_policy_tables_and_rand_ops_equal_jax():
    for policy in ("v0", "original"):
        assert aa.auto_augment_policy(policy) == jax_aa.auto_augment_policy(policy)
    assert tuple(aa.rand_augment_ops()) == tuple(jax_aa.rand_augment_ops())
    with pytest.raises(ValueError):
        aa.auto_augment_policy("v1")


def record_jax_ops(monkeypatch):
    """Wrap every op of JAX's table so that each call records (op, arg)."""
    calls = []
    for name, (fn, to_arg) in list(jax_aa._OPS.items()):
        def rec(img, arg, fn=fn, name=name):
            calls[-1].append((name, arg))
            return fn(img, arg)
        monkeypatch.setitem(jax_aa._OPS, name, (rec, to_arg))
    return calls


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["v0", "original", "rand"])
def test_policy_picks_the_same_ops_and_pixels(kind, seed, monkeypatch):
    arrs = [rgb_arrays(*SIZES[1], seed=s)[s % 3] for s in range(8)]
    if kind == "rand":
        jax_t, port_t = jax_aa.RandAugment(2, 9, seed=seed), aa.RandAugment(2, 9, seed=seed)
    else:
        jax_t, port_t = jax_aa.AutoAugment(kind, seed=seed), aa.AutoAugment(kind, seed=seed)
    calls = record_jax_ops(monkeypatch)
    want = []
    for a in arrs:
        calls.append([])
        want.append(np.asarray(jax_t(Image.fromarray(a))))
    port_plans = [port_t.plan() for _ in arrs]
    assert port_plans == calls
    # a fresh transform of the same seed draws the same plans inside __call__
    port_t = aa.RandAugment(2, 9, seed=seed) if kind == "rand" else aa.AutoAugment(kind, seed)
    got = port_t(torch.stack([chw(a) for a in arrs]))
    for i, w in enumerate(want):
        np.testing.assert_array_equal(hwc(got[i]), w, err_msg=f"image {i}")
    one = aa.RandAugment(2, 9, seed=seed) if kind == "rand" else aa.AutoAugment(kind, seed)
    np.testing.assert_array_equal(hwc(one(chw(arrs[0]))), want[0])


# ---------------------------------------------------------------- tf_pre

def test_crop_boxes_equal_jax():
    for h, w in ((200, 300), (375, 500), (64, 64), (500, 120)):
        r1, r2 = np.random.RandomState(h), np.random.RandomState(h)
        for _ in range(200):
            assert random_crop_box(h, w, r1) == jax_random_crop_box(h, w, r2)
        for size in (32, 224, 260):
            assert center_crop_box(h, w, size) == jax_center_crop_box(h, w, size)
    assert CROP_PADDING == 32


FIXTURE_FILES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".png", ".jpg"))


@pytest.mark.parametrize("fname", FIXTURE_FILES)
def test_tf_preprocess_from_bytes_matches_jax(fname):
    data = (FIXTURES / fname).read_bytes()
    for train, seed, size, interp in ((False, None, 224, "bicubic"), (True, 0, 224, "bicubic"),
                                      (True, 3, 57, "bicubic"), (True, 1, 64, "bilinear")):
        want_t = JaxTfPre(is_training=train, size=size, interpolation=interp, seed=seed)
        got_t = TfPreprocessTransform(is_training=train, size=size, interpolation=interp,
                                      seed=seed, device="cpu")
        for _ in range(3):
            want = want_t(data)
            got = got_t(data)
            assert got.dtype == torch.uint8 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{fname} {train} {seed}")
    chw_out = TfPreprocessTransform(size=32, chw=True, device="cpu")(data)
    np.testing.assert_array_equal(chw_out.numpy(), JaxTfPre(size=32, chw=True)(data))


def test_tf_preprocess_takes_a_tensor_and_records_its_box():
    arr = rgb_arrays(100, 150)[0]
    t = TfPreprocessTransform(is_training=True, size=48, seed=5, device="cpu")
    want_t = JaxTfPre(is_training=True, size=48, seed=5)
    for _ in range(4):
        np.testing.assert_array_equal(t(torch.from_numpy(arr)).numpy(),
                                      want_t(Image.fromarray(arr)))
        top, left, ch, cw = t.last_box
        assert 0 <= top and top + ch <= 100 and 0 <= left and left + cw <= 150
    with pytest.raises(ValueError, match="interpolation"):
        TfPreprocessTransform(interpolation="lanczos", device="cpu")


# ------------------------------------------------------- mixup and erasing

def test_one_hot_smooth_matches_jax():
    labels = np.array([0, 3, 1, 4])
    np.testing.assert_allclose(one_hot_smooth(torch.from_numpy(labels), 5, 0.1).numpy(),
                               np.asarray(jax_one_hot_smooth(jnp.asarray(labels), 5, 0.1)),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixup_matches_jax_on_its_draw(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(6, 9, 11, 3).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = jax_mixup(jnp.asarray(images), jnp.asarray(labels), 5, key,
                               alpha=0.2, smoothing=0.1)
    lam = float(jax.random.beta(key, 0.2, 0.2))
    got_x, got_y = mixup(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                         torch.from_numpy(labels), 5, alpha=0.2, smoothing=0.1, lam=lam)
    np.testing.assert_allclose(got_x.numpy().transpose(0, 2, 3, 1), np.asarray(want_x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(seed)
    x2, y2 = mixup(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(labels), 5, gen)
    np.testing.assert_allclose(y2.sum(1).numpy(), 1.0, rtol=1e-6)


def jax_erasing_draws(key, b, h, w, c, probability, min_area=0.02, max_area=1 / 3,
                      min_aspect=0.3):
    """``random_erasing``'s draws from ``key``, as it splits and uses it
    (scouter_tpu/data/extra_augment.py:58-72)."""
    keys = jax.random.split(key, 6)
    return dict(
        do=np.asarray(jax.random.bernoulli(keys[0], probability, (b,))),
        area=np.asarray(jax.random.uniform(keys[1], (b,), minval=min_area, maxval=max_area)),
        log_aspect=np.asarray(jax.random.uniform(keys[2], (b,), minval=jnp.log(min_aspect),
                                                 maxval=jnp.log(1 / min_aspect))),
        top=np.asarray(jax.random.uniform(keys[3], (b,))),
        left=np.asarray(jax.random.uniform(keys[4], (b,))),
        noise=np.asarray(jax.random.normal(keys[5], (b, h, w, c), jnp.float32)))


@pytest.mark.parametrize("probability", [0.5, 1.0])
def test_random_erasing_matches_jax_on_its_draws(probability):
    rng = np.random.RandomState(7)
    images = rng.rand(8, 21, 17, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_random_erasing(jnp.asarray(images), key, probability=probability))
    d = jax_erasing_draws(key, 8, 21, 17, 3, probability)
    got = random_erasing(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                         probability=probability,
                         noise=torch.from_numpy(d.pop("noise").transpose(0, 3, 1, 2).copy()),
                         **{k: torch.from_numpy(v.copy()) for k, v in d.items()})
    got = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got != images, want != images)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want != images).any()


def test_random_erasing_draws_from_its_generator():
    images = torch.zeros(6, 3, 16, 16)
    a = random_erasing(images, torch.Generator().manual_seed(1), probability=1.0)
    b = random_erasing(images, torch.Generator().manual_seed(1), probability=1.0)
    assert torch.equal(a, b) and (a != 0).flatten(1).any(1).all()
    assert torch.equal(random_erasing(images, torch.Generator().manual_seed(1),
                                      probability=0.0), images)
