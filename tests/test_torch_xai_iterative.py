"""The port's random and iterative attribution against the JAX package on the
CPU, fed JAX's own draws (regenerated from JAX's keys exactly as the JAX
functions split them): RISE (``explain/rise.py``), IGOS
(``explain/igos.py``), extremal perturbation (``explain/extremal.py``),
IBA (``explain/iba.py``) and readout IBA (``explain/iba_readout.py``), on
resnet10 at 48 px with 3 classes.

RISE within 1e-4 of its scale; the iterative methods within 1e-3 after
their full default iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.explain import cam as jax_cam
from scouter_tpu.explain import extremal as jax_extremal
from scouter_tpu.explain import iba as jax_iba
from scouter_tpu.explain import iba_readout as jax_readout
from scouter_tpu.explain import igos as jax_igos
from scouter_tpu.explain import rise as jax_rise
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu_torch.explain import cam, extremal, iba, iba_readout, igos, rise
from scouter_tpu_torch.models import create_model, variables_to_state_dict
from scouter_tpu_torch.models.convert import readout_params_to_state_dict
from test_torch_models import nhwc, perturb
from test_torch_xai_cam import assert_map_close, chw

SIZE = 48
CLASS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_create_model("resnet10", num_classes=3)
    x = np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    model = create_model("resnet10", num_classes=3).eval()
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    return (lambda im: jmodel.apply(variables, im)), model, x, (jmodel, variables)


def jax_rise_draws(key, num_masks, height, width, num_cells=7, batch_size=32, p=0.5):
    """``rise._rise_program``'s per-chunk draws: split(key, chunks), then
    each chunk key split in three for the grid and the two shifts."""
    grids, sxs, sys_ = [], [], []
    for k in jax.random.split(key, -(-num_masks // batch_size)):
        kg, kx, ky = jax.random.split(k, 3)
        grids.append((jax.random.uniform(kg, (batch_size, num_cells, num_cells)) < p)
                     .astype(jnp.float32))
        sxs.append(jax.random.randint(kx, (batch_size,), 0, -(-height // num_cells)))
        sys_.append(jax.random.randint(ky, (batch_size,), 0, -(-width // num_cells)))
    return [torch.from_numpy(np.concatenate([np.asarray(a) for a in arrs])).to(dtype)
            for arrs, dtype in ((grids, torch.float32), (sxs, torch.long), (sys_, torch.long))]


def test_rise_on_jax_draws(pair):
    jfwd, model, x, _ = pair
    key = jax.random.PRNGKey(5)
    want = jax_rise.rise(jfwd, jnp.asarray(x), key, num_masks=100)
    grid, sx, sy = jax_rise_draws(key, 100, SIZE, SIZE)
    got = rise.rise_from_draws(model, nhwc(x), grid, sx, sy, 100)
    assert got.shape == (3, SIZE, SIZE)
    assert_map_close(got, want)


def test_rise_masks_and_filter_masks(pair):
    jfwd, model, x, _ = pair
    key = jax.random.PRNGKey(6)
    want = jax_rise._make_masks(key, 8, 7, 0.5, 30, 27)
    kg, kx, ky = jax.random.split(key, 3)
    grid = (jax.random.uniform(kg, (8, 7, 7)) < 0.5).astype(jnp.float32)
    sx = jax.random.randint(kx, (8,), 0, 5)
    sy = jax.random.randint(ky, (8,), 0, 4)
    got = rise._make_masks(torch.tensor(np.asarray(grid)), torch.tensor(np.asarray(sx)).long(),
                           torch.tensor(np.asarray(sy)).long(), 30, 27)
    assert_map_close(got, want)
    masks = np.random.RandomState(1).rand(40, SIZE, SIZE).astype(np.float32)
    want = jax_rise.rise(jfwd, jnp.asarray(x), num_masks=40, filter_masks=jnp.asarray(masks))
    got = rise.rise(model, nhwc(x), num_masks=40, filter_masks=torch.from_numpy(masks))
    assert_map_close(got, want)


def test_rise_draws_are_seeded_and_whole_chunks():
    g = torch.Generator().manual_seed(3)
    grid, sx, sy = rise.draw_rise(g, 70, 260, 250)
    assert grid.shape == (96, 7, 7) and set(grid.unique().tolist()) <= {0.0, 1.0}
    assert int(sx.max()) < 38 and int(sy.max()) < 36 and int(sx.min()) >= 0
    again = rise.draw_rise(torch.Generator().manual_seed(3), 70, 260, 250)
    assert all(torch.equal(a, b) for a, b in zip((grid, sx, sy), again))


def test_igos_on_jax_noise(pair):
    jfwd, model, x, _ = pair
    key = jax.random.PRNGKey(7)
    blurred_j = jax_igos.gaussian_blur_baseline(jnp.asarray(x))
    blurred = igos.gaussian_blur_baseline(nhwc(x))
    assert_map_close(blurred, chw(blurred_j), rel=1e-5)
    want = jax_igos.integrated_mask(jfwd, jnp.asarray(x), blurred_j, CLASS, key)
    noise = [torch.from_numpy(np.asarray(0.2 * jax.random.normal(k, (20, SIZE, SIZE, 3)))
                              .transpose(0, 3, 1, 2).copy())
             for k in jax.random.split(key, 15)]
    got = igos.integrated_mask(model, nhwc(x), blurred, CLASS, draw_noise=noise.__getitem__)
    for name in ("mask", "upsampled", "curve_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    assert_map_close(got.curve_reg, want.curve_reg, rel=1e-3)
    dj, ij = jax_igos.deletion_insertion_curve(jfwd, jnp.asarray(x), blurred_j, want.mask, CLASS,
                                               num_points=5)
    dt, it = igos.deletion_insertion_curve(model, nhwc(x), blurred,
                                           torch.from_numpy(np.asarray(want.mask)), CLASS,
                                           num_points=5)
    assert_map_close(dt, dj)
    assert_map_close(it, ij)


def test_igos_pieces_match_jax():
    rng = np.random.RandomState(2)
    m = rng.rand(13, 9).astype(np.float32)
    got = igos._resize_bilinear_align_corners(torch.from_numpy(m), 31, 20)
    assert_map_close(got, jax_igos._resize_bilinear_align_corners(jnp.asarray(m), 31, 20),
                     rel=1e-5)
    assert_map_close(igos.tv_norm(torch.from_numpy(m), 2.0), jax_igos.tv_norm(jnp.asarray(m), 2.0),
                     rel=1e-5)
    # the l1 term's derivative at |1 - m| = 0 is JAX's, 1, not torch.abs's 0
    m1 = torch.ones(3, 3, requires_grad=True)
    (g,) = torch.autograd.grad(igos._abs(1.0 - m1).mean(), m1)
    (gj,) = jax.grad(lambda v: jnp.mean(jnp.abs(1.0 - v)), argnums=(0,))(jnp.ones((3, 3)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))


def test_extremal_perturbation_matches_jax(pair):
    jfwd, model, x, _ = pair
    want_masks, want_hist = jax_extremal.extremal_perturbation(jfwd, jnp.asarray(x), CLASS)
    masks, hist = extremal.extremal_perturbation(model, nhwc(x), CLASS)
    assert masks.shape == (1, 1, SIZE, SIZE) and hist.shape == (1, 2, 800)
    np.testing.assert_allclose(masks.numpy(), chw(want_masks), rtol=1e-3, atol=1e-3)
    assert_map_close(hist[:, 0], np.asarray(want_hist)[:, 0], rel=1e-3)
    assert_map_close(hist[:, 1], np.asarray(want_hist)[:, 1], rel=1e-3)


@pytest.mark.parametrize("variant", ["delete", "dual"])
def test_extremal_variants_and_pieces(pair, variant):
    jfwd, model, x, _ = pair
    want, _ = jax_extremal.extremal_perturbation(
        jfwd, jnp.asarray(x), CLASS, areas=(0.05, 0.2), max_iter=6, variant=variant,
        reward_func=jax_extremal.contrastive_reward, perturbation="fade", smooth=0.05)
    got, _ = extremal.extremal_perturbation(
        model, nhwc(x), CLASS, areas=(0.05, 0.2), max_iter=6, variant=variant,
        reward_func=extremal.contrastive_reward, perturbation="fade", smooth=0.05)
    np.testing.assert_allclose(got.numpy(), chw(want), rtol=1e-3, atol=1e-3)
    pmask = np.random.RandomState(4).rand(2, 7, 7).astype(np.float32)
    gen_j = jax_extremal.MaskGenerator((SIZE, SIZE), 7, 21.0)
    gen_t = extremal.MaskGenerator((SIZE, SIZE), 7, 21.0)
    for a, b in zip(gen_t.generate(torch.from_numpy(pmask)), gen_j.generate(jnp.asarray(pmask))):
        assert_map_close(a, b, rel=1e-5)


def test_estimate_stats_matches_jax(pair):
    _, model, x, (jmodel, variables) = pair
    jf, _, _ = jax_cam.backbone_split(jmodel, variables)
    f, _, _ = cam.backbone_split(model)
    batches = [np.random.RandomState(i).randn(4, SIZE, SIZE, 3).astype(np.float32)
               for i in range(3)]
    want = jax_iba.estimate_stats(jf, [jnp.asarray(b) for b in batches])
    got = iba.estimate_stats(f, [nhwc(b) for b in batches])
    assert got.n_samples == want.n_samples == 12
    assert_map_close(got.mean, chw(want.mean), rel=1e-5)
    assert_map_close(got.std, chw(want.std), rel=1e-5)
    np.testing.assert_array_equal(got.active.numpy(), chw(want.active))


def test_iba_analyze_on_jax_noise(pair):
    _, model, x, (jmodel, variables) = pair
    jf, jh, _ = jax_cam.backbone_split(jmodel, variables)
    f, h, _ = cam.backbone_split(model)
    batches = [np.random.RandomState(i).randn(4, SIZE, SIZE, 3).astype(np.float32)
               for i in range(3)]
    stats_j = jax_iba.estimate_stats(jf, [jnp.asarray(b) for b in batches])
    stats = iba.estimate_stats(f, [nhwc(b) for b in batches])
    key = jax.random.PRNGKey(4)
    shape = (10, *jf(jnp.asarray(x)).shape[1:])
    eps = [torch.from_numpy(np.asarray(jax.random.normal(k, shape)).transpose(0, 3, 1, 2).copy())
           for k in jax.random.split(key, 10)]
    want = jax_iba.iba_analyze(
        jf, lambda z: -jax.nn.log_softmax(jh(z), axis=1)[:, CLASS].mean(), jnp.asarray(x),
        stats_j, key, out_shape=(SIZE, SIZE))
    got = iba.iba_analyze(f, lambda z: -torch.log_softmax(h(z), dim=1)[:, CLASS].mean(),
                          nhwc(x), stats, draw_eps=eps.__getitem__, out_shape=(SIZE, SIZE))
    assert_map_close(got, want, rel=1e-3)


def test_iba_pieces_match_jax():
    rng = np.random.RandomState(5)
    lam = rng.rand(2, 5, 6, 3).astype(np.float32)
    want = jax_iba._gaussian_smooth(jnp.asarray(lam), 1.0)
    assert_map_close(iba._gaussian_smooth(nhwc(lam), 1.0), chw(want), rel=1e-5)
    # optax.adam's step, ten times
    import optax

    p = rng.randn(4, 3).astype(np.float32)
    tx = optax.adam(1.0)
    state, pj = tx.init(jnp.asarray(p)), jnp.asarray(p)
    pt = torch.from_numpy(p)
    opt = iba._Adam(pt, 1.0)
    for i in range(10):
        g = rng.randn(4, 3).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt = opt.step(pt, torch.from_numpy(g))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)


def test_readout_iba_matches_jax():
    """tests/test_iba_readout.py's toy: 150 training steps on JAX's noise,
    then the analysis, against JAX's from the same flax init."""
    rng = np.random.RandomState(0)
    data = [rng.randn(8, 4, 4, 4).astype(np.float32) for _ in range(4)]
    sub = (slice(None), slice(None, None, 2), slice(None, None, 2))
    b_stats_j = jax_iba.estimate_stats(lambda b: b, [jnp.asarray(d) for d in data])
    r_stats_j = [b_stats_j,
                 jax_iba.estimate_stats(lambda b: b[sub], [jnp.asarray(d) for d in data])]
    b_stats = iba.estimate_stats(lambda b: b, [nhwc(d) for d in data])
    r_stats = [b_stats, iba.estimate_stats(lambda b: b[:, :, ::2, ::2], [nhwc(d) for d in data])]

    readout_j = jax_readout.ReadoutNet(out_channels=4)
    inputs_j = jax_readout.readout_inputs([jnp.asarray(data[0]), jnp.asarray(data[0][sub])],
                                          r_stats_j, (4, 4))
    inputs = iba_readout.readout_inputs([nhwc(data[0]), nhwc(data[0][sub])], r_stats, (4, 4))
    assert_map_close(inputs, chw(inputs_j), rel=1e-5)
    params = readout_j.init(jax.random.PRNGKey(0), inputs_j)
    readout = iba_readout.ReadoutNet(4, in_channels=8)
    readout.load_state_dict(readout_params_to_state_dict(params))

    key = jax.random.PRNGKey(1)
    params, losses_j = jax_readout.train_readout(
        params, readout_j, lambda: ((jnp.asarray(d), None) for d in data), lambda x: x,
        lambda x: [x, x[sub]], r_stats_j, b_stats_j,
        lambda z, aux: jnp.mean((z[:, :2, :2] - 3.0) ** 2), key, steps=150, beta=1.0, lr=3e-2)
    eps = []
    for _ in range(150):
        key, k = jax.random.split(key)
        eps.append(torch.from_numpy(np.asarray(jax.random.normal(k, (8, 4, 4, 4)))
                                    .transpose(0, 3, 1, 2).copy()))
    readout, losses = iba_readout.train_readout(
        readout, lambda: ((nhwc(d), None) for d in data), lambda x: x,
        lambda x: [x, x[:, :, ::2, ::2]], r_stats, b_stats,
        lambda z, aux: ((z[:, :, :2, :2] - 3.0) ** 2).mean(), steps=150, beta=1.0, lr=3e-2,
        draw_eps=lambda i, shape: eps[i])
    np.testing.assert_allclose(losses, losses_j, rtol=1e-3, atol=1e-3)
    for name, value in readout_params_to_state_dict(params).items():
        assert_map_close(readout.state_dict()[name], value.numpy(), rel=1e-3)

    x = np.full((1, 4, 4, 4), 3.0, np.float32)
    for out_shape in (None, (8, 8)):
        want = jax_readout.readout_analyze(params, readout_j, jnp.asarray(x), lambda v: v,
                                           lambda v: [v, v[sub]], r_stats_j, b_stats_j,
                                           out_shape=out_shape)
        got = iba_readout.readout_analyze(readout, nhwc(x), lambda v: v,
                                          lambda v: [v, v[:, :, ::2, ::2]], r_stats, b_stats,
                                          out_shape=out_shape)
        assert_map_close(got, want, rel=1e-3)
