"""The port's single-shot and masked-rescoring attribution against the JAX
package on the CPU, same weights and inputs: the CAM family
(``explain/cam.py``), the backprop family (``explain/backprop.py``),
DeepLift (``explain/deeplift.py``) and excitation backprop
(``explain/excitation.py``), on resnet10 at 64 px with 3 classes.

Maps are compared before the min-max, within 1e-4 of the map's scale;
Smooth Grad-CAM++ and SS-CAM take JAX's own noise draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.explain import backprop as jax_backprop
from scouter_tpu.explain import cam as jax_cam
from scouter_tpu.explain import deeplift as jax_deeplift
from scouter_tpu.explain import excitation as jax_excitation
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu_torch.explain import backprop, cam, deeplift, excitation
from scouter_tpu_torch.models import create_model, variables_to_state_dict
from test_torch_models import nhwc, perturb

SIZE = 64
CLASS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_map_close(got, want, rel=1e-4):
    """Within ``rel`` of the map's scale (max |want|)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def chw(a):
    """JAX's (h, w, C) or (1, H, W, C) as the port's (C, h, w) / (1, C, H, W)."""
    a = np.asarray(a)
    return a.transpose(2, 0, 1) if a.ndim == 3 else a.transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_create_model("resnet10", num_classes=3)
    x = np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    model = create_model("resnet10", num_classes=3).eval()
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    return jmodel, variables, model, x


@pytest.mark.parametrize("method", ["cam", "gradcam", "gradcampp", "scorecam", "isscam"])
def test_cam_family_matches_jax(pair, method):
    jmodel, variables, model, x = pair
    kw = dict(num_samples=3) if method == "isscam" else {}  # JAX's default is 10
    want = getattr(jax_cam, method)(jmodel, variables, jnp.asarray(x), CLASS,
                                    normalized=False, **kw)
    got = getattr(cam, method)(model, nhwc(x), CLASS, normalized=False, **kw)
    assert_map_close(got, want)
    # the min-max of a map the ReLU zeroed is 0/0 in both, as in torchcam
    np.testing.assert_allclose(cam._normalize(got).numpy(), np.asarray(jax_cam._normalize(want)),
                               rtol=1e-4, atol=1e-4, equal_nan=True)


def test_smooth_gradcampp_on_jax_noise(pair):
    jmodel, variables, model, x = pair
    noise = np.asarray(0.3 * jax.random.normal(jax.random.PRNGKey(3), (4, 1, SIZE, SIZE, 3)))
    want = jax_cam.smooth_gradcampp(jmodel, variables, jnp.asarray(x), CLASS, noise=noise,
                                    normalized=False)
    got = cam.smooth_gradcampp(model, nhwc(x), CLASS, normalized=False,
                               noise=torch.from_numpy(noise.transpose(0, 1, 4, 2, 3).copy()))
    assert_map_close(got, want)


def test_sscam_on_jax_noise(pair):
    jmodel, variables, model, x = pair
    noise = np.asarray(2.0 * jax.random.normal(jax.random.PRNGKey(4), (3, SIZE, SIZE, 3)))
    want = jax_cam.sscam(jmodel, variables, jnp.asarray(x), CLASS, noise=noise,
                         normalized=False)
    got = cam.sscam(model, nhwc(x), CLASS, normalized=False,
                    noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    assert_map_close(got, want)


def test_random_cam_methods_draw_from_their_seed(pair):
    _, _, model, x = pair
    a = cam.smooth_gradcampp(model, nhwc(x), CLASS, seed=5)
    b = cam.smooth_gradcampp(model, nhwc(x), CLASS, seed=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (2, 2) and torch.isfinite(a).all()


def test_nan_to_one_quirk_and_channel_normalisation():
    """torchcam's nan -> 1 before the channel sum (cam.py:105-107) and the
    0/0 of a constant channel."""
    feats = torch.tensor([[[[1.0, 2.0]], [[float("nan"), 3.0]]]])  # (1, 2, 1, 2)
    m = cam._combine(feats, torch.tensor([1.0, 2.0]), relu=False, normalized=False)
    torch.testing.assert_close(m, torch.tensor([[2.0, 8.0]]))
    const = cam._normalize_channels(torch.ones(1, 1, 2, 2))
    assert torch.isnan(const).all()


@pytest.mark.parametrize("method", ["gradient_saliency", "deconvnet", "guided_backprop",
                                    "linear_approx"])
def test_backprop_family_matches_jax(pair, method):
    jmodel, variables, model, x = pair
    want = getattr(jax_backprop, method)(jmodel, variables, jnp.asarray(x), CLASS)
    got = getattr(backprop, method)(model, nhwc(x), CLASS)
    assert_map_close(got, want)


def test_linear_approx_at_a_stage_matches_jax(pair):
    jmodel, variables, model, x = pair
    want = jax_backprop.linear_approx(jmodel, variables, jnp.asarray(x), CLASS, "layer2")
    assert_map_close(backprop.linear_approx(model, nhwc(x), CLASS, "layer2"), want)


@pytest.mark.parametrize("layer", ["layer4", "layer2"])
def test_layer_deeplift_matches_jax(pair, layer):
    jmodel, variables, model, x = pair
    want = jax_deeplift.layer_deeplift(jmodel, variables, jnp.asarray(x), CLASS, layer=layer)
    assert_map_close(deeplift.layer_deeplift(model, nhwc(x), CLASS, layer=layer), chw(want))


def test_input_deeplift_matches_jax(pair):
    jmodel, variables, model, x = pair
    baseline = np.full_like(x, 0.1)
    want = jax_deeplift.deeplift(jmodel, variables, jnp.asarray(x), CLASS,
                                 baseline=jnp.asarray(baseline))
    got = deeplift.deeplift(model, nhwc(x), CLASS, baseline=nhwc(baseline))
    assert_map_close(got, chw(want))


def test_paired_rescale_rule():
    """delta_out/delta_in where the input moved, the local gradient where
    it did not (deeplift.py:25-50)."""
    z = torch.tensor([[2.0, -1.0, 1.0], [-2.0, -3.0, 1.0]], requires_grad=True)
    (g,) = torch.autograd.grad(deeplift._paired_rescale_relu(z).sum(), z)
    m = torch.tensor([2.0 / 4.0, 0.0, 1.0])
    torch.testing.assert_close(g, torch.stack([m, m]))


@pytest.mark.parametrize("layer", ["layer3", "layer2"])
def test_excitation_backprop_matches_jax(pair, layer):
    jmodel, variables, model, x = pair
    xa = np.abs(x)
    want = jax_excitation.excitation_backprop(jmodel, variables, jnp.asarray(xa), CLASS,
                                              saliency_layer=layer)
    got = excitation.excitation_backprop(model, nhwc(xa), CLASS, saliency_layer=layer)
    assert_map_close(got, want)


def test_contrastive_excitation_backprop_matches_jax(pair):
    jmodel, variables, model, x = pair
    xa = np.abs(x)
    want = jax_excitation.contrastive_excitation_backprop(jmodel, variables, jnp.asarray(xa),
                                                          CLASS)
    got = excitation.contrastive_excitation_backprop(model, nhwc(xa), CLASS)
    assert_map_close(got, want)
    assert float(got.min()) >= 0.0


def test_ebp_rules_conserve_relevance():
    """The linear rule's p' = x * W+ (p / (x W+)) sums to sum(p) on positive
    inputs; the eltwise rule splits by contribution; BatchNorm passes
    straight through; the EBP mean conserves (excitation_backprop.py)."""
    x = torch.tensor([[1.0, 2.0, 3.0]], requires_grad=True)
    w = torch.tensor([[1.0, -1.0], [0.5, 2.0], [-2.0, 1.0]])
    p = torch.tensor([[1.0, 1.0]])
    (g,) = torch.autograd.grad((excitation._ebp_linear(lambda a, k: a @ k, x, w) * p).sum(), x)
    w_pos = w.clamp_min(0)
    torch.testing.assert_close(g, x.detach() * ((p / (x.detach() @ w_pos + 1e-20)) @ w_pos.t()))
    torch.testing.assert_close(g.sum(), p.sum())
    a, b = torch.tensor([3.0], requires_grad=True), torch.tensor([1.0], requires_grad=True)
    ga, gb = torch.autograd.grad((excitation._ebp_add(a, b) * 4.0).sum(), (a, b))
    assert (float(ga), float(gb)) == (3.0, 1.0)
    y = torch.ones(3, requires_grad=True)
    (gy,) = torch.autograd.grad(excitation._straight_through(y, y * 5.0).sum(), y)
    torch.testing.assert_close(gy, torch.ones(3))
    f = torch.tensor([[[[1.0, 3.0]]]], requires_grad=True)
    (gf,) = torch.autograd.grad((excitation.ebp_mean(f) * 2.0).sum(), f)
    torch.testing.assert_close(gf.sum(), torch.tensor(2.0))
