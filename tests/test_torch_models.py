"""The port's layers, backbones, SlotModel, weight carrier and serving
function against the JAX package on the CPU, at small sizes.

JAX variables are initialised, their BatchNorm statistics and affine
parameters (the identity at init, which would hide a naming or layout fault)
and biases are perturbed with numpy noise, and the same weights reach the
port through ``variables_to_state_dict``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models import layers as jax_layers
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.serve import make_serving_fn as jax_make_serving_fn
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.data import preprocess_batch, resize_bilinear
from scouter_tpu_torch.models import build_slot_model, create_model, init_weights, layers
from scouter_tpu_torch.models import list_models
from scouter_tpu_torch.models import variables_to_state_dict
from scouter_tpu_torch.serve import make_serving_fn

FEATURE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_models.py:144


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def perturb(variables, seed):
    """Numpy noise on BN statistics, BN scales and every bias."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, np.float32)
        name = str(path[-1].key)
        if name == "mean" or name == "bias":
            return x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        if name in ("var", "scale"):
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def port_variables(model, seed=0):
    """The port's init of ``model`` as the JAX package's converter reads it,
    perturbed."""
    init_weights(model, torch.Generator().manual_seed(seed))
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    return perturb(torch_state_dict_to_variables(sd), seed=seed + 3)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# -------------------------------------------------------------------- layers

@pytest.mark.parametrize("hw", [(8, 8), (7, 5), (1, 3)])
def test_avg_pool_ceil_exclude_pad(hw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = jax_layers.avg_pool_ceil_exclude_pad(jnp.asarray(x), 2, 2)
    got = layers.avg_pool_ceil_exclude_pad(nhwc(x), 2, 2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["max_pool", "avg_pool_include_pad", "global_avg_pool"])
def test_pools(name):
    x = np.random.RandomState(1).randn(2, 9, 7, 4).astype(np.float32)
    if name == "max_pool":
        want, got = jax_layers.max_pool_3x3_s2_p1(x), layers.max_pool_3x3_s2_p1(nhwc(x))
    elif name == "avg_pool_include_pad":
        want = jax_layers.avg_pool_include_pad(x, 3, 2, 1)
        got = layers.avg_pool_include_pad(nhwc(x), 3, 2, 1)
    else:
        want, got = jax_layers.global_avg_pool(x), layers.global_avg_pool(nhwc(x))
    got = got.numpy() if got.ndim == 2 else got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (7, 2), (1, 1)])
def test_torch_conv_padding(k, s):
    assert layers.torch_conv_padding(k, s) == jax_layers.torch_conv_padding(k, s)


def test_registry():
    """The port registers the JAX registry name for name, less the families
    not ported yet (``test_torch_zoo_registry.STILL_TO_PORT``, none since
    the last ten families); a name outside it raises KeyError."""
    from scouter_tpu.models.registry import _REGISTRY as jax_registry
    from test_torch_zoo_registry import STILL_TO_PORT

    zoo = {n for n, fn in jax_registry.items() if fn.__module__ == "scouter_tpu.models.zoo"}
    assert zoo <= set(list_models()) and len(zoo) == 92
    assert set(list_models()) == set(jax_registry) - set(STILL_TO_PORT)
    with pytest.raises(ValueError):
        create_model("resnet10", pretrained=True)
    with pytest.raises(KeyError):
        create_model("no_such_model")


# ----------------------------------------------------------------- backbones

@pytest.mark.parametrize("name,chans,size,mnist", [
    ("resnet10", 1, 64, True),
    ("resnet10", 3, 64, False),
    ("resnest14d", 3, 64, False),
    ("resnest14d", 3, 72, False),
])
def test_backbone_features_and_logits(name, chans, size, mnist):
    jmodel = jax_create_model(name, num_classes=5, in_chans=chans, mnist_stem=mnist)
    x = np.random.RandomState(2).randn(2, size, size, chans).astype(np.float32)
    model = create_model(name, num_classes=5, in_chans=chans, mnist_stem=mnist).eval()
    variables = port_variables(model)
    feats_j, logits_j = jax.jit(
        lambda v, x: (jmodel.apply(v, x, features_only=True), jmodel.apply(v, x)))(variables, x)

    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    with torch.no_grad():
        feats = model(nhwc(x), features_only=True)
        logits = model(nhwc(x))
    np.testing.assert_allclose(feats.numpy().transpose(0, 2, 3, 1), np.asarray(feats_j),
                               **FEATURE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)


# ------------------------------------------------- slot model and the slice

SLICE_CASES = {
    "resnet10-mnist-64": dict(model="resnet10", dataset="MNIST", img_size=64),
    "resnest14d-imagenet-72": dict(model="resnest14d", dataset="ImageNet", img_size=72),
}


def slice_cfgs(case):
    kw = dict(num_classes=3, slots_per_class=2, to_k_layer=2, power=2, loss_status=1,
              use_slot=True, pre_trained=False, **SLICE_CASES[case])
    return JaxConfig(**kw), ScouterConfig(**kw)


@pytest.fixture(scope="module", params=sorted(SLICE_CASES))
def slice_case(request):
    jcfg, cfg = slice_cfgs(request.param)
    chans = 1 if jcfg.dataset == "MNIST" else 3
    x = jnp.zeros((1, jcfg.img_size, jcfg.img_size, chans), jnp.float32)
    variables = perturb(jax.jit(jax_build_slot_model(jcfg).init)(jax.random.PRNGKey(1), x),
                        seed=4)
    images = np.random.RandomState(5).randint(
        0, 256, (3, jcfg.img_size, jcfg.img_size, chans), np.uint8)
    return jcfg, cfg, variables, images


def port_state_dict(cfg, variables):
    """``variables`` as the state dict of ``cfg``'s slot model."""
    return variables_to_state_dict(variables, build_slot_model(cfg, device="cpu").state_dict())


def test_slot_model_logits_area_attention(slice_case):
    jcfg, cfg, variables, images = slice_case
    x = np.asarray((images.astype(np.float32) - 100.0) / 60.0)
    want = jax.jit(jax_build_slot_model(jcfg).apply)(variables, x)
    model = build_slot_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    with torch.no_grad():
        got = model(nhwc(x))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **FEATURE_TOL)
    np.testing.assert_allclose(got["area_loss"].numpy(), np.asarray(want["area_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["attn"].numpy(), np.asarray(want["attn"]),
                               rtol=1e-4, atol=1e-5)


def test_weight_carrier_round_trip(slice_case):
    """variables -> port state dict -> the JAX package's own converter gives
    the JAX variables back, leaf for leaf."""
    _, cfg, variables, _ = slice_case
    model = build_slot_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    back = flat(torch_state_dict_to_variables(model.state_dict()))
    want = flat(variables)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_fresh_port_model_has_the_jax_tree(slice_case):
    """A freshly initialised port model converts to a tree of the JAX
    model's structure and shapes (no missing or extra parameters)."""
    _, cfg, variables, _ = slice_case
    got = flat(torch_state_dict_to_variables(build_slot_model(cfg, device="cpu").state_dict()))
    want = flat(variables)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_fn_matches_jax(slice_case, dtype):
    """The slice as a whole: uint8 batch -> logits and slot maps."""
    jcfg, cfg, variables, images = slice_case
    jdtype = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = {"float32": None, "bfloat16": torch.bfloat16}[dtype]
    want = jax.jit(jax_make_serving_fn(jcfg, variables, compute_dtype=jdtype))(images)
    got = make_serving_fn(cfg, port_state_dict(cfg, variables), compute_dtype=tdtype,
                          device="cpu")(images)
    tol = FEATURE_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)  # serve/cli.py:80-81
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **tol)
    assert got["slot_maps"].dtype == torch.uint8
    assert got["slot_maps"].shape == tuple(np.asarray(want["slot_maps"]).shape)
    if dtype == "float32":
        # the uint8 cast truncates: a value at a step boundary may land one step apart
        diff = got["slot_maps"].numpy().astype(int) - np.asarray(want["slot_maps"]).astype(int)
        assert np.abs(diff).max() <= 1


def test_bf16_serving_maps_match_jax(slice_case):
    """bf16 serving's uint8 slot maps against JAX's bf16 maps, within JAX's
    own bf16-vs-f32 map difference (at least one level); logits within
    3e-2 (serve/cli.py:80-81)."""
    jcfg, cfg, variables, _ = slice_case
    chans = 1 if jcfg.dataset == "MNIST" else 3
    images = np.random.RandomState(5).randint(
        0, 256, (8, jcfg.img_size, jcfg.img_size, chans), np.uint8)
    want = jax.jit(jax_make_serving_fn(jcfg, variables, compute_dtype=jnp.bfloat16))(images)
    want32 = jax.jit(jax_make_serving_fn(jcfg, variables))(images)
    got = make_serving_fn(cfg, port_state_dict(cfg, variables),
                          compute_dtype=torch.bfloat16, device="cpu")(images)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=3e-2, atol=3e-2)
    want_maps = np.asarray(want["slot_maps"]).astype(int)
    jax_gap = np.abs(want_maps - np.asarray(want32["slot_maps"]).astype(int)).max()
    diff = np.abs(got["slot_maps"].numpy().astype(int) - want_maps).max()
    assert diff <= max(1, jax_gap), (diff, jax_gap)


def test_bf16_serving_keeps_batchnorm_f32(slice_case):
    """Every BatchNorm weight, bias and running statistic of the bf16 served
    model stays f32, as flax keeps its f32 ``param_dtype``."""
    _, cfg, variables, _ = slice_case
    fn = make_serving_fn(cfg, port_state_dict(cfg, variables),
                         compute_dtype=torch.bfloat16, device="cpu")
    bns = [m for m in fn.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns
    for bn in bns:
        assert bn.compute_dtype == torch.bfloat16
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            assert t.dtype == torch.float32


def test_bf16_backbone_keeps_slot_head_f32(slice_case):
    _, cfg, _, _ = slice_case
    model = build_slot_model(cfg, compute_dtype=torch.bfloat16, device="cpu")
    conv = model.backbone.layer1[0].conv1
    assert conv.weight.dtype == torch.float32
    assert conv.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.backbone.parameters())
    assert model.conv1x1.weight.dtype == torch.float32
    assert model.slot.initial_slots.dtype == torch.float32
    # a bf16 slot head keeps f32 parameters and computes in bf16, cast at use
    compute = build_slot_model(cfg.replace(slot_head_dtype="compute"),
                               compute_dtype=torch.bfloat16, device="cpu")
    assert compute.slot.initial_slots.dtype == torch.float32
    assert compute.conv1x1.weight.dtype == torch.float32
    assert compute.slot.compute_dtype == compute.conv1x1.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in compute.parameters())


# ------------------------------------------------------------------- data

def test_preprocess_matches_jax():
    from scouter_tpu.data.transforms import preprocess_batch as jax_preprocess

    images = np.random.RandomState(6).randint(0, 256, (2, 16, 16, 3), np.uint8)
    want = jax_preprocess(jnp.asarray(images), dataset="ImageNet", img_size=16)
    got = preprocess_batch(torch.from_numpy(images), dataset="ImageNet", img_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # train mode without augmentation is the same transform, as in JAX
    want = jax_preprocess(jnp.asarray(images), dataset="ImageNet", img_size=16, train=True)
    got = preprocess_batch(torch.from_numpy(images), dataset="ImageNet", img_size=16, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_resize_bilinear_upscale_matches_jax():
    from scouter_tpu.data.transforms import resize_bilinear as jax_resize

    images = np.random.RandomState(7).randint(0, 256, (2, 12, 12, 1), np.uint8)
    want = jax_resize(jnp.asarray(images), 20)
    got = resize_bilinear(torch.from_numpy(images), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
