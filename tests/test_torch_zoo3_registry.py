"""The last backbone slice's registry against the JAX package on the CPU:
the 29 entrypoints of dpn.py, tresnet.py, selecsls.py, inception_v3.py,
inception_v4.py, inception_resnet_v2.py, xception.py, gluon_xception.py,
nasnet.py and pnasnet.py, each built on the meta device with JAX's feature
width and its parameter tree against ``jax.eval_shape`` of JAX's init, and
the JAX modules' public names (``test_torch_zoo3_carrier.py`` takes every
entrypoint's names through the weight carrier). The port's registry is
JAX's.

Every model here is built on ``torch.device("meta")`` and never run."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from scouter_tpu.models.selecsls import _CONFIGS as JAX_SELECSLS
from scouter_tpu_torch.models import list_models
from test_torch_zoo_registry import STILL_TO_PORT, flat_shapes, meta_model, port_tree_shapes

FAMILIES = ("dpn", "tresnet", "selecsls", "inception_v3", "inception_v4", "inception_resnet_v2",
            "xception", "gluon_xception", "nasnet", "pnasnet")
NEW_ZOO = sorted(n for n, fn in JAX_REGISTRY.items() if fn.__module__.split(".")[-1] in FAMILIES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_slice_registers_the_ten_families():
    assert len(NEW_ZOO) == 29 and not STILL_TO_PORT
    assert list_models() == sorted(JAX_REGISTRY)


def jax_feature_width(jmodel) -> int:
    """The width of JAX's ``features_only`` map, from the module's fields."""
    kind = type(jmodel).__name__
    if kind == "TResNet":
        return int(64 * jmodel.width_factor) * 32
    if kind == "DPN":
        bw = 512 * (1 if jmodel.small else 4)
        return bw + (jmodel.k_sec[-1] + 2) * jmodel.inc_sec[-1]
    if kind == "SelecSLS":
        return JAX_SELECSLS[jmodel.variant][1][-1][0]
    if kind == "NASNetALarge":
        return jmodel.num_features
    return {"InceptionV3": 2048, "InceptionV4": 1536, "InceptionResnetV2": 1536,
            "Xception": 2048, "Xception65": 2048, "PNASNet5Large": 4320}[kind]


def head_of(model):
    """The classifier a family names: ``classifier`` (DPN's 1x1 conv),
    ``last_linear``, ``classif``, ``fc`` or ``head.fc``."""
    for name in ("classifier", "last_linear", "classif", "fc"):
        if getattr(model, name, None) is not None:
            return getattr(model, name)
    return model.head.fc


@pytest.mark.parametrize("name", NEW_ZOO)
def test_new_entrypoint_builds_on_meta_with_the_jax_feature_width(name):
    model = meta_model(name, num_classes=10)
    assert model.num_features == jax_feature_width(jax_create_model(name, num_classes=10))
    assert head_of(model).weight.shape[:2] == (10, model.num_features)
    # every entrypoint takes and drops mnist_stem, as JAX's do
    assert meta_model(name, mnist_stem=True).num_features == model.num_features


@functools.lru_cache(maxsize=None)
def jax_tree_shapes(key):
    """``jax.eval_shape`` of the init of the JAX module ``repr``'d as ``key``
    at 96 px (the aliases share one)."""
    jmodel = _JAX_MODELS[key]
    x = jax.ShapeDtypeStruct((1, 96, 96, 3), jnp.float32)
    return {k: tuple(v.shape)
            for k, v in flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x))}


_JAX_MODELS = {}


@pytest.mark.parametrize("name", NEW_ZOO)
def test_new_entrypoint_has_the_jax_parameter_tree(name):
    jmodel = jax_create_model(name)
    _JAX_MODELS.setdefault(repr(jmodel), jmodel)
    assert port_tree_shapes(meta_model(name)) == jax_tree_shapes(repr(jmodel))


@pytest.mark.parametrize("module", FAMILIES)
def test_public_names_match_jax(module):
    """Each family module exports the JAX module's public names."""
    import importlib

    jmod = importlib.import_module(f"scouter_tpu.models.{module}")
    tmod = importlib.import_module(f"scouter_tpu_torch.models.{module}")
    assert jmod.__all__ == tmod.__all__
    for name in jmod.__all__:
        assert hasattr(tmod, name), (module, name)
