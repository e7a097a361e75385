"""The second backbone slice's registry against the JAX package on the CPU:
the 176 entrypoints of efficientnet.py, regnet.py, dla.py, vovnet.py,
densenet.py, hrnet.py and senet.py, each built on the meta device with
JAX's feature width, the parameter trees of a representative per family
and option against ``jax.eval_shape`` (all 176 with their features' shape
in a ``slow`` test), the weight carrier's round trip through the JAX
package's converter, the weight aliases, the pretrained layouts and the
freeze mask. ``test_torch_zoo2_train.py`` runs the slice's models.

Heavy entrypoints (efficientnet_l2, senet154, hrnet_w64, densenet264) are
only built on ``torch.device("meta")`` here, never run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models import densenet as jax_densenet
from scouter_tpu.models import efficientnet as jax_eff
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.models.pruned import width_of as jax_width_of
from scouter_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from scouter_tpu.models.regnet import _stage_params
from scouter_tpu.train.state import make_freeze_labels as jax_make_freeze_labels
from scouter_tpu_torch.models import create_model, list_models, variables_to_state_dict
from scouter_tpu_torch.train.state import make_freeze_labels
from test_torch_models import flat
from test_torch_zoo_registry import STILL_TO_PORT, flat_shapes, meta_model, port_tree_shapes

FAMILIES = ("efficientnet", "regnet", "dla", "vovnet", "densenet", "hrnet", "senet")
NEW_ZOO = sorted(n for n, fn in JAX_REGISTRY.items() if fn.__module__.split(".")[-1] in FAMILIES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- the registry

def test_the_slice_registers_the_seven_families():
    assert len(NEW_ZOO) == 176
    assert set(NEW_ZOO) <= set(list_models())
    assert not set(STILL_TO_PORT) & set(list_models())


def jax_feature_width(jmodel) -> int:
    """The width of JAX's ``features_only`` map, from the module's fields."""
    if isinstance(jmodel, jax_eff.EfficientNet):
        return jax_width_of(jmodel.widths, "conv_head", jmodel.num_features)
    if isinstance(jmodel, jax_eff.MobileNetV3):
        return jax_eff.round_channels(jmodel.arch[-1][-1].channels, jmodel.channel_multiplier)
    if isinstance(jmodel, jax_densenet.DenseNet):
        n = 2 * jmodel.growth_rate
        for i, layers in enumerate(jmodel.block_config):
            n += layers * jmodel.growth_rate
            n = n // 2 if i < len(jmodel.block_config) - 1 else n
        return n
    kind = type(jmodel).__name__
    if kind == "RegNet":
        return _stage_params(jmodel.w0, jmodel.wa, jmodel.wm, jmodel.depth, jmodel.group_w,
                             jmodel.bottle_ratio)[-1][1]
    if kind == "DLA":
        return jmodel.channels[-1]
    if kind == "VovNet":
        return jmodel.stage_out_chs[-1]
    if kind == "HighResolutionNet":
        return 2048
    if kind == "SENet":
        return 512 * (1 if jmodel.block_kind == "basic" else 4)
    raise TypeError(kind)


def head_of(model):
    """The classifier a family names: ``classifier``, ``last_linear``,
    ``head.fc`` or ``fc``."""
    for name in ("classifier", "last_linear", "fc"):
        if getattr(model, name, None) is not None:
            return getattr(model, name)
    return model.head.fc


@pytest.mark.parametrize("name", NEW_ZOO)
def test_new_entrypoint_builds_on_meta_with_the_jax_feature_width(name):
    model = meta_model(name, num_classes=10)
    assert model.num_features == jax_feature_width(jax_create_model(name, num_classes=10))
    assert head_of(model).weight.shape[0] == 10


def jax_tree_shapes(jmodel, size=64):
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    return {k: tuple(v.shape)
            for k, v in flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x))}


@functools.lru_cache(maxsize=None)
def jax_abstract_tree(name):
    """``jax.eval_shape`` of ``name``'s init at 64 px."""
    return jax.eval_shape(jax_create_model(name).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))


# one entrypoint per family and option
REPRESENTATIVES = [
    "efficientnet_cc_b0_4e", "mixnet_s", "tf_efficientnet_es", "mobilenetv3_large_100",
    "mobilenetv3_rw", "efficientnet_b2_pruned", "regnety_002", "dla60_res2next",
    "ese_vovnet19b_dw", "ese_vovnet39b_evos", "densenetblur121d", "hrnet_w18_small",
    "seresnet18",
]


@pytest.mark.parametrize("name", REPRESENTATIVES)
def test_representative_has_the_jax_parameter_tree(name):
    want = {k: tuple(v.shape) for k, v in flat_shapes(jax_abstract_tree(name))}
    assert port_tree_shapes(meta_model(name)) == want


@pytest.mark.slow
@pytest.mark.parametrize("name", NEW_ZOO)
def test_every_new_entrypoint_has_the_jax_tree_and_features(name):
    """All 176 against ``jax.eval_shape``: the parameter tree, and the
    features' shape at 64 px from a forward on the meta device."""
    jmodel = jax_create_model(name)
    assert port_tree_shapes(meta_model(name)) == jax_tree_shapes(jmodel)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    want = jax.eval_shape(lambda k, x: jmodel.init_with_output(
        k, x, features_only=True)[0], jax.random.PRNGKey(0), x)
    with torch.device("meta"):
        got = meta_model(name)(torch.empty(1, 3, 64, 64), features_only=True)
    assert tuple(got.shape) == (1, want.shape[3], want.shape[1], want.shape[2])


# ------------------------------------------------------------- the carrier

def jax_random_tree(name):
    """A JAX tree of ``name`` at 64 px filled from numpy."""
    rng = np.random.RandomState(len(name))
    return jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                  dict(jax_abstract_tree(name)))


@pytest.mark.parametrize("name", REPRESENTATIVES)
def test_variables_round_trip_through_the_jax_converter(name):
    """JAX's tree -> ``variables_to_state_dict`` -> the port's model
    (strict) -> its state dict -> ``torch_state_dict_to_variables`` gives
    JAX's tree back, leaf for leaf: multi-index names (``blocks_2_1``,
    ``fuse_layers_1_0_0_0``, ``conv_dw_0``), EvoNorm's (1, C, 1, 1) leaves
    and the CondConv kernel's (params, experts) layout included."""
    tree = jax_random_tree(name)
    model = create_model(name)
    sd = variables_to_state_dict(tree, model.state_dict())
    model.load_state_dict(sd)  # strict: every name and shape is the port's own
    back = torch_state_dict_to_variables(
        {k: t.numpy() for k, t in model.state_dict().items()})
    want, got = flat(tree), flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_evonorm_and_condconv_leaves_take_timm_layouts():
    sd = variables_to_state_dict(jax_random_tree("ese_vovnet39b_evos"),
                                 meta_model("ese_vovnet39b_evos").state_dict())
    assert sd["stem.0.bn.v"].shape == sd["stem.0.bn.weight"].shape == (1, 64, 1, 1)
    assert sd["stem.0.bn.bias"].shape == (1, 64, 1, 1)
    sd = variables_to_state_dict(jax_random_tree("efficientnet_cc_b0_4e"),
                                 meta_model("efficientnet_cc_b0_4e").state_dict())
    w = sd["blocks.4.0.conv_dw.weight"]
    assert w.shape == (4, 480 * 1 * 5 * 5)  # (experts, out x in/g x k x k)


# ------------------------------------------------ aliases, layouts, freezing

@pytest.mark.parametrize("alias,base", [
    ("tv_densenet121", "densenet121"),
    ("mnasnet_b1", "mnasnet_100"),
    ("mnasnet_a1", "semnasnet_100"),
    ("efficientnet_b2a", "efficientnet_b2"),
])
def test_alias_same_architecture(alias, base):
    """``tests/test_models_zoo2.py``'s alias check on the port."""
    a, b = meta_model(alias, num_classes=5), meta_model(base, num_classes=5)
    assert {k: v.shape for k, v in a.state_dict().items()} == {
        k: v.shape for k, v in b.state_dict().items()}


def test_pretrained_layouts_are_jax_s():
    from scouter_tpu.train.loop import Trainer as JaxTrainer
    from scouter_tpu_torch.train import Trainer

    assert Trainer._PRETRAINED_LAYOUT == JaxTrainer._PRETRAINED_LAYOUT
    for name, (first_conv, classifier) in (("efficientnet_b0", ("conv_stem", "classifier")),
                                           ("mobilenetv3_large_100",
                                            ("conv_stem", "classifier")),
                                           ("densenet121", ("features.conv0", "classifier"))):
        sd = meta_model(name).state_dict()
        assert f"{first_conv}.weight" in sd and f"{classifier}.weight" in sd, name


@pytest.mark.parametrize("name", ["efficientnet_b0", "densenet121", "hrnet_w18_small",
                                  "seresnet18", "dla34"])
def test_freeze_mask_follows_jax_s_rule(name):
    """With ``pre_trained`` and ``freeze_layers`` 2, a backbone parameter
    trains only under a top-level module named like layer3/layer4 (SENet's
    and HRNet's), as JAX's mask has it: EfficientNet, DenseNet and DLA
    freeze whole."""
    model = meta_model(name, num_classes=0)
    names = ["backbone." + k for k, _ in model.named_parameters()]
    labels = make_freeze_labels(names, 2, True)
    sd = {k[len("backbone."):]: np.broadcast_to(np.float32(0), tuple(p.shape))
          for k, p in zip(names, model.parameters())}
    tree = {"backbone": torch_state_dict_to_variables(sd)["params"]}
    want = jax_make_freeze_labels(tree, 2, True)
    want_counts = {lab: sum(1 for v in jax.tree_util.tree_leaves(want) if v == lab)
                   for lab in ("trainable", "frozen")}
    got_counts = {lab: sum(1 for v in labels.values() if v == lab)
                  for lab in ("trainable", "frozen")}
    # EvoNorm/BatchNorm leaves map one to one; the counts match leaf for leaf
    assert got_counts == want_counts


@pytest.mark.parametrize("module", ["efficientnet", "densenet", "dla", "vovnet", "regnet",
                                    "hrnet", "senet", "extra_layers"])
def test_public_names_match_jax(module):
    """Each family module exports the JAX module's public names that JAX
    defines (its ``extra_layers.__all__`` also lists a ``split_batch_norm``
    it never defines; ``SplitBatchNorm`` is the class)."""
    import importlib

    jmod = importlib.import_module(f"scouter_tpu.models.{module}")
    tmod = importlib.import_module(f"scouter_tpu_torch.models.{module}")
    for name in jmod.__all__:
        if hasattr(jmod, name):
            assert name in tmod.__all__ and hasattr(tmod, name), (module, name)
