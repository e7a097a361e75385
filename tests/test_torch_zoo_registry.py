"""The port's ResNet-family registry against the JAX zoo on the CPU: the
port's registry against JAX's (the other families' entrypoints are held in
``test_torch_zoo2_registry.py``), the 92 names, each entrypoint built on
the meta device, the parameter trees of one
representative per option against ``jax.eval_shape`` of the JAX model (all
92 in a ``slow`` test), a pruned model at its real depth, the init of the
new modules, a slot model on a bottleneck backbone through a train step,
the JAX public names the port adds, and the pretrained-weight load.

Heavy entrypoints (ig_resnext101_32x48d, resnest269e, gluon_senet154) are
only built on ``torch.device("meta")`` here, never run."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from scouter_tpu.models.resnet import ResNet as JaxResNet
from scouter_tpu.ops.losses import scouter_loss as jax_scouter_loss
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.models import build_slot_model, create_model, layers, list_models
from scouter_tpu_torch.models import variables_to_state_dict
from scouter_tpu_torch.models.resnet import ResNet
from scouter_tpu_torch.train import create_train_state, make_train_step
from test_torch_models import FEATURE_TOL, flat, nhwc, perturb, port_variables
from test_torch_zoo import (EXTRA_MECHANISMS, _DEEP_D, check_eval, check_train,
                            mechanism_case, nchw_to_nhwc)

JAX_ZOO = sorted(n for n, fn in JAX_REGISTRY.items() if fn.__module__ == "scouter_tpu.models.zoo")


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- the registry

# the JAX registry's entrypoints the port has still to come: none since the
# last ten families (test_torch_zoo3_registry.py)
STILL_TO_PORT = ()


def test_the_port_registers_the_jax_zoo():
    """The JAX registry, all 297 entrypoints; the 92 of the ResNet zoo among
    them."""
    assert not STILL_TO_PORT
    assert list_models() == sorted(set(JAX_REGISTRY) - set(STILL_TO_PORT))
    assert len(list_models()) == 297 and set(JAX_ZOO) <= set(list_models())
    assert len(JAX_ZOO) == 92


def meta_model(name, **kw):
    with torch.device("meta"):
        return create_model(name, **kw)


@pytest.mark.parametrize("name", JAX_ZOO)
def test_entrypoint_builds_on_meta_with_the_jax_feature_width(name):
    """``num_features`` is the width of the features: JAX's
    ``num_features`` (512 x expansion), except where a pruned table narrows
    layer4's conv3, which JAX's property does not see."""
    model = meta_model(name, num_classes=10)
    jmodel = jax_create_model(name, num_classes=10)
    want = jmodel.num_features
    if jmodel.widths:
        want = dict(jmodel.widths)[f"layer4.{jmodel.layers[3] - 1}.conv3"]
    assert model.num_features == want
    assert model.fc.weight.shape == (10, model.num_features)
    assert model.block == jmodel.block


def port_tree_shapes(model):
    """The port's state dict as the JAX package's converter lays it out,
    shapes only (zero-stride arrays: nothing is allocated)."""
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in model.state_dict().items()}
    return {k: v.shape for k, v in flat(torch_state_dict_to_variables(sd)).items()}


def jax_tree_shapes(jmodel, size=64):
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    return {k: tuple(v.shape)
            for k, v in flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x))}


def flat_shapes(tree):
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# one entrypoint per option of the zoo, and the backbone options on top
REPRESENTATIVES = [
    ("resnet34", {}),
    ("resnet50", {}),
    ("resnext50_32x4d", {}),
    ("seresnext26d_32x4d", {}),
    ("seresnext26t_32x4d", {}),
    ("seresnext26tn_32x4d", {}),
    ("ecaresnet18", {}),
    ("ecaresnet50d_pruned", {}),
    ("gluon_senet154", {}),
    ("res2net50_26w_4s", {}),
    ("res2next50", {}),
    ("skresnet18", {}),
    ("skresnext50_32x4d", {}),
    ("resnetblur50", {}),
    ("resnest50d_4s2x40d", {}),
    ("resnet50", {"output_stride": 8}),
    ("resnest26d", {"output_stride": 16}),
    ("resnet18", {"s2d_stem": True}),
]


@pytest.mark.parametrize("name,kw", REPRESENTATIVES,
                         ids=[n + "".join(f"-{k}" for k in kw) for n, kw in REPRESENTATIVES])
def test_representative_has_the_jax_parameter_tree(name, kw):
    assert port_tree_shapes(meta_model(name, **kw)) == jax_tree_shapes(
        jax_create_model(name, **kw))


@pytest.mark.slow
@pytest.mark.parametrize("name", JAX_ZOO)
def test_every_entrypoint_has_the_jax_parameter_tree(name):
    """All 92 against ``jax.eval_shape``: minutes of tracing for the deep
    ones (resnest269e, gluon_senet154, the 101/152/200-layer nets)."""
    assert port_tree_shapes(meta_model(name)) == jax_tree_shapes(jax_create_model(name))


# ------------------------- the extra mechanism cases (test_torch_zoo.py's)

@pytest.fixture(scope="module", params=EXTRA_MECHANISMS)
def extra_mechanism(request):
    return mechanism_case(request.param)


def test_extra_mechanism_eval_features_and_logits(extra_mechanism):
    check_eval(extra_mechanism)


def test_extra_mechanism_train_logits_and_running_stats(extra_mechanism):
    check_train(extra_mechanism)


# ----------------------------------------------------- a pruned model, run

def test_ecaresnet50d_pruned_at_its_real_depth():
    jmodel = jax_create_model("ecaresnet50d_pruned", num_classes=7)
    model = create_model("ecaresnet50d_pruned", num_classes=7)
    variables = port_variables(model, seed=5)
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    feats_j, logits_j = jax.jit(
        lambda v, x: (jmodel.apply(v, x, features_only=True), jmodel.apply(v, x)))(variables, x)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    model.eval()
    with torch.no_grad():
        feats, logits = model(nhwc(x), features_only=True), model(nhwc(x))
    # the table prunes layer4's conv3 to 2022 channels; ECA keeps the
    # unpruned count, so its kernel follows 2048
    assert model.num_features == feats_j.shape[-1] == 2022
    assert model.layer4[0].se.conv.kernel_size == (layers.eca_kernel_size(2048),)
    np.testing.assert_allclose(nchw_to_nhwc(feats), np.asarray(feats_j), **FEATURE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)



# ------------------------------------------------- fresh models: tree and init

INIT_CASES = {
    "se_eca_bottleneck": dict(block="bottleneck", layers=(1, 1, 2, 1), attn="se",
                              cardinality=8, base_width=4, **_DEEP_D),
    "eca_basic": dict(block="basic", layers=(1, 1, 1, 1), attn="eca"),
    "res2net": dict(block="res2net", layers=(1, 1, 1, 1), base_width=26, scale=4),
    "sk": dict(block="sk_bottleneck", layers=(1, 1, 1, 1), sk_split_input=True),
    "s2d_tiered": dict(block="bottleneck", layers=(1, 1, 1, 1), s2d_stem=True,
                       stem_type="deep_tiered", stem_width=32),
}


def _kind(key):
    """A parameter path with its block and stage indices dropped: the
    leaves that share an init distribution."""
    return "/".join(p for p in re.findall(r"\['([^']*)'\]", key)
                    if not p.startswith(("layer", "conv1_")))


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_fresh_port_model_has_the_jax_tree_and_init(case):
    kw = dict(num_classes=5, **INIT_CASES[case])
    from scouter_tpu_torch.models import init_weights

    model = ResNet(**kw)
    init_weights(model, torch.Generator().manual_seed(0))
    got = flat(torch_state_dict_to_variables(model.state_dict()))
    want = flat(jax.device_get(jax.jit(JaxResNet(**kw).init)(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    # the same distribution per kind of leaf: pooled standard deviations
    # within 12%, truncation at two standard deviations of the underlying
    # normal (2 / 0.8796 of the truncated one's), zero biases
    kinds = {}
    for k in want:
        if "kernel" in k:
            kinds.setdefault(_kind(k), []).append(k)
    for kind, keys in kinds.items():
        g = np.concatenate([got[k].ravel() for k in keys])
        w = np.concatenate([want[k].ravel() for k in keys])
        if w.size >= 200:
            assert 0.88 < g.std() / w.std() < 1.12, (kind, g.std(), w.std())
        for k in keys:
            if got[k].size >= 200:
                assert np.abs(got[k]).max() <= 2.0 / 0.8796 * 1.06 * got[k].std(), k
    for k in got:
        if _kind(k).endswith("bias") and not _kind(k).startswith("fc/"):
            assert not got[k].any(), k


def test_new_gates_skip_the_int8_policy():
    """JAX's policy reaches only convs built by ``layers.conv2d``
    (``scouter_tpu/models/layers.py:75-78``): SE's fc1/fc2 and SK's
    fc_reduce/fc_select are flax ``nn.Conv`` and stay float."""
    from scouter_tpu_torch.serve.quant import quantized_convs

    model = ResNet(block="sk_bottleneck", layers=(1, 1, 1, 1), num_classes=0)
    se = ResNet(block="bottleneck", layers=(1, 1, 1, 1), num_classes=0, attn="se")
    for m in (model, se):
        with quantized_convs("int8", m):
            gates = [mod for name, mod in m.named_modules()
                     if name.endswith(("fc1", "fc2", "fc_reduce", "fc_select"))]
            assert gates and all(g.substitute is None for g in gates)
            pointwise = [mod for name, mod in m.named_modules()
                         if name.endswith(("conv3", "conv3.conv"))
                         and isinstance(mod, torch.nn.Conv2d)]
            assert pointwise and all(p.substitute is not None for p in pointwise)


# ----------------------------------------- a slot model on a bottleneck backbone

SLOT_KW = dict(model="seresnext26d_32x4d", dataset="ImageNet", img_size=64, num_classes=3,
               slots_per_class=2, to_k_layer=2, power=2, loss_status=1, use_slot=True,
               pre_trained=False, channel=2048)


@pytest.fixture(scope="module")
def slot_case():
    jcfg, cfg = JaxConfig(**SLOT_KW), ScouterConfig(**SLOT_KW)
    jmodel = jax_build_slot_model(jcfg)
    variables = perturb(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), np.zeros((1, 64, 64, 3), np.float32)), seed=9)
    return jcfg, cfg, jmodel, variables


def test_bottleneck_slot_model_matches_jax(slot_case):
    jcfg, cfg, jmodel, variables = slot_case
    x = np.random.RandomState(10).randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, x)
    model = build_slot_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    with torch.no_grad():
        got = model(nhwc(x))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **FEATURE_TOL)
    np.testing.assert_allclose(got["area_loss"].numpy(), np.asarray(want["area_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["attn"].numpy(), np.asarray(want["attn"]), rtol=1e-4,
                               atol=1e-5)


def jax_f64_grads(jmodel, variables, x, y, names):
    """jax.grad of the JAX train step's loss (``scouter_tpu.train.steps``'
    ``loss_fn``, lambda 1) in float64, as a state dict (``names``: the
    model's keys, for ``variables_to_state_dict``)."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss(params):
            out, _ = jmodel.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                  x.astype(np.float64), train=True, mutable=["batch_stats"])
            return jax_scouter_loss(out["logits"], y, out.get("area_loss"), 1.0)[1]["loss"]

        grads = jax.device_get(jax.jit(jax.grad(loss))(v64["params"]))
    return variables_to_state_dict({"params": grads}, names)


def test_bottleneck_slot_model_train_step_matches_jax(slot_case):
    """One train step, with the tolerances of
    ``test_torch_train.test_four_train_steps_match_jax``, and the gradients
    the step leaves before the update against jax.grad in float64 within
    1e-3 x max|g| (JAX's own f32 gradients miss that bar in this model's
    backbone, so they are not the reference)."""
    _, cfg, jmodel, variables = slot_case
    lr = 1e-4
    jstate, tx = jax_create_train_state(variables, lr)
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    model = build_slot_model(cfg, fused_slot=True, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    state = create_train_state(model, lr)
    rng = np.random.RandomState(11)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 3, 4)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    state, m = make_train_step(1.0)(state, {"image": nhwc(x), "label": torch.from_numpy(y)})
    for k in ("loss", "log_loss", "att_loss", "acc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3, atol=1e-6)
    want = jax_f64_grads(jmodel, variables, x, y, model.state_dict())
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.grad is not None}
    assert set(grads) == set(want) and any(k.startswith("slot.") for k in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    got = state.model.state_dict()
    stats = variables_to_state_dict({"batch_stats": jax.device_get(jstate.batch_stats)}, got)
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=1e-4,
                                       err_msg=name)
    # AdamW's first update is about lr * sign(g): a gradient near zero whose
    # last bits differ moves a weight by up to 2 lr
    params = variables_to_state_dict({"params": jax.device_get(jstate.params)}, got)
    for name in ("backbone.layer2.0.se.fc1.weight", "backbone.layer1.0.conv2.weight",
                 "conv1x1.weight", "slot.gru.weight_hh_l0"):
        np.testing.assert_allclose(got[name].numpy(), params[name].numpy(), rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=name)


def test_backbone_kwargs_reach_the_backbone():
    cfg = ScouterConfig(**SLOT_KW)
    model = build_slot_model(cfg, device="cpu", backbone_kwargs={"output_stride": 16})
    x = torch.zeros(1, 3, 64, 64)
    with torch.no_grad():
        assert model(x)["attn"].shape == (1, 6, 16)  # 64 px at stride 16: 4 x 4
    # drop_rate: head dropout before fc, in training only
    models = [build_slot_model(cfg.replace(use_slot=False), device="cpu",
                               backbone_kwargs={"drop_rate": rate}) for rate in (0.5, 0.5, 0.0)]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(16))
    outs = []
    with torch.no_grad():
        assert torch.equal(models[0](x)["logits"], models[2](x)["logits"])
        for m in models:
            torch.manual_seed(17)
            outs.append(m.train()(x)["logits"])
    assert torch.equal(outs[0], outs[1]) and not torch.allclose(outs[0], outs[2])


# ---------------------------------------------------- the JAX public names

def test_public_names_match_jax():
    import scouter_tpu.data.native_stager as jax_stager
    import scouter_tpu.models as jax_models
    import scouter_tpu.models.resnet as jax_resnet
    import scouter_tpu.models.slot_model as jax_slot_model
    import scouter_tpu_torch.data.native_stager as stager
    import scouter_tpu_torch.models as models
    import scouter_tpu_torch.models.resnet as resnet
    import scouter_tpu_torch.models.slot_model as slot_model
    from scouter_tpu_torch.ops import gru, slot_attention
    from scouter_tpu_torch.serve import quant

    for mod, names in ((models, ("auto_fused_slot", "SlotModelOutput", "strip_prefix",
                                 "prepare_pretrained_state_dict", "merge_variables")),
                       (slot_model, ("SlotModelOutput",)), (resnet, ("BlockKind", "ResNet")),
                       (stager, ("native_available",)),
                       (quant, ("int8_conv_general_dilated", "int8_conv2d")),
                       (gru, ("init_gru_params",)), (slot_attention, ("init_xslot_params",))):
        for name in names:
            assert name in mod.__all__ and hasattr(mod, name), (mod.__name__, name)
    cfg, jcfg = ScouterConfig(model="resnet50"), JaxConfig(model="resnet50")
    for train in (True, False):
        assert models.auto_fused_slot(cfg, train, 16) == jax_models.auto_fused_slot(
            jcfg, train, 16)
    assert resnet.BlockKind is jax_resnet.BlockKind is str
    assert set(resnet._EXPANSION) == set(jax_resnet._EXPANSION)
    assert resnet._EXPANSION == jax_resnet._EXPANSION
    assert slot_model.SlotModelOutput.__origin__ is jax_slot_model.SlotModelOutput.__origin__
    assert stager.native_available() == jax_stager.native_available()


def test_pretrained_helpers_match_jax():
    from scouter_tpu.models import convert as jax_convert
    from scouter_tpu_torch.models import convert

    rng = np.random.RandomState(12)
    sd = {"conv1.weight": rng.randn(8, 3, 7, 7).astype(np.float32),
          "bn1.weight": rng.randn(8).astype(np.float32),
          "fc.weight": rng.randn(1001, 8).astype(np.float32),
          "fc.bias": rng.randn(1001).astype(np.float32)}
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for kw in (dict(in_chans=1, num_classes=1000, pretrained_classes=1001),
               dict(num_classes=10, pretrained_classes=1001), dict(num_classes=1001,
                                                                    pretrained_classes=1001),
               dict(in_chans=3)):
        want = jax_convert.prepare_pretrained_state_dict(sd, **kw)
        got = convert.prepare_pretrained_state_dict(tsd, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6,
                                       err_msg=k)
    with pytest.raises(ValueError):
        convert.prepare_pretrained_state_dict(tsd, in_chans=2)
    prefixed = {"backbone.conv1.weight": 1, "backbone.fc.bias": 2, "slot.x": 3}
    assert convert.strip_prefix(prefixed) == jax_convert.strip_prefix(prefixed)
    init = {"a": {"kernel": 1, "bias": 2}, "b": {"scale": 3}, "c": 4}
    loaded = {"a": {"kernel": 10}, "c": 40, "extra": 5}
    assert convert.merge_variables(init, loaded) == jax_convert.merge_variables(init, loaded)


def test_int8_conv_general_dilated_matches_jax():
    from scouter_tpu.serve.quant import int8_conv_general_dilated as jax_int8
    from scouter_tpu_torch.serve.quant import int8_conv2d, int8_conv_general_dilated

    rng = np.random.RandomState(13)
    x = rng.randn(2, 7, 5, 24).astype(np.float32)  # NHWC
    w = rng.randn(1, 1, 24, 16).astype(np.float32)  # HWIO
    want = jax_int8(jnp.asarray(x), jnp.asarray(w), (1, 1), "VALID",
                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = int8_conv_general_dilated(nhwc(x), tw, (1, 1), "VALID")
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, int8_conv2d(nhwc(x), tw), rtol=0, atol=0)
    with pytest.raises(ValueError):
        int8_conv_general_dilated(nhwc(x), tw, (1, 1), [(1, 1), (1, 1)])


def test_init_params_follow_the_xslot_init():
    """``init_xslot_params`` and ``init_gru_params`` draw what
    ``init_weights`` puts into a built model, with JAX's shapes and
    distributions."""
    from scouter_tpu.ops.slot_attention import XSlotConfig as JaxXSlotConfig
    from scouter_tpu.ops.slot_attention import init_xslot_params as jax_init_xslot_params
    from scouter_tpu_torch.ops import XSlotConfig, init_gru_params, init_xslot_params

    kw = dict(num_classes=50, slots_per_class=4, dim=64, to_k_layer=3)
    got = init_xslot_params(torch.Generator().manual_seed(3), XSlotConfig(**kw))
    want = jax_init_xslot_params(jax.random.PRNGKey(3), JaxXSlotConfig(**kw))
    assert jax.tree_util.tree_map(np.shape, jax.tree_util.tree_map(np.asarray, {
        k: v for k, v in got.items()})) == jax.tree_util.tree_map(np.shape, want)
    bound = 1 / 8.0
    for layer in got["to_k"]:
        assert float(layer["weight"].abs().max()) <= bound
    gru = init_gru_params(torch.Generator().manual_seed(4), 64)
    assert all(float(v.abs().max()) <= bound for v in gru.values())
    assert abs(float(gru["w_ih"].std()) - bound / 3 ** 0.5) < 0.01
    # the slots share mu and |sigma| per feature: their spread over the slots
    # follows one feature's sigma
    slots = got["initial_slots"][0]
    assert slots.shape == (200, 64) and 0.3 < float(slots.std(0).mean()) < 1.5

    cfg = ScouterConfig(model="resnet10", dataset="MNIST", num_classes=3, slots_per_class=2,
                        to_k_layer=2, img_size=32, seed=5)
    model = build_slot_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    from scouter_tpu_torch.models import init_weights

    fresh = build_slot_model(cfg, device="cpu")
    init_weights(fresh, g)
    for name, t in model.state_dict().items():
        assert torch.equal(t, fresh.state_dict()[name]), name


def test_pretrained_1001_class_head_loads_as_jax_strips_it(tmp_path, monkeypatch):
    """A torch checkpoint with a 1001-row fc (a background class at row 0)
    into a 1000-class no-slot model: the port's Trainer keeps rows 1..1000,
    as the JAX package's ``prepare_pretrained_state_dict`` with the
    checkpoint's class count gives them, on top of ``merge_variables``."""
    from scouter_tpu.models import convert as jax_convert
    from scouter_tpu_torch.data import ArrayDataset
    from scouter_tpu_torch.train import Trainer

    torch.manual_seed(14)
    ckpt = create_model("resnet10", num_classes=1001).state_dict()
    torch.save(ckpt, tmp_path / "resnet10.pth")
    monkeypatch.setenv("SCOUTER_TPU_PRETRAINED_DIR", str(tmp_path))
    images = np.random.RandomState(15).randint(0, 256, (4, 32, 32, 3), np.uint8)
    labels = np.arange(4) % 3
    cfg = ScouterConfig(model="resnet10", dataset="ImageNet", num_classes=1000, channel=512,
                        img_size=32, batch_size=2, use_slot=False, pre_trained=True,
                        freeze_layers=0, device="cpu")
    trainer = Trainer(cfg, datasets=(ArrayDataset(images, labels, "ImageNet"),) * 2)
    fresh = {k: v.clone() for k, v in trainer.model.backbone.state_dict().items()}
    trainer.maybe_load_pretrained()
    got = trainer.model.backbone.state_dict()

    jmodel = jax_create_model("resnet10", num_classes=1000)
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                                       np.float32)))
    sd = jax_convert.prepare_pretrained_state_dict(
        {k: v.numpy() for k, v in ckpt.items()}, num_classes=1000, pretrained_classes=1001)
    loaded = torch_state_dict_to_variables(sd)
    want = variables_to_state_dict({
        "params": jax_convert.merge_variables(init["params"], loaded["params"]),
        "batch_stats": jax_convert.merge_variables(init["batch_stats"],
                                                   loaded["batch_stats"])}, got)
    assert got["fc.weight"].shape == (1000, 512)
    for name in ("fc.weight", "fc.bias", "conv1.weight", "layer4.0.conv2.weight"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)
        assert not torch.equal(got[name], fresh[name]), name
