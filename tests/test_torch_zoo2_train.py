"""The second backbone slice's models run against the JAX package on the
CPU: a pruned EfficientNet at its real depth, the init of the new module
kinds (CondConv experts, mixed convs, EvoNorm, depthwise convs), slot
models on an EfficientNet and a DenseNet backbone through a train step
against JAX's step and ``jax.grad``, and the pretrained-weight load by an
EfficientNet family's layout."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.models import SlotModel as JaxSlotModel
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models import densenet as jax_densenet
from scouter_tpu.models import efficientnet as jax_eff
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.models import SlotModel, create_model, init_weights
from scouter_tpu_torch.models import densenet, efficientnet as eff, variables_to_state_dict
from scouter_tpu_torch.train import create_train_state, make_train_step
from test_torch_models import FEATURE_TOL, flat, nhwc, perturb
from test_torch_zoo import nchw_to_nhwc
from test_torch_models import port_variables
from test_torch_zoo2_registry import jax_feature_width
from test_torch_zoo_registry import jax_f64_grads


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


# ----------------------------------------------------- a pruned model, run

def test_efficientnet_b2_pruned_at_its_real_depth():
    jmodel = jax_create_model("efficientnet_b2_pruned", num_classes=7)
    model = create_model("efficientnet_b2_pruned", num_classes=7)
    variables = port_variables(model, 5)
    x = np.random.RandomState(4).randn(2, 48, 48, 3).astype(np.float32)
    feats_j, logits_j = jax.jit(
        lambda v, x: (jmodel.apply(v, x, features_only=True), jmodel.apply(v, x)))(variables, x)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    model.eval()
    with torch.no_grad():
        feats, logits = model(nhwc(x), features_only=True), model(nhwc(x))
    assert model.num_features == feats_j.shape[-1] == jax_feature_width(jmodel)
    # the table narrows convs below their unpruned widths, and the skips
    # and SE reductions keep following the unpruned ones
    assert model.blocks[1][0].conv_pwl.out_channels < eff.round_channels(24, 1.1)
    np.testing.assert_allclose(nchw_to_nhwc(feats), np.asarray(feats_j), **FEATURE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)


# ------------------------------------------------- fresh models: tree and init

def _small_condconv_mixed(pkg):
    return pkg.EfficientNet(
        arch=pkg.decode_arch_def((("ds_r1_k3.5_s1_e1_c16",),
                                  ("ir_r2_k3_s2_e6_c24_se0.25_cc4",))),
        stem_size=16, num_features=64, act="swish", num_classes=5)


INIT_CASES = {
    "condconv_mixed": (lambda: _small_condconv_mixed(jax_eff),
                       lambda: _small_condconv_mixed(eff)),
    "vovnet_evos_dw": (lambda: jax_create_model("ese_vovnet19b_slim_dw", num_classes=5,
                                                norm="evos"),
                       lambda: create_model("ese_vovnet19b_slim_dw", num_classes=5,
                                            norm="evos")),
}


def _kind(key):
    """A parameter path with its indices dropped: the leaves that share an
    init distribution."""
    return "/".join(re.sub(r"_\d+", "", p) for p in re.findall(r"\['([^']*)'\]", key))


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_fresh_port_model_has_the_jax_tree_and_init(case):
    """The same distribution per kind of leaf: pooled standard deviations
    within 12%, every CondConv expert inside its own kaiming-uniform bound,
    EvoNorm at ones, zeros and ones, zero biases."""
    jctor, tctor = INIT_CASES[case]
    model = tctor()
    init_weights(model, torch.Generator().manual_seed(0))
    got = flat(torch_state_dict_to_variables(model.state_dict()))
    want = flat(jax.device_get(jax.jit(jctor().init)(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    kinds = {}
    for k in want:
        if "kernel" in k:
            kinds.setdefault(_kind(k), []).append(k)
    for kind, keys in kinds.items():
        g = np.concatenate([got[k].ravel() for k in keys])
        w = np.concatenate([want[k].ravel() for k in keys])
        if w.size >= 200:
            assert 0.88 < g.std() / w.std() < 1.12, (kind, g.std(), w.std())
    for k in got:
        if ("conv_pw" in k or "conv_dw" in k or "conv_pwl" in k) and got[k].ndim == 2:
            # a CondConv kernel: each expert within 1 / sqrt(its own fan-in)
            bound = np.abs(want[k]).max(axis=0)
            assert (np.abs(got[k]).max(axis=0) <= bound * 1.05).all(), k
            assert (np.abs(got[k]).max(axis=0) >= bound * 0.9).all(), k
        if k.endswith("['v']") or (k.endswith("['scale']") and "bn" in k):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if _kind(k).endswith("bias") and "classifier" not in k and "routing" not in k:
            assert not got[k].any(), k


# ------------------------------ slot models on an EfficientNet and a DenseNet

def _slot(backbone, slot_cls, fused_slot):
    """JAX's slot head on its jnp path, the port's through K1's plain version."""
    return slot_cls(backbone=backbone, use_slot=True, num_classes=3, hidden_dim=16,
                    slots_per_class=2, loss_status=1.0, power=2.0, to_k_layer=2,
                    lambda_value=1.0, fused_slot=fused_slot)


SLOT_BACKBONES = {
    "efficientnet": lambda pkg: pkg.EfficientNet(
        arch=pkg.decode_arch_def((("ds_r1_k3_s1_e1_c16_se0.25",),
                                  ("ir_r2_k3_s2_e3_c24_se0.25",))),
        stem_size=16, num_features=32, act="swish", num_classes=0),
    "densenet": lambda pkg: pkg.DenseNet(growth_rate=8, block_config=(2, 2), bn_size=2,
                                         num_classes=0),
}


@pytest.mark.parametrize("family", sorted(SLOT_BACKBONES))
def test_slot_model_train_step_matches_jax(family):
    """One train step of a slot model on a small backbone of the family, its
    loss and metrics against JAX's step, and the gradients it leaves before
    the update against ``jax.grad`` in float64 within 1e-3 x max|g|."""
    jpkg = {"efficientnet": jax_eff, "densenet": jax_densenet}[family]
    tpkg = {"efficientnet": eff, "densenet": densenet}[family]
    jmodel = _slot(SLOT_BACKBONES[family](jpkg), JaxSlotModel, False)
    model = _slot(SLOT_BACKBONES[family](tpkg), SlotModel, True)
    init_weights(model, torch.Generator().manual_seed(1))
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    variables = perturb(torch_state_dict_to_variables(sd), seed=9)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    lr = 1e-4
    jstate, tx = jax_create_train_state(variables, lr)
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    state = create_train_state(model, lr)
    rng = np.random.RandomState(11)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 3, 4)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    state, m = make_train_step(1.0)(state, {"image": nhwc(x), "label": torch.from_numpy(y)})
    for k in ("loss", "log_loss", "att_loss", "acc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3, atol=1e-6)
    names = model.state_dict()
    want = jax_f64_grads(jmodel, variables, x, y, names)
    jax_f32 = jax_grads(jmodel, variables, x, y, names)
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.grad is not None}
    assert set(grads) == set(want) and any(k.startswith("slot.") for k in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        # the bias of a BatchNorm whose output reaches only a conv and a
        # train-mode BatchNorm (an EfficientNet block's last) has a gradient
        # of zero in exact arithmetic; f32 leaves rounding there, which
        # JAX's own f32 gradient shows too
        floor = 2 * np.abs(jax_f32[name].numpy() - w).max()
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=max(1e-3 * np.abs(w).max(), floor), err_msg=name)


def jax_grads(jmodel, variables, x, y, names):
    """``jax.grad`` of the JAX train step's loss in f32, as a state dict."""
    from scouter_tpu.ops.losses import scouter_loss

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, train=True, mutable=["batch_stats"])
        return scouter_loss(out["logits"], y, out.get("area_loss"), 1.0)[1]["loss"]

    return variables_to_state_dict({"params": jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))}, names)


# ------------------------------------------- the pretrained load by layout

def test_efficientnet_pretrained_head_loads_by_its_layout(tmp_path, monkeypatch):
    """A 1001-class checkpoint of a no-slot EfficientNet: the Trainer keeps
    the classifier's rows 1..1000 and every other tensor, as the JAX
    package's layout for the family gives them."""
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import ArrayDataset
    from scouter_tpu_torch.train import Trainer

    torch.manual_seed(14)
    ckpt = create_model("tf_mobilenetv3_small_minimal_100", num_classes=1001).state_dict()
    torch.save(ckpt, tmp_path / "tf_mobilenetv3_small_minimal_100.pth")
    monkeypatch.setenv("SCOUTER_TPU_PRETRAINED_DIR", str(tmp_path))
    images = np.random.RandomState(15).randint(0, 256, (4, 32, 32, 3), np.uint8)
    cfg = ScouterConfig(model="tf_mobilenetv3_small_minimal_100", dataset="ImageNet",
                        num_classes=1000, channel=576, img_size=32, batch_size=2,
                        use_slot=False, pre_trained=True, freeze_layers=0, device="cpu")
    trainer = Trainer(cfg, datasets=(ArrayDataset(images, np.arange(4) % 3, "ImageNet"),) * 2)
    trainer.maybe_load_pretrained()
    got = trainer.model.backbone.state_dict()
    torch.testing.assert_close(got["classifier.weight"], ckpt["classifier.weight"][1:])
    torch.testing.assert_close(got["classifier.bias"], ckpt["classifier.bias"][1:])
    torch.testing.assert_close(got["conv_stem.weight"], ckpt["conv_stem.weight"])
