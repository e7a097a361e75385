"""The port's bf16 training (``--compute_dtype bfloat16``) against the JAX
package on the CPU: convs, BatchNorms and the classifier compute in bf16
from f32 master parameters, BatchNorm takes its statistics in f32, the slot
head and the loss stay f32, AdamW's state is f32, and a bf16 run's
checkpoint restores to the inference models. The JAX side is
``scouter_tpu``'s bf16 build (flax ``dtype=bfloat16`` over f32 parameters),
fed the same variables through ``variables_to_state_dict`` and the same
batches, made from a seed with numpy."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_eval_step as jax_make_eval_step
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig, check_training_supported
from scouter_tpu_torch.core.checkpoint import save_checkpoint
from scouter_tpu_torch.data import ArrayDataset, synthetic_mnist
from scouter_tpu_torch.models import build_slot_model, layers, variables_to_state_dict
from scouter_tpu_torch.train import (Trainer, create_train_state, make_eval_step,
                                     make_train_step, restore_inference_state)

# tests/test_train.py:139-150: a bf16 loss within 0.08 x max(1, |f32 loss|)
BF16_BAR = 0.08
STEP_CFG = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                slots_per_class=2, to_k_layer=2, power=2, lambda_value=1.0, img_size=64,
                batch_size=4, hidden_dim=64, pre_trained=False, freeze_layers=0)
SIZE = STEP_CFG["img_size"]


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def within_bar(got, want):
    return abs(got - want) <= BF16_BAR * max(1.0, abs(want))


@functools.lru_cache(maxsize=None)
def jax_bf16_model():
    """The JAX SlotModel of STEP_CFG in bf16 compute and f32 variables from
    PRNGKey(0) (the init is the same with any compute dtype)."""
    jmodel = jax_build_slot_model(JaxConfig(**STEP_CFG, compute_dtype="bfloat16"),
                                  dtype=jnp.bfloat16)
    x = np.zeros((1, SIZE, SIZE, 1), np.float32)
    return jmodel, jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x))


def batches(seed, n, b=4, classes=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, SIZE, SIZE, 1).astype(np.float32), rng.randint(0, classes, b))
            for _ in range(n)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def port_state(variables, lr, compute_dtype=torch.bfloat16):
    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu",
                             compute_dtype=compute_dtype)
    model.load_state_dict(variables_to_state_dict(variables))
    return create_train_state(model, lr)


def assert_state_f32(state):
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert buf.dtype == torch.float32, name
    for s in state.optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            assert s[key].dtype == torch.float32


# -------------------------------------------------------------------- layers

def test_conv_and_linear_cast_to_the_compute_dtype_at_use():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
    conv = layers.conv2d(3, 5, 3, bias=True, compute_dtype=torch.bfloat16)
    lin = layers.Linear(3, 4, compute_dtype=torch.bfloat16)
    y, z = conv(x), lin(x.mean(dim=(2, 3)))
    assert y.dtype == z.dtype == torch.bfloat16
    assert conv.weight.dtype == lin.weight.dtype == torch.float32
    want = torch.nn.functional.conv2d(x.bfloat16(), conv.weight.bfloat16(),
                                      conv.bias.bfloat16(), padding=1)
    assert torch.equal(y, want)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_in_bf16_matches_flax(train):
    import flax.linen as nn

    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    bn = layers.batch_norm(5, compute_dtype=torch.bfloat16).train(train)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.randn(5).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 5).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.randn(5).astype(np.float32)))
    jbn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.asarray(bn.running_mean.numpy()),
                                 "var": jnp.asarray(bn.running_var.numpy())}}
    xj = jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    yj, mutated = jbn.apply(variables, xj, mutable=["batch_stats"])
    y = bn(xb)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.detach().float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(yj.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    # statistics in f32, kept in f32
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    stats = mutated.get("batch_stats", variables["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- train step

def test_two_bf16_train_steps_match_jax():
    jmodel, variables = jax_bf16_model()
    lr = 1e-3
    jstate, tx = jax_create_train_state(variables, lr)
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    state = port_state(variables, lr)
    step = make_train_step(1.0)
    for x, y in batches(1, 2):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        state, m = step(state, {"image": nchw(x), "label": torch.from_numpy(y)})
        for k in ("loss", "log_loss", "att_loss"):
            assert m[k].dtype == torch.float32
            assert within_bar(m[k].item(), float(jm[k])), (k, m[k].item(), float(jm[k]))
    assert state.step == 2
    assert_state_f32(state)
    # the running stats moved as JAX's, in f32, to the same bf16 bar
    stats = variables_to_state_dict({"batch_stats": jax.device_get(jstate.batch_stats)})
    got = state.model.state_dict()
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            err = (got[name] - want).abs().max().item()
            assert err <= BF16_BAR * max(1.0, want.abs().max().item()), (name, err)


def test_bf16_eval_loss_is_close_to_f32_and_to_jax():
    jmodel, variables = jax_bf16_model()
    jstate, _ = jax_create_train_state(variables, 1e-4)
    (x, y), = batches(3, 1)
    mask = np.array([1, 1, 1, 0], np.float32)
    want = jax_make_eval_step(jmodel, 1.0)(
        jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y), "mask": jnp.asarray(mask)})
    batch = {"image": nchw(x), "label": torch.from_numpy(y), "mask": torch.from_numpy(mask)}
    got16 = make_eval_step(1.0)(port_state(variables, 1e-4), batch)
    got32 = make_eval_step(1.0)(port_state(variables, 1e-4, compute_dtype=None), batch)
    assert within_bar(got16["loss"].item(), got32["loss"].item())
    assert within_bar(got16["loss"].item(), float(want["loss"]))


def tiny_trainer(tmp_path=None, **kw):
    (tr_x, tr_y), (te_x, te_y) = synthetic_mnist(num_train=64, num_test=32)
    cfg = ScouterConfig(**{**STEP_CFG, "num_classes": 10, "batch_size": 8, "lr": 1e-3,
                           "device": "cpu", "compute_dtype": "bfloat16",
                           "output_dir": str(tmp_path) if tmp_path else "", **kw})
    return Trainer(cfg, datasets=(ArrayDataset(tr_x, tr_y, "MNIST"),
                                  ArrayDataset(te_x, te_y, "MNIST")))


def test_bf16_trainer_loss_falls_and_state_stays_f32():
    # tests/test_train.py:90-107
    trainer = tiny_trainer()
    assert isinstance(trainer.model.backbone.conv1, layers.Conv2d)
    assert trainer.model.backbone.conv1.compute_dtype == torch.bfloat16
    assert_state_f32(trainer.state)
    losses = []
    for epoch in range(2):
        m = trainer.run_epoch(epoch, "train")
        assert np.isfinite(m["loss"])
        losses.append(m["loss"])
    assert losses[-1] < losses[0], losses
    assert_state_f32(trainer.state)
    assert np.isfinite(trainer.run_epoch(0, "val")["loss"])


def test_bf16_checkpoint_restores_for_inference(tmp_path):
    trainer = tiny_trainer(tmp_path)
    trainer.run_epoch(0, "train")
    save_checkpoint(str(tmp_path), trainer.cfg, trainer.state, epoch=0)
    model, _, path = restore_inference_state(trainer.cfg, require=True, device="cpu")
    assert path is not None
    trained = trainer.model.state_dict()
    for k, v in model.state_dict().items():
        assert v.dtype == trained[k].dtype and torch.equal(v, trained[k]), k
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 1, SIZE, SIZE).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out["logits"].shape == (2, 10) and torch.isfinite(out["logits"]).all()


def test_bf16_training_refuses_a_bf16_slot_head():
    """No longer refused: a bf16 slot head trains. The config passes, the
    Trainer builds the head in bf16 compute over f32 parameters, and one
    train step leaves the parameters and AdamW's state f32."""
    check_training_supported(ScouterConfig(device="cpu", compute_dtype="bfloat16"))
    check_training_supported(ScouterConfig(device="cpu", compute_dtype="bfloat16",
                                           slot_head_dtype="compute"))
    trainer = tiny_trainer(slot_head_dtype="compute")
    assert trainer.model.head_dtype == torch.bfloat16
    assert trainer.model.slot.compute_dtype == torch.bfloat16
    (x, y), = batches(6, 1)
    state, m = trainer.train_step(trainer.state, {"image": nchw(x), "label": torch.from_numpy(y)})
    assert np.isfinite(m["loss"].item())
    assert_state_f32(state)
