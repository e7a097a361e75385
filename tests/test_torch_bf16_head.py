"""A bf16 slot head in training (``--compute_dtype bfloat16 --slot_head_dtype
compute``) on the CPU, against the JAX package.

K1 on bf16 inputs: JAX's fused op with hist cannot take them
(``slot_pallas.py:58`` stores bf16 slots into its f32 hist), and JAX's
``Trainer`` builds ``fused_slot=False``, so JAX's bf16 head runs
``slot_pallas.xslot_iterations_ref`` in bf16 arithmetic. The port loads bf16
exactly and computes in f32, so its gradient must lie no further from the
float64 gradient of the same bf16 inputs than JAX's does, and near JAX's.
Then two bf16-head train steps against JAX's bf16 train step (0.08 relative,
tests/test_train.py:139-150), a tiny trainer whose loss falls with f32
state, and a bf16-head checkpoint restored for inference. Inputs are made
with numpy from a seed; weights reach the port through
``variables_to_state_dict``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.ops.slot_pallas import xslot_iterations_ref as jax_xslot_ref
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.checkpoint import save_checkpoint
from scouter_tpu_torch.data import ArrayDataset, synthetic_mnist
from scouter_tpu_torch.models import build_slot_model, variables_to_state_dict
from scouter_tpu_torch.ops.slot_kernel import xslot_iterations_fused, xslot_iterations_ref
from scouter_tpu_torch.train import (Trainer, create_train_state, make_train_step,
                                     restore_inference_state)

BF16_BAR = 0.08  # tests/test_train.py:139-150
STEP_CFG = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                slots_per_class=2, to_k_layer=2, power=2, lambda_value=1.0, img_size=64,
                batch_size=4, hidden_dim=64, pre_trained=False, freeze_layers=0,
                compute_dtype="bfloat16", slot_head_dtype="compute")
SIZE = STEP_CFG["img_size"]
NAMES = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def within_bar(got, want):
    return abs(got - want) <= BF16_BAR * max(1.0, abs(want))


# ----------------------------------------------------------------- K1 in bf16

def k1_inputs(seed, b, n, s, d, magnitudes="bench"):
    """``bench.py:67-74``'s magnitudes (trained-net scale) or
    tests/test_slot_pallas.py's, rounded to bf16, and the cotangents of (upd,
    attn)."""
    rng = np.random.RandomState(seed)
    shapes = ((b, n, d), (b, n, d), (s, d), (3 * d, d), (3 * d, d), (1, 3 * d), (1, 3 * d))
    if magnitudes == "tests":
        scales = (1.0, 1.0, 1.0, 0.2, 0.2, 0.1, 0.1)
    else:
        scales = (0.1, 0.1, 0.02, 0.05, 0.05, 0.05, 0.05)
    args = [torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32)).to(torch.bfloat16)
            for sh, sc in zip(shapes, scales)]
    cot = (rng.randn(b, s, d).astype(np.float32), rng.randn(b, s, n).astype(np.float32))
    return args, cot


def port_grads(args, cot, dtype=None):
    leaves = [(a if dtype is None else a.to(dtype)).clone().requires_grad_() for a in args]
    fn = xslot_iterations_fused if dtype is None else xslot_iterations_ref
    upd, attn = fn(*leaves)
    cots = tuple(torch.from_numpy(c).to(upd.dtype) for c in cot)
    return (upd, attn), torch.autograd.grad((upd, attn), leaves, cots)


def jax_and_port(args, cot):
    """JAX's bf16 forward and vjp through ``xslot_iterations_ref``, the
    port's op on the same bf16 inputs, and the port's plain version in
    float64 on them: ((upd, attn), grads) each."""
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in args]
    jout, vjp = jax.vjp(lambda *a: jax_xslot_ref(*a, iters=3), *jargs)
    jgrads = vjp(tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in cot))
    return (jout, jgrads), port_grads(args, cot), port_grads(args, cot, torch.float64)


@pytest.mark.parametrize("b,n,s,d,seed", [(2, 49, 10, 32, 0), (2, 16, 6, 16, 1)])
def test_bf16_k1_forward_and_gradient_against_jax(b, n, s, d, seed):
    args, cot = k1_inputs(seed, b, n, s, d)
    ((upd_j, attn_j), jgrads), ((upd, attn), grads), ((upd64, attn64), grads64) = \
        jax_and_port(args, cot)
    # forward: f32 outputs, as close to float64 as JAX's bf16 ones at least
    assert upd.dtype == attn.dtype == torch.float32
    for got, jgot, exact in ((upd, upd_j, upd64), (attn, attn_j, attn64)):
        e_port = (got.double() - exact).abs().max().item()
        e_jax = np.abs(np.asarray(jgot.astype(jnp.float32), np.float64)
                       - exact.detach().numpy()).max()
        assert e_port <= e_jax, (e_port, e_jax)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jgot.astype(jnp.float32)),
                                   rtol=3e-2, atol=3e-2)  # serve/cli.py:80-81's bf16 bar
    # gradient: bf16, no further from float64 than JAX's, near JAX's
    for name, g, jg, g64 in zip(NAMES, grads, jgrads, grads64):
        assert g.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16, name
        jg = np.asarray(jg.astype(jnp.float32), np.float64)
        scale = max(1.0, g64.abs().max().item())
        e_port = (g.double() - g64).abs().max().item()
        e_jax = np.abs(jg - g64.numpy()).max()
        assert e_port <= e_jax, (name, e_port, e_jax)
        assert np.abs(g.double().numpy() - jg).max() <= 0.1 * scale, name


def test_bf16_k1_gradient_closer_to_float64_than_jax_at_test_magnitudes():
    """At tests/test_slot_pallas.py's magnitudes JAX's bf16 gradient lies up
    to ~0.2 x max|g| from float64 (bf16 arithmetic through a renorm with no
    epsilon), so the gap to it says little; the port's stays within 1e-2."""
    args, cot = k1_inputs(0, 2, 49, 10, 32, magnitudes="tests")
    (_, jgrads), (_, grads), (_, grads64) = jax_and_port(args, cot)
    for name, g, jg, g64 in zip(NAMES, grads, jgrads, grads64):
        jg = np.asarray(jg.astype(jnp.float32), np.float64)
        e_port = (g.double() - g64).abs().max().item()
        assert e_port <= np.abs(jg - g64.numpy()).max(), name
        assert e_port <= 1e-2 * max(1.0, g64.abs().max().item()), (name, e_port)


# ----------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def jax_bf16_head_model():
    """JAX's SlotModel of STEP_CFG (bf16 compute, bf16 slot head) and f32
    variables from PRNGKey(0)."""
    jmodel = jax_build_slot_model(JaxConfig(**STEP_CFG), dtype=jnp.bfloat16)
    x = np.zeros((1, SIZE, SIZE, 1), np.float32)
    return jmodel, jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x))


def batches(seed, n, b=4, classes=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, SIZE, SIZE, 1).astype(np.float32), rng.randint(0, classes, b))
            for _ in range(n)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_state_f32(state):
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
    for name, buf in state.model.named_buffers():
        if buf.is_floating_point():
            assert buf.dtype == torch.float32, name
    moments = [s[k] for s in state.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")]
    assert all(m.dtype == torch.float32 for m in moments)


def test_two_bf16_head_train_steps_match_jax():
    jmodel, variables = jax_bf16_head_model()
    lr = 1e-3
    jstate, tx = jax_create_train_state(variables, lr)
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu",
                             compute_dtype=torch.bfloat16)
    model.load_state_dict(variables_to_state_dict(variables))
    assert model.slot.compute_dtype == torch.bfloat16
    state, step = create_train_state(model, lr), make_train_step(1.0)
    for x, y in batches(1, 2):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        state, m = step(state, {"image": nchw(x), "label": torch.from_numpy(y)})
        for k in ("loss", "log_loss", "att_loss"):
            assert m[k].dtype == torch.float32
            assert within_bar(m[k].item(), float(jm[k])), (k, m[k].item(), float(jm[k]))
    assert_state_f32(state)
    # the slot head's parameters moved as JAX's did, to the same bar
    want = variables_to_state_dict({"params": jax.device_get(jstate.params)})
    got = state.model.state_dict()
    for name in ("slot.initial_slots", "slot.gru.weight_ih_l0", "conv1x1.weight"):
        err = (got[name] - want[name]).abs().max().item()
        assert err <= BF16_BAR * max(1.0, want[name].abs().max().item()), (name, err)


def tiny_trainer(tmp_path=None):
    (tr_x, tr_y), (te_x, te_y) = synthetic_mnist(num_train=64, num_test=32)
    cfg = ScouterConfig(**{**STEP_CFG, "num_classes": 10, "batch_size": 8, "lr": 1e-3,
                           "device": "cpu", "output_dir": str(tmp_path) if tmp_path else ""})
    return Trainer(cfg, datasets=(ArrayDataset(tr_x, tr_y, "MNIST"),
                                  ArrayDataset(te_x, te_y, "MNIST")))


def test_bf16_head_trainer_loss_falls_and_restores_for_inference(tmp_path):
    trainer = tiny_trainer(tmp_path)
    assert trainer.model.head_dtype == torch.bfloat16
    losses = [trainer.run_epoch(epoch, "train")["loss"] for epoch in range(2)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert_state_f32(trainer.state)
    save_checkpoint(str(tmp_path), trainer.cfg, trainer.state, epoch=1)
    model, _, path = restore_inference_state(trainer.cfg, require=True, device="cpu")
    assert path is not None
    trained = trainer.model.state_dict()
    for k, v in model.state_dict().items():
        assert (v.dtype == torch.float32 or not v.is_floating_point()), k
        assert torch.equal(v, trained[k]), k
    # served with the bf16 head: a cast at use equals the trained model's forward
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 1, SIZE, SIZE).astype(np.float32))
    served = build_slot_model(trainer.cfg, fused_slot=True, device="cpu",
                              compute_dtype=torch.bfloat16)
    served.load_state_dict(model.state_dict())
    trainer.model.eval()
    with torch.no_grad():
        out, want = served(x), trainer.model(x)
    assert torch.isfinite(out["logits"]).all() and out["logits"].shape == (2, 10)
    assert torch.equal(out["logits"], want["logits"])
