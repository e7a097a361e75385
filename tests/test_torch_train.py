"""The port's training path against the JAX package on the CPU: K1's hist
output and checkpointed gradient (Pallas in interpret mode), the loss, the
freeze rule, StepLR, train steps from the same weights on the same batches,
the masked eval step, flax-style BatchNorm, checkpoints and the train CLI.
Inputs are made from a seed with numpy and fed to both sides."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.core.config import expand_sweep as jax_expand_sweep
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.ops.losses import scouter_loss as jax_scouter_loss
from scouter_tpu.ops.slot_pallas import _fused_forward as jax_fused_forward
from scouter_tpu.ops.slot_pallas import xslot_iterations_fused as jax_fused
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.state import make_freeze_labels as jax_make_freeze_labels
from scouter_tpu.train.state import step_lr as jax_step_lr
from scouter_tpu.train.steps import make_eval_step as jax_make_eval_step
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig, check_training_supported, expand_sweep
from scouter_tpu_torch.core import get_args_parser
from scouter_tpu_torch.core.checkpoint import (checkpoint_path, restore_checkpoint,
                                               save_checkpoint)
from scouter_tpu_torch.models import build_slot_model, layers, variables_to_state_dict
from scouter_tpu_torch.ops.losses import scouter_loss
from scouter_tpu_torch.ops.slot_kernel import (_XSlotFused, xslot_fwd_ref,
                                               xslot_iterations_fused)
from scouter_tpu_torch.train import (create_train_state, make_eval_step, make_freeze_labels,
                                     make_train_step, step_lr)
from scouter_tpu_torch.train.cli import main as cli_main

TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_slot_pallas.py:48
# 64 px: at 32 px the MNIST-stem resnet10 leaves a 1x1 map, where every slot
# attends alike, the class scores tie and the CE loss is ln(C) whatever the
# weights; a 2x2 map gives the class scores a gradient
STEP_CFG = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                slots_per_class=2, to_k_layer=2, power=2, lambda_value=1.0, img_size=64,
                batch_size=4, hidden_dim=64)
SIZE = STEP_CFG["img_size"]


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def k1_inputs(seed, b, n, s, d=64, magnitudes="tests"):
    """``tests/test_slot_pallas.py`` magnitudes, or ``bench.py:67-74``'s."""
    rng = np.random.RandomState(seed)
    if magnitudes == "tests":
        scales = (1.0, 1.0, 1.0, 0.2, 0.2, 0.1, 0.1)
    else:
        scales = (0.1, 0.1, 0.02, 0.05, 0.05, 0.05, 0.05)
    shapes = ((b, n, d), (b, n, d), (s, d), (3 * d, d), (3 * d, d), (1, 3 * d), (1, 3 * d))
    return [(rng.randn(*sh) * sc).astype(np.float32) for sh, sc in zip(shapes, scales)]


# ------------------------------------------------------------------------ K1

@pytest.mark.parametrize("s", [10, 30])
def test_k1_hist_matches_pallas_interpret(s):
    args = k1_inputs(3, 2, 81, s)
    upd_j, attn_j, hist_j = jax_fused_forward(*[jnp.asarray(a) for a in args], iters=3,
                                              interpret=True, emit_hist=True)
    upd, attn, hist = xslot_fwd_ref(*[torch.from_numpy(a) for a in args], emit_hist=True)
    assert hist.shape == (2, 3, s, 64)
    for got, want in ((hist, hist_j), (upd, upd_j), (attn, attn_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def k1_grads(args, dtype=torch.float32):
    """The port's gradients of sum(upd**2) + sum(attn) for all 7 inputs."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    upd, attn = xslot_iterations_fused(*leaves)
    return [g.numpy() for g in torch.autograd.grad((upd ** 2).sum() + attn.sum(), leaves)]


def jax_k1_grads(args):
    def loss(*a):
        upd, attn = jax_fused(*a, 3, True)
        return jnp.sum(upd ** 2) + jnp.sum(attn)

    grads = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_gradients_match_jax_grad_of_pallas(seed):
    # bench.py:67-74 magnitudes. The renorm has no epsilon: on a draw with a
    # row sum near zero even JAX's f32 gradient leaves this bar of the float64
    # one, and no other f32 summation order can be held to it there; these
    # draws are not such, which the first assertion checks
    args = k1_inputs(seed, 2, 81, 10, magnitudes="bench")
    want, exact = jax_k1_grads(args), k1_grads(args, torch.float64)
    for w, x in zip(want, exact):
        np.testing.assert_allclose(w, x, **TOL)
    for g, w, a in zip(k1_grads(args), want, args):
        assert g.shape == a.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_k1_gradients_match_jax_on_ill_conditioned_inputs():
    # tests/test_slot_pallas.py magnitudes: row sums near zero amplify f32
    # rounding, so the port is held to chip_smoke.py's bar for its gradients,
    # max abs difference <= 1e-4 x max(1, max |reference gradient|)
    args = k1_inputs(1, 2, 81, 10)
    for g, w in zip(k1_grads(args), jax_k1_grads(args)):
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def test_k1_gradients_reach_the_slot_parameters():
    # ops/slot_attention.py passes views: initial_slots[0] of (1, S, d) and
    # b_ih[None] of (3d,); the gradients reach the parameters in their shapes
    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu").train()
    x = np.random.RandomState(0).randn(2, 1, SIZE, SIZE).astype(np.float32)
    out = model(torch.from_numpy(x))
    (out["logits"].sum() + out["area_loss"]).backward()
    assert type(out["attn"].grad_fn) is _XSlotFused._backward_cls
    for p in (model.slot.initial_slots, model.slot.gru.bias_ih_l0, model.slot.gru.weight_hh_l0):
        assert p.grad is not None and p.grad.shape == p.shape
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


# ---------------------------------------------------------------- loss, state

@pytest.mark.parametrize("with_area", [True, False])
def test_scouter_loss(with_area):
    rng = np.random.RandomState(0)
    logits, labels = rng.randn(6, 5).astype(np.float32), rng.randint(0, 5, 6)
    area = np.float32(0.37) if with_area else None
    _, want = jax_scouter_loss(jnp.asarray(logits), jnp.asarray(labels),
                               None if area is None else jnp.asarray(area), 2.0)
    log_probs, got = scouter_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  None if area is None else torch.tensor(area), 2.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert log_probs.dtype == torch.float32


def _label_by_name(labels_tree, params):
    """JAX labels as the port's parameter names: push a 1 (frozen) / 0 leaf of
    each parameter's shape through the weight carrier."""
    flags = jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, lab == "frozen", np.float32), labels_tree, params)
    sd = variables_to_state_dict({"params": flags})
    return {k: "frozen" if bool(v.all()) else "trainable" for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def jax_model():
    """The JAX SlotModel of STEP_CFG and its jitted init (compiled once)."""
    jmodel = jax_build_slot_model(JaxConfig(**STEP_CFG))
    return jmodel, jax.jit(jmodel.init)


def jax_init(seed):
    """The JAX SlotModel of STEP_CFG and its variables from PRNGKey(seed)."""
    jmodel, init = jax_model()
    x = np.zeros((1, SIZE, SIZE, 1), np.float32)
    return jmodel, jax.device_get(init(jax.random.PRNGKey(seed), x))


@pytest.mark.parametrize("freeze_layers", [0, 1, 2, 3])
def test_freeze_labels_match_jax(freeze_layers):
    params = jax_init(0)[1]["params"]
    want = _label_by_name(jax_make_freeze_labels(params, freeze_layers, True), params)
    model = build_slot_model(ScouterConfig(**STEP_CFG), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    got = make_freeze_labels(names, freeze_layers, pre_trained=True)
    assert got == {n: want[n] for n in names}
    assert (sum(v == "frozen" for v in got.values()) > 0) == (freeze_layers > 0)
    assert set(make_freeze_labels(names, freeze_layers, pre_trained=False).values()) == {
        "trainable"}


def test_step_lr():
    for epoch in range(25):
        for lr_drop in (1, 3, 10):
            assert step_lr(1e-4, epoch, lr_drop) == pytest.approx(
                jax_step_lr(1e-4, epoch, lr_drop), rel=1e-12)


def test_optimizer_is_adamw_with_the_reference_defaults():
    cfg = ScouterConfig(model="resnet10", dataset="MNIST", num_classes=3, img_size=32)
    state = create_train_state(build_slot_model(cfg, device="cpu"), 3e-4, freeze_layers=2,
                               pre_trained=True)
    (group,) = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.999), 1e-8, 0.01)
    frozen = {n for n, p in state.model.named_parameters() if not p.requires_grad}
    assert len(group["params"]) == sum(1 for p in state.model.parameters() if p.requires_grad)
    assert frozen and all(n.startswith("backbone.") for n in frozen)


# ------------------------------------------------------------ train and eval


def perturbed_variables(seed):
    """JAX init with numpy noise on BN statistics, scales and biases."""
    jmodel, variables = jax_init(seed)
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, np.float32)
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        if name in ("var", "scale"):
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jmodel, jax.tree_util.tree_map_with_path(leaf, variables)


def batches(seed, n, b=4, classes=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, SIZE, SIZE, 1).astype(np.float32), rng.randint(0, classes, b))
            for _ in range(n)]


def port_state(variables, lr, **kw):
    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables))
    return create_train_state(model, lr, **kw)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("freeze", [dict(), dict(freeze_layers=2, pre_trained=True)],
                         ids=["all_trainable", "freeze_2"])
def test_four_train_steps_match_jax(freeze):
    # the reference's lr; AdamW's first updates are about lr * sign(g), so a
    # gradient near zero that differs in its last bits moves a weight by 2 lr
    # (at 1e-3 that shows in the third step's loss at 4e-3)
    lr = 1e-4
    jmodel, variables = perturbed_variables(0)
    jstate, tx = jax_create_train_state(variables, lr, **freeze)
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    state = port_state(variables, lr, **freeze)
    step = make_train_step(1.0)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for x, y in batches(1, 4):
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        state, m = step(state, {"image": nchw(x), "label": torch.from_numpy(y)})
        for k in ("loss", "log_loss", "att_loss", "acc"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3, atol=1e-6)
    assert state.step == 4
    stats = variables_to_state_dict({"batch_stats": jax.device_get(jstate.batch_stats)})
    got = state.model.state_dict()
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0, atol=1e-4,
                                       err_msg=name)
    frozen = [n for n, p in state.model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == bool(freeze)
    for n in frozen:
        assert torch.equal(state.model.get_parameter(n), before[n]), n


def test_masked_eval_step_matches_jax():
    jmodel, variables = perturbed_variables(2)
    jstate, _ = jax_create_train_state(variables, 1e-4)
    state = port_state(variables, 1e-4)
    (x, y), = batches(3, 1)
    mask = np.array([1, 1, 1, 0], np.float32)
    want = jax_make_eval_step(jmodel, 1.0)(
        jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y), "mask": jnp.asarray(mask)})
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = make_eval_step(1.0)(state, {"image": nchw(x), "label": torch.from_numpy(y),
                                      "mask": torch.from_numpy(mask)})
    for k in ("loss", "log_loss", "att_loss", "acc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-6)
    assert not state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # eval leaves the running stats alone


def test_batch_norm_train_mode_updates_running_stats_as_flax():
    import flax.linen as nn

    x = (np.random.RandomState(0).randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    bn = layers.batch_norm(5).train()
    y = bn(torch.from_numpy(x))
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    yj, mutated = jbn.apply(jbn.init(jax.random.PRNGKey(0), xj), xj, mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)
    eval_out = bn.eval()(torch.from_numpy(x))
    ref = torch.nn.functional.batch_norm(torch.from_numpy(x), bn.running_mean, bn.running_var,
                                         bn.weight, bn.bias, False, 0.0, bn.eps)
    torch.testing.assert_close(eval_out, ref, rtol=0, atol=0)


# ------------------------------------------------------ checkpoint, config, CLI

def test_checkpoint_round_trip(tmp_path):
    cfg = ScouterConfig(**STEP_CFG, lr_drop=3, output_dir=str(tmp_path), device="cpu")
    state = create_train_state(build_slot_model(cfg, fused_slot=True, device="cpu"), 1e-3)
    step = make_train_step(1.0)
    for x, y in batches(5, 2):
        state, _ = step(state, {"image": nchw(x), "label": torch.from_numpy(y)})
    paths = save_checkpoint(str(tmp_path), cfg, state, epoch=2)
    assert [p.split("/")[-1] for p in paths] == ["MNIST_use_slot_checkpoint.pth",
                                                 "MNIST_use_slot_checkpoint0002.pth"]
    assert save_checkpoint(str(tmp_path), cfg, state, epoch=3) == (checkpoint_path(
        str(tmp_path), cfg),)

    fresh = create_train_state(build_slot_model(
        cfg, fused_slot=True, device="cpu", generator=torch.Generator().manual_seed(1)), 1e-3)
    restored, epoch, config = restore_checkpoint(paths[0], fresh)
    assert (epoch, restored.step, config["lr_drop"]) == (3, 2, 3)
    want = state.model.state_dict()
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    opt_a, opt_b = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, s in opt_a["state"].items():
        for k in s:
            assert torch.equal(s[k], opt_b["state"][i][k])
    # the server serves what training wrote
    from scouter_tpu_torch.serve.server import load_state_dict

    served, source = load_state_dict(cfg)
    assert source == paths[0] and served.keys() == want.keys()
    # both continue identically
    (x, y), = batches(7, 1)
    _, m1 = step(state, {"image": nchw(x), "label": torch.from_numpy(y)})
    _, m2 = step(restored, {"image": nchw(x), "label": torch.from_numpy(y)})
    assert m1["loss"].item() == m2["loss"].item()


@pytest.mark.parametrize("argv", [
    ["--lambda_value", "1,3"], ["--num_classes", "2,3", "--power", "2"],
    ["--power", "1,2", "--slots_per_class", "2"],
    ["--slots_per_class", "1"], ["--power", "3"]])
def test_expand_sweep_matches_jax(argv):
    from scouter_tpu.core.config import get_args_parser as jax_parser

    got = [(k, c.lambda_value, c.num_classes, c.power, c.slots_per_class)
           for k, c in expand_sweep(get_args_parser().parse_args(argv))]
    want = [(k, c.lambda_value, c.num_classes, c.power, c.slots_per_class)
            for k, c in jax_expand_sweep(jax_parser().parse_args(argv))]
    assert got == want


@pytest.mark.parametrize("flag,value", [
    ("mesh_shape", (2,)), ("sync_bn", False), ("zero1", True), ("preempt_save", True),
    ("ckpt_async", True), ("compute_dtype", "bfloat16")])
def test_training_refuses_what_is_not_ported(flag, value):
    check_training_supported(ScouterConfig(device="cpu"))
    if flag in ("preempt_save", "ckpt_async"):
        # ported: tests/test_torch_resilience.py
        check_training_supported(ScouterConfig(device="cpu", **{flag: value}))
        return
    if flag == "compute_dtype":
        # ported: bf16 training, also with a slot head that follows it (a bf16
        # K1 gradient; tests/test_torch_bf16_head.py)
        for head in ("float32", "compute"):
            check_training_supported(ScouterConfig(device="cpu", **{flag: value},
                                                   slot_head_dtype=head))
        return
    with pytest.raises(NotImplementedError, match=flag):
        check_training_supported(ScouterConfig(device="cpu", **{flag: value}))


def test_cli_sweep_trains_on_the_cpu(tmp_path, capsys):
    record = cli_main(["--device", "cpu", "--dataset", "MNIST", "--model", "resnet10",
                       "--num_classes", "3", "--img_size", "32", "--batch_size", "128",
                       "--epochs", "1", "--pre_trained", "false", "--lambda_value", "1,3",
                       "--dataset_dir", str(tmp_path / "none"),
                       "--output_dir", str(tmp_path / "out")])
    assert sorted(record) == ["lambda_value-1", "lambda_value-3"]
    for runs in record.values():
        (train_acc, val_acc), = runs
        assert 0.0 <= train_acc <= 1.0 and 0.0 <= val_acc <= 1.0
    assert (tmp_path / "out" / "MNIST_use_slot_checkpoint.pth").is_file()
    assert "start val :0" in capsys.readouterr().out


def test_cli_resume_continues_after_the_saved_epoch(tmp_path, capsys):
    flags = ["--device", "cpu", "--dataset", "ImageNet", "--model", "resnet10",
             "--num_classes", "2", "--channel", "512", "--img_size", "32", "--batch_size", "128",
             "--pre_trained", "false", "--lr_drop", "1", "--dataset_dir", str(tmp_path / "none"),
             "--output_dir", str(tmp_path)]
    cli_main(flags + ["--epochs", "1"])
    capsys.readouterr()
    cli_main(flags + ["--epochs", "2", "--resume", "true"])
    out = capsys.readouterr().out
    assert "at epoch 0" in out and "start train :1" in out and "start train :0" not in out
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == [
        "ImageNet_use_slot_checkpoint.pth", "ImageNet_use_slot_checkpoint0000.pth",
        "ImageNet_use_slot_checkpoint0001.pth"]


def test_thop_counts_parameters_and_flops(capsys):
    params_m, gflops = cli_main(["--device", "cpu", "--model", "resnet10", "--num_classes", "3",
                                 "--thop", "true", "--pre_trained", "false"])
    cfg = ScouterConfig(model="resnet10", num_classes=3)
    n = sum(p.numel() for p in build_slot_model(cfg, device="cpu").parameters())
    assert params_m == n / 1e6 and gflops > 0.1
    assert "GFLOPs @ (1,1,260,260)" in capsys.readouterr().out



def tiny_trainer(**kw):
    from scouter_tpu_torch.data import ArrayDataset
    from scouter_tpu_torch.train import Trainer

    rng = np.random.RandomState(0)
    ds = ArrayDataset(rng.randint(0, 256, (8, SIZE, SIZE, 1)).astype(np.uint8),
                      rng.randint(0, 3, 8), "MNIST")
    cfg = ScouterConfig(**{**STEP_CFG, "device": "cpu", **kw})
    return Trainer(cfg, datasets=(ds, ds))


def test_pretrained_backbone_loads_from_the_local_dir(tmp_path, monkeypatch):
    donor = build_slot_model(ScouterConfig(**STEP_CFG, use_slot=False), device="cpu",
                             generator=torch.Generator().manual_seed(7))
    torch.save({"model": donor.backbone.state_dict()}, tmp_path / "resnet10.pth")
    monkeypatch.setenv("SCOUTER_TPU_PRETRAINED_DIR", str(tmp_path))
    trainer = tiny_trainer(pre_trained=True, freeze_layers=2)
    before = trainer.model.state_dict()
    trainer.maybe_load_pretrained()
    after, donor_sd = trainer.model.state_dict(), donor.backbone.state_dict()
    # the MNIST stem conv and the classifier (another class count) keep their init
    assert torch.equal(after["backbone.conv1.weight"], before["backbone.conv1.weight"])
    assert torch.equal(after["backbone.layer3.0.conv1.weight"],
                       donor_sd["layer3.0.conv1.weight"])
    assert torch.equal(after["backbone.bn1.running_var"], donor_sd["bn1.running_var"])
    assert torch.equal(after["slot.initial_slots"], before["slot.initial_slots"])
    # the fresh optimizer still holds the freeze rule
    assert not trainer.model.backbone.bn1.weight.requires_grad
    assert trainer.state.optimizer.state == {}


def test_use_pre_boots_the_backbone_from_the_no_slot_checkpoint(tmp_path):
    from scouter_tpu_torch.train import create_train_state as make_state

    no_slot_cfg = ScouterConfig(**STEP_CFG, use_slot=False, output_dir=str(tmp_path))
    donor = build_slot_model(no_slot_cfg, device="cpu",
                             generator=torch.Generator().manual_seed(9))
    save_checkpoint(str(tmp_path), no_slot_cfg, make_state(donor, 1e-4), epoch=0)
    trainer = tiny_trainer(use_pre=True, output_dir=str(tmp_path))
    head = trainer.model.slot.initial_slots.detach().clone()
    trainer.maybe_use_pre()
    got, want = trainer.model.state_dict(), donor.state_dict()
    for k in want:
        if k.startswith("backbone.") and not k.startswith("backbone.fc."):
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(trainer.model.slot.initial_slots, head)
