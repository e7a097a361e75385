"""The port's training over ``torch.distributed`` against the JAX package's
mesh step, in one gloo world of 4 CPU processes (``tests/_torch_dist_child.py``,
which imports torch and the port only).

The JAX side runs here, on 4 of the test process's 8 virtual CPU devices,
while the ranks run: ``make_train_step(mesh=...)`` over a (4,) data mesh in
both BN modes, from the same weights (carried by the port's
``variables_to_state_dict``) on the same global batches, those of
``tests/test_torch_train.py::test_four_train_steps_match_jax``, to whose bars
the ranks' (4,) steps are held. AdamW does not see a gradient's scale, so the
first step's averaged gradients are also held to the port's one-process
gradients of the same objective: the global batch's, or with per-replica BN
the mean of each replica's. The (2, 2) ZeRO-1 steps are held to the port's
one-process step on the global batch, their gradient pieces too; their
sharded checkpoint must load unsharded here; only rank 0 may write; and a
preemption that one rank alone sees must stop every rank at one batch and
resume bit for bit."""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.parallel import make_mesh as jax_make_mesh
from scouter_tpu.parallel import shard_batch as jax_shard_batch
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.checkpoint import checkpoint_path, restore_checkpoint
from scouter_tpu_torch.models import build_slot_model, variables_to_state_dict
from scouter_tpu_torch.train import create_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
TIMEOUT_S = 300
STEPS = 4
LR = 1e-4
GLOBAL_BATCH = 4
# tests/test_torch_train.py's STEP_CFG: at 64 px the MNIST-stem resnet10
# leaves a 2x2 map, so the class scores have a gradient
STEP_CFG = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                slots_per_class=2, to_k_layer=2, power=2, lambda_value=1.0, img_size=64,
                batch_size=4, hidden_dim=64)
SIZE = STEP_CFG["img_size"]
TRAINER = dict(img_size=32, batch_size=2, epochs=2, zero1=True, mesh_shape=[2, 2],
               lr_drop=1)
FIRE = (1, 1)  # rank 1's guard fires after batch 1 of epoch 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _perturbed_variables(seed: int):
    """JAX's init with numpy noise on BN statistics, scales and biases (as
    tests/test_torch_train.py's), so the statistics matter."""
    jmodel = jax_build_slot_model(JaxConfig(**STEP_CFG))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), np.zeros((1, SIZE, SIZE, 1), np.float32)))
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


def _port_model():
    return build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_steps(jmodel, variables, batches, sync_bn: bool):
    """JAX's mesh steps: each step's metrics, and the variables after the
    last step and after the first."""
    mesh = jax_make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    jstate, tx = jax_create_train_state(variables, LR)
    step = jax_make_train_step(jmodel, tx, 1.0, donate=False, mesh=mesh, sync_bn=sync_bn)
    metrics = []
    for i, (x, y) in enumerate(batches):
        jstate, m = step(jstate, jax_shard_batch(mesh, {"image": jnp.asarray(x),
                                                        "label": jnp.asarray(y)}))
        metrics.append({k: float(v) for k, v in m.items()})
        held = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
        if i == 0:
            first = held
    return metrics, held, first


def _jax_steps_f64(jmodel, variables, batches):
    """JAX's per-replica mesh steps in float64."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        metrics, held, _ = _jax_steps(jmodel, v64, [(x.astype(np.float64), y)
                                                    for x, y in batches], sync_bn=False)
    return metrics, held


def _world_one_steps(weights, batches):
    """The port's one-process steps on the global batches, with each step's
    gradients."""
    model = _port_model()
    model.load_state_dict(weights)
    state = create_train_state(model, LR)
    step = make_train_step(1.0)
    metrics, grads = [], []
    for x, y in batches:
        state, m = step(state, {"image": _nchw(x), "label": torch.from_numpy(y).long()})
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    return metrics, grads, state


def _per_replica_grads(weights, batch):
    """The mean over the 4 replicas of each one's one-process gradient on its
    own row, with its own BatchNorm statistics."""
    x, y = batch
    total = {}
    for r in range(WORLD):
        model = _port_model()
        model.load_state_dict(weights)
        state = create_train_state(model, LR)
        rows = slice(r * GLOBAL_BATCH // WORLD, (r + 1) * GLOBAL_BATCH // WORLD)
        make_train_step(1.0)(state, {"image": _nchw(x[rows]),
                                     "label": torch.from_numpy(y[rows]).long()})
        for n, p in model.named_parameters():
            if p.grad is not None:
                total[n] = total.get(n, 0) + p.grad.double() / WORLD
    return total


def _assert_grads_close(got, want, bar=1e-4):
    """Each gradient (or block of one) within ``bar`` of the reference's in
    norm, relative to the reference's norm over the block."""
    assert set(got) == set(want)
    for name, g in got.items():
        block = tuple(slice(a, b) for a, b in g["block"])
        ref = want[name].double()[block]
        err = float((g["grad"].double() - ref).norm() / ref.norm().clamp_min(1e-30))
        assert err <= bar, (name, err)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks, compute JAX's and the one-process port's side while
    they run, and hand both over with the ranks' results."""
    work = tmp_path_factory.mktemp("gloo_world")
    jmodel, variables = _perturbed_variables(0)
    names = _port_model().state_dict()
    weights = variables_to_state_dict(variables, names)
    torch.save(weights, work / "weights.pt")
    rng = np.random.RandomState(1)  # tests/test_torch_train.py::batches(1, 4)
    batches = [(rng.randn(GLOBAL_BATCH, SIZE, SIZE, 1).astype(np.float32),
                rng.randint(0, 3, GLOBAL_BATCH)) for _ in range(STEPS)]
    np.savez(work / "inputs.npz", **{f"x{i}": x.transpose(0, 3, 1, 2) for i, (x, _) in
                                     enumerate(batches)},
             **{f"y{i}": y for i, (_, y) in enumerate(batches)})
    (work / "spec.json").write_text(json.dumps(
        dict(cfg=STEP_CFG, steps=STEPS, lr=LR, trainer=TRAINER, fire=FIRE)))

    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_child.py"),
                               port, str(r), str(WORLD), str(work)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        jax_side = {sync_bn: _jax_steps(jmodel, variables, batches, sync_bn)
                    for sync_bn in (True, False)}
        jax_f64 = _jax_steps_f64(jmodel, variables, batches)
        world_one = _world_one_steps(weights, batches)
        per_replica = _per_replica_grads(weights, batches[0])
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world did not finish in {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        log = (work / f"rank{r}.log").read_text()
        assert p.returncode == 0 and "OK" in log, f"rank {r} failed:\n{log[-6000:]}"
    results = [json.loads((work / f"result_{r}.json").read_text()) for r in range(WORLD)]
    return dict(work=work, weights=weights, jax=jax_side, jax_f64=jax_f64, world_one=world_one,
                per_replica=per_replica, results=results, names=names)


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync_bn", "per_replica_bn"])
def test_data_parallel_steps_match_jax_mesh_step(world, sync_bn):
    """tests/test_torch_train.py::test_four_train_steps_match_jax's bars:
    every step's metrics within rtol 1e-3, running statistics within 1e-4,
    after the first step (the BatchNorm semantics alone) and, with global
    statistics, after the last. With per-replica BN over one sample a replica
    the last step's f32 statistics carry three steps of AdamW's sign noise
    (up to 1.8e-4 from JAX's f32, which lies up to 4e-5 from its own
    float64): those are held in float64 instead, by the next test."""
    jmetrics, jvars, jfirst = world["jax"][sync_bn]
    got = torch.load(world["work"] / f"dp_{sync_bn}.pt")
    for step, (m, jm) in enumerate(zip(got["metrics"], jmetrics)):
        for k in ("loss", "log_loss", "att_loss", "acc"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    checks = [(got["after_first"], jfirst)] + ([(got["model"], jvars)] if sync_bn else [])
    for ours, theirs in checks:
        want = variables_to_state_dict({"batch_stats": theirs["batch_stats"]}, world["names"])
        for name, w in want.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(ours[name].numpy(), w.numpy(), rtol=0, atol=1e-4,
                                           err_msg=name)


def test_per_replica_bn_in_float64_matches_jax(world):
    """The per-replica world in float64 against JAX's per-replica mesh step
    in float64 (both reduce the loss in f32): metrics within rtol 1e-5,
    running statistics within 1e-5 after four steps."""
    jmetrics, jvars = world["jax_f64"]
    got = torch.load(world["work"] / "dp_f64.pt")
    for step, (m, jm) in enumerate(zip(got["metrics"], jmetrics)):
        for k in ("loss", "log_loss", "att_loss", "acc"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    want = variables_to_state_dict({"batch_stats": jvars["batch_stats"]}, world["names"])
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["model"][name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync_bn", "per_replica_bn"])
def test_data_parallel_gradients_and_ranks_agree(world, sync_bn):
    """The first step's averaged gradient is the one-process gradient of the
    same objective; every rank logs the global metrics and ends with the
    same parameters, bit for bit."""
    got = torch.load(world["work"] / f"dp_{sync_bn}.pt")
    want = world["world_one"][1][0] if sync_bn else world["per_replica"]
    _assert_grads_close(got["grads"], want)
    for r in world["results"]:
        assert r[f"dp_{sync_bn}"]["metrics"] == got["metrics"]
        assert r[f"dp_{sync_bn}"]["checksum"] == world["results"][0][f"dp_{sync_bn}"]["checksum"]


def test_tp_zero1_steps_match_the_one_process_step(world):
    """(2, 2) with ZeRO-1 against the port's one-process step on the global
    batch: each rank's pieces of the first averaged gradient within 1e-4 in
    norm, losses within 1e-4, and every parameter within 1e-5 of its scale
    bar at most 0.1% of the elements (Queue C's lamb note). The two sides'
    gradients differ in f32 rounding (~1e-5 of a norm: the global BatchNorm
    sums its statistics in another order), and AdamW's m / sqrt(v) turns
    that into up to ~lr where an element's gradient is near zero or changes
    sign between steps, so its moment cancels: 314 of 4,963,456 elements
    on this host, at most 6.1e-5 off."""
    metrics, grads, state = world["world_one"]
    for r in range(WORLD):
        _assert_grads_close(torch.load(world["work"] / f"zero1_grads_{r}.pt"), grads[0])
    got = torch.load(world["work"] / "zero1.pt")
    for m, want in zip(got["metrics"], metrics):
        for k in ("loss", "log_loss", "att_loss", "acc"):
            np.testing.assert_allclose(m[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    want_sd = state.model.state_dict()
    off = total = 0
    for name, p in state.model.named_parameters():
        scale = max(1.0, float(p.detach().abs().max()))
        diff = (got["model"][name] - want_sd[name]).abs()
        off += int((diff > 1e-5 * scale).sum())
        total += p.numel()
        assert float(diff.max()) <= 2 * LR * STEPS, name  # AdamW's reach
    assert off <= 1e-3 * total, off
    # the ranks held shards: (2, 2) splits layer4's convs over model, ZeRO-1
    # the moments over data, and every rank ends with the same weights
    shapes = [r["zero1"]["local_shapes"] for r in world["results"]]
    full = want_sd["backbone.layer4.0.conv1.weight"].shape
    assert all(s["backbone.layer4.0.conv1.weight"] == [full[0] // 2, *full[1:]] for s in shapes)
    assert len({r["zero1"]["checksum"] for r in world["results"]}) == 1
    moments = world["results"][0]["zero1"]["moment_shapes"]
    assert sum(np.prod(s) for s in moments.values()) < 0.3 * sum(
        p.numel() for p in state.model.parameters())


def test_sharded_checkpoint_loads_unsharded(world):
    """The checkpoint the (2, 2) ZeRO-1 ranks wrote is a one-process state:
    it loads into an unsharded model and optimizer, with the gathered
    weights and moments; and on the ranks it restores onto the layout bit
    for bit."""
    model = _port_model()
    state = create_train_state(model, LR)
    cfg = ScouterConfig(**STEP_CFG, device="cpu")
    state, epoch, _ = restore_checkpoint(checkpoint_path(str(world["work"] / "ckpt"), cfg), state)
    assert epoch == 0 and state.step == STEPS
    gathered = torch.load(world["work"] / "zero1.pt")
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, gathered["model"][name]), name
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == sum(1 for p in model.parameters() if p.requires_grad)
    for i, entry in opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[k], gathered["optimizer"]["state"][i][k])
    assert all(r["restore_equal"] and r["restore_epoch"] == 0 for r in world["results"])


def test_sync_batch_stats_averages_the_replicas(world):
    """Each rank's statistics set to its rank, then averaged over the data
    group of the (4,) mesh and over the world: 1.5 everywhere."""
    for r in world["results"]:
        assert r["sync_batch_stats"] == [[1.5], [1.5]]


def test_only_rank_zero_writes(world):
    work = world["work"]
    assert (work / "only_rank0.pth").is_file()
    assert not any((work / f"only_rank{r}.pth").exists() for r in range(1, WORLD))
    assert sorted(p.name for p in (work / "ckpt").iterdir()) == ["MNIST_use_slot_checkpoint.pth"]


def test_preemption_consensus_and_bit_exact_resume(world):
    results = world["results"]
    for r in results:
        # rank 1 alone fired; every rank stopped after the same batch
        assert r["preempted_at"] == [FIRE[0], FIRE[1] + 1], r["preempted_at"]
        assert r["steps_per_epoch"] == 16 // 2 // 2
        assert r["resume_start_epoch"] == FIRE[0]
        assert r["resume_equal"]
        assert r["reloaded_equal"]
    full, resumed = results[0]["resume_losses"]
    assert resumed[-1] == full[-1]
    assert "MNIST_use_slot_checkpoint.pth" in results[0]["run_files"]
