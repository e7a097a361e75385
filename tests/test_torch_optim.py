"""The port's optimizer and scheduler factories and extra losses against the
JAX package on the CPU: every optimizer name (and lookahead over adamw,
nadam and lamb) for five steps on resnet10's parameter tree with the same
gradients, with the no-decay mask and in the decay-everywhere form; the
mask itself; one whole train step of the resnet10 MNIST recipe under sgd and
lamb against JAX's ``make_train_step`` with the same ``tx``; every schedule
and the plateau rule for 60 epochs; the three losses.

Parameters are the port's init read into a JAX tree by the JAX package's
converter; gradients are numpy draws from a seed in the port's layout,
carried to JAX's by the same converter."""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.ops.extra_losses import jsd_cross_entropy as jax_jsd
from scouter_tpu.ops.extra_losses import label_smoothing_cross_entropy as jax_ls_ce
from scouter_tpu.ops.extra_losses import soft_target_cross_entropy as jax_soft_ce
from scouter_tpu.train.optim_factory import create_optimizer as jax_create_optimizer
from scouter_tpu.train.optim_factory import no_decay_mask as jax_no_decay_mask
from scouter_tpu.train.scheduler_factory import PlateauScheduler as JaxPlateau
from scouter_tpu.train.scheduler_factory import create_scheduler as jax_create_scheduler
from scouter_tpu.train.state import TrainState as JaxTrainState
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.models import build_slot_model, create_model, init_weights
from scouter_tpu_torch.models import variables_to_state_dict
from scouter_tpu_torch.ops.extra_losses import (jsd_cross_entropy,
                                                label_smoothing_cross_entropy,
                                                soft_target_cross_entropy)
from scouter_tpu_torch.train import TrainState, make_train_step
from scouter_tpu_torch.train.optim_factory import BASE_NAMES, create_optimizer, no_decay_mask
from scouter_tpu_torch.train.scheduler_factory import PlateauScheduler, create_scheduler

TRAJ_TOL = dict(rtol=1e-5, atol=1e-7)
LR, WD, STEPS = 1e-2, 0.05, 5
LOOKAHEAD_K = 2  # so that five steps sync twice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def resnet10_tree():
    """resnet10's parameters (4-D convs, 2-D fc, 1-D BN and bias) as numpy
    in the port's layout, their names, and five steps of gradients."""
    model = create_model("resnet10", num_classes=5)
    init_weights(model, torch.Generator().manual_seed(0))
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rng = np.random.RandomState(1)
    grads = [{n: (rng.randn(*v.shape) * 0.1).astype(np.float32) for n, v in params.items()}
             for _ in range(STEPS)]
    return params, grads, list(model.state_dict())


def jax_params(named):
    return torch_state_dict_to_variables(named)["params"]


@functools.lru_cache(maxsize=None)
def jax_grads():
    return [jax_params(g) for g in resnet10_tree()[1]]


def jax_trajectory(name, decay_mask):
    params, grads, names = resnet10_tree()
    tree = jax_params(params)
    tx = jax_create_optimizer(name, lr=LR, weight_decay=WD, momentum=0.9, eps=1e-8,
                              params=tree if decay_mask else None,
                              lookahead_sync_period=LOOKAHEAD_K)
    state = tx.init(tree)
    out = []
    for g in jax_grads():
        updates, state = tx.update(g, state, tree)
        tree = optax.apply_updates(tree, updates)
        out.append(variables_to_state_dict({"params": jax.device_get(tree)}, names))
    return out


def port_trajectory(name, decay_mask):
    params, grads, _ = resnet10_tree()
    tensors = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()}
    opt = create_optimizer(name, lr=LR, weight_decay=WD, momentum=0.9, eps=1e-8,
                           params=tensors, lookahead_sync_period=LOOKAHEAD_K,
                           decay_mask=decay_mask)
    out = []
    for g in grads:
        for n, p in tensors.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        out.append({n: p.detach().clone() for n, p in tensors.items()})
    return out


NAMES = list(BASE_NAMES) + ["lookahead_adamw", "lookahead_nadam", "lookahead_lamb"]


@pytest.mark.parametrize("decay_mask", [True, False], ids=["params", "decay_all"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_trajectory_matches_optax(name, decay_mask):
    want = jax_trajectory(name, decay_mask)
    got = port_trajectory(name, decay_mask)
    for step, (w, g) in enumerate(zip(want, got)):
        for n, t in g.items():
            np.testing.assert_allclose(t.numpy(), w[n].numpy(), **TRAJ_TOL,
                                       err_msg=f"{name} step {step} {n}")


def test_no_decay_mask_matches_jax():
    params, _, names = resnet10_tree()
    tree = jax_params(params)
    want = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32),
                                          jax_no_decay_mask(tree), tree)}, names)
    got = no_decay_mask(params)
    assert got == {n: bool(want[n].all()) for n in params}
    assert set(got.values()) == {True, False}
    tensors = [torch.zeros(4, 4), torch.zeros(4), torch.zeros(2, 3, 1, 1)]
    assert no_decay_mask(tensors) == [True, False, True]
    opt = create_optimizer("adamw", weight_decay=0.1, params=tensors)
    assert [(len(g["params"]), g["weight_decay"]) for g in opt.param_groups] == [(2, 0.1),
                                                                                   (1, 0.0)]
    (group,) = create_optimizer("adamw", weight_decay=0.1, params=tensors,
                                decay_mask=False).param_groups
    assert (len(group["params"]), group["weight_decay"]) == (3, 0.1)


@pytest.mark.parametrize("name", ["nadam", "novograd", "nvnovograd"])
def test_folded_decay_skips_ndim1_params(name):
    """tests/test_utils_extras.py::TestWeightDecayMask on the port: with the
    mask, the bias of a folded-decay optimizer moves as with no decay, the
    weight does not."""
    rng = np.random.RandomState(0)
    params0 = {"w": rng.randn(4, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grad_seq = [{"w": rng.randn(4, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
                for _ in range(2)]

    def run(wd):
        tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
        opt = create_optimizer(name, lr=1e-2, weight_decay=wd, params=tensors)
        for g in grad_seq:
            for k, p in tensors.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
        return {k: p.detach().numpy() for k, p in tensors.items()}

    p_wd, p_0 = run(0.1), run(0.0)
    np.testing.assert_allclose(p_wd["b"], p_0["b"], rtol=1e-6, err_msg=name)
    assert np.abs(p_wd["w"] - p_0["w"]).max() > 1e-7, name


def test_factory_rejects_unknown_names_and_missing_params():
    with pytest.raises(ValueError, match="unknown optimizer"):
        create_optimizer("adamax", params=[torch.zeros(2)])
    with pytest.raises(TypeError, match="params"):
        create_optimizer("adamw")


def test_state_dict_round_trip_keeps_host_scalars_on_the_host():
    params, grads, _ = resnet10_tree()

    def make():
        tensors = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()}
        return tensors, create_optimizer("lookahead_nadam", lr=LR, weight_decay=WD,
                                         params=tensors, lookahead_sync_period=LOOKAHEAD_K)

    def step(tensors, opt, g):
        for n, p in tensors.items():
            p.grad = torch.from_numpy(g[n])
        opt.step()

    a, opt_a = make()
    for g in grads[:3]:
        step(a, opt_a, g)
    b, opt_b = make()
    for n in params:
        b[n].data.copy_(a[n].data)
    opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))  # as from a file
    st = opt_b.state[b["fc.weight"]]
    assert st["step"].device.type == "cpu" and st["m_schedule"].dtype == torch.float64
    for g in grads[3:]:
        step(a, opt_a, g)
        step(b, opt_b, g)
    for n in params:
        assert torch.equal(a[n], b[n]), n


# ------------------------------------------------------------ one train step

STEP_CFG = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                slots_per_class=2, to_k_layer=2, power=2, lambda_value=1.0, img_size=64,
                batch_size=4, hidden_dim=64)


@functools.lru_cache(maxsize=None)
def step_case():
    """The recipe's port model init read into a JAX tree, and one batch."""
    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: t.numpy().copy() for k, t in model.state_dict().items()}
    rng = np.random.RandomState(1)
    x = rng.randn(4, 64, 64, 1).astype(np.float32)
    y = rng.randint(0, 3, 4)
    return torch_state_dict_to_variables(sd), x, y


@pytest.mark.parametrize("name", ["sgd", "lamb"])
def test_one_train_step_matches_jax(name):
    variables, x, y = step_case()
    jmodel = jax_build_slot_model(JaxConfig(**STEP_CFG))
    params = variables["params"]
    tx = jax_create_optimizer(name, lr=1e-2, weight_decay=0.01, params=params)
    jstate = JaxTrainState(params=params, batch_stats=variables.get("batch_stats"),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jmodel, tx, 1.0, donate=False)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})

    model = build_slot_model(ScouterConfig(**STEP_CFG), fused_slot=True, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    names = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in names.items()}
    state = TrainState(model=model, optimizer=create_optimizer(name, lr=1e-2,
                                                               weight_decay=0.01,
                                                               params=names))
    image = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    state, m = make_train_step(1.0)(state, {"image": image, "label": torch.from_numpy(y)})
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
    after_j = variables_to_state_dict({"params": jax.device_get(jstate.params)},
                                      model.state_dict())
    before_j = variables_to_state_dict({"params": params}, model.state_dict())
    flips = total = 0
    for n, p in names.items():
        want = (after_j[n] - before_j[n]).numpy()
        got = (p.detach() - before[n]).numpy()
        off = np.abs(got - want) > 1e-3 * np.abs(want).max()
        if name == "lamb":
            # lamb's first step is adam's, about lr * sign(g) * trust ratio:
            # an element whose gradient lies within f32 noise of zero may
            # flip (every flip measured at |g| <= 5e-5 max|g|; Queue C)
            g = np.abs(p.grad.numpy())
            assert not (off & (g >= 1e-4 * g.max())).any(), (name, n)
            flips, total = flips + int(off.sum()), total + off.size
        else:
            assert not off.any(), (name, n)
    assert flips <= 1e-3 * total, (flips, total)


# ---------------------------------------------------------------- schedules

SCHEDULES = [
    ("step", dict(epochs=40, decay_epochs=10, decay_rate=0.3, warmup_epochs=2,
                  warmup_lr_init=1e-6)),
    ("multistep", dict(epochs=60, decay_milestones=[10, 25, 40], decay_rate=0.5)),
    ("cosine", dict(epochs=30, min_lr=1e-5, decay_rate=0.5, warmup_epochs=3,
                    warmup_lr_init=1e-6, cycle_limit=2)),
    ("cosine", dict(epochs=12, cycle_mul=1.5, cycle_limit=0, noise_range=(5, 40),
                    noise_type="uniform")),
    ("tanh", dict(epochs=25, min_lr=1e-4, decay_rate=1.0, warmup_epochs=4,
                  warmup_lr_init=1e-6, cycle_limit=1)),
    ("tanh", dict(epochs=20, cycle_mul=2.0, cycle_limit=3, noise_range=10, noise_seed=7)),
]


@pytest.mark.parametrize("sched,kw", SCHEDULES)
def test_schedule_equals_jax(sched, kw):
    want = jax_create_scheduler(sched, 0.1, **kw)
    got = create_scheduler(sched, 0.1, **kw)
    assert [got(e) for e in range(60)] == [want(e) for e in range(60)]


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_equals_jax(mode):
    metrics = np.random.RandomState(3).rand(60).round(2).tolist()
    want, got = JaxPlateau(0.1, patience=2, mode=mode), PlateauScheduler(0.1, patience=2,
                                                                          mode=mode)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        create_scheduler("plateau", 0.1, 10)


# ------------------------------------------------------------------- losses

def loss_inputs(dtype=np.float32):
    rng = np.random.RandomState(5)
    logits = [(rng.randn(8, 7) * 3).astype(dtype) for _ in range(3)]
    labels = rng.randint(0, 7, 8)
    soft = rng.dirichlet(np.ones(7), 8).astype(np.float32)
    return logits, labels, soft


@pytest.mark.parametrize("loss", ["label_smoothing", "soft_target", "jsd", "jsd_same"])
def test_extra_losses_match_jax(loss):
    (a, b, c), labels, soft = loss_inputs()
    t = [torch.from_numpy(v) for v in (a, b, c)]
    lab = torch.from_numpy(labels)
    if loss == "label_smoothing":
        got = label_smoothing_cross_entropy(t[0], lab, 0.2)
        want = jax_ls_ce(jnp.asarray(a), jnp.asarray(labels), 0.2)
    elif loss == "soft_target":
        got = soft_target_cross_entropy(t[0], torch.from_numpy(soft))
        want = jax_soft_ce(jnp.asarray(a), jnp.asarray(soft))
    elif loss == "jsd":
        got = jsd_cross_entropy(*t, lab, alpha=12.0, smoothing=0.1)
        want = jax_jsd(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(labels))
    else:
        got = jsd_cross_entropy(t[0], t[0], t[0], lab)
        want = jax_jsd(*[jnp.asarray(a)] * 3, jnp.asarray(labels))
        assert got.item() == pytest.approx(label_smoothing_cross_entropy(t[0], lab).item(),
                                           rel=1e-5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_losses_reduce_bf16_logits_in_f32():
    (a, b, c), labels, _ = loss_inputs()
    lab = torch.from_numpy(labels)
    t16 = [torch.from_numpy(v).to(torch.bfloat16) for v in (a, b, c)]
    t32 = [v.to(torch.float32) for v in t16]
    for fn, args16, args32 in (
            (label_smoothing_cross_entropy, (t16[0], lab), (t32[0], lab)),
            (jsd_cross_entropy, (*t16, lab), (*t32, lab))):
        got = fn(*args16)
        assert got.dtype == torch.float32
        assert got.item() == fn(*args32).item()
    assert math.isfinite(soft_target_cross_entropy(t16[0], torch.eye(7)[lab]).item())
