"""The activation and layer hooks of ``models/act.py`` on the last backbone
slice, against the JAX package's on the CPU, as ``test_torch_zoo2_hooks.py``
holds the second slice's: in one forward of each family (a narrow TResNet,
DPN and NASNet, the other networks whole at small sizes), the ReLU and
residual-add overrides and excitation backprop's linear and BatchNorm rules
are called as often as JAX calls its own; outside an override the hooks
leave a forward's bits alone. TResNet's blocks end in a plain ReLU and add
(JAX's ``jax.nn.relu``, not its ``act.relu``), Inception-ResNet's residuals
are plain adds, and DPN's last act is an ELU: no hook sees them in either."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.explain import excitation as jax_excitation
from scouter_tpu.models import act as jax_act
from scouter_tpu.models import dpn as jax_dpn
from scouter_tpu.models import gluon_xception as jax_gluon
from scouter_tpu.models import inception_resnet_v2 as jax_irv2
from scouter_tpu.models import inception_v3 as jax_v3
from scouter_tpu.models import inception_v4 as jax_v4
from scouter_tpu.models import nasnet as jax_nasnet
from scouter_tpu.models import pnasnet as jax_pnasnet
from scouter_tpu.models import selecsls as jax_selecsls
from scouter_tpu.models import tresnet as jax_tresnet
from scouter_tpu.models import xception as jax_xception
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu_torch.explain import excitation
from scouter_tpu_torch.models import act, dpn, gluon_xception as gluon, inception_resnet_v2 as irv2
from scouter_tpu_torch.models import inception_v3 as v3, inception_v4 as v4, nasnet, pnasnet
from scouter_tpu_torch.models import selecsls, tresnet, xception
from test_torch_models import nhwc
from test_torch_xai_act import Counter


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one representative a family: (JAX class, port class, input size, fields)
HOOK_CASES = {
    "tresnet": (jax_tresnet.TResNet, tresnet.TResNet, 64,
                dict(layers=(1, 1, 2, 1), width_factor=0.25)),
    "dpn_b": (jax_dpn.DPN, dpn.DPN, 64, dict(b=True, num_init_features=16, k_r=16, groups=4,
                                             k_sec=(1, 2, 1, 1), inc_sec=(4, 4, 4, 4))),
    "selecsls42b": (jax_selecsls.SelecSLS, selecsls.SelecSLS, 64, dict(variant="selecsls42b")),
    "inception_v3": (jax_v3.InceptionV3, v3.InceptionV3, 75, {}),
    "inception_v4": (jax_v4.InceptionV4, v4.InceptionV4, 75, {}),
    "inception_resnet_v2": (jax_irv2.InceptionResnetV2, irv2.InceptionResnetV2, 75, {}),
    # the counts do not depend on the size: each net at a small one whose
    # maps stay non-empty
    "xception": (jax_xception.Xception, xception.Xception, 75, {}),
    "gluon_xception65": (jax_gluon.Xception65, gluon.Xception65, 64, {}),
    "nasnet_narrow": (jax_nasnet.NASNetALarge, nasnet.NASNetALarge, 64,
                      dict(num_features=192)),
    "pnasnet5large": (jax_pnasnet.PNASNet5Large, pnasnet.PNASNet5Large, 64, dict(drop_rate=0.0)),
}


@pytest.fixture(scope="module", params=sorted(HOOK_CASES))
def hook_case(request):
    """The port's model (its own init) and the counts of each hook: JAX's
    from one traced forward with abstract variables (JAX's tree as its
    converter reads the port's) under the EBP rules and
    the ReLU and residual-add counters (the counts come from tracing alone,
    and the rules are called in the forward: JAX's EBP gradient does not
    trace through the exclude-pad average pools of Inception-V4,
    Inception-ResNet-V2 and NASNet, a ``reduce_window`` under the patched
    ops), the port's from one forward under the same."""
    jax_cls, port_cls, size, kw = HOOK_CASES[request.param]
    kw = dict(num_classes=3, **kw)
    jmodel = jax_cls(**kw)
    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    torch.manual_seed(0)
    model = port_cls(**kw).eval()
    # JAX's tree, shapes only, through its own converter from the port's
    # (the registry tests hold the two trees equal)
    variables = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
        torch_state_dict_to_variables({k: np.broadcast_to(np.float32(0), tuple(v.shape))
                                       for k, v in model.state_dict().items()}))
    j = dict(relu=Counter(jax.nn.relu), add=Counter(lambda a, b: a + b))
    t = dict(relu=Counter(torch.relu), add=Counter(torch.add))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_ebp_conv", "_ebp_dot", "_straight_through"):
            j[name] = Counter(getattr(jax_excitation, name))
            mp.setattr(jax_excitation, name, j[name])
        for name in ("_ebp_linear", "_straight_through"):
            t[name] = Counter(getattr(excitation, name))
            mp.setattr(excitation, name, t[name])
        with jax_excitation.ebp_rules(), jax_act.override_relu(j["relu"]), \
                jax_act.override_residual_add(j["add"]):
            jax.eval_shape(jmodel.apply, variables, jnp.asarray(x))
        with excitation.ebp_rules(), act.override_relu(t["relu"]), \
                act.override_residual_add(t["add"]), torch.no_grad():
            model(nhwc(x))
    # the port's EBP gradient runs on every family (at random weights a
    # normaliser may be zero, so its values are not held)
    xt = nhwc(x).requires_grad_(True)
    with excitation.ebp_rules():
        (g,) = torch.autograd.grad(model(xt)[0, 1], xt)
    assert g.shape == xt.shape
    return model, x, {k: c.calls for k, c in j.items()}, {k: c.calls for k, c in t.items()}


def test_relu_and_residual_add_hooks_are_called_as_in_jax(hook_case):
    """``act.relu`` and ``act.residual_add`` where JAX's family calls its
    own, and nowhere else (TResNet: nowhere)."""
    model, _, j, t = hook_case
    assert (j["relu"] + j["add"] > 0) != isinstance(model, tresnet.TResNet)
    assert (t["relu"], t["add"]) == (j["relu"], j["add"])


def test_ebp_rule_reaches_the_ops_jax_patches(hook_case):
    """Under the EBP rules the port's linear rule runs as often as JAX's
    ``_ebp_conv`` + ``_ebp_dot`` (TResNet's blur is a conv in both), its
    BatchNorm rule once per BatchNorm call."""
    _, _, j, t = hook_case
    assert j["_ebp_conv"] > 0
    assert t["_ebp_linear"] == j["_ebp_conv"] + j["_ebp_dot"]
    assert t["_straight_through"] == j["_straight_through"]


def test_hooks_route_the_plain_ops_bit_for_bit(hook_case):
    model, x, _, _ = hook_case
    with torch.no_grad():
        want = model(nhwc(x))
        with act.override_relu(torch.relu), act.override_residual_add(torch.add):
            got = model(nhwc(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------- a slot model on the Xception backbone

def test_xception_slot_model_train_step_matches_jax():
    """One train step of a slot model on the whole Xception at 48 px (a 2 x 2
    map, N=4): its loss and metrics against those of JAX's step (its loss
    and ``_metrics``, from one compiled gradient in f32), and the gradients
    it leaves before the update against ``jax.grad`` in float64 within
    1e-3 x max|g|, or twice JAX's own f32 distance from it where that is
    larger (``test_torch_zoo2_train.py``'s bars: through 36 train-mode
    BatchNorms the stem conv's f32 gradient moves 1.5e-3 of its scale)."""
    from scouter_tpu.models import SlotModel as JaxSlotModel
    from scouter_tpu.ops.losses import scouter_loss
    from scouter_tpu.train.steps import _metrics
    from scouter_tpu_torch.models import SlotModel, init_weights, variables_to_state_dict
    from scouter_tpu_torch.train import create_train_state, make_train_step
    from test_torch_models import perturb
    from test_torch_zoo2_train import _slot
    from test_torch_zoo_registry import jax_f64_grads

    jmodel = _slot(jax_xception.Xception(num_classes=0), JaxSlotModel, False)
    model = _slot(xception.Xception(num_classes=0), SlotModel, True)
    init_weights(model, torch.Generator().manual_seed(1))
    names = model.state_dict().keys()
    variables = perturb(torch_state_dict_to_variables(
        {k: t.numpy() for k, t in model.state_dict().items()}), seed=9)
    model.load_state_dict(variables_to_state_dict(variables, names))
    rng = np.random.RandomState(11)
    x = rng.randn(2, 48, 48, 3).astype(np.float32)
    y = rng.randint(0, 3, 2)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
        _, losses = scouter_loss(out["logits"], y, out.get("area_loss"), 1.0)
        return losses["loss"], _metrics(out, losses, y)

    jgrads, jm = jax.device_get(jax.jit(jax.grad(loss, has_aux=True))(variables["params"]))
    jax_f32 = variables_to_state_dict({"params": jgrads}, names)
    state = create_train_state(model, 1e-4)
    state, m = make_train_step(1.0)(state, {"image": nhwc(x), "label": torch.from_numpy(y)})
    for k in ("loss", "log_loss", "att_loss", "acc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-3, atol=1e-6)
    want = jax_f64_grads(jmodel, variables, x, y, names)
    grads = {k: p.grad for k, p in state.model.named_parameters() if p.grad is not None}
    assert set(grads) == set(want) and any(k.startswith("slot.") for k in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        floor = 2 * np.abs(jax_f32[name].numpy() - w).max()
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=max(1e-3 * np.abs(w).max(), floor), err_msg=name)
