"""The activation and layer hooks of ``models/act.py`` on the second
backbone slice, against the JAX package's on the CPU, as
``test_torch_xai_act.py`` holds the ResNet zoo's: in one forward of a small
representative of each family (and of CBAM and eSE in a ResNet block), the
ReLU and residual-add overrides and excitation backprop's linear and
BatchNorm rules are called as often as JAX calls its own; outside an
override the hooks leave a forward's bits alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.explain import excitation as jax_excitation
from scouter_tpu.models import act as jax_act
from scouter_tpu_torch.explain import excitation
from scouter_tpu_torch.models import act
from test_torch_models import nhwc
from test_torch_xai_act import Counter
from test_torch_zoo2 import MECHANISMS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one representative a family (and the blocks and gates each reaches)
HOOK_CASES = ("ds_ir_se", "condconv", "mbv3_hard", "regnet_y", "dla_res2net",
              "vovnet_ese_residual", "densenet_blur_deep", "hrnet_fuse", "senet_3conv_stem",
              "resnet_cbam", "resnet_ese")


@pytest.fixture(scope="module", params=HOOK_CASES)
def hook_case(request):
    """JAX's model with abstract variables (the counts come from tracing
    alone) and the port's with its own init."""
    family, kw, size = MECHANISMS[request.param]
    kw = dict(num_classes=3, **kw)
    jmodel = family.jax(**kw)
    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    torch.manual_seed(0)
    return jmodel, variables, family.port(**kw).eval(), x


def test_relu_and_residual_add_hooks_are_called_as_in_jax(hook_case):
    """``act.relu`` and ``act.residual_add`` where JAX's family calls its
    own, and nowhere else: HRNet's fuse sum, RegNet's and VoVNet's skips
    and DLA's root are plain adds in both."""
    jmodel, variables, model, x = hook_case
    j_relu, j_add = Counter(jax.nn.relu), Counter(lambda a, b: a + b)
    with jax_act.override_relu(j_relu), jax_act.override_residual_add(j_add):
        jax.eval_shape(jmodel.apply, variables, jnp.asarray(x))
    t_relu, t_add = Counter(torch.relu), Counter(torch.add)
    with act.override_relu(t_relu), act.override_residual_add(t_add), torch.no_grad():
        model(nhwc(x))
    assert j_relu.calls + j_add.calls > 0
    assert (t_relu.calls, t_add.calls) == (j_relu.calls, j_add.calls)


def test_ebp_rule_reaches_the_ops_jax_patches(hook_case, monkeypatch):
    """One traced gradient per model under the EBP rules: the port's linear
    rule runs as often as JAX's ``_ebp_conv`` + ``_ebp_dot`` (a CondConv's
    per-sample conv is one conv in both; its expert mix an unhooked
    product in both), and its BatchNorm rule once per BatchNorm call."""
    jmodel, variables, model, x = hook_case
    j_conv = Counter(jax_excitation._ebp_conv)
    j_dot = Counter(jax_excitation._ebp_dot)
    monkeypatch.setattr(jax_excitation, "_ebp_conv", j_conv)
    monkeypatch.setattr(jax_excitation, "_ebp_dot", j_dot)
    j_bn = Counter(jax_excitation._straight_through)
    monkeypatch.setattr(jax_excitation, "_straight_through", j_bn)
    with jax_excitation.ebp_rules():
        jax.eval_shape(jax.grad(lambda v, xx: jmodel.apply(v, xx)[0, 1], argnums=1),
                       variables, jnp.asarray(x))
    t_lin = Counter(excitation._ebp_linear)
    t_bn = Counter(excitation._straight_through)
    monkeypatch.setattr(excitation, "_ebp_linear", t_lin)
    monkeypatch.setattr(excitation, "_straight_through", t_bn)
    xt = nhwc(x).requires_grad_(True)
    with excitation.ebp_rules():
        (g,) = torch.autograd.grad(model(xt)[0, 1], xt)
    assert j_conv.calls > 0
    assert t_lin.calls == j_conv.calls + j_dot.calls
    assert t_bn.calls == j_bn.calls
    assert torch.isfinite(g).all()


def test_hooks_route_the_plain_ops_bit_for_bit(hook_case):
    _, _, model, x = hook_case
    with torch.no_grad():
        want = model(nhwc(x))
        with act.override_relu(torch.relu), act.override_residual_add(torch.add):
            got = model(nhwc(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
