"""The port's activation and layer hooks (``models/act.py``) against the JAX
package's on the CPU: in one forward of each zoo mechanism, the ReLU
override, the residual-add override and excitation backprop's linear rule
are called as many times as JAX calls its own (``act.relu``,
``act.residual_add``, the patched ``conv_general_dilated``/``dot_general``);
outside an override the hooks leave a forward's bits alone; the modified
ReLU backwards match JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.explain import excitation as jax_excitation
from scouter_tpu.models import act as jax_act
from scouter_tpu.models.resnet import ResNet as JaxResNet
from scouter_tpu_torch.explain import excitation
from scouter_tpu_torch.models import act
from scouter_tpu_torch.models.resnet import ResNet
from test_torch_models import nhwc
from test_torch_zoo import MECHANISMS

# one case per mechanism the hooks reach: basic, bottleneck, SE/ECA,
# split attention, Res2Net, SK, blur, the deep and tiered stems, s2d stems
COUNT_CASES = {
    "basic": (dict(block="basic"), 32),
    "bottleneck": MECHANISMS["bottleneck"],
    "se_32x4d_d": MECHANISMS["se_32x4d_d"],
    "eca_bottleneck": MECHANISMS["eca_bottleneck"],
    "resnest": (dict(block="resnest", stem_type="deep", stem_width=32, avg_down=True), 48),
    "res2net_4s": MECHANISMS["res2net_4s"],
    "sk_basic_split": MECHANISMS["sk_basic_split"],
    "sk_bottleneck_split": MECHANISMS["sk_bottleneck_split"],
    "aa_bottleneck": MECHANISMS["aa_bottleneck"],
    "aa_basic": MECHANISMS["aa_basic"],
    "deep_tiered": MECHANISMS["deep_tiered"],
    "deep_tiered_narrow": MECHANISMS["deep_tiered_narrow"],
    "s2d_even": MECHANISMS["s2d_even"],
    "s2d_deep_odd": MECHANISMS["s2d_deep_odd"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Counter:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.fixture(scope="module", params=sorted(COUNT_CASES))
def case(request):
    """JAX's model with abstract variables (the counts come from tracing
    alone) and the port's with its own init."""
    kw, size = COUNT_CASES[request.param]
    kw = dict(layers=(1, 1, 1, 1), num_classes=3, **kw)
    jmodel = JaxResNet(**kw)
    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    torch.manual_seed(0)
    model = ResNet(**kw).eval()
    return jmodel, variables, model, x


def test_relu_and_residual_add_hooks_are_called_as_in_jax(case):
    jmodel, variables, model, x = case
    j_relu, j_add = Counter(jax.nn.relu), Counter(lambda a, b: a + b)
    with jax_act.override_relu(j_relu), jax_act.override_residual_add(j_add):
        jax.eval_shape(jmodel.apply, variables, jnp.asarray(x))
    t_relu, t_add = Counter(torch.relu), Counter(torch.add)
    with act.override_relu(t_relu), act.override_residual_add(t_add), torch.no_grad():
        model(nhwc(x))
    assert j_relu.calls > 0 and j_add.calls > 0
    assert (t_relu.calls, t_add.calls) == (j_relu.calls, j_add.calls)


def test_ebp_rule_reaches_the_ops_jax_patches(case, monkeypatch):
    """One traced gradient per model under the EBP rules: the port's
    linear rule runs as often as JAX's ``_ebp_conv`` + ``_ebp_dot``, and its
    BatchNorm rule once per BatchNorm."""
    jmodel, variables, model, x = case
    j_conv = Counter(jax_excitation._ebp_conv)
    j_dot = Counter(jax_excitation._ebp_dot)
    monkeypatch.setattr(jax_excitation, "_ebp_conv", j_conv)
    monkeypatch.setattr(jax_excitation, "_ebp_dot", j_dot)
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
    assert j_conv.calls > 0 and j_dot.calls == 1
    assert t_lin.calls == j_conv.calls + j_dot.calls
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert t_bn.calls == n_bn
    assert torch.isfinite(g).all()


def test_hooks_route_the_plain_ops_bit_for_bit(case):
    """With the plain ops installed as overrides the forward's bits are the
    hook-free forward's: the hooks compute what they wrap."""
    _, _, model, x = case
    with torch.no_grad():
        want = model(nhwc(x))
        with act.override_relu(torch.relu), act.override_residual_add(torch.add):
            got = model(nhwc(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["deconvnet", "guided"])
def test_modified_relu_backwards_match_jax(kind):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 7).astype(np.float32)
    g = rng.randn(4, 7).astype(np.float32)
    jfn = {"deconvnet": jax_act.deconvnet_relu, "guided": jax_act.guided_relu}[kind]
    tfn = {"deconvnet": act.deconvnet_relu, "guided": act.guided_relu}[kind]
    out, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overrides_are_scoped():
    assert act._RELU_OVERRIDE is None and act._LINEAR_OVERRIDE is None
    with pytest.raises(RuntimeError):
        with excitation.ebp_rules():
            assert act._LINEAR_OVERRIDE is not None and act._NORM_OVERRIDE is not None
            raise RuntimeError
    assert (act._RELU_OVERRIDE, act._ADD_OVERRIDE, act._LINEAR_OVERRIDE,
            act._NORM_OVERRIDE) == (None, None, None, None)
