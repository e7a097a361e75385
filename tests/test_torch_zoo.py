"""The port's ResNet-family mechanisms against the JAX package on the CPU:
each block kind, attention, stem and stride option at reduced depth
(``layers=(1, 1, 1, 1)``) and 32-64 px in eval and train mode, the new layer
functions, the init of the new modules, and a slot model on a bottleneck
backbone through a train step.

Weights come from the port's init read into a JAX tree by the JAX
package's own converter (``test_torch_models.port_variables``; JAX's compiled init takes as
long as a case's forward), with numpy noise on BatchNorm statistics,
scales and biases (``test_torch_models.perturb``), and reach the port back
through ``variables_to_state_dict``."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu.models import layers as jax_layers
from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.models.resnet import ResNet as JaxResNet
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu.train.steps import make_train_step as jax_make_train_step
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.models import build_slot_model, create_model, layers
from scouter_tpu_torch.models import variables_to_state_dict
from scouter_tpu_torch.models.resnet import ResNet
from scouter_tpu_torch.train import create_train_state, make_train_step
from test_torch_models import FEATURE_TOL, flat, nhwc, perturb, port_variables

STATS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nchw_to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ----------------------------------------------------------- the mechanisms

_DEEP_D = dict(stem_type="deep", stem_width=32, avg_down=True)
MECHANISMS = {
    "bottleneck": (dict(block="bottleneck"), 64),
    "bottleneck_32x4d": (dict(block="bottleneck", cardinality=32, base_width=4), 64),
    "se_32x4d_d": (dict(block="bottleneck", cardinality=32, base_width=4, attn="se", **_DEEP_D),
                   64),
    "eca_bottleneck": (dict(block="bottleneck", attn="eca"), 64),
    "eca_basic": (dict(block="basic", attn="eca"), 32),
    "aa_bottleneck": (dict(block="bottleneck", aa=True), 64),
    "aa_basic": (dict(block="basic", aa=True), 40),
    "reduce_first_down_k3": (dict(block="bottleneck", cardinality=8, base_width=4,
                                  stem_type="deep", reduce_first=2, down_kernel_size=3,
                                  attn="se"), 64),
    "res2net_4s": (dict(block="res2net", base_width=26, scale=4), 64),
    "res2net_8s": (dict(block="res2net", base_width=14, scale=8), 48),
    "res2next": (dict(block="res2net", base_width=4, scale=4, cardinality=8), 48),
    "sk_basic_split": (dict(block="sk_basic", sk_min_attn_channels=16, sk_attn_reduction=8,
                            sk_split_input=True), 64),
    "sk_bottleneck_split": (dict(block="sk_bottleneck", sk_split_input=True), 64),
    "sk_bottleneck_32x4d": (dict(block="sk_bottleneck", cardinality=32, base_width=4), 48),
    "deep_tiered": (dict(block="bottleneck", cardinality=32, base_width=4, attn="se",
                         stem_width=32, stem_type="deep_tiered", avg_down=True), 64),
    "deep_tiered_narrow": (dict(block="bottleneck", cardinality=32, base_width=4, attn="eca",
                                stem_width=32, stem_type="deep_tiered_narrow",
                                avg_down=True), 64),
    "s2d_even": (dict(block="basic", s2d_stem=True), 32),
    "s2d_odd": (dict(block="basic", s2d_stem=True), 33),
    "s2d_deep_even": (dict(block="bottleneck", s2d_stem=True, **_DEEP_D), 48),
    "s2d_deep_odd": (dict(block="bottleneck", s2d_stem=True, **_DEEP_D), 45),
    "bottleneck_os16": (dict(block="bottleneck", output_stride=16), 64),
    "bottleneck_os8": (dict(block="bottleneck", output_stride=8), 64),
    "bottleneck_d_os8": (dict(block="bottleneck", output_stride=8, **_DEEP_D), 40),
    "resnest_os16": (dict(block="resnest", **_DEEP_D, output_stride=16), 64),
    "resnest_os8": (dict(block="resnest", **_DEEP_D, output_stride=8), 40),
}


# the extra cases beyond the issue's list run in test_torch_zoo_registry.py,
# so that --dist loadfile spreads the compiles over two workers
EXTRA_MECHANISMS = ("aa_basic", "bottleneck_d_os8", "eca_basic", "res2next", "s2d_deep_odd")


def mechanism_case(name):
    """A case's perturbed JAX variables and its outputs, eval and train,
    from one compiled program."""
    kw, size = MECHANISMS[name]
    kw = dict(layers=(1, 1, 1, 1), num_classes=5, **kw)
    jmodel = JaxResNet(**kw)
    variables = port_variables(ResNet(**kw))
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    want = jax.device_get(jax.jit(lambda v, x: (
        jmodel.apply(v, x, features_only=True), jmodel.apply(v, x),
        jmodel.apply(v, x, train=True, mutable=["batch_stats"])))(variables, x))
    return kw, variables, x, want


@pytest.fixture(scope="module",
                params=sorted(set(MECHANISMS) - set(EXTRA_MECHANISMS)))
def mechanism(request):
    return mechanism_case(request.param)


def port_model(kw, variables):
    model = ResNet(**kw)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    return model


def test_mechanism_eval_features_and_logits(mechanism):
    check_eval(mechanism)


def check_eval(case):
    kw, variables, x, (feats_j, logits_j, _) = case
    model = port_model(kw, variables).eval()
    with torch.no_grad():
        feats = model(nhwc(x), features_only=True)
        logits = model(nhwc(x))
    assert model.num_features == feats_j.shape[-1]
    np.testing.assert_allclose(nchw_to_nhwc(feats), np.asarray(feats_j), **FEATURE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)


STATS_F32_GAP = 3e-4  # the most a statistic may miss JAX's f32 reading


def jax_f64_running_stats(kw, variables, x, names):
    """The running statistics of JAX's own train-mode forward in float64."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        _, mutated = JaxResNet(**kw).apply(v64, x.astype(np.float64), train=True,
                                           mutable=["batch_stats"])
        return variables_to_state_dict({"batch_stats": jax.device_get(mutated["batch_stats"])},
                                       names)


def assert_statistic(name, g, w, f64_stat):
    """A running statistic ``g`` within 1e-5 of JAX's f32 reading ``w``, or,
    where it misses, within 1e-5 of JAX's float64 reading (``f64_stat()``,
    asked for only on a miss) or no further from it than JAX's f32 reading,
    and within ``STATS_F32_GAP`` of that f32 reading. Where JAX's f32
    reading itself lies further than ``STATS_F32_GAP`` from its float64
    one, it is no reference: the statistic is then held within
    ``STATS_F32_GAP`` of the float64 reading instead."""
    g, w = g.double(), w.double()
    if torch.allclose(g, w, **STATS_TOL):
        return
    r = f64_stat().double()
    assert (torch.allclose(g, r, **STATS_TOL)
            or (g - r).abs().max() <= (w - r).abs().max()), name
    ref = r if (w - r).abs().max() > STATS_F32_GAP else w
    assert (g - ref).abs().max() <= STATS_F32_GAP, name


def assert_running_stats(model, want, kw, variables, x):
    """Each running statistic held by ``assert_statistic``. flax takes the
    variance as E[x^2] - E[x]^2 in f32, which cancels where the mean is
    large against the spread: on the ResNeSt cases at output stride 16 and 8
    that puts JAX's f32 up to 2.3e-4 from its float64 reading on one host,
    where the port stays within 7.7e-6; on another, resnest_os16's and
    sk_basic_split's lie up to 8.3e-4 and 3.4e-4 from it, the port's 7.6e-6
    and 2.6e-5."""
    got = model.state_dict()
    f64 = functools.lru_cache(maxsize=None)(
        lambda: jax_f64_running_stats(kw, variables, x, got))
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            assert_statistic(name, got[name], w, lambda: f64()[name])


LOGITS_F32_GAP = 3e-3  # past FEATURE_TOL, the most train logits may miss JAX's f32 ones


def assert_train_logits(got, want, f64_logits):
    """Train-mode logits within ``FEATURE_TOL`` of JAX's f32 logits ``want``,
    or, where they miss, within ``FEATURE_TOL`` of JAX's own float64 run
    (``f64_logits()``, run only on a miss), no further from it than JAX's
    f32 logits are, and within ``FEATURE_TOL`` plus ``LOGITS_F32_GAP`` of
    those. flax takes the train-mode variance as E[x^2] - E[x]^2 in f32,
    which cancels, as for the running statistics (``assert_running_stats``):
    on resnest_os16 and sk_basic_split JAX's f32 logits lie 1.87e-3 and
    3.79e-3 from its float64 run, the port's 1.13e-5 and 3.06e-4, and the
    two 1.88e-3 and 4.10e-3 apart (6.3e-4 and 2.8e-3 past ``FEATURE_TOL``)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.allclose(g, w, **FEATURE_TOL):
        return
    r = np.asarray(f64_logits(), np.float64)
    np.testing.assert_allclose(g, r, **FEATURE_TOL)
    assert np.abs(g - r).max() <= np.abs(w - r).max()
    np.testing.assert_allclose(g, w, rtol=FEATURE_TOL["rtol"],
                               atol=FEATURE_TOL["atol"] + LOGITS_F32_GAP)


def jax_f64_logits(kw, variables, x):
    """The logits of JAX's own train-mode forward in float64."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        logits, _ = JaxResNet(**kw).apply(v64, x.astype(np.float64), train=True,
                                          mutable=["batch_stats"])
        return np.asarray(logits)


def test_mechanism_train_logits_and_running_stats(mechanism):
    check_train(mechanism)


def check_train(case):
    kw, variables, x, (_, _, (logits_j, mutated)) = case
    model = port_model(kw, variables).train()
    logits = model(nhwc(x))
    assert_train_logits(logits.detach().numpy(), logits_j,
                        lambda: jax_f64_logits(kw, variables, x))
    want = variables_to_state_dict({"batch_stats": mutated["batch_stats"]}, model.state_dict())
    assert_running_stats(model, want, kw, variables, x)


def test_stop_after_start_from_compose_to_the_whole_forward():
    kw = dict(block="bottleneck", layers=(1, 1, 1, 1), num_classes=5, attn="se", **_DEEP_D)
    jmodel = JaxResNet(**kw)
    variables = port_variables(ResNet(**kw))
    x = np.random.RandomState(3).randn(2, 48, 48, 3).astype(np.float32)
    model = port_model(kw, variables).eval()
    with torch.no_grad():
        whole = model(nhwc(x))
        for stage in ("layer1", "layer2", "layer3", "layer4"):
            mid = model(nhwc(x), stop_after=stage)
            want_mid = jmodel.apply(variables, x, stop_after=stage)
            np.testing.assert_allclose(nchw_to_nhwc(mid), np.asarray(want_mid), **FEATURE_TOL)
            torch.testing.assert_close(model(mid, start_from=stage), whole, rtol=1e-5,
                                       atol=1e-5)
        # a resumed slice that stops again
        mid = model(nhwc(x), stop_after="layer1")
        got = model(mid, start_from="layer1", stop_after="layer3")
        want = jmodel.apply(variables, jmodel.apply(variables, x, stop_after="layer1"),
                            start_from="layer1", stop_after="layer3")
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **FEATURE_TOL)


def test_sk_attention_batch_norm_at_batch_one_in_train_mode():
    """SK attention's BatchNorm sees (1, C, 1, 1) at batch 1: flax normalises
    with variance 0 and decays the running variance; F.batch_norm refuses."""
    kw = dict(block="sk_basic", layers=(1, 1, 1, 1), num_classes=5, sk_min_attn_channels=16,
              sk_attn_reduction=8, sk_split_input=True)
    jmodel = JaxResNet(**kw)
    variables = port_variables(ResNet(**kw))
    x = np.random.RandomState(6).randn(1, 32, 32, 3).astype(np.float32)
    logits_j, mutated = jmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    model = port_model(kw, variables).train()
    logits = model(nhwc(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **FEATURE_TOL)
    names = model.state_dict()
    want = variables_to_state_dict({"batch_stats": jax.device_get(mutated["batch_stats"])}, names)
    assert_running_stats(model, want, kw, variables, x)
    # at batch 1 the gate's variance is 0: the running variance decays by 0.9
    before = variables_to_state_dict(variables, names)["layer4.0.conv1.attn.bn.running_var"]
    torch.testing.assert_close(model.state_dict()["layer4.0.conv1.attn.bn.running_var"],
                               0.9 * before)


# ------------------------------------------------------------ layer functions

@pytest.mark.parametrize("hw", [(8, 8), (7, 5), (1, 3)])
@pytest.mark.parametrize("stride", [1, 2])
def test_blur_pool(hw, stride):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = jax_layers.blur_pool(jnp.asarray(x), stride=stride)
    got = layers.blur_pool(nhwc(x), stride=stride)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hw", [(8, 8), (7, 5), (1, 3)])
@pytest.mark.parametrize("window,stride", [(2, 1), (2, 2), (3, 2)])
def test_avg_pool_same_zero_pad(hw, window, stride):
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    want = jax_layers.avg_pool_same_zero_pad(jnp.asarray(x), window, stride)
    got = layers.avg_pool_same_zero_pad(nhwc(x), window, stride)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def _gate_case(jmod, tmod, channels):
    x = np.random.RandomState(7).randn(3, 5, 4, channels).astype(np.float32)
    variables = perturb(jmod.init(jax.random.PRNGKey(0), x), seed=8)
    want = jmod.apply(variables, x)
    tmod.load_state_dict(variables_to_state_dict(variables, tmod.state_dict()))
    with torch.no_grad():
        got = tmod(nhwc(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("channels", [24, 256])
def test_squeeze_excite(channels):
    _gate_case(jax_layers.SqueezeExcite(channels), layers.SqueezeExcite(channels), channels)


@pytest.mark.parametrize("channels", [16, 64, 2048])
def test_eca(channels):
    tmod = layers.Eca(channels)
    _gate_case(jax_layers.Eca(channels), tmod, channels)
    assert tmod.conv.kernel_size[0] == layers.eca_kernel_size(channels)


@pytest.mark.parametrize("fn", ["drop_path", "head_dropout"])
def test_dropout_statistics_and_determinism(fn):
    """Their RNG cannot match JAX's: the kept share, the 1/(1 - rate)
    scale, one generator's determinism and the eval identity are held."""
    rate = 0.3
    x = torch.ones(4000, 8) if fn == "drop_path" else torch.ones(200, 400)

    def run(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        if fn == "drop_path":
            return layers.drop_path(x, rate, g, train)
        return layers.head_dropout(x, rate, train, g)

    y = run(0)
    kept = (y != 0).float()
    if fn == "drop_path":
        assert bool((kept == kept[:, :1]).all())  # whole samples are kept or dropped
    assert abs(kept.mean().item() - (1 - rate)) < 0.02
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))
    assert torch.equal(run(0), y) and not torch.equal(run(1), y)
    assert torch.equal(run(0, train=False), x)
    assert torch.equal(layers.drop_path(x, rate, None, True), x)  # no generator: identity
