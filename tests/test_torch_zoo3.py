"""The port's last backbone slice against the JAX package on the CPU: TResNet,
DPN and SelecSLS at narrow or shallow configurations, Inception-V3's and
Inception-V4's blocks one by one and each network whole at its minimum size
(75 px), in eval and train mode.

Each case builds the JAX package's module and the port's from the same
arguments (the port's also from its input widths, which flax infers). The
weights are the port's init read into a JAX tree by the JAX package's own
converter (``torch_state_dict_to_variables``; JAX's init compiles for
seconds a case), with numpy noise on the BatchNorm statistics, scales and
biases (``test_torch_models.perturb``), carried back by
``variables_to_state_dict`` with the port's own names. JAX's eval and
train outputs come from one compiled program a case. Eval features and
logits (a block's output) within ``FEATURE_TOL``; train outputs held by
``test_torch_zoo.assert_train_logits`` and the running statistics by
``test_torch_zoo.assert_statistic``, each falling back to JAX's own
float64 run where JAX's f32 reading misses. The other families run in
``test_torch_zoo3_families.py``, so that ``--dist loadfile`` spreads the
compiles over the workers."""

import functools

import jax
import numpy as np
import pytest
import torch

from scouter_tpu.models import dpn as jax_dpn
from scouter_tpu.models import inception_v3 as jax_v3
from scouter_tpu.models import inception_v4 as jax_v4
from scouter_tpu.models import selecsls as jax_selecsls
from scouter_tpu.models import tresnet as jax_tresnet
from scouter_tpu_torch.models import dpn, inception_v3 as v3, inception_v4 as v4
from scouter_tpu_torch.models import selecsls, tresnet, variables_to_state_dict
from test_torch_models import FEATURE_TOL, nhwc, port_variables
from test_torch_zoo import assert_statistic, assert_train_logits, nchw_to_nhwc


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


# ------------------------------------------------------------ the machinery

class Case:
    """The JAX package's module and the port's (``jax_ctor()``,
    ``port_ctor()``) and the NHWC shapes of its inputs. A network (``net``)
    is run for its features and its logits; a block or cell for its one
    output, on one input or two (a NASNet cell's x and x_prev)."""

    def __init__(self, jax_ctor, port_ctor, *shapes, net=False):
        self.jax, self.port, self.shapes, self.net = jax_ctor, port_ctor, shapes, net


def net(jax_cls, port_cls, size, batch=2, **kw):
    kw = dict(num_classes=5, **kw)
    return Case(lambda: jax_cls(**kw), lambda: port_cls(**kw), (batch, size, size, 3), net=True)


def port_names(model):
    """The port's state-dict keys, which ``variables_to_state_dict`` resolves
    the flax names against."""
    return model.state_dict().keys()


def run_case(case: Case, seed: int = 0):
    """The perturbed variables, the inputs and JAX's outputs, eval and train,
    from one compiled program."""
    jmod = case.jax()
    variables = port_variables(case.port(), seed)
    rng = np.random.RandomState(2)
    xs = [rng.randn(*s).astype(np.float32) for s in case.shapes]
    if case.net:
        def fn(v, x):
            return (jmod.apply(v, x, features_only=True), jmod.apply(v, x),
                    jmod.apply(v, x, train=True, mutable=["batch_stats"]))
    else:
        def fn(v, *xs):
            return (jmod.apply(v, *xs), None,
                    jmod.apply(v, *xs, train=True, mutable=["batch_stats"]))
    want = jax.device_get(jax.jit(fn)(variables, *xs))
    return case, variables, xs, want


def port_module(case, variables):
    model = case.port()
    model.load_state_dict(variables_to_state_dict(variables, port_names(model)))
    return model


def check_eval(run):
    case, variables, xs, (out_j, logits_j, _) = run
    model = port_module(case, variables).eval()
    tol = dict(FEATURE_TOL)
    with torch.no_grad():
        if case.net:
            feats = model(nhwc(xs[0]), features_only=True)
            logits = model(nhwc(xs[0]))
            assert model.num_features == out_j.shape[-1]
            np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)
            # a whole random network's eval features reach 1e4 (PNASNet's),
            # where f32 rounding alone moves a small element by 1e-2: held to
            # 1e-3 of their scale, max(1, max|JAX|), as chip_smoke.py holds
            # the zoo's card against the CPU
            tol["atol"] *= max(1.0, float(np.abs(out_j).max()))
        else:
            feats = model(*(nhwc(x) for x in xs))
    np.testing.assert_allclose(nchw_to_nhwc(feats), np.asarray(out_j), **tol)


def jax_f64_train(case, variables, xs, names):
    """JAX's own train-mode forward in float64: the output (NCHW for a
    block, as the port's) and the running statistics as a state dict."""
    jmod = case.jax()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        out, mutated = jax.device_get(jax.jit(lambda v, *xs: jmod.apply(
            v, *xs, train=True, mutable=["batch_stats"]))(v64, *(x.astype(np.float64)
                                                                for x in xs)))
    out = np.asarray(out)
    if out.ndim == 4:
        out = out.transpose(0, 3, 1, 2)
    return out, variables_to_state_dict({"batch_stats": mutated["batch_stats"]}, names)


def check_train(run):
    """The train-mode output held by ``test_torch_zoo.assert_train_logits``,
    each running statistic by ``test_torch_zoo.assert_statistic``."""
    case, variables, xs, (_, _, (out_j, mutated)) = run
    model = port_module(case, variables).train()
    out = model(*(nhwc(x) for x in xs)).detach().numpy()
    out_j = np.asarray(out_j)
    if out_j.ndim == 4:
        out_j = out_j.transpose(0, 3, 1, 2)
    names = port_names(model)
    f64 = functools.lru_cache(maxsize=None)(lambda: jax_f64_train(case, variables, xs, names))
    assert_train_logits(out, out_j, lambda: f64()[0])
    want = variables_to_state_dict({"batch_stats": mutated["batch_stats"]}, names)
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            assert_statistic(name, got[name], w, lambda: f64()[1][name])


# ------------------------------------------------------------ the cases

def block(jax_ctor, port_ctor, *shapes):
    return Case(jax_ctor, port_ctor, *shapes)


CASES = {
    # basic blocks with and without the pooled downsample, bottlenecks with
    # SE and without (layer4), the blur on odd maps (72 px: 18, 9, 5, 3)
    "tresnet": net(jax_tresnet.TResNet, tresnet.TResNet, 72, layers=(1, 1, 2, 1),
                   width_factor=0.25),
    # the 3x3 stem, 'proj' and 'down' projections, grouped 3x3s, a normal
    # block's dense growth, ELU at the end
    "dpn_small": net(jax_dpn.DPN, dpn.DPN, 64, small=True, num_init_features=8, k_r=16,
                     groups=4, k_sec=(1, 2, 1, 1), inc_sec=(4, 8, 4, 8)),
    # the 7x7 stem and the 'b' split of c1x1_c
    "dpn_b_7x7": net(jax_dpn.DPN, dpn.DPN, 64, small=False, b=True, num_init_features=16,
                     k_r=16, groups=4, k_sec=(1, 1, 1, 1), inc_sec=(4, 4, 4, 4)),
    # first and skip-lane blocks, 3x3 and 1x1 head convs; 128 px leaves 2 x 2
    "selecsls42b": net(jax_selecsls.SelecSLS, selecsls.SelecSLS, 128, variant="selecsls42b"),
    "v3_inception_a": block(lambda: jax_v3._InceptionA(32), lambda: v3._InceptionA(192, 32),
                            (2, 7, 7, 192)),
    # odd maps through the VALID stride-2 convs and pool
    "v3_inception_b": block(jax_v3._InceptionB, lambda: v3._InceptionB(288), (2, 9, 9, 288)),
    "v3_inception_c": block(lambda: jax_v3._InceptionC(128), lambda: v3._InceptionC(768, 128),
                            (2, 7, 7, 768)),
    "v3_inception_d": block(jax_v3._InceptionD, lambda: v3._InceptionD(768), (2, 9, 9, 768)),
    "v3_inception_e": block(jax_v3._InceptionE, lambda: v3._InceptionE(1280), (2, 5, 5, 1280)),
    # the whole networks at the smallest sizes whose train-mode forward in f32
    # holds to 3e-4 of float64 (at 75 px the last maps are 1 x 1, the
    # BatchNorms see two values a channel, and f32 lies 2e-2 (V3) and 0.97
    # (V4) from float64); V3 on one image, so JAX's float64 run stays short
    "inception_v3": net(jax_v3.InceptionV3, v3.InceptionV3, 107, batch=1),
    "v4_mixed_3a": block(jax_v4._Mixed3a, v4._Mixed3a, (2, 11, 11, 64)),
    "v4_mixed_4a": block(jax_v4._Mixed4a, v4._Mixed4a, (2, 9, 9, 160)),
    "v4_mixed_5a": block(jax_v4._Mixed5a, v4._Mixed5a, (2, 9, 9, 192)),
    # the exclude-pad average pool branch on a map with edges
    "v4_inception_a": block(jax_v4._InceptionA, v4._InceptionA, (2, 5, 5, 384)),
    "v4_reduction_a": block(jax_v4._ReductionA, v4._ReductionA, (2, 9, 9, 384)),
    "v4_inception_b": block(jax_v4._InceptionB, v4._InceptionB, (2, 5, 5, 1024)),
    "v4_reduction_b": block(jax_v4._ReductionB, v4._ReductionB, (2, 9, 9, 1024)),
    "v4_inception_c": block(jax_v4._InceptionC, v4._InceptionC, (2, 3, 3, 1536)),
    "inception_v4": net(jax_v4.InceptionV4, v4.InceptionV4, 171),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case_run(request):
    return run_case(CASES[request.param])


def test_eval_features_and_logits(case_run):
    check_eval(case_run)


def test_train_outputs_and_running_stats(case_run):
    check_train(case_run)


# ------------------------------------------------------------ layer functions

@pytest.mark.parametrize("hw", [(8, 12), (16, 4)])
def test_space_to_depth_keeps_torch_channel_order(hw):
    """The (bs, bs, C) channel order of the JAX package's NHWC
    ``space_to_depth``, so the 16C stem conv reads its kernel."""
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_tresnet.space_to_depth(x))
    np.testing.assert_array_equal(nchw_to_nhwc(tresnet.space_to_depth(nhwc(x))), want)


@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (1, 3)])
def test_aa_downsample_matches_jax(hw):
    """``layers.blur_pool`` at stride 2 is TResNet's reflect-padded [1, 2, 1]^2
    blur."""
    x = np.random.RandomState(1).randn(2, *hw, 4).astype(np.float32)
    want = np.asarray(jax_tresnet.aa_downsample(x))
    got = nchw_to_nhwc(tresnet.aa_downsample(nhwc(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
