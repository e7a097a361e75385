"""The port's second backbone slice against the JAX package on the CPU: one
small case per mechanism of the EfficientNet/MobileNet superfamily, RegNet,
DLA, VoVNet, DenseNet, HRNet and the legacy SENet, in eval and train mode,
the ResNet blocks with each attention kind of ``extra_layers.create_attn``,
and the ``extra_layers`` functions themselves.

Each case builds the JAX family's module and the port's from the same
arguments at small widths and 32-64 px (a final map of at least 2 x 2, so
that train mode's BatchNorm sees more than the batch). The weights are the
port's init read into a JAX tree by the JAX package's own converter
(``torch_state_dict_to_variables``; JAX's init compiles for seconds a
case), with numpy noise on the BatchNorm statistics, scales and biases
(``test_torch_models.perturb``), and carried back by
``variables_to_state_dict``; the registry tests hold each family's tree to
``jax.eval_shape`` of JAX's init. Eval features and logits within
``FEATURE_TOL``, train-mode logits too, and the running statistics held as
``test_torch_zoo.assert_running_stats`` holds the ResNet zoo's. The
families other than the EfficientNet superfamily and the ResNet blocks run
in ``test_torch_zoo2_families.py``, so that ``--dist loadfile`` spreads the
compiles over two workers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.models import densenet as jax_densenet
from scouter_tpu.models import dla as jax_dla
from scouter_tpu.models import efficientnet as jax_eff
from scouter_tpu.models import extra_layers as jax_extra
from scouter_tpu.models import hrnet as jax_hrnet
from scouter_tpu.models import regnet as jax_regnet
from scouter_tpu.models import senet as jax_senet
from scouter_tpu.models import vovnet as jax_vovnet
from scouter_tpu.models.resnet import ResNet as JaxResNet
from scouter_tpu_torch.models import densenet, dla, efficientnet as eff, extra_layers
from scouter_tpu_torch.models import hrnet, regnet, senet
from scouter_tpu_torch.models import variables_to_state_dict, vovnet
from scouter_tpu_torch.models.resnet import ResNet
from test_torch_models import FEATURE_TOL, nhwc, perturb, port_variables
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


# ------------------------------------------------------------ the mechanisms

class Family:
    """A pair of constructors, the JAX package's and the port's, that take
    the same keyword arguments."""

    def __init__(self, jax_ctor, port_ctor):
        self.jax, self.port = jax_ctor, port_ctor


def _eff_family(jax_cls, port_cls):
    """EfficientNet/MobileNetV3 shells over block strings, each package
    decoding them with its own ``decode_arch_def``."""
    def build(decode, cls):
        def ctor(arch, decode_kw=None, **kw):
            return cls(arch=decode(arch, **(decode_kw or {})), **kw)
        return ctor
    return Family(build(jax_eff.decode_arch_def, jax_cls),
                  build(eff.decode_arch_def, port_cls))


EFF = _eff_family(jax_eff.EfficientNet, eff.EfficientNet)
MBV3 = _eff_family(jax_eff.MobileNetV3, eff.MobileNetV3)
REGNET = Family(jax_regnet.RegNet, regnet.RegNet)
DLA = Family(jax_dla.DLA, dla.DLA)
VOV = Family(jax_vovnet.VovNet, vovnet.VovNet)
DENSE = Family(jax_densenet.DenseNet, densenet.DenseNet)
HRNET = Family(jax_hrnet.HighResolutionNet, hrnet.HighResolutionNet)
SENET = Family(jax_senet.SENet, senet.SENet)
RESNET = Family(JaxResNet, ResNet)

_EFF_KW = dict(stem_size=16, num_features=32)
_TINY_HR = (
    ("STEM_WIDTH", 16),
    ("STAGE1", jax_hrnet._stage(1, 1, "BOTTLENECK", (1,), (8,))),
    ("STAGE2", jax_hrnet._stage(1, 2, "BASIC", (1, 1), (4, 8))),
    ("STAGE3", jax_hrnet._stage(1, 3, "BASIC", (1, 1, 1), (4, 8, 16))),
    ("STAGE4", jax_hrnet._stage(1, 4, "BASIC", (1, 1, 1, 1), (4, 8, 16, 32))),
)
_VOV_KW = dict(stem_chs=(8, 8, 16), stage_conv_chs=(8, 8, 16, 16),
               stage_out_chs=(16, 24, 24, 32), layer_per_block=2, block_per_stage=(1, 1, 2, 1))
_DLA_KW = dict(levels=(1, 1, 1, 1, 1, 1), channels=(8, 8, 16, 32, 32, 64))

MECHANISMS = {
    # DS and IR blocks, SE from the block input, swish, residual skips
    "ds_ir_se": (EFF, dict(arch=(("ds_r1_k3_s1_e1_c16_se0.25",),
                                 ("ir_r2_k3_s2_e3_c24_se0.25",)), act="swish", **_EFF_KW), 32),
    # ER blocks (fake_in, a strided pointwise-linear conv, noskip) and a CN block
    "er_cn": (EFF, dict(arch=(("er_r1_k3_s1_e4_c16_fc16_noskip",), ("er_r2_k3_s2_e4_c24",),
                              ("cn_r1_k1_s1_c32",)), act="relu", **_EFF_KW), 32),
    # MixedConv: three dw kernels over 16 channels (6, 5, 5: the first split
    # takes the remainder), grouped 1x1s (a1.1 / p1.1)
    "mixed_conv": (EFF, dict(arch=(("ir_r1_k3.5.7_a1.1_p1.1_s1_e1_c16_se0.5_nsw",),
                                   ("ir_r2_k3.5_a1.1_p1.1_s2_e3_c24",)), act="relu",
                             **_EFF_KW), 32),
    # CondConv: all three convs routed, in a repeated stage (its skip)
    "condconv": (EFF, dict(arch=(("ds_r1_k3_s1_e1_c16",), ("ir_r2_k3_s2_e3_c24_se0.25_cc4",)),
                           act="swish", **_EFF_KW), 32),
    # the tf_ twin: TF SAME padding (odd input, so it pads unevenly) and eps 1e-3
    "same_pad": (EFF, dict(arch=(("ds_r1_k3_s1_e1_c16_se0.25",), ("ir_r2_k5_s2_e3_c24",)),
                           act="swish", pad="same", bn_eps=1e-3, **_EFF_KW), 37),
    # MobileNetV3: hard-swish, SE from mid with divisor 8, a relu SE act and
    # a hard-sigmoid gate, 'nre' overrides, the head conv after the pool
    "mbv3_hard": (MBV3, dict(arch=(("ds_r1_k3_s2_e1_c16_se0.25_nre",),
                                   ("ir_r1_k5_s2_e4_c24_se0.25", "ir_r1_k3_s1_e3_c24_nre"),
                                   ("cn_r1_k1_s1_c48",)),
                             decode_kw=dict(se_overrides=jax_eff._SE_MBV3), stem_size=16,
                             num_features=64, act="hard_swish"), 32),
    # the ResNet blocks with each attention kind create_attn adds
    **{f"resnet_{k}": (RESNET, dict(block="basic" if k != "cbam" else "bottleneck",
                                    layers=(1, 1, 1, 1), attn=k), 64)
       for k in ("ese", "ceca", "cbam", "lcbam")},
    "regnet_x": (REGNET, dict(w0=8, wa=8.0, wm=2.0, depth=4, group_w=8, stem_width=8), 64),
    "regnet_y": (REGNET, dict(w0=8, wa=8.0, wm=2.0, depth=4, group_w=8, stem_width=8,
                              se_ratio=0.25), 64),
    "dla_basic": (DLA, dict(block="basic", **_DLA_KW), 64),
    # a tree of two levels (its children reach the root), a residual root
    "dla_x_residual_root": (DLA, dict(block="bottleneck", cardinality=4, base_width=8,
                                      residual_root=True, levels=(1, 1, 1, 2, 1, 1),
                                      channels=_DLA_KW["channels"]), 64),
    "dla_res2net": (DLA, dict(block="bottle2neck", cardinality=2, base_width=16, **_DLA_KW),
                    64),
    "vovnet_ese_residual": (VOV, dict(**_VOV_KW), 64),
    "vovnet_eca_dw": (VOV, dict(attn="eca", depthwise=True, residual=False, **_VOV_KW), 64),
    "vovnet_evos": (VOV, dict(norm="evos", **_VOV_KW), 64),
    "vovnet_iabn": (VOV, dict(norm="iabn", **_VOV_KW), 64),
    "densenet": (DENSE, dict(growth_rate=8, block_config=(2, 2, 2), bn_size=2), 64),
    "densenet_blur_deep": (DENSE, dict(growth_rate=8, block_config=(2, 2), bn_size=2,
                                       stem_type="deep", aa=True), 37),
    "densenet_iabn_tiered": (DENSE, dict(growth_rate=8, block_config=(2, 2), bn_size=2,
                                         stem_type="deep_tiered", norm="iabn"), 32),
    "hrnet_fuse": (HRNET, dict(cfg=_TINY_HR), 64),
    # senet154's block kind and its 3-conv stem, 3x3 projections, an odd size
    # for the ceil-mode pools
    "senet_3conv_stem": (SENET, dict(block_kind="senet154", layers=(1, 1, 1, 1), groups=8,
                                     inplanes=32, input_3x3=True, down_kernel=3,
                                     down_padding=1), 39),
}

# the cases of the other families, run by test_torch_zoo2_families.py
FAMILY_MECHANISMS = tuple(n for n, (f, _, _) in MECHANISMS.items()
                          if f not in (EFF, MBV3, RESNET))


def mechanism_case(name, seed=0):
    """A case's perturbed variables and JAX's outputs, eval and train, from
    one compiled program."""
    family, kw, size = MECHANISMS[name]
    kw = dict(num_classes=5, **kw)
    jmodel = family.jax(**kw)
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    variables = port_variables(family.port(**kw), seed)
    want = jax.device_get(jax.jit(lambda v, x: (
        jmodel.apply(v, x, features_only=True), jmodel.apply(v, x),
        jmodel.apply(v, x, train=True, mutable=["batch_stats"])))(variables, x))
    return family, kw, variables, x, want


def port_model(family, kw, variables):
    model = family.port(**kw)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    return model


@pytest.fixture(scope="module", params=sorted(set(MECHANISMS) - set(FAMILY_MECHANISMS)))
def mechanism(request):
    return mechanism_case(request.param)


def test_mechanism_eval_features_and_logits(mechanism):
    check_eval(mechanism)


def check_eval(case):
    family, kw, variables, x, (feats_j, logits_j, _) = case
    model = port_model(family, kw, variables).eval()
    with torch.no_grad():
        feats = model(nhwc(x), features_only=True)
        logits = model(nhwc(x))
    assert model.num_features == feats_j.shape[-1]
    np.testing.assert_allclose(nchw_to_nhwc(feats), np.asarray(feats_j), **FEATURE_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **FEATURE_TOL)


def jax_f64_running_stats(family, kw, variables, x, names):
    """The running statistics of JAX's own train-mode forward in float64."""
    jmodel = family.jax(**kw)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        _, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=[
            "batch_stats"]))(v64, x.astype(np.float64))
        return variables_to_state_dict({"batch_stats": jax.device_get(mutated["batch_stats"])},
                                       names)


def jax_f64_logits(family, kw, variables, x):
    """The logits of JAX's own train-mode forward in float64."""
    jmodel = family.jax(**kw)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        logits, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=[
            "batch_stats"]))(v64, x.astype(np.float64))
        return np.asarray(logits)


def test_mechanism_train_logits_and_running_stats(mechanism):
    check_train(mechanism)


def check_train(case):
    """The logits held by ``test_torch_zoo.assert_train_logits``, each
    running statistic by ``test_torch_zoo.assert_statistic``."""
    family, kw, variables, x, (_, _, (logits_j, mutated)) = case
    model = port_model(family, kw, variables).train()
    logits = model(nhwc(x))
    assert_train_logits(logits.detach().numpy(), logits_j,
                        lambda: jax_f64_logits(family, kw, variables, x))
    # EvoNorm keeps no statistics: an all-EvoNorm model has no batch_stats
    got = model.state_dict()
    want = variables_to_state_dict({"batch_stats": mutated.get("batch_stats", {})}, got)
    f64 = functools.lru_cache(maxsize=None)(
        lambda: jax_f64_running_stats(family, kw, variables, x, got))
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            assert_statistic(name, got[name], w, lambda: f64()[name])


def test_split_channels_gives_the_first_split_the_remainder():
    assert eff._split_channels(16, 3) == jax_eff._split_channels(16, 3) == [6, 5, 5]
    convs = eff._create_conv(16, 16, (3, 5, 7), depthwise=True)
    assert [c.kernel_size[0] for c in convs.values()] == [3, 5, 7]
    assert [c.groups for c in convs.values()] == [6, 5, 5]


@pytest.mark.parametrize("arch", [jax_eff._EFFNET_ARCH, jax_eff._MIXNET_M_ARCH,
                                  jax_eff._MBV3_LARGE_ARCH, jax_eff._EDGE_ARCH,
                                  jax_eff._CONDCONV_ARCH, jax_eff._FBNETC_ARCH])
@pytest.mark.parametrize("kw", [dict(), dict(depth_multiplier=3.1),
                                dict(depth_multiplier=1.2, depth_trunc="round"),
                                dict(depth_multiplier=1.4, fix_first_last=True,
                                     experts_multiplier=2, se_overrides=jax_eff._SE_MBV3)])
def test_decode_arch_def_matches_jax(arch, kw):
    """The port's copy of the block-string decoder and its repeat scaling
    gives JAX's specs field for field."""
    got = eff.decode_arch_def(arch, **kw)
    want = jax_eff.decode_arch_def(arch, **kw)
    assert [[dataclass_fields(s) for s in st] for st in got] == \
        [[dataclass_fields(s) for s in st] for st in want]


def dataclass_fields(spec):
    import dataclasses

    return dataclasses.asdict(spec)


@pytest.mark.parametrize("v", [3.0, 7.9, 12.0, 30.4, 100.0, 1280 * 1.1, 4.3 * 32])
@pytest.mark.parametrize("divisor", [1, 8])
def test_make_divisible_and_round_channels_match_jax(v, divisor):
    assert eff.make_divisible(v, divisor) == jax_eff.make_divisible(v, divisor)
    assert eff.round_channels(v, 1.4, divisor) == jax_eff.round_channels(v, 1.4, divisor)


def test_activations_match_jax():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    for name in ("swish", "hard_swish", "hard_sigmoid"):
        got = getattr(eff, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jax_eff, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    for name in ("relu", "relu6"):
        got = eff._ACTS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_eff._ACTS[name](jnp.asarray(x))))


# ----------------------------------------------------------- the extra layers

def _layer_case(jmod, tmod, x_nhwc, tol=dict(rtol=1e-5, atol=1e-6), **apply_kw):
    variables = perturb(jmod.init(jax.random.PRNGKey(0), x_nhwc, **apply_kw), seed=8)
    want = jmod.apply(variables, x_nhwc, **apply_kw)
    tmod.load_state_dict(variables_to_state_dict(variables, tmod.state_dict()))
    with torch.no_grad():
        got = tmod(nhwc(x_nhwc))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), **tol)


@pytest.mark.parametrize("light", [False, True])
def test_cbam_matches_jax(light):
    x = np.random.RandomState(0).randn(2, 10, 10, 32).astype(np.float32)
    jcls = jax_extra.LightCbamModule if light else jax_extra.CbamModule
    tcls = extra_layers.LightCbamModule if light else extra_layers.CbamModule
    _layer_case(jcls(32), tcls(32).eval(), x, tol=dict(rtol=1e-4, atol=1e-5))


def test_ceca_matches_jax():
    x = np.random.RandomState(1).randn(2, 6, 6, 64).astype(np.float32)
    _layer_case(jax_extra.Ceca(64), extra_layers.Ceca(64), x, tol=dict(rtol=1e-4, atol=1e-6))


@pytest.mark.parametrize("kwargs", [
    dict(kernel_size=3, stride=1, padding=1),
    dict(kernel_size=3, stride=2, same=True),
    dict(kernel_size=5, stride=1, same=True),
    dict(kernel_size=2, stride=1, padding=(0, 1, 1, 0)),
])
def test_median_pool2d_matches_jax(kwargs):
    x = np.random.RandomState(2).randn(1, 9, 11, 3).astype(np.float32)
    want = jax_extra.median_pool2d(jnp.asarray(x), **kwargs)
    got = extra_layers.median_pool2d(nhwc(x), **kwargs)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_split_batch_norm_train_and_eval_match_jax():
    x = np.random.RandomState(3).randn(4, 5, 5, 8).astype(np.float32)
    jmod = jax_extra.SplitBatchNorm(num_splits=2)
    variables = perturb(jmod.init(jax.random.PRNGKey(0), x, train=True), seed=4)
    got_train, got_eval = [], []
    tmod = extra_layers.SplitBatchNorm(8, num_splits=2)
    tmod.load_state_dict(variables_to_state_dict(variables, tmod.state_dict()))
    want_train, mutated = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    got_train = tmod.train()(nhwc(x))
    np.testing.assert_allclose(nchw_to_nhwc(got_train.detach()), np.asarray(want_train),
                               rtol=1e-4, atol=1e-5)
    stats = variables_to_state_dict({"batch_stats": jax.device_get(mutated["batch_stats"])},
                                    tmod.state_dict())
    for name, t in stats.items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(tmod.state_dict()[name], t, rtol=1e-5, atol=1e-6,
                                       msg=name)
    # eval: the main BatchNorm alone, on the statistics the train step left
    v_eval = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    want_eval = jmod.apply(v_eval, x, train=False)
    with torch.no_grad():
        got_eval = tmod.eval()(nhwc(x))
    np.testing.assert_allclose(nchw_to_nhwc(got_eval), np.asarray(want_eval), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tmod.train()(nhwc(x[:3]))


def test_test_time_pool_matches_jax():
    from scouter_tpu.models import create_model as jax_create_model
    from scouter_tpu_torch.models import create_model

    jmodel = jax_create_model("resnet10", num_classes=6)
    x = np.random.RandomState(5).randn(1, 96, 96, 3).astype(np.float32)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0), x), seed=6)
    want = jax_extra.test_time_pool(jmodel, variables, jnp.asarray(x), 6, original_pool=2)
    model = create_model("resnet10", num_classes=6)
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    with torch.no_grad():
        got = extra_layers.test_time_pool(model.eval(), nhwc(x), 6, original_pool=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_adaptive_avgmax_pool():
    x = np.random.RandomState(6).randn(2, 4, 4, 3).astype(np.float32)
    got = extra_layers.adaptive_avgmax_pool(nhwc(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_extra.adaptive_avgmax_pool(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, 0.5 * (x.mean((1, 2)) + x.max((1, 2))), rtol=1e-6)


def test_cbam_resnet_runs():
    """``tests/test_extra_layers.py``'s case on the port."""
    from scouter_tpu_torch.models import create_model

    model = create_model("resnet10", num_classes=4, attn="cbam")
    with torch.no_grad():
        assert model.eval()(torch.zeros(1, 3, 64, 64)).shape == (1, 4)
    assert isinstance(model.layer1[0].se, extra_layers.CbamModule)


def test_invalid_attn_raises():
    with pytest.raises(ValueError):
        extra_layers.create_attn("nope", 8)
    with pytest.raises(ValueError):
        jax_extra.create_attn("nope", 8)
    with pytest.raises(ValueError):
        ResNet(block="basic", layers=(1, 1, 1, 1), attn="nope")


@pytest.mark.parametrize("kind", ["se", "eca", "ceca", "cbam", "lcbam", "ese", "ESE", ""])
def test_create_attn_builds_jax_kinds(kind):
    """The same module kind under the name ``se`` in a block, and the same
    parameter leaves as JAX's."""
    from scouter_tpu.models.convert import torch_state_dict_to_variables

    x = jnp.zeros((1, 4, 4, 32))
    jmod = jax_extra.create_attn(kind, 32)
    tmod = extra_layers.create_attn(kind, 32)
    if not kind:
        assert jmod is None and tmod is None
        return
    kw = {"train": False} if isinstance(jmod, jax_extra.CbamModule) else {}
    want = jax.eval_shape(lambda key: jmod.init(key, x, **kw), jax.random.PRNGKey(0))
    sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in tmod.state_dict().items()}
    got = torch_state_dict_to_variables(sd)
    assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), want)
    assert type(tmod).__name__.lstrip("_").lower() == type(jmod).__name__.lstrip("_").lower()
