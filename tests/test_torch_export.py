"""The port's serving artifact and int8 serving on the CPU, against the JAX
package at a small size (resnet10 on MNIST-sized inputs, tests/test_serve.py's
``small_cfg``): ``export_serving`` / ``save_artifact`` / ``load_artifact``
(tests/test_serve.py:47-125), the export CLI, ``serve/quant.py``
(tests/test_serve.py:364-427) and ``torch.library.opcheck`` of K1's and K2's
custom ops. Weights come from the JAX package's init through
``variables_to_state_dict``; every input is made with numpy from a seed."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.serve import make_serving_fn as jax_make_serving_fn
from scouter_tpu.serve.quant import int8_conv_general_dilated
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.explain import attention_to_maps
from scouter_tpu_torch.models import build_slot_model, layers, variables_to_state_dict
from scouter_tpu_torch.ops import render_kernel, slot_kernel
from scouter_tpu_torch.serve import (QUANT_POLICIES, InferenceEngine, export_serving,
                                     int8_conv2d, load_artifact, make_serving_fn,
                                     quantized_convs, save_artifact)
from scouter_tpu_torch.serve import quant

SMALL = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512, use_slot=True,
             slots_per_class=2, power=1, loss_status=1, to_k_layer=1, lambda_value=1.0,
             img_size=64, batch_size=4, pre_trained=False, seed=0)
TOL = dict(rtol=2e-5, atol=2e-5)  # scouter_tpu/serve/cli.py:80-82, f32
FEATURE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_models.py:144


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def small_cfg(**kw):
    return ScouterConfig(**{**SMALL, "device": "cpu", **kw})


@functools.lru_cache(maxsize=None)
def jax_case(use_slot=True):
    """The JAX config and its variables from PRNGKey(0), and the port's state
    dict of the same weights."""
    jcfg = JaxConfig(**{**SMALL, "use_slot": use_slot, "output_dir": ""})
    x = jnp.zeros((1, SMALL["img_size"], SMALL["img_size"], 1), jnp.float32)
    variables = jax.device_get(jax.jit(jax_build_slot_model(jcfg).init)(jax.random.PRNGKey(0),
                                                                        x))
    names = build_slot_model(small_cfg(use_slot=use_slot), device="cpu").state_dict()
    return jcfg, variables, variables_to_state_dict(variables, names)


def probe_images(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, SMALL["img_size"], SMALL["img_size"], 1), np.uint8)


@pytest.fixture(scope="module")
def dynamic_artifact(tmp_path_factory):
    _, _, sd = jax_case()
    cfg = small_cfg()
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    assert save_artifact(export_serving(cfg, sd, device="cpu"), path) > 0
    return cfg, sd, path


# ------------------------------------------------------------------- export

def test_round_trip_dynamic_batch(dynamic_artifact):
    """One dynamic-batch artifact serves batch 1 and 3 and matches the live
    serving function (batch 1 included: no size is specialised)."""
    from scouter_tpu_torch.serve.export import BATCH_RANGE, batch_range

    cfg, sd, path = dynamic_artifact
    call = load_artifact(path, device="cpu")
    assert batch_range(call.exported) == (BATCH_RANGE[0], False) == (2, False)
    live = make_serving_fn(cfg, sd, device="cpu")
    for n in (1, 3):
        imgs = probe_images(n, seed=n)
        got, want = call(imgs), live(imgs)
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(), **TOL)
        assert got["slot_maps"].shape == (n, cfg.num_classes, 2, 2)
        assert torch.equal(got["slot_maps"], want["slot_maps"])


def test_pinned_batch_rejects_other_sizes():
    _, _, sd = jax_case()
    cfg = small_cfg()
    exported = export_serving(cfg, sd, batch=2, device="cpu")
    out = exported.module()(torch.from_numpy(probe_images(2)))
    assert out["logits"].shape == (2, cfg.num_classes)
    with pytest.raises(Exception):
        exported.module()(torch.from_numpy(probe_images(3)))


def test_slot_maps_match_host_renderer(dynamic_artifact):
    """The artifact's maps equal the live function's, and each sample's
    within one level of ``explain.vis.attention_to_maps`` (the test.py
    slot_{id}.png contract)."""
    cfg, sd, path = dynamic_artifact
    imgs = probe_images(2, seed=7)
    got = load_artifact(path, device="cpu")(imgs)["slot_maps"]
    live = make_serving_fn(cfg, sd, device="cpu")
    assert torch.equal(got, live(imgs)["slot_maps"])
    from scouter_tpu_torch.data import preprocess_batch

    with torch.no_grad():
        x = preprocess_batch(torch.from_numpy(imgs), dataset=cfg.dataset, img_size=cfg.img_size)
        attn = live.model(x.permute(0, 3, 1, 2))["attn"]
    for i in range(2):
        want = attention_to_maps(attn[i], cfg.num_classes, cfg.slots_per_class)
        assert (got[i].int() - want.int()).abs().max() <= 1


def test_no_slot_model_exports_logits_only(tmp_path):
    _, _, sd = jax_case(use_slot=False)
    cfg = small_cfg(use_slot=False)
    path = str(tmp_path / "noslot.pt2")
    save_artifact(export_serving(cfg, sd, batch=1, device="cpu"), path)
    out = load_artifact(path, device="cpu")(probe_images(1))
    assert set(out.keys()) == {"logits"}


def test_artifact_logits_match_jax(dynamic_artifact):
    """The slice as a whole: the loaded artifact against JAX's
    make_serving_fn on the same weights and images."""
    cfg, _, path = dynamic_artifact
    jcfg, variables, _ = jax_case()
    imgs = probe_images(4, seed=11)
    want = jax.jit(jax_make_serving_fn(jcfg, variables))(imgs)
    got = load_artifact(path, device="cpu")(imgs)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **FEATURE_TOL)
    diff = got["slot_maps"].numpy().astype(int) - np.asarray(want["slot_maps"]).astype(int)
    assert np.abs(diff).max() <= 1


def test_platforms_take_one_device_kind(dynamic_artifact):
    # each entry of platforms one known device kind, each once: an unknown
    # kind, a repeated one or none is refused ("cuda", "cpu" together is an
    # artifact of two programs, checked on the card)
    cfg, sd, path = dynamic_artifact
    for bad in (("tpu",), "gpu", ("cpu", "cpu"), (), ("cuda", "tpu")):
        with pytest.raises(ValueError, match="device kinds out of"):
            export_serving(cfg, sd, platforms=bad, device="cpu")
    from scouter_tpu_torch.serve.export import artifact_platform, artifact_platforms

    assert artifact_platform(torch.export.load(path)) == "cpu"
    assert artifact_platforms(path) == ("cpu",)
    with pytest.raises(ValueError, match=r"holds a program for \['cpu'\].*not for cuda"):
        load_artifact(path, device="cuda")


def test_artifact_of_several_kinds_loads_the_program_for_its_device(dynamic_artifact, tmp_path):
    """An artifact of one program a device kind (what platforms=("cuda",
    "cpu") writes): a zip of each program's archive and a manifest; the
    loader takes the program for its device's kind, and refuses a kind the
    file holds none for, naming the kinds it holds."""
    import zipfile

    from scouter_tpu_torch.serve.export import artifact_platforms

    cfg, sd, path = dynamic_artifact
    several = str(tmp_path / "several.pt2")
    save_artifact({"cpu": torch.export.load(path)}, several)
    with zipfile.ZipFile(several) as archive:
        assert sorted(archive.namelist()) == ["cpu.pt2", "platforms.json"]
    assert artifact_platforms(several) == ("cpu",)
    imgs = probe_images(3, seed=5)
    got = load_artifact(several, device="cpu")(imgs)
    want = load_artifact(path, device="cpu")(imgs)
    assert set(got) == set(want)
    for key in got:
        assert torch.equal(got[key], want[key])
    with pytest.raises(ValueError, match=r"holds programs for \['cpu'\], not for cuda"):
        load_artifact(several, device="cuda")
    # a program saved under another kind's name is refused when written
    with pytest.raises(ValueError, match="given for cuda holds tensors on cpu"):
        save_artifact({"cuda": torch.export.load(path)}, str(tmp_path / "wrong.pt2"))


def test_export_cli_writes_verified_artifact(tmp_path, capsys):
    """serve.cli end to end: export (fresh init, no checkpoint on disk),
    save, reload and the CLI's own artifact-vs-live check."""
    from scouter_tpu_torch.serve.cli import main

    out = str(tmp_path / "m.pt2")
    main(["--device", "cpu", "--dataset", "MNIST", "--model", "resnet10", "--num_classes", "3",
          "--channel", "512", "--img_size", "64", "--batch_size", "2", "--use_slot", "true",
          "--slots_per_class", "2", "--pre_trained", "false", "--output_dir", str(tmp_path),
          "--export_path", out, "--serve_batch", "2"])
    assert os.path.getsize(out) > 1e5
    printed = capsys.readouterr().out
    assert "platforms=['cpu'], batch=2" in printed
    assert "round-trip verified" in printed


# -------------------------------------------------------------------- int8

def test_int8_conv_matches_manual_fakequant_and_jax():
    """int8_conv2d against explicit quantize / matmul / dequantize, and
    against JAX's int8_conv_general_dilated on the same inputs."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 8, 8).astype(np.float32)
    w = rng.randn(32, 16, 1, 1).astype(np.float32)
    got = int8_conv2d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    a_s = np.max(np.abs(x)) / 127.0
    qa = np.clip(np.round(x / a_s), -127, 127)
    w_s = np.abs(w).max(axis=(1, 2, 3)) / 127.0
    qw = np.clip(np.round(w / w_s[:, None, None, None]), -127, 127)
    want = np.einsum("bihw,oi->bohw", qa, qw[:, :, 0, 0]) * (a_s * w_s)[None, :, None, None]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    xj, wj = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0))
    jgot = int8_conv_general_dilated(
        xj, wj, (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=jax.lax.conv_dimension_numbers(xj.shape, wj.shape,
                                                         ("NHWC", "HWIO", "NHWC")))
    np.testing.assert_allclose(got, np.asarray(jgot).transpose(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-4)
    # a strided pointwise conv with a bias, as the downsample path has
    b = rng.randn(32).astype(np.float32)
    got = int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=2)
    want = int8_conv2d(torch.from_numpy(x[:, :, ::2, ::2].copy()), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want.numpy() + b[None, :, None, None], rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="pointwise"):
        int8_conv2d(torch.from_numpy(x), torch.randn(32, 16, 3, 3), padding=1)


def test_policy_targets_pointwise_only():
    policy = QUANT_POLICIES["int8"]
    assert policy(1, 1) is quant.Int8PointwiseConv
    assert policy(3, 1) is None   # spatial convs stay float
    assert policy(1, 2) is None   # grouped projections stay float
    # on a built model: only pointwise convs built by layers.conv2d (the
    # slot head's conv1x1 and the grouped ones are not)
    model = build_slot_model(small_cfg(), device="cpu")
    with quantized_convs("int8", model) as count:
        subs = [m for m in model.modules()
                if isinstance(m, layers.Conv2d) and m.substitute is not None]
        assert count == len(subs) > 0
        assert all(m.kernel_size == (1, 1) and m.groups == 1 for m in subs)
        assert model.conv1x1.substitute is None
    assert all(m.substitute is None for m in model.modules() if isinstance(m, layers.Conv2d))
    with pytest.raises(ValueError, match="unknown quantization policy"):
        make_serving_fn(small_cfg(), model.state_dict(), quant="int4", device="cpu")


def test_quantized_serving_close_to_float_and_to_jax():
    """quant='int8' against the float path (tests/test_serve.py:394-418's
    bars) and against JAX's int8 serving on the same weights."""
    jcfg, variables, sd = jax_case()
    cfg = small_cfg()
    imgs = probe_images(4, seed=5)
    ref = make_serving_fn(cfg, sd, device="cpu")(imgs)["logits"].numpy()
    q = make_serving_fn(cfg, sd, quant="int8", device="cpu")(imgs)["logits"].numpy()
    denom = max(np.abs(ref).max(), 1e-3)
    err = np.abs(ref - q).max() / denom
    assert 0 < err < 0.05, err
    srt = np.sort(ref, axis=1)
    decisive = srt[:, -1] - srt[:, -2] > 2 * np.abs(ref - q).max()
    assert np.array_equal(ref[decisive].argmax(1), q[decisive].argmax(1))
    jq = np.asarray(jax.jit(jax_make_serving_fn(jcfg, variables, quant="int8"))(imgs)["logits"])
    assert np.abs(q - jq).max() / denom < 0.01, np.abs(q - jq).max() / denom


def test_engine_accepts_quant():
    _, _, sd = jax_case()
    imgs = probe_images(2, seed=7)
    with InferenceEngine(small_cfg(), sd, buckets=(2,), max_wait_ms=5.0, quant="int8",
                         device="cpu") as eng:
        futs = [eng.submit(img) for img in imgs]
        out = [f.result(timeout=300) for f in futs]
        direct = eng.infer_batch(imgs)["logits"]
    got = np.stack([o["logits"] for o in out])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)
    float_fn = make_serving_fn(small_cfg(), sd, device="cpu")
    assert not np.array_equal(got, float_fn(imgs)["logits"].numpy())  # int8 was served


# ---------------------------------------------------------------- custom ops

def k1_args(seed, dtype=torch.float32, b=2, n=9, s=4, d=8):
    rng = np.random.RandomState(seed)
    shapes = ((b, n, d), (b, n, d), (s, d), (3 * d, d), (3 * d, d), (1, 3 * d), (1, 3 * d))
    scales = (1.0, 1.0, 1.0, 0.2, 0.2, 0.1, 0.1)
    return [torch.from_numpy((rng.randn(*sh) * sc).astype(np.float32)).to(dtype)
            for sh, sc in zip(shapes, scales)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_pass_opcheck(dtype):
    args = k1_args(3, dtype)
    ops = torch.ops.scouter_tpu_torch
    torch.library.opcheck(ops.xslot_fwd.default, (*args, 3))
    torch.library.opcheck(ops.xslot_fwd_hist.default, (*args, 3))
    _, _, hist = ops.xslot_fwd_hist(*args, 3)
    rng = np.random.RandomState(4)
    du = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32))
    dattn = torch.from_numpy(rng.randn(2, 4, 9).astype(np.float32))
    res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
    torch.library.opcheck(ops.xslot_bwd.default, (*res, du, dattn))
    grads = ops.xslot_bwd(*res, du, dattn)
    assert all(g.dtype == dtype for g in grads)
    attn = torch.from_numpy(rng.rand(5, 9).astype(np.float32))
    torch.library.opcheck(ops.render_heatmaps.default, (attn, 0.4))
    assert torch.equal(render_kernel.render_heatmaps_fused(attn),
                       render_kernel.render_heatmaps_ref(attn))
    assert torch.equal(ops.xslot_fwd(*args, 3)[1], slot_kernel.xslot_fwd_ref(*args)[1])
