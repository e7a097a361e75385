"""The port's explain path against the JAX package, Pillow and matplotlib on
the CPU, at small sizes: the heatmap kernel's plain version (K2), the exact
imaging counterparts (jet table, bilinear resize, alpha composite, PNG),
``explain/vis.py``, ``render_explanations`` end to end and the CLI."""

import io
import os
import struct
import zlib

import matplotlib
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.data import synthetic_mnist
from scouter_tpu.explain import apply_colormap_on_image as jax_apply_colormap
from scouter_tpu.explain import attention_area_ratio as jax_area_ratio
from scouter_tpu.explain import attention_to_maps as jax_attention_to_maps
from scouter_tpu.explain.cli import render_explanations as jax_render_explanations
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.ops.render_pallas import render_heatmaps_fused as jax_render_fused
from scouter_tpu.ops.render_pallas import render_heatmaps_ref as jax_render_ref
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core import png
from scouter_tpu_torch.core.checkpoint import checkpoint_path, save_checkpoint
from scouter_tpu_torch.data import ArrayDataset, select_dataset
from scouter_tpu_torch.explain import (apply_colormap_on_image, attention_area_ratio,
                                       attention_to_maps, save_slot_pngs)
from scouter_tpu_torch.explain import _imaging
from scouter_tpu_torch.explain.cli import main, render_explanations
from scouter_tpu_torch.models import build_slot_model, variables_to_state_dict
from scouter_tpu_torch.ops import render_kernel
from scouter_tpu_torch.train import Trainer, create_train_state, restore_inference_state

# tests/test_render_pallas.py:18, on the [0, 255] scale
RENDER_TOL = dict(rtol=1e-5, atol=1e-4)


def pil_array(path_or_bytes):
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    return np.asarray(Image.open(src))


# ------------------------------------------------------------ K2, plain version

def _render_cases():
    rng = np.random.RandomState(0)
    const = rng.rand(4, 81).astype(np.float32) * 3.0
    const[1] = 0.7  # hi - lo = 0: denominator 1e-12, the row is blue
    return {
        # tests/test_render_pallas.py's three inputs
        "uniform": np.array(jax.random.uniform(jax.random.PRNGKey(0), (10, 81)) * 3.0),
        "per-class-ranges": np.stack([np.linspace(5.0, 6.0, 81), np.linspace(-2.0, 0.0, 81)]
                                     ).astype(np.float32),
        "jet-endpoints": np.asarray([[0.0, 0.5, 1.0]], np.float32),
        "constant-row": const,
    }


@pytest.mark.parametrize("case", sorted(_render_cases()))
def test_render_plain_version_matches_jax(case):
    attn = _render_cases()[case]
    got = render_kernel.render_heatmaps_fused(torch.from_numpy(attn)).numpy()
    assert got.shape == attn.shape + (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_render_fused(jnp.asarray(attn),
                                                                interpret=True)), **RENDER_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_render_ref(jnp.asarray(attn))), **RENDER_TOL)
    np.testing.assert_allclose(render_kernel.render_heatmaps_ref(torch.from_numpy(attn)).numpy(),
                               got, rtol=0, atol=0)


def test_render_plain_version_semantics():
    """A constant row is blue; a NaN spreads over its row's r, g, b as in
    the JAX reference; other rows are untouched; C=0 and float64 input."""
    attn = np.random.RandomState(1).rand(3, 7).astype(np.float32)
    attn[0] = 2.0
    attn[2, 4] = np.nan
    got = render_kernel.render_heatmaps_fused(torch.from_numpy(attn)).numpy()
    np.testing.assert_array_equal(got[0, :, :3], np.tile([0.0, 0.0, 127.5], (7, 1)))
    assert np.isnan(got[2, :, :3]).all() and not np.isnan(got[:2]).any()
    np.testing.assert_array_equal(got[:, :, 3], np.float32(0.4) * np.float32(255.0))
    want = np.asarray(jax_render_ref(jnp.asarray(attn)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[:2], want[:2], **RENDER_TOL)
    assert render_kernel.render_heatmaps_fused(torch.zeros(0, 5)).shape == (0, 5, 4)
    f64 = render_kernel.render_heatmaps_fused(torch.from_numpy(attn[:2].astype(np.float64)))
    assert f64.dtype == torch.float32
    with pytest.raises(ValueError):
        render_kernel.render_heatmaps_fused(torch.zeros(2, 3, 4))


# ------------------------------------------------------------------ imaging

def test_jet_lut_equals_matplotlib():
    want = matplotlib.colormaps["jet"](np.arange(256))
    np.testing.assert_array_equal(_imaging.jet_lut().numpy(), want)


@pytest.mark.parametrize("size_in,size_out", [(7, 224), (9, 260), (2, 64), (7, 36), (7, 7),
                                              (260, 9)])
def test_resize_equals_pil_bilinear(size_in, size_out):
    arr = np.random.RandomState(size_in * 1000 + size_out).randint(
        0, 256, (size_in, size_in)).astype(np.uint8)
    want = np.asarray(Image.fromarray(arr, "L").resize((size_out, size_out), Image.BILINEAR))
    got = _imaging.resize_bilinear_u8(torch.from_numpy(arr), size_out, size_out)
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_of_a_stack_equals_pil_per_plane():
    arr = np.random.RandomState(3).randint(0, 256, (3, 5, 11)).astype(np.uint8)
    got = _imaging.resize_bilinear_u8(torch.from_numpy(arr), 17, 30).numpy()
    for plane, out in zip(arr, got):
        np.testing.assert_array_equal(
            out, np.asarray(Image.fromarray(plane).resize((30, 17), Image.BILINEAR)))


def test_alpha_composite_equals_pil():
    rng = np.random.RandomState(4)
    dst = rng.randint(0, 256, (32, 40, 4)).astype(np.uint8)
    src = rng.randint(0, 256, (32, 40, 4)).astype(np.uint8)
    src[::3, :, 3] = 0  # fully transparent source: the result is dst
    dst[::5, :, 3] = 0
    src[1::4, :, 3] = 255
    want = np.asarray(Image.alpha_composite(Image.fromarray(dst), Image.fromarray(src)))
    got = _imaging.alpha_composite(torch.from_numpy(dst), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,shape", [("L", (9, 13)), ("RGB", (9, 13, 3)),
                                        ("RGBA", (9, 13, 4))])
def test_png_writer_decodes_with_pil(tmp_path, mode, shape):
    arr = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, torch.from_numpy(arr))
    img = Image.open(path)
    assert img.mode == mode
    np.testing.assert_array_equal(np.asarray(img), arr)
    np.testing.assert_array_equal(png.read_png(path), arr)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    # the reader takes every filter now (Pillow picks per-row filters); it
    # refuses 16-bit samples and a filter type past 4
    path = str(tmp_path / "pil.png")
    arr = np.random.RandomState(6).randint(0, 256, (16, 16, 3)).astype(np.uint8)
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(png.read_png(path), arr)
    Image.fromarray((arr[..., 0].astype(np.uint16) * 257)).save(path)
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(path)
    raw = np.zeros((2, 1 + 2), np.uint8)
    raw[1, 0] = 5
    bad = (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0))
           + png._chunk(b"IDAT", zlib.compress(raw.tobytes())) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter"):
        png.decode_png(bad)
    with pytest.raises(TypeError):
        png.encode_png(np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_apply_colormap_equals_jax(mode):
    rng = np.random.RandomState(7)
    shape = (24, 20, 3) if mode == "RGB" else (24, 20)
    image = rng.randint(0, 256, shape).astype(np.uint8)
    activation = rng.randint(0, 256, (24, 20)).astype(np.uint8)
    activation[0, :2] = (0, 255)
    heat_j, over_j = jax_apply_colormap(Image.fromarray(image).convert("RGB"), activation, "jet")
    heat, over = apply_colormap_on_image(torch.from_numpy(image), torch.from_numpy(activation))
    np.testing.assert_array_equal(heat.numpy(), np.asarray(heat_j))
    np.testing.assert_array_equal(over.numpy(), np.asarray(over_j))
    with pytest.raises(ValueError):
        apply_colormap_on_image(torch.from_numpy(image), torch.from_numpy(activation), "viridis")


# ---------------------------------------------------------------------- vis

@pytest.mark.parametrize("seed,shape,classes,spc", [(0, (6, 81), 3, 2), (1, (4, 81), 4, 1)])
def test_attention_to_maps_and_ratio_equal_jax(seed, shape, classes, spc):
    """tests/test_cli_and_vis.py:77-102's inputs."""
    attn = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    want = jax_attention_to_maps(attn, classes, spc)
    got = attention_to_maps(torch.from_numpy(attn), classes, spc)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    for m, mj in zip(got, want):
        assert attention_area_ratio(m) == jax_area_ratio(mj)
    with pytest.raises(ValueError):
        attention_to_maps(torch.from_numpy(attn)[None], classes, spc)


def test_area_ratio_bounds_and_save_slot_pngs(tmp_path):
    assert attention_area_ratio(np.full((9, 9), 255, np.uint8)) == pytest.approx(1.0)
    assert attention_area_ratio(torch.zeros(9, 9, dtype=torch.uint8)) == 0.0
    maps = attention_to_maps(torch.rand(4, 81, generator=torch.Generator().manual_seed(0)), 4, 1)
    paths = save_slot_pngs(maps, str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [f"slot_{i}.png" for i in range(4)]
    for p, m in zip(paths, maps):
        np.testing.assert_array_equal(pil_array(p), m.numpy())


# -------------------------------------------------------------- end to end

def perturb(variables, seed):
    """Numpy noise on BN statistics and scales and on every bias, so that
    eval-mode BN is not the identity."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, np.float32)
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        if name in ("var", "scale"):
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def test_render_explanations_matches_jax(tmp_path, capsys):
    """tests/test_explain_cli.py's config and image; the same variables on
    both sides."""
    kw = dict(model="resnet10", dataset="MNIST", num_classes=10, channel=512, use_slot=True,
              slots_per_class=2, power=2, loss_status=1, to_k_layer=1, lambda_value=1.0,
              img_size=64, batch_size=8, epochs=1, lr=1e-3, pre_trained=False,
              freeze_layers=0, output_dir=str(tmp_path), cal_area_size=True, seed=0)
    jcfg, cfg = JaxConfig(**kw), ScouterConfig(**kw, device="cpu")
    _, (te_x, te_y) = synthetic_mnist(num_train=32, num_test=16)
    jmodel = jax_build_slot_model(jcfg)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 1), jnp.float32)), seed=1)
    jstate, _ = jax_create_train_state(variables, jcfg.lr)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ratio_j = jax_render_explanations(jcfg, jstate, jmodel, te_x[0], int(te_y[0]), jdir)
    printed_j = capsys.readouterr().out.splitlines()

    model = build_slot_model(cfg, fused_slot=True, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables))
    ratio = render_explanations(cfg, create_train_state(model, cfg.lr), model, te_x[0],
                                int(te_y[0]), tdir)
    printed = capsys.readouterr().out.splitlines()

    # logits: the f32 forward of two frameworks, summed in different orders
    logp_j = np.array(" ".join(printed_j[:-2]).strip("[]").split(), np.float64)
    logp = np.array(" ".join(printed[:-2]).strip("[]").split(), np.float64)
    assert logp.shape == (cfg.num_classes,)
    np.testing.assert_allclose(logp, logp_j, rtol=0, atol=1e-4)
    assert printed[-2] == printed_j[-2]  # the prediction
    assert ratio == pytest.approx(ratio_j, abs=1e-6)
    assert printed[-1].startswith("attention_ratio: ")

    image = pil_array(os.path.join(jdir, "image.png"))
    np.testing.assert_array_equal(pil_array(os.path.join(tdir, "image.png")), image)
    for i in range(cfg.num_classes):
        slot_j = pil_array(os.path.join(jdir, f"slot_{i}.png"))
        slot = pil_array(os.path.join(tdir, f"slot_{i}.png"))
        # the uint8 cast truncates: a value at a step boundary may land one step apart
        assert np.abs(slot.astype(int) - slot_j).max() <= 1
        # fed JAX's map, the resize, the jet table and the composite are exact
        resized = _imaging.resize_bilinear_u8(torch.from_numpy(slot_j), *image.shape[:2])
        _, overlaid = apply_colormap_on_image(torch.from_numpy(image), resized)
        np.testing.assert_array_equal(overlaid.numpy(),
                                      pil_array(os.path.join(jdir, f"slot_mask_{i}.png")))
        assert pil_array(os.path.join(tdir, f"slot_mask_{i}.png")).shape == image.shape + (4,)


# ---------------------------------------------------------------------- CLI

CLI_FLAGS = ["--device", "cpu", "--dataset", "ImageNet", "--model", "resnet10",
             "--num_classes", "3", "--channel", "512", "--slots_per_class", "1",
             "--img_size", "64", "--batch_size", "8", "--pre_trained", "false",
             "--cal_area_size", "true"]


def cli_cfg(tmp_path, loss_status):
    return ScouterConfig(model="resnet10", dataset="ImageNet", num_classes=3, channel=512,
                         slots_per_class=1, img_size=64, batch_size=8, pre_trained=False,
                         cal_area_size=True, loss_status=loss_status, device="cpu",
                         dataset_dir=str(tmp_path / "none"), output_dir=str(tmp_path))


@pytest.mark.parametrize("loss_status", [1, -1])
def test_cli_restores_what_training_wrote(tmp_path, monkeypatch, capsys, loss_status):
    """One train epoch of the port's Trainer, its checkpoint, then ``main``:
    the label's slot for a positive model, the next one for a negative."""
    cfg = cli_cfg(tmp_path, loss_status)
    val = select_dataset(cfg, train=False)  # the synthetic stand-in
    vis_id = int(np.flatnonzero(val.labels < cfg.num_classes - 1)[0])
    label = int(val.labels[vis_id])
    trainer = Trainer(cfg, datasets=(ArrayDataset(val.images[:8], val.labels[:8], "ImageNet"),) * 2)
    trainer.run_epoch(0, "train")
    save_checkpoint(str(tmp_path), cfg, trainer.state, 0)

    monkeypatch.chdir(tmp_path)
    path = main(CLI_FLAGS + ["--loss_status", str(loss_status), "--vis_id", str(vis_id),
                             "--dataset_dir", str(tmp_path / "none"),
                             "--output_dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert path == checkpoint_path(str(tmp_path), cfg)
    vis = tmp_path / "sloter_vis"
    assert sorted(os.listdir(vis)) == sorted(
        ["image.png"] + [f"slot_{i}.png" for i in range(3)]
        + [f"slot_mask_{i}.png" for i in range(3)])
    sel = label if loss_status > 0 else label + 1
    ratio = float(out[-1].split(": ")[1])
    assert ratio == attention_area_ratio(pil_array(str(vis / f"slot_{sel}.png")))

    # the restored weights are the trained ones, and the CLI ran them
    model, _, restored = restore_inference_state(cfg, device="cpu")
    assert restored == path
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_restore_inference_state_without_a_checkpoint(tmp_path):
    cfg = cli_cfg(tmp_path, 1)
    model, state, path = restore_inference_state(cfg, device="cpu")
    assert path is None and state.model is model and not model.training
    fresh = build_slot_model(cfg, device="cpu").state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    with pytest.raises(FileNotFoundError):
        restore_inference_state(cfg, require=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        main(CLI_FLAGS + ["--output_dir", str(tmp_path)])
