"""The port's serving engine and HTTP server on the CPU at a small size:
the invariants of tests/test_serve.py, plus the two engine races of the JAX
package that the port does not carry over, plus the config and the server's
weight loading."""

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from scouter_tpu_torch.core import ScouterConfig, check_serving_supported, checkpoint_name
from scouter_tpu_torch.models import build_slot_model
from scouter_tpu_torch.serve import InferenceEngine, engine as engine_mod, make_serving_fn
from scouter_tpu_torch.core.png import encode_png
from scouter_tpu_torch.serve.server import load_state_dict, make_server

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def small_cfg(**kw):
    base = dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                use_slot=True, slots_per_class=2, power=1, loss_status=1, to_k_layer=1,
                lambda_value=1.0, img_size=64, batch_size=4, pre_trained=False, seed=0,
                device="cpu")
    base.update(kw)
    return ScouterConfig(**base)


@pytest.fixture(scope="module")
def served():
    cfg = small_cfg()
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    return cfg, state_dict, make_serving_fn(cfg, state_dict, device="cpu")


def engine(served, **kw):
    cfg, state_dict, _ = served
    return InferenceEngine(cfg, state_dict, device="cpu", **kw)


def probe_images(cfg, n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, cfg.img_size, cfg.img_size, 1),
                                               np.uint8)


def direct(served, imgs):
    return served[2](imgs)["logits"].numpy()


class TestEngine:
    def test_futures_match_direct_batch(self, served):
        cfg = served[0]
        imgs = probe_images(cfg, 5, seed=3)
        with engine(served, buckets=(1, 4), max_wait_ms=20.0) as eng:
            futs = [eng.submit(img) for img in imgs]
            got = np.stack([f.result(timeout=120)["logits"] for f in futs])
            want = eng.infer_batch(imgs)["logits"]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, direct(served, imgs), **TOL)
        stats = eng.stats()
        assert stats["requests"] == 5
        assert stats["batches"] >= 2  # 5 requests cannot fit one 4-bucket

    def test_pipelined_dispatch_matches_serial(self, served):
        imgs = probe_images(served[0], 12, seed=11)
        outs = []
        for max_inflight in (4, 1):
            with engine(served, buckets=(1, 4), max_wait_ms=1.0,
                        max_inflight=max_inflight) as eng:
                futs = [eng.submit(img) for img in imgs]
                outs.append(np.stack([f.result(timeout=120)["logits"] for f in futs]))
                assert eng.stats()["requests"] == 12
        np.testing.assert_allclose(outs[0], outs[1], **TOL)

    def test_bucket_padding_is_masked_out(self, served):
        imgs = probe_images(served[0], 3, seed=9)
        with engine(served, buckets=(4,)) as eng:
            out = eng.infer_batch(imgs)
        assert out["logits"].shape == (3, 3)
        assert out["slot_maps"].shape == (3, 3, 2, 2)
        np.testing.assert_allclose(out["logits"], direct(served, imgs), **TOL)

    def test_oversize_batch_chunks_to_buckets(self, served):
        imgs = probe_images(served[0], 7, seed=13)
        with engine(served, buckets=(1, 4)) as eng:
            out = eng.infer_batch(imgs)
            stats = eng.stats()
        assert out["logits"].shape == (7, 3)
        assert stats["batches"] == 2 and stats["padded"] == 1
        assert stats["bucket_fill"] == {"4/4": 1, "4/3": 1}
        np.testing.assert_allclose(out["logits"], direct(served, imgs), **TOL)

    def test_rejects_float_and_misshaped_input(self, served):
        with engine(served, buckets=(1,)) as eng:
            with pytest.raises(TypeError):
                eng.submit(np.zeros((64, 64, 1), np.float32))
            with pytest.raises(ValueError):
                eng.submit(np.zeros((32, 32, 1), np.uint8))
            with pytest.raises(TypeError):
                eng.infer_batch(np.zeros((2, 64, 64, 1), np.float32))

    def test_cancelled_future_does_not_poison_batch(self, served):
        imgs = probe_images(served[0], 3, seed=17)
        with engine(served, buckets=(4,), max_wait_ms=300.0) as eng:
            futs = [eng.submit(img) for img in imgs]
            futs[0].cancel()  # may or may not win the race with the dispatcher
            results = [f.result(timeout=120)["logits"] for f in futs[1:]]
        np.testing.assert_allclose(np.stack(results), direct(served, imgs)[1:], **TOL)

    def test_submit_after_close_raises(self, served):
        eng = engine(served, buckets=(1,))
        eng.close()
        with pytest.raises(RuntimeError):
            eng.submit(probe_images(served[0], 1)[0])

    def test_multi_resolver_out_of_order_integrity(self, served):
        """Many in-flight batches race across the resolver pool; every future
        must still carry its own request's result."""
        imgs = probe_images(served[0], 24, seed=23)
        with engine(served, buckets=(1, 2), max_wait_ms=0.5, max_inflight=8,
                    resolvers=4) as eng:
            futs = [eng.submit(img) for img in imgs]
            got = np.stack([f.result(timeout=120)["logits"] for f in futs])
            samples = eng.stage_samples()
            stats = eng.stats()
        np.testing.assert_allclose(got, direct(served, imgs), **TOL)
        assert len(samples) == 24 and stats["requests"] == 24
        for s in samples:
            for k in ("queue_wait", "dispatch", "inflight_wait", "fetch"):
                assert s[k] >= 0.0
            assert 1 <= s["live"] <= s["bucket"] <= 2


class _SlowFetch:
    """Array-like whose host fetch is slow; counts batches dispatched and
    not yet fetched."""

    lock = threading.Lock()
    delay = 0.0
    outstanding = 0
    peak = 0

    def __init__(self, n):
        self.n = n
        with self.lock:
            type(self).outstanding += 1
            type(self).peak = max(type(self).peak, type(self).outstanding)

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.delay)
        with self.lock:
            type(self).outstanding -= 1
        return np.zeros((self.n, 3), np.float32)


def fake_serving_fn(cfg, state_dict, **kw):
    return lambda images: {"logits": _SlowFetch(len(images))}


@pytest.fixture
def fast_switching():
    """Switch threads every 10 us so that races show up within the test."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.usefixtures("fast_switching")
class TestEngineRaces:
    """The two engine races of the JAX package (ADVICE.md, round 5)."""

    def test_inflight_never_exceeds_max_inflight(self, monkeypatch):
        monkeypatch.setattr(engine_mod, "make_serving_fn", fake_serving_fn)
        monkeypatch.setattr(_SlowFetch, "delay", 0.03)
        _SlowFetch.outstanding = _SlowFetch.peak = 0
        cfg = small_cfg()
        with InferenceEngine(cfg, {}, buckets=(1,), max_wait_ms=0.0, max_inflight=2,
                             resolvers=6, device="cpu") as eng:
            futs = [eng.submit(img) for img in probe_images(cfg, 30)]
            for f in futs:
                f.result(timeout=60)
        # six resolvers could hold six batches; the bound is max_inflight
        assert _SlowFetch.peak == 2

    def test_close_racing_submit_returns_promptly(self, monkeypatch):
        """submit() calls that race close() must neither eat the resolvers'
        shutdown sentinels (close would wait out its 60 s joins) nor strand
        their futures."""
        monkeypatch.setattr(engine_mod, "make_serving_fn", fake_serving_fn)
        cfg = small_cfg()
        img = probe_images(cfg, 1)[0]
        for _ in range(5):
            eng = InferenceEngine(cfg, {}, buckets=(1, 4), max_wait_ms=0.0, resolvers=4,
                                  device="cpu")
            futs, stop = [], threading.Event()

            def client():
                while not stop.is_set():
                    try:
                        futs.append(eng.submit(img))
                    except RuntimeError:
                        return

            clients = [threading.Thread(target=client) for _ in range(4)]
            for c in clients:
                c.start()
            time.sleep(0.05)
            t0 = time.monotonic()
            eng.close()
            elapsed = time.monotonic() - t0
            stop.set()
            for c in clients:
                c.join()
            assert elapsed < 20.0, f"close() took {elapsed:.1f} s"
            assert not any(t.is_alive() for t in eng._resolvers)
            for f in futs:  # every future settles: a result or "engine is closed"
                assert f.exception(timeout=10) is None or "closed" in str(f.exception())


class TestHTTPServer:
    def test_png_gray_encoder_round_trips(self):
        from PIL import Image

        rng = np.random.RandomState(31)
        for arr in (np.zeros((1, 1), np.uint8), np.full((3, 7), 255, np.uint8),
                    rng.randint(0, 256, (224, 96), np.uint8)):
            back = np.asarray(Image.open(io.BytesIO(encode_png(arr, 1))))
            np.testing.assert_array_equal(back, arr)

    def test_predict_and_health_round_trip(self, served):
        """.npy body -> engine -> logits JSON; maps=1 returns one PNG per
        class; /healthz reports stats; a malformed body gets a 400."""
        cfg = served[0]
        with engine(served, buckets=(1, 4)) as eng:
            server = make_server(eng, cfg.img_size, 1, ("127.0.0.1", 0))
            port = server.server_address[1]
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            try:
                img = probe_images(cfg, 1)[0]
                buf = io.BytesIO()
                np.save(buf, img)
                req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?maps=1",
                                             data=buf.getvalue(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    payload = json.loads(resp.read())
                np.testing.assert_allclose(payload["logits"], direct(served, img[None])[0],
                                           rtol=1e-4, atol=1e-4)
                assert 0 <= payload["pred"] < cfg.num_classes
                assert len(payload["slot_maps_png"]) == cfg.num_classes
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=30) as resp:
                    health = json.loads(resp.read())
                assert health["status"] == "ok" and health["stats"]["requests"] == 1
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/predict", data=b"junk", method="POST"),
                        timeout=30)
                assert err.value.code == 400
            finally:
                server.shutdown()
                server.server_close()

    def test_cli_serves_on_the_cpu(self, tmp_path):
        """``python -m scouter_tpu_torch.serve.server --device cpu``: warms
        its buckets, listens, answers /predict and /healthz."""
        cmd = [sys.executable, "-m", "scouter_tpu_torch.serve.server", "--device", "cpu",
               "--dataset", "MNIST", "--model", "resnet10", "--num_classes", "3",
               "--img_size", "32", "--slots_per_class", "1", "--buckets", "1,2",
               "--output_dir", str(tmp_path), "--port", "0"]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if "serving on" in line:
                    break
            assert any("fresh-init" in ln for ln in lines), lines
            assert sum("warmed bucket" in ln for ln in lines) == 2, lines
            url = lines[-1].split()[2]
            buf = io.BytesIO()
            np.save(buf, np.zeros((32, 32, 1), np.uint8))
            req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert len(json.loads(resp.read())["logits"]) == 3
            with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
                assert json.loads(resp.read())["stats"]["requests"] == 1
        finally:
            proc.terminate()
            proc.wait(timeout=30)

    def test_server_loads_reference_checkpoint(self, tmp_path, served):
        cfg = served[0].replace(output_dir=str(tmp_path))
        sd, source = load_state_dict(cfg)
        assert source is None and set(sd) == set(served[1])
        ckpt = {k: v + 1.0 if v.is_floating_point() else v for k, v in served[1].items()}
        ckpt["slot.to_q.0.weight"] = torch.zeros(64, 64)  # bypassed by the forward
        path = tmp_path / f"{checkpoint_name(cfg)}.pth"
        torch.save({"model": ckpt, "args": argparse.Namespace(model="resnet10")}, path)
        sd, source = load_state_dict(cfg)
        assert source == str(path) and "slot.to_q.0.weight" not in sd
        torch.testing.assert_close(sd["conv1x1.bias"], served[1]["conv1x1.bias"] + 1.0)


class TestConfig:
    def test_flags_match_the_jax_package(self):
        from scouter_tpu.core.config import get_args_parser as jax_parser

        from scouter_tpu_torch.core import get_args_parser

        def flags(p):
            return {a.dest: a.default for a in p._actions}

        ours, theirs = flags(get_args_parser()), flags(jax_parser())
        assert ours.keys() == theirs.keys()
        assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
        assert ours == theirs
        assert ScouterConfig().device == "cuda"

    @pytest.mark.parametrize("kw", [dict(mesh_shape=(4, 2)), dict(zero1=True),
                                    dict(sync_bn=False), dict(mesh_axes=("data", "model"))])
    def test_unported_flags_raise_on_the_serving_path(self, kw, served):
        # ported: as in the JAX package, serving accepts the mesh flags and
        # ignores them (the engine's mesh is its own argument)
        cfg = small_cfg(**kw)
        check_serving_supported(cfg)
        images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 1)).astype(np.uint8)
        got = make_serving_fn(cfg, served[1], device="cpu")(images)
        want = make_serving_fn(small_cfg(), served[1], device="cpu")(images)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)

    @pytest.mark.parametrize("kw", [dict(), dict(loss_status=-1), dict(use_slot=False),
                                    dict(cal_area_size=True, lambda_value=2.0)])
    def test_checkpoint_name_matches_the_jax_package(self, kw):
        from scouter_tpu.core import ScouterConfig as JaxConfig
        from scouter_tpu.core.config import checkpoint_name as jax_checkpoint_name

        assert checkpoint_name(ScouterConfig(**kw)) == jax_checkpoint_name(JaxConfig(**kw))
        assert checkpoint_name(ScouterConfig(**kw), 3) == jax_checkpoint_name(JaxConfig(**kw), 3)
