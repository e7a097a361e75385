"""The port's spans and request record (``utils/tracing.py``) on the CPU: off
without a profiler, on the profiler's clock under one, one record a request
in a bounded ring, and the Loader's spans."""

import json
import os

import numpy as np
import pytest
import torch

from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.data import ArrayDataset, Loader
from scouter_tpu_torch.models import build_slot_model
from scouter_tpu_torch.serve import InferenceEngine
from scouter_tpu_torch.utils import profiling, tracing

MS = 1_000_000  # ns
STAMPS = ("submitted", "formed", "launched", "picked", "answered")


@pytest.fixture(scope="module")
def state():
    cfg = ScouterConfig(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                        use_slot=True, slots_per_class=2, power=1, loss_status=1, to_k_layer=1,
                        lambda_value=1.0, img_size=32, batch_size=4, pre_trained=False, seed=0,
                        device="cpu")
    return cfg, build_slot_model(cfg, device="cpu").state_dict()


def serve(state, n, **kw):
    """Serve ``n`` images through a fresh engine; its id."""
    cfg, sd = state
    imgs = np.random.RandomState(n).randint(0, 256, (n, 32, 32, 1), np.uint8)
    with InferenceEngine(cfg, sd, device="cpu", **kw) as eng:
        for f in [eng.submit(img) for img in imgs]:
            f.result(timeout=60)
    return eng._id


def profiled():
    """The profiler as the benchmark's tracer configures it: every thread."""
    every = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  record_shapes=True, experimental_config=every)


def spans(prof, name):
    return [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_off_without_a_profiler_span_makes_no_range_and_stores_nothing(state, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = tracing.records()
    with tracing.span("engine.await", batch=1) as got:
        assert got is None
    assert tracing.span("loader.wait") is tracing.span("engine.form")  # one shared null
    after = tracing.records()
    assert all(np.array_equal(before[k], after[k]) for k in tracing.FIELDS)
    # an engine serving with spans off stores its requests and nothing else
    engine = serve(state, 3, buckets=(4,))
    assert len(tracing.records(engine=engine)["request"]) == 3


def test_the_stage_span_lies_within_its_batch_on_the_store_clock(state):
    with profiled() as prof:
        engine = serve(state, 6, buckets=(2, 4), max_wait_ms=1.0)
    r = tracing.records(engine=engine)
    batches = {int(b): i for i, b in enumerate(r["batch"])}
    stage = spans(prof, "engine.stage")
    assert len(stage) == len(batches) >= 2
    for start, end in stage:
        # the dispatcher stamps formed just before it stages and launched after
        assert any(r["formed"][i] - MS <= start and end <= r["launched"][i] + MS
                   for i in batches.values()), (start, end)
    for name in ("engine.await", "engine.fetch", "engine.resolve"):
        assert spans(prof, name), name


def test_one_record_a_request_in_a_bounded_ring(state, monkeypatch):
    engine = serve(state, 24, buckets=(1, 2, 16), max_wait_ms=0.5, max_inflight=8,
                   resolvers=4)
    r = tracing.records(engine=engine)
    assert len(r["request"]) == len(set(r["request"].tolist())) == 24
    for a, b in zip(STAMPS, STAMPS[1:]):
        assert (r[a] <= r[b]).all(), (a, b)
    assert (r["live"] >= 1).all() and (r["live"] <= r["bucket"]).all()

    # past the capacity the ring keeps the newest rows, in place
    ring = np.zeros((16, len(tracing.FIELDS)), np.int64)
    monkeypatch.setattr(tracing, "_ring", ring)
    monkeypatch.setattr(tracing, "_written", 0)
    t = tracing.now_ns()
    ids = iter(range(1, 10**6))
    for n in (5, 16, 3, 12):  # a batch of the ring's size; then one that wraps
        reqs = [next(ids) for _ in range(n)]
        tracing.record_batch(-1, reqs[0], reqs, [t] * n, t, t, t, t, 32)
    tracing.record_batch(-1, 99, [1000, 1001], [t] * 2, t, t, t, t, 2)
    assert tracing._ring is ring and ring.shape == (16, len(tracing.FIELDS))
    got = tracing.records(engine=-1)["request"].tolist()
    assert got == list(range(23, 37)) + [1000, 1001]
    engine = serve(state, 24, buckets=(1, 2), max_inflight=1, resolvers=1)
    assert tracing._ring is ring
    got = tracing.records(engine=engine)["request"]
    assert len(got) == 16 and (np.diff(got) > 0).all()


def test_a_loader_epoch_shows_one_wait_and_one_gather_a_batch():
    rng = np.random.RandomState(0)
    ds = ArrayDataset(rng.randint(0, 256, (20, 16, 16, 3), np.uint8),
                      rng.randint(0, 3, 20), "ImageNet")
    loader = Loader(ds, 4, img_size=12, train=True, seed=1, device="cpu")
    with profiled() as prof:
        got = list(loader.epoch(0))
    assert len(got) == loader.steps_per_epoch() == 5
    assert len(spans(prof, "loader.wait")) == len(spans(prof, "loader.gather")) == 5


def test_the_operators_trace_holds_spans_and_each_requests_stages(state, tmp_path):
    with profiling.trace(str(tmp_path)):
        engine = serve(state, 5, buckets=(1, 4), max_wait_ms=1.0)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    stage = sorted((e for e in events if e.get("name") == "engine.stage"), key=lambda e: e["ts"])
    mine = [e for e in events if e.get("pid") == profiling.REQUESTS_PID and e["ph"] == "X"
            and e["args"]["engine"] == engine]
    queued = [e for e in mine if e["name"] == "queue"]
    assert len(queued) == 5 and len({e["args"]["request"] for e in queued}) == 5
    batches = {e["args"]["batch"] for e in queued}
    assert sorted(e["name"] for e in mine if e["name"] != "queue") == sorted(
        ["dispatch", "inflight", "fetch"] * len(batches))
    # on the trace's clock: each batch's dispatch (formed -> launched) holds
    # the dispatcher's engine.stage span of it, within 1 ms (ts, dur in us)
    dispatch = sorted((e for e in mine if e["name"] == "dispatch"), key=lambda e: e["ts"])
    assert len(stage) == len(dispatch) == len(batches)
    for s, d in zip(stage, dispatch):
        assert d["ts"] - 1e3 <= s["ts"] and s["ts"] + s["dur"] <= d["ts"] + d["dur"] + 1e3, (s, d)
    # a track's events nest: each starts after the one before it ends, or
    # ends with it (requests queued for one batch end as the batch forms)
    for tid in {e["tid"] for e in mine}:
        track = sorted((e for e in mine if e["tid"] == tid), key=lambda e: e["ts"])
        for a, b in zip(track, track[1:]):
            a_end, b_end = a["ts"] + a["dur"], b["ts"] + b["dur"]
            assert b["ts"] >= a_end - 1e-3 or b_end <= a_end + 1e-3
