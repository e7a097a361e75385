"""The readers of the program's spans and request record (``spans.py``), on a
hand-made trace and hand-made request rows, with values worked by hand."""

import numpy as np
import pytest

from gpubench import spans
from gpubench.harness import Ctx, Outcome
from gpubench.layers import Reading
from gpubench.trace import WINDOW, DeviceOp, HostOp, TraceData

from scouter_tpu_torch.utils import tracing

MS = 1_000_000  # ns
W = (0, 100 * MS)


@pytest.fixture
def store(monkeypatch):
    """An empty request record for the test; ``put`` adds a batch's rows."""
    monkeypatch.setattr(tracing, "_ring", np.zeros((64, len(tracing.FIELDS)), np.int64))
    monkeypatch.setattr(tracing, "_written", 0)

    def put(batch, submitted, formed, launched, answered, bucket=4):
        ms = [s * MS for s in submitted]
        tracing.record_batch(1, batch, [batch * 100 + i for i in range(len(ms))], ms,
                             formed * MS, launched * MS, launched * MS, answered * MS, bucket)
    return put


def _trace(host=(), device=()):
    return TraceData([HostOp(1, WINDOW, 1, *W, (), ())] + list(host), list(device), W)


def _reading(trace):
    ctx = Ctx("c", {"compute_dtype": "float32", "batch_size": 70}, {}, 0, 1.0, True, None, 0.0)
    return Reading(ctx, Outcome({}, 1, 0, {}, 0, 0.1, trace=trace), None, None)


def _serving(put):
    """Busy 10-20 and 50-60 ms; requests submitted at -10 (before the
    window), 5 and 6 (one batch), 30, 95 and 150 (after the window); their
    batches formed -> launched at -5-2, 8-12, 35-40, 96-97 and 151-152."""
    put(4, [-10], -5, 2, 15)
    put(1, [5, 6], 8, 12, 30)
    put(2, [30], 35, 40, 70)
    put(3, [95], 96, 97, 120)
    put(5, [150], 151, 152, 160)
    return _trace(device=[DeviceOp("conv", 10 * MS, 20 * MS, 0),
                          DeviceOp("gemm", 50 * MS, 60 * MS, 0)])


def test_idle_held_counts_only_idle_time_while_a_formed_batch_is_launched(store):
    r = _reading(_serving(store))
    # formed -> launched, clipped: 0-2, 8-12, 35-40, 96-97; idle: 0-10,
    # 20-50, 60-100; overlap: 2 + 2 + 5 + 1 = 10 ms of 100 (the idle 5-8
    # and 30-35, with requests queued but no batch formed, is not counted)
    assert spans.idle_held_pct(r) == pytest.approx(10.0)


def test_the_p95_readers_ignore_requests_submitted_outside_the_window(store):
    r = _reading(_serving(store))
    # in the window: queue waits 3, 2, 5, 1 ms, services 22, 22, 35, 24 ms;
    # numpy's 95th percentile of four: the third plus 0.85 of the step
    assert spans.queue_wait_p95_ms(r) == pytest.approx(3 + 0.85 * 2)
    assert spans.service_p95_ms(r) == pytest.approx(24 + 0.85 * 11)


def test_loader_wait_divides_the_windows_waits_by_its_optimizer_steps():
    host = [HostOp(2, "loader.wait", 1, -5 * MS, 5 * MS, (), ()),  # 5 ms inside
            HostOp(3, "Optimizer.step#AdamW.step", 1, 10 * MS, 20 * MS, (), ()),
            HostOp(4, "loader.wait", 1, 30 * MS, 33 * MS, (), ()),
            HostOp(5, "Optimizer.step#AdamW.step", 1, 40 * MS, 50 * MS, (), ()),
            HostOp(6, "loader.wait", 1, 60 * MS, 62 * MS, (), ()),
            HostOp(7, "loader.gather", 2, 61 * MS, 70 * MS, (), ())]
    assert spans.loader_wait_ms(_reading(_trace(host))) == pytest.approx((5 + 3 + 2) / 2)


def test_every_reader_says_none_where_the_run_holds_nothing_of_its_kind(store):
    readers = (spans.queue_wait_p95_ms, spans.service_p95_ms, spans.idle_held_pct,
               spans.loader_wait_ms)
    for fn in readers:
        assert fn(_reading(None)) is None  # no trace
    busy = _trace(device=[DeviceOp("conv", 10 * MS, 20 * MS, 0)],
                  host=[HostOp(2, "Optimizer.step#AdamW.step", 1, 10 * MS, 20 * MS, (), ())])
    for fn in readers:
        assert fn(_reading(busy)) is None  # no request rows, no loader.wait span
    store(5, [150], 151, 152, 160)  # a request outside the window only
    for fn in readers:
        assert fn(_reading(busy)) is None
    waits = _trace(host=[HostOp(2, "loader.wait", 1, 1 * MS, 2 * MS, (), ())])
    assert spans.loader_wait_ms(_reading(waits)) is None  # no optimizer step


def test_a_program_without_a_request_record_reads_none(store, monkeypatch):
    import builtins

    store(1, [5, 6], 8, 12, 30)
    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "scouter_tpu_torch.utils" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    r = _reading(_trace(device=[DeviceOp("conv", 10 * MS, 20 * MS, 0)]))
    assert spans.queue_wait_p95_ms(r) is None and spans.idle_held_pct(r) is None
