"""The trace's reduction and the per-layer readers, on a hand-made trace."""

import pytest

from gpubench import layers
from gpubench.harness import Ctx, Outcome
from gpubench.trace import WINDOW, DeviceOp, HostOp, TraceData

MS = 1_000_000  # ns

PEAKS = {"float32": 67e12, "bfloat16": 989e12, "hbm_bytes_per_s": 3.35e12}


def _trace():
    host = [
        HostOp(1, WINDOW, 1, 0, 100 * MS, (), ()),
        HostOp(2, "Optimizer.step#AdamW.step", 1, 2 * MS, 20 * MS, (), ()),
        HostOp(3, "aten::_foreach_add_", 1, 11 * MS, 12 * MS, (), ()),
        HostOp(4, "scouter_tpu_torch::xslot_fwd_hist", 1, 30 * MS, 31 * MS,
               ((70, 49, 64), (70, 49, 64), (30, 64), (192, 64), (192, 64), (1, 192),
                (1, 192), ()), ("float",) * 7 + ("Scalar",)),
        HostOp(5, "aten::empty", 1, 30 * MS + 100, 30 * MS + 200, (), ()),
        HostOp(6, "scouter_tpu_torch::xslot_bwd", 2, 50 * MS, 52 * MS,
               ((70, 49, 64), (70, 49, 64), (192, 64), (192, 64), (1, 192), (1, 192),
                (70, 3, 30, 64), (70, 30, 64), (70, 30, 49)), ("float",) * 9),
        HostOp(7, "aten::conv2d", 1, 60 * MS, 61 * MS, (), ()),
    ]
    device = [
        DeviceOp("adam_kernel", 13 * MS, 15 * MS, 3),          # under the optimizer
        DeviceOp("k1_fwd", 32 * MS, 33 * MS, 5),               # launched inside the custom op
        DeviceOp("k1_bwd", 53 * MS, 56 * MS, 6),
        DeviceOp("conv", 62 * MS, 72 * MS, 7),
        DeviceOp("conv_overlap", 70 * MS, 74 * MS, 7),
        DeviceOp("after_window", 99 * MS, 120 * MS, 7),         # clipped at 100 ms
    ]
    return TraceData(host, device, (0, 100 * MS))


def _reading(trace, layer=None, dtype="float32"):
    ctx = Ctx("c", {"compute_dtype": dtype, "batch_size": 70}, {}, 0, 1.0, True, None, 0.0)
    out = Outcome({}, 1, 0, {}, 0, 0.1, trace=trace, layer=layer or {})
    return layers.Reading(ctx, out, PEAKS, lambda batch, train: 1e9 * batch)


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    # 2 + 1 + 3 + (62..74 = 12) + (99..100 = 1) ms
    assert t.busy_s() == pytest.approx(19e-3)
    assert t.window_s == pytest.approx(0.1)
    assert layers.idle_share_pct(_reading(t)) == pytest.approx(81.0)


def test_device_time_is_attributed_by_the_launching_op():
    t = _trace()
    assert t.device_s_under(("Optimizer.step#",)) == (pytest.approx(2e-3), 1)
    assert t.device_s_under(("scouter_tpu_torch::xslot_",)) == (pytest.approx(4e-3), 2)
    assert layers.optimizer_ms(_reading(t)) == pytest.approx(2.0)


def test_k1_roofline_sums_each_calls_bound():
    from gpubench.work import k1

    t = _trace()
    bound = (k1.fwd_bound_s(70, 49, 30, 64, PEAKS, hist_iters=3)
             + k1.bwd_bound_s(70, 49, 30, 64, PEAKS, iters=3))
    assert layers.k1_roofline_pct(_reading(t)) == pytest.approx(100 * bound / 4e-3)


def test_breakdown_names_device_ops_and_idle_gaps():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["conv", pytest.approx(10e-3)]
    names = [g[0] for g in b["idle_gaps"]]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # the gap before the optimizer's kernel: the host was in the optimizer's step
    assert "Optimizer.step#AdamW.step" in names


def test_readers_return_none_without_a_trace():
    r = _reading(None)
    for fn in (layers.idle_share_pct, layers.optimizer_ms, layers.k1_roofline_pct):
        assert fn(r) is None
    assert layers.loader_ms(r) is None
    assert layers.batch_fill_pct(r) is None and layers.mfu_pct(r) is None


def test_mfu_counts_operations_over_the_window():
    r = _reading(None, layer={"images": 700, "train": True})
    # 1e9 operations an image, 700 images over 0.1 s against 67e12
    assert layers.mfu_pct(r) == pytest.approx(100 * 1e9 * 700 / 0.1 / 67e12)
