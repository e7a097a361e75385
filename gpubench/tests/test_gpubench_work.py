"""The work counts against hand-worked values."""

import pytest

from gpubench import harness
from gpubench.work import k1
from gpubench.work.model_flops import step_flops

import small

PEAKS = {"float32": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_k1_forward_at_the_flagship():
    # (B, N, S, d) = (70, 49, 30, 64): per element 3 x 2 x (2 S N d) = 1,128,960
    # and 2 x 2 x (2 S d 3d) = 2,949,120 operations; 70 elements
    flops = 70 * (1_128_960 + 2_949_120)
    assert flops == 285_465_600
    # bytes: k and v, the slots, both GRU weights and biases, upd and attn
    nbytes = 4 * (2 * 70 * 49 * 64 + 30 * 64 + 2 * 3 * 64 * 64 + 2 * 3 * 64 + 70 * 30 * 64
                  + 70 * 30 * 49)
    assert nbytes == 2_812_880
    assert k1.fwd_bound_s(70, 49, 30, 64, PEAKS) == pytest.approx(flops / 67e12, rel=1e-12)
    hist = nbytes + 4 * 70 * 3 * 30 * 64
    assert k1.fwd_bound_s(70, 49, 30, 64, PEAKS, hist_iters=3) == pytest.approx(
        max(flops / 67e12, hist / 3.35e12), rel=1e-12)


def test_k1_backward_at_the_flagship():
    # per element 3 x 6 x 188,160 + 2 x 6 x 737,280 = 12,234,240 operations
    flops = 70 * (3 * 6 * 188_160 + 2 * 6 * 737_280)
    assert flops == 856_396_800
    assert k1.bwd_bound_s(70, 49, 30, 64, PEAKS) == pytest.approx(flops / 67e12, rel=1e-12)
    assert k1.bwd_bound_s(70, 49, 30, 64, PEAKS) * 1e3 == pytest.approx(0.012782, rel=1e-4)


def _resnest_macs(blocks, size):
    """Multiply-adds of a ResNeSt-d backbone, counted by hand."""
    h = size // 2
    macs = h * h * (32 * 3 * 9 + 32 * 32 * 9 + 64 * 32 * 9)
    h //= 2  # max pool
    cin = 64
    for planes, stride, n in zip((64, 128, 256, 512), (1, 2, 2, 2), blocks):
        for j in range(n):
            s = stride if j == 0 else 1
            attn = max(planes * 2 // 4, 32)
            out = -(-h // s)
            macs += h * h * planes * cin                 # conv1
            macs += h * h * 2 * planes * (planes // 2) * 9  # split conv, 2 groups
            macs += planes * attn + attn * 2 * planes    # fc1, fc2 on the pooled map
            macs += out * out * 4 * planes * planes      # conv3
            if j == 0:
                macs += out * out * 4 * planes * cin     # skip projection
            cin, h = 4 * planes, out
    return macs, h


def _head_macs(n, s, d, to_k=3, iters=3):
    return n * 2048 * d + to_k * n * d * d + iters * (2 * s * n * d + 2 * s * d * 3 * d)


@pytest.mark.parametrize("name,blocks", [("flagship", (2, 2, 2, 2)), ("cub200", (3, 4, 6, 3))])
def test_model_forward_operations(name, blocks):
    cfg = (small.CUB200 if name == "cub200" else
           harness.load_json(harness.ROOT, "gpubench", "configs", f"{name}.json"))
    macs, side = _resnest_macs(blocks, cfg["img_size"])
    s = cfg["num_classes"] * cfg["slots_per_class"]
    macs += _head_macs(side * side, s, cfg["hidden_dim"])
    assert step_flops(cfg, 2, train=False) == 2 * 2 * macs


def test_training_counts_the_backward():
    cfg = harness.load_json(harness.ROOT, "gpubench", "configs", "flagship.json")
    fwd = step_flops(cfg, 2, train=False)
    both = step_flops(cfg, 2, train=True)
    # every product has two backward products but the stem conv's input
    # gradient, which no leaf needs
    assert 2.9 * fwd < both < 3.0 * fwd
