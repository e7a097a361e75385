"""K1's forward past a cluster's reach on the CPU: the plain version against
the JAX package's ``xslot_iterations_ref`` at the shapes its tiled route
(``csrc/xslot_fwd_tiled.cu``) runs on the card, N=784 at S=30 (output
stride 8 at 224 px) and N=196 at S=1000 (the CUB recipe at 448 px), and the
plans: ``_plan('fwd', ...)`` takes the tiled route there on a model of the
H100 (227 KB of shared memory a CTA) and keeps its cluster at every shape it
planned before, and the tiled route's own plan (products, scratch,
launches). Inputs are made from a seed with numpy and fed to both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.ops.slot_pallas import xslot_iterations_ref as jax_ref
from scouter_tpu_torch.ops.slot_kernel import (TILED, TILED_FWD_PRODUCTS, _plan, _smem_bytes,
                                               tiled_fwd_plan, tiled_plan, xslot_fwd_ref)

H100_SMEM, H100_SMS = 232448, 132  # opt-in shared memory per CTA (227 KB), SMs
REG_CTAS = {("fwd", True): 1, ("fwd", False): 2, ("bwd", True): 1}
SMEM_RESERVED = 1024


def h100_plan(b, n, s, kind, d=64):
    """``_plan`` on tests/test_torch_k1.py's model of the H100."""
    def smem(s_cta, resident):
        return _smem_bytes(kind, n, s_cta, d, resident)

    def active(c, s_cta, resident):
        per_sm = min((H100_SMEM + SMEM_RESERVED) // (smem(s_cta, resident) + SMEM_RESERVED),
                     2048 // 256, REG_CTAS[kind, resident])
        return H100_SMS * per_sm // c

    return _plan(b, n, s, d, kind, H100_SMEM, H100_SMS, smem, active)


def inputs(seed, b, n, s, d=64):
    """bench.py:67-74's magnitudes (a trained net's scale)."""
    rng = np.random.RandomState(seed)
    shapes = ((b, n, d), (b, n, d), (s, d), (3 * d, d), (3 * d, d), (1, 3 * d), (1, 3 * d))
    scales = (0.1, 0.1, 0.02, 0.05, 0.05, 0.05, 0.05)
    return [(rng.randn(*sh) * sc).astype(np.float32) for sh, sc in zip(shapes, scales)]


# max abs bars: bench.py:85-86 (upd 1e-4) and its S=1000 bars (upd 1e-3,
# attn 2e-2), the bars chip_smoke.py holds the tiled route to on the card;
# both sides are f32 on the CPU, so the plain version meets 1e-4 at both
@pytest.mark.parametrize("n,s", [(784, 30), (196, 1000)])
def test_plain_version_matches_jax_at_the_tiled_shapes(n, s):
    arrays = inputs(7, 2, n, s)
    upd, attn, hist = xslot_fwd_ref(*map(torch.from_numpy, arrays), emit_hist=True)
    j_upd, j_attn = jax_ref(*map(jnp.asarray, arrays))
    assert upd.shape == (2, s, 64) and attn.shape == (2, s, n) and hist.shape == (2, 3, s, 64)
    np.testing.assert_allclose(upd.numpy(), np.asarray(j_upd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(attn.numpy(), np.asarray(j_attn), rtol=0, atol=1e-4)
    # hist[:, 0] is the initial slots, broadcast: the tiled route copies them
    np.testing.assert_array_equal(hist[:, 0].numpy(), np.broadcast_to(arrays[2], (2, s, 64)))


@pytest.mark.parametrize("b,n,s", [(70, 784, 30), (16, 784, 30), (2, 784, 30),
                                   (16, 196, 1000), (2, 196, 1000), (16, 81, 2000),
                                   (16, 344, 30)])
def test_forward_plans_the_tiled_route_past_a_cluster(b, n, s):
    # where it raised ValueError before: past N=343 at S=30 and S=416 at
    # N=196; the backward's share fits no cluster there either
    assert h100_plan(b, n, s, "fwd") == TILED
    assert h100_plan(b, n, s, "bwd") == TILED


# every shape chip_smoke.py and the zoo phases run K1's forward at, and the
# documented edges of the cluster's reach: the cluster plans of before
CLUSTER_SHAPES = [(70, 49, 30, 64), (1, 49, 30, 64), (4, 49, 30, 64), (16, 49, 30, 64),
                  (16, 81, 10, 64), (16, 81, 125, 64), (16, 81, 1000, 64), (16, 49, 30, 32),
                  (70, 81, 30, 64), (70, 100, 30, 64), (4, 100, 30, 64), (4, 121, 30, 64),
                  (70, 196, 30, 64), (4, 196, 30, 64), (16, 81, 1000, 48), (16, 343, 30, 64),
                  (16, 81, 1024, 64), (16, 196, 416, 64), (16, 144, 30, 64), (16, 64, 30, 64)]


@pytest.mark.parametrize("b,n,s,d", CLUSTER_SHAPES)
def test_forward_keeps_its_cluster_where_it_fits(b, n, s, d):
    plan = h100_plan(b, n, s, "fwd", d)
    assert 1 <= plan.cluster <= min(8, s) and plan.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("b,n,s,hist,launches", [(70, 784, 30, False, 16),
                                                 (16, 784, 30, True, 17),
                                                 (16, 196, 1000, True, 17),
                                                 (16, 81, 2000, True, 14)])
def test_tiled_forward_plan(b, n, s, hist, launches):
    """The route's products are the backward's of the same shapes (the GRU's
    rows fold the batch), its row sums ride in the dots' epilogue only where
    one tile spans N, and its scratch is the layout's sum: dots, rs (each
    from a multiple of 4 floats), gi, gh and without hist two iterations'
    slots."""
    d = 64
    plan = tiled_fwd_plan(b, n, s, d, H100_SMS, hist=hist)
    assert tuple(plan.products) == TILED_FWD_PRODUCTS
    bwd = tiled_plan(b, n, s, d, H100_SMS).products
    assert all(plan.products[name] == bwd[name] for name in TILED_FWD_PRODUCTS)
    assert plan.products["gates"].rows == b * s
    assert all(p.pieces == 1 for p in plan.products.values())
    assert plan.fused == (n <= 128)
    up4 = lambda x: -(-x // 4) * 4
    assert plan.scratch_floats == (up4(b * s * n) + up4(b * s) + 6 * b * s * d
                                   + (0 if hist else 2 * b * s * d))
    assert plan.launches(3) == launches


def test_tiled_forward_plan_with_bf16_inputs():
    # one launch more (the conversion pass) and the inputs' f32 copies
    d, (b, n, s) = 64, (16, 196, 1000)
    f32 = tiled_fwd_plan(b, n, s, d, H100_SMS, hist=True)
    bf16 = tiled_fwd_plan(b, n, s, d, H100_SMS, hist=True, bf16=True)
    assert bf16.launches(3) == f32.launches(3) + 1
    assert bf16.scratch_floats == f32.scratch_floats + 2 * b * n * d + s * d + 6 * d * d + 6 * d
    # one iteration: no GRU
    assert f32.launches(1) == 5
