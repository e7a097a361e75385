"""K1's forward past a cluster's reach on the CPU: the plain version against
the JAX package's ``xslot_iterations_ref`` at the shapes its tiled route
(``csrc/xslot_fwd_tiled.cu``) runs on the card, N=784 at S=30 (output
stride 8 at 224 px) and N=196 at S=1000 (the CUB recipe at 448 px), and the
plans: ``_plan('fwd', ...)`` takes the tiled route there on a model of the
H100 (227 KB of shared memory a CTA) and keeps its cluster at every shape it
planned before, and the tiled route's own plan (``split_fwd_plan``: its
split of each element over a cluster, shared memory, mode, launches). Inputs
are made from a seed with numpy and fed to both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.ops.slot_pallas import xslot_iterations_ref as jax_ref
from scouter_tpu_torch.ops.slot_kernel import (TILED, SplitFwdPlan, _plan, _smem_bytes,
                                               _split_scratch_floats, _split_smem_bytes,
                                               split_fwd_plan, xslot_fwd_ref)

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


# cudaOccupancyMaxActiveClusters for the route's kernel on an NVIDIA H100
# 80GB HBM3 at one CTA an SM, by cluster size: a cluster lies within one GPC,
# so clusters of 10 to 16 CTAs fit 7 at once (measured on the card)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
                 **{c: 7 for c in range(10, 17)}}


def h100_split_plan(b, n, s, d=64, grid=True):
    """``split_fwd_plan`` on a model of the H100: the kernel's shared-memory
    layout; for cudaOccupancyMaxActiveClusters the card's count by cluster
    size while shared memory allows one CTA an SM (512 threads of up to 128
    registers fill its register file); for a grid, every SM's CTA (none
    where ``grid`` is false)."""
    def smem(cs, cn, tile, streamed, spill):
        return _split_smem_bytes(n, s, d, cs, cn, tile, streamed, spill)

    def fits(*args):
        return smem(*args) + SMEM_RESERVED <= H100_SMEM + SMEM_RESERVED

    def active(cs, cn, tile, streamed, spill):
        return H100_CLUSTERS[cs * cn] if fits(cs, cn, tile, streamed, spill) else 0

    def ctas(*args):
        return H100_SMS if fits(*args) else 0

    return split_fwd_plan(b, n, s, d, H100_SMEM, H100_SMS, smem, active,
                          ctas if grid else None)


# the three shapes the main paths run (output stride 8 served and trained,
# the CUB recipe at 448 px), the cluster forward's edges, and two widths the
# card once refused, padded to 32 and 1100
@pytest.mark.parametrize("b,n,s,d", [(70, 784, 30, 64), (16, 784, 30, 64), (16, 196, 1000, 64),
                                     (16, 344, 30, 64), (16, 196, 417, 64), (4, 49, 30, 32),
                                     (4, 49, 30, 1100)])
def test_tiled_forward_plan(b, n, s, d):
    """At most 16 CTAs an element that split the slots (cs <= S) and the
    positions (cn <= N), each CTA's shared memory within 232,448 bytes and
    the layout's sum; one launch a call; the slot buffers in shared memory,
    so scratch only for a grid's group totals; k and v resident wherever a
    cluster holds them (the grid at S=1000 streams them: its 8 slot groups
    hold their slot buffers, not k and v beside them)."""
    plan = h100_split_plan(b, n, s, d)
    assert isinstance(plan, SplitFwdPlan)
    assert 1 <= plan.cluster <= 16 and plan.slot_groups <= s and plan.position_groups <= n
    assert plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes == _split_smem_bytes(n, s, d, plan.slot_groups, plan.position_groups,
                                                plan.tile, plan.streamed, plan.spill)
    assert not plan.spill
    assert plan.scratch_floats == (4 * b * plan.slot_groups if plan.grid else 0)
    assert plan.launches(3) == plan.launches(1) == 1
    assert plan.grid == (s == 1000)  # where clusters of 16 would take three waves
    assert plan.streamed == (d == 1100 or plan.grid)
    assert plan.tile <= 64 and plan.clusters >= 1


def test_tiled_forward_plan_with_bf16_inputs():
    # bf16 inputs are converted on load: the same layout and plan (only the
    # card's occupancy of the bf16 instance could differ), one launch
    f32 = h100_split_plan(16, 196, 1000)
    assert f32.slot_groups * f32.position_groups == f32.cluster
    smem = _split_smem_bytes(196, 1000, 64, f32.slot_groups, f32.position_groups, f32.tile,
                             f32.streamed, f32.spill)
    assert smem == f32.smem_bytes and f32.launches(3) == 1
    # S=1000 needs a slot split: a whole element's slots fit no CTA
    assert f32.slot_groups >= 8


def test_tiled_forward_plan_streams_and_spills_only_past_reach():
    # N = 10000: no split of 16 CTAs holds the shares of k and v, so they
    # stream through a ring; S = 5000: no split holds the slot buffers, so
    # they spill to scratch, B x c CTAs' regions of 4 or 5 buffers
    far = h100_split_plan(4, 10000, 30)
    assert far.streamed and not far.spill and far.tile <= 32
    many = h100_split_plan(2, 49, 5000)
    assert many.spill and many.smem_bytes <= H100_SMEM
    slp, ld = -(-(-(-5000 // many.slot_groups)) // 4) * 4, 68
    buffers = 5 if many.position_groups > 1 else 4
    assert many.scratch_floats == 2 * many.cluster * buffers * slp * ld


def test_tiled_forward_plan_takes_the_cards_occupancy():
    # the plan reads footprints and occupancy from what it is given: with
    # clusters past 8 refused it stays within 8; with nothing fitting it
    # raises rather than fall back
    def smem(cs, cn, tile, streamed, spill):
        return _split_smem_bytes(784, 30, 64, cs, cn, tile, streamed, spill)

    plan = split_fwd_plan(70, 784, 30, 64, H100_SMEM, H100_SMS, smem,
                          lambda cs, cn, *_: 16 if cs * cn <= 8 else 0)
    assert plan.cluster <= 8 and plan.clusters == 16
    with pytest.raises(ValueError, match="no cluster of up to 16"):
        split_fwd_plan(70, 784, 30, 64, H100_SMEM, H100_SMS, smem, lambda *_: 0)


def test_tiled_forward_takes_a_grid_where_clusters_take_waves():
    # the CUB recipe at 448 px: 16 CTAs an element fit 7 clusters at once,
    # 3 waves for 16 elements; a grid of 8 slot groups an element holds all
    # 128 CTAs at once (its cost 24/128 against the clusters' 3 x 32/256)
    plan = h100_split_plan(16, 196, 1000)
    assert plan.grid and (plan.slot_groups, plan.position_groups) == (8, 1)
    assert plan.streamed and plan.tile == 32 and 16 * plan.slot_groups <= H100_SMS
    assert plan.clusters == 16 and plan.scratch_floats == 4 * 16 * 8
    # without a grid the clusters of 16 stay, in three waves
    clusters = h100_split_plan(16, 196, 1000, grid=False)
    assert not clusters.grid and clusters.cluster == 16 and clusters.clusters == 7
    assert clusters.scratch_floats == 0


@pytest.mark.parametrize("b,n,s", [(2, 196, 1000), (16, 784, 30), (70, 784, 30), (4, 196, 1000)])
def test_tiled_forward_keeps_clusters_in_one_wave_or_past_a_grid(b, n, s):
    # a grid only where clusters take more than one wave and it costs less:
    # 2 and 4 elements fit one wave of clusters of 16, 16 of 6 CTAs too; 70
    # elements take two waves of 3 CTAs each, but a grid of 70 holds one
    # slot group an element (its CTAs then hold every position: dearer)
    assert not h100_split_plan(b, n, s).grid


def test_tiled_forward_grid_holds_every_cta_at_once():
    # the grid's CTAs must all be resident (a cooperative launch): with 100
    # CTAs at once, 16 elements take at most 6 slot groups each
    def smem(cs, cn, tile, streamed, spill):
        return _split_smem_bytes(196, 1000, 64, cs, cn, tile, streamed, spill)

    plan = split_fwd_plan(16, 196, 1000, 64, H100_SMEM, H100_SMS, smem,
                          lambda cs, cn, *_: H100_CLUSTERS[cs * cn], lambda *_: 100)
    assert plan.grid and 16 * plan.slot_groups <= 100
    assert _split_scratch_floats(16, 1000, 64, plan.slot_groups, 1, False, True) == \
        plan.scratch_floats == 4 * 16 * plan.slot_groups
    # and none where no grid of two slot groups fits at once
    plan = split_fwd_plan(16, 196, 1000, 64, H100_SMEM, H100_SMS, smem,
                          lambda cs, cn, *_: H100_CLUSTERS[cs * cn], lambda *_: 16)
    assert not plan.grid and plan.cluster == 16
