"""K1's redesign on the CPU: bfloat16 inputs through the port's xSlot op
against the Pallas kernel (interpret mode) on the same bfloat16 inputs, the
hand-written backward ``xslot_bwd_ref`` against JAX's checkpointed ``_bwd``
fed the same residuals and cotangents (also at S=1000 and at d=12), and the
plans of the CUDA kernels: the cluster plan, the backward's tiled route
wherever the forward plans and the backward's share does not fit, and the
tiled route's own plan (tile widths, pieces, scratch, launches); slot widths
that are not a multiple of 4, zero-padded for the card exactly. Inputs are
made from a seed with numpy and fed to both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.ops.slot_pallas import _bwd as jax_bwd
from scouter_tpu.ops.slot_pallas import _fused_forward as jax_fused_forward
from scouter_tpu_torch.ops.slot_kernel import (TILED_PRODUCTS, _check_dim, _plan, _smem_bytes,
                                               pad_slot_width, tiled_plan, xslot_bwd_ref,
                                               xslot_fwd_ref, xslot_iterations_fused)

TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_slot_pallas.py:30-31
H100_SMEM, H100_SMS = 232448, 132  # opt-in shared memory per CTA, SMs
# CTAs per SM that each kernel's __launch_bounds__ keeps registers for, by
# (kind, resident), and the shared memory the card reserves per CTA (sm_90)
REG_CTAS = {("fwd", True): 1, ("fwd", False): 2, ("bwd", True): 1}
SMEM_RESERVED = 1024


def h100_plan(b, n, s, kind, d=64):
    """``launch_plan`` on a model of the H100: ``_plan`` with the kernels'
    shared-memory layouts, and for cudaOccupancyMaxActiveClusters the CTAs
    per SM that shared memory, 2048 threads and registers allow, over all
    SMs (it ignores how the SMs group into GPCs)."""
    def smem(s_cta, resident):
        return _smem_bytes(kind, n, s_cta, d, resident)

    def active(c, s_cta, resident):
        per_sm = min((H100_SMEM + SMEM_RESERVED) // (smem(s_cta, resident) + SMEM_RESERVED),
                     2048 // 256, REG_CTAS[kind, resident])
        return H100_SMS * per_sm // c

    return _plan(b, n, s, d, kind, H100_SMEM, H100_SMS, smem, active)


def k1_inputs(seed, b, n, s, d=64, magnitudes="tests"):
    """``tests/test_slot_pallas.py`` magnitudes, or ``bench.py:67-74``'s."""
    rng = np.random.RandomState(seed)
    if magnitudes == "tests":
        scales = (1.0, 1.0, 1.0, 0.2, 0.2, 0.1, 0.1)
    else:
        scales = (0.1, 0.1, 0.02, 0.05, 0.05, 0.05, 0.05)
    shapes = ((b, n, d), (b, n, d), (s, d), (3 * d, d), (3 * d, d), (1, 3 * d), (1, 3 * d))
    return [(rng.randn(*sh) * sc).astype(np.float32) for sh, sc in zip(shapes, scales)]


# ------------------------------------------------------------------ bfloat16

@pytest.mark.parametrize("b,n,s,seed,magnitudes",
                         [(2, 49, 30, 0, "bench"), (2, 81, 10, 2, "tests")])
def test_bf16_inputs_match_pallas_on_the_same_bf16_inputs(b, n, s, seed, magnitudes):
    args = [torch.from_numpy(a).to(torch.bfloat16)
            for a in k1_inputs(seed, b, n, s, magnitudes=magnitudes)]
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in args]
    upd_j, attn_j = jax_fused_forward(*jargs, iters=3, interpret=True, emit_hist=False)
    with torch.no_grad():
        upd, attn = xslot_iterations_fused(*args)
    assert upd.dtype == attn.dtype == torch.float32
    np.testing.assert_allclose(upd.numpy(), np.asarray(upd_j), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j), **TOL)


def test_bf16_under_grad_is_refused():
    """No longer refused: bf16 inputs under grad take the checkpointed
    gradient, whose plain version upcasts the residuals, computes in f32 and
    returns each gradient rounded once to bf16."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in k1_inputs(0, 2, 9, 4, d=8)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    upd, attn = xslot_iterations_fused(*leaves)
    assert upd.dtype == attn.dtype == torch.float32
    grads = torch.autograd.grad((upd, attn), leaves, (2 * upd.detach(), torch.ones_like(attn)))
    f32 = [a.float().requires_grad_(True) for a in args]
    u32, a32 = xslot_iterations_fused(*f32)
    want = torch.autograd.grad((u32, a32), f32, (2 * u32.detach(), torch.ones_like(a32)))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


# ------------------------------------------------------------------ backward

def jax_and_port_bwd(args, seed, iters=3):
    """(JAX's _bwd, xslot_bwd_ref, xslot_bwd_ref in float64) on the residuals
    of the Pallas forward with hist and on seeded cotangents."""
    k, v, slots0, w_ih, w_hh, b_ih, b_hh = args
    _, _, hist = jax_fused_forward(*[jnp.asarray(a) for a in args], iters=iters,
                                   interpret=True, emit_hist=True)
    rng = np.random.RandomState(seed)
    b, n, d = k.shape
    s = slots0.shape[0]
    du = rng.randn(b, s, d).astype(np.float32)
    dattn = rng.randn(b, s, n).astype(np.float32)
    residuals = (k, v, w_ih, w_hh, b_ih, b_hh, np.array(hist))
    want = jax_bwd(iters, True, tuple(jnp.asarray(a) for a in residuals),
                   (jnp.asarray(du), jnp.asarray(dattn)))
    ours = [[g.numpy() for g in xslot_bwd_ref(*[torch.from_numpy(a.astype(dtype))
                                                for a in residuals + (du, dattn)])]
            for dtype in (np.float32, np.float64)]
    return [np.asarray(w) for w in want], *ours


@pytest.mark.parametrize("s,seed", [(10, 0), (10, 8), (30, 9)])
def test_bwd_ref_matches_jax_bwd(s, seed):
    # bench.py:67-74 magnitudes with unit cotangents. On some such draws a
    # row sum near zero puts even JAX's f32 gradient past this bar of the
    # float64 one; these draws are not such, which the first loop checks
    args = k1_inputs(seed, 2, 81, s, magnitudes="bench")
    want, got, exact = jax_and_port_bwd(args, seed + 10)
    for w, x in zip(want, exact):
        np.testing.assert_allclose(w, x, **TOL)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("s,seed", [(10, 1), (30, 3)])
def test_bwd_ref_matches_jax_bwd_on_ill_conditioned_inputs(s, seed):
    # tests/test_slot_pallas.py magnitudes: a row sum near zero amplifies f32
    # rounding, so the bar is chip_smoke.py's, 1e-4 x max(1, max |reference|)
    want, got, _ = jax_and_port_bwd(k1_inputs(seed, 2, 81, s), seed + 10)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def test_bwd_ref_matches_jax_bwd_at_the_cub_slot_count():
    # S=1000 (bench.py:64's 200 x 5 slots) at a small N and d, where the
    # backward's cross-slot sums (the renorm total's gradient, dk, dv) run
    # over a thousand slots. The gradients reach hundreds there and JAX's
    # own f32 gradient is not within rtol 1e-4 of the float64 one, so the
    # port is held to Queue C's rule: chip_smoke.py's bar, 1e-4 x max(1, max
    # |JAX|), and at most 2x JAX's distance from the float64 gradient
    args = k1_inputs(11, 2, 9, 1000, d=8, magnitudes="bench")
    want, got, exact = jax_and_port_bwd(args, 21)
    for g, w, x in zip(got, want, exact):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())
        assert np.abs(g - x).max() <= 2 * np.abs(w - x).max()


def test_d12_plain_path_matches_jax():
    # a slot width that is a multiple of 4 and not of 8: the forward through
    # the op's plain version and the hand-written backward
    args = k1_inputs(12, 2, 49, 6, d=12, magnitudes="bench")
    upd_j, attn_j = jax_fused_forward(*[jnp.asarray(a) for a in args], iters=3,
                                      interpret=True, emit_hist=False)
    with torch.no_grad():
        upd, attn = xslot_iterations_fused(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(upd.numpy(), np.asarray(upd_j), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j), **TOL)
    want, got, _ = jax_and_port_bwd(args, 22)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("iters", [1, 2])
def test_bwd_ref_matches_jax_bwd_at_other_depths(iters):
    want, got, _ = jax_and_port_bwd(k1_inputs(5, 2, 49, 6, magnitudes="bench"), 7, iters)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_cpu_backward_is_uncounted():
    args = [torch.from_numpy(a).requires_grad_() for a in k1_inputs(4, 2, 9, 4, d=8)]
    before = (xslot_iterations_fused.launches, xslot_iterations_fused.hist_launches,
              xslot_iterations_fused.bwd_launches)
    upd, attn = xslot_iterations_fused(*args)
    (upd.sum() + attn.sum()).backward()
    assert all(a.grad is not None for a in args)
    assert (xslot_iterations_fused.launches, xslot_iterations_fused.hist_launches,
            xslot_iterations_fused.bwd_launches) == before


# ---------------------------------------------------------------------- plan

@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("b,n,s", [(70, 49, 30), (16, 49, 30), (16, 81, 10), (16, 81, 125),
                                   (1, 49, 30), (4, 49, 30)])
def test_plan_fits_every_chip_smoke_shape(kind, b, n, s):
    plan = h100_plan(b, n, s, kind)
    assert 1 <= plan.cluster <= min(8, s)
    assert plan.slots_per_cta == -(-s // plan.cluster)
    assert plan.smem_bytes == _smem_bytes(kind, n, plan.slots_per_cta, 64,
                                          plan.resident) <= H100_SMEM
    assert kind == "fwd" or plan.resident  # the backward keeps its GRU weights resident
    assert plan.ctas_per_sm >= 1
    assert b <= plan.clusters  # one wave
    assert b * plan.cluster <= H100_SMS * plan.ctas_per_sm


def test_plan_of_the_cub_config_forward():
    # bench.py:64: S=1000 at N=81, B=16
    plan = h100_plan(16, 81, 1000, "fwd")
    assert plan.cluster <= 8 and plan.smem_bytes <= H100_SMEM
    # 125 slots per CTA leave no room for the whole of the GRU weights
    assert not plan.resident


def test_plan_of_the_flagship_is_one_wave_and_splits_small_batches():
    fwd = h100_plan(70, 49, 30, "fwd")
    assert 70 * fwd.cluster <= H100_SMS * fwd.ctas_per_sm and fwd.resident
    assert h100_plan(1, 49, 30, "fwd").cluster == 8


@pytest.mark.parametrize("b", [1, 4, 16])
def test_backward_plan_at_the_engines_buckets(b):
    # N=49, S=30: 4 slots a CTA on a cluster of 8 (the card itself may hold
    # fewer clusters of 8 at once than this model, which ignores how SMs
    # group into GPCs, and then plans fewer CTAs), the GRU weights resident
    # beside them, N padded to 52: 2 x 192 x 68 + 2 x 52 x 68 + 4 x 4 x 68 +
    # 3 x 4 x 52 + 3 x 4 + 4 x 4 x 64 + 6 x 64 floats
    plan = h100_plan(b, 49, 30, "bwd")
    assert (plan.cluster, plan.slots_per_cta, plan.resident) == (8, 4, True)
    assert plan.smem_bytes == 4 * (26112 + 7072 + 1088 + 624 + 12 + 1024 + 384) == 145264


def test_backward_plan_of_the_flagship_batch():
    # B=70 stays one wave: one CTA an element holds all 30 slots beside the
    # resident weights, within one SM's shared memory
    plan = h100_plan(70, 49, 30, "bwd")
    assert (plan.cluster, plan.slots_per_cta, plan.resident) == (1, 30, True)
    assert plan.smem_bytes == 222208 <= H100_SMEM
    assert 70 <= plan.clusters


@pytest.mark.parametrize("b,n,s,d,cluster", [(16, 49, 30, 64, True), (16, 128, 30, 64, True),
                                             (16, 144, 30, 64, True), (16, 192, 30, 64, True),
                                             (16, 196, 30, 64, False), (16, 81, 192, 64, True),
                                             (16, 81, 200, 64, False), (1, 49, 8, 84, True),
                                             (1, 49, 8, 88, False)])
def test_backward_cluster_reach(b, n, s, d, cluster):
    # the reach in xslot_iterations_fused's docstring: dk and dv held in
    # registers (N/4 * d/4 <= 768 tiles) bound N at S=30 (448 px's N=196
    # takes the tiled route), shared memory bounds S at N=81 and the
    # resident weights bound d; past it the tiled route
    assert h100_plan(b, n, s, "fwd", d).cluster >= 1
    assert h100_plan(b, n, s, "bwd", d).tiled != cluster


@pytest.mark.parametrize("kind,launches", [("fwd", 1), ("bwd", 2)])
def test_cluster_plan_counts_its_launches(kind, launches):
    # chip_smoke.py holds the launches of one call (its CUDA graph's nodes)
    # to this: the forward's kernel; the backward's gradient kernel and its sum
    assert h100_plan(16, 49, 30, kind).launches(kind) == launches
    with pytest.raises(ValueError, match="TiledPlan"):
        h100_plan(16, 81, 1000, "bwd").launches("bwd")


@pytest.mark.parametrize("kind,s", [("fwd", 2000), ("bwd", 2000)])
def test_plan_past_eight_ctas_raises(kind, s):
    # past the forward's cluster reach (S=1024 at N=81) both take their tiled
    # routes, where the forward raised ValueError before it had one
    plan = h100_plan(16, 81, s, kind)
    assert plan.tiled and plan.cluster == 0


@pytest.mark.parametrize("b,n,s", [(16, 81, 1000), (64, 81, 1000), (70, 196, 30)])
def test_backward_takes_its_tiled_route_past_a_cluster(b, n, s):
    # the CUB recipe at batch 16 and 64 (bench.py:64, config.py:49) and 448 px
    # at the flagship's slots: no cluster of 8 holds the backward's share
    assert h100_plan(b, n, s, "fwd").cluster >= 1
    plan = h100_plan(b, n, s, "bwd")
    assert plan.tiled and plan.cluster == 0


@pytest.mark.parametrize("b,n,s", [(16, 81, 1000), (64, 81, 1000), (70, 196, 30)])
def test_tiled_plan_at_the_tiled_shapes(b, n, s):
    """The tiled route's plan on the H100 (132 SMs): its scratch is the
    layout's sum, a split product has at most 8 pieces and the others one,
    the GRU's products fold the batch into B*S rows, and one call makes at
    most 50 launches (66 before the redesign at (16, 81, 1000))."""
    d, iters = 64, 3
    plan = tiled_plan(b, n, s, d, H100_SMS)
    prods = plan.products
    assert tuple(prods) == TILED_PRODUCTS
    for name, prod in prods.items():
        assert prod.tile_cols in (64, 128)
        assert 1 <= prod.pieces <= (8 if name in ("dw", "dkv") else 1), name
    assert prods["gates"].rows == prods["dgates"].rows == b * s
    assert prods["dw"].rows == 3 * d and prods["dkv"].rows == n
    assert plan.fused == (n <= 128)
    kv = prods["dkv"].pieces
    partials = prods["dw"].pieces * b * (2 * 3 * d * d + 2 * 3 * d)
    buffers = b * s * (4 * d + 2 * 3 * d + 3 * n + 3)
    assert plan.scratch_floats == partials + buffers + (2 * kv * b * n * d if kv > 1 else 0)
    assert plan.launches(iters) <= 50


def test_tiled_plan_of_the_cub_step():
    # at B=16 the slots split dW, dv and dk into as many pieces as the card
    # holds CTAs of them at once (2 x 132 at 64 columns), the 16000 GRU rows
    # are one product, and the row passes ride in the epilogues (N=81 fits
    # one 128-column tile): 30 launches
    plan = tiled_plan(16, 81, 1000, 64, H100_SMS)
    assert plan.products["gates"].rows == 16000
    assert plan.products["dw"].pieces == 4 and plan.products["dkv"].pieces == 7
    assert plan.fused and plan.launches(3) == 30
    # unsplit and unfused at (70, 196, 30): two row passes more an iteration
    plan = tiled_plan(70, 196, 30, 64, H100_SMS)
    assert plan.products["dw"].pieces == plan.products["dkv"].pieces == 1
    assert not plan.fused and plan.launches(3) == 36
    # one iteration runs no GRU: its partials are zeroed by a memset
    assert tiled_plan(16, 81, 1000, 64, H100_SMS).launches(1) == 9


@pytest.mark.parametrize("b,n,s", [(16, 81, 1000), (70, 196, 30)])
def test_tiled_plan_with_bf16_residuals(b, n, s):
    """bf16 residuals: the same products, one launch more (the pass that
    converts the residuals), and the scratch holds their f32 copies (from a
    multiple of 4 floats) and dv's and dk's pieces even unsplit."""
    d = 64
    f32, bf16 = tiled_plan(b, n, s, d, H100_SMS), tiled_plan(b, n, s, d, H100_SMS, bf16=True)
    assert bf16.products == f32.products and bf16.fused == f32.fused
    assert bf16.launches(3) == f32.launches(3) + 1
    kv = f32.products["dkv"].pieces
    extra = (2 * b * n * d if kv == 1 else 0) + 2 * b * n * d + 6 * d * d + 6 * d + 3
    assert bf16.scratch_floats == f32.scratch_floats + extra


def test_tiled_plan_at_d48():
    # the CUB shape at d=48, which chip_smoke.py also runs on the card: no
    # cluster of 8 holds its share either, and its dv, dk and dW keep
    # 64-column tiles (48 columns, 3 x 48 rows) split over the slots
    assert h100_plan(16, 81, 1000, "bwd", d=48).tiled
    plan = tiled_plan(16, 81, 1000, 48, H100_SMS)
    prods = plan.products
    assert prods["gates"].rows == 16000 and prods["dw"].rows == 144
    assert prods["dw"].tile_cols == prods["dkv"].tile_cols == 64
    assert prods["dw"].pieces > 1 and prods["dkv"].pieces > 1
    assert plan.fused and plan.launches(3) == 30


@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("n", [49, 81, 196])
def test_backward_plans_wherever_the_forward_does(n, d):
    planned = 0
    for b in (1, 4, 16, 64, 70):
        for s in (10, 30, 125, 400, 1000, 1024, 2000):
            try:
                h100_plan(b, n, s, "fwd", d)
            except ValueError:
                with pytest.raises(ValueError, match="cluster of 8"):
                    h100_plan(b, n, s, "bwd", d)
                continue
            plan = h100_plan(b, n, s, "bwd", d)
            assert plan.tiled or (1 <= plan.cluster <= min(8, s)
                                  and plan.smem_bytes <= H100_SMEM)
            planned += 1
    assert planned >= 20


@pytest.mark.parametrize("d", [4, 12, 48, 64, 96, 1024])
def test_any_slot_width_that_is_a_multiple_of_four_runs(d):
    _check_dim(d)
    args = [torch.from_numpy(a) for a in k1_inputs(0, 1, 3, 2, d)]
    assert all(torch.equal(x, y) for x, y in zip(pad_slot_width(*args), args))


@pytest.mark.parametrize("d", [0, -1, -4, -64])
def test_other_slot_widths_raise(d):
    # every width from 1 up runs (zero-padded to a multiple of 4 on the
    # card); only a width below 1 is refused
    with pytest.raises(ValueError, match="d >= 1"):
        _check_dim(d)


@pytest.mark.parametrize("d", [30, 1100, 6, 50])
def test_slot_widths_off_four_are_taken_and_padded_exactly(d):
    """Widths the card once refused (d % 4, d > 1024): the CUDA launches take
    them zero-padded to the next multiple of 4, the scale and the update's
    divisor on the true d. The padded plain call's outputs, cut back to d,
    equal the unpadded ones bit for bit (the padded columns add exact
    zeros, and the GRU keeps them at zero); its hist lies within f32
    rounding of the unpadded one (the CPU's GEMM blocks a GRU product of
    another width otherwise: 1 ulp at d = 30); the padded backward's
    gradients, cut back, match the unpadded ones to f32 rounding (its bias
    sums reduce rows of another width), and the padded gradients of the
    padded columns are zero. Past d = 1024 both directions plan their tiled
    routes."""
    _check_dim(d)
    b, n, s = 2, 7, 5
    args = [torch.from_numpy(a) for a in k1_inputs(3, b, n, s, d, magnitudes="bench")]
    padded = pad_slot_width(*args)
    d4 = -(-d // 4) * 4
    assert padded[0].shape == (b, n, d4) and padded[3].shape == (3 * d4, d4)
    assert padded[5].shape == (1, 3 * d4)
    upd, attn, hist = xslot_fwd_ref(*args, emit_hist=True)
    p_upd, p_attn, p_hist = xslot_fwd_ref(*padded, emit_hist=True, dim=d)
    assert torch.equal(p_upd[..., :d], upd) and torch.equal(p_attn, attn)
    np.testing.assert_allclose(p_hist[..., :d].numpy(), hist.numpy(), rtol=1e-6, atol=1e-8)
    assert not p_upd[..., d:].any() and not p_hist[..., d:].any()
    rng = np.random.RandomState(4)
    du = torch.from_numpy(rng.randn(b, s, d).astype(np.float32))
    dattn = torch.from_numpy(rng.randn(b, s, n).astype(np.float32))
    res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
    want = xslot_bwd_ref(*res, du, dattn)
    p_res = (padded[0], padded[1], padded[3], padded[4], padded[5], padded[6], p_hist)
    got = xslot_bwd_ref(*p_res, torch.nn.functional.pad(du, (0, d4 - d)), dattn, dim=d)
    cut = (got[0][..., :d], got[1][..., :d], got[2][:, :d],
           *(g.reshape(3, d4, -1)[:, :d, :d if g.shape[0] != 1 else None].reshape(w.shape)
             if g.shape[0] != 1 else g.reshape(3, d4)[:, :d].reshape(1, 3 * d)
             for g, w in zip(got[3:], want[3:])))
    for g, w in zip(cut, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    assert not got[0][..., d:].any() and not got[1][..., d:].any()
    if d > 1024:
        assert h100_plan(b, n, s, "fwd", d4).tiled and h100_plan(b, n, s, "bwd", d4).tiled


def test_plan_takes_the_cards_footprint_and_occupancy():
    # the plan reads both from what it is given, not from the Python layout
    seen = []

    def active(c, s_cta, resident):
        seen.append((c, s_cta, resident))
        return 6 if c <= 4 else 0  # clusters of more than 4 do not fit

    plan = _plan(4, 49, 30, 64, "bwd", 1000, 132, lambda s_cta, resident: 10 * s_cta, active)
    assert (plan.cluster, plan.slots_per_cta, plan.smem_bytes, plan.clusters) == (4, 8, 80, 6)
    assert plan.ctas_per_sm == 1 and plan.resident
    assert all(r for _, _, r in seen)  # the backward asks only for resident weights
    # a footprint past the card's shared memory: the tiled route, which
    # raised ValueError for the forward before it had one
    assert _plan(4, 49, 30, 64, "fwd", 1000, 132, lambda s_cta, resident: 1001,
                 active).tiled
