"""The control of the comparison: the reference put in the program's place one
precision step below the configuration's has to come out as not correct.
On the CPU at a small size; on the card (``-m card``) at each cell's own
size, the serving cell's on as many answers as a run compares."""

import pytest
import torch

from gpubench import harness
from gpubench.compare import held, serve_numbers, train_numbers
from gpubench.loops import train as T
from gpubench.loops.serving import reference_answers
from gpubench.reference.precision import by_name

import small

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _ctx(config, seed, device="cpu", params=None):
    return harness.Ctx("small", config, dict(params or small.SMALL, aug=False), seed, 1.0,
                       False, torch.device(device), 0.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from gpubench.reference.precision import _round_tf32

    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0], dtype=torch.float32)
    # ties round away from zero; below half an ulp rounds down
    assert _round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_control_reads_far_above_the_program(dtype):
    config = dict(small.TRAIN, compute_dtype=dtype)
    for seed in (1, 2):
        ctx = _ctx(config, seed)
        prog = T.TrainRun(ctx)
        got = prog.first_steps()
        prog.close()
        exact = T.reference_readings(ctx)
        sound = train_numbers(got, exact)
        control = train_numbers(T.reference_readings(ctx, by_name(CONTROL[dtype])), exact)
        assert control["grad_gap"] > 3 * sound["grad_gap"], (sound, control)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_control_reads_far_above_the_program(dtype):
    from scouter_tpu_torch.serve.export import make_serving_fn
    from gpubench.reference import model as ref
    from gpubench.weights import make_weights

    config = dict(small.TRAIN, compute_dtype=dtype)
    ctx = _ctx(config, 4)
    images = harness.seeded_images(ctx, 8, stream=4)
    fn = make_serving_fn(harness.port_config(ctx, 8),
                         make_weights(ref.param_spec(config), 4, "cpu"),
                         compute_dtype=torch.bfloat16 if dtype == "bfloat16" else None,
                         device="cpu")
    out = fn(images)
    prog = [{"logits": lg.numpy(), "slot_maps": m.numpy()}
            for lg, m in zip(out["logits"], out["slot_maps"])]
    exact = reference_answers(ctx, images)
    sound = serve_numbers(prog, exact)
    control = serve_numbers(reference_answers(ctx, images, by_name(CONTROL[dtype])), exact)
    assert control["logits_gap"] > 3 * sound["logits_gap"], (sound, control)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship.train", "flagship.serve_open"])
def test_control_fails_the_cells_limits_at_its_size(card, cell):
    from gpubench.control import readings

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    ctx = harness.load_ctx(bench, cell, 7, 1.0, False, card, 0.0)
    control = readings(ctx, "control")
    assert not all(c["ok"] for c in held(control, ctx.params["limits"]).values()), control
