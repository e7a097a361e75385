"""The plain reference against the program, on the CPU at small sizes (the
program's K1 runs its plain version there)."""

import pytest
import torch

from gpubench import harness
from gpubench.compare import train_numbers
from gpubench.loops import train as T
from gpubench.reference import model as ref
from gpubench.weights import make_weights

import small


def _config(name):
    return harness.load_json(harness.ROOT, "gpubench", "configs", f"{name}.json")


@pytest.mark.parametrize("name", ["flagship", "cub200"])
def test_spec_names_every_entry_of_the_programs_state_dict(name):
    from scouter_tpu_torch.models import build_slot_model

    cfg = small.CUB200 if name == "cub200" else _config(name)
    ctx = harness.Ctx(name, cfg, {}, 0, 1.0, False, torch.device("cpu"), 0.0)
    model = build_slot_model(harness.port_config(ctx, cfg["batch_size"]), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(shape) for k, shape, _ in ref.param_spec(cfg)}
    assert got == want


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program(train):
    from scouter_tpu_torch.data.transforms import preprocess_batch
    from scouter_tpu_torch.models import build_slot_model

    cfg = small.TRAIN
    ctx = harness.Ctx("small", cfg, {}, 11, 1.0, False, torch.device("cpu"), 0.0)
    model = build_slot_model(harness.port_config(ctx, 8), fused_slot=True, device="meta")
    model = model.to_empty(device="cpu")
    W = make_weights(ref.param_spec(cfg), 11, "cpu")
    model.load_state_dict(W)
    model.train(train)
    x = torch.from_numpy(harness.seeded_images(ctx, 8, stream=2))
    with torch.no_grad():
        out = model(preprocess_batch(x, dataset="ImageNet", img_size=96)
                    .permute(0, 3, 1, 2).contiguous())
        logits, area, attn = ref.forward(W, x, cfg, train=train)
    scale = logits.abs().max()
    assert (out["logits"] - logits).abs().max() <= 1e-4 * scale
    assert (out["attn"] - attn).abs().max() <= 1e-4
    assert abs(float(out["area_loss"]) - float(area)) <= 1e-5 * float(area)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [[torch.randn(t.shape, generator=g) for t in p0] for _ in range(3)]
    mine = [t.clone() for t in p0]
    theirs = [torch.nn.Parameter(t.clone()) for t in p0]
    opt = torch.optim.AdamW(theirs, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    state = {}
    for step, gs in enumerate(grads, start=1):
        ref.adamw_step(mine, gs, state, step, 1e-3)
        for p, gr in zip(theirs, gs):
            p.grad = gr.clone()
        opt.step()
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


def test_three_train_steps_follow_the_program():
    ctx = harness.Ctx("small", small.TRAIN, dict(small.SMALL, aug=False), 2, 1.0, False,
                      torch.device("cpu"), 0.0)
    prog = T.TrainRun(ctx)
    got = prog.first_steps()
    prog.close()
    exact = T.reference_readings(ctx)
    numbers = train_numbers(got, exact)
    assert max(abs(p - r) / abs(r) for p, r in zip(got["losses"], exact["losses"])) < 1e-3
    assert numbers["grad_gap"] < 1e-2


def test_maps_render_as_the_program_renders_them():
    from scouter_tpu_torch.serve.export import _render_slot_maps

    attn = torch.rand(3, 6, 9, generator=torch.Generator().manual_seed(1))
    cfg = dict(small.TRAIN)
    assert torch.equal(ref.render_maps(attn, cfg), _render_slot_maps(attn, 3, 2))


def test_config_files_hold_the_keys_the_harness_reads():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert set(small.TRAIN) <= set(cfg), set(small.TRAIN) - set(cfg)
        assert cfg["source"] == c["source"] and cfg["compute_dtype"] in ("float32", "bfloat16")
