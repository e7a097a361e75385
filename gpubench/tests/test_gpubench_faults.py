"""The harness end to end on the CPU with the timed path broken underneath:
``correct`` has to come out false for each fault a cell can have, and true
for the sound program at the same size (limits set for this size from its
readings: tests/small.py)."""

import pytest
import torch

from small import bench_with, run_small

# the numbers flagship.train compares; sound runs at this size read up to
# 3.3e-7 / 1.1e-3 / 2.3e-3 (seeds 1-2), the TF32 control 1.3e-4 / 0.057 / 1.6e-3
TRAIN_LIMITS = {"loss1_gap": 1e-5, "grad_gap": 1e-2, "change_median_gap": 0.1}
SERVE_LIMITS = {"logits_gap": 1e-4, "maps_gap": 0.5}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(4)
    return bench_with(tmp_path_factory.mktemp("gpubench"))


def test_sound_training_is_correct(bench):
    line = run_small(bench, "train_loop", TRAIN_LIMITS)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_img_s"}


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench, monkeypatch):
    from scouter_tpu_torch.train import steps

    monkeypatch.setattr(steps, "optimizer_step", lambda *a, **k: None)
    line = run_small(bench, "train_loop", TRAIN_LIMITS)
    assert not line["correct"]
    # every leaf at or above the median change reads 1
    assert line["checks"]["change_median_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_caught(bench, monkeypatch):
    from scouter_tpu_torch.train import steps

    whole = steps.scouter_loss

    def half(logits, labels, area=None, lambda_value=1.0):
        h = logits.shape[0] // 2
        return whole(logits[:h], labels[:h], area, lambda_value)

    monkeypatch.setattr(steps, "scouter_loss", half)
    line = run_small(bench, "train_loop", TRAIN_LIMITS)
    assert not line["correct"]


def test_sound_serving_is_correct(bench):
    line = run_small(bench, "serve_open", SERVE_LIMITS)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_an_answer_altered_where_it_is_produced_is_caught(bench, monkeypatch):
    from scouter_tpu_torch.serve.export import ServingModule

    forward = ServingModule.forward

    def altered(self, images_u8):
        out = forward(self, images_u8)
        out["logits"] = out["logits"].clone()
        out["logits"][:, 0] += 0.01 * out["logits"].abs().amax(dim=1)
        return out

    monkeypatch.setattr(ServingModule, "forward", altered)
    line = run_small(bench, "serve_open", SERVE_LIMITS)
    assert not line["correct"]


def test_an_answer_returned_to_another_request_is_caught(bench, monkeypatch):
    from scouter_tpu_torch.serve.export import ServingModule

    forward = ServingModule.forward

    def rolled(self, images_u8):
        out = forward(self, images_u8)
        return {k: v.roll(1, dims=0) if v.shape[0] > 1 else 255 - v if v.dtype == torch.uint8
                else -v for k, v in out.items()}

    monkeypatch.setattr(ServingModule, "forward", rolled)
    line = run_small(bench, "serve_open", SERVE_LIMITS)
    assert not line["correct"]


def test_a_traced_run_reports_per_layer_metrics_only(bench):
    line = run_small(bench, "train_loop", TRAIN_LIMITS, trace=1)
    assert line["correct"]
    # on the CPU the trace holds no device work: only the host's span is read
    assert set(line["metrics"]) == {"loader_ms.train"}
    assert line["metrics"]["loader_ms.train"]["unit"] == "ms"
