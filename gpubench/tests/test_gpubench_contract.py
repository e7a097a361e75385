"""BENCHMARK.json against the benchmark's rules, and every file it names."""

import json
import os
import re
import subprocess
import sys

import pytest

from gpubench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
HERE = os.path.join(harness.ROOT, "gpubench")


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1] == "gpubench/run.py"
    assert len(json.dumps(BENCH)) < 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for n in names:
            assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        _line(m["layer"])
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/configs/")
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        _line(c["why"])
        _line(c["source"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        _line(w["why"])
        traffic = harness.load_json(HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(HERE, "loops", f"{traffic['loop']}.py"))
        cell = harness.load_json(HERE, "cells", f"{w['name']}.json")
        assert cell["limits"], w["name"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", ())]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_per_layer_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_run_without_a_card_exits_without_a_result(cell):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
