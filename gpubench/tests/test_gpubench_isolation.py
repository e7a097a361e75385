"""The benchmark runs the PyTorch port alone: nothing it or a run loads is JAX
or the JAX package, and the reference and the work counts import nothing of
the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from gpubench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "scouter_tpu"}
HERE = os.path.join(harness.ROOT, "gpubench")

_CHILD = r"""
import importlib, json, os, pkgutil, sys, tempfile
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "gpubench", "tests"))
import torch
torch.set_num_threads(2)
import gpubench
for m in pkgutil.walk_packages(gpubench.__path__, "gpubench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from gpubench import run as R
for name in os.listdir(os.path.join({root!r}, "gpubench", "metrics")):
    if name.endswith(".py"):
        R._reader(name[:-3])
import small
bench = small.bench_with(tempfile.mkdtemp())
for traffic in ("train_loop", "serve_open"):
    small.run_small(bench, traffic, {{}}, trace=int(traffic == "train_loop"), seconds=0.5)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _CHILD.format(root=harness.ROOT)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "scouter_tpu_torch" in loaded and "gpubench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_and_work_import_nothing_of_the_program():
    for sub in ("reference", "work"):
        for path in glob.glob(os.path.join(HERE, sub, "*.py")):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert "scouter_tpu_torch" not in tops, path
            assert tops <= {"torch", "math", "typing", "__future__", "statistics"}, (path, tops)


def test_the_run_refuses_where_a_forbidden_module_is_loaded(monkeypatch):
    from gpubench import run as R

    monkeypatch.setitem(sys.modules, "scouter_tpu_torch_extra", sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert R.forbidden_modules() == ["jax"]
