"""Nothing the harness runs imports JAX, Flax or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``volpick_tpu_torch`` begins with ``volpick_tpu`` and is not it."""

import ast
import json
import subprocess
import sys
import types

import pytest

from conftest import REPO
from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "volpick_tpu"}
# the benchmark's files that make up the yardstick: none may import the program
YARDSTICK = ["reference.py", "weights.py", "traffic.py", "bounds.py", "plan.py", "trace.py",
             "readers.py", "manifest.py"] + [f"configs/{p.name}" for p in (REPO / "benchmark" / "configs").glob("*.py")]

DRY_PASS = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import tiny_mix
from benchmark import harness, manifest
from benchmark.plan import plan
man = manifest.load()
for cell in man["workloads"]:
    cfg = manifest.config(man, cell["config"])
    mix = tiny_mix(cell["traffic"])
    c = mix["classify"]
    pl = plan(mix["stations"], mix["samples"], cfg["model_args"]["in_samples"], c["overlap"], c["batch_size"])
    sd, pool = harness.make_inputs(cfg, mix, pl, 2**31 + 9, torch.device("cpu"))
    harness.classify_call(harness.build_program(cfg, sd, torch.device("cpu")), cfg, mix)(pool[0])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch
from benchmark import manifest, reference, weights
man = manifest.load()
for entry in man["configs"]:
    cfg = manifest.config(man, entry["name"])
    model = reference.build_model(cfg, "cpu")
    model.load_state_dict(weights.seeded_state_dict(model, 3, torch.device("cpu")))
    w = cfg["model_args"]["in_samples"]
    reference.curves(cfg, model, torch.randn(1, 3, w + 600), {{"overlap": w - 300, "blinding": [0, 0], "stacking": "avg"}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def modules_of(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script.format(repo=str(REPO), tests=str(REPO / "benchmark" / "tests"))],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(REPO), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_dry_pass_of_every_cell_loads_no_jax():
    names = modules_of(DRY_PASS)
    assert "volpick_tpu_torch" in names  # the port ran
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = modules_of(REFERENCE_ONLY)
    assert not names & (FORBIDDEN | {"volpick_tpu_torch"})


@pytest.mark.parametrize("path", YARDSTICK)
def test_yardstick_files_import_neither_package(path):
    tree = ast.parse((REPO / "benchmark" / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    assert not tops & (FORBIDDEN | {"volpick_tpu_torch"}), tops


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import volpick_tpu_torch  # noqa: F401  (the port is loaded and is no offence)

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "volpick_tpu_torchlike", types.ModuleType("volpick_tpu_torchlike"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "volpick_tpu.models", types.ModuleType("volpick_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.loaded_forbidden() == ["jaxlib", "volpick_tpu.models"]


def test_pin_process_keeps_to_two_allowed_cores():
    script = ("import os, sys; sys.path.insert(0, {repo!r}); before = os.sched_getaffinity(0); "
              "from benchmark.run import pin_process; pin_process(); after = os.sched_getaffinity(0); "
              "print(after <= before, len(after), os.environ['OMP_NUM_THREADS'], 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", script.format(repo=str(REPO))], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    subset, n, omp, torch_loaded = out.stdout.split()
    assert subset == "True" and int(n) <= 2 and omp == "1" and torch_loaded == "False"
