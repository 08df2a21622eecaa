"""Shared pieces of the benchmark's CPU tests.

Run from the repository's root: ``python -m pytest benchmark/tests``. Tests
that need the card carry the ``cuda`` marker and skip in the ``card``
fixture where there is none.
"""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# each cell cut to a size the CPU runs in seconds: (stations, samples, pool, batch)
TINY = {"archive": (2, 8000, 2, 4), "archive.phasenet": (2, 12000, 2, 8), "live": (2, 8000, 3, 4)}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def tiny_mix(traffic: str) -> dict:
    from benchmark import manifest

    mix = copy.deepcopy(manifest.mix(traffic, REPO))
    stations, samples, pool, batch = TINY[traffic]
    mix.update(stations=stations, samples=samples, pool=pool)
    mix["classify"]["batch_size"] = batch
    if mix["loop"] == "open":
        mix.update(rate_per_s=3.0, drain_s=120.0)  # a loaded CPU serves a request in seconds
    return mix


def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark whose cells are the committed ones with each
    mix cut to TINY's size; the program is still the repository's."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for traffic in TINY:
        (root / "benchmark" / "mixes" / f"{traffic}.json").write_text(json.dumps(tiny_mix(traffic)))
    return root
