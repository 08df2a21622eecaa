"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` with its plain reference beside
it, a traffic mix ``mixes/<name>.json``, a metric ``metrics/<name>.py``
(a ``read(ctx)`` of its own) or ``metrics/<name>.json`` (a reader of
``readers.py`` and its parameters). Adding one is adding files and entries.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, name: str, repo: Path = REPO) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(repo / c["file"]) as f:
                cfg = json.load(f)
            # the plain reference lives beside the configuration's file
            cfg["reference_path"] = str((repo / c["file"]).parent / cfg["reference"])
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str, repo: Path = REPO) -> dict:
    with open(repo / "benchmark" / "mixes" / f"{traffic}.json") as f:
        return json.load(f)


def metric_file(name: str, repo: Path = REPO) -> Path:
    for ext in (".py", ".json"):
        p = repo / "benchmark" / "metrics" / f"{name}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"metric {name!r} has no benchmark/metrics/{name}.py or .json")


def metrics_of(man: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those that
    list it under ``workloads``, and those without the key."""
    return [m for m in man[kind] if workload in m.get("workloads", [workload])]


def names(man: dict) -> Dict[str, List[Optional[str]]]:
    """Every name the manifest gives, by kind, for the character rules."""
    return {
        "config": [c["name"] for c in man["configs"]] + [w["config"] for w in man["workloads"]],
        "workload": [w["name"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]],
        "metric": [m["name"] for k in ("end_to_end", "per_layer") for m in man[k]],
        "reduced": [k for c in man["configs"] for k in c["reduced"]],
    }
