"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric is found by its name, and the manifest keeps the contract's
rules on names, units and keys."""

import json

import pytest

from conftest import REPO
from benchmark import harness, manifest, reference

MAN = manifest.load(REPO)
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MAN) == TOP
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert (REPO / MAN["command"][1]).is_file()
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["config", "workload", "metric", "reduced"])
def test_names_use_the_allowed_characters(kind):
    names = manifest.names(MAN)[kind]
    assert all(manifest.NAME.match(n) for n in names), names


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for k in ("end_to_end", "per_layer") for m in MAN[k]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", [m for k in ("end_to_end", "per_layer") for m in MAN[k]],
                         ids=lambda m: m["name"])
def test_metric_entry_and_reader_are_found(metric):
    assert manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert harness.load_reader(metric["name"], REPO) is not None
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in MAN["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        moves = [m for m in MAN["end_to_end"] if m["name"] == metric["moves"]]
        assert moves, metric["moves"]
        # each cell that reads the metric reports the end-to-end metric it moves
        assert set(metric["workloads"]) <= set(moves[0].get("workloads", cells))
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_config_mix_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    cfg = manifest.config(MAN, cell["config"], REPO)
    mix = manifest.mix(cell["traffic"], REPO)
    assert mix["loop"] in ("closed", "open")
    e2e = [m["name"] for m in manifest.metrics_of(MAN, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(MAN, cell["name"], "per_layer")
    assert set(cfg["thresholds"]) == set(cfg["labels"])


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_and_its_reference(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    assert entry["source"].startswith("https://") and len(entry["source"]) <= 200
    cfg = manifest.config(MAN, entry["name"], REPO)
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"] == []
    assert cfg["check"]["pick_gap"] is not None
    model = reference.build_model(cfg, "cpu")
    assert sum(v.numel() for v in model.state_dict().values()) == cfg["state_dict_elements"]
    assert all(c["name"] != entry["name"] or c is entry for c in MAN["configs"])


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_run_fits_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
