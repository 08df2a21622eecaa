"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new manifest entries, and edits no file that is
there: the harness finds them by name and runs the new cell."""

import hashlib
import json
import shutil
import time
from types import SimpleNamespace

from conftest import tiny_root
from benchmark import harness, manifest


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tmp_path):
    root = tiny_root(tmp_path)
    before = digest(root)
    bench = root / "benchmark"
    # a configuration: a copy of phasenet under another name, its reference beside it
    cfg = json.loads((bench / "configs" / "phasenet.json").read_text())
    cfg.update(name="phasenet_copy", reference="phasenet_copy.py")
    (bench / "configs" / "phasenet_copy.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "configs" / "phasenet.py", bench / "configs" / "phasenet_copy.py")
    # a traffic mix: three stations, another event rate
    mix = json.loads((bench / "mixes" / "archive.phasenet.json").read_text())
    mix.update(stations=3, events_per_station_hour=40)
    (bench / "mixes" / "throwaway.json").write_text(json.dumps(mix))
    # a per-layer metric with a reader of its own
    (bench / "metrics" / "requests_done.throwaway.py").write_text(
        "def read(ctx):\n    return float(sum(1 for r in ctx.requests if r.done))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "phasenet_copy", "source": "https://example.org/phasenet",
                           "file": "benchmark/configs/phasenet_copy.json", "reduced": [], "why": "a copy"})
    man["workloads"].append({"name": "phasenet_copy.throwaway", "config": "phasenet_copy",
                             "traffic": "throwaway", "chips": 1, "why": "a throwaway cell"})
    rate = next(m for m in man["end_to_end"] if m["name"] == "classify_station_h_per_s.phasenet")
    rate["workloads"].append("phasenet_copy.throwaway")
    man["per_layer"].append({"name": "requests_done.throwaway", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "request loop",
                             "moves": "classify_station_h_per_s.phasenet", "workloads": ["phasenet_copy.throwaway"]})
    after_manifest = json.dumps(man, indent=1)

    # every file that was there is unchanged but the manifest, which only gained entries
    assert {k: v for k, v in digest(root).items() if k in before} == before
    (root / "BENCHMARK.json").write_text(after_manifest)

    out = harness.run("phasenet_copy.throwaway", 2**31 + 3, 1.0, False, "cpu", time.perf_counter(), root)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"classify_station_h_per_s.phasenet", "setup_s"}
    metric = manifest.metrics_of(manifest.load(root), "phasenet_copy.throwaway", "per_layer")
    assert [m["name"] for m in metric] == ["requests_done.throwaway"]
    fake = SimpleNamespace(requests=[harness.Request(0.0, 0, 0.0, 1.0), harness.Request(1.0, 0)])
    assert harness.load_reader("requests_done.throwaway", root)(fake) == 1.0
