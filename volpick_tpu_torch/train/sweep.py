"""Hyperparameter-sweep orchestration (the reference's tune.ipynb workflow).

Port of ``volpick_tpu/train/sweep.py``: the same config files, run by the
port's ``train`` on `device` (the card unless ``device="cpu"``).

Generates the reference's config grid (model × batch × lr × label shape ×
...) as JSON files named like `p_512_5e-04_400_s.json`, runs them
sequentially or filtered, and collects results with the eval harness's
collection functions.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence


def generate_sweep_configs(
    base_config: Dict,
    grid: Dict[str, Sequence],
    out_dir,
    name_keys: Optional[Sequence[str]] = None,
) -> List[Path]:
    """Cartesian-product sweep configs.

    grid keys use dotted paths into the config (e.g. "model_args.lr",
    "batch_size"). Returns the written config paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = list(grid.keys())
    paths = []
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = json.loads(json.dumps(base_config))  # deep copy
        parts = []
        for k, v in zip(keys, values):
            node = cfg
            *heads, last = k.split(".")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = v
            if name_keys is None or k in name_keys:
                parts.append(f"{last}={v}" if not isinstance(v, float) else f"{last}={v:.0e}")
        name = "_".join([cfg.get("model", "m").lower()[0]] + parts).replace(" ", "")
        path = out_dir / f"{name}.json"
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        paths.append(path)
    return paths


def run_sweep(config_paths: Iterable, test_run: bool = False, device=None) -> List[Dict]:
    """Run each config with train(); returns the result dicts."""
    from volpick_tpu_torch.train.trainer import train

    results = []
    for path in config_paths:
        path = Path(path)
        with open(path) as f:
            cfg = json.load(f)
        res = train(cfg, experiment_name=path.stem, test_run=test_run, device=device)
        res["config"] = str(path)
        results.append(res)
    return results
