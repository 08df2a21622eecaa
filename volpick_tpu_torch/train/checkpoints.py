"""Checkpoints and CSV metrics logging (PyTorch port of
``volpick_tpu/train/checkpoints.py``).

The same on-disk contract as the JAX package (reference
`volpick/model/train.py:118-176`, `volpick/model/ema.py:421-541`,
`volpick/model/utils.py:190-245`): an experiment directory with
`metrics.csv`, `hparams.json`, `checkpoints/last.ckpt` and the best
`checkpoints/epoch=E-step=S.ckpt` (save_top_k=1, held across resumes), each
with an `-EMA` pair when EMA is on, and the NaN guard. A checkpoint is a
``torch.save`` of {params (a state dict), ema_params, swa_params, swa_n,
opt_state, step, epoch, plateau, best_monitor}, tensors on the CPU (``None``
where EMA or SWA is off).
"""

from __future__ import annotations

import csv
import json
import math
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, state: Dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_to_cpu(state), tmp)
    tmp.replace(path)


def load_checkpoint(path) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Best and last checkpoints like (EMA)ModelCheckpoint(save_top_k=1,
    save_last=True) with the NaN guard of `ema.py:521-532`."""

    def __init__(self, directory, monitor: str = "val_loss", save_ema: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.best = math.inf
        # adopt the best checkpoint a resumed run left in the same directory,
        # so that save_top_k=1 holds across resumes
        existing = [
            c
            for c in self.dir.glob("epoch=*-step=*.ckpt")
            if not c.stem.endswith("-EMA") and _ckpt_epoch_step(c) is not None
        ]
        self.best_path: Optional[Path] = (
            max(existing, key=_ckpt_epoch_step) if existing else None
        )
        self.save_ema = save_ema

    def _write(self, tag: str, state: Dict) -> Path:
        path = self.dir / f"{tag}.ckpt"
        save_checkpoint(path, state)
        if self.save_ema and state.get("ema_params") is not None:
            save_checkpoint(self.dir / f"{tag}-EMA.ckpt", dict(state, params=state["ema_params"]))
        return path

    def update(self, state: Dict, metrics: Dict, epoch: int, step: int):
        value = metrics.get(self.monitor, math.nan)
        improved = not (value is None or math.isnan(value)) and value < self.best
        if improved:
            self.best = value
        # stamp the post-update best so a resumed run starts from it and
        # cannot replace this checkpoint with a worse "best"
        state = dict(state, best_monitor=None if math.isinf(self.best) else self.best)
        self._write("last", state)
        if improved:
            new_best = self._write(f"epoch={epoch}-step={step}", state)
            # every other epoch=*-step=* checkpoint (and its EMA pair) goes
            for stale in self.dir.glob("epoch=*-step=*.ckpt"):
                if stale.stem.endswith("-EMA"):
                    continue
                if stale != new_best and _ckpt_epoch_step(stale) is not None:
                    stale.unlink(missing_ok=True)
                    stale.with_name(stale.stem + "-EMA.ckpt").unlink(missing_ok=True)
            self.best_path = new_best
        return self.best_path


class CSVMetricsLogger:
    """Append-only metrics.csv (one row a logged dict, like PL CSVLogger)."""

    def __init__(self, directory, hparams: Optional[dict] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.csv"
        self._fields = None
        if hparams is not None:
            with open(self.dir / "hparams.json", "w") as f:
                json.dump(_jsonable(hparams), f, indent=2, default=str)

    def log(self, row: Dict):
        row = {k: (float(v) if isinstance(v, (np.floating, np.integer)) else v) for k, v in row.items()}
        new_file = not self.path.exists()
        if self._fields is None:
            if new_file:
                self._fields = list(row.keys())
            else:
                with open(self.path) as f:
                    self._fields = next(csv.reader(f))
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
                self._rewrite_with_fields()
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            if new_file:
                w.writeheader()
            w.writerow(row)

    def _rewrite_with_fields(self):
        if not self.path.exists():
            return
        with open(self.path) as f:
            rows = list(csv.DictReader(f))
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            for r in rows:
                w.writerow(r)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def _ckpt_epoch_step(path: Path):
    m = re.match(r"epoch=(\d+)-step=(\d+)$", path.stem)
    return (int(m.group(1)), int(m.group(2))) if m else None


def find_best_checkpoint(experiment_dir, monitor: str = "val_loss", prefer_ema: bool = True):
    """The checkpoint of the least monitored loss in metrics.csv (reference
    `volpick/model/utils.py:190-231`), its -EMA pair when present and
    `prefer_ema`. Without metrics.csv, or when no logged (epoch, step) matches
    a kept checkpoint, the numerically latest `epoch=*-step=*.ckpt` (the one
    save_top_k=1 keeps), then `last.ckpt`."""
    experiment_dir = Path(experiment_dir)
    ckpts = [
        c
        for c in experiment_dir.glob("checkpoints/epoch=*-step=*.ckpt")
        if not c.stem.endswith("-EMA") and _ckpt_epoch_step(c) is not None
    ]
    if not ckpts:
        last = experiment_dir / "checkpoints" / "last.ckpt"
        return last if last.exists() else None

    best = None
    metrics_path = experiment_dir / "metrics.csv"
    if metrics_path.exists():
        by_key = {_ckpt_epoch_step(c): c for c in ckpts}
        best_val = math.inf
        with open(metrics_path) as f:
            for row in csv.DictReader(f):
                raw = row.get(monitor)
                if raw in (None, ""):
                    continue
                try:
                    val = float(raw)
                    key = (int(float(row.get("epoch", "nan"))), int(float(row.get("step", "nan"))))
                except (TypeError, ValueError):
                    continue
                if not math.isnan(val) and val < best_val and key in by_key:
                    best_val = val
                    best = by_key[key]
    if best is None:
        best = max(ckpts, key=_ckpt_epoch_step)  # numeric, not lexicographic
    if prefer_ema:
        ema = best.with_name(best.stem + "-EMA.ckpt")
        if ema.exists():
            return ema
    return best
