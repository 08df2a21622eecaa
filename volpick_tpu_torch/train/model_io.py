"""Experiment artefacts → models, and the native pretrained export (PyTorch
port of ``volpick_tpu/train/model_io.py``).

``load_best_model`` / ``load_last_model`` read a trainer's checkpoints (the
best one is EMA-aware, reference `volpick/model/utils.py:190-245`).
``export_pretrained`` writes the JAX package's native pair
(`<name>.json.v1` + `<name>.npz.v1`, JAX tree keys), which the JAX
``load_pretrained_npz`` and the port's ``from_pretrained`` /
``load_pretrained_npz`` both read: weights go both ways.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from volpick_tpu_torch.device import resolve_device
from volpick_tpu_torch.models.convert import ARCHS, _flatten, jax_tree_from_model, load_npz_v1, model_args_of
from volpick_tpu_torch.train.checkpoints import find_best_checkpoint, load_checkpoint


def _model_from_checkpoint(path, arch: str, model_args: Optional[dict], device) -> torch.nn.Module:
    device = resolve_device(device, "load_model")
    model = ARCHS[arch.lower()](**(model_args or {}))
    model.load_state_dict(load_checkpoint(path)["params"], strict=True)
    return model.to(device).eval()


def load_best_model(
    experiment_dir, arch: str, model_args: Optional[dict] = None, prefer_ema: bool = True, device=None
) -> torch.nn.Module:
    """The model of an experiment's best checkpoint (least monitored loss; its
    -EMA weights when present and `prefer_ema`), in eval mode on `device`
    (the card unless ``"cpu"``).

    EMA with decay 0.999 needs thousands of steps to leave the
    initialisation behind: after a short run pass prefer_ema=False."""
    path = find_best_checkpoint(experiment_dir, prefer_ema=prefer_ema)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {experiment_dir}")
    return _model_from_checkpoint(path, arch, model_args, device)


def load_last_model(experiment_dir, arch: str, model_args: Optional[dict] = None, device=None):
    """The model of an experiment's `last.ckpt`, in eval mode on `device`."""
    return _model_from_checkpoint(Path(experiment_dir) / "checkpoints" / "last.ckpt", arch,
                                  model_args, device)


def export_pretrained(
    model: torch.nn.Module,
    dest_dir,
    name: str = "custom",
    docstring: str = "",
    default_args: Optional[dict] = None,
) -> Path:
    """Write `<name>.json.v1` + `<name>.npz.v1` under dest_dir/<arch>/: the
    model's constructor arguments under the JAX field names and its
    parameters and BatchNorm statistics under the JAX tree's flattened keys."""
    arch = model.name.lower()
    d = Path(dest_dir) / arch
    d.mkdir(parents=True, exist_ok=True)
    meta = {
        "docstring": docstring,
        "architecture": arch,  # authoritative; key sniffing is the fallback
        "model_args": model_args_of(model),
        "version": "1",
        "format": "volpick_tpu_npz",
        "default_args": default_args or dict(model.default_args),
    }
    with open(d / f"{name}.json.v1", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    # np.savez appends ".npz" to string paths; a file handle avoids that
    with open(d / f"{name}.npz.v1", "wb") as f:
        np.savez(f, **_flatten(jax_tree_from_model(model)))
    return d


def load_pretrained_npz(json_path, npz_path) -> torch.nn.Module:
    """Read a native pretrained pair (`<name>.json.v1` + `<name>.npz.v1`) → the
    port's model holding its weights, on the CPU in eval mode: the JAX
    package's function of this name, whose (model, params) pair is one object
    here. The architecture is ``meta["architecture"]``, else sniffed from the
    kwargs as JAX does (legacy exports carry no such field)."""
    return load_npz_v1(json_path, npz_path)[1]
