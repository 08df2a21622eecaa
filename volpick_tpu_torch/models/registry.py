"""Model registry: name → PyTorch model, fresh or with published weights.

Port of ``volpick_tpu/models/registry.py`` for ``phasenet``,
``eqtransformer``, ``voleqtransformer`` and ``tpupicknet``. Weights are a
``<name>.json.v1`` beside either a ``<name>.pt.v1`` state dict (the published
SeisBench files, or a port state dict) or a ``<name>.npz.v1`` (the JAX
trainer's native export, read by ``convert.load_npz_v1``); ``.pt.v1`` is
taken first. They are searched in:

1. the directories passed as ``search_paths`` (each as ``<dir>/<arch>/`` and ``<dir>/``);
2. ``$VOLPICK_TPU_MODELS``;
3. ``~/.cache/volpick_tpu/models``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import torch

from volpick_tpu_torch.device import resolve_device
from volpick_tpu_torch.models.convert import ARCHS, load_npz_v1


def _arch(arch: str):
    arch = arch.lower()
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; available: {sorted(ARCHS)}")
    return arch, ARCHS[arch]


def _find(arch: str, name: str, search_paths: Sequence[str]) -> Tuple[str, str, str]:
    """(json path, weights path, "pt" or "npz")."""
    bases = list(search_paths) + [
        os.environ.get("VOLPICK_TPU_MODELS", ""),
        os.path.expanduser("~/.cache/volpick_tpu/models"),
    ]
    for base in bases:
        if not base:
            continue
        for d in (os.path.join(base, arch), base):
            js = os.path.join(d, f"{name}.json.v1")
            if not os.path.exists(js):
                continue
            for kind in ("pt", "npz"):
                weights = os.path.join(d, f"{name}.{kind}.v1")
                if os.path.exists(weights):
                    return js, weights, kind
    raise FileNotFoundError(
        f"pretrained weights {name!r} for {arch!r} ({name}.json.v1 + {name}.pt.v1 or "
        f"{name}.npz.v1) not found in {[b for b in bases if b]}; set VOLPICK_TPU_MODELS"
    )


def load_model(arch: str, seed: int = 0, device=None, **model_args) -> torch.nn.Module:
    """Fresh model with parameters drawn from ``torch.Generator`` seeded `seed`,
    on `device`: the card by default (``resolve_device``), ``"cpu"`` on request."""
    _, cls = _arch(arch)
    device = resolve_device(device, "load_model")
    model = cls(generator=torch.Generator().manual_seed(seed), **model_args)
    return model.to(device).eval()


def from_pretrained(
    arch: str, name: str = "volpick", search_paths: Sequence[str] = (), device=None
) -> torch.nn.Module:
    """Model with published or exported weights, loaded with ``strict=True``,
    on `device`: the card by default (``resolve_device``), ``"cpu"`` on request.

    ``model.default_args`` carries the shipped thresholds of the ``.json.v1``."""
    arch, cls = _arch(arch)
    device = resolve_device(device, "from_pretrained")
    js_path, weights_path, kind = _find(arch, name, search_paths)
    if kind == "npz":
        _, model = load_npz_v1(js_path, weights_path)
        return model.to(device).eval()
    with open(js_path) as f:
        meta = json.load(f)
    model_args = dict(meta.get("model_args", {}))
    model_args.pop("sampling_rate", None)
    model = cls(default_args=dict(meta.get("default_args", {})), **model_args)
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
