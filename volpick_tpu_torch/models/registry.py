"""Model registry: name → PyTorch model, fresh or with published weights.

Port of ``volpick_tpu/models/registry.py`` for EQTransformer. Published
weights are the ``volpick.{json,pt}.v1`` pairs, searched in:

1. the directories passed as ``search_paths`` (each as ``<dir>/<arch>/`` and ``<dir>/``);
2. ``$VOLPICK_TPU_MODELS``;
3. ``~/.cache/volpick_tpu/models``.

The native ``.npz.v1`` export of the JAX trainer is not read yet.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import torch

from volpick_tpu_torch.models.eqtransformer import EQTransformer

_ARCHS = {"eqtransformer": EQTransformer}


def _arch(arch: str):
    arch = arch.lower()
    if arch not in _ARCHS:
        raise ValueError(f"unknown or not yet ported architecture {arch!r}; available: {sorted(_ARCHS)}")
    return arch, _ARCHS[arch]


def _find(arch: str, name: str, search_paths: Sequence[str]) -> Tuple[str, str]:
    bases = list(search_paths) + [
        os.environ.get("VOLPICK_TPU_MODELS", ""),
        os.path.expanduser("~/.cache/volpick_tpu/models"),
    ]
    for base in bases:
        if not base:
            continue
        for d in (os.path.join(base, arch), base):
            js = os.path.join(d, f"{name}.json.v1")
            pt = os.path.join(d, f"{name}.pt.v1")
            if os.path.exists(js) and os.path.exists(pt):
                return js, pt
    raise FileNotFoundError(
        f"pretrained weights {name!r} for {arch!r} ({name}.json.v1 + {name}.pt.v1) "
        f"not found in {[b for b in bases if b]}; set VOLPICK_TPU_MODELS"
    )


def load_model(arch: str, seed: int = 0, device="cpu", **model_args) -> torch.nn.Module:
    """Fresh model with parameters drawn from ``torch.Generator`` seeded `seed`."""
    _, cls = _arch(arch)
    model = cls(generator=torch.Generator().manual_seed(seed), **model_args)
    return model.to(device).eval()


def from_pretrained(
    arch: str, name: str = "volpick", search_paths: Sequence[str] = (), device="cpu"
) -> torch.nn.Module:
    """Model with published weights, loaded with ``strict=True``.

    ``model.default_args`` carries the shipped thresholds of the ``.json.v1``."""
    arch, cls = _arch(arch)
    js_path, pt_path = _find(arch, name, search_paths)
    with open(js_path) as f:
        meta = json.load(f)
    model_args = dict(meta.get("model_args", {}))
    model_args.pop("sampling_rate", None)
    model = cls(default_args=dict(meta.get("default_args", {})), **model_args)
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
