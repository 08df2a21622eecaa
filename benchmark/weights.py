"""Seeded weights at published widths, made by the benchmark on the card.

One state dict with the SeisBench names of the configuration's plain
reference, drawn from ``--seed`` in one call on the card's generator and
loaded into the program and the reference alike. Each tensor is uniform
with a bound for its kind: convolution and linear weights He-uniform
(+-sqrt(6 / fan-in)) and their biases +-1/sqrt(fan-in); LSTMs
+-1/sqrt(hidden) (PyTorch's default); the additive attention's matrices
Glorot-uniform; BatchNorm and layer-norm parameters and statistics near
identity.

Seeded heads give nearly flat curves: one trigger run a row. So
``stretch_heads`` rescales each head's last layer from the reference's
logits on whole stations of the first request, some 600 windows (the
stretch of the port's card smoke test, w' = a w, b' = a (b - m) + centre):
the median m of the logit goes to ``centre``, and a is set so that a small
share of the stacked curve lies above the label's threshold. Trained heads are near 0 with
isolated peaks, as these are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.traffic import sub_seed


def _bounds(model: nn.Module) -> Dict[str, tuple]:
    """name → (lo, hi) of the uniform draw of every floating-point
    state-dict entry."""
    out = {}
    for mod_name, mod in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        local = {**dict(mod.named_parameters(recurse=False)), **dict(mod.named_buffers(recurse=False))}
        for name, t in local.items():
            key = pre + name
            if not t.is_floating_point():
                continue
            if isinstance(mod, nn.modules.batchnorm._BatchNorm) or name in ("gamma", "beta"):
                centre = 1.0 if name in ("weight", "running_var", "gamma") else 0.0
                half = 0.5 if name == "running_var" else 0.1
                out[key] = (centre - half, centre + half)
            elif isinstance(mod, nn.LSTM):
                b = 1.0 / math.sqrt(mod.hidden_size)
                out[key] = (-b, b)
            elif name in ("Wx", "Wt", "Wa"):
                b = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
                out[key] = (-b, b)
            elif name in ("bh", "ba"):
                out[key] = (-0.1, 0.1)
            else:  # conv, transposed conv and linear weights and biases
                w = getattr(mod, "weight", None)
                if isinstance(mod, nn.ConvTranspose1d):
                    fan_in = w.shape[1] * w.shape[2]
                else:
                    fan_in = w[0].numel() if w is not None else t.numel()
                # He-uniform weights keep a ReLU stack's activations at
                # their scale through the 14 convs of encoder and decoder
                b = math.sqrt((6.0 if t.dim() > 1 else 1.0) / fan_in)
                out[key] = (-b, b)
    return out


def seeded_state_dict(model: nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for `seed`, on `device`, float32."""
    sd = model.state_dict()
    bounds = _bounds(model)
    total = sum(v.numel() for v in sd.values() if v.is_floating_point())
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():  # BatchNorm's batch counts
            out[k] = torch.zeros_like(v, device=device)
            continue
        lo, hi = bounds[k]
        out[k] = lo + (hi - lo) * u[at : at + v.numel()].view(v.shape)
        at += v.numel()
    return out


def _module(model: nn.Module, name: str) -> nn.Module:
    return dict(model.named_modules())[name]


def head_logits(model: nn.Module, heads) -> Callable[[torch.Tensor], torch.Tensor]:
    """x → (N, len(heads), W): the outputs of the (module, channel) pairs
    `heads` in one forward of `model`."""
    def run(x: torch.Tensor) -> torch.Tensor:
        seen: Dict[str, torch.Tensor] = {}
        hooks = [_module(model, name).register_forward_hook(
                     lambda m, i, o, name=name: seen.__setitem__(name, o.detach()))
                 for name in {h[0] for h in heads}]
        try:
            model(x)
        finally:
            for h in hooks:
                h.remove()
        return torch.stack([seen[name][:, ch] for name, ch in heads], dim=1)
    return run


def _fold(pr: torch.Tensor, stride: int, mask: torch.Tensor) -> torch.Tensor:
    """Blinded windows on a uniform grid, pr (N, R, W) → their average
    (R, (N - 1) * stride + W), as the curves are stacked."""
    n, r, w = pr.shape
    total = (n - 1) * stride + w
    fold = lambda x: F.fold(x, (1, total), (1, w), stride=(1, stride))[:, 0, 0]
    sums = fold((pr * mask).permute(1, 2, 0))
    counts = fold(mask.expand(1, n, w).permute(0, 2, 1).contiguous())
    return sums / torch.clamp(counts, min=1.0)


def stretch_heads(cfg: dict, model: nn.Module, sd: Dict[str, torch.Tensor], frames: torch.Tensor,
                  stride: int, blinding) -> Dict[str, torch.Tensor]:
    """`sd` with the heads of ``cfg["heads"]`` (one a label, in the order of
    ``cfg["labels"]``) stretched on the reference `model`'s logits for
    `frames` (N, R, C, W): N conditioned windows on a uniform grid of
    `stride` for each of R rows. Each head maps to w' = a w,
    b' = a (b - m) + ``centre``, m the median of its logit, a found by
    bisection so that ``above`` of the samples of its stacked probability
    exceed the label's threshold. The (module, channel) pairs of ``zero``
    get weight and bias 0, a constant logit of 0. `model` is left loaded
    with the result."""
    heads = cfg["heads"]
    out = dict(sd)
    for name, ch in heads.get("zero", []):
        for part in ("weight", "bias"):
            t = out[f"{name}.{part}"].clone()
            t[ch] = 0.0
            out[f"{name}.{part}"] = t
    model.load_state_dict(out)
    n, rows, c, w = frames.shape
    run = head_logits(model, heads["modules"])
    with torch.inference_mode():
        step = max(1, 256 // rows)
        logits = torch.cat([run(frames[j : j + step].reshape(-1, c, w)) for j in range(0, n, step)])
    logits = logits.reshape(n, rows, len(heads["modules"]), w)
    mask = torch.zeros(w, dtype=torch.float32, device=frames.device)
    mask[blinding[0] : w - blinding[1]] = 1.0
    edge = w  # judge the stacked curve where every window covering it was counted
    for h, ((name, ch), label) in enumerate(zip(heads["modules"], cfg["labels"])):
        lg = logits[:, :, h]
        mid = float(torch.quantile(lg[:, :, blinding[0] : w - blinding[1]].reshape(-1)[:: max(1, lg.numel() // 4_000_000)], 0.5))
        thr = cfg["thresholds"][label]
        lo, hi = math.log(1e-2), math.log(1e9)
        for _ in range(heads["bisections"]):
            a = math.exp((lo + hi) / 2)
            cur = _fold(torch.sigmoid(a * (lg - mid) + heads["centre"]), stride, mask)[:, edge:-edge]
            frac = float((cur > thr).float().mean())
            lo, hi = (lo, math.log(a)) if frac > heads["above"] else (math.log(a), hi)
        a = math.exp((lo + hi) / 2)
        wt, b = out[f"{name}.weight"].clone(), out[f"{name}.bias"].clone()
        wt[ch] *= a
        b[ch] = (b[ch] - mid) * a + heads["centre"]
        out[f"{name}.weight"], out[f"{name}.bias"] = wt, b
    model.load_state_dict(out)
    return out


def state_dict_elements(sd: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() for v in sd.values())
