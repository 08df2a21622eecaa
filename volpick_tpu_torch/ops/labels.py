"""Pick labels painted for a whole batch: Gaussian / triangle / box phase
curves and EQTransformer's detection labels (PyTorch).

Port of ``volpick_tpu/ops/labels.py``. Onsets are float sample indices
relative to the window, NaN where a trace has no pick of that phase; an onset
outside the window still paints its in-window tail. Output is
(B, n_classes, W) in the model's class order (PhaseNet "PSN" with the noise
row last; EQTransformer "PS").
"""

from __future__ import annotations

from typing import Optional

import torch


def _phase_curve(dist: torch.Tensor, shape: str, sigma: float) -> torch.Tensor:
    """Label value as a function of the distance t - onset in samples."""
    if shape == "gaussian":
        return torch.exp(-(dist**2) / (2 * sigma**2))
    if shape == "triangle":
        return torch.clamp(1.0 - dist.abs() / sigma, 0.0, 1.0)
    if shape == "box":
        return (dist.abs() <= sigma).to(torch.float32)
    raise ValueError(f"unknown label shape {shape!r}")


def probabilistic_labels(
    onsets: torch.Tensor,
    window: int,
    sigma: float = 20.0,
    shape: str = "gaussian",
    noise_column: bool = True,
) -> torch.Tensor:
    """onsets (B, n_phases) → (B, n_phases [+1], window): one curve a phase and,
    with `noise_column`, a last row clip(1 - sum of the phase rows, 0, 1)."""
    t = torch.arange(window, dtype=torch.float32, device=onsets.device)[None, None, :]
    onset_grid = onsets[:, :, None].to(torch.float32)
    curves = _phase_curve(t - onset_grid, shape, float(sigma))
    curves = torch.where(torch.isnan(onset_grid), torch.zeros_like(curves), curves)
    if noise_column:
        noise = torch.clamp(1.0 - curves.sum(dim=1, keepdim=True), 0.0, 1.0)
        curves = torch.cat([curves, noise], dim=1)
    return curves


def renormalize_labels(y: torch.Tensor) -> torch.Tensor:
    """Noise row (the last) = clip(1 - sum of the others, 0, 1)."""
    phases = y[..., :-1, :]
    noise = torch.clamp(1.0 - phases.sum(dim=-2, keepdim=True), 0.0, 1.0)
    return torch.cat([phases, noise], dim=-2)


def detection_labels(
    p_onset: torch.Tensor,
    s_onset: torch.Tensor,
    window: int,
    factor: float = 1.4,
    fixed_window: Optional[int] = None,
) -> torch.Tensor:
    """1 on [P, S + factor (S - P)], or on [P, P + fixed_window] when that is
    set; a trace without P (or without S and a fixed window) gets zeros.
    p_onset, s_onset (B,) with NaN for absent picks → (B, 1, window)."""
    t = torch.arange(window, dtype=torch.float32, device=p_onset.device)[None, :]
    p = p_onset[:, None].to(torch.float32)
    if fixed_window is not None:
        end = p + float(fixed_window)
        ok = ~torch.isnan(p)
    else:
        s = s_onset[:, None].to(torch.float32)
        end = s + factor * (s - p)
        ok = ~torch.isnan(p) & ~torch.isnan(s)
    det = ((t >= p) & (t <= end)).to(torch.float32)
    det = torch.where(ok, det, torch.zeros_like(det))
    return det[:, None, :]
