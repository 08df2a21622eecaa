"""Batched training augmentations on the batch's device (PyTorch).

Port of ``volpick_tpu/pipeline/augmentations.py``: the reference's training
program (window selection → probabilistic labels (+ detection labels) →
normalise → event stacking (superimpose / duplicate-self / none) → noise
stacking (noise superimpose / gaussian / none) → [rotation] → gaps → final
normalise) as tensor operations over fixed-shape batches. The behaviours and
their reference citations are those of the JAX module's docstring.

JAX draws its random quantities from split PRNG keys, a stream PyTorch cannot
reproduce. So every block is split in two: a ``draw_*`` function makes every
random quantity the JAX block draws (modes, gates, unit uniforms, scaled
uniforms, normals) from an explicit ``torch.Generator``, and the block itself
takes those draws. Fed the draws the JAX block makes from its key, a block
gives the JAX block's output. The draws of one block are a dict:

- window: ``pick_s``, ``gate`` (bool (B,)), ``rand_u``, ``u`` (unit uniforms (B,));
  empty when the host already cropped the window (``pre_windowed``);
- one superimpose pass: ``u`` (unit uniform of the placement), ``inv``
  (uniform on ``inv_scale_event``);
- stacking: ``mode_e``, ``mode_n`` (int (B,) in 0..2), ``two_events``,
  ``two_noise`` (bool (B,)), ``pass1``, ``pass2`` (superimpose draws),
  ``noise_inv1``, ``noise_inv2`` (uniform on ``inv_scale_noise``), ``g_scale``
  (uniform on ``gaussian_scale``), ``gnoise`` (standard normal (B, C, W));
- rotation: ``do`` (bool (B,)), ``shift`` (int (B,) in [0, W));
- gap: ``do`` (bool (B,)), ``u0``, ``u1`` (unit uniforms (B,)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from volpick_tpu_torch.ops.labels import detection_labels, probabilistic_labels
from volpick_tpu_torch.ops.signal import demean, detrend_linear, normalize_amplitude

Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    window: int = 3001
    pre_window: int = 6000
    samples_before: int = 3000
    window_around_prob: float = 2.0 / 3.0
    selection: str = "random"  # onset used by WindowAroundSample
    # RandomWindow low/high sample boundaries (`models.py:245-250` sample_boundaries)
    low: Optional[int] = None
    high: Optional[int] = None
    label_shape: str = "gaussian"
    sigma: float = 20.0
    noise_column: bool = True
    detection: bool = False
    detection_factor: float = 1.4
    detection_fixed_window: Optional[int] = None
    norm: str = "peak"
    detrend: bool = False
    # stacking
    stack: bool = False
    inv_scale_event: Tuple[float, float] = (0.25, 4.0)
    inv_scale_noise: Tuple[float, float] = (2.0, 50.0)
    sep: int = 200
    tail_length_factor: float = 1.4
    p_event_modes: Tuple[float, float, float] = (0.2, 0.2, 0.6)  # superimpose/duplicate/none
    p_noise_modes: Tuple[float, float, float] = (0.25, 0.25, 0.5)  # noise-superimpose/gaussian/none
    p_two_events: float = 0.3
    gaussian_scale: Tuple[float, float] = (0.0, 0.15)
    gap_prob: float = 0.2
    rotate_array: bool = False  # RandomArrayRotation gate (`models.py:330-343`)
    rotate_prob: float = 0.99
    # window already selected on the host (the generator's host crop): the
    # window block is then an identity gather at offset 0
    pre_windowed: bool = False

    def for_secondary(self) -> "AugmentConfig":
        """Window config of the stacked-event sub-generator: always
        WindowAroundSample around the first onset with a wider pre-window
        (reference `models.py:277-279` PhaseNet: 1500/4000; `models.py:679-681`
        EQT: 3000/8000)."""
        if self.window >= 6000:  # EQT geometry
            return dataclasses.replace(
                self, samples_before=3000, pre_window=8000, window_around_prob=1.0, selection="first", stack=False
            )
        return dataclasses.replace(
            self, samples_before=1500, pre_window=4000, window_around_prob=1.0, selection="first", stack=False
        )


# ----------------------------------------------------------------- draws
def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    return _rand(gen, shape, device) * (hi - lo) + lo


def _choice(gen, probs, b: int, device) -> torch.Tensor:
    p = torch.as_tensor(probs, dtype=torch.float32, device=device)
    return torch.multinomial(p, b, replacement=True, generator=gen)


def draw_window(gen: torch.Generator, b: int, cfg: AugmentConfig, device) -> Draws:
    if cfg.pre_windowed:
        return {}
    return {
        "pick_s": _rand(gen, (b,), device) < 0.5,
        "rand_u": _rand(gen, (b,), device),
        "gate": _rand(gen, (b,), device) < cfg.window_around_prob,
        "u": _rand(gen, (b,), device),
    }


def draw_superimpose(gen: torch.Generator, b: int, cfg: AugmentConfig, device) -> Draws:
    return {"u": _rand(gen, (b,), device), "inv": _uniform(gen, (b,), *cfg.inv_scale_event, device)}


def draw_stack(gen: torch.Generator, b: int, channels: int, cfg: AugmentConfig, device) -> Dict:
    return {
        "mode_e": _choice(gen, cfg.p_event_modes, b, device),
        "two_events": _rand(gen, (b,), device) < cfg.p_two_events,
        "pass1": draw_superimpose(gen, b, cfg, device),
        "pass2": draw_superimpose(gen, b, cfg, device),
        "mode_n": _choice(gen, cfg.p_noise_modes, b, device),
        "two_noise": _rand(gen, (b,), device) < cfg.p_two_events,
        "noise_inv1": _uniform(gen, (b,), *cfg.inv_scale_noise, device),
        "noise_inv2": _uniform(gen, (b,), *cfg.inv_scale_noise, device),
        "g_scale": _uniform(gen, (b,), *cfg.gaussian_scale, device),
        "gnoise": torch.randn((b, channels, cfg.window), generator=gen, device=device),
    }


def draw_rotation(gen: torch.Generator, b: int, cfg: AugmentConfig, device) -> Draws:
    return {
        "do": _rand(gen, (b,), device) < cfg.rotate_prob,
        "shift": torch.randint(0, cfg.window, (b,), generator=gen, device=device),
    }


def draw_gap(gen: torch.Generator, b: int, cfg: AugmentConfig, device) -> Draws:
    return {
        "do": _rand(gen, (b,), device) < cfg.gap_prob,
        "u0": _rand(gen, (b,), device),
        "u1": _rand(gen, (b,), device),
    }


def draw_augment(
    gen: torch.Generator, b: int, channels: int, cfg: AugmentConfig, device, stack: bool
) -> Dict:
    """Every draw of ``augment_train_batch`` for one batch; `stack` says
    whether the stacking program runs (a secondary batch is given)."""
    draws = {"prim": draw_window(gen, b, cfg, device)}
    if cfg.stack and stack:
        sec_cfg = cfg.for_secondary()
        draws.update(
            sec=draw_window(gen, b, sec_cfg, device),
            sec2=draw_window(gen, b, sec_cfg, device),
            noi=draw_window(gen, b, cfg, device),
            noi2=draw_window(gen, b, cfg, device),
            stack=draw_stack(gen, b, channels, cfg, device),
        )
    if cfg.rotate_array:
        draws["rotate"] = draw_rotation(gen, b, cfg, device)
    draws["gap"] = draw_gap(gen, b, cfg, device)
    return draws


# ----------------------------------------------------------------- primitives
def shift_batch(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row integer shift along the last axis with zero fill. x (B, ..., W);
    shift (B,) int (positive shifts right)."""
    w = x.shape[-1]
    idx = torch.arange(w, device=x.device)[None, :] - shift[:, None].long()  # (B, W) source index
    valid = (idx >= 0) & (idx < w)
    view = (x.shape[0],) + (1,) * (x.dim() - 2) + (w,)
    gathered = torch.gather(x, -1, idx.clamp(0, w - 1).view(view).expand(x.shape))
    return torch.where(valid.view(view), gathered, torch.zeros((), dtype=x.dtype, device=x.device))


def gather_window(x: torch.Tensor, lens: torch.Tensor, offsets: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-padded window gather: x (B, C, Wraw), offsets (B,) may be negative
    or reach past `lens`; samples outside the trace are zero ("pad")."""
    b, c, w_raw = x.shape
    idx = offsets[:, None].long() + torch.arange(window, device=x.device)[None, :]  # (B, window)
    valid = (idx >= 0) & (idx < lens[:, None]) & (idx < w_raw)
    gathered = torch.gather(x, -1, idx.clamp(0, w_raw - 1)[:, None, :].expand(b, c, window))
    return torch.where(valid[:, None, :], gathered, torch.zeros((), dtype=x.dtype, device=x.device))


def _uniform_int(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-element integer in [lo, hi) from a unit uniform `u` (hi > lo assumed where used)."""
    span = torch.clamp(hi - lo, min=1)
    return lo + torch.floor(u * span).to(torch.int32)


# ---------------------------------------------------------------- window block
def select_window_offsets(
    lens: torch.Tensor, p: torch.Tensor, s: torch.Tensor, cfg: AugmentConfig, draws: Draws
) -> torch.Tensor:
    """Absolute window start offsets (B,) int32 of the reference's window
    program: WindowAroundSample(samples_before, pre_window) with probability
    window_around_prob, else the whole trace within [low, high), then
    RandomWindow(window)."""
    b = lens.shape[0]
    if cfg.pre_windowed:
        return torch.zeros((b,), dtype=torch.int32, device=lens.device)
    has_p, has_s = ~torch.isnan(p), ~torch.isnan(s)
    if cfg.selection == "first":
        inf = torch.full_like(p, float("inf"))
        base = torch.where(has_p, torch.nan_to_num(p, nan=float("inf")), inf)
        base = torch.minimum(base, torch.where(has_s, torch.nan_to_num(s, nan=float("inf")), inf))
        onset = torch.where(torch.isfinite(base), base, torch.zeros_like(base))
    else:  # random among present picks
        use_s = (has_p & has_s & draws["pick_s"]) | (has_s & ~has_p)
        onset = torch.where(use_s, torch.nan_to_num(s), torch.nan_to_num(p))
    # noise traces: a random position stands in for the missing onset
    rand_pos = draws["rand_u"] * lens.to(torch.float32)
    onset = torch.where(has_p | has_s, onset, rand_pos)

    was_start = onset.to(torch.int32) - cfg.samples_before
    u = draws["u"]
    span_was = max(cfg.pre_window - cfg.window, 0)
    off_was = was_start + torch.floor(u * (span_was + 1)).to(torch.int32)
    lo = cfg.low if cfg.low is not None else 0
    hi = lens.to(torch.int32)
    if cfg.high is not None:
        hi = torch.clamp(hi, max=cfg.high)
    span_null = torch.clamp(hi - lo - cfg.window, min=0)
    off_null = lo + torch.floor(u * (span_null + 1).to(torch.float32)).to(torch.int32)
    return torch.where(draws["gate"], off_was, off_null)


def window_and_label(
    x: torch.Tensor,
    lens: torch.Tensor,
    p: torch.Tensor,
    s: torch.Tensor,
    cfg: AugmentConfig,
    draws: Draws,
) -> Dict[str, torch.Tensor]:
    """Window selection + labels + conditioning → {"X" (B, C, window), "y",
    ["detections"], "p", "s" (window-relative onsets)}."""
    off = select_window_offsets(lens, p, s, cfg, draws)
    xw = gather_window(x, lens, off, cfg.window)
    p_w = p - off.to(p.dtype)
    s_w = s - off.to(s.dtype)
    y = probabilistic_labels(
        torch.stack([p_w, s_w], dim=1), cfg.window, sigma=cfg.sigma, shape=cfg.label_shape,
        noise_column=cfg.noise_column,
    )
    out = {"p": p_w, "s": s_w}
    if cfg.detection:
        out["detections"] = detection_labels(
            p_w, s_w, cfg.window, factor=cfg.detection_factor, fixed_window=cfg.detection_fixed_window
        )
    xw = detrend_linear(xw) if cfg.detrend else demean(xw)
    out["X"] = normalize_amplitude(xw, norm=cfg.norm, per_channel=True)
    out["y"] = y
    return out


# ------------------------------------------------------------- stacking block
def _first_event_end(p: torch.Tensor, s: torch.Tensor, cfg: AugmentConfig):
    """(first_event_end (B,) int32, has an onset (B,) bool)."""
    has_p, has_s = ~torch.isnan(p), ~torch.isnan(s)
    pv, sv = torch.nan_to_num(p), torch.nan_to_num(s)
    both = has_p & has_s
    hi = torch.where(both, torch.maximum(pv, sv), torch.where(has_p, pv, sv))
    lo = torch.where(both, torch.minimum(pv, sv), hi)
    fee_two = hi + torch.clamp((hi - lo) * cfg.tail_length_factor, min=float(cfg.sep)) + 0.2 * cfg.sep
    fee_one = hi + 1 + cfg.sep
    fee = torch.where(both, fee_two, fee_one)
    has_any = has_p | has_s
    return torch.where(has_any, fee, torch.zeros_like(fee)).to(torch.int32), has_any


def _renorm_labels(y: torch.Tensor, noise_column: bool) -> torch.Tensor:
    if not noise_column:
        return y
    phases = y[:, :-1]
    phases = phases / torch.clamp(phases.sum(dim=1, keepdim=True), min=1.0)
    noise = 1.0 - phases.sum(dim=1, keepdim=True)
    return torch.cat([phases, noise], dim=1)


def _where_rows(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def stack_block(
    prim: Dict[str, torch.Tensor],
    sec: Dict[str, torch.Tensor],
    sec2: Dict[str, torch.Tensor],
    noise_x: torch.Tensor,
    noise2_x: torch.Tensor,
    cfg: AugmentConfig,
    draws: Dict,
) -> Dict[str, torch.Tensor]:
    """Event stacking, then noise stacking, for the whole batch."""
    mode_e, two_events = draws["mode_e"], draws["two_events"]
    fee, has_event = _first_event_end(prim["p"], prim["s"], cfg)
    do_stack = (mode_e < 2) & has_event  # superimpose or duplicate, event traces only
    # duplicate-self needs a contained P pick of the primary itself
    dup_ok = prim["y"][:, 0].amax(dim=-1) > 0.99
    do_stack = do_stack & torch.where(mode_e == 1, dup_ok, torch.ones_like(dup_ok))

    # the duplicate's secondary is the window before tail zeroing
    pre_zero = {"X": prim["X"], "y": prim["y"]}
    if cfg.detection and "detections" in prim:
        pre_zero["detections"] = prim["detections"]

    # the tail is zeroed whenever a stacking mode was drawn for an event trace
    t = torch.arange(cfg.window, device=fee.device)[None, :]
    keep = t < fee[:, None]
    prim = dict(prim, X=_where_rows(do_stack, prim["X"] * keep[:, None, :], prim["X"]))

    # mode 0: a secondary from the eq sub-generator; mode 1: the self-copy
    dup = mode_e == 1
    sec_eff = {k: _where_rows(dup, pre_zero[k], sec[k]) for k in pre_zero if k in sec}
    margin = torch.where(dup, cfg.sep, 2 * cfg.sep)

    prim1, fee1 = _superimpose_pass_dynamic(prim, sec_eff, fee, do_stack, cfg, margin, draws["pass1"])
    # pass 2 only where two events were drawn; the duplicate reuses its self-copy
    sec2_eff = {k: _where_rows(dup, sec_eff[k], sec2[k]) for k in sec_eff}
    prim2, _ = _superimpose_pass_dynamic(
        prim1, sec2_eff, fee1, do_stack & two_events, cfg, margin, draws["pass2"])

    # ---- noise gate
    mode_n, two_noise = draws["mode_n"], draws["two_noise"]
    x = prim2["X"]
    alive = (x.abs() > 1e-12).any(dim=-1, keepdim=True)

    def add_noise(inv, xx, nx, act):
        scale = 1.0 / inv * xx.abs().amax(dim=(1, 2))
        nx = nx * alive
        return _where_rows(act, xx + scale[:, None, None] * nx, xx)

    x = add_noise(draws["noise_inv1"], x, noise_x, mode_n == 0)
    x = add_noise(draws["noise_inv2"], x, noise2_x, (mode_n == 0) & two_noise)
    gnoise = draws["gnoise"] * draws["g_scale"][:, None, None]
    x = _where_rows(mode_n == 1, x + gnoise, x)
    return dict(prim2, X=x)


def _superimpose_pass_dynamic(prim, sec, fee, active, cfg, margin, draws):
    """One superimpose pass with a per-row placement margin (duplicate vs
    event) → (stacked batch, new first_event_end)."""
    n = cfg.window
    x, y = prim["X"], prim["y"]
    x2, y2 = sec["X"], sec["y"]

    hi = n - margin  # (B,) exclusive upper bound of the placement
    # feasibility uses 2 sep for both modes (reference `augmentations.py:198-200`
    # and `:458`) while the duplicate's placement reaches n - sep (`:474-476`)
    feasible = fee < n - 2 * cfg.sep
    p_peak_ok = y2[:, 0].amax(dim=-1) > 0.99
    active = active & feasible & p_peak_ok

    original_pick = torch.argmax(y2[:, 0], dim=-1).to(torch.int32)
    t = torch.arange(n, device=x.device)[None, :]
    keep2 = t >= torch.clamp(original_pick - cfg.sep, min=0)[:, None]
    x2 = x2 * keep2[:, None, :]

    shifted_pick = _uniform_int(draws["u"], fee, hi)
    shift = shifted_pick - original_pick
    x2s = shift_batch(x2, shift)
    y2s = shift_batch(y2, shift)
    x2s = x2s * (x.abs() > 1e-12).any(dim=-1, keepdim=True)

    scale = 1.0 / draws["inv"]
    out = dict(prim)
    out["X"] = _where_rows(active, x + scale[:, None, None] * x2s, x)
    out["y"] = _where_rows(active, _renorm_labels(torch.maximum(y, y2s), cfg.noise_column), y)
    if cfg.detection and "detections" in prim and "detections" in sec:
        d2s = shift_batch(sec["detections"], shift)
        out["detections"] = _where_rows(active, torch.maximum(prim["detections"], d2s), prim["detections"])

    n_phase = y2s.shape[1] - (1 if cfg.noise_column else 0)
    placed_onset = torch.argmax(y2s[:, :n_phase], dim=-1).amax(dim=-1)
    fee_new = torch.where(active, torch.maximum(fee, placed_onset.to(torch.int32) + 1 + cfg.sep), fee)
    return out, fee_new


# ------------------------------------------------------------- rotation block
def rotation_block(out: Dict[str, torch.Tensor], cfg: AugmentConfig, draws: Draws) -> Dict[str, torch.Tensor]:
    """RandomArrayRotation: circular roll of X, y (and detections) along time
    by a per-row shift, where the gate drew True."""
    n = cfg.window
    idx = (torch.arange(n, device=out["X"].device)[None, :] - draws["shift"][:, None]) % n  # (B, W)

    def roll(a):
        g = torch.gather(a, -1, idx[:, None, :].expand(a.shape))
        return _where_rows(draws["do"], g, a)

    res = dict(out, X=roll(out["X"]), y=roll(out["y"]))
    if cfg.detection and "detections" in out:
        res["detections"] = roll(out["detections"])
    return res


# ------------------------------------------------------------------ gap block
def gap_block(out: Dict[str, torch.Tensor], cfg: AugmentConfig, draws: Draws) -> Dict[str, torch.Tensor]:
    """AddGap: a random span zeroed in X and the label rows, the noise row
    (when present) set to 1 there."""
    n = cfg.window
    dev = out["X"].device
    b = out["X"].shape[0]
    full = torch.full((b,), n, dtype=torch.int32, device=dev)
    g0 = _uniform_int(draws["u0"], torch.zeros((b,), dtype=torch.int32, device=dev), full)
    g1 = _uniform_int(draws["u1"], g0, full)
    t = torch.arange(n, device=dev)[None, :]
    in_gap = (t >= g0[:, None]) & (t < g1[:, None]) & draws["do"][:, None]
    zero = torch.zeros((), dtype=out["X"].dtype, device=dev)
    x = torch.where(in_gap[:, None, :], zero, out["X"])
    y = torch.where(in_gap[:, None, :], zero, out["y"])
    if cfg.noise_column:
        noise_row = torch.where(in_gap, torch.ones((), dtype=y.dtype, device=dev), out["y"][:, -1])
        y = torch.cat([y[:, :-1], noise_row[:, None]], dim=1)
    res = dict(out, X=x, y=y)
    if cfg.detection and "detections" in out:
        res["detections"] = torch.where(in_gap[:, None, :], zero, out["detections"])
    return res


# --------------------------------------------------------------- full program
def augment_train_batch(
    prim_raw: Dict[str, torch.Tensor],
    sec_raw: Optional[Dict[str, torch.Tensor]],
    sec2_raw: Optional[Dict[str, torch.Tensor]],
    noise_raw: Optional[Dict[str, torch.Tensor]],
    noise2_raw: Optional[Dict[str, torch.Tensor]],
    cfg: AugmentConfig,
    draws: Dict,
) -> Dict[str, torch.Tensor]:
    """The whole training augmentation program on the tensors' device.

    Raw dicts: {"x": (B, C, Wraw) float32, "len": (B,) int, "p"/"s": (B,)
    float32 with NaN for absent picks[, "is_lp"]}; the secondary and noise
    batches are independent draws from the eq / noise subsets (the
    generator's job). `draws` is ``draw_augment``'s dict. Returns {"X", "y"
    [, "detections"][, "is_lp"]} in float32."""
    prim = window_and_label(prim_raw["x"], prim_raw["len"], prim_raw["p"], prim_raw["s"], cfg,
                            draws["prim"])
    if cfg.stack and sec_raw is not None:
        sec_cfg = cfg.for_secondary()
        sec = window_and_label(sec_raw["x"], sec_raw["len"], sec_raw["p"], sec_raw["s"], sec_cfg,
                               draws["sec"])
        sec2 = window_and_label(sec2_raw["x"], sec2_raw["len"], sec2_raw["p"], sec2_raw["s"], sec_cfg,
                                draws["sec2"])
        noi = window_and_label(noise_raw["x"], noise_raw["len"], noise_raw["p"], noise_raw["s"], cfg,
                               draws["noi"])
        noi2 = window_and_label(noise2_raw["x"], noise2_raw["len"], noise2_raw["p"], noise2_raw["s"],
                                cfg, draws["noi2"])
        prim = stack_block(prim, sec, sec2, noi["X"], noi2["X"], cfg, draws["stack"])
    if cfg.rotate_array:
        prim = rotation_block(prim, cfg, draws["rotate"])
    prim = gap_block(prim, cfg, draws["gap"])

    # final re-normalisation (reference `models.py:408-412`)
    x = normalize_amplitude(demean(prim["X"]), norm=cfg.norm, per_channel=True)
    out = {"X": x.to(torch.float32), "y": prim["y"].to(torch.float32)}
    if cfg.detection and "detections" in prim:
        out["detections"] = prim["detections"].to(torch.float32)
    if "is_lp" in prim_raw:
        # the source-type flag rides along (no block reorders rows);
        # VolEQTransformer's loss gates its two detection heads with it
        out["is_lp"] = torch.as_tensor(prim_raw["is_lp"], dtype=torch.float32, device=x.device)
    return out
