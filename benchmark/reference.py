"""The plain reference of a classify request, and the comparison that
decides ``correct``.

Written again from the semantics the port documents (SeisBench
``annotate`` / ``classify`` with the obspy trigger rule), in plain PyTorch
and NumPy, float32, with the TF32 flags off. It imports neither JAX nor the
JAX package nor anything of the program, and takes no state of the program:
the benchmark hands it the same weights and the same request arrays.

- windows at i * stride, plus one flush with the stream end where the grid
  does not end there; a stream shorter than one window is zero-padded to one;
- each window, each channel: the least-squares line (``detrend``) or the
  mean removed, then divided by its peak |x| (+ eps);
- the configuration's reference model (``configs/<name>.py``), windows in
  blocks;
- each window's curves, with ``blinding`` samples at either end left out,
  summed into the stream; "avg" divides by how many windows covered a
  sample (at least 1);
- obspy ``trigger_onset(curve, t1, t2 = t1 / 2)`` with the argmax in the
  trigger as the pick.

``pick_gap`` judges the program's pick buffers against the reference's
curves. A row's picks state conditions on the curve they came from: each
trigger's onset above t1, every sample of the trigger above t2, the sample
after it at most t2, every sample outside the triggers at most t1, the peak
the trigger's largest value and the peak value the curve there. The gap is
the most by which the reference curve breaks one of them, in curve units
(a peak's by half: two curves that differ by e can swap two values 2e
apart). Picks that follow from the reference curve read 0; float32 rounding
reads its own size; a wrong or missing pick reads the size of the curve's
swing.
"""

from __future__ import annotations

import contextlib
import importlib.util
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

BLOCK = 512  # windows a reference forward


def load_reference_module(cfg: dict):
    """The configuration's reference module, loaded by path from beside its
    file (``manifest.config`` gives the path)."""
    spec = importlib.util.spec_from_file_location(f"bm_reference_{cfg['name']}", cfg["reference_path"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_model(cfg: dict, device) -> torch.nn.Module:
    return load_reference_module(cfg).build(cfg).to(device).eval()


@contextlib.contextmanager
def tf32(allow: bool) -> Iterator[None]:
    """The TF32 flags set to `allow` for cuDNN and matmuls, restored on exit."""
    flags = (torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32")
    saved = [getattr(m, a) for m, a in flags]
    for m, a in flags:
        setattr(m, a, allow)
    try:
        yield
    finally:
        for (m, a), v in zip(flags, saved):
            setattr(m, a, v)


def starts_of(total: int, window: int, overlap: int) -> List[int]:
    stride = window - overlap
    if total <= window:
        return [0]
    starts = list(range(0, total - window + 1, stride))
    if starts[-1] + window < total:
        starts.append(total - window)
    return starts


def condition(frames: torch.Tensor, detrend: bool, eps: float) -> torch.Tensor:
    """(N, C, W) windows: line or mean removed, then divided by the peak."""
    x = frames - frames.mean(dim=-1, keepdim=True)
    if detrend:
        w = frames.shape[-1]
        t = torch.arange(w, dtype=frames.dtype, device=frames.device) - (w - 1) / 2.0
        x = x - (x * t).sum(dim=-1, keepdim=True) / (t * t).sum() * t
    return x / (x.abs().amax(dim=-1, keepdim=True) + eps)


def probabilities(cfg: dict, out) -> torch.Tensor:
    """The model's output as (N, K, W) curves in ``cfg["labels"]`` order, the
    noise class (PhaseNet's last) dropped."""
    if isinstance(out, tuple):
        out = torch.stack(out, dim=1)
    return out[:, : len(cfg["labels"])]


def curves(cfg: dict, model, data: torch.Tensor, classify: dict, outputs=None) -> torch.Tensor:
    """Stacked curves (S, K, total) of one request (S, C, total) on the
    device `data` is on, float32. `outputs(x)` gives a block's (N, K, W)
    curves, the model's probabilities by default."""
    if outputs is None:
        outputs = lambda x: probabilities(cfg, model(x))
    window = cfg["model_args"]["in_samples"]
    cond = cfg["conditioning"]
    blind_l, blind_r = classify["blinding"]
    if classify["stacking"] != "avg":
        raise ValueError("the reference stacks by 'avg' only")
    total = data.shape[-1]
    if total < window:
        data = torch.nn.functional.pad(data, (0, window - total))
        total = window
    starts = starts_of(total, window, classify["overlap"])
    s = data.shape[0]
    k = None
    mask = torch.zeros(window, dtype=torch.float32, device=data.device)
    mask[blind_l : window - blind_r] = 1.0
    sums = None
    counts = torch.zeros(total, dtype=torch.float32, device=data.device)
    per_block = max(1, BLOCK // s)
    with torch.inference_mode():
        for j in range(0, len(starts), per_block):
            block = starts[j : j + per_block]
            frames = torch.stack([data[:, :, st : st + window] for st in block], dim=0)
            frames = frames.reshape(len(block) * s, data.shape[1], window)
            x = condition(frames, cond["detrend"], cond["eps"])
            pr = outputs(x)
            if sums is None:
                k = pr.shape[1]
                sums = torch.zeros((s, k, total), dtype=torch.float32, device=data.device)
            pr = pr.reshape(len(block), s, k, window)
            for i, st in enumerate(block):
                sums[:, :, st : st + window] += pr[i] * mask
                counts[st : st + window] += mask
    return sums / torch.clamp(counts, min=1.0)


def thresholds(cfg: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(t1, t2) float32 a label, t2 = t1 / 2 in float32."""
    t1 = np.array([cfg["thresholds"][lab] for lab in cfg["labels"]], dtype=np.float32)
    return t1, (t1 / np.float32(2.0)).astype(np.float32)


def triggers(r: np.ndarray, t1: float, t2: float) -> List[Tuple[int, int]]:
    """obspy trigger_onset: (first sample > t1, last sample) of every run of
    samples > t2 that holds a sample > t1."""
    above2 = np.concatenate([[False], r > t2, [False]])
    d = np.diff(above2.astype(np.int8))
    run_on, run_off = np.flatnonzero(d == 1), np.flatnonzero(d == -1) - 1
    out = []
    for a, b in zip(run_on, run_off):
        hit = np.flatnonzero(r[a : b + 1] > t1)
        if hit.size:
            out.append((int(a + hit[0]), int(b)))
    return out


def pick_buffers(rows: np.ndarray, t1: Sequence[float], t2: Sequence[float], max_picks: int):
    """(peak_idx, peak_val, valid, on, off), each (R, max_picks), of curves
    (R, W): the earliest ``max_picks`` triggers a row, unused slots -1 / 0."""
    n = rows.shape[0]
    idx = np.full((n, max_picks), -1, np.int64)
    val = np.zeros((n, max_picks), np.float32)
    valid = np.zeros((n, max_picks), bool)
    on_, off_ = idx.copy(), idx.copy()
    for i in range(n):
        for j, (a, b) in enumerate(triggers(rows[i], t1[i], t2[i])[:max_picks]):
            p = a + int(np.argmax(rows[i, a : b + 1]))
            idx[i, j], val[i, j], valid[i, j], on_[i, j], off_[i, j] = p, rows[i, p], True, a, b
    return idx, val, valid, on_, off_


def row_gap(r: np.ndarray, t1: float, t2: float, pk, val, valid, on, off) -> float:
    """How far curve `r` (W,) is from giving one row's picks (see the
    module's docstring); inf for buffers that no curve gives."""
    w = r.shape[0]
    n = int(valid.sum())
    if not valid[:n].all():
        return float("inf")  # valid slots come first
    pk, val, on, off = (np.asarray(a[:n], dtype=np.int64 if a is not val else np.float64)
                        for a in (pk, val, on, off))
    if n and (on.min() < 0 or off.max() >= w or (on > pk).any() or (pk > off).any()
              or (on[1:] < off[:-1] + 2).any()):
        return float("inf")
    r64 = r.astype(np.float64)
    inside = np.zeros(w + 1, np.int64)
    np.add.at(inside, on, 1)
    np.add.at(inside, off + 1, -1)
    inside = np.cumsum(inside)[:w] > 0
    # a full buffer says nothing of the row after its last trigger
    end = int(off[-1]) + 1 if n == valid.shape[0] and n else w
    gaps = [0.0]
    outside = r64[:end][~inside[:end]]
    if outside.size:
        gaps.append(outside.max() - t1)
    if n:
        gaps.append((t1 - r64[on]).max())
        gaps.append((t2 - r64[inside]).max())
        after = off + 1 < w
        if after.any():
            gaps.append((r64[off[after] + 1] - t2).max())
        bounds = np.stack([on, off + 1], axis=1).reshape(-1)
        if bounds[-1] == w:  # the last segment then runs to the row's end by itself
            bounds = bounds[:-1]
        seg_max = np.maximum.reduceat(r64, bounds)[::2]
        gaps.append(((seg_max - r64[pk]) / 2.0).max())
        gaps.append(np.abs(val - r64[pk]).max())
    return float(max(gaps))


def pick_gap(cfg: dict, curves_np: np.ndarray, result: Dict[str, tuple]) -> Tuple[float, int]:
    """(gap, picks judged) of one request's program output `result`
    ({label: (peak_idx, peak_val, valid, on, off)}, each (S, slots)) against
    the reference curves (S, K, W)."""
    t1, t2 = thresholds(cfg)
    gap, n = 0.0, 0
    for ki, label in enumerate(cfg["labels"]):
        pk, val, valid, on, off = (np.asarray(a) for a in result[label])
        for si in range(curves_np.shape[0]):
            gap = max(gap, row_gap(curves_np[si, ki], float(t1[ki]), float(t2[ki]),
                                   pk[si], val[si], valid[si], on[si], off[si]))
            n += int(valid[si].sum())
    return gap, n


def as_result(cfg: dict, buffers, stations: int) -> Dict[str, tuple]:
    """Pick buffers of rows (label, station) as the program's result dict."""
    return {lab: tuple(a[ki * stations : (ki + 1) * stations] for a in buffers)
            for ki, lab in enumerate(cfg["labels"])}


def reference_result(cfg: dict, curves_np: np.ndarray, max_picks: int) -> Dict[str, tuple]:
    """The reference's own pick buffers of curves (S, K, W), as the program
    returns them: what the control hands in the program's place."""
    s, k, w = curves_np.shape
    t1, t2 = thresholds(cfg)
    rows = curves_np.transpose(1, 0, 2).reshape(k * s, w)
    buffers = pick_buffers(rows, np.repeat(t1, s), np.repeat(t2, s), max_picks)
    return as_result(cfg, buffers, s)
