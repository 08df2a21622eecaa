"""Dataset QC via model screening (reference `volpick/data/utils.py:574-1175`).

The reference's visual-QC pass runs pretrained PhaseNet + EQTransformer over
candidate (usually noise) traces — on the raw (>0.3 Hz) and 1-20 Hz-filtered
waveform — and flags traces where any model probability exceeds a threshold
(likely hidden events). Here the screen runs as batched device inference;
flagged traces can optionally be rendered with plot_waveform for human review.

Port of ``volpick_tpu/utils/qc.py``: the pickers are the port's
``WaveformPicker``s, each running its forward (``_condition`` then
``_apply_model``) on framed windows on its own device; the band filter is
scipy's ``sosfilt`` on the host, as in JAX; the flagged traces are drawn by
the port's ``utils/plotting.py::plot_waveform``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("volpick_tpu_torch")


def check_waveforms(
    pickers: Sequence,
    data: np.ndarray,
    sampling_rate: float = 100.0,
    threshold: float = 0.3,
    bands: Sequence[Optional[Tuple[float, float]]] = (None, (1.0, 20.0)),
    batch_size: int = 64,
) -> np.ndarray:
    """Flag traces whose max P/S probability under any picker/band exceeds
    `threshold`. data: (B, C, W). Returns a boolean (B,) flag array."""
    import torch
    from scipy.signal import butter, sosfilt

    from volpick_tpu_torch.device import inference_work
    from volpick_tpu_torch.ops.windows import frame_windows, window_starts

    b, c, w = data.shape
    flags = np.zeros(b, dtype=bool)
    for band in bands:
        if band is None:
            x = data
        else:
            sos = butter(4, band, btype="bandpass", fs=sampling_rate, output="sos")
            x = sosfilt(sos, data, axis=-1)
        for picker in pickers:
            window = picker.in_samples
            starts = window_starts(max(w, window), window, window // 2)
            xx = x
            if w < window:
                xx = np.pad(x, ((0, 0), (0, 0), (0, window - w)))
            for lo in range(0, b, batch_size):
                chunk = xx[lo : lo + batch_size]
                with inference_work(picker.device):
                    frames = frame_windows(
                        torch.as_tensor(np.asarray(chunk, dtype=np.float32), device=picker.device),
                        torch.as_tensor(starts), window,
                    )  # (N, B', C, window)
                    n, bb = frames.shape[0], frames.shape[1]
                    frames = frames.reshape(n * bb, c, window)
                    preds = picker._apply_model(picker._condition(frames)).cpu().numpy()  # (N*B', K, window)
                channels = picker._prob_channels()
                prob = np.zeros(preds.shape[0])
                for ki, lab in enumerate(channels):
                    if lab in ("P", "S"):
                        prob = np.maximum(prob, preds[:, ki].max(-1))
                prob = prob.reshape(n, bb).max(0)
                flags[lo : lo + bb] |= prob > threshold
    return flags


def screen_dataset_with_models(
    dataset,
    pickers: Sequence,
    threshold: float = 0.3,
    out_dir=None,
    plot_flagged: bool = False,
    max_plots: int = 50,
) -> np.ndarray:
    """Run check_waveforms over a whole dataset and, with `out_dir`, write
    the metadata with a ``qc_flagged`` column to ``qc_flags.csv`` and, with
    ``plot_flagged``, the first `max_plots` flagged traces to
    ``flagged_<i>.png`` for manual review. Returns the flag array (aligned
    to metadata)."""
    n = len(dataset)
    flags = np.zeros(n, dtype=bool)
    batch = 64
    for lo in range(0, n, batch):
        idxs = range(lo, min(lo + batch, n))
        waves = [dataset.get_sample(i)[0] for i in idxs]
        max_w = max(x.shape[-1] for x in waves)
        arr = np.zeros((len(waves), waves[0].shape[0], max_w), dtype=np.float32)
        for j, x in enumerate(waves):
            arr[j, :, : x.shape[-1]] = x
        flags[lo : lo + len(waves)] = check_waveforms(
            pickers, arr, dataset.sampling_rate or 100.0, threshold
        )
    logger.info(f"QC screen: {flags.sum()}/{n} traces flagged (> {threshold})")
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        md = dataset.metadata.copy()
        md["qc_flagged"] = flags
        md.to_csv(out_dir / "qc_flags.csv", index=False)
        if plot_flagged:
            from volpick_tpu_torch.utils.plotting import plot_waveform

            for i in np.where(flags)[0][:max_plots]:
                data, m = dataset.get_sample(int(i))
                plot_waveform(
                    data,
                    dataset.sampling_rate or 100.0,
                    title=str(m.get("trace_name", i)),
                    save_path=out_dir / f"flagged_{i}.png",
                )
    return flags
