"""QC / diagnostics plotting (loss curves, prediction examples, spectrograms).

Counterparts of the reference's matplotlib tooling: loss-curve plots from
metrics.csv (`volpick/model/utils.py:26-187`), qualitative prediction panels
(`utils.py:248-701`), and the waveform/spectrum/spectrogram QC figures
(`volpick/data/utils.py:203-573`). All functions return the figure and can
save to disk; matplotlib uses the Agg backend (headless).

Port of ``volpick_tpu/utils/plotting.py``: matplotlib on numpy as there;
``plot_prediction_examples`` takes the model, which holds its weights, and
runs its eval forward on `device` (the card unless ``device="cpu"``; the
EQT family's LSTMs go through the K2 kernel there). ``_prediction_arrays``
returns what a panel draws, so that it can be checked without pixels."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_loss_curves(experiment_dir, save_path=None, log_scale: bool = False):
    """Train/val loss + LR vs epoch from an experiment's metrics.csv."""
    import pandas as pd

    plt = _mpl()
    df = pd.read_csv(Path(experiment_dir) / "metrics.csv")
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    ax = axes[0]
    ax.plot(df["epoch"], df["train_loss"], label="train")
    if "val_loss" in df and df["val_loss"].notna().any():
        ax.plot(df["epoch"], df["val_loss"], label="val")
    if log_scale:
        ax.set_yscale("log")
    ax.set_ylabel("loss")
    ax.legend()
    axes[1].plot(df["epoch"], df["lr"])
    axes[1].set_ylabel("lr")
    axes[1].set_xlabel("epoch")
    axes[1].set_yscale("log")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def spectrogram(data: np.ndarray, sampling_rate: float, ax=None, wlen: float = 1.28,
                overlap: float = 0.9, dbscale: bool = True, cmap="viridis"):
    """Spectrogram image on an axes (scipy STFT; obspy-like appearance)."""
    from scipy.signal import spectrogram as sp_spec

    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots()
    nperseg = max(int(wlen * sampling_rate), 16)
    f, t, sxx = sp_spec(
        data, fs=sampling_rate, nperseg=nperseg, noverlap=int(nperseg * overlap)
    )
    z = 10 * np.log10(np.maximum(sxx, 1e-20)) if dbscale else np.sqrt(sxx)
    im = ax.pcolormesh(t, f, z, shading="gouraud", cmap=cmap)
    ax.set_ylabel("frequency (Hz)")
    return im


def plot_spectrum(
    data: np.ndarray,
    sampling_rate: float = 100.0,
    ax=None,
    component_names: str = "ZNE",
    loglog: bool = True,
    save_path=None,
):
    """Amplitude spectra of (C, W) waveforms (`volpick/data/utils.py`
    plot_spectrum role)."""
    plt = _mpl()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 4))
    data = np.atleast_2d(data)
    w = data.shape[-1]
    freq = np.fft.rfftfreq(w, 1.0 / sampling_rate)
    for i, comp in enumerate(data):
        spec = np.abs(np.fft.rfft(comp - comp.mean()))
        label = component_names[i] if i < len(component_names) else f"ch{i}"
        ax.plot(freq[1:], spec[1:], lw=0.7, label=label)
    if loglog:
        ax.set_xscale("log")
        ax.set_yscale("log")
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("amplitude")
    ax.legend()
    if save_path and fig is not None:
        fig.tight_layout()
        fig.savefig(save_path, dpi=150)
    return ax


def plot_waveform(
    data: np.ndarray,
    sampling_rate: float = 100.0,
    p_sample: Optional[float] = None,
    s_sample: Optional[float] = None,
    component_names: str = "ZNE",
    with_spectrogram: bool = True,
    title: str = "",
    save_path=None,
):
    """3-component waveform (+ optional spectrograms) with pick markers."""
    plt = _mpl()
    c = data.shape[0]
    rows = c * (2 if with_spectrogram else 1)
    fig, axes = plt.subplots(rows, 1, figsize=(10, 2 * rows), sharex=True)
    axes = np.atleast_1d(axes)
    t = np.arange(data.shape[-1]) / sampling_rate
    for i in range(c):
        ax = axes[i * 2] if with_spectrogram else axes[i]
        ax.plot(t, data[i], "k", lw=0.5)
        ax.set_ylabel(component_names[i] if i < len(component_names) else f"ch{i}")
        for sample, color, label in ((p_sample, "b", "P"), (s_sample, "r", "S")):
            if sample is not None and not np.isnan(sample):
                ax.axvline(sample / sampling_rate, color=color, label=label)
        if with_spectrogram:
            spectrogram(data[i], sampling_rate, ax=axes[i * 2 + 1])
    axes[0].set_title(title)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def _prediction_arrays(model, data: np.ndarray, p0: float, s0: float, device: torch.device):
    """What one panel of ``plot_prediction_examples`` draws: (x, the
    conditioned (1, C, window) float32 window around the first labelled
    onset, else the trace's middle; curves, {label: (window,) probabilities}
    of the model's eval forward on `device`; w0, the window's first sample
    in the trace)."""
    from volpick_tpu_torch.device import inference_work
    from volpick_tpu_torch.ops.windows import pad_frame

    window = model.in_samples
    center = int(p0 if not np.isnan(p0) else (s0 if not np.isnan(s0) else data.shape[-1] // 2))
    w0 = int(np.clip(center - window // 2, 0, max(data.shape[-1] - window, 0)))
    x = pad_frame(data, w0, window)[None].astype(np.float32)
    # condition like the eval path
    if model.name == "EQTransformer":
        tt = np.arange(window) - (window - 1) / 2
        sl = ((x - x.mean(-1, keepdims=True)) * tt).sum(-1, keepdims=True) / (tt * tt).sum()
        x = x - x.mean(-1, keepdims=True) - sl * tt
    else:
        x = x - x.mean(-1, keepdims=True)
    x = (x / (np.abs(x).max(-1, keepdims=True) + 1e-10)).astype(np.float32)
    with inference_work(device):
        out = model(torch.as_tensor(x, device=device))
        if model.name == "EQTransformer":
            det, p, s = (o.float().cpu().numpy() for o in out)
            curves = {"Detection": det[0], "P": p[0], "S": s[0]}
        else:
            pred = out.float().cpu().numpy()[0]
            curves = {lab: pred[i] for i, lab in enumerate(model.phases)}
    return x, curves, w0


def plot_prediction_examples(
    model,
    dataset,
    indices: Sequence[int],
    save_dir=None,
    thresholds: Optional[dict] = None,
    device=None,
):
    """Per-trace panels: waveform with true picks + model probability curves
    (the qualitative-eval figure of `volpick/model/utils.py:248-701`).
    `model` is moved to `device` (the card unless ``device="cpu"``) and put
    in eval mode."""
    from volpick_tpu_torch.device import resolve_device
    from volpick_tpu_torch.pipeline.generator import _onset_arrays

    plt = _mpl()
    device = resolve_device(device, "plot_prediction_examples")
    model = model.to(device).eval()
    thresholds = thresholds or dict(model.default_args)
    window = model.in_samples
    p_all, s_all = _onset_arrays(dataset.metadata)
    figs = []
    for idx in indices:
        data, md = dataset.get_sample(int(idx))
        p0, s0 = p_all[idx], s_all[idx]
        x, curves, w0 = _prediction_arrays(model, data, p0, s0, device)

        fig, axes = plt.subplots(4, 1, figsize=(10, 7), sharex=True)
        t = np.arange(window) / model.sampling_rate
        for i in range(3):
            axes[i].plot(t, x[0, i], "k", lw=0.5)
            axes[i].set_ylabel("ZNE"[i])
        for lab, curve in curves.items():
            axes[3].plot(t, curve, label=lab)
        for onset, color, lab in ((p0, "b", "P true"), (s0, "r", "S true")):
            if not np.isnan(onset):
                rel = (onset - w0) / model.sampling_rate
                if 0 <= rel <= t[-1]:
                    for ax in axes:
                        ax.axvline(rel, color=color, ls="--", lw=0.8)
        axes[3].legend(loc="upper right", fontsize=8)
        axes[3].set_ylim(-0.05, 1.05)
        axes[3].set_xlabel("time (s)")
        fig.suptitle(f"trace {md.get('trace_name', idx)} ({md.get('source_type', '')})")
        fig.tight_layout()
        if save_dir:
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            fig.savefig(Path(save_dir) / f"prediction_{idx}.png", dpi=130)
            plt.close(fig)
        figs.append(fig)
    return figs


# ------------------------------------------------------- batch table plotters
def _batch_qc(waveform_table, data_dir, indices, fig_dir, loader, render, suffix):
    """Shared loop of the table-driven QC figure batches (reference
    `volpick/data/utils.py:203-573`): per selected row, load
    `<data_dir>/<trace_name>` (mseed via the native reader by default),
    render one figure, save it under `<data_dir>_fig/` as jpg."""
    data_dir = Path(data_dir)
    if fig_dir is None:
        fig_dir = data_dir.parent / f"{data_dir.name}_fig"
    fig_dir = Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    if loader is None:
        from volpick_tpu_torch.io.miniseed import read_mseed as loader
    if max(indices) >= len(waveform_table):
        raise KeyError(
            f"The maximum requested index {max(indices)} is larger than the "
            f"number of rows ({len(waveform_table)})"
        )
    out_paths = []
    for i in indices:
        md = waveform_table.iloc[i]
        name = str(md["trace_name"])
        path = data_dir / name
        if not path.exists() and (data_dir / f"{name}.mseed").exists():
            path = data_dir / f"{name}.mseed"
        stream = loader(path)
        fig = render(stream, md)
        stem = name.rsplit("/", 1)[-1]
        stem = stem[: -len(".mseed")] if stem.endswith(".mseed") else stem
        path = fig_dir / f"{stem}.jpg"
        fig.savefig(path, bbox_inches="tight", dpi=150)
        _mpl().close(fig)
        out_paths.append(path)
    return out_paths


def _pick_times(md):
    import pandas as pd

    from volpick_tpu_torch.core.stream import UTC

    picks = []
    for col, label, color in (
        ("trace_p_arrival_time", "P", "blue"),
        ("trace_s_arrival_time", "S", "red"),
    ):
        v = md.get(col)
        if v is not None and not pd.isna(v):
            picks.append((UTC(v).timestamp, label, color))
    return picks


def plot_waveforms(waveform_table, data_dir, indices, fig_dir=None, loader=None):
    """Batch per-trace waveform figures with P/S pick markers (reference
    `plot_waveforms`, `volpick/data/utils.py:203-300`)."""
    plt = _mpl()

    def render(stream, md):
        picks = _pick_times(md)
        t0 = min(tr.stats.starttime.timestamp for tr in stream)
        fig, axes = plt.subplots(len(stream), 1, figsize=(8, 2.2 * len(stream)),
                                 sharex=True, squeeze=False)
        for k, tr in enumerate(stream):
            ax = axes[k][0]
            t = tr.stats.starttime.timestamp - t0 + np.arange(tr.stats.npts) / tr.stats.sampling_rate
            ax.plot(t, tr.data, "k", lw=0.7, label=tr.id)
            for ts, label, color in picks:
                ax.axvline(ts - t0, color=color, label=label)
            ax.legend(fontsize=8)
        axes[-1][0].set_xlabel("time (s)")
        return fig

    return _batch_qc(waveform_table, data_dir, indices, fig_dir, loader, render, "wave")


def plot_spectra(waveform_table, data_dir, indices, fig_dir=None, loader=None):
    """Batch waveform + amplitude-spectrum panels (reference `plot_spectrum`,
    `volpick/data/utils.py:302-435`)."""
    plt = _mpl()

    def render(stream, md):
        picks = _pick_times(md)
        t0 = min(tr.stats.starttime.timestamp for tr in stream)
        n = len(stream)
        fig, axes = plt.subplots(n, 2, figsize=(11, 2.2 * n), squeeze=False)
        for k, tr in enumerate(stream):
            t = tr.stats.starttime.timestamp - t0 + np.arange(tr.stats.npts) / tr.stats.sampling_rate
            axes[k][0].plot(t, tr.data, "k", lw=0.5)
            for ts, label, color in picks:
                axes[k][0].axvline(ts - t0, color=color, label=label)
            axes[k][0].text(0.97, 0.02, tr.id, transform=axes[k][0].transAxes,
                            ha="right", va="bottom", fontsize=8)
            data = np.asarray(tr.data, dtype=np.float64)
            win = np.hanning(len(data))
            freqs = np.fft.rfftfreq(len(data), 1.0 / tr.stats.sampling_rate)
            spec = np.abs(np.fft.rfft(data * win))
            keep = freqs > 0.1
            axes[k][1].semilogx(freqs[keep], spec[keep], color="blue", lw=0.5)
            axes[k][1].axvline(1, color="gray")
            axes[k][1].yaxis.tick_right()
        axes[0][0].set_title("Time series")
        axes[0][1].set_title("Amplitude spectrum")
        axes[-1][0].set_xlabel("time (s)")
        axes[-1][1].set_xlabel("Frequency (Hz)")
        return fig

    return _batch_qc(waveform_table, data_dir, indices, fig_dir, loader, render, "spec")


def plot_spectrograms(waveform_table, data_dir, indices, fig_dir=None, loader=None):
    """Batch waveform + spectrogram panels (reference `plot_spectrogram`,
    `volpick/data/utils.py:437-573`)."""
    plt = _mpl()

    def render(stream, md):
        picks = _pick_times(md)
        t0 = min(tr.stats.starttime.timestamp for tr in stream)
        n = len(stream)
        fig, axes = plt.subplots(2 * n, 1, figsize=(8, 2.0 * 2 * n), sharex=True)
        axes = np.atleast_1d(axes)
        for k, tr in enumerate(stream):
            t = tr.stats.starttime.timestamp - t0 + np.arange(tr.stats.npts) / tr.stats.sampling_rate
            axes[2 * k].plot(t, tr.data, "k", lw=0.5, label=tr.id)
            for ts, label, color in picks:
                axes[2 * k].axvline(ts - t0, color=color, label=label)
            axes[2 * k].legend(fontsize=8)
            spectrogram(np.asarray(tr.data, np.float64), tr.stats.sampling_rate,
                        ax=axes[2 * k + 1])
        axes[-1].set_xlabel("time (s)")
        return fig

    return _batch_qc(waveform_table, data_dir, indices, fig_dir, loader, render, "sgram")
