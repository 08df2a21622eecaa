"""Synthetic VCSEIS-like dataset generation (fixtures, smoke training, bench).

Port of ``volpick_tpu/data/synthetic.py`` (a copy: numpy only, the same seed
gives the same arrays and metadata as the JAX package). ``synthetic_arrays``
returns the easy generator's traces in memory, for a machine without
``h5py`` or when no file is wanted, and ``ArrayDataset`` reads such arrays
the way the evaluation harness and ``RawBatchSource`` read a dataset file
(port-only: the JAX package has no in-memory dataset).

Two generators, same on-disk format (SeisBench HDF5+CSV):

- `make_synthetic_dataset`: the EASY fixture generator (clean sinusoids at
  24-40 dB SNR over a white noise floor). Kept for CI fixtures and smoke
  training, where a quickly-learnable task is the point. Every model scores
  F1 ~ 1.0 on it — it has no discriminating power and must not be used for
  quality claims.
- `make_hard_synthetic_dataset`: the HARD benchmark generator — graded SNR
  swept across (-5, +40) dB, colored (1/f^alpha + microseism) noise,
  band-limited stochastic wavelets instead of pure tones, emergent (ramped)
  onsets, LP/VT corner-frequency overlap, overlapping second events,
  spikes/gaps, and noise traces carrying non-seismic transients. Per-trace
  MEASURED `trace_mean_snr_db` / `trace_frequency_index` are written to the
  metadata so the performance-vs-SNR/FI analysis (`eval/analysis.py`, the
  reference's `Performance_vs_freq_vs_snr` study) can bin on them. Difficulty
  is modeled on the reference's description of VCSEIS (low-SNR emergent LP
  events, reference README.md:98-112) and its SNR definition
  (`volpick/data/utils.py:45-102`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from volpick_tpu_torch.data.writer import WaveformDataWriter


def _event_waveform(rng, n, sr, p_sample, s_sample, lp=False):
    t = np.arange(n) / sr
    tp, ts = p_sample / sr, s_sample / sr
    f_p, f_s = (3.0, 1.8) if lp else (9.0, 4.5)
    decay = 4.0 if lp else 1.5
    data = rng.normal(size=(3, n)) * 0.05
    rise = lambda t0, tau: (1 - np.exp(-np.clip(t - t0, 0, None) / tau)) * (t >= t0)
    env_p = rise(tp, 0.08) * np.exp(-np.clip(t - tp, 0, None) / decay)
    env_s = rise(ts, 0.12) * np.exp(-np.clip(t - ts, 0, None) / (decay * 1.6))
    amp = rng.uniform(0.5, 3.0)
    data[0] += np.sin(2 * np.pi * f_p * t + rng.uniform(0, 6)) * env_p * amp * 1.6
    data[1] += np.sin(2 * np.pi * f_p * t + rng.uniform(0, 6)) * env_p * amp * 0.5
    data[2] += np.sin(2 * np.pi * f_p * t + rng.uniform(0, 6)) * env_p * amp * 0.5
    data[1] += np.sin(2 * np.pi * f_s * t + rng.uniform(0, 6)) * env_s * amp * 2.2
    data[2] += np.sin(2 * np.pi * f_s * t + rng.uniform(0, 6)) * env_s * amp * 2.0
    data[0] += np.sin(2 * np.pi * f_s * t + rng.uniform(0, 6)) * env_s * amp * 0.7
    return data.astype(np.float32)


def _synthetic_traces(n_events, n_noise, n_samples, sampling_rate, seed, split_prob):
    """(metadata, waveform (3, n_samples) float32) for each trace, events first."""
    rng = np.random.default_rng(seed)
    for i in range(n_events + n_noise):
        is_noise = i >= n_events
        split = rng.choice(["train", "dev", "test"], p=list(split_prob))
        md = {
            "source_id": f"synth{i:05d}",
            "source_type": "noise" if is_noise else ("lp" if rng.random() < 0.4 else "regular"),
            "station_network_code": "AV",
            "station_code": f"S{i % 7:03d}",
            "station_location_code": "",
            "trace_channel": "BH",
            "trace_sampling_rate_hz": sampling_rate,
            "trace_name": f"synth{i:05d}",
            "split": split,
        }
        if is_noise:
            data = (rng.normal(size=(3, n_samples)) * rng.uniform(0.05, 0.5)).astype(
                np.float32
            )
            md["trace_p_arrival_sample"] = np.nan
            md["trace_s_arrival_sample"] = np.nan
        else:
            p = int(rng.uniform(0.25, 0.55) * n_samples)
            s = p + int(rng.uniform(1.0, 6.0) * sampling_rate)
            data = _event_waveform(rng, n_samples, sampling_rate, p, s, lp=md["source_type"] == "lp")
            md["trace_p_arrival_sample"] = float(p)
            md["trace_s_arrival_sample"] = float(s)
        yield md, data


def synthetic_arrays(
    n_events: int = 64,
    n_noise: int = 16,
    n_samples: int = 9001,
    sampling_rate: float = 100.0,
    seed: int = 0,
    split_prob=(0.7, 0.1, 0.2),
) -> Tuple[np.ndarray, List[dict]]:
    """The traces ``make_synthetic_dataset`` writes, in memory:
    (waveforms (N, 3, n_samples) float32, one metadata dict a trace)."""
    waves = np.empty((n_events + n_noise, 3, n_samples), dtype=np.float32)
    meta = []
    for i, (md, data) in enumerate(
        _synthetic_traces(n_events, n_noise, n_samples, sampling_rate, seed, split_prob)
    ):
        waves[i] = data
        meta.append(md)
    return waves, meta


class ArrayDataset:
    """A read-only dataset over traces in memory, with the reading interface
    of ``data/dataset.py::WaveformDataset``: ``metadata`` (a DataFrame of
    the meta dicts, with ``trace_chunk`` "" as a single-chunk dataset file
    gives it), ``sampling_rate``, ``len()`` and ``get_sample(i)``.
    ``synthetic_dataset`` builds one that reads like the file
    ``make_synthetic_dataset`` writes."""

    def __init__(self, waveforms: np.ndarray, metadata: List[dict], sampling_rate: float = 100.0):
        import pandas as pd

        self.waveforms = waveforms
        self.metadata = pd.DataFrame(metadata)
        self.metadata["trace_chunk"] = ""
        self.sampling_rate = sampling_rate

    def __len__(self):
        return len(self.metadata)

    def get_sample(self, idx: int) -> Tuple[np.ndarray, dict]:
        return self.waveforms[idx], self.metadata.iloc[idx].to_dict()


def synthetic_dataset(waveforms: np.ndarray, metadata: List[dict], sampling_rate: float = 100.0) -> ArrayDataset:
    """``ArrayDataset`` over ``synthetic_arrays``' output, each trace renamed
    to the reference ``WaveformDataWriter`` gives it in the file
    ``make_synthetic_dataset`` writes from the same arguments (traces of one
    shape go to the writer's buckets of 1024 in order: "bucket<k>$<i>,:C,:W"),
    so that evaluation targets name the same traces either way."""
    n, c, w = waveforms.shape
    meta = [dict(md, trace_name=f"bucket{i // 1024}${i % 1024},:{c},:{w}") for i, md in enumerate(metadata)]
    return ArrayDataset(waveforms, meta, sampling_rate)


def make_synthetic_dataset(
    dest_dir: Union[str, Path],
    n_events: int = 64,
    n_noise: int = 16,
    n_samples: int = 9001,
    sampling_rate: float = 100.0,
    seed: int = 0,
    chunk: str = "",
    split_prob=(0.7, 0.1, 0.2),
) -> Path:
    """Write a small labeled dataset; returns the dataset directory."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    meta_path = dest_dir / f"metadata{chunk}.csv"
    wave_path = dest_dir / f"waveforms{chunk}.hdf5"
    with WaveformDataWriter(meta_path, wave_path) as writer:
        writer.data_format = {
            "dimension_order": "CW",
            "component_order": "ZNE",
            "unit": "counts",
            "instrument_response": "not restituted",
        }
        for md, data in _synthetic_traces(n_events, n_noise, n_samples, sampling_rate, seed, split_prob):
            writer.add_trace(md, data)
    generate_chunk_file(dest_dir)
    return dest_dir


def generate_chunk_file(dataset_dir: Union[str, Path]) -> List[str]:
    """(Re)create the `chunks` index from the metadata files present (a copy of
    ``volpick_tpu/data/assemble.py::generate_chunk_file``)."""
    dataset_dir = Path(dataset_dir)
    chunks = sorted(
        p.name[len("metadata") : -len(".csv")] for p in dataset_dir.glob("metadata*.csv")
    )
    with open(dataset_dir / "chunks", "w") as f:
        f.write("\n".join(chunks) + ("\n" if chunks else ""))
    return chunks


# --------------------------------------------------------------------------
# Hard benchmark generator
# --------------------------------------------------------------------------


def _shaped_noise(rng, n: int, sr: float, alpha: float, microseism: float = 0.0,
                  hum_freq: float = 0.0, hum_amp: float = 0.0) -> np.ndarray:
    """Colored background noise, (3, n), unit RMS per component.

    Amplitude spectrum ~ 1/f^(alpha/2) (alpha = PSD slope) with an optional
    ocean-microseism Gaussian bump near 0.2 Hz and an optional monochromatic
    cultural hum line.
    """
    freq = np.fft.rfftfreq(n, 1.0 / sr)
    f_lo = 0.05  # flatten below 0.05 Hz so DC doesn't blow up
    shape = 1.0 / np.maximum(freq, f_lo) ** (alpha / 2.0)
    if microseism > 0:
        shape = shape * (1.0 + microseism * np.exp(-0.5 * ((freq - 0.22) / 0.08) ** 2))
    out = np.empty((3, n), dtype=np.float32)
    for c in range(3):
        spec = (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * shape
        spec[0] = 0.0
        x = np.fft.irfft(spec, n=n)
        x /= max(np.sqrt(np.mean(x**2)), 1e-12)
        if hum_amp > 0 and hum_freq > 0:
            x = x + hum_amp * np.sin(2 * np.pi * hum_freq * np.arange(n) / sr
                                     + rng.uniform(0, 2 * np.pi))
        out[c] = x
    return out


def _stochastic_wavelet(rng, n: int, sr: float, onset_s: float, f0: float,
                        rel_bw: float, tau_rise: float, tau_decay: float) -> np.ndarray:
    """Band-limited noise burst: Gaussian band at f0, emergent rise, exp coda.

    Zero before `onset_s`; peak-|amplitude| normalized to 1. This replaces the
    easy generator's pure sinusoid — real VT/LP arrivals are stochastic
    wide/narrow-band bursts, and a picker can no longer lock onto a single
    deterministic phase.
    """
    freq = np.fft.rfftfreq(n, 1.0 / sr)
    band = np.exp(-0.5 * ((freq - f0) / max(rel_bw * f0, 0.05)) ** 2)
    spec = (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * band
    spec[0] = 0.0
    carrier = np.fft.irfft(spec, n=n)
    t = np.arange(n) / sr - onset_s
    env = np.where(t >= 0, (1.0 - np.exp(-np.maximum(t, 0) / max(tau_rise, 1e-3)))
                   * np.exp(-np.maximum(t, 0) / max(tau_decay, 1e-3)), 0.0)
    x = carrier * env
    peak = np.max(np.abs(x))
    return (x / max(peak, 1e-12)).astype(np.float32)


# Default physics of the hard benchmark (local volcanic mix). Every range is
# overridable through the `domain` dict so a SECOND, differently-parameterized
# domain can be generated for zero-shot cross-domain evaluation — the offline
# analogue of the reference's INSTANCE/STEAD/western-US studies (reference
# `model_training/test_INSTANCE.ipynb`, `Performance_vs_freq_vs_snr/
# FI_test_westernus`). Overriding bounds does NOT change the rng call order,
# so the default domain reproduces the committed benchmark bit-exactly.
DEFAULT_DOMAIN = {
    "lp_f0": (0.7, 5.5),       # log-uniform P corner (Hz), LP events
    "vt_f0": (3.5, 16.0),      # log-uniform P corner (Hz), VT events
    "lp_bw": (0.10, 0.40),     # relative bandwidth
    "vt_bw": (0.25, 0.70),
    "lp_rise": (0.15, 2.0),    # log-uniform onset rise (s)
    "vt_rise": (0.03, 0.5),
    "lp_decay": (2.0, 12.0),   # coda decay (s)
    "vt_decay": (0.8, 5.0),
    "f0s_factor": (0.55, 0.80),  # S corner as a fraction of P's
    "s_over_p": (1.2, 3.5),    # S/P amplitude ratio
    "sp_seconds": (0.8, 12.0),  # S-P time (s)
    "noise_alpha": (0.5, 1.6),  # PSD slope of the colored background
    "microseism": (0.0, 4.0),   # microseism bump strength
    "hum_prob": 0.25,           # probability of a cultural hum line
}

# A shifted-physics domain: regional tectonic-style seismicity — corners
# shifted up, broader VT bands, faster rises/shorter codas, longer S-P times
# (larger epicentral distance), steeper noise with stronger microseism and
# more cultural hum, and an LP-minority population. Used by
# scripts/run_crossdomain_study.py for the zero-shot leg.
SHIFTED_DOMAIN = {
    "lp_f0": (1.5, 8.0),
    "vt_f0": (6.0, 24.0),
    "lp_bw": (0.15, 0.50),
    "vt_bw": (0.35, 0.90),
    "lp_rise": (0.08, 1.0),
    "vt_rise": (0.02, 0.25),
    "lp_decay": (1.0, 6.0),
    "vt_decay": (0.5, 2.5),
    "f0s_factor": (0.45, 0.70),
    "s_over_p": (1.5, 5.0),
    "sp_seconds": (3.0, 20.0),
    "noise_alpha": (1.2, 2.4),
    "microseism": (1.0, 6.0),
    "hum_prob": 0.5,
}


def _hard_event(rng, n: int, sr: float, p: int, s: int, lp: bool,
                dom: dict = DEFAULT_DOMAIN) -> np.ndarray:
    """Event-only 3-component signal (unit-scale; caller scales to target SNR).

    LP: low corner (log-uniform), narrow band, emergent onsets, long coda.
    VT: higher corner but overlapping LP's range at the low end, broader
    band, mostly impulsive. P is Z-dominant, S is horizontal-dominant at a
    fraction of the P corner. All bounds come from `dom` (see DEFAULT_DOMAIN).
    """
    tp, ts = p / sr, s / sr
    if lp:
        f0p = np.exp(rng.uniform(*np.log(dom["lp_f0"])))
        bw = rng.uniform(*dom["lp_bw"])
        rise_p = np.exp(rng.uniform(*np.log(dom["lp_rise"])))
        decay = rng.uniform(*dom["lp_decay"])
    else:
        f0p = np.exp(rng.uniform(*np.log(dom["vt_f0"])))
        bw = rng.uniform(*dom["vt_bw"])
        rise_p = np.exp(rng.uniform(*np.log(dom["vt_rise"])))
        decay = rng.uniform(*dom["vt_decay"])
    f0s = f0p * rng.uniform(*dom["f0s_factor"])
    rise_s = rise_p * rng.uniform(1.0, 2.0)
    decay_s = decay * rng.uniform(1.2, 2.0)
    s_over_p = rng.uniform(*dom["s_over_p"])  # S usually larger

    data = np.zeros((3, n), dtype=np.float32)
    # independent wavelet realizations per component (incoherent coda)
    pz = _stochastic_wavelet(rng, n, sr, tp, f0p, bw, rise_p, decay)
    ph1 = _stochastic_wavelet(rng, n, sr, tp, f0p, bw, rise_p, decay)
    ph2 = _stochastic_wavelet(rng, n, sr, tp, f0p, bw, rise_p, decay)
    sz = _stochastic_wavelet(rng, n, sr, ts, f0s, bw, rise_s, decay_s)
    sh1 = _stochastic_wavelet(rng, n, sr, ts, f0s, bw, rise_s, decay_s)
    sh2 = _stochastic_wavelet(rng, n, sr, ts, f0s, bw, rise_s, decay_s)
    data[0] = pz * 1.0 + sz * (s_over_p * 0.45)
    data[1] = ph1 * rng.uniform(0.3, 0.6) + sh1 * s_over_p
    data[2] = ph2 * rng.uniform(0.3, 0.6) + sh2 * (s_over_p * rng.uniform(0.8, 1.1))
    return data


def _measured_fi(data: np.ndarray, sr: float, lo: int, hi: int) -> float:
    from volpick_tpu_torch.acquisition.convert import _frequency_index_numpy

    vals = [_frequency_index_numpy(comp[lo:hi], 1.0 / sr) for comp in data]
    vals = [v for v in vals if v == v]
    return float(np.mean(vals)) if vals else float("nan")


def make_hard_synthetic_dataset(
    dest_dir: Union[str, Path],
    n_events: int = 64,
    n_noise: int = 16,
    n_samples: int = 12001,
    sampling_rate: float = 100.0,
    seed: int = 0,
    chunk: str = "",
    split_prob=(0.7, 0.1, 0.2),
    snr_range_db=(-5.0, 40.0),
    second_event_prob: float = 0.12,
    lp_fraction: float = 0.4,
    domain: dict = None,
) -> Path:
    """Write the HARD graded-difficulty benchmark; returns the dataset dir.

    Every event trace gets a target SNR drawn uniformly from `snr_range_db`,
    calibrated against the reference SNR definition (P95 amplitude ratio,
    S-window vs pre-P window, `volpick/data/utils.py:45-102`) and then
    RE-MEASURED after composition; the measured values land in
    `trace_mean_snr_db` (and per-component `trace_snr_db`), with
    `trace_frequency_index` measured over the signal span — so
    `eval.analysis.performance_vs_snr_fi` bins on real, not nominal, values.
    """
    from volpick_tpu_torch.acquisition.convert import _snr_db_numpy

    dom = dict(DEFAULT_DOMAIN, **(domain or {}))
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = sampling_rate
    winlen = 500
    meta_path = dest_dir / f"metadata{chunk}.csv"
    wave_path = dest_dir / f"waveforms{chunk}.hdf5"
    with WaveformDataWriter(meta_path, wave_path) as writer:
        writer.data_format = {
            "dimension_order": "CW",
            "component_order": "ZNE",
            "unit": "counts",
            "instrument_response": "not restituted",
        }
        for i in range(n_events + n_noise):
            is_noise = i >= n_events
            split = rng.choice(["train", "dev", "test"], p=list(split_prob))
            md = {
                "source_id": f"hard{i:05d}",
                "source_type": "noise" if is_noise else ("lp" if rng.random() < lp_fraction else "regular"),
                "station_network_code": "AV",
                "station_code": f"S{i % 11:03d}",
                "station_location_code": "",
                "trace_channel": "BH",
                "trace_sampling_rate_hz": sr,
                "trace_name": f"hard{i:05d}",
                "split": split,
            }
            # colored background noise, always
            alpha = rng.uniform(*dom["noise_alpha"])
            micro = rng.uniform(*dom["microseism"])
            hum_f = rng.uniform(1.5, 9.0) if rng.random() < dom["hum_prob"] else 0.0
            hum_a = rng.uniform(0.1, 0.6) if hum_f else 0.0
            noise = _shaped_noise(rng, n_samples, sr, alpha, micro, hum_f, hum_a)
            noise *= np.exp(rng.uniform(np.log(0.2), np.log(50.0)))  # absolute scale varies

            if is_noise:
                data = noise
                # non-seismic transients: spikes and envelope bursts with no
                # clean P/S structure -> false-positive pressure
                if rng.random() < 0.35:
                    for _ in range(rng.integers(1, 4)):
                        j = rng.integers(0, n_samples)
                        c = rng.integers(0, 3)
                        data[c, j] += rng.choice([-1, 1]) * rng.uniform(10, 30) * np.std(data[c])
                if rng.random() < 0.25:
                    t0 = rng.uniform(5.0, n_samples / sr - 15.0)
                    f0 = np.exp(rng.uniform(np.log(1.0), np.log(12.0)))
                    burst = _stochastic_wavelet(rng, n_samples, sr, t0, f0,
                                                rng.uniform(0.2, 0.6),
                                                rng.uniform(1.0, 4.0),  # slow symmetric-ish rise
                                                rng.uniform(2.0, 6.0))
                    amp = rng.uniform(1.0, 4.0) * np.std(data)
                    data = data + burst[None, :] * amp * rng.uniform(0.5, 1.0, size=(3, 1)).astype(np.float32)
                if rng.random() < 0.10:
                    g0 = rng.integers(0, n_samples - 400)
                    data[:, g0 : g0 + rng.integers(100, 400)] = 0.0
                md["trace_p_arrival_sample"] = np.nan
                md["trace_s_arrival_sample"] = np.nan
                md["trace_mean_snr_db"] = np.nan
                md["trace_frequency_index"] = np.nan
                writer.add_trace(md, data.astype(np.float32))
                continue

            lp = md["source_type"] == "lp"
            p = int(rng.uniform(0.20, 0.55) * n_samples)
            s = p + int(rng.uniform(*dom["sp_seconds"]) * sr)
            s = min(s, int(0.92 * n_samples))
            event = _hard_event(rng, n_samples, sr, p, s, lp, dom)

            # calibrate to the target SNR under the reference P95 definition:
            # gain such that mean-dB of P95(S window of event)/P95(pre-P noise)
            # hits the target, then re-measure on the composed trace below
            target = rng.uniform(*snr_range_db)
            noi_p95 = np.array([np.percentile(np.abs(noise[c, max(0, p - winlen):p]), 95)
                                for c in range(3)])
            sig_p95 = np.array([np.percentile(np.abs(event[c, s:min(s + winlen, n_samples)]), 95)
                                for c in range(3)])
            cur_db = np.mean(20 * np.log10(np.maximum(sig_p95, 1e-12) / np.maximum(noi_p95, 1e-12)))
            gain = 10 ** ((target - cur_db) / 20.0)
            data = noise + gain * event

            # overlapping second (unlabeled) event later in the trace
            if rng.random() < second_event_prob and s + int(4 * sr) < n_samples - int(8 * sr):
                p2 = s + int(rng.uniform(3.0, min(14.0, (n_samples - s) / sr - 6.0)) * sr)
                s2 = min(p2 + int(rng.uniform(0.8, 8.0) * sr), n_samples - 10)
                ev2 = _hard_event(rng, n_samples, sr, p2, s2, rng.random() < lp_fraction, dom)
                data = data + ev2 * gain * rng.uniform(0.3, 1.5)

            if rng.random() < 0.15:  # spikes on event traces too
                for _ in range(rng.integers(1, 3)):
                    j = rng.integers(0, n_samples)
                    c = rng.integers(0, 3)
                    data[c, j] += rng.choice([-1, 1]) * rng.uniform(10, 30) * np.std(data[c])
            if rng.random() < 0.08:  # gap, kept >=3 s away from both picks
                for _ in range(8):
                    g0 = int(rng.integers(0, n_samples - 300))
                    g1 = g0 + int(rng.integers(100, 300))
                    if (g1 < p - 3 * sr or g0 > p + 3 * sr) and (g1 < s - 3 * sr or g0 > s + 3 * sr):
                        data[:, g0:g1] = 0.0
                        break

            data = data.astype(np.float32)
            snrs, mean_snr = _snr_db_numpy(data, float(p), float(s), winlen)
            lo = max(0, p - int(1 * sr))
            hi = min(n_samples, s + int(15 * sr))
            md["trace_p_arrival_sample"] = float(p)
            md["trace_s_arrival_sample"] = float(s)
            md["trace_snr_db"] = snrs
            md["trace_mean_snr_db"] = mean_snr
            md["trace_frequency_index"] = _measured_fi(data, sr, lo, hi)
            writer.add_trace(md, data)
    generate_chunk_file(dest_dir)
    return dest_dir
