"""Waveform → benchmark-dataset conversion (reference `volpick/data/convert.py`).

``convert_catalog_to_dataset`` reproduces the reference converter's behavior:
resample to 100 Hz, demean, optional edge trim / long-trace trim around the
picks, spike flagging (optionally skipping), arrival-time → sample indices,
3-component SNR (95th-percentile, 5 s windows), per-trace frequency index
(1 s before / 6 s after the reference pick), random train/dev/test split, and
a final per-source FI pass — written as a SeisBench-format chunk.

Waveforms are supplied by a ``loader(trace_name) -> Stream`` callable: obspy
mseed reading when obspy is installed, our native miniSEED reader, or any
in-memory source (tests).

Port of ``volpick_tpu/acquisition/convert.py`` (a copy over the port's
``core``, ``io`` and ``data`` modules; h5py is imported where a file is
written, by ``data/writer.py``). The split column is drawn as in JAX: with a
``seed``, from ``np.random.RandomState(seed)``, which yields the stream that
JAX's ``np.random.seed(seed)`` gives the global state; without one, from the
global state. The port leaves the global state as it found it.
``_frequency_index_numpy`` and ``_snr_db_numpy`` are also what
``data/synthetic.py`` records in its metadata.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

from volpick_tpu_torch.core.stream import Stream, UTC
from volpick_tpu_torch.data.writer import WaveformDataWriter

logger = logging.getLogger("volpick_tpu_torch")


def stream_to_array(stream: Stream, component_order: str = "ZNE"):
    """(starttime, data (C, W), completeness) with gap zero-fill.

    Component matching uses the relaxed `*{c}` channel pattern (the
    reference's deliberate deviation from seisbench, `convert.py:24-70`)."""
    if not len(stream):
        raise ValueError("empty stream")
    starttime = min(tr.stats.starttime.timestamp for tr in stream)
    endtime = max(tr.stats.endtime.timestamp for tr in stream)
    sr = stream[0].stats.sampling_rate
    samples = int((endtime - starttime) * sr) + 1
    data = np.zeros((len(component_order), samples), dtype=np.float64)
    completeness = 0.0
    for ci, c in enumerate(component_order):
        c_stream = stream.select(channel=f"*{c}")
        traces = sorted(c_stream, key=lambda t: t.stats.npts)
        c_complete = 0.0
        for tr in traces:
            start = int((tr.stats.starttime.timestamp - starttime) * sr)
            n = min(len(tr.data), samples - start)
            if n > 0:
                data[ci, start : start + n] = tr.data[:n]
                c_complete += n
        completeness += min(1.0, c_complete / samples)
    data -= data.mean(axis=1, keepdims=True)
    return UTC(starttime), data, completeness / len(component_order)


def _frequency_index_numpy(
    data: np.ndarray, dt: float, low=(1.0, 5.0), high=(10.0, 15.0)
) -> float:
    """FI = log10(mean|A| in high band / mean|A| in low band), Hann-windowed
    FFT (reference `volpick/data/utils.py:27-42`)."""
    n = len(data)
    if n < 8:
        return float("nan")
    hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / (n - 1)))
    spec = np.abs(np.fft.rfft(data * hann))[: n // 2]
    freq = np.fft.rfftfreq(n, dt)[: n // 2]
    hi = (freq > high[0]) & (freq < high[1])
    lo = (freq > low[0]) & (freq < low[1])
    if not hi.any() or not lo.any():
        return float("nan")
    return float(np.log10(np.mean(spec[hi]) / np.mean(spec[lo])))


def _snr_db_numpy(data: np.ndarray, p_sample, s_sample, winlen: int):
    """Per-component 95th-percentile SNR (reference `utils.py:45-102`)."""
    n = data.shape[-1]
    if p_sample is None or (isinstance(p_sample, float) and np.isnan(p_sample)) or p_sample < 10:
        return [float("nan")] * data.shape[0], float("nan")
    p = int(p_sample)
    use_s = s_sample is not None and not np.isnan(float(s_sample)) and s_sample < n - 10
    sig_start = int(s_sample) if use_s else p
    if p > n or sig_start >= n or sig_start < 0:  # picks outside the trace
        return [float("nan")] * data.shape[0], float("nan")
    snrs = []
    for comp in data:
        noi_seg = np.abs(comp[max(0, p - winlen) : p])
        sig_seg = np.abs(comp[sig_start : min(sig_start + winlen, n)])
        if not len(noi_seg) or not len(sig_seg):
            snrs.append(float("nan"))
            continue
        noi = np.percentile(noi_seg, 95)
        sig = np.percentile(sig_seg, 95)
        if np.isclose(noi, 0) or np.isclose(sig, 0):
            snrs.append(float("nan"))
        else:
            snrs.append(float(20 * np.log10(sig / noi)))
    mean = float(np.nanmean(snrs)) if not np.all(np.isnan(snrs)) else float("nan")
    return snrs, mean


def _split_state(seed: Optional[int]):
    """What the split column is drawn from: a RandomState of its own with a
    seed, else numpy's global state."""
    return np.random.RandomState(seed) if seed is not None else np.random


def trace_has_spikes(data: np.ndarray, factor: float = 25.0, quantile: float = 0.975) -> bool:
    """Spike heuristic: any sample exceeding factor × the per-channel
    |amplitude| quantile (semantics of seisbench.util.trace_ops used by the
    reference's converter, `convert.py:206-208`)."""
    q = np.quantile(np.abs(data), quantile, axis=-1, keepdims=True)
    return bool(np.any(np.abs(data) > factor * q))


def convert_catalog_to_dataset(
    catalog_table: pd.DataFrame,
    loader: Callable[[str], Stream],
    dest_dir: Union[str, Path],
    split_prob: Sequence[float] = (0.75, 0.1, 0.15),
    chunk: str = "",
    sampling_rate: float = 100.0,
    check_long_traces: bool = False,
    check_long_traces_limit: float = 150.0,
    skip_spikes: bool = False,
    cut_bounds: Optional[float] = None,
    n_limit: Optional[int] = None,
    seed: Optional[int] = None,
) -> Path:
    """Catalog rows + waveform loader → `metadata{chunk}.csv` + `waveforms{chunk}.hdf5`."""
    import pandas as pd

    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    draw = _split_state(seed)
    metadata_path = dest_dir / f"metadata{chunk}.csv"
    waveforms_path = dest_dir / f"waveforms{chunk}.hdf5"

    event_cols = [
        "source_id",
        "source_origin_time",
        "source_latitude_deg",
        "source_longitude_deg",
        "source_depth_km",
        "source_magnitude",
        "source_magnitude_type",
        "source_type",
    ]
    trace_cols = [
        "station_network_code",
        "station_code",
        "station_location_code",
        "trace_channel",
        "station_latitude_deg",
        "station_longitude_deg",
        "station_elevation_m",
        "station_epicentral_distance_m",
        "path_azimuth_deg",
        "path_back_azimuth_deg",
        "trace_p_arrival_time",
        "trace_s_arrival_time",
        "trace_p_max_weight",
        "trace_s_max_weight",
        "trace_p_first_motion",
        "trace_name",
    ]

    n_written = 0
    with WaveformDataWriter(metadata_path, waveforms_path) as writer:
        writer.data_format = {
            "dimension_order": "CW",
            "component_order": "ZNE",
            "unit": "counts",
            "instrument_response": "not restituted",
        }
        for row in catalog_table.itertuples():
            params = {}
            for col in event_cols + trace_cols:
                params[col] = getattr(row, col, None)
            try:
                stream = loader(params["trace_name"])
            except Exception as e:
                logger.warning(f"loader failed for {params['trace_name']}: {e}")
                continue
            if not len(stream):
                continue
            for tr in stream:
                if abs(tr.stats.sampling_rate - sampling_rate) > 1e-6:
                    tr.resample(sampling_rate)
                tr.detrend_demean()
            params["trace_sampling_rate_hz"] = sampling_rate

            t0 = min(tr.stats.starttime for tr in stream)
            t1 = max(tr.stats.endtime for tr in stream)
            if isinstance(cut_bounds, (int, float)) and (t1 - t0) > (3 * cut_bounds + 60):
                stream = Stream([tr.slice(t0 + cut_bounds, t1 - cut_bounds) for tr in stream])
                t0 = min(tr.stats.starttime for tr in stream)
                t1 = max(tr.stats.endtime for tr in stream)
            if check_long_traces and (t1 - t0) > check_long_traces_limit:
                arr_times = [
                    UTC(params[k])
                    for k in ("trace_p_arrival_time", "trace_s_arrival_time")
                    if params[k] is not None and not pd.isna(params[k])
                ]
                if arr_times:
                    lo = max(min(arr_times) - check_long_traces_limit / 2, t0)
                    hi = min(max(arr_times) + check_long_traces_limit / 2, t1)
                    stream = Stream([tr.slice(lo, hi) for tr in stream])

            actual_t0, data, completeness = stream_to_array(stream, "ZNE")
            params["trace_completeness"] = completeness
            params["trace_has_spikes"] = trace_has_spikes(data)
            if skip_spikes and params["trace_has_spikes"]:
                continue
            params["trace_start_time"] = actual_t0.isoformat()
            for phase in ("p", "s"):
                at = params.get(f"trace_{phase}_arrival_time")
                if at is not None and not pd.isna(at):
                    sample = (UTC(at) - actual_t0) * sampling_rate
                    params[f"trace_{phase}_arrival_sample"] = int(sample)
                    params[f"trace_{phase}_status"] = "None"
                else:
                    params[f"trace_{phase}_arrival_sample"] = None
                    params[f"trace_{phase}_status"] = None

            # host-side numpy SNR/FI (this is ingest code — it must never
            # touch an accelerator; the device versions live in ops.features)
            snrs, avg = _snr_db_numpy(
                data,
                params["trace_p_arrival_sample"],
                params["trace_s_arrival_sample"],
                int(5 * sampling_rate),
            )
            params["trace_snr_db"] = snrs
            params["trace_mean_snr_db"] = avg

            # frequency index around the reference pick (1 s before, 6 s after)
            ref = params["trace_p_arrival_sample"] or params["trace_s_arrival_sample"]
            fi = np.nan
            if ref:
                ref = int(ref)
                lo = max(ref - int(1 * sampling_rate), 0)
                hi = min(ref + int(6 * sampling_rate), data.shape[-1])
                fis = []
                for comp in data:
                    if np.sum(np.abs(np.diff(comp))) > 1e-9:
                        v = _frequency_index_numpy(comp[lo:hi], 1.0 / sampling_rate)
                        if not np.isnan(v):
                            fis.append(v)
                if fis:
                    fi = float(np.mean(fis))
            params["trace_frequency_index"] = fi
            params["split"] = draw.choice(["train", "dev", "test"], p=list(split_prob))
            writer.add_trace(params, data.astype(np.float32))
            n_written += 1
            if n_limit is not None and n_written >= n_limit:
                break

    # per-source frequency index pass (reference `convert.py:281-298`)
    md = pd.read_csv(metadata_path)
    if len(md) and np.all(
        pd.notna(md.get("trace_p_arrival_sample")) | pd.notna(md.get("trace_s_arrival_sample"))
    ):
        fi_by_source = md.groupby("source_id")["trace_frequency_index"].mean()
        md["source_frequency_index"] = md["source_id"].map(fi_by_source)
    else:
        md["source_frequency_index"] = np.nan
    md.to_csv(metadata_path, index=False)
    return dest_dir


def extract_noise_from_dataset(
    source_dataset,
    dest_dir: Union[str, Path],
    n_traces: int = 1000,
    chunk: str = "_noise",
    split_prob: Sequence[float] = (0.75, 0.1, 0.15),
    seed: int = 42,
) -> Path:
    """Pull noise traces from another dataset into a local chunk (the
    STEAD-noise extraction path, reference `convert.py:461-547`)."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    md = source_dataset.metadata
    from volpick_tpu_torch.pipeline.generator import _onset_arrays

    p, s = _onset_arrays(md)
    noise_idx = np.where(np.isnan(p) & np.isnan(s))[0]
    if "source_type" in md.columns:
        noise_idx = np.union1d(
            noise_idx, np.where(md["source_type"].astype(str).str.lower() == "noise")[0]
        )
    rng.shuffle(noise_idx)
    noise_idx = noise_idx[:n_traces]
    with WaveformDataWriter(
        dest_dir / f"metadata{chunk}.csv", dest_dir / f"waveforms{chunk}.hdf5"
    ) as writer:
        writer.data_format = {"dimension_order": "CW", "component_order": "ZNE"}
        for i in noise_idx:
            data, meta = source_dataset.get_sample(int(i))
            row = {
                "source_type": "noise",
                "trace_name": f"noise_{meta.get('trace_name', i)}",
                "trace_sampling_rate_hz": source_dataset.sampling_rate,
                "station_network_code": meta.get("station_network_code"),
                "station_code": meta.get("station_code"),
                "trace_p_arrival_sample": None,
                "trace_s_arrival_sample": None,
                "split": np.random.RandomState(seed + int(i)).choice(
                    ["train", "dev", "test"], p=list(split_prob)
                ),
            }
            writer.add_trace(row, data)
    from volpick_tpu_torch.data.assemble import generate_chunk_file

    generate_chunk_file(dest_dir)
    return dest_dir


def convert_from_old_format(
    src_dir,
    dest_dir,
    bucket_size: int = 1024,
    split_prob: Sequence[float] = (0.7, 0.1, 0.2),
    loader: Optional[Callable] = None,
    seed: Optional[int] = None,
):
    """Per-event-folder archive → SeisBench dataset (reference
    `volpick/data/convert.py:306-458`).

    Each event directory under `src_dir` holds `event_info.csv` (origin
    time/lat/lon/depth/magnitude/event_type), `picks.csv` (index = waveform
    file name; network/station/instrument/latitude/longitude/elevation_m/
    p_time/s_time/first_motion columns), mseed waveforms and StationXML
    sidecars (`<name>.xml`). Per trace: ZNE rotation from the inventory
    orientations, resample check to 100 Hz, spike flag, arrival-sample
    conversion (status "USGS"), per-trace frequency index over
    [P−1 s, P+6 s], random split, and a final per-source FI pass — same
    metadata contract as convert_catalog_to_dataset. `loader` defaults to
    the native miniSEED reader; injectable for tests.
    """
    import pandas as pd
    from volpick_tpu_torch.core.geo import gps2dist_azimuth
    from volpick_tpu_torch.core.rotate import rotate_to_zne
    from volpick_tpu_torch.io.stationxml import channel_orientations, read_stationxml

    if loader is None:
        from volpick_tpu_torch.io.miniseed import read_mseed as loader

    src_dir = Path(src_dir)
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    draw = _split_state(seed)
    sampling_rate = 100.0

    metadata_path = dest_dir / "metadata.csv"
    waveforms_path = dest_dir / "waveforms.hdf5"
    with WaveformDataWriter(metadata_path, waveforms_path) as writer:
        writer.data_format = {
            "dimension_order": "CW",
            "component_order": "ZNE",
            "unit": "counts",
            "instrument_response": "not restituted",
        }
        writer.bucket_size = bucket_size
        for event_dir in sorted(x for x in src_dir.iterdir() if x.is_dir()):
            info = pd.read_csv(event_dir / "event_info.csv", index_col=0).iloc[0]
            event_params = {
                "source_id": info["event_id"],
                "source_origin_time": info["origin_time"],
                "source_latitude_deg": info["hypo_lat"],
                "source_longitude_deg": info["hypo_lon"],
                "source_depth_km": info["hypo_depth"],
                "source_magnitude": info["magnitude"],
                "source_type": info["event_type"],
            }
            picks = pd.read_csv(event_dir / "picks.csv", index_col=0)
            for fname, pick in picks.iterrows():
                lat, lon = pick["latitude"], pick["longitude"]
                if not np.isnan(lat * lon):
                    back_azimuth = gps2dist_azimuth(
                        event_params["source_latitude_deg"],
                        event_params["source_longitude_deg"],
                        lat, lon,
                    )[2]
                else:
                    back_azimuth = np.nan
                trace_params = {
                    "station_network_code": pick["network"],
                    "station_code": pick["station"],
                    "trace_channel": pick["instrument"],
                    "station_location_code": None,
                    "station_latitude_deg": lat,
                    "station_longitude_deg": lon,
                    "station_elevation_m": pick.get("elevation_m"),
                    "path_back_azimuth_deg": back_azimuth,
                }
                try:
                    stream = loader(event_dir / fname)
                except Exception as e:
                    logger.warning(f"loader failed for {event_dir / fname}: {e}")
                    continue
                xml = event_dir / str(fname).replace("mseed", "xml")
                if xml.exists() and len(stream) == 3:
                    inv = read_stationxml(xml)
                    ori = channel_orientations(
                        inv, str(pick["network"]), str(pick["station"])
                    )
                    try:
                        stream = rotate_to_zne(stream, ori)
                    except (KeyError, ValueError) as e:
                        logger.warning(f"rotation failed for {fname}: {e}")
                if any(abs(tr.stats.sampling_rate - sampling_rate) > 1e-6 for tr in stream):
                    logger.warning(
                        f"inconsistent sampling rates in {event_dir.name}/{fname}; resampling"
                    )
                    for tr in stream:
                        tr.resample(sampling_rate)
                trace_params["trace_sampling_rate_hz"] = sampling_rate
                sid = event_params["source_id"]
                first = stream[0]
                trace_params["trace_name"] = (
                    f"{sid}_{first.stats.network}.{first.stats.station}."
                    f"{first.stats.location}"
                )
                t_start, data, _ = stream_to_array(stream, "ZNE")
                trace_params["trace_has_spikes"] = trace_has_spikes(data)
                trace_params["trace_start_time"] = t_start.isoformat()
                for ph in ("p", "s"):
                    v = pick.get(f"{ph}_time")
                    if v is not None and not pd.isna(v):
                        sample = (UTC(v).timestamp - t_start.timestamp) * sampling_rate
                        trace_params[f"trace_{ph}_arrival_sample"] = int(sample)
                        trace_params[f"trace_{ph}_status"] = "USGS"
                    else:
                        trace_params[f"trace_{ph}_arrival_sample"] = None
                        trace_params[f"trace_{ph}_status"] = None
                trace_params["trace_p_first_motion"] = pick.get("first_motion")

                # per-trace FI over [P-1 s, P+6 s] (S fallback), mean over
                # non-flat components (`convert.py:419-440`)
                ref = trace_params["trace_p_arrival_sample"] or trace_params[
                    "trace_s_arrival_sample"
                ]
                fis = []
                if ref:
                    lo = max(int(ref - sampling_rate), 0)
                    hi = int(ref + 6 * sampling_rate)
                    for comp in data:
                        if np.sum(np.abs(np.diff(comp))) > 1e-9:
                            fi = _frequency_index_numpy(comp[lo:hi], 1.0 / sampling_rate)
                            if not np.isnan(fi):
                                fis.append(fi)
                trace_params["trace_frequency_index"] = float(np.mean(fis)) if fis else np.nan
                trace_params["split"] = draw.choice(
                    ["train", "dev", "test"], p=list(split_prob)
                )
                writer.add_trace({**event_params, **trace_params}, data)

    # per-source frequency index pass (`convert.py:448-458`)
    metadata = pd.read_csv(metadata_path)
    fi_by_source = metadata.groupby("source_id")["trace_frequency_index"].mean()
    metadata["source_frequency_index"] = metadata["source_id"].map(fi_by_source)
    metadata.to_csv(metadata_path, index=False)
    return dest_dir
