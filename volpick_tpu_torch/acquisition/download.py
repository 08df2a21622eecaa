"""Waveform acquisition: noise-window tables + parallel FDSN downloads.

The pure logic (noise-window selection from inter-event gaps, retry
filtering, per-process log merging) is implemented obspy-free; the actual
network download path requires obspy's FDSN client and raises a clear error
when obspy is unavailable.
Reference behaviors: `volpick/data/data.py:1782-1874` (noise table),
`:2791-2825` (retry with error-class exclusion), `:2827-2934` (parallel
download with per-process CSV logs).

Port of ``volpick_tpu/acquisition/download.py`` (a copy). The worker keeps its
injectable ``client_factory``, ``stream_writer`` and ``time_cls``; the live
FDSN path needs obspy, which the port does not require.
"""

from __future__ import annotations

import multiprocessing as mp
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from volpick_tpu_torch.core.stream import UTC


def conservative_event_end(row) -> float:
    """End-of-event heuristic (reference `data.py:1808-1823`): P + 5·(S−P) + 60 s
    when both picks exist in order, else origin/P + 600 s. Returns epoch s."""
    import pandas as pd

    p = row.get("trace_p_arrival_time")
    s = row.get("trace_s_arrival_time")
    o = row.get("source_origin_time")
    p_t = UTC(p).timestamp if pd.notna(p) else None
    s_t = UTC(s).timestamp if pd.notna(s) else None
    o_t = UTC(o).timestamp if pd.notna(o) else None
    if p_t is not None and s_t is not None:
        if p_t < s_t:
            return p_t + (s_t - p_t) * 5 + 60
        return (o_t or p_t) + 600
    if p_t is not None:
        return p_t + 600
    return (o_t or 0.0) + 600


def create_noise_table(
    base_catalog: pd.DataFrame,
    number_stations: int = 200,
    time_difference_limit: float = 3600 * 24,
    number_records_each_station: int = 500,
    seed: int = 100,
) -> pd.DataFrame:
    """Quiet windows per station: sorts each station's events by origin time,
    keeps rows whose gap to the next event exceeds `time_difference_limit`,
    largest gaps first (reference `data.py:1782-1874`)."""
    import pandas as pd

    key_cols = ["station_network_code", "station_code", "station_location_code", "trace_channel"]
    cat = base_catalog.copy()
    cat["_station"] = cat[key_cols].astype(str).agg(".".join, axis=1)
    stations = np.unique(cat["_station"])
    rng = np.random.RandomState(seed)
    if len(stations) > number_stations:
        rng.shuffle(stations)
        stations = stations[:number_stations]

    subcatalogs = []
    for station in stations:
        sub = cat[cat["_station"] == station].copy()
        sub["_origin_ts"] = sub["source_origin_time"].map(
            lambda x: UTC(x).timestamp if pd.notna(x) else np.nan
        )
        sub.sort_values("_origin_ts", inplace=True)
        sub["event_end"] = sub.apply(conservative_event_end, axis=1)
        nxt = np.append(sub["_origin_ts"].to_numpy()[1:], np.nan)
        sub["forward_event_time_difference"] = nxt - sub["event_end"].to_numpy()
        sub["next_event_origin_time"] = nxt
        sub = sub[
            pd.notna(sub["forward_event_time_difference"])
            & (sub["forward_event_time_difference"] > time_difference_limit)
        ]
        sub.sort_values("forward_event_time_difference", ascending=False, inplace=True)
        subcatalogs.append(sub.iloc[:number_records_each_station])
    if not subcatalogs:
        return pd.DataFrame()
    out = pd.concat(subcatalogs, ignore_index=True)
    return out.drop(columns=["_station", "_origin_ts"])


def filter_failed_downloads(
    log_df: pd.DataFrame,
    exclude_errors: Sequence[str] = ("FDSNNoDataException",),
    error_col: str = "error",
) -> pd.DataFrame:
    """Rows worth retrying: failures whose recorded exception class is not in
    the permanent-failure exclusion list (reference `data.py:2791-2825`)."""
    mask = ~log_df[error_col].astype(str).str.strip().isin(list(exclude_errors) + ["", "nan", "None"])
    return log_df[mask]


def assemble_subprocess_csvlogs(
    log_dir: Union[str, Path], pattern: str, merged_name: str, delete: bool = True
) -> Optional[pd.DataFrame]:
    """Merge per-process CSV logs written by download workers
    (reference `data.py:2918-2934`)."""
    import pandas as pd

    log_dir = Path(log_dir)
    parts = sorted(log_dir.glob(pattern))
    if not parts:
        return None
    frames = [pd.read_csv(p) for p in parts]
    merged = pd.concat(frames, ignore_index=True)
    merged.to_csv(log_dir / merged_name, index=False)
    if delete:
        for p in parts:
            p.unlink()
    return merged


def _chunk_indices(n: int, num_processes: int) -> List[np.ndarray]:
    return [c for c in np.array_split(np.arange(n), num_processes) if len(c)]


def download_waveforms_fdsn(
    catalog_table: pd.DataFrame,
    save_dir: Union[str, Path],
    providers: Sequence[str] = ("IRIS",),
    time_window: float = 120.0,
    sampling_rate: Optional[float] = None,
    num_processes: int = 1,
):
    """Parallel FDSN event-waveform download (requires obspy + network).

    Spawns `num_processes` workers over catalog chunks; each worker fetches
    [first pick − time_window/3, + time_window] per trace row, rotates to ZNE,
    optionally resamples, writes mseed + a per-process CSV log; logs are
    merged afterwards. QC: skips rows with P after S or P before origin."""
    try:
        import obspy  # noqa: F401
        from obspy.clients.fdsn import Client  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "download_waveforms_fdsn requires obspy (not installed in this "
            "environment); use convert_catalog_to_dataset with a local loader instead"
        ) from e

    save_dir = Path(save_dir)
    (save_dir / "mseed").mkdir(parents=True, exist_ok=True)
    chunks = _chunk_indices(len(catalog_table), num_processes)
    ctx = mp.get_context("spawn")
    procs = []
    for pid, idx in enumerate(chunks):
        p = ctx.Process(
            target=_download_worker,
            args=(catalog_table.iloc[idx], str(save_dir), list(providers), time_window, sampling_rate, pid),
        )
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
    return assemble_subprocess_csvlogs(save_dir, "download_log_p*.csv", "download_log.csv")


def _phase_in_gap(stream, arrivals) -> bool:
    """True when any arrival lies outside EVERY trace's [start, end] span
    (reference `data.py:3184-3206`: picks landing in a data gap disqualify
    the whole trace row). Duck-typed so fake streams work in tests."""
    for ts in arrivals:
        out_of_all = True
        for tr in stream:
            t0 = float(getattr(tr.stats.starttime, "timestamp", tr.stats.starttime))
            t1 = float(getattr(tr.stats.endtime, "timestamp", tr.stats.endtime))
            if t0 <= ts <= t1:
                out_of_all = False
                break
        if out_of_all:
            return True
    return False


def _download_worker(
    table,
    save_dir,
    providers,
    time_window,
    sampling_rate,
    pid,
    client_factory=None,
    stream_writer=None,
    time_cls=None,
):
    """One worker process of download_waveforms_fdsn.

    `client_factory(provider) -> client`, `stream_writer(stream, path)` and
    `time_cls` (constructor for the client's time arguments) default to the
    obspy implementations; tests inject fakes to exercise the QC branches
    without obspy or network (reference worker: `data.py:2936-3272`).
    """
    import pandas as pd

    if client_factory is None:
        from obspy.clients.fdsn import Client as client_factory  # noqa: N813
    if time_cls is None:
        try:
            from obspy import UTCDateTime as time_cls  # noqa: N813
        except ImportError:
            time_cls = float
    if stream_writer is None:
        def stream_writer(st, fname):
            st.write(str(fname), format="MSEED")

    save_dir = Path(save_dir)
    clients = [client_factory(p) for p in providers]
    rows = []
    for row in table.itertuples():
        entry = {"trace_name": getattr(row, "trace_name", ""), "error": ""}
        try:
            p_t = getattr(row, "trace_p_arrival_time", None)
            s_t = getattr(row, "trace_s_arrival_time", None)
            o_t = getattr(row, "source_origin_time", None)
            first = min([UTC(t).timestamp for t in (p_t, s_t) if pd.notna(t)])
            # QC (reference `data.py:3103-3136`)
            if pd.notna(p_t) and pd.notna(s_t) and UTC(p_t) > UTC(s_t):
                entry["error"] = "P_after_S"
                rows.append(entry)
                continue
            if pd.notna(p_t) and pd.notna(o_t) and UTC(p_t) < UTC(o_t):
                entry["error"] = "P_before_origin"
                rows.append(entry)
                continue
            t0 = time_cls(first - time_window / 3.0)
            t1 = time_cls(first + time_window)
            st = None
            for client in clients:
                try:
                    st = client.get_waveforms(
                        network=row.station_network_code,
                        station=row.station_code,
                        location="*",
                        channel=f"{row.trace_channel}?",
                        starttime=t0,
                        endtime=t1,
                    )
                    break
                except Exception as e:  # try next provider
                    entry["error"] = type(e).__name__
            if st is None or not len(st):
                rows.append(entry)
                continue
            # picks landing in a data gap disqualify the row
            arrivals = [UTC(t).timestamp for t in (p_t, s_t) if pd.notna(t)]
            if _phase_in_gap(st, arrivals):
                entry["error"] = "phases_in_gap"
                rows.append(entry)
                continue
            if sampling_rate:
                st.resample(sampling_rate)
            fname = save_dir / "mseed" / f"{row.trace_name}.mseed"
            stream_writer(st, fname)
            entry["error"] = ""
            rows.append(entry)
        except Exception as e:
            entry["error"] = type(e).__name__
            rows.append(entry)
    pd.DataFrame(rows).to_csv(Path(save_dir) / f"download_log_p{pid}.csv", index=False)
