"""NIED Hi-net acquisition (the reference's Japan data path).

The reference downloads Hi-net event waveforms with a patched HinetPy client
and shells out to NIED's win32tools for win32 → SAC → mseed conversion
(`volpick/data/data.py:75-175, 897-1388`). Here the conversion leg is fully
native — `convert_win32_event_dirs` decodes win32 archives with the built-in
C++ decoder (`volpick_tpu_torch.io.win32`) and writes per-trace mseed directly, so
the JapanDataset-equivalent path (JMA catalog → win32 archives → mseed →
SeisBench dataset) runs end-to-end without external tooling. The
authenticated event-waveform download loop is native too —
`volpick_tpu_torch.acquisition.hinet_net` implements the reference's
HinetClient2.get_event_waveform orchestration (`data.py:75-175`) over a
stdlib-urllib wire (fake-wire tested offline; live NIED credentials are the
only environmental dependency). `HinetDownloader` below remains the
HinetPy-backed continuous-waveform driver for deployments that have it.

JMA catalog parsing is native too (`volpick_tpu_torch.acquisition.jma`).

Port of ``volpick_tpu/acquisition/hinet.py`` (a copy over the port's
``io/win32.py`` and ``io/miniseed.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from volpick_tpu_torch.core.stream import Stream, UTC


@dataclass
class HinetRequest:
    """One win32 request window for an event."""

    event_id: str
    starttime: UTC
    span_minutes: int


def event_request_windows(
    catalog_df: pd.DataFrame,
    pre_event_s: float = 60.0,
    post_event_s: float = 120.0,
    max_span_minutes: int = 5,
) -> List[HinetRequest]:
    """Per-event request windows: [first pick − pre, last pick + post],
    split into ≤max_span_minutes chunks (the Hi-net API limit)."""
    out: List[HinetRequest] = []
    for sid, grp in catalog_df.groupby("source_id"):
        times = []
        for col in ("trace_p_arrival_time", "trace_s_arrival_time", "source_origin_time"):
            if col in grp.columns:
                times.extend(UTC(v).timestamp for v in grp[col].dropna())
        if not times:
            continue
        t0 = min(times) - pre_event_s
        t1 = max(times) + post_event_s
        total_min = max(int(math.ceil((t1 - t0) / 60.0)), 1)
        pos = t0
        while total_min > 0:
            span = min(total_min, max_span_minutes)
            out.append(HinetRequest(str(sid), UTC(pos), span))
            pos += span * 60
            total_min -= span
    return out


class HinetDownloader:
    """Thin driver over HinetPy's Client (win32 download + cnt→SAC)."""

    def __init__(self, user: str, password: str, save_dir):
        try:
            from HinetPy import Client  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "HinetDownloader requires HinetPy (not installed in this "
                "environment). Catalog parsing (acquisition.jma) and dataset "
                "conversion work without it."
            ) from e
        from HinetPy import Client

        self.client = Client(user, password)
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def download_and_convert(
        self,
        requests: Sequence[HinetRequest],
        catalog_df: pd.DataFrame,
        code: str = "0101",
        network: str = "N",
    ) -> pd.DataFrame:
        """Download win32 archives per event, then convert natively to
        per-trace mseed (the reference's download→win32tools→SAC→mseed
        pipeline, `data.py:897-1388`, collapsed to download→mseed)."""
        self.download(requests, code=code)
        return convert_win32_event_dirs(self.save_dir, catalog_df, network=network)

    def download(self, requests: Sequence[HinetRequest], code: str = "0101"):
        """Fetch win32 data + ch tables per request into save_dir/<event>/."""
        import pandas as pd

        logs = []
        for req in requests:
            out = self.save_dir / req.event_id
            out.mkdir(parents=True, exist_ok=True)
            entry = {"event": req.event_id, "start": req.starttime.isoformat(), "error": ""}
            try:
                self.client.get_continuous_waveform(
                    code, req.starttime.datetime.replace(tzinfo=None), req.span_minutes, outdir=str(out)
                )
            except Exception as e:
                entry["error"] = type(e).__name__
            logs.append(entry)
        df = pd.DataFrame(logs)
        df.to_csv(self.save_dir / "hinet_download_log.csv", index=False)
        return df


def convert_win32_event_dirs(
    save_dir,
    catalog_df: pd.DataFrame,
    network: str = "N",
    cut_pre_s: float = 60.0,
    cut_post_s: float = 120.0,
    component_rename: Optional[Dict[str, str]] = None,
) -> pd.DataFrame:
    """Native win32 → mseed conversion for downloaded Hi-net event directories.

    Expects `save_dir/<source_id>/` directories holding the win32 archives
    (`*.cnt`) and a channel table (`*.ch` / `*.euc.ch`) as produced by the
    Hi-net request API. For every catalog row whose station has data, the
    merged stream is trimmed to [first pick − cut_pre_s, last pick +
    cut_post_s] and written as ``save_dir/mseed/{trace_name}.mseed`` — the
    same on-disk contract as the FDSN downloader
    (`acquisition/download.py`), so `convert_catalog_to_dataset` consumes
    the result unchanged. Replaces the reference's win32tools/SAC round trip
    (`volpick/data/data.py:1014-1388`).

    Returns the per-trace log DataFrame (written to
    ``save_dir/win32_convert_log.csv``): trace_name, n_components, error.
    `component_rename` maps channel-table component names (e.g. "U", "N",
    "E") to output channel codes (default U→Z so ZNE selection works).
    """
    import pandas as pd
    from volpick_tpu_torch.io.miniseed import write_mseed
    from volpick_tpu_torch.io.win32 import read_win32, read_win32_channel_table

    save_dir = Path(save_dir)
    (save_dir / "mseed").mkdir(parents=True, exist_ok=True)
    rename = {"U": "Z"}
    rename.update(component_rename or {})

    # decode each event directory once, cache per event
    logs = []
    for source_id, grp in catalog_df.groupby("source_id"):
        ev_dir = save_dir / str(source_id)
        entry_base = {"source_id": str(source_id)}
        if not ev_dir.is_dir():
            for row in grp.itertuples():
                logs.append(dict(entry_base, trace_name=_trace_name(row, network),
                                 n_components=0, error="NoEventDirectory"))
            continue
        tables = sorted(ev_dir.glob("*.ch")) + sorted(ev_dir.glob("*.euc.ch"))
        table = read_win32_channel_table(tables[0]) if tables else None
        stream = Stream()
        for cnt in sorted(ev_dir.glob("*.cnt")):
            try:
                for tr in read_win32(cnt, channel_table=table, network=network):
                    stream.append(tr)
            except ValueError:
                continue
        stream.merge_overlaps()
        for row in grp.itertuples():
            name = _trace_name(row, network)
            entry = dict(entry_base, trace_name=name, n_components=0, error="")
            sta = str(getattr(row, "station_code", ""))
            sel = Stream([tr for tr in stream if tr.stats.station == sta])
            if not len(sel):
                entry["error"] = "NoStationData"
                logs.append(entry)
                continue
            times = []
            for col in ("trace_p_arrival_time", "trace_s_arrival_time"):
                v = getattr(row, col, None)
                if v is not None and not pd.isna(v):
                    times.append(UTC(v).timestamp)
            out = Stream()
            for tr in sel:
                tr = tr.copy()
                comp = tr.stats.channel
                tr.stats.channel = rename.get(comp, comp)
                if times:
                    tr = tr.slice(UTC(min(times) - cut_pre_s), UTC(max(times) + cut_post_s))
                if tr.stats.npts:
                    out.append(tr)
            if not len(out):
                entry["error"] = "EmptyAfterTrim"
                logs.append(entry)
                continue
            write_mseed(out, save_dir / "mseed" / f"{name}.mseed")
            entry["n_components"] = len(out)
            logs.append(entry)
    df = pd.DataFrame(logs)
    df.to_csv(save_dir / "win32_convert_log.csv", index=False)
    return df


def _trace_name(row, network: str) -> str:
    import pandas as pd

    name = getattr(row, "trace_name", None)
    if name is not None and not pd.isna(name):
        return str(name)
    return f"{row.source_id}_{network}.{getattr(row, 'station_code', '')}"
