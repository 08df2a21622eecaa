"""WIN32 (NIED Hi-net) waveform I/O via the native C++ decoder.

The reference's Japan pipeline is JMA catalog → Hi-net win32 download →
win32tools conversion → SAC → mseed (reference `volpick/data/data.py:897-1388`).
Here the win32 leg is native: `read_win32` decodes archives straight into
Streams (no NIED tooling), `read_win32_channel_table` parses the Hi-net
channel-table (.ch/.euc) metadata that names each channel, and `write_win32`
is a symmetric encoder used for round-trip tests and fixtures.

Channel data stays in counts (the converter downstream demeans/normalizes);
the channel table's LSB/sensitivity/gain columns are exposed as a `scale`
(counts → physical units) for callers that need it.

Port of ``volpick_tpu/io/win32.py``: the decoder ``native/win32.cpp`` is built
with g++ on first use into ``build/volpick_tpu_torch/`` (``io/_native.py``);
pandas is imported by the channel-table reader only.
"""

from __future__ import annotations

import ctypes
import math
import struct
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from volpick_tpu_torch.core.stream import Stream, Trace, UTC
from volpick_tpu_torch.io import _native

_LIB = None


class _SecondInfo(ctypes.Structure):
    _fields_ = [
        ("org_id", ctypes.c_uint16),
        ("chan_id", ctypes.c_uint16),
        ("n_samples", ctypes.c_int32),
        ("starttime", ctypes.c_double),
        ("offset", ctypes.c_int64),
    ]


def _get_lib():
    global _LIB
    if _LIB is None:
        lib = _native.library("win32")
        lib.win32_scan.restype = ctypes.c_int
        lib.win32_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.win32_decode.restype = ctypes.c_int64
        lib.win32_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.POINTER(_SecondInfo),
        ]
        _LIB = lib
    return _LIB


# --------------------------------------------------------------- channel table
def read_win32_channel_table(path: Union[str, Path]):
    """Parse a Hi-net channel table (.ch / *.euc.ch).

    NIED's table is whitespace-separated with '#' comments; the columns used
    here (fixed positions in the published format): 0 channel id (hex),
    3 station code, 4 component, 7 sensitivity, 11 gain (dB), 12 LSB value
    (V/count). Returns a DataFrame indexed by integer channel id with
    station/component/scale columns; rows that fail to parse are skipped.
    """
    import pandas as pd

    rows = []
    for line in Path(path).read_text(errors="replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        f = line.split()
        if len(f) < 5:
            continue
        try:
            chan = int(f[0], 16)
        except ValueError:
            continue
        station = f[3]
        component = f[4]
        sensitivity = gain_db = lsb = None
        try:
            sensitivity = float(f[7])
            gain_db = float(f[11])
            lsb = float(f[12])
        except (IndexError, ValueError):
            pass
        scale = None
        if sensitivity and lsb is not None and gain_db is not None:
            # counts → physical units: LSB volts / (sensitivity · 10^(gain/20))
            scale = lsb / (sensitivity * (10.0 ** (gain_db / 20.0)))
        rows.append(
            dict(chan_id=chan, station=station, component=component,
                 sensitivity=sensitivity, gain_db=gain_db, lsb=lsb, scale=scale)
        )
    df = pd.DataFrame(rows)
    if len(df):
        df = df.set_index("chan_id")
    return df


# --------------------------------------------------------------------- reading
def read_win32(
    path: Union[str, Path],
    channel_table=None,
    network: str = "N",
    merge: bool = True,
) -> Stream:
    """Decode a WIN32 archive into a Stream (native decoder, no win32tools).

    Channel-seconds with the same channel id are merged into continuous
    Traces across block boundaries. With a `channel_table`
    (read_win32_channel_table), traces get real station/component codes;
    otherwise the channel id is used ("C0123"/"CH").
    """
    lib = _get_lib()
    buf = Path(path).read_bytes()
    n_cs = ctypes.c_int64(0)
    total = ctypes.c_int64(0)
    rc = lib.win32_scan(buf, len(buf), ctypes.byref(n_cs), ctypes.byref(total))
    if rc != 0 or n_cs.value == 0:
        raise ValueError(f"{path}: not a readable WIN32 file")
    samples = np.zeros(total.value, dtype=np.float64)
    infos = (_SecondInfo * n_cs.value)()
    ndec = lib.win32_decode(buf, len(buf), samples, infos)

    # group channel-seconds per channel, ordered by time
    per_chan: Dict[int, list] = {}
    for i in range(ndec):
        info = infos[i]
        per_chan.setdefault(int(info.chan_id), []).append(
            (info.starttime, int(info.offset), int(info.n_samples))
        )

    st = Stream()
    for chan, secs in per_chan.items():
        secs.sort()
        if channel_table is not None and chan in channel_table.index:
            row = channel_table.loc[chan]
            station, component = str(row["station"]), str(row["component"])
        else:
            station, component = f"C{chan:04X}", "CH"
        for t0, off, n in secs:
            st.append(
                Trace(
                    samples[off : off + n].copy(),
                    dict(
                        network=network,
                        station=station,
                        location="",
                        channel=component,
                        sampling_rate=float(n),  # n samples per 1-s block
                        starttime=UTC(t0),
                    ),
                )
            )
    if merge:
        st.merge_overlaps()
    return st


# --------------------------------------------------------------------- writing
def _bcd_time(t: UTC) -> bytes:
    d = t.datetime
    s = f"{d.year:04d}{d.month:02d}{d.day:02d}{d.hour:02d}{d.minute:02d}{d.second:02d}00"
    return bytes((int(s[i]) << 4) | int(s[i + 1]) for i in range(0, 16, 2))


def _pack_diffs(diffs: np.ndarray) -> tuple:
    """Choose the smallest WIN32 size code holding all diffs, pack them."""
    if len(diffs) == 0:
        return 4, b""
    lo, hi = int(diffs.min()), int(diffs.max())
    if -8 <= lo and hi <= 7:
        code = 0
        out = bytearray((len(diffs) + 1) // 2)
        for i, d in enumerate(diffs):
            nib = int(d) & 0x0F
            if i % 2 == 0:
                out[i // 2] |= nib << 4
            else:
                out[i // 2] |= nib
        return code, bytes(out)
    if -(2**7) <= lo and hi < 2**7:
        return 1, struct.pack(f">{len(diffs)}b", *diffs.tolist())
    if -(2**15) <= lo and hi < 2**15:
        return 2, struct.pack(f">{len(diffs)}h", *diffs.tolist())
    if -(2**23) <= lo and hi < 2**23:
        out = bytearray()
        for d in diffs.tolist():
            out += int(d & 0xFFFFFF).to_bytes(3, "big")
        return 3, bytes(out)
    return 4, struct.pack(f">{len(diffs)}i", *diffs.tolist())


def write_win32(
    stream: Stream,
    path: Union[str, Path],
    chan_ids: Optional[Dict[str, int]] = None,
    org_id: int = 1,
):
    """Encode integer-valued Traces as a WIN32 archive (1-second blocks).

    Traces must have integer sampling rates ≤ 4095 Hz and second-aligned
    start times; data is rounded to int32 counts. `chan_ids` maps trace ids
    to channel numbers (auto-assigned 0x100, 0x101, ... otherwise).
    """
    chan_ids = dict(chan_ids or {})
    next_id = 0x100
    # (epoch second) → list of packed channel blocks
    blocks: Dict[int, list] = {}
    for tr in stream:
        sr = tr.stats.sampling_rate
        if abs(sr - round(sr)) > 1e-9 or not (1 <= sr <= 4095):
            raise ValueError(f"win32 needs integer 1..4095 Hz rates, got {sr}")
        n = int(round(sr))
        t0 = tr.stats.starttime.timestamp
        if abs(t0 - round(t0)) > 1e-6:
            raise ValueError("win32 traces must start on a whole second")
        if tr.id not in chan_ids:
            chan_ids[tr.id] = next_id
            next_id += 1
        chan = chan_ids[tr.id]
        data = np.round(np.asarray(tr.data, dtype=np.float64)).astype(np.int64)
        # WIN32 carries int32 counts; silently wrapping would corrupt the
        # decoded samples by multiples of 2^32
        if len(data) and (data.max() >= 2**31 or data.min() < -(2**31)):
            raise ValueError(
                f"{tr.id}: samples exceed the WIN32 int32 count range "
                f"(min {data.min()}, max {data.max()})"
            )
        n_sec = int(math.ceil(len(data) / n))
        for s in range(n_sec):
            seg = data[s * n : (s + 1) * n]
            if len(seg) < n:  # zero-pad the final partial second
                seg = np.concatenate([seg, np.zeros(n - len(seg), dtype=np.int64)])
            diffs = np.diff(seg)
            code, packed = _pack_diffs(diffs)
            hdr = struct.pack(">HHHi", org_id, chan, (code << 12) | n, int(seg[0]))
            blocks.setdefault(int(round(t0)) + s, []).append(hdr + packed)

    out = bytearray()
    for sec in sorted(blocks):
        payload = b"".join(blocks[sec])
        out += _bcd_time(UTC(float(sec))) + struct.pack(">I", len(payload)) + payload
    Path(path).write_bytes(bytes(out))
    return chan_ids
