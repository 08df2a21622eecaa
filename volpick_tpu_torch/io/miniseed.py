"""miniSEED reading via the native C++ decoder (ctypes binding), and writing.

Port of ``volpick_tpu/io/miniseed.py``. The decoder is the repository's
``native/miniseed.cpp``, built with g++ on first use into
``build/volpick_tpu_torch/`` (``io/_native.py``); records with identical ids
that abut are merged into continuous Traces.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Union

import numpy as np

from volpick_tpu_torch.core.stream import Stream, Trace, UTC
from volpick_tpu_torch.io import _native

_LIB = None


class _RecordInfo(ctypes.Structure):
    _fields_ = [
        ("network", ctypes.c_char * 3),
        ("station", ctypes.c_char * 6),
        ("location", ctypes.c_char * 3),
        ("channel", ctypes.c_char * 4),
        ("starttime", ctypes.c_double),
        ("sampling_rate", ctypes.c_double),
        ("nsamples", ctypes.c_int32),
        ("offset", ctypes.c_int64),
    ]


def _get_lib():
    global _LIB
    if _LIB is None:
        lib = _native.library("miniseed")
        lib.msd_scan.restype = ctypes.c_int
        lib.msd_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.msd_decode.restype = ctypes.c_int
        lib.msd_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.POINTER(_RecordInfo),
        ]
        _LIB = lib
    return _LIB


def read_mseed(path: Union[str, Path], merge: bool = True) -> Stream:
    """Read a miniSEED file into a Stream (native decoder; no obspy)."""
    lib = _get_lib()
    buf = Path(path).read_bytes()
    n_records = ctypes.c_int32(0)
    total = ctypes.c_int64(0)
    rc = lib.msd_scan(buf, len(buf), ctypes.byref(n_records), ctypes.byref(total))
    if rc != 0 or n_records.value == 0:
        raise ValueError(f"{path}: not a readable miniSEED file")
    samples = np.zeros(total.value, dtype=np.float64)
    infos = (_RecordInfo * n_records.value)()
    ndec = lib.msd_decode(buf, len(buf), samples, infos)
    st = Stream()
    for i in range(ndec):
        info = infos[i]
        if info.nsamples <= 0:
            continue
        data = samples[info.offset : info.offset + info.nsamples].copy()
        st.append(
            Trace(
                data,
                dict(
                    network=info.network.decode().strip(),
                    station=info.station.decode().strip(),
                    location=info.location.decode().strip(),
                    channel=info.channel.decode().strip(),
                    sampling_rate=info.sampling_rate,
                    starttime=UTC(info.starttime),
                ),
            )
        )
    if merge:
        st.merge_overlaps()
    return st


def write_mseed(stream: Stream, path: Union[str, Path], encoding: str = "float32"):
    """Write a Stream as big-endian miniSEED (uncompressed float32 or int32,
    4096-byte records with blockette 1000)."""
    import datetime as dt
    import struct

    enc_code = {"float32": 4, "int32": 3}[encoding]
    reclen = 4096
    data_off = 64
    per_record = (reclen - data_off) // 4

    out = bytearray()
    seq = 1
    for tr in stream:
        data = np.asarray(tr.data)
        data = data.astype(">f4") if encoding == "float32" else np.round(data).astype(">i4")
        sr = tr.stats.sampling_rate
        pos = 0
        while pos < len(data):
            n = min(per_record, len(data) - pos)
            t = (tr.stats.starttime + pos / sr).datetime
            frac = int(round(t.microsecond / 100.0))
            if frac >= 10000:  # carry into the seconds field (BTIME range 0-9999)
                import datetime as _dtmod

                t = t + _dtmod.timedelta(microseconds=1_000_000 - t.microsecond)
                frac = 0
            rec = bytearray(reclen)
            rec[0:6] = f"{seq:06d}".encode()
            rec[6:8] = b"D "
            rec[8:13] = tr.stats.station.ljust(5)[:5].encode()
            rec[13:15] = tr.stats.location.ljust(2)[:2].encode()
            rec[15:18] = tr.stats.channel.ljust(3)[:3].encode()
            rec[18:20] = tr.stats.network.ljust(2)[:2].encode()
            rec[20:30] = struct.pack(
                ">HHBBBxH", t.year, t.timetuple().tm_yday, t.hour, t.minute, t.second, frac
            )
            rec[30:32] = struct.pack(">H", n)
            # sample rate as integer factor when possible, else 1/delta form
            if abs(sr - round(sr)) < 1e-9:
                rec[32:36] = struct.pack(">hh", int(round(sr)), 1)
            else:
                rec[32:36] = struct.pack(">hh", -int(round(1e4 / sr)), 10000)
            rec[39] = 1  # one blockette
            rec[44:46] = struct.pack(">H", data_off)
            rec[46:48] = struct.pack(">H", 48)
            # blockette 1000 at offset 48
            rec[48:56] = struct.pack(">HHBBBx", 1000, 0, enc_code, 1, 12)  # 2**12=4096
            rec[data_off : data_off + 4 * n] = data[pos : pos + n].tobytes()
            out += rec
            pos += n
            seq += 1
    Path(path).write_bytes(bytes(out))
