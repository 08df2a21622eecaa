"""Native SAC binary waveform I/O (no obspy dependency).

The reference's Hawaii pipeline reads legacy SAC files
(`volpick/data/data.py:3535-3645`). SAC is a simple fixed-layout format:
158-word header (70 float32 + 40 int32 + 192 bytes of char fields) followed
by float32 samples; byte order is autodetected from the header version field
(NVHDR, word 76 of the int block, value 6).

Port of ``volpick_tpu/core/sacio.py`` (a copy on the port's own ``core.stream``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

from volpick_tpu_torch.core.stream import Stream, Trace, UTC

_FLOAT_WORDS = 70
_INT_WORDS = 40
_CHAR_BYTES = 192
_HDR_BYTES = _FLOAT_WORDS * 4 + _INT_WORDS * 4 + _CHAR_BYTES  # 632
_UNDEF_F = -12345.0
_UNDEF_I = -12345


def _detect_endian(raw: bytes) -> str:
    # NVHDR is int word 6 (index 6 of the int block)
    off = _FLOAT_WORDS * 4 + 6 * 4
    for endian in ("<", ">"):
        (nvhdr,) = struct.unpack(endian + "i", raw[off : off + 4])
        if 1 <= nvhdr <= 10:
            return endian
    raise ValueError("not a SAC file (bad NVHDR)")


def read_sac(path: Union[str, Path]) -> Trace:
    """Read one SAC file → Trace (with start time, station ids, rate)."""
    raw = Path(path).read_bytes()
    if len(raw) < _HDR_BYTES:
        raise ValueError(f"{path}: truncated SAC header")
    endian = _detect_endian(raw)
    floats = np.frombuffer(raw, dtype=endian + "f4", count=_FLOAT_WORDS)
    ints = np.frombuffer(raw, dtype=endian + "i4", count=_INT_WORDS, offset=_FLOAT_WORDS * 4)
    chars = raw[_FLOAT_WORDS * 4 + _INT_WORDS * 4 : _HDR_BYTES]

    delta = float(floats[0])
    b = float(floats[5])  # begin time offset
    npts = int(ints[9])
    nz = [int(v) for v in ints[0:6]]  # year, jday, hour, min, sec, msec

    def char_field(idx: int, n: int = 8) -> str:
        s = chars[idx * 8 : idx * 8 + n].decode("ascii", "replace").strip()
        return "" if s in ("-12345", "") else s

    kstnm = char_field(0)
    # kcmpnm is field 20, knetwk field 21 (each 8 bytes; khole is field 2)
    khole = char_field(2)
    kcmpnm = char_field(20)
    knetwk = char_field(21)

    data = np.frombuffer(raw, dtype=endian + "f4", count=npts, offset=_HDR_BYTES).copy()

    if nz[0] != _UNDEF_I and nz[0] > 0:
        import datetime as dt

        base = dt.datetime(nz[0], 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(
            days=nz[1] - 1, hours=nz[2], minutes=nz[3], seconds=nz[4], milliseconds=nz[5]
        )
        start = UTC(base.timestamp() + (b if b != _UNDEF_F else 0.0))
    else:
        start = UTC(0.0)

    return Trace(
        data,
        dict(
            network=knetwk,
            station=kstnm,
            location=khole,
            channel=kcmpnm,
            sampling_rate=1.0 / delta if delta > 0 else 100.0,
            starttime=start,
        ),
    )


def write_sac(trace: Trace, path: Union[str, Path]):
    """Write a Trace as a little-endian SAC file."""
    import datetime as dt

    floats = np.full(_FLOAT_WORDS, _UNDEF_F, dtype="<f4")
    ints = np.full(_INT_WORDS, _UNDEF_I, dtype="<i4")
    chars = bytearray(b" " * _CHAR_BYTES)

    floats[0] = trace.stats.delta
    floats[5] = 0.0  # b
    floats[6] = (trace.stats.npts - 1) * trace.stats.delta  # e

    t = trace.stats.starttime.datetime
    ints[0] = t.year
    ints[1] = t.timetuple().tm_yday
    ints[2] = t.hour
    ints[3] = t.minute
    ints[4] = t.second
    ints[5] = t.microsecond // 1000
    ints[6] = 6  # NVHDR
    ints[9] = trace.stats.npts
    ints[15] = 1  # IFTYPE = ITIME
    ints[35] = 1  # LEVEN = true

    def put(idx: int, s: str, n: int = 8):
        b = s.encode("ascii", "replace")[:n].ljust(n)
        chars[idx * 8 : idx * 8 + n] = b

    put(0, trace.stats.station or "-12345")
    put(2, trace.stats.location or "")
    put(20, trace.stats.channel or "-12345")
    put(21, trace.stats.network or "-12345")

    with open(path, "wb") as f:
        f.write(floats.tobytes())
        f.write(ints.tobytes())
        f.write(bytes(chars))
        f.write(np.asarray(trace.data, dtype="<f4").tobytes())


def read_sac_stream(paths) -> Stream:
    return Stream([read_sac(p) for p in paths])
