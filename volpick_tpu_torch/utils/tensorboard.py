"""Minimal TensorBoard event-file writer (no TensorFlow/tensorboard dependency).

Port of ``volpick_tpu/utils/tensorboard.py`` (a copy: the same bytes for the
same events).

The reference logs training scalars to CSV *and* TensorBoard side by side
(reference `volpick/model/train.py:122-130`, `TensorBoardLogger(save_dir=...)`).
This module provides the TensorBoard half natively: TFRecord framing
(length + masked CRC32C, as defined by the TensorFlow record format) around
hand-encoded `tensorflow.Event` protobufs carrying `Summary/simple_value`
scalars. Files written here load in stock TensorBoard (verified in
tests/test_tensorboard.py against the tensorboard package's own reader).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict, Optional

# ----------------------------------------------------------------- CRC32C
# Castagnoli polynomial (reflected), table-driven; TFRecord masks the CRC.
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ protobuf bits
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _vint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def encode_scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    """tensorflow.Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}."""
    summary_value = _bytes(1, tag.encode()) + _f32(2, float(value))
    summary = _bytes(1, summary_value)
    return _f64(1, wall_time) + _vint(2, int(step)) + _bytes(5, summary)


def encode_file_version_event(wall_time: float) -> bytes:
    """The mandatory first record: Event{wall_time=1, file_version=3}."""
    return _f64(1, wall_time) + _bytes(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    """TFRecord: u64 length, u32 masked-crc(length), data, u32 masked-crc(data)."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


# ----------------------------------------------------------------- writer
class TensorBoardLogger:
    """Scalar event writer compatible with `tensorboard --logdir <dir>`.

    Mirrors the logging surface the reference uses: one scalar per metric
    key per epoch (reference `volpick/model/train.py:122-130` plus the
    `self.log(...)` calls in `volpick/model/models.py:166-175`).
    """

    def __init__(self, logdir, filename_suffix: str = ""):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "local"
        name = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}{filename_suffix}"
        self.path = self.dir / name
        self._f = open(self.path, "ab")
        self._write(encode_file_version_event(time.time()))

    def _write(self, event: bytes):
        self._f.write(frame_record(event))

    def add_scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None):
        if value is None:
            return
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        self._write(encode_scalar_event(wall_time or time.time(), step, tag, v))

    def log_scalars(self, metrics: Dict, step: int, wall_time: Optional[float] = None):
        """Log every numeric value of a metrics dict (epoch/step keys skipped)."""
        for k, v in metrics.items():
            if k in ("epoch", "step"):
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.add_scalar(k, v, step, wall_time)

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
