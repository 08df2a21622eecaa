"""WaveformDataWriter: produce SeisBench-format HDF5+CSV dataset chunks.

Port of ``volpick_tpu/data/writer.py`` (a copy: the same file format, so a
dataset written by either package is read by both; ``h5py`` and ``pandas``
are imported where a file is written, not with the module). Counterpart of the seisbench writer the reference's converter drives
(reference `volpick/data/convert.py:92-101`). Traces of similar length are
packed into fixed-shape "bucket" arrays (better HDF5 read throughput and the
layout SeisBench itself writes); metadata rows reference them with the
`bucket<N>$<idx>,:C,:W` syntax our reader (and SeisBench's) understands.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Union

import numpy as np


class WaveformDataWriter:
    def __init__(
        self,
        metadata_path: Union[str, Path],
        waveforms_path: Union[str, Path],
        bucket_size: int = 1024,
    ):
        self.metadata_path = Path(metadata_path)
        self.waveforms_path = Path(waveforms_path)
        self.bucket_size = bucket_size
        self.data_format: Dict[str, str] = {}
        self._rows: List[dict] = []
        self._buckets: Dict[tuple, list] = {}  # (C, W_pow2) → list[(row_idx, data)]
        self._file = None
        self._n_buckets = 0

    def __enter__(self):
        import h5py

        self.metadata_path.parent.mkdir(parents=True, exist_ok=True)
        self.waveforms_path.parent.mkdir(parents=True, exist_ok=True)
        self._file = h5py.File(self.waveforms_path, "w")
        return self

    def add_trace(self, metadata: dict, waveform: np.ndarray):
        waveform = np.asarray(waveform)
        if waveform.ndim == 1:
            waveform = waveform[None, :]
        row = dict(metadata)
        row["trace_name"] = str(row.get("trace_name", f"trace{len(self._rows)}"))
        idx = len(self._rows)
        self._rows.append(row)
        c, w = waveform.shape
        # bucket by channel count and power-of-two length class
        w_class = 1 << max(int(math.ceil(math.log2(max(w, 1)))), 0)
        key = (c, w_class)
        self._buckets.setdefault(key, []).append((idx, waveform))
        if len(self._buckets[key]) >= self.bucket_size:
            self._flush_bucket(key)

    def _flush_bucket(self, key):
        entries = self._buckets.pop(key, [])
        if not entries:
            return
        c, _ = key
        max_w = max(d.shape[-1] for _, d in entries)
        arr = np.zeros((len(entries), c, max_w), dtype=np.float32)
        for i, (_, d) in enumerate(entries):
            arr[i, :, : d.shape[-1]] = d
        name = f"bucket{self._n_buckets}"
        self._n_buckets += 1
        grp = self._file.require_group("data")
        grp.create_dataset(name, data=arr, compression=None)
        for i, (row_idx, d) in enumerate(entries):
            self._rows[row_idx]["trace_name"] = f"{name}${i},:{d.shape[0]},:{d.shape[-1]}"

    def set_total(self, n: int):  # API-compat no-op (progress hint)
        pass

    def flush_hdf5(self):
        for key in list(self._buckets):
            self._flush_bucket(key)

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.flush_hdf5()
                g = self._file.require_group("data_format")
                for k, v in self.data_format.items():
                    g.create_dataset(k, data=str(v))
                import pandas as pd

                pd.DataFrame(self._rows).to_csv(self.metadata_path, index=False)
        finally:
            self._file.close()
            self._file = None
        return False
