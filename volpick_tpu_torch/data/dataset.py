"""HDF5+CSV waveform datasets, on-disk compatible with the SeisBench format.

Port of ``volpick_tpu/data/dataset.py`` (a copy: one file format for both
packages). ``pandas`` and ``h5py`` are imported by the functions that read
files, not with the module.

The reference stores its benchmark data (VCSEIS) as SeisBench datasets:
`metadata{chunk}.csv` + `waveforms{chunk}.hdf5` pairs with a `chunks` index
file (reference `volpick/data/convert.py:92-101`, `volpick/data/utils.py:117-139`).
This reader understands that exact layout — including packed "bucket" arrays
with `name$idx,:C,:W` trace references — so datasets written by SeisBench
(VCSEIS, STEAD, INSTANCE) load directly.

Loading conventions mirror the reference's `get_dataset_by_path`
(`volpick/data/utils.py:1189-1196`): sampling_rate=100, component_order="ZNE",
dimension_order "NCW", optional full cache.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _parse_trace_name(name: str) -> Tuple[str, Optional[int], Optional[List[slice]]]:
    """Parse SeisBench trace references: "name" or "bucket0$3,:3,:6000"."""
    if "$" not in name:
        return name, None, None
    base, spec = name.split("$", 1)
    parts = spec.split(",")
    idx = int(parts[0])
    slices = []
    for p in parts[1:]:
        m = re.match(r"^:(\d+)$", p.strip())
        if m:
            slices.append(slice(0, int(m.group(1))))
        else:
            slices.append(slice(None))
    return base, idx, slices


class WaveformDataset:
    """A waveform benchmark dataset (traces + metadata table)."""

    def __init__(
        self,
        path: Union[str, Path],
        name: Optional[str] = None,
        sampling_rate: Optional[float] = 100.0,
        component_order: str = "ZNE",
        dimension_order: str = "NCW",
        cache: Optional[str] = None,
        chunks: Optional[Sequence[str]] = None,
    ):
        self.path = Path(path)
        self.name = name or self.path.name
        self.sampling_rate = sampling_rate
        self.component_order = component_order
        self.dimension_order = dimension_order
        self.cache = cache
        self._waveform_cache: Dict[str, np.ndarray] = {}

        if chunks is None:
            chunks = self.available_chunks(self.path)
        self.chunks = list(chunks)

        import pandas as pd

        frames = []
        for chunk in self.chunks:
            meta_path = self.path / f"metadata{chunk}.csv"
            df = pd.read_csv(meta_path, low_memory=False)
            df["trace_chunk"] = chunk
            frames.append(df)
        self.metadata = pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
        # remember whether the dataset shipped a split (consumers may inject
        # an auxiliary one when it did not, `train.py:255-261` semantics)
        self.had_split_column = "split" in self.metadata.columns
        if not self.had_split_column:
            self.metadata["split"] = "train"
        self._h5: Dict[str, object] = {}

    # ------------------------------------------------------------------ layout
    @staticmethod
    def available_chunks(path: Union[str, Path]) -> List[str]:
        path = Path(path)
        chunks_file = path / "chunks"
        if chunks_file.exists():
            with open(chunks_file) as f:
                chunks = [line.strip() for line in f if line.strip()]
            return chunks or [""]
        if (path / "metadata.csv").exists():
            return [""]
        chunks = []
        for p in sorted(path.glob("metadata*.csv")):
            chunks.append(p.name[len("metadata") : -len(".csv")])
        return chunks

    def _file(self, chunk: str):
        import h5py

        if chunk not in self._h5:
            self._h5[chunk] = h5py.File(self.path / f"waveforms{chunk}.hdf5", "r")
        return self._h5[chunk]

    @property
    def data_format(self) -> dict:
        if getattr(self, "_data_format_cache", None) is None:
            self._data_format_cache = {}
            for chunk in self.chunks:
                f = self._file(chunk)
                if "data_format" in f:
                    g = f["data_format"]
                    out = {}
                    for k in g:
                        v = g[k][()]
                        out[k] = v.decode() if isinstance(v, bytes) else v
                    self._data_format_cache = out
                    break
        return self._data_format_cache

    # ------------------------------------------------------------------ access
    def __len__(self):
        return len(self.metadata)

    def copy(self) -> "WaveformDataset":
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.metadata = self.metadata.copy()
        new._h5 = {}
        new._waveform_cache = self._waveform_cache  # share cache (read-only)
        return new

    def filter(self, mask, inplace: bool = True) -> "WaveformDataset":
        if inplace:
            self.metadata = self.metadata[np.asarray(mask)].reset_index(drop=True)
            return self
        new = self.copy()
        new.metadata = self.metadata[np.asarray(mask)].reset_index(drop=True)
        return new

    def get_split(self, split: str) -> "WaveformDataset":
        return self.filter(self.metadata["split"] == split, inplace=False)

    def train_dev_test(self):
        return tuple(self.get_split(s) for s in ("train", "dev", "test"))

    def region(self, *args, **kwargs):  # pragma: no cover - subclass hook
        raise NotImplementedError

    def _raw_waveform(self, row) -> np.ndarray:
        name = row["trace_name"]
        cache_key = f"{row['trace_chunk']}|{name}"
        if cache_key in self._waveform_cache:
            return self._waveform_cache[cache_key]
        f = self._file(row["trace_chunk"])
        base, idx, slices = _parse_trace_name(str(name))
        # SeisBench stores datasets under /data/<base>
        grp = f["data"] if "data" in f else f
        arr = grp[base]
        if idx is not None:
            data = arr[idx]
            if slices:
                data = data[tuple(slices)]
        else:
            data = arr[()]
        data = np.asarray(data)
        if self.cache == "full":
            self._waveform_cache[cache_key] = data
        return data

    def get_waveforms(self, idx: Optional[int] = None, mask=None) -> np.ndarray:
        """Waveforms for one index or a mask; returns NCW-ordered float arrays.

        When multiple traces are requested, they are zero-padded to the
        longest length (fixed-shape batching).
        """
        if idx is not None:
            rows = [self.metadata.iloc[idx]]
        elif mask is not None:
            rows = [self.metadata.iloc[i] for i in np.where(np.asarray(mask))[0]]
        else:
            rows = [self.metadata.iloc[i] for i in range(len(self.metadata))]
        arrays = [self._convert_waveform(r) for r in rows]
        if idx is not None:
            return arrays[0]
        max_w = max(a.shape[-1] for a in arrays)
        out = np.zeros((len(arrays), arrays[0].shape[0], max_w), dtype=np.float32)
        for i, a in enumerate(arrays):
            out[i, :, : a.shape[-1]] = a
        return out

    def _convert_waveform(self, row) -> np.ndarray:
        data = np.asarray(self._raw_waveform(row), dtype=np.float32)
        if data.ndim == 1:
            data = data[None, :]
        # source dimension/component order from the file's data_format
        fmt = self.data_format
        dim_order = fmt.get("dimension_order", "CW")
        comp_order = fmt.get("component_order", "ZNE")
        if dim_order == "WC":
            data = data.T
        # reorder components; components absent from the stored order come
        # out zero-filled (SeisBench padding semantics), keeping the channel
        # count equal to len(self.component_order)
        if comp_order != self.component_order and data.shape[0] == len(comp_order):
            out = np.zeros((len(self.component_order), data.shape[-1]), dtype=data.dtype)
            for i, c in enumerate(self.component_order):
                if c in comp_order:
                    out[i] = data[comp_order.index(c)]
            data = out
        # resample if needed
        sr = float(row.get("trace_sampling_rate_hz", self.sampling_rate or 100.0))
        if self.sampling_rate and abs(sr - self.sampling_rate) > 1e-6:
            from scipy.signal import resample_poly
            from fractions import Fraction

            frac = Fraction(self.sampling_rate / sr).limit_denominator(1000)
            data = resample_poly(data, frac.numerator, frac.denominator, axis=-1).astype(
                np.float32
            )
        return data

    def get_sample(self, idx: int) -> Tuple[np.ndarray, dict]:
        """(waveform (C, W), metadata dict) with arrival samples rescaled to
        the dataset sampling rate (the SeisBench get_sample contract the
        reference's generators consume)."""
        row = self.metadata.iloc[idx]
        data = self._convert_waveform(row)
        import pandas as pd

        md = row.to_dict()
        sr = float(row.get("trace_sampling_rate_hz", self.sampling_rate or 100.0))
        if self.sampling_rate and abs(sr - self.sampling_rate) > 1e-6:
            scale = self.sampling_rate / sr
            for k, v in list(md.items()):
                if k.endswith("_arrival_sample") and v is not None and not pd.isna(v):
                    md[k] = float(v) * scale
            md["trace_sampling_rate_hz"] = self.sampling_rate
        return data, md

    def preload_waveforms(self, pbar: bool = False):
        if self.cache is None:
            self.cache = "full"
        it = range(len(self.metadata))
        if pbar:
            try:
                from tqdm import tqdm

                it = tqdm(it, desc=f"preload {self.name}")
            except ImportError:
                pass
        for i in it:
            self._raw_waveform(self.metadata.iloc[i])


class VCSEIS(WaveformDataset):
    """The VCSEIS benchmark layout with the region / source-type selectors the
    reference documents (reference `README.md:91-112`)."""

    _REGION_NETWORKS = {
        "alaska": {"AV", "AK"},
        "hawaii": {"HV"},
        "northern_california": {"NC", "BG", "BK"},
        "cascade": {"UW", "CC", "PB"},
    }

    def _region_mask(self, region: str):
        md = self.metadata
        if "trace_region" in md.columns:
            return md["trace_region"].astype(str).str.lower().str.contains(region)
        chunk_hit = md["trace_chunk"].astype(str).str.lower().str.contains(region.split("_")[0])
        if chunk_hit.any():
            return chunk_hit
        nets = self._REGION_NETWORKS.get(region, set())
        return md["station_network_code"].astype(str).isin(nets)

    def get_alaska_subset(self):
        return self.filter(self._region_mask("alaska"), inplace=False)

    def get_hawaii_subset(self):
        return self.filter(self._region_mask("hawaii"), inplace=False)

    def get_northern_california_subset(self):
        return self.filter(self._region_mask("northern_california"), inplace=False)

    def get_cascade_subset(self):
        return self.filter(self._region_mask("cascade"), inplace=False)

    def _source_type(self):
        import pandas as pd

        return self.metadata.get(
            "source_type", pd.Series([""] * len(self.metadata))
        ).astype(str).str.lower()

    def get_long_period_earthquakes(self):
        st = self._source_type()
        return self.filter(st.isin({"lp", "long period", "long-period"}), inplace=False)

    def get_regular_earthquakes(self):
        st = self._source_type()
        return self.filter(
            st.isin({"regular", "vt", "earthquake", "regular earthquake"}), inplace=False
        )

    def get_noise_traces(self):
        import pandas as pd

        st = self._source_type()
        noise = st.isin({"noise"})
        if not noise.any() and "trace_p_arrival_sample" in self.metadata.columns:
            noise = self.metadata["trace_p_arrival_sample"].isna() & self.metadata.get(
                "trace_s_arrival_sample", pd.Series([np.nan] * len(self.metadata))
            ).isna()
        return self.filter(noise, inplace=False)


def load_dataset(name_or_path: Union[str, Path], **kwargs) -> WaveformDataset:
    """Resolve a dataset by path (or by name under $VOLPICK_TPU_DATA).

    Mirrors the reference's `get_dataset_by_name/by_path`
    (`volpick/data/utils.py:1176-1196`): 100 Hz, ZNE, NCW defaults."""
    kwargs.setdefault("sampling_rate", 100.0)
    kwargs.setdefault("component_order", "ZNE")
    kwargs.setdefault("dimension_order", "NCW")
    p = Path(name_or_path)
    if not p.exists():
        base = os.environ.get("VOLPICK_TPU_DATA", os.path.expanduser("~/.cache/volpick_tpu/data"))
        p = Path(base) / str(name_or_path)
    if not p.exists():
        raise FileNotFoundError(f"dataset {name_or_path!r} not found (looked at {p})")
    cls = VCSEIS if "vcseis" in str(name_or_path).lower() else WaveformDataset
    return cls(p, **kwargs)
