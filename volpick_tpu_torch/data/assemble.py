"""Multi-chunk dataset assembly (reference `volpick/data/utils.py:117-139`).

Port of ``volpick_tpu/data/assemble.py`` (a copy: file operations and the
port's own ``data/dataset.py`` and ``data/writer.py``).

A dataset directory holds one or more (metadata{chunk}.csv, waveforms{chunk}.hdf5)
pairs plus a `chunks` index file listing the chunk suffixes.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Sequence, Union


def generate_chunk_file(dataset_dir: Union[str, Path]) -> List[str]:
    """(Re)create the `chunks` index from the metadata files present."""
    dataset_dir = Path(dataset_dir)
    chunks = sorted(
        p.name[len("metadata") : -len(".csv")] for p in dataset_dir.glob("metadata*.csv")
    )
    with open(dataset_dir / "chunks", "w") as f:
        f.write("\n".join(chunks) + ("\n" if chunks else ""))
    return chunks


def assemble_datasets(
    source_dirs: Dict[Union[str, Path], Sequence[str]],
    dest_dir: Union[str, Path],
    link: bool = False,
) -> List[str]:
    """Copy (or hard-link) chunk file pairs from several datasets into one.

    source_dirs: {dataset_dir: [chunk suffixes to take]} (empty sequence =
    all chunks present). Returns the final chunk list of the destination.
    """
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    for src, chunks in source_dirs.items():
        src = Path(src)
        if not chunks:
            chunks = [
                p.name[len("metadata") : -len(".csv")] for p in sorted(src.glob("metadata*.csv"))
            ]
        for chunk in chunks:
            for stem, suffix in (("metadata", ".csv"), ("waveforms", ".hdf5")):
                s = src / f"{stem}{chunk}{suffix}"
                d = dest_dir / f"{stem}{chunk}{suffix}"
                if not s.exists():
                    raise FileNotFoundError(s)
                if link:
                    if d.exists():
                        d.unlink()
                    try:
                        d.hardlink_to(s)
                    except OSError:
                        shutil.copy2(s, d)
                else:
                    shutil.copy2(s, d)
    return generate_chunk_file(dest_dir)


def repack_dataset(
    src_dir: Union[str, Path],
    dest_dir: Union[str, Path],
    bucket_size: int,
) -> int:
    """Rewrite a dataset with a different HDF5 bucket size; returns the new
    unique-bucket count.

    Waveform content (raw samples — no resampling or component reordering;
    float32, the HDF5 storage dtype) and every on-disk metadata column
    except `trace_name` (which encodes the bucket reference and is
    reassigned by the writer) are preserved. Block-granular consumers — `training_fraction` subsampling keeps
    whole buckets, exactly like the reference (`volpick/model/train.py:
    335-359`) — get `len(dataset)/bucket_size` selectable blocks instead of
    however coarsely the source happened to be packed, so small requested
    fractions resolve to distinct subsets (see docs/DIFFSIZE.md granularity
    note)."""
    import numpy as np

    from .dataset import WaveformDataset
    from .writer import WaveformDataWriter

    # sampling_rate=None: raw passthrough — no resampling, no component
    # reorder/zero-fill; the stored samples and the metadata describing them
    # (trace_sampling_rate_hz, *_arrival_sample) stay exactly as on disk
    src = WaveformDataset(src_dir, sampling_rate=None)
    dest_dir = Path(dest_dir)
    fmt = dict(src.data_format)
    dim_order = fmt.get("dimension_order", "CW")
    fmt["dimension_order"] = "CW"  # the writer stores (C, W)
    # never persist columns the reader injected (it re-injects them on load;
    # baking split='train' into a dataset that shipped none would disable
    # prepare_data's auxiliary-split path)
    drop = {"trace_chunk"} | (set() if src.had_split_column else {"split"})
    with WaveformDataWriter(
        dest_dir / "metadata.csv", dest_dir / "waveforms.hdf5", bucket_size=bucket_size
    ) as w:
        w.data_format = fmt
        for i in range(len(src)):
            full_row = src.metadata.iloc[i]
            data = np.asarray(src._raw_waveform(full_row), dtype=np.float32)
            if data.ndim == 1:
                data = data[None, :]
            if dim_order == "WC":
                data = data.T
            row = {k: v for k, v in full_row.to_dict().items() if k not in drop}
            w.add_trace(row, data)
    out = WaveformDataset(dest_dir)
    return out.metadata["trace_name"].astype(str).str.split("$").str[0].nunique()
