"""Legacy SAC archive → miniSEED conversion (the HVO data path).

The reference converts per-event SAC folders (with sidecar pick files) to
mseed in parallel (`volpick/data/data.py:3566-3914`). Here the conversion is
fully native: the port's SAC reader + miniSEED writer, multiprocessing
over events with per-process CSV logs merged afterwards.

Port of ``volpick_tpu/acquisition/sac_convert.py``, with two faults of that
module repaired:

- the sidecar of ``x.sac`` is ``x.pick`` and that of ``x.SAC`` is ``x.PICK``:
  only the suffix changes (the JAX module replaces every ``sac`` in the whole
  path, so a directory named ``*_sac_*`` hides the sidecar and an upper-case
  ``.SAC`` file is read as its own sidecar);
- a worker that converts nothing still writes its log with the columns
  ``event, station, error``, so the merged log of an event folder without
  SAC files is an empty table (the JAX module writes a log without columns,
  which the merge cannot read).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from volpick_tpu_torch.acquisition.download import assemble_subprocess_csvlogs
from volpick_tpu_torch.core.sacio import read_sac
from volpick_tpu_torch.core.stream import Stream

logger = logging.getLogger("volpick_tpu_torch")


def read_sidecar_info(path: Union[str, Path]) -> Dict[str, list]:
    """Parse the legacy `key: value ...` sidecar files that accompany HVO SAC
    archives (reference `volpick/data/data.py:3535-3543`)."""
    info: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            key, _, value = line.partition(":")
            if key.strip():
                info[key.strip()] = value.strip().split()
    return info


def sidecar_path(sac_path: Union[str, Path]) -> Optional[Path]:
    """The sidecar of a SAC file: its path with the suffix ``.sac`` swapped
    for ``.pick`` (``.SAC`` for ``.PICK``); None for a file whose suffix is not
    ``.sac`` in some case."""
    sac_path = Path(sac_path)
    suffix = sac_path.suffix
    if suffix.lower() != ".sac":
        return None
    return sac_path.with_suffix(".PICK" if suffix.isupper() else ".pick")


def read_sac_with_sidecar(sac_path: Union[str, Path], t_offset: float = 0.0):
    """Read a SAC file and override its start time from the sidecar `.pick`
    file's `start_time: Y M D H M S.s` entry (reference `data.py:3545-3563`)."""
    from volpick_tpu_torch.core.stream import UTC
    import datetime as dt

    tr = read_sac(sac_path)
    sidecar = sidecar_path(sac_path)
    if sidecar is not None and sidecar.exists():
        info = read_sidecar_info(sidecar)
        st = info.get("start_time")
        if st and len(st) >= 6:
            base = dt.datetime(
                int(st[0]), int(st[1]), int(st[2]), int(st[3]), int(st[4]),
                tzinfo=dt.timezone.utc,
            )
            tr.stats.starttime = UTC(base.timestamp() + float(st[5]) + t_offset)
    return tr


def read_sac_event_folder(folder: Union[str, Path], pattern: str = "*.sac") -> Dict[str, Stream]:
    """Read all SAC files in an event folder, grouped per station id."""
    folder = Path(folder)
    groups: Dict[str, Stream] = {}
    for f in sorted(list(folder.glob(pattern)) + list(folder.glob(pattern.upper()))):
        try:
            tr = read_sac(f)
        except Exception as e:
            logger.warning(f"unreadable SAC file {f}: {e}")
            continue
        key = f"{tr.stats.network}.{tr.stats.station}.{tr.stats.location}"
        groups.setdefault(key, Stream()).append(tr)
    return groups


def convert_sac_to_mseed(
    event_folders: Sequence[Union[str, Path]],
    dest_dir: Union[str, Path],
    num_processes: int = 1,
    pattern: str = "*.sac",
) -> pd.DataFrame:
    """Convert per-event SAC folders to per-station mseed files.

    Output: dest_dir/<event>/<net.sta.loc>.mseed + a conversion log table."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    chunks = [c for c in np.array_split(np.arange(len(event_folders)), max(num_processes, 1)) if len(c)]
    if num_processes <= 1 or len(chunks) <= 1:
        _convert_worker([event_folders[i] for i in chunks[0]] if chunks else [], str(dest_dir), 0, pattern)
    else:
        ctx = mp.get_context("spawn")
        procs = []
        for pid, idx in enumerate(chunks):
            p = ctx.Process(
                target=_convert_worker,
                args=([str(event_folders[i]) for i in idx], str(dest_dir), pid, pattern),
            )
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
    return assemble_subprocess_csvlogs(dest_dir, "convert_log_p*.csv", "convert_log.csv")


def _convert_worker(folders, dest_dir, pid, pattern):
    import pandas as pd
    from volpick_tpu_torch.io.miniseed import write_mseed

    dest_dir = Path(dest_dir)
    rows = []
    for folder in folders:
        folder = Path(folder)
        out_dir = dest_dir / folder.name
        out_dir.mkdir(parents=True, exist_ok=True)
        for key, st in read_sac_event_folder(folder, pattern).items():
            entry = {"event": folder.name, "station": key, "error": ""}
            try:
                write_mseed(st, out_dir / f"{key}.mseed")
            except Exception as e:
                entry["error"] = type(e).__name__
            rows.append(entry)
    # the columns also when nothing was converted, so that the merge reads the log
    log = pd.DataFrame(rows, columns=["event", "station", "error"])
    log.to_csv(dest_dir / f"convert_log_p{pid}.csv", index=False)
