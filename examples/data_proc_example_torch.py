"""Dataset-compilation workflow with the PyTorch port.

The counterpart of ``examples/data_proc_example.py`` on ``volpick_tpu_torch``:
1. a region catalog (here built from ``Event`` / ``PhasePick`` objects; in
   production ``read_hypoinverse_catalog``, ``read_jma_catalog`` or
   ``download_phases``), flattened to the per-station pick table,
2. the noise-window candidates of its quiet inter-event gaps,
3. waveforms through a loader (here synthetic; in production
   ``io.read_mseed`` on what ``download_waveforms_fdsn``,
   ``convert_win32_event_dirs`` or ``convert_sac_to_mseed`` wrote) into a
   benchmark dataset chunk (spikes, SNR, frequency index, seeded split),
4. the chunk index and the task-0 evaluation targets.

Everything here is host-side: no card is needed.

Run: python examples/data_proc_example_torch.py [WORKDIR]
"""

import argparse
from pathlib import Path

import numpy as np
import pandas as pd

from volpick_tpu_torch.acquisition import Catalog, Event, Magnitude, Origin, PhasePick
from volpick_tpu_torch.acquisition.convert import convert_catalog_to_dataset
from volpick_tpu_torch.acquisition.download import create_noise_table
from volpick_tpu_torch.core import UTC, Stream, Trace
from volpick_tpu_torch.data.assemble import generate_chunk_file
from volpick_tpu_torch.data.dataset import VCSEIS
from volpick_tpu_torch.eval import generate_task0


def example_catalog() -> Catalog:
    """Six events 2 h apart at three stations, a P and an S pick each (the
    table of the JAX example)."""
    cat = Catalog()
    for i in range(6):
        t0 = UTC("2020-01-02T03:04:00") + i * 7200.0
        sta = f"ST{i % 3}"
        cat.append(Event(
            f"ev{i}", Origin(t0 + 1, 61.2, -152.1, 3.0), Magnitude(1.2, "ml"), "lp" if i % 2 else "vt",
            picks=[PhasePick("AV", sta, "", "BHZ", t0 + 8.0, "P", weight=1.0),
                   PhasePick("AV", sta, "", "BHZ", t0 + 11.0, "S", weight=1.0)]))
    return cat


def fake_waveform_loader(table: pd.DataFrame, sr=100.0, n=6000):
    """trace_name -> a 60-s 3-component stream starting 1 s before the origin."""
    rng = np.random.default_rng(0)
    t0_by_name = {r["trace_name"]: UTC(r["source_origin_time"]) - 1.0 for _, r in table.iterrows()}

    def load(trace_name: str) -> Stream:
        t0 = t0_by_name[trace_name]
        t = np.arange(n) / sr
        d = rng.normal(size=(3, n)) * 0.1
        env = np.where(t >= 8.0, np.exp(-(t - 8.0) / 2.0), 0)
        d[0] += np.sin(2 * np.pi * 8 * t) * env * 2
        return Stream([Trace(d[i], dict(network="AV", station=trace_name.split(".")[0], channel=f"BH{c}",
                                        sampling_rate=sr, starttime=t0))
                       for i, c in enumerate("ZNE")])

    return load


def main(workdir) -> VCSEIS:
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)

    table = example_catalog().to_dataframe()
    table["trace_name"] = table["station_code"] + "." + table["source_id"]

    noise = create_noise_table(table, time_difference_limit=60.0)
    print(f"noise-window candidates: {len(noise)}")

    convert_catalog_to_dataset(table, fake_waveform_loader(table), work / "dataset", chunk="_demo", seed=42)
    generate_chunk_file(work / "dataset")
    ds = VCSEIS(work / "dataset")
    print(f"dataset: {len(ds)} traces; LP={len(ds.get_long_period_earthquakes())}")

    generate_task0(ds, work / "targets")
    print("targets written to", work / "targets")
    return ds


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="data_proc_demo_torch")
    main(ap.parse_args().workdir)
