"""The port's ``data/assemble.py`` against the JAX package's: exact.

- ``assemble_datasets`` (copied and hard-linked chunk pairs) gives the chunk
  list and the files JAX's gives, and each package reads the other's result
  as its own;
- ``repack_dataset`` (``tests/test_data.py``'s ``test_repack`` and
  ``test_repack_foreign_source`` as templates): the same bucket count and
  metadata as JAX's repack of the same source, waveforms equal, and each
  package reads the other's repacked files exactly;
- ``generate_chunk_file`` has one copy in the port, in ``data/assemble.py``.
"""

import re
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from volpick_tpu.data import WaveformDataset as JaxDataset
from volpick_tpu.data import assemble as jasm
from volpick_tpu_torch.data import assemble as pasm
from volpick_tpu_torch.data import synthetic
from volpick_tpu_torch.data.dataset import WaveformDataset
from volpick_tpu_torch.data.synthetic import make_synthetic_dataset
from volpick_tpu_torch.train.trainer import apply_training_fraction

PORT = Path(__file__).resolve().parents[1] / "volpick_tpu_torch"


@pytest.fixture(scope="module")
def synth_ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("asm_ds")
    make_synthetic_dataset(d, n_events=20, n_noise=6, n_samples=600, seed=4)
    return d


def _same_datasets(a, b):
    """Two readers of one dataset (of either package) agree exactly."""
    assert len(a) == len(b)
    pd.testing.assert_frame_equal(a.metadata.reset_index(drop=True), b.metadata.reset_index(drop=True))
    for i in range(len(a)):
        np.testing.assert_array_equal(a.get_waveforms(i), b.get_waveforms(i))


@pytest.mark.parametrize("link", [False, True])
def test_assemble_matches_jax(tmp_path, link):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    make_synthetic_dataset(d1, n_events=4, n_noise=0, n_samples=500, chunk="_r1")
    make_synthetic_dataset(d2, n_events=3, n_noise=2, n_samples=500, chunk="_r2", seed=9)
    make_synthetic_dataset(d2, n_events=2, n_noise=1, n_samples=500, chunk="_r3", seed=10)
    # d2's chunks by an empty sequence: every chunk present
    got = pasm.assemble_datasets({d1: ["_r1"], d2: []}, tmp_path / "port", link=link)
    want = jasm.assemble_datasets({d1: ["_r1"], d2: []}, tmp_path / "jax", link=link)
    assert got == want == ["_r1", "_r2", "_r3"]
    for name in ("chunks", "metadata_r1.csv", "waveforms_r1.hdf5", "metadata_r3.csv", "waveforms_r3.hdf5"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    port, jax_ = WaveformDataset(tmp_path / "port"), JaxDataset(tmp_path / "port")
    assert len(port) == 12 and set(port.metadata["trace_chunk"]) == {"_r1", "_r2", "_r3"}
    _same_datasets(port, jax_)
    _same_datasets(WaveformDataset(tmp_path / "jax"), port)
    with pytest.raises(FileNotFoundError):
        pasm.assemble_datasets({d1: ["_missing"]}, tmp_path / "none")


def test_repack_matches_jax(synth_ds, tmp_path):
    """repack_dataset preserves content and multiplies the block count, as
    JAX's does, so that training_fraction resolves small fractions."""
    src = WaveformDataset(synth_ds)
    n_buckets = pasm.repack_dataset(synth_ds, tmp_path / "port", bucket_size=4)
    assert n_buckets == jasm.repack_dataset(synth_ds, tmp_path / "jax", bucket_size=4) == -(-len(src) // 4)
    assert (tmp_path / "port" / "metadata.csv").read_bytes() == (tmp_path / "jax" / "metadata.csv").read_bytes()
    out = WaveformDataset(tmp_path / "port")
    for i in range(len(src)):
        np.testing.assert_array_equal(out.get_waveforms(i), src.get_waveforms(i))
    for col in src.metadata.columns:
        if col == "trace_name":
            continue
        a, b = src.metadata[col], out.metadata[col]
        assert (a.fillna("~") == b.fillna("~")).all() if a.isna().any() else (a == b).all()
    # each package reads the other's repacked files as its own
    _same_datasets(out, JaxDataset(tmp_path / "port"))
    _same_datasets(WaveformDataset(tmp_path / "jax"), out)
    sizes = []
    for frac in (0.15, 0.45, 0.9):
        sub = WaveformDataset(tmp_path / "port")
        apply_training_fraction(frac, sub)
        sizes.append(len(sub))
    assert sizes[0] < sizes[1] < sizes[2]


def test_repack_foreign_source_matches_jax(tmp_path):
    """A WC-order, 50-Hz, float64 source with no split column repacks as raw
    content: no second resampling, no component shuffle, no reader-injected
    columns persisted; JAX's repack of it gives the same files' content."""
    import h5py

    src_dir = tmp_path / "foreign"
    src_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    with h5py.File(src_dir / "waveforms.hdf5", "w") as f:
        g = f.require_group("data")
        for i in range(10):
            g.create_dataset(f"tr{i}", data=rng.normal(size=(1500 + 10 * i, 3)))
            rows.append({"trace_name": f"tr{i}", "trace_sampling_rate_hz": 50.0,
                         "trace_p_arrival_sample": 300.0 + i, "source_type": "vt"})
        df = f.require_group("data_format")
        df.create_dataset("dimension_order", data="WC")
        df.create_dataset("component_order", data="ZNE")
        df.create_dataset("sampling_rate", data="50")
    pd.DataFrame(rows).to_csv(src_dir / "metadata.csv", index=False)

    assert pasm.repack_dataset(src_dir, tmp_path / "port", bucket_size=3) == 4
    assert jasm.repack_dataset(src_dir, tmp_path / "jax", bucket_size=3) == 4
    out_md = pd.read_csv(tmp_path / "port" / "metadata.csv")
    assert "split" not in out_md.columns and "trace_chunk" not in out_md.columns
    assert (out_md["trace_sampling_rate_hz"] == 50.0).all()
    assert (tmp_path / "port" / "metadata.csv").read_bytes() == (tmp_path / "jax" / "metadata.csv").read_bytes()
    src, out = WaveformDataset(src_dir), WaveformDataset(tmp_path / "port")
    for i in (0, 4, 9):  # converted reads agree: resampled exactly once
        np.testing.assert_allclose(src.get_waveforms(i), out.get_waveforms(i), atol=1e-6)
    _, md = out.get_sample(2)
    assert md["trace_p_arrival_sample"] == (300.0 + 2) * 2.0
    _same_datasets(out, JaxDataset(tmp_path / "port"))
    _same_datasets(WaveformDataset(tmp_path / "jax"), out)


def test_generate_chunk_file_has_one_copy(tmp_path):
    assert synthetic.generate_chunk_file is pasm.generate_chunk_file
    defs = [p for p in PORT.rglob("*.py") if re.search(r"^def generate_chunk_file\b", p.read_text(), re.M)]
    assert defs == [PORT / "data" / "assemble.py"]
    for name in ("metadata_b.csv", "metadata.csv", "metadata_a.csv", "waveforms_a.hdf5"):
        (tmp_path / name).write_text("")
    assert pasm.generate_chunk_file(tmp_path) == jasm.generate_chunk_file(tmp_path) == ["", "_a", "_b"]
    assert (tmp_path / "chunks").read_text() == "\n_a\n_b\n"
    (tmp_path / "empty").mkdir()
    assert pasm.generate_chunk_file(tmp_path / "empty") == []
    assert (tmp_path / "empty" / "chunks").read_text() == ""
