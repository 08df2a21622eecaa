"""The port's dataset layer and batch generator against the JAX package.

- ``data/synthetic.py``: the same seed writes the same dataset (metadata and
  waveforms exactly equal), for the easy and the hard generator, and
  ``synthetic_arrays`` holds the traces the writer writes;
- each package reads the other's files (``WaveformDataset``,
  ``load_dataset``, the writer's bucket references);
- ``pipeline/generator.py``: from one seed, the same batch indices, window
  offsets and host crops as the JAX generator, exactly, in the host-crop and
  in the device-resident mode; the device crop equals the host crop; a
  dataset smaller than a batch still gives a step.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from volpick_tpu.data import VCSEIS as JaxVCSEIS
from volpick_tpu.data import WaveformDataset as JaxDataset
from volpick_tpu.data import synthetic as jsynth
from volpick_tpu.pipeline import generator as jgen
from volpick_tpu_torch.data import dataset as tdataset
from volpick_tpu_torch.data import synthetic as tsynth
from volpick_tpu_torch.pipeline import generator as tgen
from volpick_tpu_torch.pipeline.augmentations import AugmentConfig

CFG = AugmentConfig(window=3001, stack=True)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    kw = dict(n_events=14, n_noise=4, n_samples=4000, seed=9)
    return (jsynth.make_synthetic_dataset(root / "jax", **kw),
            tsynth.make_synthetic_dataset(root / "port", **kw), kw)


def _assert_same_dataset(a, b):
    pd.testing.assert_frame_equal(a.metadata, b.metadata)
    for i in range(len(a)):
        wa, ma = a.get_sample(i)
        wb, mb = b.get_sample(i)
        np.testing.assert_array_equal(wa, wb)
        assert ma.keys() == mb.keys()


def test_same_seed_same_dataset_and_both_read_both(datasets):
    jdir, tdir, kw = datasets
    assert (jdir / "chunks").read_text() == (tdir / "chunks").read_text()
    assert (jdir / "metadata.csv").read_text() == (tdir / "metadata.csv").read_text()
    # each package reads the other's files, and both read the same thing
    _assert_same_dataset(JaxDataset(jdir), tdataset.WaveformDataset(tdir))
    _assert_same_dataset(tdataset.WaveformDataset(jdir), JaxDataset(tdir))
    _assert_same_dataset(tdataset.load_dataset(jdir), tdataset.WaveformDataset(tdir))
    # VCSEIS subsets select the same rows
    for name in ("get_noise_traces", "get_regular_earthquakes", "get_long_period_earthquakes"):
        pd.testing.assert_frame_equal(getattr(JaxVCSEIS(jdir), name)().metadata,
                                      getattr(tdataset.VCSEIS(tdir), name)().metadata)
    # the in-memory arrays are the traces the writer wrote
    waves, meta = tsynth.synthetic_arrays(**kw)
    ds = tdataset.WaveformDataset(tdir)
    assert [m["source_id"] for m in meta] == list(ds.metadata["source_id"])
    np.testing.assert_array_equal(waves, np.stack([ds.get_sample(i)[0] for i in range(len(ds))]))


def test_hard_generator_same_seed_same_dataset(tmp_path):
    kw = dict(n_events=5, n_noise=3, n_samples=3001, seed=4)
    a = jsynth.make_hard_synthetic_dataset(tmp_path / "jax", **kw)
    b = tsynth.make_hard_synthetic_dataset(tmp_path / "port", **kw)
    assert (a / "metadata.csv").read_text() == (b / "metadata.csv").read_text()
    _assert_same_dataset(JaxDataset(a), tdataset.WaveformDataset(b))


def test_raw_batch_source_from_arrays_equals_the_dataset_source(datasets):
    _, tdir, kw = datasets
    ds = tdataset.WaveformDataset(tdir)
    from_ds = tgen.RawBatchSource(ds)
    waves, meta = tsynth.synthetic_arrays(**kw)
    md = pd.DataFrame(meta)
    p, s = tgen._onset_arrays(md)
    from_arrays = tgen.RawBatchSource.from_arrays(
        waves, p, s, is_lp=(md["source_type"] == "lp").to_numpy())
    idx = np.array([0, 5, 17, 3])
    a, b = from_ds.take(idx), from_arrays.take(idx)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k][..., : waves.shape[-1]], b[k], err_msg=k)
    jsrc = jgen.RawBatchSource(JaxDataset(tdir))
    for k, v in jsrc.take(idx).items():
        np.testing.assert_array_equal(v, a[k], err_msg=k)


def _recorded(module, monkeypatch):
    """Replace the generator module's augmentation by a recorder of its
    inputs: the five raw batches of every step."""
    seen = []

    def record(*args):
        raws = [a for a in args if a is None or isinstance(a, dict)][:5]
        seen.append([None if r is None else {k: np.array(v if not isinstance(v, torch.Tensor) else v.cpu())
                                             for k, v in r.items()} for r in raws])
        return {}

    monkeypatch.setattr(module, "augment_train_batch", record)
    return seen


def _subsets(dataset_cls, path):
    ds = dataset_cls(path)
    train = ds.get_split("train")
    p, s = jgen._onset_arrays(train.metadata)
    return (train, train.filter(~np.isnan(p) | ~np.isnan(s), inplace=False),
            train.filter(np.isnan(p) & np.isnan(s), inplace=False))


@pytest.mark.parametrize("device_data", [False, True], ids=["host-crop", "device-resident"])
def test_generator_draws_the_jax_indices_offsets_and_crops(datasets, monkeypatch, device_data):
    jdir, tdir, _ = datasets
    j_seen, t_seen = _recorded(jgen, monkeypatch), _recorded(tgen, monkeypatch)
    jtrain, jeq, jnoise = _subsets(JaxDataset, jdir)
    ttrain, teq, tnoise = _subsets(tdataset.WaveformDataset, tdir)
    jg = jgen.TrainGenerator(jtrain, jgen.AugmentConfig(**dataclasses.asdict(CFG)), 4, eq_dataset=jeq,
                             noise_dataset=jnoise, seed=17, drop_last=False, device_data=device_data)
    tg = tgen.TrainGenerator(ttrain, CFG, 4, eq_dataset=teq, noise_dataset=tnoise, seed=17,
                             drop_last=False, device_data=device_data, device="cpu")
    assert jg.device_data == tg.device_data == device_data and len(jg) == len(tg) >= 2
    for _ in range(2):  # two epochs: the permutation and every draw after it
        list(jg.epoch())
        list(tg.epoch())
    assert len(j_seen) == len(t_seen) == 2 * len(jg)
    for js, ts in zip(j_seen, t_seen):
        for jr, tr in zip(js, ts):
            assert jr.keys() == tr.keys()
            for k in jr:
                np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)


def test_device_crop_equals_host_crop(datasets):
    _, tdir, _ = datasets
    train, eq, noise = _subsets(tdataset.WaveformDataset, tdir)
    src = tgen.RawBatchSource(train)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(src), 9)
    batch = src.take(idx)
    batch["len"] = batch["len"].copy()
    batch["len"][2] = 1500  # a short trace: the window runs past its end
    host = tgen.host_window_crop(np.random.default_rng(7), batch, CFG)
    off = tgen.select_window_offsets_host(np.random.default_rng(7), batch["len"], batch["p"], batch["s"], CFG)
    dev = tgen.device_gather_crop(src.device_pool("cpu"), torch.as_tensor(idx), torch.as_tensor(off),
                                  torch.as_tensor(batch["len"]), CFG.window)
    np.testing.assert_array_equal(dev.numpy(), host["x"])

    def epoch(device_data):
        g = tgen.TrainGenerator(train, CFG, 4, eq_dataset=eq, noise_dataset=noise, seed=5, drop_last=False,
                                device_data=device_data, device="cpu")
        return list(g.epoch())

    for a, b in zip(epoch(False), epoch(True)):
        assert a.keys() == b.keys() == {"X", "y", "is_lp"}
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_small_dataset_still_gives_a_step_and_device_is_required(datasets, monkeypatch):
    _, tdir, _ = datasets
    ds = tdataset.WaveformDataset(tdir).get_split("train")
    gen = tgen.TrainGenerator(ds, dataclasses.replace(CFG, stack=False), batch_size=64, device="cpu")
    assert len(gen) == 1
    (batch,) = list(gen.epoch())
    assert batch["X"].shape == (64, 3, 3001) and torch.isfinite(batch["X"]).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgen.TrainGenerator(ds, CFG, 4)
