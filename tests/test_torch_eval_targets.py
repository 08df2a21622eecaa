"""Evaluation targets and steered framing of the port against the JAX package.

Both packages read one dataset directory written by ``make_synthetic_dataset``
(40 traces of 6000 samples). The three target CSVs are byte-equal between
the packages (both draw from the global ``np.random`` stream seeded 42), and
the port's in-memory ``synthetic_dataset`` gives the same CSVs and the same
``RawBatchSource`` arrays as the file. ``steered_window_offsets`` is exact;
``steered_frames`` is within 2e-6 of JAX's (the JAX tests' pin between the
device framing and ``eval_batch``) and of the port's ``eval_batch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.data import VCSEIS
from volpick_tpu.data.synthetic import make_synthetic_dataset
from volpick_tpu.eval import targets as jtargets
from volpick_tpu.pipeline import generator as jgen
from volpick_tpu_torch.data.dataset import WaveformDataset
from volpick_tpu_torch.data.synthetic import synthetic_arrays, synthetic_dataset
from volpick_tpu_torch.eval import targets as ptargets
from volpick_tpu_torch.pipeline import generator as pgen

FRAME_TOL = 2e-6
DS = dict(n_events=30, n_noise=10, n_samples=6000, seed=11)


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_targets_ds")
    make_synthetic_dataset(d, **DS)
    return d


@pytest.fixture(scope="module")
def datasets(ds_dir):
    """(JAX dataset, the port's file dataset, the port's in-memory dataset)."""
    return VCSEIS(ds_dir), WaveformDataset(ds_dir), synthetic_dataset(*synthetic_arrays(**DS))


TASKS = [
    ("task0", "generate_task0", {}),
    ("task0", "generate_task0", {"noise_before_events": True, "keep_source_type": True}),
    ("task0", "generate_task0", {"windowlen_t": 10.0}),
    ("task1", "generate_task1", {}),
    ("task1", "generate_task1", {"noise_before_events": False}),
    ("task23", "generate_task23", {}),
]


@pytest.mark.parametrize("task,fn,kw", TASKS, ids=[f"{t[1]}-{'-'.join(t[2]) or 'default'}" for t in TASKS])
def test_target_csvs_are_byte_equal(datasets, tmp_path, task, fn, kw):
    jds, pds, mem = datasets
    getattr(jtargets, fn)(jds, tmp_path / "jax", **kw)
    getattr(ptargets, fn)(pds, tmp_path / "port", **kw)
    getattr(ptargets, fn)(mem, tmp_path / "mem", **kw)
    want = (tmp_path / "jax" / f"{task}.csv").read_bytes()
    assert len(want.splitlines()) > 10
    assert (tmp_path / "port" / f"{task}.csv").read_bytes() == want
    assert (tmp_path / "mem" / f"{task}.csv").read_bytes() == want


def test_existing_targets_are_kept_when_asked(datasets, tmp_path):
    _, pds, _ = datasets
    ptargets.generate_task0(pds, tmp_path)
    assert ptargets.generate_task0(pds, tmp_path, replace_if_exist=False) is None


def test_select_window_containing_follows_jax():
    for seed in range(3):
        got, want = [], []
        for out, mod in ((got, ptargets), (want, jtargets)):
            np.random.seed(seed)
            for npts, wl, c in ((10000, 3000, 5000), (1000, 3000, None), (9000, 3000, None),
                                (6000, 3000, 150), (4000, 3000, 3950)):
                out.append(mod.select_window_containing(npts, wl, containing=c))
        assert got == want


def test_raw_batch_source_reads_the_same_arrays(datasets):
    _, pds, mem = datasets
    a, b = pgen.RawBatchSource(pds), pgen.RawBatchSource(mem)
    idx = np.arange(len(pds))[::-1]
    for k, v in a.take(idx).items():
        np.testing.assert_array_equal(b.take(idx)[k], v, err_msg=k)
    np.testing.assert_array_equal(a.is_lp, b.is_lp)


def test_steered_window_offsets_exact():
    rng = np.random.default_rng(2)
    lens = rng.integers(500, 9000, 64)
    ss = rng.integers(-200, 9000, 64)
    es = ss + rng.integers(1, 7000, 64)
    for window in (601, 3001, 6000):
        got = pgen.steered_window_offsets(lens, ss, es, window)
        want = jgen.steered_window_offsets(lens, ss, es, window)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
def test_steered_frames_match_jax_and_eval_batch(datasets, detrend, norm):
    jds, pds, _ = datasets
    window = 601
    idxs = np.arange(8)
    ss = np.array([100, 2000, 5500, 0, 300, 5900, 2500, 1]) % 5900
    es = ss + 80
    src = pgen.RawBatchSource(pds)
    batch = src.take(idxs)
    w0, borders = pgen.steered_window_offsets(batch["len"], ss, es, window)
    got = pgen.steered_frames(torch.as_tensor(batch["x"]), torch.as_tensor(w0), window,
                              detrend=detrend, norm=norm).numpy()
    want = np.asarray(jgen.steered_frames(jnp.asarray(batch["x"]), jnp.asarray(w0), window,
                                          detrend=detrend, norm=norm))
    np.testing.assert_allclose(got, want, atol=FRAME_TOL, rtol=0)
    x_host, borders_host = pgen.eval_batch(pds, idxs, window, ss, es, norm=norm, detrend=detrend)
    x_jax, borders_jax = jgen.eval_batch(jds, idxs, window, ss, es, norm=norm, detrend=detrend)
    np.testing.assert_array_equal(borders, borders_host)
    np.testing.assert_array_equal(borders_host, borders_jax)
    np.testing.assert_array_equal(x_host, x_jax)
    np.testing.assert_allclose(got, x_host, atol=FRAME_TOL, rtol=0)


def test_steered_frames_pad_outside_the_buffer():
    """Starts before the buffer or past its end read zeros, as JAX's padded
    slice does; a start is clamped to [-window, L] as JAX clamps it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 3, 700)).astype(np.float32)
    w0 = np.array([-50, 0, 650, 699, 2000])
    got = pgen.steered_frames(torch.as_tensor(x), torch.as_tensor(w0), 300).numpy()
    want = np.asarray(jgen.steered_frames(jnp.asarray(x), jnp.asarray(w0), 300))
    np.testing.assert_allclose(got, want, atol=FRAME_TOL, rtol=0)
