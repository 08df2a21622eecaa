"""Trigger scan of the port (``ops/cuda/triggers.py::trigger_scan``) and the
``method="pallas"`` route vs the JAX package: exact equality.

On the CPU the wrapper runs its plain twin. Its three outputs are held
against the Pallas kernel ``trigger_scan_pallas_raw`` in interpret mode at
every position (run ends, where picks are read, included), with W not a
multiple of the Pallas chunk. ``extract_triggers_batched(method="pallas")``
must equal ``"pallas_full"`` and ``"shift"``, JAX's ``method="pallas"`` and
the numpy oracle, with per-row thresholds and more runs than K. Tolerance:
none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_picker import TorchDummyNet, _picks
from tests.test_torch_triggers import assert_same, edge_curves
from tests.test_oracle import THRESHOLDS, DummyNet, make_data
from volpick_tpu.ops.pallas.triggers import trigger_scan_pallas_raw
from volpick_tpu.ops.triggers import extract_triggers_batched as jax_extract
from volpick_tpu.ops.triggers import trigger_onset_numpy
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.ops import triggers as port_triggers
from volpick_tpu_torch.ops.cuda import triggers as cuda_triggers
from volpick_tpu_torch.ops.triggers import default_trigger_method, extract_triggers_batched
from volpick_tpu_torch.picker import WaveformPicker

I32_MAX = 2**31 - 1


def _scan(prob, t1, t2):
    out = cuda_triggers.trigger_scan(torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2))
    return [a.numpy() for a in out]


@pytest.mark.parametrize("w,chunk", [(1, 1024), (7, 1024), (1024, 1024), (2100, 1024), (2600, 512)])
def test_twin_matches_pallas_everywhere(rng, w, chunk):
    prob = edge_curves(rng, w, 8)
    b = prob.shape[0]
    t1 = rng.uniform(0.4, 0.7, b).astype(np.float32)
    t2 = (t1 * 0.5).astype(np.float32)
    before = cuda_triggers.scan_launches
    got = _scan(prob, t1, t2)
    assert cuda_triggers.scan_launches == before  # a CPU tensor launches nothing
    want = trigger_scan_pallas_raw(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                   chunk=chunk, interpret=True)
    assert [a.dtype for a in got] == [np.int32, np.float32, np.int32]
    above2 = prob > t2[:, None]
    run_end = above2 & ~np.pad(above2[:, 1:], ((0, 0), (0, 1)))
    for name, g, p in zip(("onset", "max", "argmax"), got, want):
        p = np.asarray(p)
        assert g.shape == p.shape == prob.shape
        np.testing.assert_array_equal(g[run_end], p[run_end], err_msg=f"{name} at run ends")
        np.testing.assert_array_equal(g, p, err_msg=name)


def test_what_the_outputs_hold_outside_runs():
    prob = np.float32([[0.1, 0.1, 0.6, 0.9, 0.9, 0.1, 0.1, 0.3, 0.3, 0.1],
                       [0.1] * 10])
    on, m, am = _scan(prob, np.float32([0.5, 0.5]), np.float32([0.25, 0.25]))
    # before the first run: (INT32_MAX, -3.4e38, 0); after a run: its state
    assert on[0].tolist() == [I32_MAX, I32_MAX, 2, 2, 2, 2, 2, I32_MAX, I32_MAX, I32_MAX]
    assert am[0].tolist() == [0, 0, 2, 3, 3, 3, 3, 7, 7, 7]
    np.testing.assert_array_equal(
        m[0], np.float32([cuda_triggers.SCAN_NEG] * 2 + [0.6, 0.9, 0.9, 0.9, 0.9, 0.3, 0.3, 0.3]))
    assert (on[1] == I32_MAX).all() and (am[1] == 0).all()
    assert (m[1] == np.float32(cuda_triggers.SCAN_NEG)).all() and np.isfinite(m).all()


@pytest.mark.parametrize("w,k", [(7, 4), (2100, 16), (2600, 80)])
def test_methods_agree_on_edge_rows(rng, w, k):
    prob = edge_curves(rng, w, k)  # one row has ~w/7 runs, far more than k
    t1 = rng.uniform(0.4, 0.7, prob.shape[0]).astype(np.float32)
    full, scan, shift = (
        [a.numpy() for a in extract_triggers_batched(torch.as_tensor(prob), torch.as_tensor(t1),
                                                     max_picks=k, method=m)]
        for m in ("pallas_full", "pallas", "shift"))
    assert_same(scan, full)
    assert_same(shift, full)
    if k <= w:
        assert_same(scan, jax_extract(jnp.asarray(prob), jnp.asarray(t1), max_picks=k,
                                      method="pallas"))  # Pallas interpreted


@pytest.mark.parametrize("seed", range(4))
def test_pallas_method_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    b, w, k = 10, 2000, (3, 40)[seed % 2]
    smooth = np.ones(int(rng.integers(1, 30)))
    prob = np.stack([np.convolve(rng.random(w), smooth / smooth.size, mode="same")
                     for _ in range(b)]).astype(np.float32)
    t1 = rng.uniform(0.3, 0.8, size=b).astype(np.float32)
    t2 = (t1 * rng.uniform(0.3, 1.0, size=b)).astype(np.float32)
    got = [a.numpy() for a in extract_triggers_batched(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), max_picks=k,
        method="pallas")]
    assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                 max_picks=k, method="pallas"))
    for i in range(b):
        trig = trigger_onset_numpy(prob[i], float(t1[i]), float(t2[i]))
        n = min(len(trig), k)
        assert got[2][i].sum() == n
        np.testing.assert_array_equal(got[3][i, :n], [t[0] for t in trig[:n]])
        np.testing.assert_array_equal(got[4][i, :n], [t[1] for t in trig[:n]])
        for j, (s0, s1) in enumerate(trig[:n]):
            assert got[0][i, j] == s0 + int(np.argmax(prob[i, s0 : s1 + 1]))
            assert got[1][i, j] == prob[i, got[0][i, j]]


def test_method_resolution_and_refusals(monkeypatch):
    monkeypatch.delenv("VOLPICK_TRIGGER_METHOD", raising=False)
    assert default_trigger_method() == "pallas_full"
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", "pallas")
    assert default_trigger_method() == "pallas"
    prob = torch.rand(3, 50)
    calls = []
    real = port_triggers.trigger_scan
    monkeypatch.setattr(port_triggers, "trigger_scan", lambda *a: calls.append(1) or real(*a))
    extract_triggers_batched(prob, 0.5, max_picks=4)  # the environment's method
    assert calls == [1]
    extract_triggers_batched(prob, 0.5, max_picks=4, method="pallas_full")  # the argument wins
    assert calls == [1]
    for method in ("assoc", "blocked"):
        with pytest.raises(NotImplementedError, match=method):
            extract_triggers_batched(prob, 0.5, method=method)
    with pytest.raises(ValueError, match="unknown trigger scan method"):
        extract_triggers_batched(prob, 0.5, method="fastest")


def test_scan_wrapper_rejects_bad_input():
    prob = torch.rand(3, 50)
    with pytest.raises(TypeError):
        cuda_triggers.trigger_scan(prob.double(), torch.ones(3), torch.ones(3))
    with pytest.raises(ValueError):
        cuda_triggers.trigger_scan(prob, torch.ones(2), torch.ones(3))
    with pytest.raises(ValueError):
        cuda_triggers.trigger_scan(prob[0], torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("total,overlap", [(1234, 100), (987, 200)])
def test_picker_under_the_pallas_method_matches_jax(total, overlap, monkeypatch):
    """Both pickers read ``$VOLPICK_TRIGGER_METHOD``; under "pallas" the picks
    are exactly the JAX picker's under the same setting."""
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", "pallas")
    data = make_data(np.random.default_rng(total), total)
    kw = dict(overlap=overlap, blinding=(0, 0), batch_size=8)
    calls = []
    real = port_triggers.trigger_scan
    monkeypatch.setattr(port_triggers, "trigger_scan", lambda *a: calls.append(1) or real(*a))
    got = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False).classify_arrays(
        data[None], THRESHOLDS, **kw)
    assert calls == [1]  # once a classify_arrays
    want = JaxPicker(DummyNet(), {}, detrend=False).classify_arrays(data[None], THRESHOLDS, **kw)
    for label in ("P", "S"):
        assert _picks(got, label, total) == _picks(want, label, total)
    assert sum(len(_picks(got, label, total)) for label in ("P", "S")) > 0
