"""Trigger scan of the port (``ops/cuda/triggers.py::trigger_scan``) and the
``method="pallas"`` route vs the JAX package: exact equality.

On the CPU the wrapper runs its plain twin. Its three outputs are held
against the Pallas kernel ``trigger_scan_pallas_raw`` in interpret mode at
every position (run ends, where picks are read, included), with W not a
multiple of the Pallas chunk. ``extract_triggers_batched(method="pallas")``
must equal ``"pallas_full"`` and ``"shift"``, JAX's ``method="pallas"`` and
the numpy oracle, with per-row thresholds and more runs than K. The
``"blocked"`` method (scan inside blocks, scan of the block summaries, one
combine with the exclusive prefix: the two-level structure of the CUDA
kernel, a piece a warp) is held against the flat scan, JAX's ``"blocked"`` and
``"shift"`` and the numpy oracle for block lengths 1, 7 and 2048, with runs
across and beyond block boundaries. The ``"assoc"`` method (an up-sweep over
pairs and a down-sweep, the recursion of ``jax.lax.associative_scan``) is held
against ``"shift"``, ``"blocked"`` and JAX's ``"assoc"`` on the same cases, at
every position of the scanned state. Tolerance: none.
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


def _blocked(prob, t1, t2, block):
    out = cuda_triggers.trigger_scan_reference(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), block=block)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("block", [1, 7, 2048])
@pytest.mark.parametrize("w", [1, 7, 2100, 2600])
def test_blocked_scan_equals_flat_scan_and_jax(rng, w, block):
    """Every position of all three outputs: the two-level scan against the
    flat one, and its picks against JAX's "blocked" and "shift" methods."""
    k = 16
    prob = edge_curves(rng, w, k)
    b = prob.shape[0]
    t1 = rng.uniform(0.4, 0.7, b).astype(np.float32)
    t2 = (t1 * 0.5).astype(np.float32)
    for name, g, f in zip(("onset", "max", "argmax"), _blocked(prob, t1, t2, block),
                          _scan(prob, t1, t2)):
        assert g.dtype == f.dtype
        np.testing.assert_array_equal(g, f, err_msg=name)
    got = [a.numpy() for a in cuda_triggers.trigger_extract_blocked(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), k, block=block)]
    assert_same(got, [a.numpy() for a in cuda_triggers.trigger_extract_reference(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), k)])
    if k <= w:
        for method in ("blocked", "shift"):
            assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                         max_picks=k, method=method))


def _assoc(prob, t1, t2):
    out = cuda_triggers._scan_states(torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2),
                                     cuda_triggers.SCAN_NEG, pairwise=True)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("w", [1, 2, 3, 7, 64, 2100, 2600])
def test_assoc_scan_equals_flat_scan_and_jax(rng, w):
    """Every position of all three outputs: the pairwise scan against the flat
    one, and its picks against "shift", "blocked" and JAX's "assoc"."""
    k = 16
    prob = edge_curves(rng, w, k)
    b = prob.shape[0]
    t1 = rng.uniform(0.4, 0.7, b).astype(np.float32)
    t2 = (t1 * 0.5).astype(np.float32)
    for name, g, f in zip(("onset", "max", "argmax"), _assoc(prob, t1, t2), _scan(prob, t1, t2)):
        assert g.dtype == f.dtype
        np.testing.assert_array_equal(g, f, err_msg=name)
    args = (torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2))
    got = [a.numpy() for a in extract_triggers_batched(*args, max_picks=k, method="assoc")]
    for method in ("shift", "blocked", "pallas_full"):
        assert_same(got, [a.numpy() for a in extract_triggers_batched(*args, max_picks=k, method=method)])
    if k <= w:
        assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                     max_picks=k, method="assoc"))


def _one_row(w, *runs):
    r = np.full(w, 0.1, np.float32)
    for lo, hi, v in runs:
        r[lo:hi] = v
    return r[None]


# block length 8; what goes wrong if a block's carry is mishandled
BLOCK_TRAPS = {
    # the first run starts in the second block: before it (INT32_MAX, -3.4e38, 0)
    "first_run_in_second_block": (_one_row(32, (10, 13, 0.9)), 10),
    # one run over three blocks: the middle block has no run start and hands
    # onset, max and argmax through; the max sits in the first block
    "run_spans_three_blocks": (_one_row(40, (6, 9, 0.6), (9, 10, 0.95), (10, 27, 0.7)), 6),
    # a run that touches the row end ends at W - 1
    "run_touches_row_end": (_one_row(30, (3, 5, 0.8), (21, 30, 0.9)), 3),
    # a row that never triggers: argmax 0 everywhere, not a block's first index
    "never_triggers": (_one_row(29), None),
}


@pytest.mark.parametrize("trap", sorted(BLOCK_TRAPS))
def test_blocked_scan_traps(trap):
    prob, first_onset = BLOCK_TRAPS[trap]
    w = prob.shape[1]
    t1, t2 = np.float32([0.5]), np.float32([0.25])
    got = _blocked(prob, t1, t2, block=8)
    for name, g, f in zip(("onset", "max", "argmax"), got, _scan(prob, t1, t2)):
        np.testing.assert_array_equal(g, f, err_msg=name)
    on, m, am = (a[0] for a in got)
    quiet = w if first_onset is None else first_onset  # positions before the first run
    assert (on[:quiet] == I32_MAX).all() and (am[:quiet] == 0).all()
    assert (m[:quiet] == np.float32(cuda_triggers.SCAN_NEG)).all()
    for name, g, f in zip(("onset", "max", "argmax"), _assoc(prob, t1, t2), got):
        np.testing.assert_array_equal(g, f, err_msg=f"assoc {name}")
    picks = [a.numpy() for a in extract_triggers_batched(torch.as_tensor(prob), 0.5, max_picks=4,
                                                         method="blocked")]
    assert_same(picks, [a.numpy() for a in extract_triggers_batched(torch.as_tensor(prob), 0.5,
                                                                    max_picks=4, method="assoc")])
    trig = trigger_onset_numpy(prob[0], 0.5, 0.25)
    assert picks[2][0].sum() == len(trig)
    if trap == "run_spans_three_blocks":
        assert (on[6:27] == 6).all() and (am[9:27] == 9).all() and (m[9:27] == np.float32(0.95)).all()
        assert picks[0][0, 0] == 9 and picks[3][0, 0] == 6 and picks[4][0, 0] == 26
    if trap == "run_touches_row_end":
        assert tuple(trig[-1]) == (21, w - 1) and picks[4][0, 1] == w - 1 and picks[3][0, 1] == 21
    if trap == "never_triggers":
        assert len(trig) == 0 and (picks[0] == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_assoc_method_matches_numpy_oracle_and_jax(seed):
    rng = np.random.default_rng(200 + seed)
    b, w, k = 10, 3001, (3, 40)[seed % 2]
    smooth = np.ones(int(rng.integers(1, 30)))
    prob = np.stack([np.convolve(rng.random(w), smooth / smooth.size, mode="same")
                     for _ in range(b)]).astype(np.float32)
    t1 = rng.uniform(0.3, 0.8, size=b).astype(np.float32)
    t2 = (t1 * rng.uniform(0.3, 1.0, size=b)).astype(np.float32)
    got = [a.numpy() for a in extract_triggers_batched(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), max_picks=k, method="assoc")]
    assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                 max_picks=k, method="assoc"))
    peaks = port_triggers.extract_picks_batched(torch.as_tensor(prob), torch.as_tensor(t1),
                                                torch.as_tensor(t2), max_picks=k)
    assert_same([a.numpy() for a in peaks], got[:3])
    for i in range(b):
        trig = trigger_onset_numpy(prob[i], float(t1[i]), float(t2[i]))
        assert trig == port_triggers.trigger_onset_numpy(prob[i], float(t1[i]), float(t2[i]))
        n = min(len(trig), k)
        assert got[2][i].sum() == n
        np.testing.assert_array_equal(got[3][i, :n], [t[0] for t in trig[:n]])
        np.testing.assert_array_equal(got[4][i, :n], [t[1] for t in trig[:n]])


@pytest.mark.parametrize("seed", range(4))
def test_blocked_method_matches_numpy_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    b, w, k = 10, 5000, (3, 40)[seed % 2]  # W > 2048: three blocks
    smooth = np.ones(int(rng.integers(1, 30)))
    prob = np.stack([np.convolve(rng.random(w), smooth / smooth.size, mode="same")
                     for _ in range(b)]).astype(np.float32)
    t1 = rng.uniform(0.3, 0.8, size=b).astype(np.float32)
    t2 = (t1 * rng.uniform(0.3, 1.0, size=b)).astype(np.float32)
    got = [a.numpy() for a in extract_triggers_batched(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), max_picks=k,
        method="blocked")]
    assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                 max_picks=k, method="blocked"))
    for i in range(b):
        trig = trigger_onset_numpy(prob[i], float(t1[i]), float(t2[i]))
        n = min(len(trig), k)
        assert got[2][i].sum() == n
        np.testing.assert_array_equal(got[3][i, :n], [t[0] for t in trig[:n]])
        np.testing.assert_array_equal(got[4][i, :n], [t[1] for t in trig[:n]])
        for j, (s0, s1) in enumerate(trig[:n]):
            assert got[0][i, j] == s0 + int(np.argmax(prob[i, s0 : s1 + 1]))
            assert got[1][i, j] == prob[i, got[0][i, j]]


@pytest.mark.parametrize("b,w", [(24, 120000), (3000, 6000), (1, 120000), (5, 1), (7, 4097),
                                 (600, 1023), (5000, 6000), (132, 8192)])
def test_scan_plan_covers_the_row(b, w):
    """The split of a row that the CUDA kernel is given: whole steps, the row
    and its shift of up to 3 samples covered, no piece empty of steps."""
    piece, n_pieces = cuda_triggers.scan_plan(b, w)
    span = w + (3 if w % 4 else 0)
    assert piece % cuda_triggers.SCAN_STEP == 0 and piece >= cuda_triggers.SCAN_STEP
    assert n_pieces >= 1 and n_pieces * piece >= span > (n_pieces - 1) * piece
    if b >= cuda_triggers.SCAN_TARGET_WARPS:
        assert n_pieces == 1
    if (b, w) == (24, 120000):
        assert (piece, n_pieces) == (1408, 86)  # 2064 warps, 258 CTAs for 132 SMs
    if (b, w) == (3000, 6000):
        assert (piece, n_pieces) == (6016, 1)


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
    for method in ("blocked", "assoc"):
        for g, r in zip(extract_triggers_batched(prob, 0.5, max_picks=4, method=method),
                        extract_triggers_batched(prob, 0.5, max_picks=4, method="shift")):
            assert torch.equal(g, r)
    assert calls == [1]  # "blocked" and "assoc" are plain PyTorch
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", "assoc")
    assert default_trigger_method() == "assoc"
    for g, r in zip(extract_triggers_batched(prob, 0.5, max_picks=4),
                    extract_triggers_batched(prob, 0.5, max_picks=4, method="shift")):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="block"):
        cuda_triggers.trigger_extract_blocked(prob, torch.ones(3), torch.ones(3), 4, block=0)
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
