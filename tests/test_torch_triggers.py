"""Trigger extraction of the port vs the JAX package: exact equality.

The twin of the CUDA kernel (``ops/cuda/triggers.py::trigger_extract_reference``,
what ``extract_triggers_batched`` runs on a CPU tensor) is held against
``volpick_tpu.ops.triggers.extract_triggers_batched(method="blocked")``,
against the Pallas kernel ``trigger_extract_pallas`` in interpret mode, and
against the numpy oracle. Tolerance: none; all five outputs must be equal.

The port's host oracle ``picks_from_prob_numpy`` returns exactly JAX's on
the rows built around piece boundaries and on the edge rows.

``trigger_extract_pieces`` (the kernel's way of counting: a row in pieces, per
piece a summary, the emissions that are sure and one pending bit, slots from
the resolved counts) is held to the twin and to the JAX package for every
piece length, on noise and on rows built around piece boundaries.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.ops.pallas.triggers import trigger_extract_pallas
from volpick_tpu.ops.triggers import extract_triggers_batched as jax_extract
from volpick_tpu.ops.triggers import picks_from_prob_numpy, trigger_onset_numpy
from volpick_tpu_torch.ops.cuda import triggers as cuda_triggers
from volpick_tpu_torch.ops.triggers import extract_triggers_batched
from volpick_tpu_torch.ops.triggers import picks_from_prob_numpy as port_picks_from_prob


def edge_curves(rng, w, k):
    """Rows that stress the segmented scan: runs crossing every multiple of
    `seg` (a thread's segment in the CUDA kernel), a run touching the row end,
    more than k runs, a dense alternating row, a row that never triggers, a
    run opening at sample 0, plateaus (argmax ties) and noise."""
    rows = []
    seg = max(1, -(-w // 1024))
    r = np.full(w, 0.1, np.float32)
    for b in range(seg, w, seg):
        r[max(b - 2, 0) : b + 2] = 0.9
    rows.append(r)
    r = np.full(w, 0.1, np.float32)
    r[max(w - 7, 0) :] = np.linspace(0.4, 0.95, 7)[-min(w, 7) :]
    rows.append(r)
    r = np.full(w, 0.05, np.float32)
    r[3::7] = 0.8  # ~w/7 separate runs, far more than k
    rows.append(r)
    rows.append(np.where(np.arange(w) % 2 == 0, 0.9, 0.0).astype(np.float32))  # dense
    rows.append(np.full(w, 0.2, np.float32))  # never above t1
    r = np.full(w, 0.1, np.float32)
    head = [0.9, 0.9, 0.6, 0.9, 0.3]  # run at sample 0, tie inside it
    r[: min(w, 5)] = head[: min(w, 5)]
    mid = [0.3, 0.6, 0.7, 0.7, 0.7, 0.4, 0.26, 0.6, 0.2]
    n = min(len(mid), w - w // 2)
    r[w // 2 : w // 2 + n] = mid[:n]
    rows.append(r)
    rows.append(rng.random(w).astype(np.float32))
    rows.append(np.clip(np.cumsum(rng.normal(size=w)) * 0.05 + 0.3, 0, 1).astype(np.float32))
    return np.stack(rows)


def torch_picks(prob, t1, t2=None, k=16):
    out = extract_triggers_batched(torch.as_tensor(prob), torch.as_tensor(t1),
                                   None if t2 is None else torch.as_tensor(t2), max_picks=k)
    return [a.numpy() for a in out]


def assert_same(got, want):
    names = ("peak_idx", "peak_val", "valid", "onset", "offset")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("w,k", [(1, 4), (7, 4), (2100, 16), (2600, 80)])
def test_edge_rows_match_blocked_and_pallas(rng, w, k):
    prob = edge_curves(rng, w, k)
    t1 = np.full(prob.shape[0], 0.5, np.float32)
    got = torch_picks(prob, t1, k=k)
    if k <= w:  # the blocked scan's top_k needs k <= W; the Pallas kernel pads
        assert_same(got, jax_extract(jnp.asarray(prob), jnp.asarray(t1), max_picks=k,
                                     method="blocked"))
    if w <= 2100:  # the interpreted Pallas kernel costs seconds per shape
        assert_same(got, trigger_extract_pallas(
            jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t1) / 2.0, max_picks=k, chunk=1024,
            interpret=True,
        ))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_per_row_thresholds(seed):
    rng = np.random.default_rng(seed)
    b, w, k = 12, 2000, (1, 9, 40)[seed % 3]  # few shapes: JAX compiles once per shape
    smooth = np.ones(int(rng.integers(1, 30))) / 1.0
    prob = np.stack([
        np.convolve(rng.random(w), smooth / smooth.size, mode="same") for _ in range(b)
    ]).astype(np.float32)
    t1 = rng.uniform(0.3, 0.8, size=b).astype(np.float32)
    t2 = (t1 * rng.uniform(0.3, 1.0, size=b)).astype(np.float32)
    for thr2 in (None, t2):
        got = torch_picks(prob, t1, thr2, k=k)
        want = jax_extract(jnp.asarray(prob), jnp.asarray(t1),
                           None if thr2 is None else jnp.asarray(thr2),
                           max_picks=k, method="blocked")
        assert_same(got, want)
        # the numpy oracle, row by row
        for i in range(b):
            t2i = float(np.float32(t1[i]) / np.float32(2.0)) if thr2 is None else float(thr2[i])
            pk, val = picks_from_prob_numpy(prob[i].astype(np.float64), float(t1[i]), t2i)
            trig = trigger_onset_numpy(prob[i], float(t1[i]), t2i)
            n = min(len(pk), k)
            assert got[2][i].sum() == n
            np.testing.assert_array_equal(got[0][i, :n], pk[:n])
            np.testing.assert_array_equal(got[1][i, :n], val[:n].astype(np.float32))
            np.testing.assert_array_equal(got[3][i, :n], [t[0] for t in trig[:n]])
            np.testing.assert_array_equal(got[4][i, :n], [t[1] for t in trig[:n]])


@functools.lru_cache(maxsize=None)
def _noise_case(w, k):
    """Edge rows and smoothed-noise rows of width w with per-row thresholds,
    the twin's picks and, where the blocked scan takes the shape, JAX's."""
    rng = np.random.default_rng(1000 * w + k)
    rows = [edge_curves(rng, w, k)]
    for width in (1, min(5, w), min(40, w)):
        x = np.stack([np.convolve(rng.random(w), np.ones(width) / width, mode="same")
                      for _ in range(3)])
        rows.append(((x - x.min()) / (x.max() - x.min() + 1e-9)).astype(np.float32))
    prob = np.concatenate(rows)
    b = prob.shape[0]
    t1 = np.full(b, 0.5, np.float32)
    t1[8:] = rng.uniform(0.3, 0.8, b - 8).astype(np.float32)
    t2 = (t1 * np.float32(0.5)).astype(np.float32)
    want = [a.numpy() for a in cuda_triggers.trigger_extract_reference(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), k)]
    theirs = None
    if k <= w:  # the blocked scan's top_k needs k <= W
        theirs = [np.asarray(a) for a in jax_extract(
            jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2), max_picks=k, method="blocked")]
    return prob, t1, t2, want, theirs


def _pieces(prob, t1, t2, k, piece):
    return [a.numpy() for a in cuda_triggers.trigger_extract_pieces(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), k, piece)]


@pytest.mark.parametrize("k", [1, 4, 80])
@pytest.mark.parametrize("w", [1, 7, 2100, 2600])
@pytest.mark.parametrize("piece", [1, 7, 128, 1408, 10**6])
def test_pieces_equal_twin_and_jax_on_noise(piece, w, k):
    prob, t1, t2, want, theirs = _noise_case(w, k)
    got = _pieces(prob, t1, t2, k, piece)
    assert_same(got, want)
    for g, a in zip(got, want):
        assert g.dtype == a.dtype
    if theirs is not None:
        assert_same(got, theirs)


TRAPS = ("pending_true", "pending_false", "spans_three_pieces", "ends_at_piece_last_sample",
         "touches_row_end", "k_cut_inside_piece", "k_cut_at_piece_boundary", "exactly_k_picks",
         "dense_alternating", "never_triggers", "one_run_never_crossing")


def trap_row(name, p):
    """(row of 5 p + 3 samples, K) for pieces of p >= 7 samples; thresholds
    0.5 / 0.25."""
    w = 5 * p + 3
    r = np.full(w, 0.1, np.float32)
    k = 4
    if name in ("pending_true", "pending_false"):
        # open at the start of piece 1, ends there without crossing t1 in it;
        # a later pick must keep its slot either way
        r[p - 3 : p + 3] = 0.4
        if name == "pending_true":
            r[p - 2] = 0.9
        r[3 * p + 1 : 3 * p + 3] = 0.8
    elif name == "spans_three_pieces":
        r[p - 2 : 2 * p + 2] = 0.4
        r[p + p // 2] = 0.9  # crosses t1 in the middle piece
        r[2 * p] = 0.9  # a tie in the last piece: the first occurrence wins
        r[4 * p : 4 * p + 2] = 0.7
    elif name == "ends_at_piece_last_sample":
        r[p + 2 : 2 * p] = 0.9
        r[3 * p : 3 * p + 2] = 0.6  # and one that opens at a piece's first sample
    elif name == "touches_row_end":
        r[w - p - 2 :] = np.linspace(0.3, 0.95, p + 2)
    elif name == "k_cut_inside_piece":
        r[[p + 1, p + 3, p + 5, 3 * p]] = 0.9
        k = 2
    elif name in ("k_cut_at_piece_boundary", "exactly_k_picks"):
        # the second pick is the last run end of piece 1, the third the first of piece 2
        r[[p + 1, 2 * p - 2, 2 * p - 1, 2 * p + 1]] = 0.9
        k = 2 if name == "k_cut_at_piece_boundary" else 3
    elif name == "dense_alternating":
        r = np.where(np.arange(w) % 2 == 0, 0.9, 0.0).astype(np.float32)
        k = 80
    elif name == "never_triggers":
        r[:] = 0.2
    elif name == "one_run_never_crossing":
        r[:] = 0.3  # pending in every piece, resolved false in each
    return r, k


@pytest.mark.parametrize("name", TRAPS)
@pytest.mark.parametrize("piece", [7, 128, 1408])
def test_pieces_equal_twin_and_jax_on_trap_rows(piece, name):
    row, k = trap_row(name, piece)
    prob = row[None]
    t1, t2 = np.float32([0.5]), np.float32([0.25])
    want = [a.numpy() for a in cuda_triggers.trigger_extract_reference(
        torch.as_tensor(prob), torch.as_tensor(t1), torch.as_tensor(t2), k)]
    for length in (piece, piece - 1, 3 * piece):  # the boundaries where the row was built, and off them
        assert_same(_pieces(prob, t1, t2, k, length), want)
    if k <= row.size:
        assert_same(want, jax_extract(jnp.asarray(prob), jnp.asarray(t1), jnp.asarray(t2),
                                      max_picks=k, method="blocked"))
    # what the rows are for
    n = int(want[2].sum())
    expect = {"pending_true": 2, "pending_false": 1, "spans_three_pieces": 2,
              "ends_at_piece_last_sample": 2, "touches_row_end": 1, "k_cut_inside_piece": 2,
              "k_cut_at_piece_boundary": 2, "exactly_k_picks": 3, "dense_alternating": min(80, (row.size + 1) // 2),
              "never_triggers": 0, "one_run_never_crossing": 0}[name]
    assert n == expect
    if name == "spans_three_pieces":
        assert want[0][0, 0] == piece + piece // 2 and want[4][0, 0] == 2 * piece + 1


def test_pieces_rejects_bad_input():
    prob = torch.rand(3, 50)
    with pytest.raises(ValueError):
        cuda_triggers.trigger_extract_pieces(prob, torch.ones(3), torch.ones(3), 4, 0)
    with pytest.raises(TypeError):
        cuda_triggers.trigger_extract_pieces(prob.double(), torch.ones(3), torch.ones(3), 4, 8)


def test_scalar_threshold_and_cpu_dispatch(rng):
    prob = edge_curves(rng, 900, 8)
    before = cuda_triggers.launches
    got = torch_picks(prob, 0.5, k=8)  # scalar threshold, t2 = 0.5 / 2 in float32
    assert cuda_triggers.launches == before  # a CPU tensor never reaches the kernel
    assert_same(got, jax_extract(jnp.asarray(prob), 0.5, max_picks=8, method="blocked"))
    ref = cuda_triggers.trigger_extract_reference(
        torch.as_tensor(prob), torch.full((prob.shape[0],), 0.5), torch.full((prob.shape[0],), 0.25), 8
    )
    assert_same(got, [a.numpy() for a in ref])
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32 and got[2].dtype == bool


def test_wrapper_rejects_bad_input():
    prob = torch.rand(3, 50)
    with pytest.raises(TypeError):
        cuda_triggers.trigger_extract(prob.double(), torch.ones(3), torch.ones(3), 4)
    with pytest.raises(ValueError):
        cuda_triggers.trigger_extract(prob, torch.ones(2), torch.ones(3), 4)
    with pytest.raises(ValueError):
        cuda_triggers.trigger_extract(prob, torch.ones(3), torch.ones(3), 0)


@pytest.mark.parametrize("name", TRAPS)
@pytest.mark.parametrize("piece", [7, 128])
def test_picks_from_prob_numpy_equals_jax_on_trap_rows(piece, name):
    row, _ = trap_row(name, piece)
    rows = [row] + list(edge_curves(np.random.default_rng(piece), row.size, 4))
    for r in rows:
        for thres, thres2 in ((0.5, None), (0.5, 0.25), (0.35, 0.3), (0.95, None)):
            got, want = port_picks_from_prob(r, thres, thres2), picks_from_prob_numpy(r, thres, thres2)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    n = len(port_picks_from_prob(row, 0.5)[0])
    assert n == {"pending_true": 2, "pending_false": 1, "spans_three_pieces": 2, "ends_at_piece_last_sample": 2,
                 "touches_row_end": 1, "k_cut_inside_piece": 4, "k_cut_at_piece_boundary": 3,
                 "exactly_k_picks": 3, "dense_alternating": (row.size + 1) // 2, "never_triggers": 0,
                 "one_run_never_crossing": 0}[name]
