"""Merged LSTM recurrences of the port vs the JAX package.

The twins of the CUDA kernel (``ops/cuda/lstm.py::lstm_multi_reference`` and
``lstm_branches_reference``, what ``lstm_multi`` and ``lstm_branches`` run on
a CPU tensor) are held against ``volpick_tpu.models.layers`` and against the
Pallas kernel ``lstm_multi_pallas`` in interpret mode; the unit-major row
permutation of W_ih, which only the CUDA route applies, is held exactly
against the unpermuted projection. Tolerance: 1e-5 absolute, the LSTM
pin of tests/test_pallas.py (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.models import layers as jlayers
from volpick_tpu.ops.pallas.lstm import lstm_multi_pallas
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm

ATOL = 1e-5


def _weights(rng, g, c, h):
    return (
        (rng.normal(size=(g, 4 * h, c)) * 0.2).astype(np.float32),
        (rng.normal(size=(g, 4 * h, h)) * 0.2).astype(np.float32),
        (rng.normal(size=(g, 4 * h)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("g,b,c,t,h", [(2, 4, 64, 47, 16), (2, 5, 16, 47, 16), (3, 2, 16, 31, 8)])
def test_lstm_multi_matches_jax_and_pallas(rng, g, b, c, t, h):
    xs = rng.normal(size=(g, b, c, t)).astype(np.float32)
    w_ih, w_hh, bias = _weights(rng, g, c, h)
    before = cuda_lstm.launches
    got = cuda_lstm.lstm_multi(*(torch.as_tensor(a) for a in (xs, w_ih, w_hh, bias))).numpy()
    assert cuda_lstm.launches == before  # a CPU tensor never reaches the kernel
    assert got.shape == (g, b, h, t)
    jargs = [jnp.asarray(a) for a in (xs, w_ih, w_hh, bias)]
    np.testing.assert_allclose(got, np.asarray(jlayers.lstm_multi(*jargs)), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(lstm_multi_pallas(*jargs, interpret=True)), atol=ATOL)


@pytest.mark.parametrize("c", [64, 16])
def test_bilstm_and_lstm_match_jax_unfused(rng, c):
    h = 16
    p = {}
    for suf in ("", "_rev"):
        w_ih, w_hh, bias = _weights(rng, 1, c, h)
        p[f"w_ih{suf}"], p[f"w_hh{suf}"] = w_ih[0], w_hh[0]
        p[f"b_ih{suf}"] = bias[0]
        p[f"b_hh{suf}"] = (rng.normal(size=4 * h) * 0.1).astype(np.float32)
    x = rng.normal(size=(3, c, 47)).astype(np.float32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = tlayers.bilstm(torch.as_tensor(x), tp).numpy()
    want = np.asarray(jlayers.bilstm(jnp.asarray(x), jp, fused=False))
    assert got.shape == (3, 2 * h, 47)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for reverse, suf in ((False, ""), (True, "_rev")):
        args = [p[f"{k}{suf}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
        got = tlayers.lstm(torch.as_tensor(x), *(torch.as_tensor(a) for a in args), reverse=reverse)
        want = jlayers.lstm(jnp.asarray(x), *(jnp.asarray(a) for a in args), reverse=reverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("reverse", [(False, True), (True,), (False, False, True)])
@pytest.mark.parametrize("c,t,h", [(64, 47, 16), (16, 31, 8)])
def test_lstm_branches_twin_matches_jax_and_pallas(rng, reverse, c, t, h):
    """G LSTMs over one x, branch g scanning backward where reverse[g], states
    as (B, G*H, T): against ``volpick_tpu.models.layers.lstm`` a branch and the
    Pallas kernel on the stacked, flipped input it replaces."""
    g, b = len(reverse), 3
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    w_ih, w_hh, bias = _weights(rng, g, c, h)
    before = cuda_lstm.launches
    got = cuda_lstm.lstm_branches(
        *(torch.as_tensor(a) for a in (x, w_ih, w_hh, bias)), reverse=reverse).numpy()
    assert cuda_lstm.launches == before  # a CPU tensor never reaches the kernel
    assert got.shape == (b, g * h, t)
    zeros = jnp.zeros(4 * h)
    for i, r in enumerate(reverse):
        want = jlayers.lstm(jnp.asarray(x), jnp.asarray(w_ih[i]), jnp.asarray(w_hh[i]),
                            jnp.asarray(bias[i]), zeros, reverse=r)
        np.testing.assert_allclose(got[:, i * h:(i + 1) * h], np.asarray(want), atol=ATOL)
    xs = np.stack([x[..., ::-1] if r else x for r in reverse])
    hs = np.asarray(lstm_multi_pallas(*(jnp.asarray(a) for a in (xs, w_ih, w_hh, bias)), interpret=True))
    old = np.concatenate([hs[i][..., ::-1] if r else hs[i] for i, r in enumerate(reverse)], axis=1)
    np.testing.assert_allclose(got, old, atol=ATOL)


@pytest.mark.parametrize("c", [64, 16])
def test_bilstm_matches_jax_fused_and_pallas(rng, c):
    """The port's ``bilstm`` (one ``lstm_branches`` call, no stack, flips or
    concatenation) against ``layers.bilstm`` on its merged route and against
    the Pallas kernel under that route."""
    h = 16
    p = {}
    for suf in ("", "_rev"):
        w_ih, w_hh, bias = _weights(rng, 1, c, h)
        p[f"w_ih{suf}"], p[f"w_hh{suf}"], p[f"b_ih{suf}"] = w_ih[0], w_hh[0], bias[0]
        p[f"b_hh{suf}"] = (rng.normal(size=4 * h) * 0.1).astype(np.float32)
    x = rng.normal(size=(3, c, 47)).astype(np.float32)
    got = tlayers.bilstm(torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()}).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(got, np.asarray(jlayers.bilstm(jnp.asarray(x), jp, fused=True)), atol=ATOL)
    xs = jnp.stack([jnp.asarray(x), jnp.asarray(x[..., ::-1])])
    hs = np.asarray(lstm_multi_pallas(
        xs, jnp.stack([jp["w_ih"], jp["w_ih_rev"]]), jnp.stack([jp["w_hh"], jp["w_hh_rev"]]),
        jnp.stack([jp["b_ih"] + jp["b_hh"], jp["b_ih_rev"] + jp["b_hh_rev"]]), interpret=True))
    np.testing.assert_allclose(got, np.concatenate([hs[0], hs[1][..., ::-1]], axis=1), atol=ATOL)


@pytest.mark.parametrize("g,c,h", [(2, 64, 16), (3, 16, 8), (1, 7, 5)])
def test_unit_major_rows_permute_the_projection_exactly(rng, g, c, h):
    """Row 4u + gate of ``unit_major(w)`` is row gate*H + u of w, so the
    projection against the permuted W_ih is the unpermuted projection with its
    columns in that order, bit for bit, in both CUDA-side layouts."""
    w_ih, _, bias = (torch.as_tensor(a) for a in _weights(rng, g, c, h))
    um = cuda_lstm.unit_major(w_ih)
    assert um.shape == w_ih.shape
    for gate in range(4):
        for u in range(h):
            assert torch.equal(um[:, 4 * u + gate], w_ih[:, gate * h + u])
    assert torch.equal(cuda_lstm.unit_major(bias).reshape(g, h, 4)[:, :, 2], bias[:, 2 * h:3 * h])
    b, t = 3, 11
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32))
    plain = torch.einsum("bct,gkc->btgk", x, w_ih)  # (B, T, G, 4H) gate-major
    want = plain.reshape(b, t, g, 4, h).transpose(3, 4).reshape(b, t, g * 4 * h)
    assert torch.equal(cuda_lstm.project_shared(x, w_ih), want)
    xs = x.unsqueeze(0).expand(g, b, c, t)
    want_multi = plain.permute(2, 0, 1, 3).reshape(g, b, t, 4, h).transpose(3, 4).reshape(g, b, t, 4 * h)
    assert torch.equal(cuda_lstm.project(xs, w_ih), want_multi)


def test_wrapper_rejects_bad_input(rng):
    xs = torch.zeros(2, 3, 16, 5)
    w_ih, w_hh, bias = (torch.as_tensor(a) for a in _weights(rng, 2, 16, 16))
    with pytest.raises(TypeError):
        cuda_lstm.lstm_multi(xs.double(), w_ih, w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih[:, :, :8], w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias[:1])
    with pytest.raises(ValueError):
        cuda_lstm.lstm_branches(xs[0], w_ih, w_hh, bias, reverse=(False,))  # 2 weight sets, 1 flag
    with pytest.raises(ValueError):
        cuda_lstm.lstm_branches(xs, w_ih, w_hh, bias, reverse=(False, True))  # x is not (B, C, T)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_branches(xs[0].double(), w_ih, w_hh, bias, reverse=(False, True))
