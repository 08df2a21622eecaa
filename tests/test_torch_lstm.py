"""Merged LSTM recurrences of the port vs the JAX package.

The twin of the CUDA kernel (``ops/cuda/lstm.py::lstm_multi_reference``, what
``lstm_multi`` runs on a CPU tensor) is held against
``volpick_tpu.models.layers.lstm_multi`` and against the Pallas kernel
``lstm_multi_pallas`` in interpret mode. Tolerance: 1e-5 absolute, the LSTM
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


def test_wrapper_rejects_bad_input(rng):
    xs = torch.zeros(2, 3, 16, 5)
    w_ih, w_hh, bias = (torch.as_tensor(a) for a in _weights(rng, 2, 16, 16))
    with pytest.raises(TypeError):
        cuda_lstm.lstm_multi(xs.double(), w_ih, w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih[:, :, :8], w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias[:1])
