"""Merged LSTM recurrences of the port vs the JAX package.

The twins of the CUDA kernel (``ops/cuda/lstm.py::lstm_multi_reference`` and
``lstm_branches_reference``, what ``lstm_multi`` and ``lstm_branches`` run on
a CPU tensor) are held against ``volpick_tpu.models.layers`` and against the
Pallas kernel ``lstm_multi_pallas`` in interpret mode; the unit-major row
permutation of W_ih, which only the CUDA route applies, is held exactly
against the unpermuted projection. Tolerance: 1e-5 absolute, the LSTM
pin of tests/test_pallas.py (float32 sums in another order).

The bf16 twins are held against JAX's own kernel body (``_kernel`` and
``_pack_whh`` through ``pl.pallas_call`` in interpret mode) fed the
projection as ``lstm_multi_pallas`` forms it in bf16, bf16(bf16(x . W_ih) +
b): within one bf16 ulp (|d| <= 2^-7 |want| + 1e-6) everywhere at C 64 and
C 16. ``lstm_multi_pallas`` itself cannot run on bf16 operands: its kernel
stores a float32 h into the bf16 output (a fault of the reference package),
so the test restates its projection and gives ``pallas_call`` a float32
output, cast to bf16 after, the evident meaning of the kernel. Where XLA's
einsum and PyTorch's matmul round a projection sum differently (here 8 and 4
of 144,384 gate inputs are off the correctly rounded product), a state can
lie two ulps away: with both branches reading x and the second reversed,
one element of 36,096 at C 64 does. So the bidirectional form is held as
what it is, the stacked lstm_multi twin on the flipped input, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from volpick_tpu.models import layers as jlayers
from volpick_tpu.ops.pallas.lstm import _kernel, _pack_whh, lstm_multi_pallas
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


def _pallas_bf16(xs, w_ih, w_hh, bias):
    """JAX's kernel body on bf16 operands: the projection restated from
    ``lstm_multi_pallas`` (a bf16 einsum plus the bias in bf16), the output
    float32 and cast to bf16 after (``lstm_multi_pallas`` stores float32 h
    into a bf16 output and raises)."""
    g, b, _, t = xs.shape
    h = w_hh.shape[-1]
    proj = jnp.einsum("gkc,gbct->tgkb", w_ih, xs) + bias[None, :, :, None]
    xp = proj.reshape(t, g, 4, h, b).transpose(0, 2, 1, 3, 4).reshape(t, 4 * g * h, b)
    out = pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((t, g * h, b), jnp.float32),
        scratch_shapes=[pltpu.VMEM((g * h, b), jnp.float32), pltpu.VMEM((g * h, b), jnp.float32)],
        interpret=True,
    )(xp, _pack_whh(w_hh))
    return np.asarray(out.astype(jnp.bfloat16).astype(jnp.float32)).reshape(t, g, h, b).transpose(1, 3, 2, 0)


def _within_one_bf16_ulp(got, want):
    d = np.abs(got - want)
    over = d > 2.0 ** -7 * np.abs(want) + 1e-6
    assert not over.any(), f"{int(over.sum())} of {d.size} beyond one bf16 ulp, largest |d| {d.max():.3e}"


@pytest.mark.parametrize("c", [64, 16])
def test_bf16_twins_match_jax_kernel(c):
    """The bf16 twins add the bias in bf16, as JAX's projection does: within
    one bf16 ulp of JAX's kernel (G 2, B 24, H 16, T 47, weights drawn as
    chip_smoke.py draws them). The parent's twin added it in float32 and had
    2,406 (C 64) / 2,512 (C 16) elements beyond."""
    g, b, t, h = 2, 24, 47, 16
    rng = np.random.default_rng(c)
    xs = rng.normal(size=(g, b, c, t)).astype(np.float32)
    w_ih = rng.uniform(-0.25, 0.25, (g, 4 * h, c)).astype(np.float32)
    w_hh = rng.uniform(-0.25, 0.25, (g, 4 * h, h)).astype(np.float32)
    bias = (rng.normal(size=(g, 4 * h)) * 0.1).astype(np.float32)
    to16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    got = cuda_lstm.lstm_multi(*(to16(a) for a in (xs, w_ih, w_hh, bias)))
    assert got.dtype == torch.bfloat16 and got.shape == (g, b, h, t)
    _within_one_bf16_ulp(got.float().numpy(), _pallas_bf16(*(j16(a) for a in (xs, w_ih, w_hh, bias))))
    # both branches over one x (the pick LSTMs' form)
    x = xs[0]
    got = cuda_lstm.lstm_branches(*(to16(a) for a in (x, w_ih, w_hh, bias)), reverse=(False, False))
    want = _pallas_bf16(*(j16(a) for a in (np.stack([x, x]), w_ih, w_hh, bias)))
    _within_one_bf16_ulp(got.float().numpy(), np.concatenate([want[0], want[1]], axis=1))
    # the bidirectional form: the stacked twin on the flipped input, bit for bit
    args = [to16(a) for a in (w_ih, w_hh, bias)]
    hs = cuda_lstm.lstm_multi_reference(torch.stack([to16(x), to16(x).flip(-1)]), *args)
    assert torch.equal(cuda_lstm.lstm_branches(to16(x), *args, reverse=(False, True)),
                       torch.cat([hs[0], hs[1].flip(-1)], dim=1))


def test_reference_kernel_refuses_bf16():
    """``lstm_multi_pallas`` on bf16 operands raises: its kernel stores the
    float32 h into the bf16 output. When the reference package is repaired
    this test fails and says so."""
    a = [jnp.zeros(shape, jnp.bfloat16) for shape in ((2, 3, 16, 5), (2, 64, 16), (2, 64, 16), (2, 64))]
    with pytest.raises(ValueError, match="dtype"):
        lstm_multi_pallas(*a, interpret=True)
