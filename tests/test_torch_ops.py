"""volpick_tpu_torch.ops (windows, stacking, conditioning) vs volpick_tpu.ops.

Same numpy inputs through both packages on the CPU. Tolerance: 2e-5 absolute
for anything that sums floats (the conditioning pin of tests/test_pallas.py;
the two frameworks reduce in different orders); exact for integer window
placement and for pure data movement (framing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.ops import signal as jsig
from volpick_tpu.ops import windows as jwin
from volpick_tpu_torch.ops import signal as tsig
from volpick_tpu_torch.ops import windows as twin

ATOL = 2e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize(
    "n,window,overlap", [(100, 400, 100), (400, 400, 100), (401, 400, 100), (1234, 400, 150),
                         (2000, 400, 0), (120000, 6000, 5500), (30000, 6000, 5500)]
)
def test_window_starts_equal(n, window, overlap):
    np.testing.assert_array_equal(
        twin.window_starts(n, window, overlap), jwin.window_starts(n, window, overlap)
    )


def test_window_starts_rejects_overlap_ge_window():
    with pytest.raises(ValueError):
        twin.window_starts(1000, 400, 400)


def test_framing_exact(rng):
    x = rng.normal(size=(2, 3, 1000)).astype(np.float32)
    starts = np.array([0, 100, 350, 600], dtype=np.int64)
    got = twin.frame_windows(_t(x), _t(starts), 400).numpy()
    want = np.asarray(jwin.frame_windows(jnp.asarray(x), jnp.asarray(starts), 400))
    np.testing.assert_array_equal(got, want)
    for n_win, stride, window in ((5, 100, 400), (3, 170, 400), (4, 500, 400)):
        got = twin.frame_windows_uniform(_t(x), n_win, stride, window).numpy()
        want = np.asarray(jwin.frame_windows_uniform(jnp.asarray(x), n_win, stride, window))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stacking", ["avg", "max"])
@pytest.mark.parametrize("blinding", [(0, 0), (30, 50)])
def test_overlap_stack(rng, stacking, blinding):
    preds = rng.random(size=(6, 3, 200)).astype(np.float32)
    starts = np.array([0, 60, 120, 180, 240, 310], dtype=np.int64)
    total = 510
    got = twin.overlap_stack(_t(preds), _t(starts), total, blinding, stacking).numpy()
    want = np.asarray(
        jwin.overlap_stack(jnp.asarray(preds), jnp.asarray(starts), total, blinding, stacking)
    )
    np.testing.assert_allclose(got, want, atol=ATOL)
    # leading station axis = per-station calls
    batched = twin.overlap_stack(_t(np.stack([preds, preds[::-1]])), _t(starts), total,
                                 blinding, stacking).numpy()
    np.testing.assert_allclose(batched[0], got, atol=ATOL)


@pytest.mark.parametrize("stacking", ["avg", "max"])
@pytest.mark.parametrize("stride,blinding", [(50, (0, 0)), (50, (20, 30)), (70, (10, 10)),
                                             (250, (0, 0))])
def test_overlap_stack_uniform(rng, stacking, stride, blinding):
    preds = rng.random(size=(7, 3, 200)).astype(np.float32)
    got = twin.overlap_stack_uniform(_t(preds), stride, blinding, stacking).numpy()
    want = np.asarray(jwin.overlap_stack_uniform(jnp.asarray(preds), stride, blinding, stacking))
    np.testing.assert_allclose(got, want, atol=ATOL)
    sums, wgt = twin.overlap_stack_uniform(_t(preds), stride, blinding, stacking, return_sums=True)
    jsums, jwgt = jwin.overlap_stack_uniform(
        jnp.asarray(preds), stride, blinding, stacking, return_sums=True
    )
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), atol=ATOL)
    np.testing.assert_array_equal(wgt.numpy(), np.asarray(jwgt))
    np.testing.assert_array_equal(
        twin.uniform_stack_weights(7, stride, 200, blinding, 900),
        jwin.uniform_stack_weights(7, stride, 200, blinding, 900),
    )


def test_demean_detrend_normalize(rng):
    x = (rng.normal(size=(4, 3, 700)) * 5 + np.linspace(0, 9, 700)).astype(np.float32)
    mask = rng.random(size=(4, 700)) > 0.2
    jx = jnp.asarray(x)
    np.testing.assert_allclose(tsig.demean(_t(x)).numpy(), np.asarray(jsig.demean(jx)), atol=ATOL)
    np.testing.assert_allclose(
        tsig.demean(_t(x), mask=_t(mask)).numpy(),
        np.asarray(jsig.demean(jx, mask=jnp.asarray(mask))), atol=ATOL,
    )
    np.testing.assert_allclose(
        tsig.detrend_linear(_t(x)).numpy(), np.asarray(jsig.detrend_linear(jx)), atol=ATOL
    )
    for norm in ("peak", "std"):
        for per_channel in (False, True):
            np.testing.assert_allclose(
                tsig.normalize_amplitude(_t(x), norm, per_channel=per_channel).numpy(),
                np.asarray(jsig.normalize_amplitude(jx, norm, per_channel=per_channel)),
                atol=ATOL,
            )


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
@pytest.mark.parametrize(
    "n_win,stride,window",
    [(6, 100, 400),   # stride divides the window: block-sum branch
     (3, 500, 6000),  # EQT's 6000/500 geometry
     (5, 150, 400)],  # general branch: one strided convolution
)
def test_condition_windows_from_span(rng, detrend, norm, n_win, stride, window):
    span = (n_win - 1) * stride + window
    sp = (rng.normal(size=(2, 3, span)) * 3 + np.linspace(-2, 5, span)).astype(np.float32)
    got = tsig.condition_windows_from_span(_t(sp), n_win, stride, window, detrend, norm).numpy()
    want = np.asarray(
        jsig.condition_windows_from_span(jnp.asarray(sp), n_win, stride, window, detrend, norm)
    )
    assert got.shape == (n_win, 2, 3, window)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and equal to conditioning the framed windows one by one
    fr = twin.frame_windows_uniform(_t(sp), n_win, stride, window)
    fr = tsig.detrend_linear(fr) if detrend else tsig.demean(fr)
    ref = tsig.normalize_amplitude(fr, norm, per_channel=True).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("do_demean,do_detrend", [(True, False), (False, True), (False, False), (True, True)])
@pytest.mark.parametrize("norm", ["peak", "std"])
def test_normalize_block(rng, norm, do_demean, do_detrend):
    x = (rng.normal(size=(4, 3, 700)) * 5 + np.linspace(0, 9, 700)).astype(np.float32)
    got = tsig.normalize(_t(x), norm, do_demean=do_demean, do_detrend=do_detrend).numpy()
    want = jsig.normalize(jnp.asarray(x), norm, do_demean=do_demean, do_detrend=do_detrend)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="unknown norm"):
        tsig.normalize(_t(x), "max")


@pytest.mark.parametrize("n_samples,window", [(6000, 3001), (3001, 3001), (2000, 3001), (12000, 6000)])
def test_steered_window_indices_equal(rng, n_samples, window):
    start = rng.integers(0, n_samples - 10, size=40)
    end = np.minimum(start + rng.integers(1, min(window, n_samples), size=40), n_samples)
    got = twin.steered_window_indices(n_samples, start, end, window)
    want = jwin.steered_window_indices(n_samples, start, end, window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    w0, lo, hi = got
    assert ((hi - lo) == (end - start)).all() and (lo >= 0).all()
    if n_samples >= window:
        assert (w0 >= 0).all() and (w0 + window <= n_samples).all()


@pytest.mark.parametrize("w0", [-50, 0, 120, 900, 1500])
def test_pad_frame_equal(rng, w0):
    data = rng.normal(size=(3, 1000)).astype(np.float32)
    got = twin.pad_frame(data, w0, 400)
    np.testing.assert_array_equal(got, jwin.pad_frame(data, w0, 400))
    assert got.shape == (3, 400) and got.dtype == data.dtype
