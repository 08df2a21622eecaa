"""The port's remaining signal ops and features against the JAX package's.

Inputs come from a numpy seed and go through both functions as numpy arrays:
- ``taper_cosine`` within 1e-7 of JAX's (float32; relative where |x| > 1,
  where one float32 ulp of the product is larger);
- ``sosfilt`` against scipy, the pins of ``tests/test_ops.py``: float64 within
  1e-10, float32 within 2e-3 (float32 biquads away from extreme band edges),
  and against JAX's float32 ``lax.scan`` within 2e-5;
- ``resample_poly_device`` within 1e-5 of JAX's (float32) for down-, up- and
  rational rates, and the same output length;
- ``frequency_index`` and ``snr_db`` within 1e-5 of JAX's (float32; absent
  picks give NaN in the same places), and against the numpy copies the
  port's synthetic data layer records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import sosfilt as scipy_sosfilt

from volpick_tpu.ops import features as jfeat
from volpick_tpu.ops import signal as jsig
from volpick_tpu_torch.acquisition.convert import _frequency_index_numpy, _snr_db_numpy
from volpick_tpu_torch.ops import features as pfeat
from volpick_tpu_torch.ops import signal as psig


@pytest.mark.parametrize("fraction", [0.05, 0.2, 0.0])
def test_taper_cosine_matches_jax(fraction):
    x = np.random.default_rng(0).normal(size=(2, 3, 777)).astype(np.float32)
    got = psig.taper_cosine(torch.as_tensor(x), fraction).numpy()
    want = np.asarray(jsig.taper_cosine(jnp.asarray(x), fraction))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    ones = np.ones((777,), np.float32)  # the window itself
    np.testing.assert_allclose(psig.taper_cosine(torch.as_tensor(ones), fraction).numpy(),
                               np.asarray(jsig.taper_cosine(jnp.asarray(ones), fraction)),
                               rtol=0, atol=1e-7)
    # along another axis
    got = psig.taper_cosine(torch.as_tensor(x), fraction, dim=1).numpy()
    want = np.asarray(jsig.taper_cosine(jnp.asarray(x), fraction, axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_sos_designs_are_jax_designs():
    np.testing.assert_array_equal(psig.sosfilt_coeffs_bandpass(1.0, 20.0, 100.0),
                                  jsig.sosfilt_coeffs_bandpass(1.0, 20.0, 100.0))
    np.testing.assert_array_equal(psig.sosfilt_coeffs_highpass(0.3, 100.0),
                                  jsig.sosfilt_coeffs_highpass(0.3, 100.0))


def test_sosfilt_float64_matches_scipy():
    sos = psig.sosfilt_coeffs_bandpass(1.0, 20.0, 100.0)
    x = np.random.default_rng(1).normal(size=(2, 3, 400))
    y = psig.sosfilt(torch.as_tensor(x), sos)
    assert y.dtype == torch.float64 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), scipy_sosfilt(sos, x, axis=-1), rtol=0, atol=1e-10)


def test_sosfilt_float32_matches_scipy_and_jax():
    sos = psig.sosfilt_coeffs_bandpass(5.0, 15.0, 100.0, order=2)
    x = np.random.default_rng(2).normal(size=(2, 3, 400)).astype(np.float32)
    y = psig.sosfilt(torch.as_tensor(x), sos).numpy()
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, scipy_sosfilt(sos.astype(np.float32), x, axis=-1), rtol=0, atol=2e-3)
    np.testing.assert_allclose(y, np.asarray(jsig.sosfilt(jnp.asarray(x), sos)), rtol=0, atol=2e-5)


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1), (3, 2), (4, 4)])
def test_resample_poly_device_matches_jax(up, down):
    t = np.arange(1001) / 200.0
    rng = np.random.default_rng(3)
    x = (np.sin(2 * np.pi * 5 * t) + 0.3 * rng.normal(size=(2, 3, 1001))).astype(np.float32)
    got = psig.resample_poly_device(torch.as_tensor(x), up, down).numpy()
    want = np.asarray(jsig.resample_poly_device(jnp.asarray(x), up, down))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_frequency_index_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 2, 3000)).astype(np.float32)
    x[0] += np.sin(2 * np.pi * 12.0 * np.arange(3000) / 100.0).astype(np.float32) * 3
    got = pfeat.frequency_index(torch.as_tensor(x), 0.01).numpy()
    want = np.asarray(jfeat.frequency_index(jnp.asarray(x), 0.01))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref = _frequency_index_numpy(x[1, 0].astype(np.float64), 0.01)
    np.testing.assert_allclose(got[1, 0], ref, rtol=0, atol=1e-5)


def test_snr_db_matches_jax():
    rng = np.random.default_rng(5)
    w = 3000
    x = rng.normal(size=(5, 3, w)).astype(np.float32)
    x[:, :, 1200:1800] *= 20.0
    p = np.array([1200.0, 1200.0, np.nan, 5.0, 2900.0], dtype=np.float32)
    s = np.array([1500.0, np.nan, 1500.0, 1500.0, 2995.0], dtype=np.float32)
    snr, mean = (a.numpy() for a in pfeat.snr_db(torch.as_tensor(x), torch.as_tensor(p),
                                                    torch.as_tensor(s)))
    jsnr, jmean = (np.asarray(a) for a in jfeat.snr_db(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s)))
    np.testing.assert_array_equal(np.isnan(snr), np.isnan(jsnr))
    np.testing.assert_array_equal(np.isnan(mean), np.isnan(jmean))
    np.testing.assert_allclose(snr, jsnr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-5)
    assert np.isnan(snr[2:4]).all() and np.isfinite(snr[:2]).all()
    ref, ref_mean = _snr_db_numpy(x[0].astype(np.float64), 1200.0, 1500.0, 500)
    np.testing.assert_allclose(snr[0], ref, rtol=0, atol=1e-4)
    # the percentile itself, on a ragged mask, against numpy's 'linear' method
    valid = rng.random((4, 50)) < 0.6
    v = rng.normal(size=(4, 50))
    got = pfeat._percentile95_abs(torch.as_tensor(v), torch.as_tensor(valid)).numpy()
    want = [np.percentile(np.abs(v[i][valid[i]]), 95) for i in range(4)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
