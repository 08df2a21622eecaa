"""Window conditioning of the port (``ops/cuda/conditioning.py``) and the
picker's ``use_pallas`` route vs the JAX package.

On the CPU the wrapper runs its plain twin. It is held against the Pallas
kernel ``condition_windows_pallas`` in interpret mode at 2e-5 (the pin of
the Pallas kernel against the jnp path: two-pass float32 reductions in
another order), over detrend x norm, on rows whose offset and trend are far
larger than the signal. ``WaveformPicker(use_pallas=True)`` must return
exactly the picks of the JAX picker with ``span_conditioning=False`` (its jnp
conditioning of framed windows; the JAX picker's own ``use_pallas=True``
calls the Pallas kernel without interpret mode and cannot run on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_oracle import THRESHOLDS, WINDOW, DummyNet, make_data
from tests.test_torch_picker import TorchDummyNet, _picks
from volpick_tpu.ops import signal as jsignal
from volpick_tpu.ops.pallas.conditioning import condition_windows_pallas
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.ops import signal as tsignal
from volpick_tpu_torch.ops.cuda import conditioning
from volpick_tpu_torch.picker import WaveformPicker
from volpick_tpu_torch.picker import annotate as port_annotate

ATOL = 2e-5


def _windows(rng, n, c, w):
    """Unit-variance noise on an offset and a straight line 20 to 30 times
    larger, per row."""
    t = np.linspace(-1.0, 1.0, w)
    x = rng.normal(size=(n, c, w))
    x += rng.uniform(-20, 20, (n, c, 1)) + rng.uniform(-30, 30, (n, c, 1)) * t
    return x.astype(np.float32)


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
@pytest.mark.parametrize("n,w", [(8, 6000), (16, 1000), (8, 257)])
def test_twin_matches_pallas(detrend, norm, n, w):
    x = _windows(np.random.default_rng(w + n), n, 3, w)
    before = conditioning.launches
    got = conditioning.condition_windows(torch.as_tensor(x), detrend=detrend, norm=norm).numpy()
    assert conditioning.launches == before  # a CPU tensor launches nothing
    want = np.asarray(condition_windows_pallas(jnp.asarray(x), detrend=detrend, norm=norm,
                                               interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and the jnp path the Pallas kernel was pinned to
    ref = jsignal.detrend_linear(jnp.asarray(x)) if detrend else jsignal.demean(jnp.asarray(x))
    ref = np.asarray(jsignal.normalize_amplitude(ref, norm=norm, per_channel=True))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if norm == "peak":
        np.testing.assert_allclose(np.abs(got).max(axis=-1), 1.0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.std(axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 13])  # the kernel has no tile: any N
def test_any_batch_and_the_port_s_plain_path(n):
    x = _windows(np.random.default_rng(n), n, 3, 1504)
    xt = torch.as_tensor(x)
    got = conditioning.condition_windows(xt, detrend=True, norm="peak")
    plain = tsignal.normalize_amplitude(tsignal.detrend_linear(xt), norm="peak", per_channel=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)


def test_wrapper_checks_its_arguments():
    x = torch.zeros(4, 3, 100)
    with pytest.raises(ValueError):
        conditioning.condition_windows(x[0])
    with pytest.raises(ValueError):
        conditioning.condition_windows(x, norm="rms")
    with pytest.raises(TypeError):
        conditioning.condition_windows(x.double())
    with pytest.raises(ValueError):
        conditioning.condition_windows(x.to("meta"))
    assert conditioning.MAX_SAMPLES >= 6000  # every ported model's window fits


@pytest.mark.parametrize(
    "total,overlap,blinding,detrend",
    [
        (1234, 100, (0, 0), False),    # flush window
        (987, 200, (50, 50), True),    # blinding + flush, detrended
        (1300, 200, (0, 0), True),     # stride 200 divides the window of 400: span conditioning
                                        # would apply, and must not under use_pallas
        (640, WINDOW - 5, (0, 0), False),  # stride 5: gather / scatter path
        (120, 100, (0, 0), False),     # shorter than one window
    ],
)
def test_use_pallas_picker_matches_jax_framed_conditioning(total, overlap, blinding, detrend,
                                                           monkeypatch):
    rng = np.random.default_rng(total)
    data = make_data(rng, total)
    data += np.float32(3.0) + np.linspace(0, 2, total, dtype=np.float32)  # offset and trend
    calls = []
    real = port_annotate.condition_windows
    monkeypatch.setattr(port_annotate, "condition_windows",
                        lambda x, **k: calls.append(tuple(x.shape)) or real(x, **k))

    def no_span(*a, **k):
        raise AssertionError("span conditioning ran under use_pallas")

    monkeypatch.setattr(port_annotate, "condition_windows_from_span", no_span)
    port = WaveformPicker(TorchDummyNet(), device="cpu", detrend=detrend, use_pallas=True)
    kw = dict(overlap=overlap, blinding=blinding, batch_size=8)
    got = port.classify_arrays(data[None], THRESHOLDS, **kw)
    assert calls and all(len(s) == 3 and s[1:] == (3, WINDOW) for s in calls)
    jpick = JaxPicker(DummyNet(), {}, detrend=detrend, span_conditioning=False)
    want = jpick.classify_arrays(data[None], THRESHOLDS, **kw)
    for label in ("P", "S"):
        assert _picks(got, label, total) == _picks(want, label, total)
    assert sum(len(_picks(got, label, total)) for label in ("P", "S")) > 0
    np.testing.assert_allclose(port.annotate_array(data[None], **kw),
                               jpick.annotate_array(data[None], **kw), atol=ATOL)
    # and the port's default route gives the same picks
    plain = WaveformPicker(TorchDummyNet(), device="cpu", detrend=detrend)
    monkeypatch.undo()
    res = plain.classify_arrays(data[None], THRESHOLDS, **kw)
    for label in ("P", "S"):
        assert _picks(res, label, total) == _picks(got, label, total)


# (rows, W, bulk copies possible) -> (CTAs, row buffers) on a card of 132 SMs
@pytest.mark.parametrize("rows,w,bulk,want", [
    (696, 6000, True, (348, 2)),      # EQTransformer's step: 528 slots, two rows a CTA on 348
    (6000, 6000, True, (500, 2)),     # many rows: 12 turns on 500 CTAs, none idle in the last
    (768, 3001, False, (768, 1)),     # PhaseNet's width: plain loads, one buffer, 8 CTAs an SM
    (696, 6000, False, (696, 1)),     # an unaligned x at an even width
    (3, conditioning.MAX_SAMPLES, True, (3, 1)),  # the longest row: one buffer, 4 CTAs an SM
    (900, 12000, True, (450, 1)),     # two buffers of 48 KB would leave 2 CTAs an SM
    (1, 1, True, (1, 2)),
])
def test_ring_plan(rows, w, bulk, want):
    """How the kernel's launch is cut: never more CTAs than rows, every CTA
    the same count of rows up to one, the ring inside an SM's shared memory."""
    ctas, n_buf = conditioning.ring_plan(rows, w, 132, bulk=bulk)
    assert (ctas, n_buf) == want
    turns = -(-rows // ctas)
    assert 1 <= ctas <= rows and ctas * turns >= rows > ctas * (turns - 1) - turns
    assert n_buf * 4 * w + conditioning._SMEM_PER_CTA <= 227 * 1024
