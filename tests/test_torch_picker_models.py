"""WaveformPicker of the port vs the JAX picker on PhaseNet, TPUPickNet and
VolEQTransformer.

Each model is initialised by JAX and carried over with ``models/convert.py``;
both pickers annotate and classify the same two-station stream (a flush
window included). Curves agree within the model's forward pin (PhaseNet and
TPUPickNet 2e-5, VolEQTransformer 2e-4). Picks and detections must be
exactly the JAX picker's: thresholds are taken from the curves, away from
every curve sample by ten times the largest curve difference, so no sample
can fall on the other side of a threshold in one package only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_picker import _eqt_stream
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.models import TPUPickNet as JaxTPUPickNet
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.models import PhaseNet, TPUPickNet, VolEQTransformer
from volpick_tpu_torch.models.convert import (
    phasenet_state_dict_from_jax,
    tpupicknet_state_dict_from_jax,
    voleqtransformer_state_dict_from_jax,
)
from volpick_tpu_torch.picker import WaveformPicker

TPN_SMALL = dict(in_samples=512, d_model=32, n_heads=2, n_layers=1)
VOL_SMALL = dict(in_samples=1504, lstm_blocks=1)

# name: (JAX class, port class, converter, model kwargs, overlap, blinding, stream samples, curve pin)
CASES = {
    "phasenet": (JaxPhaseNet, PhaseNet, phasenet_state_dict_from_jax, {}, 1500, (0, 0), 9000, 2e-5),
    "tpupicknet-xla": (JaxTPUPickNet, TPUPickNet, tpupicknet_state_dict_from_jax,
                       dict(TPN_SMALL, attn="xla"), 256, (50, 50), 2300, 2e-5),
    "tpupicknet-pallas": (JaxTPUPickNet, TPUPickNet, tpupicknet_state_dict_from_jax,
                          dict(TPN_SMALL, attn="pallas"), 256, (50, 50), 2300, 2e-5),
    "voleqtransformer": (JaxVolEQT, VolEQTransformer, voleqtransformer_state_dict_from_jax,
                         VOL_SMALL, 1128, (200, 200), 4100, 2e-4),
}


def _threshold(values: np.ndarray, q: float, margin: float) -> float:
    """A threshold near the q-quantile with every sample farther than
    `margin` from both it and its half (the trigger's off threshold)."""
    vals = np.sort(values.ravel().astype(np.float64))
    for cand in np.quantile(vals, np.linspace(q, 0.9995, 400)):
        if all(np.abs(vals - t).min() > margin for t in (cand, cand / 2)):
            return float(np.float32(cand))
    raise AssertionError("no threshold with the margin near the quantile")


def _events(out):
    picks = [(p.trace_id, p.phase, p.start_time.timestamp, p.end_time.timestamp,
              p.peak_time.timestamp) for p in out.picks]
    dets = [(d.trace_id, d.start_time.timestamp, d.end_time.timestamp) for d in out.detections]
    return picks, dets


@pytest.mark.parametrize("case", sorted(CASES))
def test_classify_matches_jax_picker(case):
    jcls, pcls, convert, margs, overlap, blinding, n, pin = CASES[case]
    jmodel = jcls(**margs)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(7)))
    model = pcls(**margs)
    model.load_state_dict(convert(params), strict=True)
    port = WaveformPicker(model, device="cpu")
    jpick = JaxPicker(jmodel, jax.tree_util.tree_map(jnp.asarray, params))
    channels = port._prob_channels()
    assert channels == jpick._prob_channels()
    assert port.detrend == jpick.detrend

    stream = _eqt_stream(np.random.default_rng(n), n)
    kw = dict(overlap=overlap, blinding=blinding, batch_size=8)
    arrays = np.stack([g[1] for g in port._group_arrays(stream)])
    curves = port.annotate_array(arrays, **kw)
    jcurves = jpick.annotate_array(arrays, **kw)
    assert curves.shape == jcurves.shape == (2, len(channels), n)
    np.testing.assert_allclose(curves, jcurves, atol=pin)

    margin = 10 * float(np.abs(curves - jcurves).max()) + 1e-7
    thr = {lab: _threshold(jcurves[:, i], 0.99, margin)
           for i, lab in enumerate(channels) if not lab.startswith("Detection") and lab != "N"}
    det_rows = [i for i, lab in enumerate(channels) if lab.startswith("Detection")]
    det = _threshold(jcurves[:, det_rows], 0.99, margin) if det_rows else None
    out = port.classify(stream, P_threshold=thr["P"], S_threshold=thr["S"],
                        detection_threshold=det, **kw)
    jout = jpick.classify(stream, P_threshold=thr["P"], S_threshold=thr["S"],
                          detection_threshold=det, **kw)
    assert out.creator == jout.creator == model.name
    picks, dets = _events(out)
    assert len(picks) > 0 and {p[1] for p in picks} <= {"P", "S"}
    assert (picks, dets) == _events(jout)
    np.testing.assert_allclose([p.peak_value for p in out.picks],
                               [p.peak_value for p in jout.picks], atol=pin)
    if det_rows:
        assert len(dets) > 0

    ann = port.annotate(stream, **kw)
    assert {tr.stats.channel for tr in ann} == {f"{model.name}_{lab}" for lab in channels}


def test_voleqt_windows_are_demeaned_as_in_jax():
    """The JAX picker detrends only models named "EQTransformer"; the port
    keeps that rule, so VolEQTransformer windows are demeaned."""
    assert WaveformPicker(VolEQTransformer(**VOL_SMALL), device="cpu").detrend is False
    assert JaxPicker(JaxVolEQT(**VOL_SMALL), {}).detrend is False
    assert WaveformPicker(PhaseNet(), device="cpu").detrend is False
