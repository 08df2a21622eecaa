"""The port's QC screen and classical pickers against the JAX package's.

- ``utils/qc.py``: ``check_waveforms`` flags exactly the traces JAX's flags,
  with a seeded PhaseNet whose heads are stretched (``stretch_heads``: seeded
  heads give flat curves) and a picker of each package on the same weights,
  on the raw and the 1-20 Hz band; the thresholds are the middles of the two
  widest gaps between the traces' largest P/S probabilities, each more than
  2e-3 wide (the PhaseNet forward pin is 2e-5), so no trace can fall on the
  other side in one package only.
  ``screen_dataset_with_models`` gives the same flags and the same CSV
  (``plot_flagged``: ``test_torch_plotting.py``).
- ``classical.py`` (a numpy copy): the Baer-Kradolfer and AR-AIC pickers,
  ``gp_maximize`` and ``tune_picker`` return exactly what JAX's return on
  the same traces and seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_utils_classical import synth_onset_trace
from tests.torch_eval_common import stretch_heads
from tests.torch_train_common import torch_alone
from volpick_tpu import classical as jcl
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu.utils import qc as jqc
from volpick_tpu_torch import classical as pcl
from volpick_tpu_torch.data.synthetic import synthetic_arrays, synthetic_dataset
from volpick_tpu_torch.models import PhaseNet
from volpick_tpu_torch.models.convert import jax_tree_from_model
from volpick_tpu_torch.ops.windows import frame_windows, window_starts
from volpick_tpu_torch.picker import WaveformPicker
from volpick_tpu_torch.utils import qc as pqc


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the CPU."""
    with torch_alone():
        yield


@pytest.fixture(scope="module")
def pickers_and_traces():
    torch.manual_seed(0)
    waves, meta = synthetic_arrays(n_events=6, n_noise=4, n_samples=4000, seed=9)
    model = PhaseNet(generator=torch.Generator().manual_seed(3)).eval()
    stretch_heads(model, torch.as_tensor(waves[:, :, :3001]))
    port = WaveformPicker(model, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_model(model))
    return port, JaxPicker(JaxPhaseNet(), params), waves, meta


def _largest_probabilities(picker, data):
    """Each trace's largest P/S probability over its half-overlapping
    windows, on the raw and the 1-20 Hz band (what check_waveforms reads)."""
    from scipy.signal import butter, sosfilt

    out = []
    window = picker.in_samples
    starts = torch.as_tensor(window_starts(data.shape[-1], window, window // 2))
    sos = butter(4, (1.0, 20.0), btype="bandpass", fs=100.0, output="sos")
    for x in (data, sosfilt(sos, data, axis=-1)):
        with torch.inference_mode():
            fr = frame_windows(torch.as_tensor(np.asarray(x, np.float32)), starts, window)
            n, b = fr.shape[:2]
            pr = picker._apply_model(picker._condition(fr.reshape(n * b, 3, window))).numpy()
        out.append(pr[:, :2].max(axis=(1, 2)).reshape(n, b).max(0))
    return np.concatenate(out)


def test_check_waveforms_flags_the_jax_traces(pickers_and_traces):
    port, jpick, waves, _ = pickers_and_traces
    srt = np.sort(_largest_probabilities(port, waves))
    gaps = np.diff(srt)
    # the middles of the two widest gaps between the traces' maxima
    for k in np.argsort(gaps)[::-1][:2]:
        assert gaps[k] > 2e-3
        thr = float(srt[k] + gaps[k] / 2)
        got = pqc.check_waveforms([port], waves, threshold=thr, batch_size=4)
        want = jqc.check_waveforms([jpick], waves, threshold=thr, batch_size=4)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)  # a threshold that splits the traces


def test_screen_dataset_matches_jax(pickers_and_traces, tmp_path):
    port, jpick, waves, meta = pickers_and_traces
    ds = synthetic_dataset(waves, meta)
    probs = _largest_probabilities(port, waves)
    srt = np.sort(probs)
    k = int(np.argmax(np.diff(srt)))  # the widest gap between traces' maxima
    thr = float((srt[k] + srt[k + 1]) / 2)
    got = pqc.screen_dataset_with_models(ds, [port], threshold=thr, out_dir=tmp_path / "p")
    want = jqc.screen_dataset_with_models(ds, [jpick], threshold=thr, out_dir=tmp_path / "j")
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    assert (tmp_path / "p" / "qc_flags.csv").read_bytes() == (tmp_path / "j" / "qc_flags.csv").read_bytes()


def test_classical_pickers_match_jax():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        z = synth_onset_trace(rng, onset=3000, snr=6 + seed)
        n = synth_onset_trace(rng, onset=3400)
        e = synth_onset_trace(rng, onset=3400)
        assert pcl.baer_kradolfer_pick(z, 100.0) == jcl.baer_kradolfer_pick(z, 100.0)
        assert pcl.baer_kradolfer_pick(z, 100.0, thr1=5.0, tupevent=0.3) == \
            jcl.baer_kradolfer_pick(z, 100.0, thr1=5.0, tupevent=0.3)
        assert pcl.ar_aic_pick(z, n, e, sampling_rate=100.0) == jcl.ar_aic_pick(z, n, e, sampling_rate=100.0)
        assert pcl.ar_aic_pick(z, sampling_rate=100.0) == jcl.ar_aic_pick(z, sampling_rate=100.0)
        assert pcl.aic_onset(z[2000:4000]) == jcl.aic_onset(z[2000:4000])
        noise = rng.normal(size=6000)
        assert pcl.baer_kradolfer_pick(noise, 100.0) == jcl.baer_kradolfer_pick(noise, 100.0)


def test_gp_maximize_and_tuner_match_jax():
    def objective(x, y):
        return -((x - 0.3) ** 2) - (y + 0.6) ** 2 + 0.1 * np.cos(5 * x)

    bounds = {"x": (-2.0, 2.0), "y": (-2.0, 2.0)}
    for seed in range(2):
        assert pcl.gp_maximize(objective, bounds, n_trials=14, seed=seed) == \
            jcl.gp_maximize(objective, bounds, n_trials=14, seed=seed)
    traces = [synth_onset_trace(np.random.default_rng(s), onset=3000, snr=10) for s in range(3)]
    space = {"thr1": (5.0, 20.0), "tupevent": (0.3, 1.0)}
    for method in ("gp", "random"):
        assert pcl.tune_picker(pcl.baer_kradolfer_pick, space, traces, [3000] * 3, n_trials=6,
                               method=method) == \
            jcl.tune_picker(jcl.baer_kradolfer_pick, space, traces, [3000] * 3, n_trials=6,
                            method=method)
