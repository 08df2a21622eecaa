"""The port's ``utils/plotting.py`` against the JAX package's: the arrays each
figure draws, not its pixels.

- ``plot_prediction_examples`` on the seeded initial parameters of the
  port's model, handed to the JAX model as its tree by the converter
  (``jax_tree_from_model``; the same initialisers as ``model.init``, whose
  un-jitted run alone takes 9-19 s on the CPU), on the same in-memory
  traces: the conditioned waveform panels exactly, the probability curves
  within 2e-4 (EQTransformer) and 2e-5 (PhaseNet), the forward pins of
  ``tests/test_torch_eqtransformer.py`` / ``test_torch_phasenet.py``; the
  true-pick markers, labels and titles exactly; ``_prediction_arrays`` is
  what the panels draw; the saved files carry JAX's names;
- ``plot_waveform`` (with its spectrograms), ``plot_spectrum`` and
  ``plot_loss_curves``: every line and image exactly
  (``tests/test_utils_classical.py``'s plotting tests as the templates);
- ``plot_waveforms`` / ``plot_spectra`` / ``plot_spectrograms`` on miniSEED
  files: the same file names and the same JPEG bytes as JAX's;
- ``screen_dataset_with_models(plot_flagged=True)`` writes the
  ``flagged_*.png`` files JAX's writes, on a stretched PhaseNet at a
  threshold in the widest gap between the traces' largest probabilities.
"""

import jax
import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from tests.test_torch_qc_classical import _largest_probabilities  # noqa: E402
from tests.torch_eval_common import stretch_heads  # noqa: E402
from tests.torch_train_common import torch_alone  # noqa: E402
from volpick_tpu.models import EQTransformer as JaxEQT  # noqa: E402
from volpick_tpu.models import PhaseNet as JaxPhaseNet  # noqa: E402
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker  # noqa: E402
from volpick_tpu.utils import plotting as jplot  # noqa: E402
from volpick_tpu.utils import qc as jqc  # noqa: E402
from volpick_tpu_torch.data.synthetic import synthetic_arrays, synthetic_dataset  # noqa: E402
from volpick_tpu_torch.models import EQTransformer, PhaseNet  # noqa: E402
from volpick_tpu_torch.models.convert import jax_tree_from_model  # noqa: E402
from volpick_tpu_torch.picker import WaveformPicker  # noqa: E402
from volpick_tpu_torch.pipeline.generator import _onset_arrays  # noqa: E402
from volpick_tpu_torch.utils import plotting as pplot  # noqa: E402
from volpick_tpu_torch.utils import qc as pqc  # noqa: E402

SMALL_EQT = dict(in_samples=1504, lstm_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the CPU."""
    with torch_alone():
        yield


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def traces():
    waves, meta = synthetic_arrays(n_events=3, n_noise=1, n_samples=4000, seed=2)
    return synthetic_dataset(waves, meta)


def _lines(ax):
    return [(ln.get_label(), np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata())) for ln in ax.get_lines()]


def _assert_same_lines(got_ax, want_ax, tol=0.0):
    got, want = _lines(got_ax), _lines(want_ax)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (label, gx, gy), (_, wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx, err_msg=label)
        if tol:
            np.testing.assert_allclose(gy.astype(np.float64), wy.astype(np.float64), rtol=0, atol=tol,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(gy, wy, err_msg=label)
    assert got_ax.get_ylabel() == want_ax.get_ylabel() and got_ax.get_title() == want_ax.get_title()


@pytest.mark.parametrize("arch,tol", [("eqtransformer", 2e-4), ("phasenet", 2e-5)])
def test_prediction_examples_match_jax(traces, tmp_path, arch, tol):
    gen = torch.Generator().manual_seed(0)
    jmodel, port = {"eqtransformer": (JaxEQT(**SMALL_EQT), EQTransformer(generator=gen, **SMALL_EQT)),
                    "phasenet": (JaxPhaseNet(), PhaseNet(generator=gen))}[arch]
    params = jax.tree_util.tree_map(np.asarray, jax_tree_from_model(port))
    indices = [0, 2, 3]  # events (a window on the P onset) and a noise trace (the middle)
    want = jplot.plot_prediction_examples(jmodel, params, traces, indices)
    got = pplot.plot_prediction_examples(port, traces, indices, device="cpu")
    assert len(got) == len(want) == len(indices)
    for idx, g, w in zip(indices, got, want):
        assert g._suptitle.get_text() == w._suptitle.get_text()
        assert len(g.axes) == len(w.axes) == 4
        for i in range(3):  # the conditioned waveform (host numpy in both)
            _assert_same_lines(g.axes[i], w.axes[i])
        _assert_same_lines(g.axes[3], w.axes[3], tol)
        # what the curves panel draws is _prediction_arrays' output
        data, _ = traces.get_sample(idx)
        p_all, s_all = _onset_arrays(traces.metadata)
        x, curves, w0 = pplot._prediction_arrays(port, data, p_all[idx], s_all[idx], torch.device("cpu"))
        labels = [ln.get_label() for ln in g.axes[3].get_lines()]
        assert list(curves) == [lab for lab in labels if not lab.startswith("_")]
        for ln in g.axes[3].get_lines():
            if ln.get_label() in curves:
                np.testing.assert_array_equal(ln.get_ydata(), curves[ln.get_label()])
        for i in range(3):
            np.testing.assert_array_equal(g.axes[i].get_lines()[0].get_ydata(), x[0, i])
        assert 0 <= w0 <= data.shape[-1] - port.in_samples
    assert not port.training
    pplot.plot_prediction_examples(port, traces, indices[:1], save_dir=tmp_path / "p", device="cpu")
    jplot.plot_prediction_examples(jmodel, params, traces, indices[:1], save_dir=tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == ["prediction_0.png"]


def test_waveform_spectrum_and_loss_curves_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 2000))
    g = pplot.plot_waveform(data, 100.0, p_sample=800, s_sample=1200, title="t", save_path=tmp_path / "w.png")
    w = jplot.plot_waveform(data, 100.0, p_sample=800, s_sample=1200, title="t")
    assert (tmp_path / "w.png").exists() and len(g.axes) == len(w.axes) == 6
    for ga, wa in zip(g.axes, w.axes):
        _assert_same_lines(ga, wa)
        gm, wm = ga.collections, wa.collections  # the spectrograms
        assert len(gm) == len(wm)
        for a, b in zip(gm, wm):
            np.testing.assert_array_equal(a.get_array(), b.get_array())
            np.testing.assert_array_equal(a.get_coordinates(), b.get_coordinates())
    g = pplot.plot_waveform(data[:2], 50.0, p_sample=np.nan, with_spectrogram=False)
    w = jplot.plot_waveform(data[:2], 50.0, p_sample=np.nan, with_spectrogram=False)
    for ga, wa in zip(g.axes, w.axes):
        _assert_same_lines(ga, wa)

    ax = pplot.plot_spectrum(data[:, :1000], 100.0, save_path=tmp_path / "s.png")
    assert (tmp_path / "s.png").exists()
    _assert_same_lines(ax, jplot.plot_spectrum(data[:, :1000], 100.0))
    _assert_same_lines(pplot.plot_spectrum(data[0], 40.0, loglog=False),
                       jplot.plot_spectrum(data[0], 40.0, loglog=False))

    pd.DataFrame({"epoch": [0, 1, 2], "train_loss": [1.0, 0.8, 0.7], "val_loss": [1.1, np.nan, 0.9],
                  "lr": [1e-3, 1e-3, 5e-4]}).to_csv(tmp_path / "metrics.csv", index=False)
    g = pplot.plot_loss_curves(tmp_path, save_path=tmp_path / "loss.png", log_scale=True)
    w = jplot.plot_loss_curves(tmp_path, log_scale=True)
    assert (tmp_path / "loss.png").exists()
    for ga, wa in zip(g.axes, w.axes):
        _assert_same_lines(ga, wa)
        assert ga.get_yscale() == wa.get_yscale()


def test_table_driven_batches_match_jax(tmp_path):
    """plot_waveforms / plot_spectra / plot_spectrograms: one jpg per row under
    <data_dir>_fig, the same names and bytes as JAX's (reference
    `volpick/data/utils.py:203-573`)."""
    from volpick_tpu_torch.core.stream import UTC, Stream, Trace
    from volpick_tpu_torch.io.miniseed import write_mseed

    rng = np.random.default_rng(3)
    data_dir = tmp_path / "mseed"
    data_dir.mkdir()
    rows = []
    t0 = UTC("2024-03-01T00:00:00")
    for i in range(2):
        st = Stream([Trace(rng.normal(size=2000), dict(network="AV", station=f"Q{i}", channel=f"BH{c}",
                                                       sampling_rate=100.0, starttime=t0))
                     for c in "ZNE"])
        write_mseed(st, data_dir / f"ev{i}.mseed")
        rows.append({"trace_name": f"ev{i}.mseed" if i == 0 else f"ev{i}",
                     "trace_p_arrival_time": (t0 + 5.0).isoformat(),
                     "trace_s_arrival_time": None if i else (t0 + 9.0).isoformat()})
    table = pd.DataFrame(rows)
    for port_fn, jax_fn in ((pplot.plot_waveforms, jplot.plot_waveforms), (pplot.plot_spectra, jplot.plot_spectra),
                            (pplot.plot_spectrograms, jplot.plot_spectrograms)):
        got = port_fn(table, data_dir, [0, 1], fig_dir=tmp_path / "p" / port_fn.__name__)
        want = jax_fn(table, data_dir, [0, 1], fig_dir=tmp_path / "j" / port_fn.__name__)
        assert [p.name for p in got] == [p.name for p in want] == ["ev0.jpg", "ev1.jpg"]
        for a, b in zip(got, want):
            assert a.read_bytes() == b.read_bytes(), (port_fn.__name__, a.name)
    default = pplot.plot_waveforms(table, data_dir, [1])
    assert default == [tmp_path / "mseed_fig" / "ev1.jpg"] and default[0].exists()
    with pytest.raises(KeyError):
        pplot.plot_spectra(table, data_dir, [2], fig_dir=tmp_path / "x")


def test_screen_plot_flagged_writes_the_jax_files(tmp_path):
    waves, meta = synthetic_arrays(n_events=5, n_noise=3, n_samples=4000, seed=9)
    model = PhaseNet(generator=torch.Generator().manual_seed(3)).eval()
    stretch_heads(model, torch.as_tensor(waves[:, :, :3001]))
    port = WaveformPicker(model, device="cpu")
    jpick = JaxPicker(JaxPhaseNet(), jax.tree_util.tree_map(np.asarray, jax_tree_from_model(model)))
    ds = synthetic_dataset(waves, meta)
    srt = np.sort(_largest_probabilities(port, waves))
    k = int(np.argmax(np.diff(srt)))  # the widest gap between traces' maxima
    assert srt[k + 1] - srt[k] > 2e-3
    thr = float((srt[k] + srt[k + 1]) / 2)
    got = pqc.screen_dataset_with_models(ds, [port], threshold=thr, out_dir=tmp_path / "p", plot_flagged=True,
                                         max_plots=3)
    want = jqc.screen_dataset_with_models(ds, [jpick], threshold=thr, out_dir=tmp_path / "j", plot_flagged=True,
                                          max_plots=3)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    names = sorted(p.name for p in (tmp_path / "p").glob("flagged_*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("flagged_*.png"))
    assert names == sorted(f"flagged_{i}.png" for i in np.where(got)[0][:3])
