"""Utilities of the port: plotting, QC, profiling, TensorBoard logging."""

from volpick_tpu_torch.utils.plotting import (
    plot_loss_curves,
    plot_prediction_examples,
    plot_spectrum,
    plot_waveform,
    spectrogram,
)
from volpick_tpu_torch.utils.qc import check_waveforms, screen_dataset_with_models

__all__ = [
    "plot_loss_curves",
    "plot_prediction_examples",
    "plot_spectrum",
    "plot_waveform",
    "spectrogram",
    "check_waveforms",
    "screen_dataset_with_models",
]
