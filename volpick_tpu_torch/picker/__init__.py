from volpick_tpu_torch.picker.annotate import UTC, Stream, Trace, WaveformPicker

__all__ = ["WaveformPicker", "Stream", "Trace", "UTC"]
