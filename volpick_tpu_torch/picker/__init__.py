from volpick_tpu_torch.picker.annotate import UTC, Stream, Trace, WaveformPicker
from volpick_tpu_torch.picker.streaming import StreamingPicker

__all__ = ["WaveformPicker", "StreamingPicker", "Stream", "Trace", "UTC"]
