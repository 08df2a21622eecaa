"""Host-side containers of the port: streams, traces, timestamps and the
pick / detection result types (numpy only), and their obspy converters."""

from volpick_tpu_torch.core.picks import ClassifyOutput, Detection, Pick, PickList
from volpick_tpu_torch.core.interop import from_obspy, to_obspy
from volpick_tpu_torch.core.stream import UTC, Stream, Trace, group_streams_by_instrument

__all__ = [
    "UTC", "Trace", "Stream", "group_streams_by_instrument",
    "Pick", "PickList", "Detection", "ClassifyOutput", "from_obspy", "to_obspy",
]
