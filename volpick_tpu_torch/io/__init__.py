"""Waveform readers and writers of the port: miniSEED (``io/miniseed.py``,
native decoder), SAC (``core/sacio.py``), WIN32 (``io/win32.py``, native
decoder) and StationXML metadata (``io/stationxml.py``)."""

from volpick_tpu_torch.core.sacio import read_sac, read_sac_stream, write_sac
from volpick_tpu_torch.io.miniseed import read_mseed, write_mseed

__all__ = ["read_mseed", "write_mseed", "read_sac", "write_sac", "read_sac_stream"]
