"""Acquisition of the port: catalogs, downloaders with injectable clients, the
Hi-net wire, SAC / WIN32 → miniSEED and catalog → dataset converters (copies of
``volpick_tpu/acquisition``'s modules). They import no torch, and pandas only
inside the functions that build or read a table, as the rest of the port
does."""

from volpick_tpu_torch.acquisition.events import Catalog, Event, Origin, Magnitude, PhasePick
from volpick_tpu_torch.acquisition.catalogs import (
    read_hypoinverse_catalog,
    read_ncedc_summary,
    read_hvo_summary,
    read_hypoinverse_summary,
    group_picks,
)
from volpick_tpu_torch.acquisition.comcat import (
    download_phases,
    group_comcat_picks,
    read_PNSN_events,
)

__all__ = [
    "Catalog",
    "Event",
    "Origin",
    "Magnitude",
    "PhasePick",
    "read_hypoinverse_catalog",
    "read_ncedc_summary",
    "read_hvo_summary",
    "read_hypoinverse_summary",
    "group_picks",
    "download_phases",
    "group_comcat_picks",
    "read_PNSN_events",
]
