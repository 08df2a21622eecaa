"""Pick / Detection result types returned by classify().

Mirrors the SeisBench result surface the reference documents
(reference `README.md:69-84`): ``classify()`` returns an object with a
``.picks`` PickList of Pick{trace_id, start_time, end_time, peak_time,
peak_value, phase}.

The port's own copy of ``volpick_tpu/core/picks.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional

from volpick_tpu_torch.core.stream import UTC


@dataclass
class Pick:
    trace_id: str
    start_time: UTC
    end_time: Optional[UTC] = None
    peak_time: Optional[UTC] = None
    peak_value: Optional[float] = None
    phase: Optional[str] = None

    def __str__(self):
        parts = [f"{self.trace_id}\t{self.start_time.isoformat()}"]
        if self.peak_time is not None:
            parts.append(f"peak={self.peak_time.isoformat()}")
        if self.peak_value is not None:
            parts.append(f"value={self.peak_value:.3f}")
        if self.phase is not None:
            parts.append(f"phase={self.phase}")
        return "\t".join(parts)

    def __lt__(self, other: "Pick"):
        return (self.trace_id, self.start_time.timestamp) < (
            other.trace_id,
            other.start_time.timestamp,
        )


@dataclass
class Detection:
    trace_id: str
    start_time: UTC
    end_time: UTC
    peak_value: Optional[float] = None

    def __str__(self):
        return (
            f"{self.trace_id}\t{self.start_time.isoformat()}\t"
            f"{self.end_time.isoformat()}\tvalue={self.peak_value}"
        )


class PickList(list):
    """A list of Picks with convenience selectors."""

    def __init__(self, picks: Optional[Iterable[Pick]] = None):
        super().__init__(picks or [])

    def select(self, trace_id: Optional[str] = None, phase: Optional[str] = None) -> "PickList":
        out = PickList()
        for p in self:
            if trace_id is not None and p.trace_id != trace_id:
                continue
            if phase is not None and p.phase != phase:
                continue
            out.append(p)
        return out

    def __str__(self):
        header = f"PickList with {len(self)} entries:"
        shown = [str(p) for p in self[:20]]
        if len(self) > 20:
            shown.append("...")
        return "\n".join([header] + shown)


@dataclass
class ClassifyOutput:
    """Container returned by classify(); mirrors seisbench.util.ClassifyOutput."""

    creator: str
    picks: PickList = field(default_factory=PickList)
    detections: List[Detection] = field(default_factory=list)

    def __str__(self):
        return (
            f"ClassifyOutput(creator={self.creator}, picks={len(self.picks)}, "
            f"detections={len(self.detections)})"
        )
