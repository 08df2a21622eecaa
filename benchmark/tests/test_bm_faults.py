"""A run whose timed path is broken underneath comes out not correct.

The harness runs on the CPU here (the look for a card is ``run.py``'s), at
each cell's tiny size, once sound and once for each fault a picking cell
can have: half of a step's windows left out, the rest's mean put in their
place; a pick moved by a tenth of a second (10 samples) where it is produced; a pick's
value altered there. (No cell trains, and none spans chips.)"""

import time

import pytest
import torch

from conftest import tiny_root
from benchmark import harness

CELLS = ["eqt.archive", "phasenet.archive", "eqt.live"]


def half_batch(monkeypatch):
    from volpick_tpu_torch.picker.annotate import WaveformPicker

    orig = WaveformPicker._apply_model

    def apply(self, frames):
        h = max(1, frames.shape[0] // 2)
        out = orig(self, frames[:h])
        rest = out.mean(dim=0, keepdim=True).expand((frames.shape[0] - h,) + out.shape[1:])
        return torch.cat([out, rest])

    monkeypatch.setattr(WaveformPicker, "_apply_model", apply)


def altered_pick(which):
    def plant(monkeypatch):
        import volpick_tpu_torch.picker.annotate as annotate

        orig = annotate.extract_triggers_batched

        def extract(*args, **kwargs):
            pk, val, valid, on, off = orig(*args, **kwargs)
            if which == "shift":
                pk = torch.where(valid, pk + 10, pk)
            else:
                val = torch.where(valid, val + 0.05, val)
            return pk, val, valid, on, off

        monkeypatch.setattr(annotate, "extract_triggers_batched", extract)
    return plant


FAULTS = {"sound": None, "half_batch": half_batch, "pick_shifted": altered_pick("shift"),
          "pick_value": altered_pick("value")}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    out = harness.run(cell, 2**31 + 77, 1.0, False, "cpu", time.perf_counter(), root)
    assert out["attempted"] > 0 and list(out)[-1] == "check"
    gap = out["check"]["pick_gap"]
    if fault == "sound":
        assert out["correct"] and out["failed"] == 0, gap
    else:
        assert not out["correct"] and out["failed"] > 0, gap
        assert gap["value"] > gap["limit"]
