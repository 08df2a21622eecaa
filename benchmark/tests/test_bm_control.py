"""The control of ``pick_gap``: the reference put in the program's place
and run with TF32 on (the precision below the configurations' float32 with
TF32 off) must read above each configuration's limit, and the program on
the same seeds below it. On the card only, at a size a test run holds;
``benchmark/control.py`` takes the same readings at a cell's own size."""

import pytest

from conftest import REPO, tiny_mix
from benchmark import control, manifest

MAN = manifest.load(REPO)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_control_fails_and_program_passes(card, cell):
    cfg = manifest.config(MAN, cell["config"], REPO)
    mix = tiny_mix(cell["traffic"])
    mix.update(stations=4, samples=4 * mix["samples"])
    limit = cfg["check"]["pick_gap"]
    rows = list(control.readings(cfg, mix, [1, 2, 3], [1, 2, 3], card))
    assert all(r["program"] <= limit for r in rows), rows
    assert all(r["control"] > limit for r in rows), rows
