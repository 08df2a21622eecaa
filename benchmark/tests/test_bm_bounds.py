"""The K1 and K2 bound arithmetic at two shapes each, by hand."""

import pytest

from benchmark import bounds


def test_sfu_rate_derivation():
    assert bounds.PEAK_SFU == pytest.approx(4.1875e12)


@pytest.mark.parametrize("rows,width,k", [(48, 360000, 240), (32, 360000, 476)])
def test_k1_work_and_bound(rows, width, k):
    n_bytes, flops, sfu = bounds.k1_work(rows, width, k)
    assert n_bytes == rows * width * 4 + rows * 8 + rows * k * 17
    assert flops == 8 * rows * width and sfu == 0
    t, side = bounds.bound_s(n_bytes, flops, sfu)
    assert side == "bytes" and t == pytest.approx(n_bytes / 3.35e12)


@pytest.mark.parametrize("batch,expect_side", [(256, "bytes"), (16, "bytes")])
def test_k2_work_and_bound(batch, expect_side):
    g, t, h = 2, 47, 16
    n_bytes, flops, sfu = bounds.k2_work(g, batch, t, h)
    cells = g * batch * t * h
    assert n_bytes == cells * 20 + g * 4 * h * (h + 1) * 4
    assert flops == 2 * cells * 4 * h + 10 * cells and sfu == 5 * cells
    secs, side = bounds.bound_s(n_bytes, flops, sfu)
    assert side == expect_side
    assert secs == pytest.approx(max(n_bytes / 3.35e12, flops / 67e12, sfu / bounds.PEAK_SFU))


def test_k2_at_256_windows_is_2_3_us():
    secs, _ = bounds.bound_s(*bounds.k2_work(2, 256, 47, 16))
    assert secs == pytest.approx(2.30e-6, rel=0.01)
