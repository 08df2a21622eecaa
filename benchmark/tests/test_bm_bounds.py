"""The K1, K2 and K8 bound arithmetic, by hand and against the kernels' table."""

import pytest

from conftest import REPO
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


# K8 at 256 windows, the decoder layers L0-L6 of the eqtransformer
# configuration: each layer's bound in ms as PERF.md's table of kernels gives
# it (chip_smoke.py's K8 rows), L0 by its bytes, the others by their folded
# operations; 0.1488 ms a decoder
K8_MS = [0.0021, 0.0177, 0.0176, 0.0235, 0.0235, 0.0293, 0.0352]


def eqt_config():
    from benchmark import manifest

    man = manifest.load(REPO)
    return manifest.config(man, "eqtransformer", REPO)


def test_k8_work_at_256_windows_holds_the_decoders_bounds():
    got = [bounds.bound_s(*bounds.k8_work(256, *layer)) for layer in eqt_config()["kernels"]["k8"]["layers"]]
    assert [round(1e3 * t, 4) for t, _ in got] == K8_MS
    assert [side for _, side in got] == ["bytes"] + ["operations"] * 6
    assert round(1e3 * sum(t for t, _ in got), 4) == 0.1488


def test_k8_work_by_hand_at_the_cropped_layer():
    # L2: x (256, 64, 188) upsampled to 376 and cropped to 375, w (32, 64, 5):
    # p = 2, so 3 folded taps a parity
    n_bytes, flops, sfu = bounds.k8_work(256, 64, 32, 5, 375)
    assert n_bytes == 4 * (256 * 64 * 188 + 32 * 64 * 5 + 32 + 256 * 32 * 375)
    assert flops == 2 * 256 * 32 * 375 * 64 * 3 and sfu == 0


def test_k8_layers_are_the_reference_decoders():
    import torch

    from benchmark import reference

    cfg = eqt_config()
    model = reference.build_model(cfg, "cpu")
    seen = []
    decoders = [model.decoder_d] + list(model.pick_decoders)
    hooks = [c.register_forward_hook(lambda m, a, out: seen.append([m.in_channels, m.out_channels,
                                                                   m.kernel_size[0], out.shape[-1]]))
             for d in decoders for c in d.convs]
    with torch.inference_mode():
        model(torch.zeros(1, 3, cfg["model_args"]["in_samples"]))
    for h in hooks:
        h.remove()
    spec = cfg["kernels"]["k8"]
    assert spec["calls_per_forward"] == len(seen) == 3 * len(spec["layers"])
    assert seen == spec["layers"] * 3


def test_roofline_sums_each_launch_shape_bound():
    """k8_roofline over a slice of two requests whose K8 rows take 2.5 times
    their launches' bounds reads 40%; K2's and K1's launches, one shape each
    here, read the bound of their summed work."""
    from types import SimpleNamespace

    from benchmark import readers, trace
    from benchmark.plan import plan

    cfg = eqt_config()
    pl = plan(16, 360000, 6000, 5500, 256)
    spec = cfg["kernels"]["k8"]
    rows, t = [], 0
    for _ in range(2 * len(pl.forwards) * spec["calls_per_forward"] // len(spec["layers"])):
        for layer in spec["layers"]:
            ns = 2.5 * bounds.bound_s(*bounds.k8_work(256, *layer))[0] * 1e9
            rows.append(("void upconv_relu_kernel<3>", t, t + ns, 0))
            t += ns
    k2 = bounds.k2_work(2, 256, 47, 16)
    k1 = bounds.k1_work(48, pl.padded_total, pl.max_picks)
    rows += [("lstm_multi_kernel", t, t + 10**6, 0), ("trigger_extract_kernel", t, t + 10**5, 0)]
    ctx = SimpleNamespace(cfg=cfg, plan=pl, slice_requests=2, slice=trace.Slice(0, t + 10**6, rows, []))
    read = lambda kernel, match: readers.kernel_roofline(ctx, {"kernel": kernel, "match": match})
    assert read("k8", "upconv_relu_kernel") == pytest.approx(40.0, rel=1e-9)
    n2 = 2 * 4 * len(pl.forwards)
    assert read("k2", "lstm_multi_kernel") == pytest.approx(
        100 * bounds.bound_s(*(n2 * v for v in k2))[0] / 1e-3, rel=1e-12)
    assert read("k1", "trigger_extract_kernel") == pytest.approx(
        100 * bounds.bound_s(*(2 * v for v in k1))[0] / 1e-4, rel=1e-12)
