"""K9's work count by hand, and the reader of ``k9_roofline.archive``."""

from types import SimpleNamespace

import pytest

from conftest import REPO
from benchmark import bounds, harness, manifest, trace
from benchmark.plan import plan


def k9():
    import importlib.util

    spec = importlib.util.spec_from_file_location("k9_metric", REPO / "benchmark" / "metrics" / "k9_roofline.archive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eqt_config():
    return manifest.config(manifest.load(REPO), "eqtransformer", REPO)


def test_k9_work_by_hand_at_the_padded_layer():
    # layer 4: x (256, 32, 375), w (32, 32, 5), pooled 188 (the pool pads
    # one sample); 'same' pads 2 on each side, so taps 0 and 4 miss 2 outputs
    # each, taps 1 and 3 one each: 5 x 375 - 6 = 1869 taps inside
    n_bytes, flops, sfu = k9().k9_work(256, 32, 32, 5, 375)
    assert n_bytes == 4 * (256 * 32 * 375 + 32 * 32 * 5 + 32 + 256 * 32 * 188)
    assert flops == 2 * 256 * 32 * 32 * 1869 and sfu == 0


def test_k9_work_of_an_even_kernel_and_a_one_sample_row():
    # K 4 pads 1 on the left, 2 on the right: taps 0 and 3 miss 1 and 2
    # outputs, tap 2 one: of L 10, 40 - 4 inside
    assert k9().k9_work(1, 1, 1, 4, 10)[1] == 2 * 36
    # L 1: only the centre tap of K 3 falls inside; pooled 1
    assert k9().k9_work(2, 3, 4, 3, 1) == (4.0 * (2 * 3 + 4 * 3 * 3 + 4 + 2 * 4), 2.0 * 2 * 4 * 3, 0.0)


def test_encoder_layers_of_the_configuration():
    assert k9().encoder_layers(eqt_config()["model_args"]) == [
        (3, 8, 11, 6000), (8, 16, 9, 3000), (16, 16, 7, 1500), (16, 32, 7, 750), (32, 32, 5, 375),
        (32, 64, 5, 188), (64, 64, 3, 94)]


def test_k9_bound_of_an_encoder_at_256_windows():
    """0.1182 ms an encoder at B 256 (0.462 ms a kwin): layer 0 by its
    bytes, the others by their operations."""
    mod = k9()
    got = [bounds.bound_s(*mod.k9_work(256, *layer)) for layer in mod.encoder_layers(eqt_config()["model_args"])]
    assert [side for _, side in got] == ["bytes"] + ["operations"] * 6
    assert 1e3 * sum(t for t, _ in got) == pytest.approx(0.11825, abs=1e-5)


def test_reader_reads_its_rows_and_nothing_without_them():
    """Over a slice of two requests whose K9 rows take 4 times their
    launches' bounds, the reader gives 25%; a slice without K9 rows (the
    program before K9) gives None, and so does a run with no slice."""
    cfg = eqt_config()
    pl = plan(16, 360000, 6000, 5500, 256)
    mod = k9()
    rows, t = [], 0
    for _ in range(2):
        for batch in pl.forwards:
            for layer in mod.encoder_layers(cfg["model_args"]):
                ns = 4 * bounds.bound_s(*mod.k9_work(batch, *layer))[0] * 1e9
                rows.append(("void (anonymous namespace)::convpool_relu_kernel<11>(float const*)", t, t + ns, 0))
                t += ns
    other = [("void upconv_relu_kernel<3>", t, t + 10**6, 0), ("implicit_convolve_sgemm", t, t + 10**6, 0)]
    read = harness.load_reader("k9_roofline.archive", REPO)
    ctx = SimpleNamespace(cfg=cfg, plan=pl, slice_requests=2, slice=trace.Slice(0, t + 10**6, rows + other, []))
    assert read(ctx) == pytest.approx(25.0, rel=1e-9)
    ctx.slice = trace.Slice(0, t + 10**6, other, [])
    assert read(ctx) is None
    ctx.slice = None
    assert read(ctx) is None
