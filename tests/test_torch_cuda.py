"""The port's CUDA kernels vs their plain PyTorch twins, on a CUDA device.

Marked ``cuda``; every test skips when torch sees no CUDA device (decided in
a fixture, not at import). Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Tolerances:
trigger extraction (both forms of its launch) and trigger scan exact; LSTM (both forms), MHA (both
entries) and additive attention (both entries) 1e-5 (the tests/test_pallas.py pins); conditioning 2e-5; the res-CNN stack
3e-4; picker curves GPU vs CPU 1e-4 (float32 convolutions reduce in another
order on the card); the decoder layer's kernel within 1e-5 of the layer's
largest output (it sums the taps that land on one input sample in the
weights, so it adds the same products in another order), a full-width
forward through it within 1e-4 of the same forward through its twin with
equal picks; the encoder layer's kernel within 1e-5 of the layer's
largest output as well (it sums the same products as cuDNN's float32 conv in
another order; TF32 would miss this by ~100x), a forward through it within
1e-4 of the plain encoder's with equal picks; a train step on the card against the CPU port in
float64: loss 1e-10 relative, gradients 1e-6 of each tensor's largest
entry, parameters and EMA after the step 1e-9 (the same pins hold a step of a
world of one NCCL rank to the plain step). The bfloat16 bodies against
their bf16 twins, each by the rule chip_smoke.py states: the LSTM's within
2^-7 |twin| + 2^-9 (it sums the projection on the tensor cores, the twin in
another order, so a gate input can round to the neighbouring bf16 value);
the additive attention's within one bf16 ulp, |Δ| <= 2^-7 |twin| + 1e-6 (it
rounds where the twin rounds, its tanh correctly rounded; the sums run in
another order, so a result near a rounding boundary may round to the
neighbouring bf16 value). The MHA kernel's bf16 body sums its
logits on the tensor cores, where one probability's bf16 rounding can flip
and move an output near zero by up to 2^-8 of the largest |v| of its window
and head: |Δ| <= 2^-7 |twin| + 2^-8 max|v|.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.ops.cuda import LayerRefused, _build
from volpick_tpu_torch.ops.cuda import addattn as cuda_addattn
from volpick_tpu_torch.ops.cuda import attention as cuda_attn
from volpick_tpu_torch.ops.cuda import conditioning as cuda_cond
from volpick_tpu_torch.ops.cuda import convpool as cuda_convpool
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
from volpick_tpu_torch.ops.cuda import rescnn as cuda_rescnn
from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
from volpick_tpu_torch.ops.cuda import upconv as cuda_upconv
from volpick_tpu_torch.ops.labels import detection_labels, probabilistic_labels
from volpick_tpu_torch.ops.triggers import extract_triggers_batched
from volpick_tpu_torch.picker import WaveformPicker
from volpick_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _curves(rng, b, w):
    rows = [np.where(np.arange(w) % 2 == 0, 0.9, 0.0), np.full(w, 0.2), rng.random(w)]
    seg = -(-w // 1024)
    r = np.full(w, 0.1)
    r[max(w - 3, 0):] = 0.7
    for s in range(seg, w, seg):
        r[max(s - 2, 0) : s + 1] = 0.9
    rows.append(r)
    # runs across every step boundary (128 samples) of trigger_scan, and so
    # across every boundary between the pieces of its warps
    r = np.full(w, 0.1)
    for s in range(cuda_trig.SCAN_STEP, w, cuda_trig.SCAN_STEP):
        r[s - 2 : s + 2] = 0.9 if s % (6 * cuda_trig.SCAN_STEP) else 0.95
    rows.append(r)
    while len(rows) < b:
        k = int(rng.integers(1, min(60, w) + 1))
        rows.append(np.convolve(rng.random(w), np.ones(k) / k, mode="same"))
    return np.stack(rows[:b]).astype(np.float32)


@pytest.mark.parametrize("b,w,k", [(4, 1, 3), (5, 7, 4), (8, 1023, 16), (8, 1025, 16),
                                   (9, 5000, 40), (24, 120000, 80)])
def test_trigger_extract_equals_twin(dev, b, w, k):
    rng = np.random.default_rng(w)
    prob = torch.as_tensor(_curves(rng, b, w), device=dev)
    t1 = torch.as_tensor(rng.uniform(0.3, 0.8, b).astype(np.float32), device=dev)
    t2 = t1 * 0.5
    before = cuda_trig.launches
    got = cuda_trig.trigger_extract(prob, t1, t2, k)
    assert cuda_trig.launches == before + 1
    want = cuda_trig.trigger_extract_reference(prob, t1, t2, k)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


def _assert_extract_equals_twin(prob, t1, t2, k):
    before = cuda_trig.launches
    got = cuda_trig.trigger_extract(prob, t1, t2, k)
    assert cuda_trig.launches == before + 1  # one a call, however many kernels it launches
    want = cuda_trig.trigger_extract_reference(prob, t1, t2, k)
    for name, g, r in zip(("peak_idx", "peak_val", "valid", "onset", "offset"), got, want):
        assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.fixture(params=[True, False], ids=["cooperative", "two-launches"])
def extract_form(request):
    """Both forms of the trigger_extract kernel for a row of several pieces:
    the cooperative launch (taken where every CTA is resident) and the two
    plain launches."""
    saved = cuda_trig.EXTRACT_COOPERATIVE
    cuda_trig.EXTRACT_COOPERATIVE = request.param
    yield request.param
    cuda_trig.EXTRACT_COOPERATIVE = saved


# (24, 120000): the main path, 86 pieces a row; (3000, 6000): one piece a row,
# one launch; (1, 120001): 938 pieces of one step, more summaries than a warp,
# an odd width; (5, 1): one ragged quad; (7, 4097): rows that start off a
# 16-byte boundary, one sample past a step; (100, 30001): 22 pieces a row
@pytest.mark.parametrize("k", [1, 64, 80])
@pytest.mark.parametrize("b,w", [(24, 120000), (3000, 6000), (1, 120001), (5, 1), (7, 4097),
                                 (100, 30001)])
def test_trigger_extract_split_equals_twin(dev, extract_form, b, w, k):
    rng = np.random.default_rng(w + k)
    curves = _curves(rng, b, w)
    curves[-1] = 0.95  # a row that is all one run: longer than any piece
    prob = torch.as_tensor(curves, device=dev)
    t1 = torch.as_tensor(rng.uniform(0.3, 0.8, b).astype(np.float32), device=dev)
    _assert_extract_equals_twin(prob, t1, t1 * 0.5, k)


@pytest.mark.parametrize("b,w", [(24, 120000), (8, 30001)])
def test_trigger_extract_piece_boundaries(dev, extract_form, b, w):
    """Rows built around the pieces of the kernel's split: what a piece counts
    alone (sure), what the state carried into it decides (pending, both ways),
    and the cut at K inside a piece and exactly between two."""
    piece, n_pieces = cuda_trig.scan_plan(b, w)
    assert n_pieces > 4
    k = 6
    prob = np.full((b, w), 0.1, np.float32)
    for c in range(piece, w, piece):  # a run across every piece boundary: far more than K picks
        prob[0, c - 2 : c + 3] = 0.9
    prob[1, piece - 50 : 3 * piece + 7] = 0.4  # pending in two pieces, resolved true:
    prob[1, piece - 20] = 0.97                 # crossed t1 only in its first piece
    prob[1, 4 * piece : 4 * piece + 3] = 0.8
    prob[2, piece - 50 : 3 * piece + 7] = 0.4  # the same, never crossing: resolved false
    prob[2, 4 * piece : 4 * piece + 3] = 0.8
    prob[3, w - 5 :] = 0.9  # touches the row end
    # row 4 never triggers; row 5: the K-th pick is the last run end of piece 1,
    # the next the first of piece 2; row 6: exactly K picks
    for row, n in ((5, k + 1), (6, k)):
        ends = [2 * piece - 2 - 3 * j for j in range(k)][::-1] + [2 * piece + 1]
        prob[row, ends[-n:] if row == 5 else ends[:n]] = 0.9
    prob[7:] = np.random.default_rng(b).random((b - 7, w), dtype=np.float32)
    prob = torch.as_tensor(prob, device=dev)
    t1 = torch.full((b,), 0.5, device=dev)
    _assert_extract_equals_twin(prob, t1, t1 * 0.5, k)
    _, _, valid, on, off = cuda_trig.trigger_extract(prob, t1, t1 * 0.5, k)
    assert valid.sum(dim=1)[:7].tolist() == [k, 2, 1, 1, 0, k, k]
    assert on[1, 0] == piece - 20 and off[1, 0] == 3 * piece + 6
    assert off[5, -1] == 2 * piece - 2 and off[6, -1] == 2 * piece - 2


def test_trigger_extract_unaligned_base(dev, extract_form):
    """A contiguous view that starts 4 bytes into its storage takes the scalar path."""
    rng = np.random.default_rng(11)
    b, w = 5, 9000
    store = torch.as_tensor(np.concatenate([[0.0], _curves(rng, b, w).ravel()]).astype(np.float32),
                            device=dev)
    prob = store[1:].view(b, w)
    assert prob.is_contiguous() and prob.data_ptr() % 16 != 0
    t1 = torch.full((b,), 0.6, device=dev)
    _assert_extract_equals_twin(prob, t1, t1 * 0.5, 64)


def test_trigger_extract_repeats_bit_equal(dev, extract_form):
    """Back-to-back calls on one stream share the summaries' scratch."""
    rng = np.random.default_rng(5)
    prob = torch.as_tensor(_curves(rng, 24, 50000), device=dev)
    t1 = torch.full((24,), 0.55, device=dev)
    outs = [cuda_trig.trigger_extract(prob, t1, t1 * 0.5, 80) for _ in range(20)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b_) for a, b_ in zip(o, outs[0]))


def _lstm_args(dev, rng, g, c, h):
    args = [
        rng.normal(size=(g, 4 * h, c)) * 0.2,
        rng.normal(size=(g, 4 * h, h)) * 0.2,
        rng.normal(size=(g, 4 * h)) * 0.1,
    ]
    return [torch.as_tensor(a.astype(np.float32), device=dev) for a in args]


@pytest.mark.parametrize("g,b,c,t,h", [(2, 232, 64, 47, 16), (2, 232, 16, 47, 16),
                                       (3, 5, 16, 31, 8), (1, 17, 32, 12, 32),
                                       (2, 9, 7, 33, 5), (2, 3, 16, 40, 12), (40, 2, 4, 9, 16)])
def test_lstm_multi_matches_twin(dev, g, b, c, t, h):
    rng = np.random.default_rng(b + c)
    xs = torch.as_tensor(rng.normal(size=(g, b, c, t)).astype(np.float32), device=dev)
    args = [xs] + _lstm_args(dev, rng, g, c, h)
    before = cuda_lstm.launches
    got = cuda_lstm.lstm_multi(*args)
    assert cuda_lstm.launches == before + 1
    err = (got - cuda_lstm.lstm_multi_reference(*args)).abs().max().item()
    assert err <= 1e-5


@pytest.mark.parametrize("t", [1, 47, 200])
@pytest.mark.parametrize("h", [8, 16, 32])
@pytest.mark.parametrize("b", [1, 7, 232, 500])
def test_lstm_both_forms_match_twins(dev, b, h, t):
    """``lstm_multi`` (no reverse) and ``lstm_branches`` (forward + backward
    over one x) against their twins, and ``lstm_branches`` against the
    composition it replaces: stack x with its time flip, ``lstm_multi``, flip
    back, concatenate."""
    rng = np.random.default_rng(b * 1000 + h * 10 + t)
    c = 16
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev)
    w = _lstm_args(dev, rng, 2, c, h)
    xs = torch.stack([x, x.flip(-1)])
    before = cuda_lstm.launches
    multi = cuda_lstm.lstm_multi(xs, *w)
    got = cuda_lstm.lstm_branches(x, *w, reverse=(False, True))
    assert cuda_lstm.launches == before + 2
    assert got.shape == (b, 2 * h, t) and got.is_contiguous()
    assert (multi - cuda_lstm.lstm_multi_reference(xs, *w)).abs().max().item() <= 1e-5
    want = cuda_lstm.lstm_branches_reference(x, *w, reverse=(False, True))
    assert (got - want).abs().max().item() <= 1e-5
    old = torch.cat([multi[0], multi[1].flip(-1)], dim=1)
    assert (got - old).abs().max().item() <= 1e-5


@pytest.mark.parametrize("reverse", [(True,), (False, False, True), (True, True)])
def test_lstm_branches_reverse_flags(dev, reverse):
    rng = np.random.default_rng(len(reverse))
    g, b, c, t, h = len(reverse), 11, 24, 47, 16
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev)
    w = _lstm_args(dev, rng, g, c, h)
    got = cuda_lstm.lstm_branches(x, *w, reverse=reverse)
    want = cuda_lstm.lstm_branches_reference(x, *w, reverse=reverse)
    assert (got - want).abs().max().item() <= 1e-5


def test_lstm_wrapper_refusals(dev):
    rng = np.random.default_rng(0)
    xs = torch.zeros(2, 3, 16, 5, device=dev)
    w_ih, w_hh, bias = _lstm_args(dev, rng, 2, 16, 16)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_multi(xs.double(), w_ih, w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih[:, :, :8], w_hh, bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias[:1])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lstm.lstm_multi(xs, w_ih, w_hh.transpose(1, 2).contiguous().transpose(1, 2), bias)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_branches(xs[0], w_ih, w_hh, bias, reverse=(False,))  # 2 weight sets, 1 flag
    big = _lstm_args(dev, rng, 1, 16, 33)
    with pytest.raises(ValueError, match="limit"):  # H = 33
        cuda_lstm.lstm_multi(xs[:1], *big)
    with pytest.raises(ValueError, match="limit"):
        cuda_lstm.lstm_branches(xs[0], *big, reverse=(True,))


def test_picker_gpu_matches_cpu(dev):
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(2, 3, 5000)) * 0.1).astype(np.float32)
    data[:, :, 2500:2600] += 2.0 * np.hanning(100).astype(np.float32)
    gpu_model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1, device=dev)
    cpu_model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1, device="cpu")
    kw = dict(overlap=1128, blinding=(200, 200), batch_size=8)
    gpu = WaveformPicker(gpu_model, device=dev)
    cpu = WaveformPicker(cpu_model, device="cpu")
    # the picker turns TF32 off only for its own work and restores the flags
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    before = (cuda_trig.launches, cuda_lstm.launches)
    gc = gpu.annotate_array(data, **kw)
    np.testing.assert_allclose(gc, cpu.annotate_array(data, **kw), atol=1e-4)
    thr = {lab: float(np.percentile(gc[:, i], 99.0)) for i, lab in enumerate(["Detection", "P", "S"])}
    res = gpu.classify_arrays(data, thr, **kw)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert cuda_trig.launches > before[0] and cuda_lstm.launches > before[1]
    assert sum(int(v[2].sum()) for v in res.values()) > 0


@pytest.mark.parametrize("b,d,t,h", [(128, 128, 94, 4), (3, 32, 16, 2), (5, 64, 127, 2),
                                     (2, 96, 33, 3), (1, 128, 1, 4), (2, 12, 9, 2), (3, 21, 50, 3)])
def test_mha_matches_twin(dev, b, d, t, h):
    rng = np.random.default_rng(b + t)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, d, t)).astype(np.float32), device=dev)
               for _ in range(3))
    before = cuda_attn.launches
    got = cuda_attn.mha(q, k, v, h)
    assert cuda_attn.launches == before + 1
    assert (got - cuda_attn.mha_reference(q, k, v, h)).abs().max().item() <= 1e-5


def _head_major(qkv, scale):
    """q, k, v of a (B, T, 3, H, Dh) projection packed (B, H·Dh, T), q scaled."""
    b, t, _, h, dh = qkv.shape
    q, k, v = (a.permute(0, 2, 3, 1).reshape(b, h * dh, t).contiguous() for a in qkv.unbind(2))
    return q * scale, k, v


@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("t", [1, 5, 94, 127, 128])
@pytest.mark.parametrize("dh", [8, 16, 32, 6])
def test_mha_both_entries_match_twins(dev, dh, t, b):
    """The in-place entry against its twin and against the head-major entry on
    the same data; Dh = 6 takes the in-place entry off its 16-byte path."""
    h = 4 if dh == 32 else 2
    rng = np.random.default_rng(dh * 1000 + t * 10 + b)
    qkv = torch.as_tensor(rng.normal(size=(b, t, 3, h, dh)).astype(np.float32), device=dev)
    scale = dh ** -0.5
    before = cuda_attn.launches
    got = cuda_attn.mha_qkv(qkv, scale)
    assert cuda_attn.launches == before + 1
    assert got.shape == (b, t, h * dh) and got.is_contiguous()
    assert (got - cuda_attn.mha_qkv_reference(qkv, scale)).abs().max().item() <= 1e-5
    q, k, v = _head_major(qkv, scale)
    packed = cuda_attn.mha(q, k, v, h)
    assert (packed - cuda_attn.mha_reference(q, k, v, h)).abs().max().item() <= 1e-5
    assert (got - packed.transpose(1, 2)).abs().max().item() <= 1e-5


def test_mha_qkv_refusals(dev):
    """A non-contiguous projection is refused, not copied."""
    qkv = torch.zeros(2, 10, 3, 2, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attn.mha_qkv(qkv[:, ::2], 0.25)
    with pytest.raises(ValueError):
        cuda_attn.mha_qkv(qkv[:, :, :2], 0.25)
    with pytest.raises(TypeError):
        cuda_attn.mha_qkv(qkv.double(), 0.25)
    for shape in ((1, 129, 3, 4, 32), (1, 94, 3, 2, 64)):  # T > 128; Dh = 64 > 32
        with pytest.raises(ValueError, match="limits"):
            cuda_attn.mha_qkv(torch.zeros(shape, device=dev), 1.0)


def test_mha_refuses_shapes_beyond_the_kernel(dev):
    for shape, h in (((1, 128, 129), 4), ((1, 128, 94), 2)):  # T > 128; Dh = 64 > 32
        q = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError):
            cuda_attn.mha(q, q, q, h)
    q = torch.zeros(2, 128, 94, device=dev)
    with pytest.raises(ValueError):
        cuda_attn.mha(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, 4)


def test_tpupicknet_pallas_picker_gpu_matches_cpu(dev):
    rng = np.random.default_rng(5)
    data = (rng.normal(size=(2, 3, 5000)) * 0.1).astype(np.float32)
    data[:, :, 2500:2600] += 2.0 * np.hanning(100).astype(np.float32)
    margs = dict(in_samples=512, d_model=32, n_heads=2, n_layers=2, attn="pallas")
    kw = dict(overlap=256, blinding=(50, 50), batch_size=8)
    gpu = WaveformPicker(load_model("tpupicknet", seed=1, device=dev, **margs), device=dev)
    cpu = WaveformPicker(load_model("tpupicknet", seed=1, device="cpu", **margs), device="cpu")
    before = cuda_attn.launches
    gc = gpu.annotate_array(data, **kw)
    assert cuda_attn.launches > before and (cuda_attn.launches - before) % 2 == 0
    np.testing.assert_allclose(gc, cpu.annotate_array(data, **kw), atol=1e-4)


# ---- trigger_scan (K3)
def _assert_scan_equals_twin(prob, t1, t2):
    before = cuda_trig.scan_launches
    got = cuda_trig.trigger_scan(prob, t1, t2)
    assert cuda_trig.scan_launches == before + 1  # one a call, however many kernels it launches
    want = cuda_trig.trigger_scan_reference(prob, t1, t2)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


# W = 1, 3: one ragged quad; odd W with B > 1: rows that start off a 16-byte
# boundary; 4097, 12289: one sample past a step; B = 1: 938 pieces of one step,
# far more summaries than a warp; (100, 30001): 22 pieces a row; B = 3000 and
# 5000: one piece a row, one launch
@pytest.mark.parametrize("b,w", [(4, 1), (5, 3), (5, 7), (8, 1023), (8, 1025), (9, 4097), (9, 5000),
                                 (7, 12289), (24, 120000), (1, 120000), (100, 30001), (3000, 6000),
                                 (3000, 37), (5000, 1501)])
def test_trigger_scan_equals_twin(dev, b, w):
    rng = np.random.default_rng(w)
    curves = _curves(rng, b, w)
    curves[-1] = 0.95  # a row that is all one run: longer than any piece
    prob = torch.as_tensor(curves, device=dev)
    t1 = torch.as_tensor(rng.uniform(0.3, 0.8, b).astype(np.float32), device=dev)
    t2 = t1 * 0.5
    _assert_scan_equals_twin(prob, t1, t2)
    k = 16
    full = extract_triggers_batched(prob, t1, t2, max_picks=k, method="pallas_full")
    for method in ("pallas", "shift", "blocked"):
        for g, r in zip(extract_triggers_batched(prob, t1, t2, max_picks=k, method=method), full):
            assert torch.equal(g, r)


@pytest.mark.parametrize("b,w", [(24, 120000), (6, 30001)])
def test_trigger_scan_piece_boundaries(dev, b, w):
    """Runs across every piece boundary of the kernel's split, a run longer
    than two pieces whose max sits in its first, a row whose first run starts
    in its second piece, a run touching the row end, a row that never triggers."""
    piece, n_pieces = cuda_trig.scan_plan(b, w)
    assert n_pieces > 4
    prob = np.full((b, w), 0.1, np.float32)
    for c in range(piece, w, piece):
        prob[0, c - 2 : c + 3] = 0.9
    prob[1, piece - 50 : min(w, 3 * piece + 7)] = 0.4
    prob[1, piece - 20] = 0.97
    prob[2, piece + 1 : piece + 9] = 0.8
    prob[3, w - 5 :] = 0.9
    prob[5:] = np.random.default_rng(b).random((b - 5, w), dtype=np.float32)
    prob = torch.as_tensor(prob, device=dev)
    t1 = torch.full((b,), 0.5, device=dev)
    _assert_scan_equals_twin(prob, t1, t1 * 0.5)
    on, m, am = cuda_trig.trigger_scan(prob, t1, t1 * 0.5)
    assert (am[4] == 0).all() and (on[4] == 2**31 - 1).all()  # never triggers: argmax 0 everywhere
    assert (am[2, : piece + 1] == 0).all() and am[2, piece + 1] == piece + 1
    end = min(w, 3 * piece + 7) - 1
    assert on[1, end] == piece - 20 and am[1, end] == piece - 20 and m[1, end] == np.float32(0.97)


def test_trigger_scan_unaligned_base(dev):
    """A contiguous view that starts 4 bytes into its storage takes the scalar path."""
    rng = np.random.default_rng(11)
    b, w = 5, 9000
    store = torch.as_tensor(np.concatenate([[0.0], _curves(rng, b, w).ravel()]).astype(np.float32),
                            device=dev)
    prob = store[1:].view(b, w)
    assert prob.is_contiguous() and prob.data_ptr() % 16 != 0
    t1 = torch.full((b,), 0.6, device=dev)
    _assert_scan_equals_twin(prob, t1, t1 * 0.5)


def test_trigger_scan_refuses_non_contiguous(dev):
    prob = torch.rand(50, 6, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_trig.trigger_scan(prob, torch.ones(6, device=dev), torch.ones(6, device=dev))


# ---- condition_windows (K4)
@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
@pytest.mark.parametrize("n,c,w", [(232, 3, 6000), (8, 3, 6000), (1, 1, 257), (5, 3, 3001),
                                   (3, 2, 31)])
def test_condition_windows_matches_twin(dev, detrend, norm, n, c, w):
    rng = np.random.default_rng(n + w)
    t = np.linspace(-1.0, 1.0, w)
    x = rng.normal(size=(n, c, w)) + rng.uniform(-20, 20, (n, c, 1)) + rng.uniform(-30, 30, (n, c, 1)) * t
    x = torch.as_tensor(x.astype(np.float32), device=dev)
    before = cuda_cond.launches
    got = cuda_cond.condition_windows(x, detrend=detrend, norm=norm)
    assert cuda_cond.launches == before + 1
    want = cuda_cond.condition_windows_reference(x, detrend=detrend, norm=norm)
    assert (got - want).abs().max().item() <= 2e-5


@pytest.fixture(params=[(3, 3), (2, 4), (1, 2), (2, 1)], ids=["3buf", "2buf", "1buf", "1cta"])
def ring_form(request):
    """Forms of the conditioning kernel: ring depth and CTAs an SM."""
    saved = cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM
    cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM = request.param
    yield request.param
    cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM = saved


def _cond_rows(rng, n, c, w, dev):
    t = np.linspace(-1.0, 1.0, w)
    x = rng.normal(size=(n, c, w)) + rng.uniform(-20, 20, (n, c, 1)) + rng.uniform(-30, 30, (n, c, 1)) * t
    return torch.as_tensor(x.astype(np.float32), device=dev)


# (232, 3, 6000): the main path; (700, 3, 6000): several rows a CTA, the ring
# goes round; (5, 3, 3001): the plain-load path; (3, 1, MAX_SAMPLES): the
# fewest buffers; (4, 3, 24): rows shorter than a CTA
@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
@pytest.mark.parametrize("n,c,w", [(232, 3, 6000), (700, 3, 6000), (5, 3, 3001),
                                   (3, 1, cuda_cond.MAX_SAMPLES), (4, 3, 24)])
def test_condition_windows_ring_matches_twin(dev, ring_form, detrend, norm, n, c, w):
    x = _cond_rows(np.random.default_rng(n + w), n, c, w, dev)
    before = cuda_cond.launches
    got = cuda_cond.condition_windows(x, detrend=detrend, norm=norm)
    assert cuda_cond.launches == before + 1
    want = cuda_cond.condition_windows_reference(x, detrend=detrend, norm=norm)
    assert (got - want).abs().max().item() <= 2e-5
    # a buffer loaded again before its row has left shows as a difference between calls
    for _ in range(5):
        assert torch.equal(cuda_cond.condition_windows(x, detrend=detrend, norm=norm), got)


def test_condition_windows_unaligned_base(dev, ring_form):
    """A contiguous view that starts 4 bytes into its storage takes plain loads and stores."""
    n, c, w = 40, 3, 6000
    flat = _cond_rows(np.random.default_rng(3), n, c, w, dev).reshape(-1)
    store = torch.cat([flat.new_zeros(1), flat])
    x = store[1:].view(n, c, w)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    for detrend in (False, True):
        got = cuda_cond.condition_windows(x, detrend=detrend, norm="peak")
        want = cuda_cond.condition_windows_reference(x, detrend=detrend, norm="peak")
        assert (got - want).abs().max().item() <= 2e-5


def test_condition_windows_refusals(dev):
    with pytest.raises(ValueError, match="limit"):
        cuda_cond.condition_windows(torch.zeros(1, 1, cuda_cond.MAX_SAMPLES + 1, device=dev))
    x = torch.zeros(4, 3, 200, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cond.condition_windows(x[..., ::2])
    assert cuda_cond.condition_windows(torch.zeros(1, 1, cuda_cond.MAX_SAMPLES, device=dev)).shape[-1] \
        == cuda_cond.MAX_SAMPLES


# ---- addattn (K5)
@pytest.mark.parametrize("b,c,t,u,scale", [(232, 16, 47, 32, 1.0), (1, 16, 47, 32, 1.0),
                                           (3, 16, 1, 32, 1.0), (5, 8, 33, 16, 1.0),
                                           (7, 16, 64, 32, 1.0), (4, 3, 5, 7, 1.0),
                                           (9, 16, 47, 32, 20.0), (3, 16, 128, 32, 1.0),
                                           (6, 5, 9, 40, 1.0), (600, 16, 47, 32, 1.0)])
def test_addattn_matches_twin(dev, b, c, t, u, scale):
    rng = np.random.default_rng(b + t)
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev)
    q = torch.as_tensor((rng.normal(size=(b, t, u)) * scale).astype(np.float32), device=dev)
    k = torch.as_tensor((rng.normal(size=(b, t, u)) * scale).astype(np.float32), device=dev)
    wa = torch.as_tensor(rng.uniform(-0.5, 0.5, u).astype(np.float32), device=dev)
    before = cuda_addattn.launches
    got = cuda_addattn.addattn(x, q, k, wa)
    assert cuda_addattn.launches == before + 1
    assert (got - cuda_addattn.addattn_reference(x, q, k, wa)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("scale", [0.5, 20.0])
@pytest.mark.parametrize("t", [5, 47])
@pytest.mark.parametrize("b", [1, 3, 232, 256])
def test_addattn_both_entries_match_twins(dev, b, t, scale):
    """``addattn`` (q and k projected by the caller) and ``addattn_x`` (projects
    inside) against their twins, and against each other on PyTorch's
    projections; scale 20 saturates tanh."""
    rng = np.random.default_rng(b * 100 + t)
    c, u = 16, 32
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev)
    wt, wx = (torch.as_tensor((rng.normal(size=(c, u)) * scale / 4).astype(np.float32), device=dev)
              for _ in range(2))
    bh = torch.as_tensor((rng.normal(size=u) * 0.1 * scale).astype(np.float32), device=dev)
    wa = torch.as_tensor(rng.uniform(-0.3, 0.3, u).astype(np.float32), device=dev)
    before = cuda_addattn.launches
    got = cuda_addattn.addattn_x(x, wt, bh, wx, wa)
    assert cuda_addattn.launches == before + 1  # one launch a block
    assert torch.isfinite(got).all()
    assert (got - cuda_addattn.addattn_x_reference(x, wt, bh, wx, wa)).abs().max().item() <= 1e-5
    xt = x.transpose(1, 2)
    q, k = (xt @ wt + bh).contiguous(), (xt @ wx).contiguous()
    old = cuda_addattn.addattn(x, q, k, wa)
    assert cuda_addattn.launches == before + 2
    assert (old - cuda_addattn.addattn_reference(x, q, k, wa)).abs().max().item() <= 1e-5
    assert (got - old).abs().max().item() <= 1e-5


def test_seq_self_attention_is_one_launch(dev):
    model = load_model("eqtransformer", seed=2, in_samples=1504, lstm_blocks=1, device=dev)
    p = {k: v.detach() for k, v in model.transformer_d0.attention.params().items()}
    x = torch.randn(9, 16, 47, device=dev, generator=torch.Generator(dev).manual_seed(0))
    before = cuda_addattn.launches
    got = cuda_addattn.seq_self_attention(x, p)
    assert cuda_addattn.launches == before + 1
    want = cuda_addattn.addattn_x_reference(x, p["Wt"], p["bh"], p["Wx"], p["Wa"].reshape(-1))
    assert (got - want).abs().max().item() <= 1e-5


def test_addattn_refusals(dev):
    """A CTA gets at most 227 KB of shared memory (above 48 KB by the opt-in
    attribute): one window of T = 128 fits, of T = 256 (345 KB) does not."""
    wa = torch.zeros(32, device=dev)
    x = torch.zeros(1, 16, 256, device=dev)
    q = torch.zeros(1, 256, 32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_addattn.addattn(x, q, q, wa)
    w = torch.zeros(16, 32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_addattn.addattn_x(x, w, wa, w, wa)
    x = torch.zeros(2, 47, 16, device=dev).transpose(1, 2)
    q = torch.zeros(2, 47, 32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_addattn.addattn(x, q, q, wa)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_addattn.addattn_x(x, w, wa, w, wa)
    # the wrapper's count of a CTA's shared memory is the kernel's own
    smem = _build.function("addattn_smem_bytes", [ctypes.c_int] * 5)
    for c, t, u, g, project in ((16, 47, 32, 2, 1), (16, 47, 32, 1, 0), (3, 5, 7, 4, 1),
                                (5, 9, 40, 2, 0), (16, 128, 32, 1, 1)):
        assert smem(c, t, u, g, project) == cuda_addattn._smem_bytes(c, t, u, g, bool(project))
    smem16 = _build.function("addattn_bf16_smem_bytes", [ctypes.c_int] * 5)
    for c, t, u, g, project in ((16, 47, 32, 2, 1), (16, 47, 32, 1, 0), (3, 5, 7, 4, 1),
                                (5, 9, 20, 2, 0), (16, 128, 32, 1, 1), (12, 33, 16, 3, 1)):
        assert smem16(c, t, u, g, project) == cuda_addattn._smem_bytes_bf16(c, t, u, g, bool(project))


# ---- res_cnn_stack (K6)
def _res_model(dev, seed):
    model = load_model("eqtransformer", seed=seed, in_samples=1504, lstm_blocks=1, device=dev)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.res_cnn_stack.members:
            for norm in (blk.norm1, blk.norm2):
                norm.running_mean.copy_(torch.randn(64, generator=gen) * 0.3)
                norm.running_var.copy_(torch.rand(64, generator=gen) * 2 + 0.5)
                norm.weight.copy_(torch.randn(64, generator=gen) * 0.5 + 1)
                norm.bias.copy_(torch.randn(64, generator=gen) * 0.1)
    return model


@pytest.mark.parametrize("b,t", [(232, 47), (1, 47), (3, 1), (5, 12), (4, 48), (2, 13), (2, 47),
                                 (131, 47), (233, 47), (133, 12), (600, 47)])
def test_res_cnn_stack_matches_twin_and_modules(dev, b, t):
    model = _res_model(dev, seed=b)
    packed = cuda_rescnn.fold_res_cnn_params(model.res_cnn_stack)
    x = torch.as_tensor(np.random.default_rng(t).normal(size=(b, 64, t)).astype(np.float32), device=dev)
    before = cuda_rescnn.launches
    got = cuda_rescnn.res_cnn_stack(x, packed)
    assert cuda_rescnn.launches == before + 1
    assert (got - cuda_rescnn.res_cnn_stack_reference(x, packed)).abs().max().item() <= 3e-4
    with torch.inference_mode():
        h = x
        for block in model.res_cnn_stack.members:
            h = block(h)
    assert (got - h).abs().max().item() <= 3e-4


def _res_packed(rng, c, nb, dev, kernel=3):
    """Folded parameters drawn directly, at the model's scale of weights; a
    kernel of 2 has a zero -1 tap."""
    bound = (6.0 / (c * 3)) ** 0.5
    p = {k: rng.uniform(-bound, bound, (nb, 3, c, c)) for k in ("w1", "w2")}
    if kernel == 2:
        p["w1"][:, 0] = p["w2"][:, 0] = 0.0
    for k in ("cb1", "cb2", "b1", "b2"):
        p[k] = rng.normal(size=(nb, c)) * 0.1
    for k in ("g1", "g2"):
        p[k] = (rng.normal(size=(nb, c)) * 0.5 + 1) / np.sqrt(rng.random((nb, c)) * 2 + 0.5)
    return {k: torch.as_tensor(v.astype(np.float32), device=dev).contiguous() for k, v in p.items()}


@pytest.mark.parametrize("kernel", [2, 3])
@pytest.mark.parametrize("nb", [1, 7])
@pytest.mark.parametrize("c,t", [(64, 47), (64, 1), (64, 48), (16, 12), (16, 47), (24, 30), (63, 47), (2, 5)])
@pytest.mark.parametrize("b", [1, 2, 5])
def test_res_cnn_stack_shapes_and_kernels(dev, b, c, t, nb, kernel):
    """Channels under 64 (weights copied by plain loads, padded), T at both
    limits, 1 and 7 blocks, kernel-2 and kernel-3 convs, a CTA half full."""
    rng = np.random.default_rng(1000 * c + 10 * t + nb)
    packed = _res_packed(rng, c, nb, dev, kernel)
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev)
    got = cuda_rescnn.res_cnn_stack(x, packed)
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    assert (got - cuda_rescnn.res_cnn_stack_reference(x, packed)).abs().max().item() <= 3e-4


@pytest.mark.parametrize("wpc", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [1, 7, 232, 233])
def test_res_cnn_stack_windows_a_cta(dev, b, wpc, monkeypatch):
    """Every number of windows a CTA gives the twin's result, a last CTA that
    is not full included; a view that starts inside a tensor takes the same
    path (its start is a multiple of 16 bytes) or, off by one float, the
    plain loads."""
    monkeypatch.setattr(cuda_rescnn, "WINDOWS_PER_CTA", wpc)
    rng = np.random.default_rng(b + wpc)
    packed = _res_packed(rng, 64, 7, dev)
    x = torch.as_tensor(rng.normal(size=(b + 1, 64, 47)).astype(np.float32), device=dev)
    want = cuda_rescnn.res_cnn_stack_reference(x, packed)
    assert (cuda_rescnn.res_cnn_stack(x, packed) - want).abs().max().item() <= 3e-4
    assert (cuda_rescnn.res_cnn_stack(x[1:], packed) - want[1:]).abs().max().item() <= 3e-4
    flat = torch.zeros(x.numel() + 1, device=dev)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(x.shape)  # 4 bytes off a 16-byte boundary
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert (cuda_rescnn.res_cnn_stack(shifted, packed) - want).abs().max().item() <= 3e-4


def test_res_cnn_plan_matches_the_library(dev):
    fn = _build.function("rescnn_shared_bytes", [ctypes.c_int])
    per_thread = _build.function("rescnn_channels_per_thread", [])
    assert per_thread() == cuda_rescnn.CHANNELS_PER_THREAD
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for wpc in range(1, cuda_rescnn.MAX_WINDOWS + 1):
        assert fn(wpc) == cuda_rescnn.rescnn_plan(wpc * n_sm, n_sm)[2] == cuda_rescnn.rescnn_plan(9, n_sm, wpc)[2]
    assert fn(cuda_rescnn.MAX_WINDOWS) <= 232448  # what a block may take on an H100


def test_res_cnn_stack_narrow_channels(dev):
    rng = np.random.default_rng(0)
    c, nb = 24, 3
    packed = {k: torch.as_tensor(rng.normal(size=(nb, 3, c, c) if k in ("w1", "w2") else (nb, c))
                                 .astype(np.float32) * 0.2, device=dev)
              for k in ("w1", "w2", "cb1", "cb2", "g1", "b1", "g2", "b2")}
    x = torch.as_tensor(rng.normal(size=(6, c, 30)).astype(np.float32), device=dev)
    got = cuda_rescnn.res_cnn_stack(x, packed)
    assert (got - cuda_rescnn.res_cnn_stack_reference(x, packed)).abs().max().item() <= 3e-4


def test_res_cnn_stack_refusals(dev):
    model = _res_model(dev, seed=0)
    packed = cuda_rescnn.fold_res_cnn_params(model.res_cnn_stack)
    with pytest.raises(ValueError, match="limits"):  # T = 49
        cuda_rescnn.res_cnn_stack(torch.zeros(1, 64, 49, device=dev), packed)
    wide = _res_packed(np.random.default_rng(0), 65, 1, dev)
    with pytest.raises(ValueError, match="limits"):  # C = 65
        cuda_rescnn.res_cnn_stack(torch.zeros(1, 65, 47, device=dev), wide)
    x = torch.zeros(2, 47, 64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rescnn.res_cnn_stack(x, packed)
    x = torch.zeros(2, 64, 47, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rescnn.res_cnn_stack(x, dict(packed, w1=packed["w1"].transpose(2, 3)))
    with pytest.raises(TypeError, match="float32"):
        cuda_rescnn.res_cnn_stack(x.double(), packed)
    with pytest.raises(TypeError, match="float32"):
        cuda_rescnn.res_cnn_stack(x, dict(packed, g1=packed["g1"].half()))
    with pytest.raises(ValueError, match="is on"):
        cuda_rescnn.res_cnn_stack(x, dict(packed, cb1=packed["cb1"].cpu()))
    with pytest.raises(ValueError, match="no backward"):
        cuda_rescnn.res_cnn_stack(x.clone().requires_grad_(), packed)
    with pytest.raises(ValueError, match="no backward"):
        cuda_rescnn.res_cnn_stack(x, dict(packed, w2=packed["w2"].clone().requires_grad_()))
    with torch.no_grad():  # nothing to differentiate: taken
        cuda_rescnn.res_cnn_stack(x.clone().requires_grad_(), packed)
    before = cuda_rescnn.launches
    empty = cuda_rescnn.res_cnn_stack(torch.zeros(0, 64, 47, device=dev), packed)
    assert empty.shape == (0, 64, 47) and cuda_rescnn.launches == before


# ---- the opt-in route end to end
def test_optin_picker_gpu_matches_cpu(dev, monkeypatch):
    rng = np.random.default_rng(7)
    data = (rng.normal(size=(2, 3, 5000)) * 0.1).astype(np.float32) + 0.5
    data[:, :, 2500:2600] += 2.0 * np.hanning(100).astype(np.float32)
    margs = dict(in_samples=1504, lstm_blocks=1, fused="plstm+bandattn+pattn")
    gpu = WaveformPicker(load_model("eqtransformer", seed=1, device=dev, **margs), device=dev,
                         use_pallas=True)
    cpu = WaveformPicker(load_model("eqtransformer", seed=1, device="cpu", **margs), device="cpu", use_pallas=True)
    kw = dict(overlap=1128, blinding=(200, 200), batch_size=8)
    before = (cuda_addattn.launches, cuda_cond.launches, cuda_trig.scan_launches, cuda_trig.launches)
    gc = gpu.annotate_array(data, **kw)
    np.testing.assert_allclose(gc, cpu.annotate_array(data, **kw), atol=1e-4)
    assert cuda_addattn.launches > before[0] and cuda_cond.launches > before[1]
    thr = {lab: float(np.percentile(gc[:, i], 99.0)) for i, lab in enumerate(["Detection", "P", "S"])}
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", "pallas")
    res = gpu.classify_arrays(data, thr, **kw)
    assert cuda_trig.scan_launches == before[2] + 1 and cuda_trig.launches == before[3]
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", "pallas_full")
    full = gpu.classify_arrays(data, thr, **kw)
    for lab in res:
        for g, r in zip(res[lab], full[lab]):
            np.testing.assert_array_equal(g, r)
    assert sum(int(v[2].sum()) for v in res.values()) > 0


# ---- the decoder layer (K8)
UPCONV_TOL = 1e-5
# (I, O, K, T in, crop) of the full-width decoder's layers
DECODER = [(16, 64, 3, 47, 0), (64, 64, 5, 94, 0), (64, 32, 5, 188, 1), (32, 32, 7, 375, 0),
           (32, 16, 7, 750, 0), (16, 16, 9, 1500, 0), (16, 8, 11, 3000, 0)]


def _upconv_case(dev, seed, b, i, o, t, k):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, i, t, device=dev, generator=g)
    w = torch.randn(o, i, k, device=dev, generator=g) / (i * k) ** 0.5
    return x, w, torch.randn(o, device=dev, generator=g) * 0.1


def _assert_upconv_equals_twin(x, w, b, crop):
    before = cuda_upconv.launches
    got = cuda_upconv.upconv_relu(x, w, b, crop)
    assert cuda_upconv.launches == before + 1
    want = cuda_upconv.upconv_relu_reference(x, w, b, crop)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= UPCONV_TOL * scale, (err, scale)


@pytest.mark.parametrize("b", [256, 208, 16])
@pytest.mark.parametrize("layer", range(len(DECODER)))
def test_upconv_matches_twin_at_the_decoder_layers(dev, layer, b):
    i, o, k, t, crop = DECODER[layer]
    with torch.inference_mode():
        _assert_upconv_equals_twin(*_upconv_case(dev, layer, b, i, o, t, k), crop)


@pytest.mark.parametrize("b,i,o,t,k,crop", [
    (2, 3, 5, 1, 1, 1), (2, 3, 5, 1, 5, 1), (3, 4, 12, 2, 13, 1), (1, 7, 9, 13, 3, 0), (2, 1, 1, 5, 7, 0),
    (3, 5, 17, 33, 9, 1), (7, 32, 40, 101, 7, 1), (1, 100, 64, 50, 13, 0), (2, 16, 8, 6001, 11, 1),
    (300, 16, 8, 1000, 11, 0)])
def test_upconv_other_shapes(dev, b, i, o, t, k, crop):
    """Lengths that cut a tile or a 16-byte row, channels that fill no whole
    group, one-sample rows, K from 1 to 13, channel blocks, more items than CTAs."""
    with torch.inference_mode():
        _assert_upconv_equals_twin(*_upconv_case(dev, b * t + k, b, i, o, t, k), crop)


def test_upconv_refusals(dev):
    x, w, b = _upconv_case(dev, 0, 2, 4, 6, 10, 5)
    before = cuda_upconv.launches
    with pytest.raises(TypeError, match="float32"):
        cuda_upconv.upconv_relu(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_upconv.upconv_relu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="odd kernels"):
        cuda_upconv.upconv_relu(x, w[..., :4].contiguous(), b)
    with pytest.raises(ValueError, match="limit"):
        cuda_upconv.upconv_relu(x, torch.zeros(6, 4, 15, device=dev), b)
    with pytest.raises(ValueError, match="require"):
        cuda_upconv.upconv_relu(x, w.clone().requires_grad_(True), b)
    assert cuda_upconv.launches == before
    with torch.no_grad():  # weights that require grad, outside autograd: the kernel
        cuda_upconv.upconv_relu(x, w.clone().requires_grad_(True), b)
    assert cuda_upconv.launches == before + 1


def test_upconv_plan_matches_the_library(dev):
    fn = _build.function("upconv_shared_words", [ctypes.c_int] * 4)
    fn.restype = ctypes.c_longlong
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, o, k, t, _ in DECODER:
        for b in (256, 16):
            nt, _, cblocks, threads, smem = cuda_upconv.upconv_plan(b, i, o, t, k, n_sm)
            gc = threads // nt
            assert 4 * fn(k, i, gc, nt) == smem


def _clear_threshold(a, b):
    """A threshold t near the top of curves ``a`` such that no sample of
    ``a`` and ``b`` at one position lies on two sides of t or of t / 2 (the
    trigger's second threshold): the triggers of the two curves are then the
    same. Of such candidates, the one farthest from every sample of ``a``."""
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    vals = np.sort(a)

    def gap(c):
        return np.abs(vals[np.clip(np.searchsorted(vals, c) + np.array([-1, 0]), 0, vals.size - 1)] - c).min()

    best = (None, -1.0)
    for c in np.quantile(vals, np.linspace(0.98, 0.999, 200)):
        c = float(np.float32(c))
        half = float(np.float32(c) / np.float32(2.0))
        if ((a - c) * (b - c) <= 0).any() or ((a - half) * (b - half) <= 0).any():
            continue
        g = min(gap(c), gap(half))
        if g > best[1]:
            best = (c, g)
    return best


@pytest.mark.parametrize("arch,n_dec", [("eqtransformer", 3), ("voleqtransformer", 4)])
def test_eqt_forward_through_upconv_matches_its_twin(dev, arch, n_dec, monkeypatch):
    """The default route's eval forward at full width launches the kernel 7
    times a decoder a forward (21 for EQTransformer, 28 for VolEQTransformer)
    and the ``eqt.branches`` span counts them; its curves lie within 1e-4 of
    the same forward with the twin, and the picks are the twin's."""
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.models import eqtransformer as port_eqt
    from volpick_tpu_torch.utils import profiling

    rng = np.random.default_rng(17)
    data = (rng.normal(size=(4, 3, 30000)) * 0.1).astype(np.float32)
    data[:, :, 12000:12400] += 2.0 * np.hanning(400).astype(np.float32)
    model = load_model(arch, seed=1, device=dev)
    picker = WaveformPicker(model, device=dev)
    kw = dict(overlap=5500, blinding=(500, 500), batch_size=64)
    forwards = [0]
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    before = cuda_upconv.launches
    curves = picker.annotate_array(data, **kw)
    assert forwards[0] > 0 and cuda_upconv.launches == before + 7 * n_dec * forwards[0]
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]):
        model(torch.as_tensor(data[:, :, :6000], device=dev))
    span, = [s for s in profiling.spans() if s.name == "eqt.branches"][-1:]
    assert span.counts == {"upconv": 7 * n_dec}
    # seeded weights give nearly flat curves, too dense for a threshold that
    # clears every sample: stretch each head's logits about their median so
    # that the curves have isolated peaks (chip_smoke.py's rule)
    heads = [getattr(model, ck) for _, ck in model.detection_branches] + list(model.pick_convs)
    with torch.no_grad():
        for ci, head in enumerate(heads):
            pr = np.clip(curves[:, ci, 500:-500].astype(np.float64), 1e-7, 1 - 1e-7)
            lo, mid, hi = np.percentile(np.log(pr / (1 - pr)), [16, 50, 84])
            a = 3.0 / float(hi - lo)
            head.bias.copy_((head.bias - float(mid)) * a - 5.0)
            head.weight.mul_(a)
    curves = picker.annotate_array(data, **kw)
    with monkeypatch.context() as m:
        m.setattr(port_eqt, "upconv_relu", cuda_upconv.upconv_relu_reference)
        before = cuda_upconv.launches
        twin = picker.annotate_array(data, **kw)
        assert cuda_upconv.launches == before
    hook.remove()
    np.testing.assert_allclose(curves, twin, atol=1e-4)
    # thresholds on which the two curves trigger alike
    thr = {}
    for ci, lab in enumerate(picker._prob_channels()):
        thr[lab], _ = _clear_threshold(curves[:, ci], twin[:, ci])
        assert thr[lab] is not None, lab
    res = picker.classify_arrays(data, thr, **kw)
    with monkeypatch.context() as m:
        m.setattr(port_eqt, "upconv_relu", cuda_upconv.upconv_relu_reference)
        twin_res = picker.classify_arrays(data, thr, **kw)
    assert sum(int(v[2].sum()) for v in res.values()) > 0
    for lab in res:  # the same picks; their peak values within the curves' 1e-4
        (idx, val, *rest), (t_idx, t_val, *t_rest) = res[lab], twin_res[lab]
        np.testing.assert_array_equal(idx, t_idx)
        np.testing.assert_allclose(val, t_val, atol=1e-4)
        for g, r in zip(rest, t_rest):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["train", "bfloat16", "polyup", "grouped", "blockdiag"])
def test_eqt_other_routes_launch_no_upconv(dev, case):
    model = load_model("eqtransformer", seed=1, device=dev)
    x = torch.randn(4, 3, 6000, device=dev)
    before = cuda_upconv.launches
    if case == "train":
        model.train()
        with torch.no_grad():
            model(x)
    elif case == "bfloat16":
        with torch.inference_mode():
            model.eval().to(torch.bfloat16)(x.bfloat16())
    else:
        with torch.inference_mode():
            model.eval()(x, fused=f"plstm+bandattn+{case}")
    torch.cuda.synchronize()
    assert cuda_upconv.launches == before


# ---- the encoder layer (K9)
# within 1e-5 of the layer's largest output: the kernel sums the K x I products
# of an output in another order than cuDNN's float32 conv (~1e-6 apart);
# TF32's 10-bit mantissa would be ~1e-3 off, so it fails this
CONVPOOL_TOL = 1e-5
# (I, O, K, L in) of the full-width encoder's layers; layer 4 (L 375) pads its pool
ENCODER = [(3, 8, 11, 6000), (8, 16, 9, 3000), (16, 16, 7, 1500), (16, 32, 7, 750), (32, 32, 5, 375),
           (32, 64, 5, 188), (64, 64, 3, 94)]


def _refuse_layer(*args, **kwargs):
    """A wrapper that refuses every layer's shape: the model's plain route."""
    raise LayerRefused("refused")


def _assert_convpool_equals_twin(x, w, b):
    before = cuda_convpool.launches
    got = cuda_convpool.convpool_relu(x, w, b)
    assert cuda_convpool.launches == before + 1
    want = cuda_convpool.convpool_relu_reference(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= CONVPOOL_TOL * scale, (err, scale)


@pytest.mark.parametrize("b", [256, 208, 16])
@pytest.mark.parametrize("layer", range(len(ENCODER)))
def test_convpool_matches_twin_at_the_encoder_layers(dev, layer, b):
    i, o, k, length = ENCODER[layer]
    with torch.inference_mode():
        _assert_convpool_equals_twin(*_upconv_case(dev, 100 + layer, b, i, o, length, k))


def test_convpool_takes_the_shifted_pairs_of_an_odd_length(dev):
    """Layer 4 (375 -> 188): the pool pads -inf on both sides, so its pairs
    are (y[2j - 1], y[2j]): out[0] is y[0] alone and out[187] max(y[373],
    y[374]). With only the centre tap set, y is x; a one-hot x at sample s
    then lands at pooled output (s + 1) // 2, where pairs (2j, 2j + 1) would
    put it at s // 2."""
    i, o, k, length = ENCODER[4]
    w = torch.zeros(o, i, k, device=dev)
    w[:, :, (k - 1) // 2] = 1.0
    b = torch.zeros(o, device=dev)
    for s in (0, 1, 2, 185, 372, 373, 374):
        x = torch.zeros(1, i, length, device=dev)
        x[0, 0, s] = 1.0
        with torch.inference_mode():
            got = cuda_convpool.convpool_relu(x, w, b)
            want = cuda_convpool.convpool_relu_reference(x, w, b)
        torch.cuda.synchronize()
        assert got.shape == (1, o, 188) and torch.equal(got, want), s
        hot = torch.zeros(188, device=dev)
        hot[(s + 1) // 2] = 1.0
        assert torch.equal(got[0, 0], hot), s


@pytest.mark.parametrize("b,i,o,length,k", [
    (2, 3, 5, 1, 1), (2, 3, 5, 2, 4), (3, 4, 12, 3, 13), (1, 7, 9, 13, 2), (2, 1, 1, 5, 7),
    (3, 5, 17, 33, 9), (7, 32, 40, 101, 6), (1, 100, 64, 50, 12), (2, 3, 8, 6001, 11),
    (300, 8, 16, 1999, 10), (2, 64, 64, 95, 3)])
def test_convpool_other_shapes(dev, b, i, o, length, k):
    """Odd and even lengths and kernels, lengths that cut a tile or a 16-byte
    row, channels that fill no whole group, one-sample rows, channel blocks,
    more items than CTAs."""
    with torch.inference_mode():
        _assert_convpool_equals_twin(*_upconv_case(dev, b * length + k, b, i, o, length, k))


def test_convpool_refusals(dev):
    """Operands the kernel takes in no shape raise as errors, which the
    model's encoder lets through; a kernel beyond the instantiations and a
    layer whose tile fits no CTA raise ``LayerRefused``, on which the
    encoder runs its plain code."""
    x, w, b = _upconv_case(dev, 0, 2, 4, 6, 10, 5)
    before = cuda_convpool.launches
    errors = [(TypeError, "float32", (x.bfloat16(), w.bfloat16(), b.bfloat16())),
              (ValueError, "contiguous", (x.transpose(1, 2).contiguous().transpose(1, 2), w, b)),
              (ValueError, "require", (x, w.clone().requires_grad_(True), b))]
    for kind, text, args in errors:
        with pytest.raises(kind, match=text) as err:
            cuda_convpool.convpool_relu(*args)
        assert not isinstance(err.value, LayerRefused), text
    with pytest.raises(LayerRefused, match="limit"):
        cuda_convpool.convpool_relu(x, torch.zeros(6, 4, 14, device=dev), b)
    with pytest.raises(LayerRefused, match="shared memory"):
        cuda_convpool.convpool_relu(torch.zeros(2, 4096, 10, device=dev), torch.zeros(6, 4096, 13, device=dev), b)
    assert cuda_convpool.launches == before
    with torch.no_grad():  # weights that require grad, outside autograd: the kernel
        cuda_convpool.convpool_relu(x, w.clone().requires_grad_(True), b)
    assert cuda_convpool.launches == before + 1


def test_convpool_plan_matches_the_library(dev):
    fn = _build.function("convpool_shared_words", [ctypes.c_int] * 4)
    fn.restype = ctypes.c_longlong
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, o, k, length in ENCODER:
        for b in (256, 16):
            nt, _, cblocks, threads, smem = cuda_convpool.convpool_plan(b, i, o, length, k, n_sm)
            assert 4 * fn(k, i, threads // nt, nt) == smem


@pytest.mark.parametrize("arch", ["eqtransformer", "voleqtransformer"])
def test_eqt_encoder_through_convpool_matches_the_modules(dev, arch, monkeypatch):
    """The eval forward at full width launches the kernel once an encoder
    layer (7 a forward, for a strided input too; with autograd recording it
    raises) and the ``eqt.encoder`` span counts them; the
    ``stop_after="encoder"`` output lies within CONVPOOL_TOL of the largest
    output of the same forward with every layer refused (the modules' plain
    code), and the whole forward within 1e-4. No pooling kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.models import eqtransformer as port_eqt
    from volpick_tpu_torch.utils import profiling

    model = load_model(arch, seed=2, device=dev)
    x = torch.randn(256, 3, 6000, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    with pytest.raises(ValueError, match="require"):  # autograd recording: an error, not the plain code
        model(x[:2], stop_after="encoder")
    with torch.inference_mode():
        before = cuda_convpool.launches
        enc = model(x, stop_after="encoder")
        assert cuda_convpool.launches == before + 7
        strided = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert torch.equal(model(strided, stop_after="encoder"), enc)  # the encoder hands K9 a contiguous copy
        assert cuda_convpool.launches == before + 14
        out = model(x[:16])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x[:16])
        with monkeypatch.context() as m:
            m.setattr(port_eqt, "convpool_relu", _refuse_layer)
            before = cuda_convpool.launches
            plain = model(x, stop_after="encoder")
            plain_out = model(x[:16])
            assert cuda_convpool.launches == before
    torch.cuda.synchronize()
    span, = [s for s in profiling.spans() if s.name == "eqt.encoder"][-1:]
    assert span.counts == {"convpool": 7}
    rows = prof.key_averages()
    assert sum(e.count for e in rows if "convpool_relu_kernel" in e.key) == 7
    assert not [e.key for e in rows if "max_pool" in e.key]  # the pooling pass is gone
    err, scale = float((enc - plain).abs().max()), float(plain.abs().max())
    assert enc.shape == plain.shape == (256, 64, 47) and err <= CONVPOOL_TOL * scale, (err, scale)
    for g, r in zip(out, plain_out):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)


def test_classify_picks_through_convpool_equal_the_plain_encoders(dev, monkeypatch):
    """A seeded request through ``WaveformPicker.classify_arrays``: the same
    picks with the encoder through K9 and through the plain modules, at
    thresholds on which both curves (within 1e-4) trigger alike."""
    from volpick_tpu_torch.models import eqtransformer as port_eqt

    rng = np.random.default_rng(29)
    data = (rng.normal(size=(4, 3, 30000)) * 0.1).astype(np.float32)
    data[:, :, 9000:9400] += 2.0 * np.hanning(400).astype(np.float32)
    model = load_model("eqtransformer", seed=5, device=dev)
    picker = WaveformPicker(model, device=dev)
    kw = dict(overlap=5500, blinding=(500, 500), batch_size=64)
    curves = picker.annotate_array(data, **kw)
    heads = [model.conv_d] + list(model.pick_convs)
    with torch.no_grad():  # isolated peaks, as in the decoder's test
        for ci, head in enumerate(heads):
            pr = np.clip(curves[:, ci, 500:-500].astype(np.float64), 1e-7, 1 - 1e-7)
            lo, mid, hi = np.percentile(np.log(pr / (1 - pr)), [16, 50, 84])
            a = 3.0 / float(hi - lo)
            head.bias.copy_((head.bias - float(mid)) * a - 5.0)
            head.weight.mul_(a)
    before = cuda_convpool.launches
    curves = picker.annotate_array(data, **kw)
    assert cuda_convpool.launches > before
    with monkeypatch.context() as m:
        m.setattr(port_eqt, "convpool_relu", _refuse_layer)
        plain = picker.annotate_array(data, **kw)
    np.testing.assert_allclose(curves, plain, atol=1e-4)
    thr = {}
    for ci, lab in enumerate(picker._prob_channels()):
        thr[lab], _ = _clear_threshold(curves[:, ci], plain[:, ci])
        assert thr[lab] is not None, lab
    res = picker.classify_arrays(data, thr, **kw)
    with monkeypatch.context() as m:
        m.setattr(port_eqt, "convpool_relu", _refuse_layer)
        plain_res = picker.classify_arrays(data, thr, **kw)
    assert sum(int(v[2].sum()) for v in res.values()) > 0
    for lab in res:
        (idx, val, *rest), (p_idx, p_val, *p_rest) = res[lab], plain_res[lab]
        np.testing.assert_array_equal(idx, p_idx)
        np.testing.assert_allclose(val, p_val, atol=1e-4)
        for g, r in zip(rest, p_rest):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kernel_sizes,refused", [((11, 9, 7, 7, 5, 5, 4), (0, 1)), ((15, 9, 7, 7, 5, 5, 3), (1, 1))],
                         ids=["even", "k15"])
def test_eqt_with_kernels_the_wrappers_refuse_runs_on_the_card(dev, kernel_sizes, refused):
    """An even decoder kernel (K8 refuses it; K9 takes even kernels) and a
    15-sample one (beyond both kernels' instantiations): the eval forward
    runs, those layers launch nothing, the others one launch each, and the
    curves lie within 1e-4 of the CPU port's (float32 sums in other orders)."""
    import copy

    enc_refused, dec_refused = refused
    cpu = load_model("eqtransformer", seed=6, device="cpu", kernel_sizes=kernel_sizes)
    gpu = copy.deepcopy(cpu).to(dev)
    x = torch.randn(8, 3, 6000, generator=torch.Generator().manual_seed(7))
    before = (cuda_convpool.launches, cuda_upconv.launches)
    with torch.inference_mode():
        got = gpu(x.to(dev))
        want = cpu(x)
    torch.cuda.synchronize()
    assert cuda_convpool.launches - before[0] == 7 - enc_refused
    assert cuda_upconv.launches - before[1] == 3 * (7 - dec_refused)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=0)


# ---- training
def _train_batch(n, w, dtype, device):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 3, w))
    x /= np.abs(x).max(axis=-1, keepdims=True)
    on = np.stack([rng.uniform(0.1 * w, 0.5 * w, n), np.zeros(n)], axis=1)
    on[:, 1] = on[:, 0] + rng.uniform(0.05 * w, 0.2 * w, n)
    on = torch.as_tensor(on, dtype=torch.float32)
    batch = {"X": torch.as_tensor(x, dtype=torch.float32),
             "y": probabilistic_labels(on, w, noise_column=False),
             "detections": detection_labels(on[:, 0], on[:, 1], w)}
    return {k: v.to(device, dtype) for k, v in batch.items()}


def test_train_step_on_the_card_matches_the_cpu_port(dev):
    """One Trainer step (EMA on, no dropout) of a small EQTransformer on the
    card and on the CPU from the same parameters and batch, in float64 (in
    float32 two summation orders move gradient sums that nearly cancel by up
    to ~1e-2 of a tensor's largest entry); the float32 step launches no
    kernel."""
    import copy

    cpu = load_model("eqtransformer", seed=4, in_samples=1504, lstm_blocks=1, drop_rate=0.0,
                     device="cpu").double()
    gpu = copy.deepcopy(cpu).to(dev)
    tc, tg = Trainer(cpu, ema=True, device="cpu"), Trainer(gpu, ema=True, device=dev)
    lc = float(tc.train_step(_train_batch(6, 1504, torch.float64, "cpu"), 1e-3))
    lg = float(tg.train_step(_train_batch(6, 1504, torch.float64, dev), 1e-3))
    assert abs(lg - lc) <= 1e-10 * abs(lc)
    zero = {f"res_cnn_stack.members.{j}.conv1.bias" for j in range(7)} | {
        "bi_lstm_stack.members.0.conv.bias", "transformer_d0.attention.ba", "transformer_d.attention.ba",
        "pick_attentions.0.ba", "pick_attentions.1.ba"}
    gp = dict(gpu.named_parameters())
    for name, q in cpu.named_parameters():
        g_gpu = gp[name].grad.cpu()
        if name not in zero:
            assert (g_gpu - q.grad).abs().max().item() <= 1e-6 * q.grad.abs().max().item(), name
        assert (gp[name].detach().cpu() - q.detach()).abs().max().item() <= 1e-9, name
    for name, e in tc.ema_params.items():
        assert (tg.ema_params[name].cpu() - e).abs().max().item() <= 1e-9, name

    model = load_model("eqtransformer", seed=4, in_samples=1504, lstm_blocks=1, device=dev)
    before = (cuda_lstm.launches, cuda_addattn.launches, cuda_trig.launches)
    loss = Trainer(model, device=dev).train_step(_train_batch(6, 1504, torch.float32, dev), 1e-3,
                                                 torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert (cuda_lstm.launches, cuda_addattn.launches, cuda_trig.launches) == before


def test_kernel_wrappers_refuse_autograd_inputs(dev):
    """Every CUDA wrapper raises on an input that requires grad while
    autograd records, and runs under torch.no_grad()."""
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape):
        return torch.rand(shape, device=dev, generator=g)

    calls = {
        "trigger_extract": (cuda_trig.trigger_extract, lambda: (r(4, 300), r(4) * 0 + 0.5, r(4) * 0 + 0.25, 8)),
        "trigger_scan": (cuda_trig.trigger_scan, lambda: (r(4, 300), r(4) * 0 + 0.5, r(4) * 0 + 0.25)),
        "condition_windows": (cuda_cond.condition_windows, lambda: (r(4, 3, 600),)),
        "addattn": (cuda_addattn.addattn, lambda: (r(2, 16, 47), r(2, 47, 32), r(2, 47, 32), r(32))),
        "addattn_x": (cuda_addattn.addattn_x, lambda: (r(2, 16, 47), r(16, 32), r(32), r(16, 32), r(32))),
        "mha": (cuda_attn.mha, lambda: (r(2, 64, 20), r(2, 64, 20), r(2, 64, 20), 2)),
        "mha_qkv": (cuda_attn.mha_qkv, lambda: (r(2, 20, 3, 2, 32), 0.17)),
        "lstm_multi": (cuda_lstm.lstm_multi, lambda: (r(2, 3, 16, 47), r(2, 64, 16), r(2, 64, 16), r(2, 64))),
        "lstm_branches": (cuda_lstm.lstm_branches,
                          lambda: (r(3, 16, 47), r(2, 64, 16), r(2, 64, 16), r(2, 64), (False, True))),
        "upconv_relu": (cuda_upconv.upconv_relu, lambda: (r(2, 16, 47), r(8, 16, 5), r(8))),
        "convpool_relu": (cuda_convpool.convpool_relu, lambda: (r(2, 3, 600), r(8, 3, 11), r(8))),
    }
    for name, (fn, make) in calls.items():
        args = make()
        tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        for i in (tensors[0], tensors[-1]):
            bad = list(args)
            bad[i] = args[i].clone().requires_grad_()
            with pytest.raises(ValueError, match="no backward"):
                fn(*bad)
            with torch.no_grad():
                fn(*bad)
        fn(*args)
    torch.cuda.synchronize()
    # a model whose parameters require grad: eval mode on the card reaches K2
    # and refuses; under no_grad it runs
    model = load_model("eqtransformer", seed=0, in_samples=1504, lstm_blocks=1, device=dev)
    x = r(2, 3, 1504)
    with pytest.raises(ValueError, match="no backward"):
        model(x)
    with torch.no_grad():
        assert len(model(x)) == 3


def test_eval_sweep_on_the_card_equals_the_per_threshold_path(dev, tmp_path):
    """evaluate_sweep on the card (one forward a batch, K1 twice a batch at
    (9 thresholds x 256, 6000), K = 64) gives exactly the pick lists of the
    per-threshold path on the card's curves; K1 equals its twin on the
    sweep's (2304, 6000) rows of the first batch. A full-width seeded
    EQTransformer with its heads' logits stretched (median at -5, the 99.9th
    percentile at 0), so that the curves have isolated peaks."""
    from volpick_tpu_torch.data.synthetic import synthetic_arrays, synthetic_dataset
    from volpick_tpu_torch.eval import generate_task0
    from volpick_tpu_torch.eval import task0 as et0

    # by its path: where a package named `tests` is installed, it shadows this directory
    spec = importlib.util.spec_from_file_location("torch_heads", Path(__file__).with_name("torch_heads.py"))
    heads = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(heads)
    stretch_eqt_heads = heads.stretch_eqt_heads

    ds = synthetic_dataset(*synthetic_arrays(n_events=240, n_noise=40, n_samples=9000, seed=3))
    targets = generate_task0(ds, tmp_path, noise_before_events=True).reset_index(drop=True)
    assert len(targets) > 256
    model = load_model("eqtransformer", seed=0, device=dev)
    runner = et0._SteeredRunner(model, batch_size=256, device=dev)
    flat, borders = runner.prob_curves(ds, targets.iloc[:256])
    t = np.arange(flat.shape[-1])[None, :]
    region = (t >= borders[:, :1]) & (t < borders[:, 1:2])
    stretch_eqt_heads(model, [np.log(p / (1 - p)) for p in (flat[:, ki][region] for ki in range(3))])
    thresholds = tuple(np.arange(0.1, 0.95, 0.1))
    curves = runner.prob_curves(ds, targets)
    before = (cuda_trig.launches, cuda_lstm.launches)
    sweep = et0.evaluate_sweep(model, ds, targets, thresholds, batch_size=256, device=dev)
    n_batches = -(-len(targets) // 256)
    assert (cuda_trig.launches - before[0], cuda_lstm.launches - before[1]) == (2 * n_batches, 4 * n_batches)
    n_picks = 0
    for thr, (p_s, s_s) in zip(thresholds, sweep):
        p_e, s_e = et0.evaluate(model, ds, targets, thr, curves=curves, device=dev)
        for a, b in zip(p_s + s_s, p_e + s_e):
            np.testing.assert_array_equal(a, b)
            n_picks += len(a)
    assert n_picks > len(targets)

    preds = torch.as_tensor(curves[0][:256, 1] * region, device=dev)
    rows = preds.repeat(len(thresholds), 1).contiguous()
    t1 = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev).repeat_interleave(256)
    assert rows.shape == (2304, flat.shape[-1])
    _assert_extract_equals_twin(rows, t1, t1 / 2.0, 64)


BF16 = torch.bfloat16


def _bf16_close(got: torch.Tensor, want: torch.Tensor, extra) -> None:
    """bf16 outputs within 2^-7 |twin| + `extra` of the twin's."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    tol = 2.0 ** -7 * want.float().abs() + extra
    assert bool(torch.isfinite(got.float()).all())
    assert bool((d <= tol).all()), float((d - tol).max())


@pytest.mark.parametrize("b,c,h,t", [(232, 64, 16, 47), (232, 16, 16, 47), (7, 16, 8, 5), (33, 12, 32, 60)])
def test_lstm_bf16_entries_match_twins(dev, b, c, h, t):
    """The fused bf16 body, one launch a call in both forms, and under the
    profiler ten rows of that one kernel for ten calls of lstm_branches (no
    gemm beside them)."""
    rng = np.random.default_rng(b + c)
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev).to(BF16)
    w = [a.to(BF16) for a in _lstm_args(dev, rng, 2, c, h)]
    before = (cuda_lstm.launches, cuda_lstm.bf16_launches)
    got = cuda_lstm.lstm_branches(x, *w, reverse=(False, True))
    assert (cuda_lstm.launches, cuda_lstm.bf16_launches) == (before[0] + 1, before[1] + 1)
    _bf16_close(got, cuda_lstm.lstm_branches_reference(x, *w, reverse=(False, True)), 2.0 ** -9)
    xs = torch.stack([x, x.flip(-1)])
    _bf16_close(cuda_lstm.lstm_multi(xs, *w), cuda_lstm.lstm_multi_reference(xs, *w), 2.0 ** -9)
    assert (cuda_lstm.launches, cuda_lstm.bf16_launches) == (before[0] + 2, before[1] + 2)
    from volpick_tpu_torch.picker.stage_times import profiled

    events = profiled(lambda: [cuda_lstm.lstm_branches(x, *w, reverse=(False, True)) for _ in range(10)])[2]
    kernels = {e.key: e.count for e in events if str(e.device_type).endswith("CUDA")}
    assert len(kernels) == 1 and "lstm_multi_kernel_bf16" in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 10


@pytest.mark.parametrize("b,t", [(232, 47), (1, 47), (3, 5), (256, 47)])
def test_addattn_bf16_entries_match_twins(dev, b, t):
    rng = np.random.default_rng(b * t)
    x = torch.as_tensor(rng.normal(size=(b, 16, t)).astype(np.float32), device=dev).to(BF16)
    wt, wx = (torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32) * 0.3, device=dev).to(BF16)
              for _ in range(2))
    bh, wa = (torch.as_tensor(rng.normal(size=32).astype(np.float32) * 0.3, device=dev).to(BF16)
              for _ in range(2))
    before = cuda_addattn.launches
    _bf16_close(cuda_addattn.addattn_x(x, wt, bh, wx, wa), cuda_addattn.addattn_x_reference(x, wt, bh, wx, wa),
                1e-6)
    xt = x.transpose(1, 2)
    q = (xt @ wt + bh).contiguous()
    k = (xt @ wx).contiguous()
    _bf16_close(cuda_addattn.addattn(x, q, k, wa), cuda_addattn.addattn_reference(x, q, k, wa), 1e-6)
    assert cuda_addattn.launches == before + 2


@pytest.mark.parametrize("b,c,t,u", [(5, 8, 12, 16), (9, 12, 33, 20)])
def test_addattn_bf16_body_at_other_widths(dev, b, c, t, u):
    """Channels not a multiple of 16 and units padded to 16 or 32; U above
    32 is refused (the body keeps a row of q in registers)."""
    rng = np.random.default_rng(b + c + t + u)
    x = torch.as_tensor(rng.normal(size=(b, c, t)).astype(np.float32), device=dev).to(BF16)
    wt, wx = (torch.as_tensor(rng.normal(size=(c, u)).astype(np.float32) * 0.3, device=dev).to(BF16)
              for _ in range(2))
    bh, wa = (torch.as_tensor(rng.normal(size=u).astype(np.float32) * 0.3, device=dev).to(BF16)
              for _ in range(2))
    _bf16_close(cuda_addattn.addattn_x(x, wt, bh, wx, wa), cuda_addattn.addattn_x_reference(x, wt, bh, wx, wa),
                1e-6)
    wide = torch.zeros(c, 33, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="U <= 32"):
        cuda_addattn.addattn_x(x, wide, wide[0], wide, wide[0])


@pytest.mark.parametrize("b,t,dh", [(128, 94, 32), (3, 5, 8), (5, 127, 16), (2, 40, 6), (128, 128, 32)])
def test_mha_bf16_entries_match_twins(dev, b, t, dh):
    """The tensor-core body in both entries, one launch each, against the bf16
    twins; the float32 entries on the same values still within 1e-5."""
    rng = np.random.default_rng(b + t + dh)
    qkv32 = torch.as_tensor(rng.normal(size=(b, t, 3, 4, dh)).astype(np.float32), device=dev)
    qkv = qkv32.to(BF16)
    # a window's and head's largest |v|, (b, 4 * dh)
    v_max = qkv[:, :, 2].float().abs().amax(dim=(1, 3)).repeat_interleave(dh, dim=1)
    before = (cuda_attn.launches, cuda_attn.bf16_launches)
    got = cuda_attn.mha_qkv(qkv, dh ** -0.5)
    assert (cuda_attn.launches, cuda_attn.bf16_launches) == (before[0] + 1, before[1] + 1)
    _bf16_close(got, cuda_attn.mha_qkv_reference(qkv, dh ** -0.5), 2.0 ** -8 * v_max[:, None, :])
    q, k, v = _head_major(qkv, 1.0)
    got_hm = cuda_attn.mha(q, k, v, 4)
    assert (cuda_attn.launches, cuda_attn.bf16_launches) == (before[0] + 2, before[1] + 2)
    _bf16_close(got_hm, cuda_attn.mha_reference(q, k, v, 4), 2.0 ** -8 * v_max[:, :, None])
    got32 = cuda_attn.mha_qkv(qkv32, dh ** -0.5)
    assert (got32 - cuda_attn.mha_qkv_reference(qkv32, dh ** -0.5)).abs().max().item() <= 1e-5
    q, k, v = _head_major(qkv32, dh ** -0.5)
    assert (cuda_attn.mha(q, k, v, 4) - cuda_attn.mha_reference(q, k, v, 4)).abs().max().item() <= 1e-5
    assert (cuda_attn.launches, cuda_attn.bf16_launches) == (before[0] + 4, before[1] + 2)


def test_bf16_wrappers_refuse_grad_and_float16(dev):
    rng = np.random.default_rng(0)
    x = torch.zeros(4, 16, 47, device=dev, dtype=BF16)
    w = [a.to(BF16) for a in _lstm_args(dev, rng, 2, 16, 16)]
    wt = torch.zeros(16, 32, device=dev, dtype=BF16)
    bh = torch.zeros(32, device=dev, dtype=BF16)
    qkv = torch.zeros(2, 10, 3, 2, 16, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="grad"):
        cuda_lstm.lstm_branches(x.clone().requires_grad_(), *w, reverse=(False, True))
    with pytest.raises(ValueError, match="grad"):
        cuda_addattn.addattn_x(x, wt.clone().requires_grad_(), bh, wt, bh)
    with pytest.raises(ValueError, match="grad"):
        cuda_attn.mha_qkv(qkv.clone().requires_grad_(), 0.25)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_branches(x.half(), *(a.half() for a in w), reverse=(False, True))
    with pytest.raises(TypeError):
        cuda_lstm.lstm_branches(x, w[0].float(), *w[1:], reverse=(False, True))
    with pytest.raises(TypeError):
        cuda_addattn.addattn_x(x.half(), wt.half(), bh.half(), wt.half(), bh.half())
    with pytest.raises(TypeError):
        cuda_attn.mha_qkv(qkv.half(), 0.25)
    with pytest.raises(TypeError):
        q = torch.zeros(2, 32, 10, device=dev, dtype=torch.float16)
        cuda_attn.mha(q, q, q, 2)


def test_bf16_picker_launches_the_bf16_kernels(dev):
    """A bf16 EQTransformer picker on the card goes through K2's bf16
    instantiation, 4 launches a forward, and its curves stay within 0.1 of
    the float32 picker's."""
    model = load_model("eqtransformer", seed=0, in_samples=1504, lstm_blocks=1, device=dev)
    data = np.random.default_rng(1).normal(size=(2, 3, 4000)).astype(np.float32)
    want = WaveformPicker(model, device=dev).annotate_array(data, overlap=752, batch_size=8)
    picker = WaveformPicker(model, device=dev, precision="bfloat16")
    cuda_lstm.launches = cuda_lstm.bf16_launches = 0
    got = picker.annotate_array(data, overlap=752, batch_size=8)
    assert cuda_lstm.bf16_launches == cuda_lstm.launches > 0 and cuda_lstm.launches % 4 == 0
    assert got.dtype == np.float32 and np.abs(got - want).max() <= 0.1


def test_bench_throughput_picks_equal_classify(dev):
    """The bench's timing on one station of the bench stream: a positive
    rate, K1 once a call, and picks (at thresholds that raise some) exactly
    a direct classify_arrays call's."""
    from volpick_tpu_torch import bench
    from volpick_tpu_torch.picker.stage_times import bench_stream_array

    data = np.ascontiguousarray(bench_stream_array(0)[:1])
    picker = bench.make_picker(load_model("eqtransformer", seed=0, device=dev), dev)
    before = cuda_trig.launches
    res = bench.throughput(picker, data, iters_a=1, iters_b=2)
    assert cuda_trig.launches == before + 1 + 2 * 3
    assert res.windows == 229 and np.isfinite(res.windows_per_s) and res.windows_per_s > 0
    direct = picker.classify_arrays(data, bench.THRESHOLDS, overlap=bench.OVERLAP, blinding=bench.BLINDING,
                                    stacking="avg", batch_size=bench.BATCH, max_picks=bench.MAX_PICKS)
    assert res.n_picks == int(direct["P"][2].sum()) > 0
    for lab in direct:
        for a, b, c in zip(res.first[lab], res.last[lab], direct[lab]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def test_classify_spans_hold_its_launches_and_time_the_device(dev):
    """A classify_arrays of a full-width EQTransformer in a profiler session
    of the device's activity (the benchmark's traced slice): at least 99.9%
    of the CUDA launch calls the host made during the call lie inside its
    root ``classify`` span, every device-timed span has a positive
    ``device_ms``, and no span shows up as device activity."""
    import re
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.picker.stage_times import PROFILE_PAD_S
    from volpick_tpu_torch.utils import profiling

    launch = re.compile(r"^(cudaLaunchKernel(ExC)?|cudaLaunchCooperativeKernel|cuLaunchKernel(Ex)?|"
                        r"cudaMemcpyAsync|cudaMemsetAsync)(_v\d+)?$")
    rng = np.random.default_rng(5)
    data = (rng.normal(size=(4, 3, 30000)) * 0.1).astype(np.float32)
    picker = WaveformPicker(load_model("eqtransformer", seed=1, device=dev), device=dev)
    kw = dict(overlap=5500, blinding=(500, 500), batch_size=64)
    thr = {"Detection": 0.5, "P": 0.5, "S": 0.5}
    picker.classify_arrays(data, thr, **kw)  # builds and loads the kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        t0 = time.time_ns()
        picker.classify_arrays(data, thr, **kw)
        torch.cuda.synchronize()
        t1 = time.time_ns()
        time.sleep(PROFILE_PAD_S)
    got = [s for s in profiling.spans() if s.start_ns >= t0]
    root, = [s for s in got if s.parent is None]
    assert root.name == "classify" and root.end_ns <= t1
    events = list(prof.profiler.kineto_results.events())
    calls = [e.start_ns() for e in events if e.device_type() != DeviceType.CUDA and launch.match(e.name())
             and t0 <= e.start_ns() <= t1]
    inside = sum(root.start_ns <= t <= root.end_ns for t in calls)
    assert len(calls) > 100 and inside >= 0.999 * len(calls), (inside, len(calls))
    timed = [s for s in got if s.name in ("condition", "forward", "stack", "triggers") or s.name.startswith("eqt.")]
    assert {s.name for s in timed} == {"condition", "forward", "stack", "triggers", "eqt.encoder", "eqt.res_cnn",
                                       "eqt.bilstm", "eqt.transformer", "eqt.branches"}
    assert all(s.device_ms > 0 for s in timed), [(s.name, s.device_ms) for s in timed if not s.device_ms > 0]
    assert all(s.device_ms is None for s in got if s not in timed)
    device_names = {e.name() for e in events if e.device_type() == DeviceType.CUDA}
    assert not device_names & {s.name for s in got}


def test_native_readers_build_under_the_ports_build_directory(dev, tmp_path):
    """On the card machine too, g++ builds the miniSEED decoder from
    ``native/miniseed.cpp`` into ``build/volpick_tpu_torch/``."""
    from volpick_tpu_torch.core.stream import Stream, Trace, UTC
    from volpick_tpu_torch.io import _native, read_mseed, write_mseed

    tr = Trace(np.arange(5000, dtype=np.float32), dict(network="XX", station="A", channel="HHZ",
                                                        sampling_rate=100.0, starttime=UTC(0)))
    write_mseed(Stream([tr]), tmp_path / "a.mseed")
    np.testing.assert_array_equal(read_mseed(tmp_path / "a.mseed")[0].data, tr.data)
    path = _native.library_path("miniseed")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.parent.name == "volpick_tpu_torch" and path.parent.parent.name == "build"
    assert not any(p.name == "volpick_tpu" for p in path.parents)


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


def test_swa_fit_on_the_card_matches_the_cpu_port(dev, tmp_path):
    """A 2-epoch SWA fit (swa_epoch_start 0: both epochs collect; swa_lrs
    5e-4) of a small EQTransformer without dropout on the card and on the
    CPU from the same parameters and batches, in float64: swa_n 2 and
    swa_params within 1e-9 of the CPU's. The same fit in float32 with a
    validation batch launches K2 twice a validation forward (one BiLSTM
    block, the pick LSTMs) and nothing in a train step."""
    import copy

    swa = {"swa_lrs": 5e-4, "swa_epoch_start": 0}
    cpu = load_model("eqtransformer", seed=4, in_samples=1504, lstm_blocks=1, drop_rate=0.0,
                     device="cpu").double()
    gpu = copy.deepcopy(cpu).to(dev)
    trainers = {}
    for key, model, where in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        t = Trainer(model, swa=swa, warmup_steps=0, device=where)
        batches = [_train_batch(6, 1504, torch.float64, where)] * 2
        t.fit(_Batches(batches), None, max_epochs=2, save_dir=str(tmp_path / key), tensorboard=False)
        trainers[key] = t
    tc, tg = trainers["cpu"], trainers["card"]
    assert tc.swa_n == tg.swa_n == 2
    for name, v in tc.swa_params.items():
        assert (tg.swa_params[name].cpu() - v).abs().max().item() <= 1e-9, name

    model = load_model("eqtransformer", seed=4, in_samples=1504, lstm_blocks=1, device=dev)
    t = Trainer(model, swa=swa, warmup_steps=0, device=dev)
    batch = _train_batch(6, 1504, torch.float32, dev)
    before = cuda_lstm.launches
    t.fit(_Batches([batch]), _Batches([batch]), max_epochs=2, save_dir=str(tmp_path / "f32"), tensorboard=False)
    torch.cuda.synchronize()
    # two validation forwards, each with K2 once for its BiLSTM block and once for the pick LSTMs
    assert cuda_lstm.launches - before == 2 * 2 and t.swa_n == 2


def test_prediction_examples_on_the_card_match_the_cpu(dev):
    """plot_prediction_examples' curves for a full-width seeded EQTransformer
    on the card, within 2e-4 of the same call with device="cpu" (the EQT
    forward pin), K2 4 times a trace. Gated on the matplotlib probe: where
    ``importlib.util.find_spec("matplotlib")`` finds none (the H100 machine
    has none), the arrays the panels would draw (``_prediction_arrays``)
    are held instead of the figures."""
    from volpick_tpu_torch.data.synthetic import synthetic_arrays, synthetic_dataset
    from volpick_tpu_torch.pipeline.generator import _onset_arrays
    from volpick_tpu_torch.utils import plotting

    ds = synthetic_dataset(*synthetic_arrays(n_events=2, n_noise=1, n_samples=9000, seed=1))
    model = load_model("eqtransformer", seed=0, device=dev)
    cpu_model = load_model("eqtransformer", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    shown = [0, 1, 2]
    p_all, s_all = _onset_arrays(ds.metadata)

    def curves(m, d):
        if importlib.util.find_spec("matplotlib") is not None:
            return [{ln.get_label(): np.asarray(ln.get_ydata()) for ln in fig.axes[3].get_lines()
                     if not ln.get_label().startswith("_")}
                    for fig in plotting.plot_prediction_examples(m, ds, shown, device=d)]
        return [plotting._prediction_arrays(m, ds.get_sample(i)[0], p_all[i], s_all[i], torch.device(d))[1]
                for i in shown]

    before = cuda_lstm.launches
    got = curves(model, dev)
    assert cuda_lstm.launches - before == 4 * len(shown)
    want = curves(cpu_model, "cpu")
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["Detection", "P", "S"]
        for k in g:
            assert g[k].shape == (model.in_samples,) and np.abs(g[k] - w[k]).max() <= 2e-4, k


def test_nccl_world_of_one_equals_one_device(dev, tmp_path):
    """A world of one NCCL rank (a file store under tmp_path): a Trainer step
    over its mesh of a small EQTransformer (EMA on, drop_rate 0.1; global
    BatchNorm, dropout drawn at the global shape, gradients all-reduced) in
    float64 equals the plain step on the same batch and dropout seed (loss
    1e-10 relative, parameters, BatchNorm statistics and EMA 1e-9, the pins
    above), and WaveformPicker(mesh=) returns the plain picker's picks
    exactly, launching K1 once."""
    import copy
    import datetime

    import torch.distributed as dist

    from volpick_tpu_torch.parallel import make_mesh

    kw = dict(seed=4, in_samples=1504, lstm_blocks=1, device=dev)
    plain_model = load_model("eqtransformer", drop_rate=0.1, **kw).double()
    dp_model = copy.deepcopy(plain_model)
    batch = _train_batch(6, 1504, torch.float64, dev)
    plain = Trainer(plain_model, ema=True, device=dev)
    l_plain = float(plain.train_step(batch, 1e-3, plain.dropout_generator(5)))

    rng = np.random.default_rng(0)
    data = (rng.normal(size=(2, 3, 12000)) * 0.05).astype(np.float32)
    pick_kw = dict(overlap=1128, blinding=(200, 200), batch_size=16)
    curves = WaveformPicker(load_model("eqtransformer", **kw), device=dev).annotate_array(data, **pick_kw)
    thr = {lab: float(np.percentile(curves[:, i], 99.5)) for i, lab in enumerate(("Detection", "P", "S"))}
    want = WaveformPicker(load_model("eqtransformer", **kw), device=dev).classify_arrays(data, thr, **pick_kw)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(device=dev)
        assert mesh.device == dev
        dp = Trainer(dp_model, ema=True)
        assert dp.mesh is not None and dp.shard == (0, 1)
        l_dp = float(dp.train_step(batch, 1e-3, dp.dropout_generator(5)))
        before = cuda_trig.launches
        got = WaveformPicker(load_model("eqtransformer", **kw), mesh=mesh).classify_arrays(data, thr, **pick_kw)
        assert cuda_trig.launches == before + 1
    finally:
        dist.destroy_process_group()
    assert abs(l_dp - l_plain) <= 1e-10 * abs(l_plain)
    for name, v in plain_model.state_dict().items():
        assert (dp_model.state_dict()[name] - v).abs().max().item() <= 1e-9, name
    for name, v in plain.ema_params.items():
        assert (dp.ema_params[name] - v).abs().max().item() <= 1e-9, name
    assert sum(int(v[2].sum()) for v in want.values()) > 0
    for label, arrs in want.items():
        for a, b in zip(arrs, got[label]):
            np.testing.assert_array_equal(b, a, err_msg=label)
