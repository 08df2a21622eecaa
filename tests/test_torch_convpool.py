"""EQTransformer's encoder layer as one kernel (``ops/cuda/convpool.py``) on the CPU.

The wrapper runs its twin for a CPU tensor. Held here: the twin bitwise
against the encoder code the model ran before the kernel, at each of the
seven layers of the full-width encoder and at odd and even lengths and
kernels; the twin against the JAX package's encoder layer (1e-5: two float32
convolutions that sum in other orders); the index rules of
``csrc/convpool.cu`` (staged columns, pairs shifted by an odd length's
padding, max before bias and ReLU), written out in float64, against the twin
in float64 (1e-12: the same products summed in another order); the launch
plan; the refusals; the model's route, which sends every layer of the
float32 eval forward through the wrapper and is unchanged on the CPU. The
kernel itself is held against its twin in ``tests/test_torch_cuda.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from volpick_tpu.models import layers as jlayers
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer
from volpick_tpu_torch.models import eqtransformer as port_eqt
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.ops.cuda import LayerRefused, convpool

JAX_ATOL = 1e-5
INDEX_ATOL = 1e-12
N_SM = 132  # an H100 SXM
# (I, O, K, L in) of the full-width encoder's layers at 6000 samples; the
# pool pads one sample where L is odd (layer 4: 375 -> 188)
ENCODER = [(3, 8, 11, 6000), (8, 16, 9, 3000), (16, 16, 7, 1500), (16, 32, 7, 750), (32, 32, 5, 375),
           (32, 64, 5, 188), (64, 64, 3, 94)]


def _layer(rng, b, i, o, k, length, dtype=np.float32):
    x = rng.normal(size=(b, i, length)).astype(dtype)
    w = (rng.normal(size=(o, i, k)) / np.sqrt(i * k)).astype(dtype)
    return x, w, (rng.normal(size=o) * 0.1).astype(dtype)


def _refused(*args, **kwargs):
    """A wrapper that refuses every layer's shape: the model's plain route."""
    raise LayerRefused("refused")


def _old_layer(x, w, b):
    """The encoder layer as ``EQTransformer.encode`` wrote it before the kernel."""
    return tlayers.max_pool1d(F.relu(tlayers.conv1d_same(x, w, b)), 2, padding=x.shape[-1] % 2)


def test_encoder_shapes_are_the_models():
    model = EQTransformer()
    got, length = [], model.in_samples
    for conv, pad in zip(model.encoder.convs, model._pool_pads):
        o, i, k = conv.weight.shape
        got.append((i, o, k, length))
        assert pad == length % 2
        length = (length + pad) // 2
    assert got == ENCODER


@pytest.mark.parametrize("layer", range(len(ENCODER)))
def test_twin_is_the_old_encoder_layer_bitwise(layer):
    i, o, k, length = ENCODER[layer]
    rng = np.random.default_rng(layer)
    x, w, b = (torch.as_tensor(a) for a in _layer(rng, 2, i, o, k, length))
    got = convpool.convpool_relu(x, w, b)
    assert got.shape == (2, o, (length + length % 2) // 2)
    assert torch.equal(got, _old_layer(x, w, b))
    assert torch.equal(convpool.convpool_relu_reference(x, w, b), got)


@pytest.mark.parametrize("length", [1, 2, 3, 8, 13, 94, 375])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 11, 14])
def test_twin_at_odd_and_even_lengths_and_kernels(k, length):
    rng = np.random.default_rng(k * 1000 + length)
    x, w, b = (torch.as_tensor(a) for a in _layer(rng, 3, 4, 6, k, length))
    got = convpool.convpool_relu(x, w, b)
    assert got.shape == (3, 6, (length + length % 2) // 2)
    assert torch.equal(got, _old_layer(x, w, b))


@pytest.mark.parametrize("layer", [0, 4, 6])
def test_twin_matches_the_jax_encoder_layer(layer):
    i, o, k, length = ENCODER[layer]
    rng = np.random.default_rng(10 + layer)
    x, w, b = _layer(rng, 2, i, o, k, length)
    want = jlayers.max_pool1d(jnp.maximum(jlayers.conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 0),
                              2, padding=length % 2)
    got = convpool.convpool_relu(*(torch.as_tensor(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)


def _kernel_arithmetic(x, w, b, nt=8):
    """csrc/convpool.cu's arithmetic in float64 with its index rules: an item
    is a tile of M = 4 nt pooled outputs from j0; its staged column c holds
    x[2 j0 - q - pl + c] (zero outside [0, L)); lane tl's pair m of output j
    = j0 + 4 tl + m sums w[:, :, k] times columns 8 tl + 2 m + r + k for r =
    0, 1; the max of the pair (only r = 1 at j = 0 of an odd length), the
    bias, ReLU."""
    bn, i, length = x.shape
    o, _, k = w.shape
    q, pl = length % 2, (k - 1) // 2
    lp = (length + q) // 2
    m_tile = 4 * nt
    row_words = (nt - 1) * 8 + (8 + k - 1 + 3) // 4 * 4
    out = torch.zeros((bn, o, lp), dtype=x.dtype)
    for j0 in range(0, lp, m_tile):
        s = torch.arange(row_words) + 2 * j0 - q - pl
        inside = (s >= 0) & (s < length)
        xs = torch.where(inside, x[:, :, s.clamp(0, length - 1)], torch.zeros((), dtype=x.dtype))
        for tl in range(nt):
            for m in range(4):
                j = j0 + 4 * tl + m
                if j >= lp:
                    continue
                acc = [sum(torch.einsum("oi,bi->bo", w[:, :, kk], xs[:, :, 8 * tl + 2 * m + r + kk])
                           for kk in range(k)) for r in (0, 1)]
                a = acc[1] if (j == 0 and q) else torch.maximum(acc[0], acc[1])
                out[:, :, j] = torch.relu(a + b)
    return out


@pytest.mark.parametrize("i,o,k,length", [(3, 8, 11, 131), (4, 5, 5, 37), (2, 3, 4, 20), (2, 9, 1, 9),
                                          (5, 4, 13, 1), (3, 2, 6, 2), (4, 4, 3, 33)])
def test_the_kernels_index_rules_equal_the_twin(i, o, k, length):
    rng = np.random.default_rng(i * 100 + o * 10 + k + length)
    x, w, b = (torch.as_tensor(a) for a in _layer(rng, 2, i, o, k, length, np.float64))
    want = convpool.convpool_relu_reference(x, w, b)
    got = _kernel_arithmetic(x, w, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=INDEX_ATOL)


@pytest.mark.parametrize("b", [256, 208, 16, 1])
@pytest.mark.parametrize("layer", range(len(ENCODER)))
def test_plan_covers_the_layer_and_fits_the_card(layer, b):
    i, o, k, length = ENCODER[layer]
    lp = (length + length % 2) // 2
    nt, tiles, cblocks, threads, smem = convpool.convpool_plan(b, i, o, length, k, N_SM)
    groups = -(-o // convpool.CHANNELS_PER_THREAD)
    gc = -(-groups // cblocks)
    assert nt % 8 == 0 and threads == gc * nt <= convpool.MAX_THREADS
    assert (tiles - 1) * 4 * nt < lp <= tiles * 4 * nt  # every pooled output in one tile, no empty tile
    assert (cblocks - 1) * gc < groups <= cblocks * gc
    assert smem == convpool.shared_bytes(k, i, gc, nt) <= convpool.MAX_SHARED_BYTES
    if b >= 208:  # the archive and live steps: one channel block, every SM busy
        assert cblocks == 1 and b * tiles >= N_SM and threads >= 128
    else:
        assert threads >= 64


def test_shared_bytes_by_hand():
    # layer 6: weights 64 x 3 x 64, tile 64 rows of 15 x 8 + 12 words (10 inputs a lane as 3 float4)
    assert convpool.shared_bytes(3, 64, 8, 16) == 4 * (64 * 3 * 64 + 64 * (15 * 8 + 12))
    # layer 0: weights 3 x 11 x 8, tile 3 rows of 255 x 8 + 20 words
    assert convpool.shared_bytes(11, 3, 1, 256) == 4 * (3 * 11 * 8 + 3 * (255 * 8 + 20))


def test_plan_refuses_what_no_launch_can_take():
    with pytest.raises(ValueError, match="no plan"):
        convpool.convpool_plan(4, 16, 8, 100, 14, N_SM)
    with pytest.raises(ValueError, match="no plan"):
        convpool.convpool_plan(0, 16, 8, 100, 3, N_SM)
    with pytest.raises(LayerRefused, match="shared memory"):
        convpool.convpool_plan(4, 4096, 8, 100, 13, N_SM)


@pytest.mark.parametrize("case", ["in_channels", "bias", "empty_length", "rank", "empty_kernel", "device"])
def test_refusals_on_every_device(case):
    x, w, b = torch.zeros(2, 4, 10), torch.zeros(6, 4, 5), torch.zeros(6)
    args = {
        "in_channels": (x, torch.zeros(6, 3, 5), b),
        "bias": (x, w, torch.zeros(5)),
        "empty_length": (torch.zeros(2, 4, 0), w, b),
        "rank": (x[0], w, b),
        "empty_kernel": (x, torch.zeros(6, 4, 0), b),
        "device": (x, w, b.to("meta")),
    }[case]
    with pytest.raises(ValueError) as err:
        convpool.convpool_relu(*args)
    assert not isinstance(err.value, LayerRefused)  # an error the model's route lets through


def test_cpu_takes_the_twin_and_launches_nothing():
    """On the CPU the wrapper accepts every well-formed layer, even or long
    kernels and bf16 included, runs the twin (differentiable) and launches
    nothing."""
    rng = np.random.default_rng(3)
    before = convpool.launches
    x, w, b = (torch.as_tensor(a) for a in _layer(rng, 3, 4, 6, 15, 21))
    w.requires_grad_(True)
    convpool.convpool_relu(x, w, b).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    half = convpool.convpool_relu(x.bfloat16(), w.detach().bfloat16(), b.bfloat16())
    assert half.dtype == torch.bfloat16 and half.shape == (3, 6, 11)
    assert convpool.launches == before


def _old_encode(model, x):
    h = x
    for conv, pad in zip(model.encoder.convs, model._pool_pads):
        h = tlayers.max_pool1d(F.relu(conv.same(h)), 2, padding=pad)
    return h


@pytest.fixture(scope="module", params=[EQTransformer, VolEQTransformer], ids=["eqt", "voleqt"])
def small(request):
    model = request.param(in_samples=1504, lstm_blocks=1, generator=torch.Generator().manual_seed(4)).eval()
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 3, 1504)).astype(np.float32))
    return model, x


def test_encode_and_the_eval_forward_are_unchanged_on_the_cpu(small, monkeypatch):
    """The encoder through the wrapper (its twin here) is the old encoder
    bitwise, and so is the whole eval forward against the same forward with
    the wrapper refused at every layer (the plain code)."""
    model, x = small
    with torch.inference_mode():
        assert torch.equal(model.encode(x), _old_encode(model, x))
        assert torch.equal(model(x, stop_after="encoder"), _old_encode(model, x))
        got = model(x)
        monkeypatch.setattr(port_eqt, "convpool_relu", _refused)
        want = model(x)
    assert len(got) == len(want) == len(model.detection_branches) + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_float32_eval_forward_sends_every_encoder_layer_through_the_wrapper(small, monkeypatch):
    model, x = small
    calls = []
    real = convpool.convpool_relu
    monkeypatch.setattr(port_eqt, "convpool_relu", lambda *a: (calls.append(a[0].shape[-1]), real(*a))[1])
    before = convpool.launches
    with torch.inference_mode():
        model(x)
        model(x, fused="grouped")
        model(x, fused="plstm+bandattn+polyup")
    lengths = [1504, 752, 376, 188, 94, 47, 24]
    assert calls == lengths * 3
    assert convpool.launches == before  # CPU tensors launch nothing


def test_train_mode_and_bf16_keep_the_plain_encoder(small, monkeypatch):
    model, x = small
    calls = []
    monkeypatch.setattr(port_eqt, "convpool_relu", lambda *a: calls.append(1))
    model.train()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.eval()
    half = copy.deepcopy(model).to(torch.bfloat16)
    with torch.inference_mode():
        out = half(x.to(torch.bfloat16))
    assert calls == [] and all(o.dtype == torch.bfloat16 for o in out)


def test_encoder_span_counts_the_kernel_layers(small):
    """``eqt.encoder`` carries ``convpool``: the encoder layers run through
    the kernel in that forward, 0 on the CPU (the twin runs there)."""
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.utils import profiling

    model, x = small
    with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
        model(x)
    got = [s for s in profiling.spans() if s.name == "eqt.encoder"][-1:]
    assert [s.counts for s in got] == [{"convpool": 0}]


def test_an_input_of_another_length_keeps_the_models_padding(small, monkeypatch):
    """The encoder pads by the lengths of ``in_samples``; an input of another
    length whose layer would pad otherwise takes the plain code there, so the
    model computes what it computed before the kernel."""
    model, _ = small
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(1, 3, 1503)).astype(np.float32))
    calls = []
    real = convpool.convpool_relu
    monkeypatch.setattr(port_eqt, "convpool_relu", lambda *a: (calls.append(a[0].shape[-1]), real(*a))[1])
    with torch.inference_mode():
        assert torch.equal(model.encode(x), _old_encode(model, x))
    assert 1503 not in calls


def test_a_strided_input_takes_the_wrapper_and_other_refusals_propagate(small, monkeypatch):
    """The encoder hands the wrapper a contiguous copy of a strided input
    (the card's kernel takes contiguous tensors only), and only a refusal of
    the layer's shape (``LayerRefused``) sends a layer to the plain code:
    any other error of the wrapper reaches the caller."""
    model, x = small
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    calls = []
    real = convpool.convpool_relu
    monkeypatch.setattr(port_eqt, "convpool_relu",
                        lambda *a: (calls.append(a[0].is_contiguous()), real(*a))[1])
    with torch.inference_mode():
        assert torch.equal(model.encode(strided), _old_encode(model, x))
    assert calls == [True] * 7

    def broken(*a):
        raise TypeError("not a shape refusal")

    monkeypatch.setattr(port_eqt, "convpool_relu", broken)
    with torch.inference_mode(), pytest.raises(TypeError, match="not a shape refusal"):
        model.encode(x)
