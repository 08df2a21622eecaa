"""EQTransformer's decoder layer as one kernel (``ops/cuda/upconv.py``) on the CPU.

The wrapper runs its twin for a CPU tensor. Held here: the twin against the
JAX package's decoder layer at each of the seven layers of the full-width
decoder (1e-5: two float32 convolutions that sum in other orders), and
bitwise against the decoder code the model ran before the kernel; the
folded-tap algebra that ``csrc/upconv.cu`` computes, written out in float64
with the kernel's own index rules, against the twin in float64 (1e-10: the
same products summed in another order); the launch plan; the refusals that
hold on every device. The kernel itself is held against its twin in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.models import layers as jlayers
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.ops.cuda import LayerRefused, upconv

JAX_ATOL = 1e-5
FOLD_ATOL = 1e-10
N_SM = 132  # an H100 SXM
# (I, O, K, crop) of the full-width decoder's layers; T in of each at 6000 samples
DECODER = [(16, 64, 3, 0), (64, 64, 5, 0), (64, 32, 5, 1), (32, 32, 7, 0), (32, 16, 7, 0),
           (16, 16, 9, 0), (16, 8, 11, 0)]
DECODER_T = [47, 94, 188, 375, 750, 1500, 3000]


def _layer(rng, b, i, o, k, t, dtype=np.float32):
    x = rng.normal(size=(b, i, t)).astype(dtype)
    w = (rng.normal(size=(o, i, k)) / np.sqrt(i * k)).astype(dtype)
    return x, w, (rng.normal(size=o) * 0.1).astype(dtype)


@pytest.mark.parametrize("layer", range(len(DECODER)))
def test_twin_matches_the_jax_decoder_layer(layer):
    i, o, k, crop = DECODER[layer]
    rng = np.random.default_rng(layer)
    for t in (1, 6, 13):
        x, w, b = _layer(rng, 2, i, o, k, t)
        z = jlayers.upsample_nearest(jnp.asarray(x), 2)
        if crop:
            z = z[..., :-1]
        want = jax.nn.relu(jlayers.conv1d_same(z, jnp.asarray(w), jnp.asarray(b)))
        got = upconv.upconv_relu(*(torch.as_tensor(a) for a in (x, w, b)), crop)
        assert got.shape == (2, o, 2 * t - crop)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)


def test_cpu_takes_the_twin_bitwise_and_launches_nothing():
    """On the CPU the wrapper is the twin, and the twin is the decoder code
    the model ran before: bitwise, differentiable, in any float type."""
    rng = np.random.default_rng(3)
    before = upconv.launches
    for i, o, k, crop in DECODER:
        x, w, b = (torch.as_tensor(a) for a in _layer(rng, 3, i, o, k, 11))
        z = tlayers.upsample_nearest(x, 2)
        old = torch.relu(tlayers.conv1d_same(z[..., :-1] if crop else z, w, b))
        assert torch.equal(upconv.upconv_relu(x, w, b, crop), old)
        assert torch.equal(upconv.upconv_relu_reference(x, w, b, crop), old)
    w.requires_grad_(True)
    upconv.upconv_relu(x, w, b, 1).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    half = upconv.upconv_relu(x.bfloat16(), w.detach().bfloat16(), b.bfloat16())
    assert half.dtype == torch.bfloat16 and half.shape == (3, 8, 22)
    assert upconv.launches == before


def _folded(x, w, b, crop):
    """csrc/upconv.cu's arithmetic in float64 with its index rules: parity r
    of output 2m + r sums the folded taps Wf_r[d] = w[2d + p - r] + w[2d + p -
    r + 1] over x[m + d] (zero outside [0, T)), d from D0 + r·odd; the crop's
    last p outputs give back w[:, :, 2p - q] x[:, :, T - 1]; bias, ReLU."""
    bn, _, t = x.shape
    o, _, k = w.shape
    p = (k - 1) // 2
    odd, d0 = p & 1, -((p + 1) // 2)
    n = 2 * t - crop
    pad = p + 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    y = torch.zeros((bn, o, 2 * t), dtype=x.dtype)
    for r in (0, 1):
        for dd in range(p + 1):
            j0 = 2 * (dd + d0 + (odd if r else 0)) + p - r
            wf = sum(w[:, :, j] for j in (j0, j0 + 1) if 0 <= j < k)
            d = d0 + (odd if r else 0) + dd
            y[:, :, r::2] += torch.einsum("oi,bim->bom", wf, xp[:, :, pad + d : pad + d + t])
    crop_from = 2 * t - 1 - p if crop else n
    for tt in range(max(crop_from, 0), n):
        y[:, :, tt] -= torch.einsum("oi,bi->bo", w[:, :, 2 * p - (tt - crop_from)], x[:, :, t - 1])
    return torch.relu(y[:, :, :n] + b[None, :, None])


@pytest.mark.parametrize("crop", [0, 1])
@pytest.mark.parametrize("i,o,k", [(i, o, k) for i, o, k, _ in DECODER] + [(3, 5, 1), (2, 3, 13), (5, 9, 9)])
def test_the_kernels_folded_taps_equal_the_twin(i, o, k, crop):
    rng = np.random.default_rng(i * 100 + o + k)
    for t in (1, 2, 3, 8):
        x, w, b = (torch.as_tensor(a) for a in _layer(rng, 2, i, o, k, t, np.float64))
        want = upconv.upconv_relu_reference(x, w, b, crop)
        np.testing.assert_allclose(_folded(x, w, b, crop).numpy(), want.numpy(), atol=FOLD_ATOL)


@pytest.mark.parametrize("b", [256, 208, 16, 1])
@pytest.mark.parametrize("layer", range(len(DECODER)))
def test_plan_covers_the_layer_and_fits_the_card(layer, b):
    i, o, k, _ = DECODER[layer]
    t = DECODER_T[layer]
    nt, tiles, cblocks, threads, smem = upconv.upconv_plan(b, i, o, t, k, N_SM)
    groups = -(-o // upconv.CHANNELS_PER_THREAD)
    gc = -(-groups // cblocks)
    assert nt % 8 == 0 and threads == gc * nt <= upconv.MAX_THREADS
    assert (tiles - 1) * 4 * nt < t <= tiles * 4 * nt  # every step in one tile, no empty tile
    assert (cblocks - 1) * gc < groups <= cblocks * gc
    assert smem == upconv.shared_bytes(k, i, gc, nt) <= upconv.MAX_SHARED_BYTES
    if b >= 208:  # the archive and live steps: one channel block, the widest tiles, every SM busy
        assert cblocks == 1 and b * tiles >= N_SM and threads >= 128
    else:
        assert threads >= 64


def test_plan_refuses_what_no_launch_can_take():
    with pytest.raises(ValueError, match="no plan"):
        upconv.upconv_plan(4, 16, 8, 100, 4, N_SM)
    with pytest.raises(ValueError, match="no plan"):
        upconv.upconv_plan(4, 16, 8, 100, 15, N_SM)
    with pytest.raises(LayerRefused, match="shared memory"):
        upconv.upconv_plan(4, 4096, 8, 100, 13, N_SM)


@pytest.mark.parametrize("case", ["even_k", "in_channels", "bias", "crop", "empty_time", "rank"])
def test_refusals_on_every_device(case):
    x, w, b = torch.zeros(2, 4, 10), torch.zeros(6, 4, 5), torch.zeros(6)
    args = {
        "even_k": (x, torch.zeros(6, 4, 4), b, 0),
        "in_channels": (x, torch.zeros(6, 3, 5), b, 0),
        "bias": (x, w, torch.zeros(5), 0),
        "crop": (x, w, b, 2),
        "empty_time": (torch.zeros(2, 4, 0), w, b, 0),
        "rank": (x[0], w, b, 0),
    }[case]
    with pytest.raises(ValueError) as err:
        upconv.upconv_relu(*args)
    # the model's decoder runs its plain code for a refused shape, and lets every other error through
    assert isinstance(err.value, LayerRefused) == (case == "even_k")


@pytest.mark.parametrize("kernel_sizes", [(11, 9, 7, 7, 5, 5, 4), (15, 9, 7, 7, 5, 5, 3)], ids=["even", "k15"])
def test_eval_forward_of_kernels_the_wrapper_refuses_matches_jax(kernel_sizes, monkeypatch):
    """An EQTransformer whose decoders hold an even kernel (which
    ``upconv_relu`` refuses on every device) or a 15-sample one (refused on
    the card, forced here) runs its eval forward: each such layer takes the
    plain decoder code, the others the wrapper, and the curves are JAX's
    within the EQT forward pin, 2e-4."""
    from tests.test_torch_eqtransformer import _jax_params, _windows
    from volpick_tpu.models import EQTransformer as JaxEQT
    from volpick_tpu_torch.models import EQTransformer
    from volpick_tpu_torch.models import eqtransformer as port_eqt
    from volpick_tpu_torch.models.convert import eqtransformer_state_dict_from_jax

    small = dict(in_samples=1504, lstm_blocks=1, kernel_sizes=kernel_sizes)
    jmodel = JaxEQT(**small)
    params = _jax_params(jmodel)
    model = EQTransformer(**small)
    model.load_state_dict(eqtransformer_state_dict_from_jax(params), strict=True)
    model.eval()
    calls = []
    real = port_eqt.upconv_relu

    def counted(z, w, *a, **k):
        if w.shape[-1] > upconv.MAX_KERNEL:  # the card's refusal, here where the twin would take it
            raise LayerRefused(f"kernel size {w.shape[-1]}")
        out = real(z, w, *a, **k)
        calls.append(w.shape[-1])
        return out

    monkeypatch.setattr(port_eqt, "upconv_relu", counted)
    x = _windows(2, 1504)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.as_tensor(x))
    refused = [k for k in kernel_sizes[::-1] if k % 2 == 0 or k > upconv.MAX_KERNEL]
    assert len(refused) == 1 and refused[0] not in calls
    assert sorted(calls) == sorted([k for k in kernel_sizes[::-1] if k not in refused] * 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
