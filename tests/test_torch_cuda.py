"""The port's CUDA kernels vs their plain PyTorch twins, on a CUDA device.

Marked ``cuda``; every test skips when torch sees no CUDA device (decided in
a fixture, not at import). Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Tolerances:
trigger extraction exact; LSTM and MHA 1e-5 (the tests/test_pallas.py pins);
picker curves GPU vs CPU 1e-4 (float32 convolutions reduce in another order
on the card).
"""

import numpy as np
import pytest
import torch

from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.ops.cuda import attention as cuda_attn
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
from volpick_tpu_torch.picker import WaveformPicker

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


@pytest.mark.parametrize("g,b,c,t,h", [(2, 232, 64, 47, 16), (2, 232, 16, 47, 16),
                                       (3, 5, 16, 31, 8), (1, 17, 32, 12, 32)])
def test_lstm_multi_matches_twin(dev, g, b, c, t, h):
    rng = np.random.default_rng(b + c)
    args = [
        rng.normal(size=(g, b, c, t)),
        rng.normal(size=(g, 4 * h, c)) * 0.2,
        rng.normal(size=(g, 4 * h, h)) * 0.2,
        rng.normal(size=(g, 4 * h)) * 0.1,
    ]
    args = [torch.as_tensor(a.astype(np.float32), device=dev) for a in args]
    before = cuda_lstm.launches
    got = cuda_lstm.lstm_multi(*args)
    assert cuda_lstm.launches == before + 1
    err = (got - cuda_lstm.lstm_multi_reference(*args)).abs().max().item()
    assert err <= 1e-5


def test_picker_gpu_matches_cpu(dev):
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(2, 3, 5000)) * 0.1).astype(np.float32)
    data[:, :, 2500:2600] += 2.0 * np.hanning(100).astype(np.float32)
    gpu_model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1, device=dev)
    cpu_model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1)
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
                                     (2, 96, 33, 3), (1, 128, 1, 4)])
def test_mha_matches_twin(dev, b, d, t, h):
    rng = np.random.default_rng(b + t)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, d, t)).astype(np.float32), device=dev)
               for _ in range(3))
    before = cuda_attn.launches
    got = cuda_attn.mha(q, k, v, h)
    assert cuda_attn.launches == before + 1
    assert (got - cuda_attn.mha_reference(q, k, v, h)).abs().max().item() <= 1e-5


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
    cpu = WaveformPicker(load_model("tpupicknet", seed=1, **margs), device="cpu")
    before = cuda_attn.launches
    gc = gpu.annotate_array(data, **kw)
    assert cuda_attn.launches > before and (cuda_attn.launches - before) % 2 == 0
    np.testing.assert_allclose(gc, cpu.annotate_array(data, **kw), atol=1e-4)
