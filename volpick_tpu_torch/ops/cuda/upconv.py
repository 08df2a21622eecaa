"""One decoder layer of EQTransformer as one kernel: ``csrc/upconv.cu`` and
its plain PyTorch twin.

``upconv_relu(x, w, b, crop_last)`` computes
``relu(conv1d_same(upsample_nearest(x, 2)[..., :2T - crop_last], w, b))`` with
zero padding: x (B, I, T), w (O, I, K) with odd K, b (O,) → (B, O, 2T -
crop_last). The twin, ``upconv_relu_reference``, is that expression as the
model's decoder wrote it (``repeat_interleave``, a crop, ``F.pad``,
``F.conv1d``, ``F.relu``).

Replaces no TPU kernel: the JAX package leaves these convolutions to XLA. On
the card they were four passes a layer (an upsampling copy, a pad copy,
cuDNN's float32 implicit sgemm with TF32 off, a ReLU pass), about two thirds
of EQTransformer's device time. What bounds the layer is both its float32
operations and its bytes, about equally: the kernel sums the taps that land
on the same input sample in the weights (p + 1 taps a parity instead of K,
exact algebra), reads the input once at its own resolution and writes each
output once, ReLU applied; see the source for the design.

``upconv_relu`` takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route. On CUDA it refuses, rather than converts,
what the kernel does not take: another type than float32, a non-contiguous
tensor and an input that requires grad while autograd records (the kernel
has no backward) raise as errors; a kernel longer than ``MAX_KERNEL`` and a
layer whose tile fits no CTA's shared memory raise ``LayerRefused``, as an
even K does on every device, and the model's decoder runs its plain code
for such a layer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from volpick_tpu_torch.ops.cuda import LayerRefused, _build, check_conv_operands, tile_plan

CHANNELS_PER_THREAD = 8  # kCO of csrc/upconv.cu
STEPS_PER_THREAD = 4  # kTT: input steps a thread owns, 8 outputs
MAX_THREADS = 256  # the kernel's launch bound
MAX_KERNEL = 13  # the largest K the source instantiates
MAX_SHARED_BYTES = 232448  # dynamic shared memory a CTA can take on Hopper

launches = 0  # kernel launches made by upconv_relu on CUDA tensors


def upconv_relu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, crop_last: int = 0) -> torch.Tensor:
    """Plain PyTorch twin, on any device: 2x nearest upsampling, the last
    ``crop_last`` samples dropped, the keras 'same' convolution, ReLU."""
    z = torch.repeat_interleave(x, 2, dim=-1)
    if crop_last:
        z = z[..., :-1]
    k = w.shape[-1]
    pad = ((k - 1) // 2, k // 2)
    if pad != (0, 0):
        z = F.pad(z, pad)
    return F.relu(F.conv1d(z, w, b))


def _taps(k: int) -> Tuple[int, int, int]:
    """(p, folded taps a parity, 16-byte loads of a thread's inputs) for odd k."""
    p = (k - 1) // 2
    span = p + 1 + (p & 1)
    return p, p + 1, (STEPS_PER_THREAD + span - 1 + 3) // 4


def shared_bytes(k: int, i: int, gc: int, nt: int) -> int:
    """Dynamic shared memory of a CTA of csrc/upconv.cu: folded weights
    (I x 2 x (p+1) x gc·8), the input tile (I rows of its halo-padded width)
    and the crop's corrections (p x gc·8)."""
    p, n_taps, nin4 = _taps(k)
    opc = gc * CHANNELS_PER_THREAD
    return 4 * (i * 2 * n_taps * opc + i * (nt - 1 + nin4) * STEPS_PER_THREAD + p * opc)


@functools.lru_cache(maxsize=256)
def upconv_plan(b: int, i: int, o: int, t: int, k: int, n_sm: int) -> Tuple[int, int, int, int, int]:
    """``(nt, n_tiles, cblocks, threads, shared bytes)`` of a launch over
    B windows of x (B, I, T) and w (O, I, K) on a card of ``n_sm`` SMs:
    ``ops/cuda/__init__.py::tile_plan`` with time lanes of 4 input steps.
    Raises ``LayerRefused`` when no tile fits in shared memory."""
    if min(b, i, o, t, n_sm) < 1 or k % 2 == 0 or k > MAX_KERNEL:
        raise ValueError(f"upconv_plan: no plan for b={b}, i={i}, o={o}, t={t}, k={k}, n_sm={n_sm}")
    return tile_plan(b, o, t, STEPS_PER_THREAD, lambda gc, nt: shared_bytes(k, i, gc, nt), n_sm,
                     MAX_THREADS, MAX_SHARED_BYTES, f"upconv_plan (I={i}, K={k})")


def upconv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, crop_last: int = 0) -> torch.Tensor:
    """relu(conv1d_same(upsample_nearest(x, 2)[..., :2T - crop_last], w, b)):
    x (B, I, T), w (O, I, K) with odd K, b (O,) → (B, O, 2T - crop_last).
    Raises ``LayerRefused`` for a layer whose shape the kernel does not take
    (an even K; on the card a long kernel or no plan)."""
    global launches
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"x (B, I, T), w (O, I, K), b (O,) expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, i, t = x.shape
    o, _, k = w.shape
    if w.shape[1] != i or b.shape[0] != o or i < 1:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} do not agree")
    if t < 1:
        raise ValueError("upconv_relu needs T >= 1")
    if crop_last not in (0, 1):
        raise ValueError(f"crop_last must be 0 or 1, got {crop_last!r}")
    check_conv_operands("upconv_relu", x, w, b)
    if k % 2 == 0:
        raise LayerRefused(f"upconv_relu takes odd kernels only, got K={k}")
    crop = int(crop_last)
    if x.device.type == "cpu":
        return upconv_relu_reference(x, w, b, crop)
    if k > MAX_KERNEL:
        raise LayerRefused(f"kernel size {k} exceeds the kernel's limit {MAX_KERNEL}")
    out = torch.empty((n, o, 2 * t - crop), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    nt, tiles, cblocks, _, _ = upconv_plan(n, i, o, t, k, n_sm)
    fn = _build.function("upconv_relu_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, i, o, t, k, crop, nt, tiles,
             cblocks, n_sm, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upconv_relu_f32 launch failed: cudaError {err}")
    launches += 1
    return out
