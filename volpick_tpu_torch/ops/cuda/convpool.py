"""One encoder layer of EQTransformer as one kernel: ``csrc/convpool.cu`` and
its plain PyTorch twin.

``convpool_relu(x, w, b)`` computes ``max_pool1d(relu(conv1d_same(x, w, b)),
2)`` with keras 'same' padding on both: x (B, I, L), w (O, I, K) with any K,
b (O,) → (B, O, (L + q) // 2), q = L % 2. The conv pads (K - 1) // 2 zeros on
the left and K // 2 on the right; the pool pads q copies of -inf on both
sides, so for odd L its pairs are (y[2j - 1], y[2j]). The twin,
``convpool_relu_reference``, is that expression as the model's encoder wrote
it (``F.pad``, ``F.conv1d``, ``F.relu``, a -inf ``F.pad``, ``F.max_pool1d``).

Replaces no TPU kernel: the JAX package leaves these convolutions to XLA. On
the card they were four or five passes a layer (a pad copy, cuDNN's float32
implicit sgemm with TF32 off, a ReLU pass, for odd lengths a -inf pad copy,
the pooling pass), with the conv output at full resolution in device memory.
The kernel reads the input once, with the zero padding made by its index,
and writes only the pooled output, ReLU applied; see the source for the
design.

``convpool_relu`` takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route. On CUDA it refuses, rather than converts,
what the kernel does not take: another type than float32, a non-contiguous
tensor and an input that requires grad while autograd records (the kernel
has no backward) raise as errors; a kernel longer than ``MAX_KERNEL`` and a
layer whose tile fits no CTA's shared memory raise ``LayerRefused``, on which
the model's encoder runs its plain code.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from volpick_tpu_torch.ops.cuda import LayerRefused, _build, check_conv_operands, tile_plan

CHANNELS_PER_THREAD = 8  # kCO of csrc/convpool.cu
POOLED_PER_THREAD = 4  # kTP: pooled outputs a thread owns, 8 conv outputs
MAX_THREADS = 256  # the kernel's launch bound
MAX_KERNEL = 13  # the largest K the source instantiates (every K from 1)
MAX_SHARED_BYTES = 232448  # dynamic shared memory a CTA can take on Hopper

launches = 0  # kernel launches made by convpool_relu on CUDA tensors


def convpool_relu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin, on any device: the keras 'same' convolution, ReLU,
    max-pool of 2 with -inf padding of an odd length on both sides."""
    k = w.shape[-1]
    q = x.shape[-1] % 2
    pad = ((k - 1) // 2, k // 2)
    if pad != (0, 0):
        x = F.pad(x, pad)
    y = F.relu(F.conv1d(x, w, b))
    if q:
        y = F.pad(y, (q, q), value=float("-inf"))
    return F.max_pool1d(y, 2, 2)


def shared_bytes(k: int, i: int, gc: int, nt: int) -> int:
    """Dynamic shared memory of a CTA of csrc/convpool.cu: the weights
    (I x K x gc·8) and the input tile (I rows of its halo-padded width)."""
    nin4 = (2 * POOLED_PER_THREAD + k - 1 + 3) // 4
    return 4 * (i * k * gc * CHANNELS_PER_THREAD + i * ((nt - 1) * 2 * POOLED_PER_THREAD + nin4 * 4))


@functools.lru_cache(maxsize=256)
def convpool_plan(b: int, i: int, o: int, length: int, k: int, n_sm: int) -> Tuple[int, int, int, int, int]:
    """``(nt, n_tiles, cblocks, threads, shared bytes)`` of a launch over
    B windows of x (B, I, L) and w (O, I, K) on a card of ``n_sm`` SMs:
    ``ops/cuda/__init__.py::tile_plan`` over the (L + L % 2) // 2 pooled
    outputs, time lanes of 4. Raises ``LayerRefused`` when no tile fits in
    shared memory."""
    if min(b, i, o, length, k, n_sm) < 1 or k > MAX_KERNEL:
        raise ValueError(f"convpool_plan: no plan for b={b}, i={i}, o={o}, l={length}, k={k}, n_sm={n_sm}")
    return tile_plan(b, o, (length + length % 2) // 2, POOLED_PER_THREAD,
                     lambda gc, nt: shared_bytes(k, i, gc, nt), n_sm, MAX_THREADS, MAX_SHARED_BYTES,
                     f"convpool_plan (I={i}, K={k})")


def convpool_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max_pool1d(relu(conv1d_same(x, w, b)), 2, padding=L % 2): x (B, I, L),
    w (O, I, K), b (O,) → (B, O, (L + L % 2) // 2). Raises ``LayerRefused``
    for a layer whose shape the kernel does not take on the card."""
    global launches
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"x (B, I, L), w (O, I, K), b (O,) expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, i, length = x.shape
    o, _, k = w.shape
    if w.shape[1] != i or b.shape[0] != o or i < 1 or k < 1:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} do not agree")
    if length < 1:
        raise ValueError("convpool_relu needs L >= 1")
    check_conv_operands("convpool_relu", x, w, b)
    if x.device.type == "cpu":
        return convpool_relu_reference(x, w, b)
    if k > MAX_KERNEL:
        raise LayerRefused(f"kernel size {k} exceeds the kernel's limit {MAX_KERNEL}")
    out = torch.empty((n, o, (length + length % 2) // 2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    nt, tiles, cblocks, _, _ = convpool_plan(n, i, o, length, k, n_sm)
    fn = _build.function("convpool_relu_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, i, o, length, k, nt, tiles, cblocks,
             n_sm, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"convpool_relu_f32 launch failed: cudaError {err}")
    launches += 1
    return out
