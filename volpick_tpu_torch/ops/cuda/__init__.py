"""Hand-written CUDA kernels (csrc/*.cu, built by ``_build``) and their plain
PyTorch twins. A wrapper runs its twin for CPU tensors and its kernel for CUDA
tensors. The kernels have no backward: on a CUDA tensor every wrapper refuses
an input that requires grad while autograd records (``refuse_autograd``); the
twins are differentiable."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# element type -> suffix of a kernel's C entry points (K2, K5 and K7 have both)
ENTRY_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def refuse_autograd(who: str, **tensors: torch.Tensor) -> None:
    """Raise ValueError when autograd is recording and one of `tensors`
    requires grad. A kernel writes into a fresh tensor through ctypes, so its
    result would be cut from the graph and what fed it would train on no
    gradient."""
    if not torch.is_grad_enabled():
        return
    needing = [name for name, t in tensors.items() if t.requires_grad]
    if needing:
        raise ValueError(
            f"{who}: {', '.join(needing)} require(s) grad, but the CUDA kernel has no backward "
            "and its result would be cut from the autograd graph; call it under "
            "torch.no_grad() / torch.inference_mode(), or run the model's train-mode route"
        )


class LayerRefused(ValueError):
    """A conv layer whose shape K8's or K9's kernel does not take on the
    layer's device: a kernel longer than the source instantiates, a tile
    that fits no CTA's shared memory, for K8 an even kernel. The model runs
    its plain code for such a layer; every other refusal of those wrappers
    is the caller's error."""


def check_conv_operands(who: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """Raise for operands that a conv layer's wrapper (K8's, K9's) takes in
    no shape: w or b on another device than x; off the CPU, a device that
    is not CUDA, another type than float32, a non-contiguous tensor, or an
    input that requires grad while autograd records (the kernels have no
    backward)."""
    for name, a in (("w", w), ("b", b)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{who} runs on cpu or cuda, got {x.device}")
    for name, a in (("x", x), ("w", w), ("b", b)):
        if a.dtype != torch.float32:
            raise TypeError(f"{who}'s kernel takes float32, got {name} {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    refuse_autograd(who, x=x, w=w, b=b)


def tile_plan(b: int, o: int, steps: int, per_thread: int, shared: Callable[[int, int], int], n_sm: int,
              max_threads: int, max_shared: int, who: str) -> Tuple[int, int, int, int, int]:
    """``(nt, n_tiles, cblocks, threads, shared bytes)`` of a launch whose CTA
    has gc channel groups of 8 of the ``o`` output channels (all of them, or
    1 of ``cblocks`` blocks) and ``nt`` time lanes (a multiple of 8) of
    ``per_thread`` of a window's ``steps`` steps each, at most
    ``max_threads`` threads; an item is one of ``b`` windows and one tile of
    ``per_thread``·nt steps, ``n_tiles`` tiles a window cut evenly;
    ``shared(gc, nt)`` is a CTA's shared memory in bytes (K8's and K9's).
    Candidates run from all channels in one block and the widest tile down;
    the first that gives at least ``n_sm`` items with 64 threads or more is
    taken, else the one with the most items. Raises ``LayerRefused`` when no
    tile fits in ``max_shared`` bytes."""
    groups = -(-o // 8)
    cands = []
    for s in (1, 2, 4, 8, 16, 32, 64):
        if s > groups:
            break
        cblocks = -(-groups // -(-groups // s))  # no empty block
        gc = -(-groups // cblocks)  # as the kernels compute it
        for cap in (256, 128, 64, 32, 16, 8):
            if gc * cap > max_threads:
                continue
            tiles = -(-steps // (per_thread * cap))
            nt = 8 * -(-steps // (tiles * per_thread * 8))
            smem = shared(gc, nt)
            if smem <= max_shared:
                cands.append((nt, tiles, cblocks, gc * nt, smem, b * tiles * cblocks))
    if not cands:
        raise LayerRefused(f"{who}: no tile of {o} output channels fits the kernel's shared memory")
    for cand in cands:
        if cand[5] >= n_sm and cand[3] >= 64:
            return cand[:5]
    wide = [c for c in cands if c[3] >= 64] or cands
    return max(wide, key=lambda c: c[5])[:5]
