"""Hand-written CUDA kernels (csrc/*.cu, built by ``_build``) and their plain
PyTorch twins. A wrapper runs its twin for CPU tensors and its kernel for CUDA
tensors. The kernels have no backward: on a CUDA tensor every wrapper refuses
an input that requires grad while autograd records (``refuse_autograd``); the
twins are differentiable."""

from __future__ import annotations

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
