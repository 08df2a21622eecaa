"""Where the port's entry points run: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device=None`` means ``"cuda"``. CUDA that is not available raises and
    names ``device="cpu"`` as the way to ask for the CPU: an entry point never
    carries on on the CPU by itself. Anything but cpu or cuda is refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            asked = "the default device" if device is None else f"device={str(device)!r}"
            raise RuntimeError(
                f'{who}: {asked} needs CUDA, which is not available; pass device="cpu" '
                "to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"{who}: device must be cpu or cuda, got {dev}")
    return dev


@contextlib.contextmanager
def inference_work(device: torch.device):
    """Inference mode and, on CUDA, float32 parity: cuDNN convolutions and
    matmuls default to TF32 otherwise. The process-wide TF32 flags are
    restored on exit."""
    flags = (torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32")
    saved = [getattr(m, a) for m, a in flags]
    if device.type == "cuda":
        for m, a in flags:
            setattr(m, a, False)
    try:
        with torch.inference_mode():
            yield
    finally:
        for (m, a), v in zip(flags, saved):
            setattr(m, a, v)
