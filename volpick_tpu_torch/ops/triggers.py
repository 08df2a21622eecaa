"""Two-threshold trigger + peak extraction on batched probability curves.

Port of ``volpick_tpu/ops/triggers.py::extract_triggers_batched``: obspy
``trigger_onset(prob, thres1, thres2)`` semantics with an in-trigger argmax,
for many curves at once with per-row thresholds. The work is done by
``ops/cuda/triggers.py``: its CUDA kernel for a CUDA tensor, its plain
PyTorch twin for a CPU tensor.
"""

from __future__ import annotations

import torch

from volpick_tpu_torch.ops.cuda.triggers import Picks, trigger_extract


def extract_triggers_batched(
    prob: torch.Tensor, thres1, thres2=None, max_picks: int = 32
) -> Picks:
    """Returns (peak_idx, peak_value, valid, onset_idx, offset_idx), each
    (B, max_picks), for prob (B, W) float32.

    thres1/thres2 are scalars or per-row (B,) values; thres2 defaults to
    thres1 / 2 computed in float32. Picks are the earliest max_picks per row
    in time order; invalid entries have idx/onset/offset -1 and value 0.
    offset is the last index of the > thres2 run (inclusive, obspy)."""
    b = prob.shape[0]
    t1 = torch.as_tensor(thres1, dtype=torch.float32, device=prob.device)
    t2 = t1 / 2.0 if thres2 is None else torch.as_tensor(
        thres2, dtype=torch.float32, device=prob.device
    )
    t1 = t1.reshape(-1).expand(b).contiguous()
    t2 = t2.reshape(-1).expand(b).contiguous()
    return trigger_extract(prob.contiguous(), t1, t2, max_picks)
