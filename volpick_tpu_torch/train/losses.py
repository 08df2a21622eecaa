"""Training losses (PyTorch port of ``volpick_tpu/train/losses.py``;
reference `volpick/model/models.py:34-51` and `:539-549`), on probabilities,
with the same eps and clip."""

from __future__ import annotations

import torch


def vector_cross_entropy(y_pred: torch.Tensor, y_true: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """PhaseNet loss: -mean over the batch of the sum over classes of the mean
    over time of y log(ŷ + eps). y_pred, y_true (B, classes, W)."""
    h = y_true * torch.log(y_pred + eps)
    return -h.mean(dim=-1).sum(dim=-1).mean()


def bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities clipped to [eps, 1 - eps], mean
    reduction (torch BCELoss semantics)."""
    pred = torch.clamp(pred, eps, 1.0 - eps)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred)).mean()


def weighted_bce(
    det_pred, p_pred, s_pred, det_true, p_true, s_true, weights=(0.05, 0.40, 0.55)
) -> torch.Tensor:
    """EQTransformer loss: weighted BCE over the (detection, P, S) heads."""
    return (
        weights[0] * bce(det_pred, det_true)
        + weights[1] * bce(p_pred, p_true)
        + weights[2] * bce(s_pred, s_true)
    )


def vol_eqt_loss(
    rg_pred, lp_pred, p_pred, s_pred, rg_true, lp_true, p_true, s_true,
    weights=(0.05, 0.05, 0.45, 0.45),
):
    """VolEQTransformer loss: weighted BCE over (regular detection, LP
    detection, P, S), one weight a head."""
    return (
        weights[0] * bce(rg_pred, rg_true)
        + weights[1] * bce(lp_pred, lp_true)
        + weights[2] * bce(p_pred, p_true)
        + weights[3] * bce(s_pred, s_true)
    )
