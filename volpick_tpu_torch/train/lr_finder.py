"""Learning-rate finder (the reference's Tuner.lr_find path, `train.py:194-205`).

Port of ``volpick_tpu/train/lr_finder.py``. Exponential LR sweep from min_lr
to max_lr over num_training steps of ``Trainer.train_step``; the suggested
LR is the point of steepest smoothed-loss descent, the Lightning tuner's
suggestion rule. The trainer's state is restored afterwards.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch


def lr_find(
    trainer,
    train_gen,
    min_lr: float = 1e-5,
    max_lr: float = 1e-2,
    num_training: int = 200,
    smooth: float = 0.05,
    diverge_factor: float = 4.0,
) -> Dict:
    """Returns {"suggestion": lr, "lrs": [...], "losses": [...]}. The
    trainer's parameters, BatchNorm statistics, gradients, Adam state and
    EMA are the same afterwards as before; the dropout draws come from a
    ``torch.Generator`` on the trainer's device seeded 123 (JAX's
    ``PRNGKey(123)``)."""
    model = trainer.model
    saved_state = copy.deepcopy(model.state_dict())
    saved_grads = {n: (None if p.grad is None else p.grad.clone()) for n, p in model.named_parameters()}
    saved_opt = copy.deepcopy(trainer.opt_state)
    saved_ema = copy.deepcopy(trainer.ema_params)
    was_training = model.training
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), num_training))
    losses: List[float] = []
    gen = torch.Generator(device=trainer.device).manual_seed(123)
    it = iter(train_gen.epoch())
    best = np.inf
    smoothed = None
    i = 0
    try:
        while i < num_training:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_gen.epoch())
                continue
            loss = float(trainer.train_step(batch, float(lrs[i]), gen))
            smoothed = loss if smoothed is None else smooth * loss + (1 - smooth) * smoothed
            losses.append(smoothed)
            best = min(best, smoothed)
            if smoothed > diverge_factor * best or not np.isfinite(smoothed):
                lrs = lrs[: len(losses)]
                break
            i += 1
    finally:
        with torch.no_grad():
            model.load_state_dict(saved_state, strict=True)
            for n, p in model.named_parameters():
                p.grad = saved_grads[n]
        trainer.opt_state = saved_opt
        trainer.ema_params = saved_ema
        model.train(was_training)
    losses_a = np.asarray(losses)
    if len(losses_a) < 5:
        suggestion = float(np.sqrt(min_lr * max_lr))
    else:
        k = int(np.argmin(np.gradient(losses_a)))
        suggestion = float(lrs[min(k, len(lrs) - 1)])
    return {"suggestion": suggestion, "lrs": list(map(float, lrs[: len(losses)])), "losses": losses}
