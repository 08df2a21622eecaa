"""The one traffic generator: every mix under ``mixes/`` is parameters of it.

A mix file gives the request's shape (``stations``, ``samples`` at
``sampling_rate``), how many distinct inputs set-up makes (``pool``), the
synthetic signal (``noise_std``, ``events_per_station_hour``), the
``classify_arrays`` settings and the loop: ``"closed"`` (one client sending
its next request when the last returned) or ``"open"`` (requests due at
fixed times, ``rate_per_s`` a second, served by one client in order; those
not started ``drain_s`` after the window closed never are; see
``open_schedule`` for ``block_s`` and ``pattern_seed``).

The signal is the bench stream of the port's stage profiler, extended to any
length: unit-free noise plus P/S-like events, a P burst on the first
component and an S burst on the other two. Events fall at times drawn from
the seed; their number depends only on the shape, so every seed makes the
same amount of work.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# event shapes of the bench stream: P at f Hz decaying over tau seconds on
# component 0, S on components 1 and 2
P_HZ, P_TAU, P_AMP = 8.0, 2.0, 2.0
S_HZ, S_TAU, S_AMP = 4.0, 3.0, (3.0, 2.5)
EVENT_S = 20.0  # seconds of each burst that are written (exp(-20/2) < 5e-5)
S_MINUS_P_S = (2.0, 8.0)  # S-P times are drawn in this range
AMP_RANGE = (0.3, 3.0)  # each event's amplitude factor, log-uniform


def sub_seed(seed: int, stream: str) -> int:
    """A seed of its own for each use of the run's seed (weights, data,
    schedule), below 2**63, equal across runs of one seed."""
    h = 1469598103934665603
    for ch in f"{seed}/{stream}":
        h = ((h ^ ord(ch)) * 1099511628211) % 2**64
    return h % 2**63


def n_events(mix: dict) -> int:
    hours = mix["stations"] * mix["samples"] / mix["sampling_rate"] / 3600.0
    return int(round(mix["events_per_station_hour"] * hours))


def make_pool(mix: dict, seed: int, device: torch.device) -> List[np.ndarray]:
    """``pool`` distinct requests, each (stations, 3, samples) float32 numpy,
    made on `device` from the seed and handed over as numpy, as users hand
    their arrays to the picker."""
    s, n, sr = mix["stations"], mix["samples"], float(mix["sampling_rate"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    length = int(EVENT_S * sr)
    lag_max = int(S_MINUS_P_S[1] * sr)
    tau = torch.arange(length, device=device, dtype=torch.float32) / sr
    p_wave = torch.sin(2 * math.pi * P_HZ * tau) * torch.exp(-tau / P_TAU) * P_AMP
    s_wave = torch.sin(2 * math.pi * S_HZ * tau) * torch.exp(-tau / S_TAU)
    # events sit in slots of twice their span, one at most a slot, so that no
    # two bursts add into one sample: the sums on the card are then the same
    # in every run of a seed
    slot = 2 * (length + lag_max)
    n_slots = n // slot
    k = n_events(mix)
    if k > s * n_slots:
        raise ValueError(f"{k} events do not fit {s} x {n_slots} slots of {slot} samples")
    pool = []
    for _ in range(mix["pool"]):
        x = torch.randn((s, 3, n), generator=g, device=device) * mix["noise_std"]
        if k:
            pick = torch.randperm(s * n_slots, generator=g, device=device)[:k]
            u = torch.rand((k, 3), generator=g, device=device)
            sta = pick // n_slots
            t_p = (pick % n_slots) * slot + (u[:, 0] * (slot - length - lag_max)).long()
            t_s = t_p + (S_MINUS_P_S[0] * sr + u[:, 1] * (S_MINUS_P_S[1] - S_MINUS_P_S[0]) * sr).long()
            amp = torch.exp(math.log(AMP_RANGE[0]) + u[:, 2] * math.log(AMP_RANGE[1] / AMP_RANGE[0]))
            flat = x.view(-1)
            offs = torch.arange(length, device=device)
            for comp, start, wave, a in ((0, t_p, p_wave, 1.0), (1, t_s, s_wave, S_AMP[0]),
                                         (2, t_s, s_wave, S_AMP[1])):
                idx = ((sta * 3 + comp) * n + start)[:, None] + offs[None, :]
                flat.index_add_(0, idx.reshape(-1), (amp[:, None] * a * wave[None, :]).reshape(-1))
        pool.append(x.cpu().numpy())
    return pool


def closed_order(mix: dict, seed: int, n: int) -> List[int]:
    """Pool indices of a closed loop's first `n` requests: every pool entry
    once in a seeded order, then again in the same order."""
    order = np.random.default_rng(sub_seed(seed, "schedule")).permutation(mix["pool"])
    return [int(order[i % len(order)]) for i in range(n)]


def open_schedule(mix: dict, seed: int, seconds: float) -> List[Tuple[float, int]]:
    """(due second, pool index) of every request of an open loop's window,
    in time order. The window is cut into blocks of ``block_s`` seconds,
    each with ``round(rate_per_s * block_s)`` requests whose gaps are the
    quantiles of an exponential distribution at the mix's rate, scaled to
    fill the block: Poisson-like arrivals within a block, and the same load
    in every block. The order of the gaps within each block is drawn for the
    mix, from its ``pattern_seed``, and not from the run's seed, so that
    every seed gets the same set of blocks; the seed orders the blocks and
    the pool indices. Where a burst falls inside a block decides how long
    its requests queue, so a tail taken over blocks that each seed orders
    afresh would swing with the seed (a simulation at the live cell's load:
    an interquartile range of 6% of the p95 over seeds, against 2-2.5% with
    the blocks fixed)."""
    rate, block = mix["rate_per_s"], mix["block_s"]
    n_blocks = max(1, int(round(seconds / block)))
    per = max(1, int(round(rate * block)))
    q = (np.arange(per) + 0.5) / per
    gaps = -np.log1p(-q) / rate
    gaps *= (seconds / n_blocks) / gaps.sum()
    patterns = np.random.default_rng(mix["pattern_seed"])
    blocks = [gaps[patterns.permutation(per)] for _ in range(n_blocks)]
    rng = np.random.default_rng(sub_seed(seed, "schedule"))
    order = np.concatenate([blocks[b] for b in rng.permutation(n_blocks)])
    due = np.concatenate([[0.0], np.cumsum(order)[:-1]])
    idx = rng.permutation(np.arange(due.size) % mix["pool"])
    return [(float(t), int(i)) for t, i in zip(due, idx)]
