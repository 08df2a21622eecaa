"""The yardstick's peaks and the work of the port's hand-written kernels,
counted from their call shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores,
the rate a float32 run with TF32 off can reach. The special-function rate is
derived, not published: an SM issues 16 special-function operations a clock
against 128 float32 lanes doing one multiply-add (2 operations) each, so
67e12 / 2 / 128 * 16 = 4.19e12 a second.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes over the memory rate and its operations over their
rate. Each input byte is counted as read once and each output byte as
written once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_SFU = PEAK_F32 / 2 / 128 * 16

# bytes of one pick slot in K1's five outputs: peak index (int32), peak
# value (float32), valid (bool), onset and offset (int32)
PICK_SLOT_BYTES = 4 + 4 + 1 + 4 + 4


def bound_s(n_bytes: float, flops: float = 0.0, sfu: float = 0.0) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time for this work."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(flops / PEAK_F32, sfu / PEAK_SFU)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_work(rows: int, width: int, max_picks: int) -> Tuple[float, float, float]:
    """(bytes, float32 operations, special-function operations) of one K1
    ``trigger_extract`` call: float32 curves (rows, width) and two per-row
    thresholds read, ``max_picks`` slots a row written, a handful of
    compares and selects a sample."""
    n_bytes = rows * width * 4 + rows * 2 * 4 + rows * max_picks * PICK_SLOT_BYTES
    return float(n_bytes), 8.0 * rows * width, 0.0


def k2_work(branches: int, batch: int, steps: int, hidden: int) -> Tuple[float, float, float]:
    """(bytes, float32 operations, special-function operations) of one float32
    K2 recurrence launch (``lstm_multi_kernel``): the input projection is a
    matrix product outside the kernel, so the kernel reads 4 gate inputs a
    cell, W_hh and the bias, and writes one state a cell; a cell (branch,
    window, step, unit) does a 4H-long dot product of h for each of its 4
    gates, ~10 elementwise operations, and 3 sigmoids and 2 tanh."""
    cells = branches * batch * steps * hidden
    weights = branches * 4 * hidden * (hidden + 1)
    n_bytes = cells * 4 * 4 + weights * 4 + cells * 4
    flops = 2.0 * cells * 4 * hidden + 10.0 * cells
    return float(n_bytes), flops, 5.0 * cells


def k8_work(batch: int, c_in: int, c_out: int, k: int, length_out: int) -> Tuple[float, float, float]:
    """(bytes, float32 operations, special-function operations) of one K8
    ``upconv_relu`` launch, one decoder layer: x (batch, c_in, T) upsampled
    twice to ``length_out`` = 2T or 2T - 1 samples, a 'same' convolution of
    odd width k, ReLU. The kernel reads x at its own resolution, the weights
    (c_out, c_in, k) and the bias once, and writes the output once; it folds
    the taps that land on one input sample, so an output takes p + 1 = (k + 1)
    / 2 multiply-adds an input channel, not k."""
    t_in = (length_out + 1) // 2
    n_bytes = 4 * (batch * c_in * t_in + c_out * c_in * k + c_out + batch * c_out * length_out)
    flops = 2.0 * batch * c_out * length_out * c_in * ((k - 1) // 2 + 1)
    return float(n_bytes), flops, 0.0


def flops_per_window(model, in_channels: int, in_samples: int) -> int:
    """Matrix-product and convolution operations (2 a multiply-add) of one
    window through `model`: ``torch.utils.flop_counter`` on the CPU, plus
    the LSTMs, which it does not count: per step and direction, the input
    and hidden products of 4 gates, 2 * (input + hidden) * 4 * hidden."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    lstm_ops = []

    def count_lstm(mod, args, _out):
        steps = args[0].shape[0]  # (T, B, C), batch_first off
        directions = 2 if mod.bidirectional else 1
        h = mod.hidden_size
        lstm_ops.append(2 * (mod.input_size + h) * 4 * h * steps * directions)

    hooks = [m.register_forward_hook(count_lstm) for m in model.modules()
             if isinstance(m, torch.nn.LSTM)]
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            model(torch.randn(1, in_channels, in_samples))
    finally:
        for hk in hooks:
            hk.remove()
    return int(fc.get_total_flops()) + sum(lstm_ops)
