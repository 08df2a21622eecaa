"""The headline benchmark on one CUDA device: EQTransformer classify throughput.

    python -m volpick_tpu_torch bench
    python -m volpick_tpu_torch.bench

The port of the JAX package's ``bench.py``. It measures the production
picking path end to end: a raw multi-station stream, handed over as numpy as
users pass it, goes to the card, is framed into sliding windows, conditioned
from its spans, run through EQTransformer (its default route,
``plstm+bandattn``: K2), overlap-averaged with blinding and searched for
two-threshold triggers (K1); the fixed-size pick buffers come back to the
host. Workload as ``bench.py``: 8 stations x 20 min at 100 Hz (1832 windows
a call), window 6000, overlap 5500, blinding (500, 500), "avg" stacking,
batch 256, ``max_picks`` 64, the thresholds of ``THRESHOLDS``; float32 with
TF32 off. The model is the published EQTransformer where
``from_pretrained`` finds it (``$VOLPICK_TPU_MODELS``), else
``load_model("eqtransformer", seed=0)``; stderr says which.

Timing: a call is one ``classify_arrays``, which ends with the pick buffers
on the host (so synchronised, host work included). The time a call is the
difference between a run of 24 and a run of 4 back-to-back calls (the best
of 2 runs each) over 20: the fixed cost of a run cancels, as it does in the
JAX bench's differenced device loop. The stream's upload lies inside every
call (JAX keeps it resident); its ms is printed on an earlier line.

The baseline is the same workload on CPU torch (the reference's runtime):
``tests/torch_oracle.py``'s ``EQTransformerTorch``, found by the package's
path, on one station's first 256 windows conditioned in numpy, batch 32, the
median of 3 passes.

Prints the card's name and power limit, the upload's ms, ``n_picks``, the
median single-call time and the baseline's rate on earlier lines, then ONE
JSON line last:

    {"metric": "eqt_classify_windows_per_s", "value": N, "unit": "windows/s",
     "vs_baseline": ratio_vs_cpu_torch}

With ``$BENCH_AXES`` set it also times the same calls with
``precision="bfloat16"`` and writes the two rates to ``BENCH_AXES.json`` in
the working directory (and stderr). Without CUDA it refuses (exit 1) and
prints no metric line: nothing of the timed path falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from volpick_tpu_torch.models import from_pretrained, load_model
from volpick_tpu_torch.ops.windows import window_starts
from volpick_tpu_torch.picker.annotate import WaveformPicker
from volpick_tpu_torch.picker.stage_times import (
    BATCH, BLINDING, OVERLAP, WINDOW, bench_stream_array, smi)

MAX_PICKS = 64
# bench.py's thresholds; the noise channel never triggers
THRESHOLDS = {"Detection": 0.10141666, "P": 0.22, "S": 0.22}
ORACLE = Path(__file__).resolve().parents[1] / "tests" / "torch_oracle.py"


def load_bench_model(device) -> Tuple[torch.nn.Module, bool]:
    """(model, pretrained): the published EQTransformer, or the seeded one
    where no weights are found; stderr names which."""
    try:
        model = from_pretrained("eqtransformer", device=device)
    except FileNotFoundError as e:
        print(f"bench: weights: load_model('eqtransformer', seed=0) ({e})", file=sys.stderr)
        return load_model("eqtransformer", seed=0, device=device), False
    print("bench: weights: the published eqtransformer 'volpick'", file=sys.stderr)
    return model, True


def make_picker(model, device, precision: str = "float32") -> WaveformPicker:
    return WaveformPicker(model, device=device, precision=precision)


def classify(picker: WaveformPicker, data: np.ndarray, thresholds: Optional[Dict[str, float]] = None):
    """The call the bench times: {label: (peak_idx, peak_val, valid, on, off)}."""
    return picker.classify_arrays(
        data, THRESHOLDS if thresholds is None else thresholds, overlap=OVERLAP, blinding=BLINDING,
        stacking="avg", batch_size=BATCH, max_picks=MAX_PICKS)


@dataclasses.dataclass
class Throughput:
    windows_per_s: float
    n_picks: int  # valid P picks of a call
    median_ms: float  # host clock of one call, the median over the timed calls
    windows: int  # a call
    first: dict  # the warm-up call's pick buffers
    last: dict  # the last timed call's


def throughput(picker: WaveformPicker, data: np.ndarray, iters_a: int = 4, iters_b: int = 24,
               runs: int = 2) -> Throughput:
    """Windows a second of back-to-back ``classify`` calls on `data`
    (S, 3, samples): (t_b - t_a) / (iters_b - iters_a) a call, t the best of
    `runs` runs of that many calls, after one warm-up call."""
    first = classify(picker, data)
    single, last = [], [first]

    def run(iters: int) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            t = time.perf_counter()
            last[0] = classify(picker, data)
            single.append(time.perf_counter() - t)
        return time.perf_counter() - t0

    ta = min(run(iters_a) for _ in range(runs))
    tb = min(run(iters_b) for _ in range(runs))
    per_call = max(tb - ta, 1e-9) / (iters_b - iters_a)
    windows = data.shape[0] * len(window_starts(data.shape[-1], picker.in_samples, OVERLAP))
    return Throughput(windows / per_call, int(first["P"][2].sum()), float(np.median(single)) * 1e3,
                      windows, first, last[0])


def upload_ms(data: np.ndarray, device, repeats: int = 5) -> float:
    """Median ms of the stream's copy to `device`, as ``classify_arrays``
    makes it."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.as_tensor(data, device=device)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _oracle_module():
    """``tests/torch_oracle.py`` (numpy and torch only), loaded by path."""
    spec = importlib.util.spec_from_file_location("volpick_bench_torch_oracle", ORACLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_baseline(max_windows: int = 256, batch: int = 32, repeats: int = 3,
                 state_dict: Optional[dict] = None) -> float:
    """CPU-torch reference windows/s: the median of `repeats` passes over one
    station's first `max_windows` windows, forward batched by `batch`.
    `state_dict` (SeisBench names) loads weights, as ``bench.py`` loads the
    published ones where they exist."""
    tm = _oracle_module().EQTransformerTorch()
    if state_dict is not None:
        tm.load_state_dict(state_dict)
    tm.eval()
    data = bench_stream_array(0)[0]  # one station is enough to rate-measure
    starts = window_starts(data.shape[-1], WINDOW, OVERLAP)[:max_windows]
    frames = np.stack([data[:, s : s + WINDOW] for s in starts]).astype(np.float32)
    # conditioning (detrend + peak norm), as the device path does
    t = np.arange(WINDOW) - (WINDOW - 1) / 2
    sl = ((frames - frames.mean(-1, keepdims=True)) * t).sum(-1, keepdims=True) / (t * t).sum()
    frames = frames - frames.mean(-1, keepdims=True) - sl * t
    frames = frames / (np.abs(frames).max(-1, keepdims=True) + 1e-10)
    x = torch.from_numpy(frames.astype(np.float32))
    times = []
    with torch.no_grad():
        tm(x[:2])  # warm
        for _ in range(repeats):
            t0 = time.perf_counter()
            for lo in range(0, len(starts), batch):
                tm(x[lo : lo + batch])
            times.append(time.perf_counter() - t0)
    return len(starts) / float(np.median(times))


def metric_line(rate: float, cpu: float) -> dict:
    """The last stdout line's object; ``vs_baseline`` None when the baseline
    failed (NaN)."""
    vs = rate / cpu if cpu == cpu and cpu > 0 else None
    return {"metric": "eqt_classify_windows_per_s", "value": round(rate, 2), "unit": "windows/s",
            "vs_baseline": round(vs, 2) if vs else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device; refusing to benchmark on the CPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"bench: card {smi('name,power.limit')}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    model, pretrained = load_bench_model(dev)
    data = bench_stream_array(0)
    print(f"bench: upload of the {data.nbytes / 1e6:.1f} MB stream {upload_ms(data, dev):.3f} ms "
          "(inside every timed call)")
    fp32 = throughput(make_picker(model, dev), data)
    print(f"bench: float32 {fp32.windows_per_s:.2f} windows/s ({fp32.windows} windows a call), "
          f"n_picks {fp32.n_picks}, single-call median {fp32.median_ms:.2f} ms")
    try:
        cpu = cpu_baseline(state_dict={k: v.cpu() for k, v in model.state_dict().items()}
                           if pretrained else None)
    except Exception as e:  # as bench.py: a failed baseline prints null
        traceback.print_exc()
        print(f"cpu baseline failed: {e}", file=sys.stderr)
        cpu = float("nan")
    print(f"bench: cpu-torch baseline {cpu:.2f} windows/s")
    # extended axis: bf16 with the same method, in a side file so that the
    # stdout contract stays one JSON line
    if os.environ.get("BENCH_AXES"):
        try:
            bf16 = throughput(make_picker(model, dev, "bfloat16"), data)
            extra = {"bf16_classify_windows_per_s": round(bf16.windows_per_s, 2),
                     "fp32_classify_windows_per_s": round(fp32.windows_per_s, 2),
                     "method": "back-to-back classify_arrays, differenced"}
            print(json.dumps(extra), file=sys.stderr)
            with open("BENCH_AXES.json", "w") as f:
                json.dump(extra, f)
        except Exception as e:  # as bench.py: the headline still prints
            traceback.print_exc()
            print(f"bf16 axis failed: {e}", file=sys.stderr)
    print(json.dumps(metric_line(fp32.windows_per_s, cpu)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
