"""Smoke run of volpick_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

1. prints the card (name, power limit from nvidia-smi), torch/CUDA versions
   and the TF32 flags (both set False: every comparison is float32);
2. builds the hand-written kernels from volpick_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the main path: trigger_extract at (24, 120000), K = 80, must be
   exactly equal; lstm_multi at G=2, B=232, C in {64, 16}, H=16, T=47 within
   1e-5; and times kernel and twin with CUDA events;
4. runs the main path at full width: a seeded random-init EQTransformer
   (6000 samples, filters 8..64, 3 BiLSTM blocks) classifies 8 stations x
   20 min at 100 Hz (overlap 5500, blinding (500, 500), batch 256) through
   WaveformPicker.classify, and checks that both kernels were launched and
   that picks came out;
5. times classify_arrays on the full workload;
6. cross-checks 1 station x 5 min against the same weights on the CPU
   (curves within 1e-4; the CPU trigger twin on the GPU curves gives exactly
   the kernel's picks).

Exits non-zero on any failure and without a CUDA device. The last two lines
are a JSON summary of the kernels and {"ok": true, "device": {...}}.
"""

import json
import sys
import time

import numpy as np
import torch

TRIG_ROWS, TRIG_W, TRIG_K = 24, 120_000, 80
LSTM_G, LSTM_B, LSTM_H, LSTM_T = 2, 232, 16, 47
LSTM_TOL, CURVE_TOL = 1e-5, 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def trigger_curves(rng) -> np.ndarray:
    """(24, 120000) curves: runs across every thread-segment boundary of the
    kernel, a run touching the row end, rows with far more than K runs, a
    dense alternating row, a row that never triggers, plateaus, and smoothed
    noise rows like real probability curves."""
    w = TRIG_W
    seg = -(-w // 1024)  # samples per thread in the kernel
    rows = []
    r = np.full(w, 0.1, np.float32)
    for b in range(seg, w, seg):
        r[b - 3 : b + 2] = 0.9
    rows.append(r)
    r = np.full(w, 0.1, np.float32)
    r[w - 500 :] = np.linspace(0.3, 0.95, 500)
    rows.append(r)
    r = np.full(w, 0.05, np.float32)
    r[3::7] = 0.8
    rows.append(r)
    rows.append(np.where(np.arange(w) % 2 == 0, 0.9, 0.0).astype(np.float32))
    rows.append(np.full(w, 0.2, np.float32))
    r = np.full(w, 0.1, np.float32)
    r[:5] = [0.9, 0.9, 0.6, 0.9, 0.3]
    r[60_000:60_009] = [0.3, 0.6, 0.7, 0.7, 0.7, 0.4, 0.26, 0.6, 0.2]
    rows.append(r)
    while len(rows) < TRIG_ROWS:
        width = int(rng.integers(5, 400))
        x = np.convolve(rng.random(w), np.ones(width) / width, mode="same")
        rows.append(((x - x.min()) / (x.max() - x.min() + 1e-9)).astype(np.float32))
    return np.stack(rows)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import _build
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.picker import UTC, Stream, Trace, WaveformPicker
    from volpick_tpu_torch.picker.stage_times import (
        BATCH, BLINDING, OVERLAP, SR, STATIONS, WINDOW, bench_stream_array, cuda_ms, smi)

    name = torch.cuda.get_device_name(0)
    limit = smi("name,power.limit")
    card = f"{name} ({limit})"
    print(f"device: {name}; nvidia-smi: {limit}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {lib.name} "
          f"in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    _build.library()

    # ---- 3. kernels vs twins at the main path's shapes
    rng = np.random.default_rng(0)
    prob = torch.as_tensor(trigger_curves(rng), device=dev)
    t1 = torch.full((TRIG_ROWS,), 0.5, device=dev)
    t1[6:] = torch.as_tensor(rng.uniform(0.3, 0.8, TRIG_ROWS - 6).astype(np.float32), device=dev)
    t2 = t1 / 2.0
    got = cuda_trig.trigger_extract(prob, t1, t2, TRIG_K)
    want = cuda_trig.trigger_extract_reference(prob, t1, t2, TRIG_K)
    torch.cuda.synchronize()
    trig_err = 0.0
    for field, g, w in zip(("peak_idx", "peak_val", "valid", "onset", "offset"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            fail(f"trigger_extract {field} differs from its twin")
        trig_err = max(trig_err, float((g.double() - w.double()).abs().max()))
    n_valid = got[2].sum(dim=1).tolist()
    print(f"K1 trigger_extract ({TRIG_ROWS}, {TRIG_W}) K={TRIG_K}: equal to twin "
          f"in all five outputs; picks per row {n_valid}")
    trig_ms = cuda_ms(lambda: cuda_trig.trigger_extract(prob, t1, t2, TRIG_K))
    trig_plain_ms = cuda_ms(lambda: cuda_trig.trigger_extract_reference(prob, t1, t2, TRIG_K), iters=5)
    print(f"K1 time on {card}: kernel {trig_ms:.4f} ms, twin {trig_plain_ms:.4f} ms")

    lstm_err, lstm_ms = 0.0, {}
    for c in (64, 16):  # one forward: BiLSTM 1 at C=64; BiLSTM 2-3 and the pick LSTMs at C=16
        xs = torch.as_tensor(rng.normal(size=(LSTM_G, LSTM_B, c, LSTM_T)).astype(np.float32), device=dev)
        w_ih = torch.as_tensor((rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, c))).astype(np.float32), device=dev)
        w_hh = torch.as_tensor((rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, LSTM_H))).astype(np.float32), device=dev)
        bias = torch.as_tensor((rng.normal(size=(LSTM_G, 4 * LSTM_H)) * 0.1).astype(np.float32), device=dev)
        err = float((cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias)
                     - cuda_lstm.lstm_multi_reference(xs, w_ih, w_hh, bias)).abs().max())
        if not err <= LSTM_TOL:
            fail(f"lstm_multi C={c} max abs err {err} > {LSTM_TOL}")
        k_ms = cuda_ms(lambda: cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias))
        p_ms = cuda_ms(lambda: cuda_lstm.lstm_multi_reference(xs, w_ih, w_hh, bias), iters=5)
        print(f"K2 lstm_multi G={LSTM_G} B={LSTM_B} C={c} H={LSTM_H} T={LSTM_T}: max abs err "
              f"{err:.3e} (tol {LSTM_TOL}); time on {card}: kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms")
        lstm_err = max(lstm_err, err)
        lstm_ms[c] = (k_ms, p_ms)

    # ---- 4. main path at full width
    model = load_model("eqtransformer", seed=0, device=dev)
    picker = WaveformPicker(model, device=dev)
    data = bench_stream_array(seed=0)
    t_start = UTC("2024-06-01T00:00:00")
    stream = Stream([
        Trace(data[s, ci], dict(network="XV", station=f"S{s:02d}", channel=f"HH{comp}",
                                sampling_rate=SR, starttime=t_start))
        for s in range(STATIONS) for ci, comp in enumerate("ZNE")
    ])
    curves = picker.annotate_array(data, overlap=OVERLAP, blinding=BLINDING, batch_size=BATCH)
    if curves.shape != data.shape or not np.isfinite(curves).all():
        fail(f"curves of shape {curves.shape} or not finite")
    thr = [float(np.percentile(curves[:, k], 99.9)) for k in range(3)]  # Detection, P, S
    print(f"main path thresholds (99.9th percentile of each channel): {thr}")
    cuda_trig.launches = 0
    cuda_lstm.launches = 0
    out = picker.classify(stream, detection_threshold=thr[0], P_threshold=thr[1],
                          S_threshold=thr[2], overlap=OVERLAP, blinding=BLINDING, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = {"trigger_extract": cuda_trig.launches, "lstm_multi": cuda_lstm.launches}
    print(f"classify: {len(out.picks)} picks, {len(out.detections)} detections; launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    if len(out.picks) == 0:
        fail("classify returned no picks")

    # ---- 5. classify_arrays throughput on the full workload (before any CPU work)
    kw = dict(overlap=OVERLAP, blinding=BLINDING, batch_size=BATCH)
    thresholds = {"Detection": thr[0], "P": thr[1], "S": thr[2]}
    n_windows = STATIONS * len(range(0, data.shape[-1] - WINDOW + 1, WINDOW - OVERLAP))
    picker.classify_arrays(data, thresholds, **kw)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picker.classify_arrays(data, thresholds, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"classify_arrays on {card}: {n_windows} windows in {med * 1e3:.2f} ms (median of 5: "
          f"{[round(t * 1e3, 2) for t in times]}) = {n_windows / med:.1f} windows/s, fp32")
    print("nvidia-smi after the timed runs: " + smi("clocks.sm,power.draw,temperature.gpu"))

    # ---- 6. CPU cross-check on 1 station x 5 min, same weights
    cut = np.ascontiguousarray(data[:1, :, : int(5 * 60 * SR)])
    cpu_model = load_model("eqtransformer", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    gpu_c = picker.annotate_array(cut, **kw)
    cpu_c = WaveformPicker(cpu_model, device="cpu").annotate_array(cut, **kw)
    curve_err = float(np.abs(gpu_c - cpu_c).max())
    print(f"CPU cross-check (1 x 3 x {cut.shape[-1]}): max abs curve diff {curve_err:.3e} "
          f"(tol {CURVE_TOL})")
    if not curve_err <= CURVE_TOL:
        fail(f"GPU curves differ from CPU by {curve_err}")
    rows = torch.as_tensor(gpu_c[0], device=dev)
    rt1 = torch.as_tensor(np.float32([np.percentile(c, 99.0) for c in gpu_c[0]]), device=dev)
    on_gpu = cuda_trig.trigger_extract(rows, rt1, rt1 / 2.0, 32)
    on_cpu = cuda_trig.trigger_extract(rows.cpu(), rt1.cpu(), rt1.cpu() / 2.0, 32)
    for g, c in zip(on_gpu, on_cpu):
        if not torch.equal(g.cpu(), c):
            fail("the CPU twin of trigger_extract disagrees with the kernel on the GPU curves")
    print(f"CPU twin on GPU curves: picks equal ({int(on_cpu[2].sum())} picks)")

    print(json.dumps({"kernels": [
        {"name": "trigger_extract", "route": "cuda",
         "source": "volpick_tpu_torch/csrc/trigger_extract.cu",
         "replaces": "volpick_tpu/ops/pallas/triggers.py:250",
         "launches": launches["trigger_extract"], "max_abs_err": trig_err,
         "ms": trig_ms, "plain_ms": trig_plain_ms},
        {"name": "lstm_multi", "route": "cuda",
         "source": "volpick_tpu_torch/csrc/lstm_multi.cu",
         "replaces": "volpick_tpu/ops/pallas/lstm.py:76",
         "launches": launches["lstm_multi"], "max_abs_err": lstm_err,
         # one launch at C=64 (ms, plain_ms) and one at C=16 (*_c16)
         "ms": lstm_ms[64][0], "plain_ms": lstm_ms[64][1],
         "ms_c16": lstm_ms[16][0], "plain_ms_c16": lstm_ms[16][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
