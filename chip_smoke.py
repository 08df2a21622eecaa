"""Smoke run of volpick_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

1. prints the card (name, power limit from nvidia-smi), torch/CUDA versions
   and the TF32 flags (both set False: every comparison is float32);
2. builds the hand-written kernels from volpick_tpu_torch/csrc with nvcc
   (one nvcc per source, in parallel);
3. holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the main paths, and times kernel and twin with CUDA events:
   K1 trigger_extract at (24, 120000), K = 80, exactly equal; K2 lstm_multi
   at G=2, B=232, C in {64, 16}, H=16, T=47 within 1e-5; K7 mha at
   (128, 128, 94), 4 heads (TPUPickNet's batch-128 step) within 1e-5;
4. drives every ported picker at full width with seeded random weights on
   the bench stream (8 stations x 20 min at 100 Hz) through
   WaveformPicker.classify, with the launch counts set to 0 just before and
   read just after each run:
   - EQTransformer (6000 samples; overlap 5500, blinding (500, 500), batch 256);
   - PhaseNet (3001 samples, depth 5; overlap 1500, batch 256);
   - TPUPickNet (3008 samples, d_model 128, 4 heads, 4 layers; overlap 1504,
     batch 128), once with attn="xla" and once with attn="pallas" (K7);
   - VolEQTransformer (EQTransformer's settings);
   each must pick and launch exactly the kernels of its path (K1 once a
   call; K2 4 times a forward on the EQT family; K7 n_layers times a forward
   under "pallas", never otherwise);
5. times classify_arrays on each (median of 5, windows/s; the window count
   includes the flush window) and sums its kernel time in one call under
   torch.profiler, and times TPUPickNet's two attention routes once more on
   one model in turns (xla, pallas, pallas, xla; median of 10 each);
6. cross-checks 1 station x 5 min of each against the same weights on the
   CPU (curves within 1e-4); on EQTransformer also the CPU twin of K1 on the
   GPU curves gives exactly the kernel's picks.

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
MHA_B, MHA_D, MHA_T, MHA_H = 128, 128, 94, 4
LSTM_TOL, MHA_TOL, CURVE_TOL = 1e-5, 1e-5, 1e-4

# (label, arch, model kwargs, overlap, blinding, batch)
PATHS = [
    ("eqtransformer", "eqtransformer", {}, 5500, (500, 500), 256),
    ("phasenet", "phasenet", {}, 1500, (0, 0), 256),
    ("tpupicknet/xla", "tpupicknet", {"attn": "xla"}, 1504, (0, 0), 128),
    ("tpupicknet/pallas", "tpupicknet", {"attn": "pallas"}, 1504, (0, 0), 128),
    ("voleqtransformer", "voleqtransformer", {}, 5500, (500, 500), 256),
]


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


def classify_seconds(picker, data, thresholds, kw) -> float:
    """Host-clock seconds of one classify_arrays call (it returns host numpy
    picks, so the call ends synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    picker.classify_arrays(data, thresholds, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import _build
    from volpick_tpu_torch.ops.cuda import attention as cuda_attn
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.ops.windows import window_starts
    from volpick_tpu_torch.picker import UTC, Stream, Trace, WaveformPicker
    from volpick_tpu_torch.picker.stage_times import (
        SR, STATIONS, bench_stream_array, cuda_ms, profiled, self_device_us, smi)

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
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, one per source in parallel -> {lib.name} "
          f"in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    _build.library()

    # ---- 3. kernels vs twins at the main paths' shapes
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

    # q scaled as TPUPickNet scales it (1/sqrt(Dh)), so the scores have the
    # model's spread
    q, k, v = (torch.as_tensor(rng.normal(size=(MHA_B, MHA_D, MHA_T)).astype(np.float32), device=dev)
               for _ in range(3))
    q = q * (MHA_H / MHA_D) ** 0.5
    mha_out = cuda_attn.mha(q, k, v, MHA_H)
    mha_twin = cuda_attn.mha_reference(q, k, v, MHA_H)
    mha_f64 = cuda_attn.mha_reference(q.double(), k.double(), v.double(), MHA_H)
    torch.cuda.synchronize()
    mha_err = float((mha_out - mha_twin).abs().max())
    if not mha_err <= MHA_TOL:
        fail(f"mha max abs err {mha_err} > {MHA_TOL}")
    mha_ms = cuda_ms(lambda: cuda_attn.mha(q, k, v, MHA_H), iters=50)
    mha_plain_ms = cuda_ms(lambda: cuda_attn.mha_reference(q, k, v, MHA_H), iters=50)
    print(f"K7 mha ({MHA_B}, {MHA_D}, {MHA_T}) H={MHA_H}: max abs err {mha_err:.3e} vs twin (tol "
          f"{MHA_TOL}); vs float64: kernel {float((mha_out - mha_f64).abs().max()):.3e}, twin "
          f"{float((mha_twin - mha_f64).abs().max()):.3e}; time on {card}: kernel {mha_ms:.4f} ms, "
          f"twin {mha_plain_ms:.4f} ms")

    # ---- 4-6. every picker at full width on the bench stream
    data = bench_stream_array(seed=0)
    t_start = UTC("2024-06-01T00:00:00")
    stream = Stream([
        Trace(data[s, ci], dict(network="XV", station=f"S{s:02d}", channel=f"HH{comp}",
                                sampling_rate=SR, starttime=t_start))
        for s in range(STATIONS) for ci, comp in enumerate("ZNE")
    ])
    cut = np.ascontiguousarray(data[:1, :, : int(5 * 60 * SR)])
    counters = {"trigger_extract": cuda_trig, "lstm_multi": cuda_lstm, "mha": cuda_attn}
    by_path, rates, thresholds_of, device_of = {}, {}, {}, {}
    for label, arch, margs, overlap, blinding, batch in PATHS:
        model = load_model(arch, seed=0, device=dev, **margs)
        picker = WaveformPicker(model, device=dev)
        kw = dict(overlap=overlap, blinding=blinding, batch_size=batch)
        channels = picker._prob_channels()
        curves = picker.annotate_array(data, **kw)
        if curves.shape != (STATIONS, len(channels), data.shape[-1]) or not np.isfinite(curves).all():
            fail(f"{label}: curves of shape {curves.shape} or not finite")
        # 99.9th percentile of each channel: random weights have no fixed scale
        thr = {lab: float(np.percentile(curves[:, i], 99.9)) for i, lab in enumerate(channels)}
        det = min(v for lab, v in thr.items() if lab.startswith("Detection")) if arch.endswith(
            "eqtransformer") else None
        forwards = [0]
        hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        for mod in counters.values():
            mod.launches = 0
        out = picker.classify(stream, P_threshold=thr["P"], S_threshold=thr["S"],
                              detection_threshold=det, **kw)
        torch.cuda.synchronize()
        launches = {kn: mod.launches for kn, mod in counters.items()}
        hook.remove()
        n_fwd = forwards[0]
        by_path[label] = launches
        print(f"{label}: classify {len(out.picks)} picks, {len(out.detections)} detections, "
              f"{n_fwd} forwards; launches {launches}; thresholds {thr}")
        want = {
            "lstm_multi": 4 * n_fwd if arch.endswith("eqtransformer") else 0,
            "mha": model.n_layers * n_fwd if margs.get("attn") == "pallas" else 0,
        }
        if launches["trigger_extract"] < 1 or any(launches[kn] != n for kn, n in want.items()):
            fail(f"{label}: launches {launches}, want trigger_extract >= 1 and {want}")
        if len(out.picks) == 0:
            fail(f"{label}: classify returned no picks")

        # classify_arrays throughput, windows counted from window_starts
        thresholds = dict(thr, **({"Detection": det, "Detection_rg": det, "Detection_lp": det}
                                  if det is not None else {}))
        thresholds_of[label] = thresholds
        n_windows = STATIONS * len(window_starts(data.shape[-1], model.in_samples, overlap))
        picker.classify_arrays(data, thresholds, **kw)
        times = [classify_seconds(picker, data, thresholds, kw) for _ in range(5)]
        med = float(np.median(times))
        rates[label] = n_windows / med
        print(f"{label}: classify_arrays on {card}: {n_windows} windows in {med * 1e3:.2f} ms "
              f"(median of 5: {[round(t * 1e3, 2) for t in times]}) = {n_windows / med:.1f} "
              f"windows/s, fp32")
        print(f"{label}: nvidia-smi after the timed runs: "
              + smi("clocks.sm,power.draw,temperature.gpu"))
        _, dev_ms, events = profiled(lambda: picker.classify_arrays(data, thresholds, **kw))
        k7_ms = sum(self_device_us(e) for e in events if "mha_kernel" in e.key) / 1e3
        device_of[label] = dev_ms
        print(f"{label}: one classify_arrays under torch.profiler: summed kernel time "
              f"{dev_ms:.2f} ms (K7 mha_kernel {k7_ms:.3f} ms); idle share against the "
              f"median {max(0.0, 1 - dev_ms / (med * 1e3)):.3f}")

        # CPU cross-check on 1 station x 5 min, same weights
        cpu_model = load_model(arch, device="cpu", **margs)
        cpu_model.load_state_dict({k_: v_.cpu() for k_, v_ in model.state_dict().items()}, strict=True)
        gpu_c = picker.annotate_array(cut, **kw)
        cpu_c = WaveformPicker(cpu_model, device="cpu").annotate_array(cut, **kw)
        curve_err = float(np.abs(gpu_c - cpu_c).max())
        print(f"{label}: CPU cross-check (1 x 3 x {cut.shape[-1]}): max abs curve diff "
              f"{curve_err:.3e} (tol {CURVE_TOL})")
        if not curve_err <= CURVE_TOL:
            fail(f"{label}: GPU curves differ from CPU by {curve_err}")
        if label == "eqtransformer":
            rows = torch.as_tensor(gpu_c[0], device=dev)
            rt1 = torch.as_tensor(np.float32([np.percentile(c, 99.0) for c in gpu_c[0]]), device=dev)
            on_gpu = cuda_trig.trigger_extract(rows, rt1, rt1 / 2.0, 32)
            on_cpu = cuda_trig.trigger_extract(rows.cpu(), rt1.cpu(), rt1.cpu() / 2.0, 32)
            for g, c in zip(on_gpu, on_cpu):
                if not torch.equal(g.cpu(), c):
                    fail("the CPU twin of trigger_extract disagrees with the kernel on the GPU curves")
            print(f"CPU twin on GPU curves: picks equal ({int(on_cpu[2].sum())} picks)")
        del model, picker, cpu_model
        torch.cuda.empty_cache()

    # TPUPickNet's attention routes in turns on one model and picker
    label, arch, _, overlap, blinding, batch = PATHS[3]
    model = load_model(arch, seed=0, device=dev)
    picker = WaveformPicker(model, device=dev)
    kw = dict(overlap=overlap, blinding=blinding, batch_size=batch)
    n_windows = STATIONS * len(window_starts(data.shape[-1], model.in_samples, overlap))
    turns = {"xla": [], "pallas": []}
    for attn in ["xla", "pallas", "pallas", "xla"] * 5:
        model.attn = attn
        turns[attn].append(classify_seconds(picker, data, thresholds_of[label], kw))
    for attn, times in turns.items():
        med = float(np.median(times))
        rates[f"tpupicknet/{attn} in turns"] = n_windows / med
        print(f"tpupicknet/{attn} in turns: classify_arrays on {card}: {n_windows} windows in "
              f"{med * 1e3:.2f} ms (median of 10: {[round(t * 1e3, 2) for t in times]}) = "
              f"{n_windows / med:.1f} windows/s, fp32")

    print(f"classify_arrays windows/s on {card}: "
          + ", ".join(f"{lab} {r:.1f}" for lab, r in rates.items()))
    print(f"classify_arrays summed kernel ms on {card}: "
          + ", ".join(f"{lab} {ms:.2f}" for lab, ms in device_of.items()))
    print(json.dumps({"kernels": [
        {"name": "trigger_extract", "route": "cuda",
         "source": "volpick_tpu_torch/csrc/trigger_extract.cu",
         "replaces": "volpick_tpu/ops/pallas/triggers.py:250",
         "launches": by_path["eqtransformer"]["trigger_extract"], "max_abs_err": trig_err,
         "ms": trig_ms, "plain_ms": trig_plain_ms},
        {"name": "lstm_multi", "route": "cuda",
         "source": "volpick_tpu_torch/csrc/lstm_multi.cu",
         "replaces": "volpick_tpu/ops/pallas/lstm.py:76",
         "launches": by_path["eqtransformer"]["lstm_multi"], "max_abs_err": lstm_err,
         # one launch at C=64 (ms, plain_ms) and one at C=16 (*_c16)
         "ms": lstm_ms[64][0], "plain_ms": lstm_ms[64][1],
         "ms_c16": lstm_ms[16][0], "plain_ms_c16": lstm_ms[16][1]},
        {"name": "mha", "route": "cuda",
         "source": "volpick_tpu_torch/csrc/mha.cu",
         "replaces": "volpick_tpu/ops/pallas/attention.py:55",
         "launches": by_path["tpupicknet/pallas"]["mha"], "max_abs_err": mha_err,
         "ms": mha_ms, "plain_ms": mha_plain_ms},
    ], "launches_by_path": by_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
