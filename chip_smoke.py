"""Smoke run of volpick_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

1. prints the card (name, power limit from nvidia-smi), torch/CUDA versions
   and the TF32 flags (both set False: every comparison is float32);
2. builds the hand-written kernels from volpick_tpu_torch/csrc with nvcc
   (one nvcc per source, in parallel);
3. holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the main paths, and times kernel and twin with CUDA events:
   K1 trigger_extract at (24, 120000), K = 80, with runs across every piece
   boundary of its split of a row over warps and rows built around its count
   of picks a piece (a run open where a piece begins that crossed t1 only in
   an earlier piece, the same without any crossing, the K-th pick the last
   run end of one piece and the next the first of the following, exactly K
   picks), and at (3000, 6000), K = 64, many short rows of one piece each:
   exactly equal in all five outputs, timed by its kernels' rows in
   torch.profiler with the CUDA-event time beside it; K2 at B=232,
   C in {64, 16}, H=16, T=47 within 1e-5 in both forms: lstm_multi (G=2
   inputs, (G, B, H, T) out) and lstm_branches (one x, the second branch
   scanning time backward, (B, G*H, T) out, the form the models call), the
   latter also against the stacked and flipped lstm_multi it replaces, with
   the whole call's time by CUDA events and, from torch.profiler, its summed
   kernel time and the recurrence kernel's alone; K3 trigger_scan at
   (24, 120000), with runs across every step and piece boundary of its split
   of a row over warps, a run longer than two pieces and a row whose first
   run starts in its second piece, and at (3000, 6000), many short rows of
   one piece each:
   exactly equal in all three outputs, timed by CUDA events and by its
   kernels' rows in torch.profiler, each shape beside its own bound; K4
   condition_windows at (232, 3, 6000) over detrend x norm within 2e-5, each
   mode timed by the kernel's profiler row and by CUDA events; K5 at
   x (232, 16, 47), U = 32 within 1e-5 in both entries: addattn (q / k
   (232, 47, 32) projected by the caller) and addattn_x (projects inside,
   the entry the model calls), the latter also against the former fed
   PyTorch's projections, at the model's scale and at one that saturates
   tanh, kernel and twin also against a float64 evaluation (the kernel no
   worse than 1e-5 there either), timed by the kernel's row in torch.profiler
   (a launch is shorter than its Python wrapper) with the CUDA-event time
   beside it; K7 at (128, 128, 94), 4 heads (TPUPickNet's
   batch-128 step) within 1e-5 in both entries: mha (head-major) and mha_qkv
   (in place on the (128, 94, 3, 4, 32) projection, the entry the model
   calls), the latter also against the former on the same data; K6
   res_cnn_stack at (232, 64, 47) within 3e-4 of its twin and of the model's
   res-CNN section, fed the encoder's output for the bench stream's steps
   (phase 4b). Beside each kernel it prints the least time the card could
   take for the same work (bytes over 3.35 TB/s, float32 operations over 67
   TFLOP/s, transcendentals over the special-function units' 67 / 16 T/s; the
   largest of the three) and, for K2 and K7, the time of the one PyTorch call
   that computes the same function (torch.nn.LSTM(bidirectional=True);
   F.scaled_dot_product_attention on views of the same projection):
   yardsticks only, the port calls neither;
4. drives every ported picker at full width with seeded random weights on
   the bench stream (8 stations x 20 min at 100 Hz) through
   WaveformPicker.classify, with the launch counts set to 0 just before and
   read just after each run:
   - EQTransformer (6000 samples; overlap 5500, blinding (500, 500), batch 256);
   - PhaseNet (3001 samples, depth 5; overlap 1500, batch 256);
   - TPUPickNet (3008 samples, d_model 128, 4 heads, 4 layers; overlap 1504,
     batch 128), once with attn="xla" and once with attn="pallas" (K7);
   - VolEQTransformer (EQTransformer's settings);
   - EQTransformer on its opt-in route ("eqtransformer/optin"):
     fused="plstm+bandattn+pattn", WaveformPicker(use_pallas=True) and
     VOLPICK_TRIGGER_METHOD=pallas (set for this path only);
   each must pick and launch exactly the kernels of its path (K1 once a
   call, on the opt-in route K3 instead; K2 4 times a forward on the EQT
   family; K7 n_layers times a forward under "pallas"; on the opt-in route
   K5 twice a forward and K4 once a forward; never otherwise). The opt-in
   route's curves must lie within 1e-4 of the default EQTransformer path's
   (same weights), and on them method="pallas" must give exactly the picks
   of method="pallas_full";
4b. runs K6 over the 8 steps of the bench stream (counts set to 0 before,
   read after): conditioned windows through the full-width model's encoder,
   then the kernel against the model's seven res-CNN modules (BatchNorm
   statistics set away from (0, 1) from the seed). K6 is wired into no
   forward, as in the JAX package; its time by CUDA events and by its row in
   torch.profiler, with its launch plan (windows a CTA, CTAs, shared memory);
4c. streams 2 stations of the bench stream through StreamingPicker on a
   full-width EQTransformer: 10-second packets a component, overlap 5500,
   blinding (500, 500), a pass every 30 s of new data, then flush(). The
   streamed picks must be those of offline classify() on the same records
   (trace id, phase, peak sample), each once, and offline's picks must be the
   numpy oracle's trigger rule on the card's own curves; every pass launches
   K1 once and K2 4 times a forward (counts set to 0 before, read after).
   Seeded random weights give nearly flat curves (one trigger run a row), on
   which a streamed pick means nothing, so the heads' logits are stretched
   about their median first (a gain and a bias on the four output convs, from
   the seed's own curves): isolated peaks, a few dozen picks a station;
4d. holds EQTransformer's other routes to the default one on 1 station x 5 min
   with the same weights: fused=False, "lstm", "polyup", "grouped",
   "blockdiag+polyup" (none of which may launch K2) and
   "plstm+bandattn+grouped+polyup" (K2 4 times a forward): curves within 1e-4
   with the seeded weights as they are, and the same picks with 4c's stretched
   heads, at thresholds that stay clear of every curve sample by more than
   the routes differ (same triggers; the same peak sample, or one whose value
   the two routes cannot tell apart);
5. times classify_arrays on each (median of 5, windows/s; the window count
   includes the flush window) and sums its kernel time in one call under
   torch.profiler (with the call's aten::copy_ and aten::mul launches, which
   set TPUPickNet's "pallas" route beside its "xla" route), and times
   TPUPickNet's two attention routes once more on one model in turns (xla,
   pallas, pallas, xla; median of 10 each);
6. cross-checks 1 station x 5 min of each against the same weights on the
   CPU (curves within 1e-4); on EQTransformer also the CPU twin of K1 on the
   GPU curves gives exactly the kernel's picks;
7. trains EQTransformer at full width (6000 samples, filters 8..64, 3 BiLSTM
   blocks, drop_rate 0.1) with the settings of
   examples/configs/eqtransformer_vcseis.json (batch 1024, lr 1e-3, Adam,
   EMA, stack_data, loss weights (0.05, 0.40, 0.55), peak norm, sigma 20)
   through Trainer.fit on a synthetic pool of 2048 events and 512 noise
   traces of 3 x 12288 samples resident on the card (data/synthetic.py's
   arrays in RawBatchSource.from_arrays: the card machine has no h5py), 20
   steps and one validation pass; fails unless every loss is finite, the
   train steps launch no kernel and validation launches K2 4 times a
   forward (counts set to 0 before, read after), every trained tensor has a
   finite gradient, nonzero except the 14 that are zero by construction
   (BatchNorm-cancelled biases, the attention `ba`), and moved, the
   BatchNorm statistics moved, the EMA is exactly the rule on the recorded
   parameters, 20 steps on one fixed batch with warmup 0 lower the loss,
   and the gradient of 8 windows on the card is within 1e-3 of the CPU
   port's (relative to each tensor's largest entry, in float64; the float32
   difference printed beside it); prints the median train step and the
   augmentation of a batch by CUDA events, samples/s and
   torch.cuda.max_memory_allocated beside the card's name and power limit.

8. evaluates a full-width EQTransformer (seeded weights, heads stretched as
   in 4c on its first batch's curves) on phase 7's synthetic traces through
   data/synthetic.py's in-memory dataset: the targets of
   generate_task0/1/23 (noise_before_events as the command line passes it),
   eval_task0 over its default 9 thresholds at batch 256 on the dev and test
   windows, eval_task0_true_negative_rate, eval_tasks123, opt_prob_metrics,
   parse_task1 and parse_task23; fails unless eval_task0's sweep launches K1
   2 times and K2 4 times a batch and nothing else (counts set to 0 before,
   read after), each of those K2 calls (full and partial batches) is within
   1e-5 of its twin on the same inputs, the sweep's pick lists equal
   evaluate()'s at every threshold,
   K1's picks on the card's own curves equal its twin's (on the card at every
   threshold, on the CPU at the lowest) and the numpy trigger rule's, 32
   windows' curves lie within 1e-4 of the CPU port's, the metrics CSVs have
   the reference's columns, some threshold gives picks in a tenth of the
   windows without one run over every region, and the parsed metrics are
   finite; prints eval_task0's windows/s by the host clock, one sweep batch's
   device work by CUDA events and its summed kernel time, and K1's profiler
   row at (9 x 256, 6000), K = 64, beside its bound.

Exits non-zero on any failure and without a CUDA device. The last two lines
are a JSON summary of the kernels and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

TRIG_ROWS, TRIG_W, TRIG_K = 24, 120_000, 80
SHORT_ROWS, SHORT_W, SHORT_K = 3000, 6000, 64  # many short rows, as an evaluation sweep hands them to K1 / K3
LSTM_G, LSTM_B, LSTM_H, LSTM_T = 2, 232, 16, 47
MHA_B, MHA_D, MHA_T, MHA_H = 128, 128, 94, 4
COND_N, COND_C, COND_W = 232, 3, 6000
ATT_B, ATT_C, ATT_T, ATT_U = 232, 16, 47, 32
RES_B, RES_C, RES_T = 232, 64, 47
STREAM_STATIONS, PACKET, HOP_S = 2, 1000, 30.0  # 10-second packets at 100 Hz, a pass every 30 s
LSTM_TOL, MHA_TOL, CURVE_TOL = 1e-5, 1e-5, 1e-4
COND_TOL, ATT_TOL, RES_TOL = 2e-5, 1e-5, 3e-4
# phase 7: a synthetic pool on the card, about TRAIN_STEPS steps of the
# training config, the card-vs-CPU gradient on GRAD_WINDOWS windows
TRAIN_CONFIG = "examples/configs/eqtransformer_vcseis.json"
TRAIN_EVENTS, TRAIN_NOISE, TRAIN_SAMPLES = 2048, 512, 12_288
TRAIN_STEPS, TIMED_STEPS, OVERFIT_STEPS, GRAD_WINDOWS = 20, 10, 20, 8
GRAD_TOL = 1e-3
# phase 8: eval_task0's default sweep at EQTransformer's batch (K1 on 9 x 256
# rows a phase), the card-vs-CPU curves on EVAL_CPU_WINDOWS windows
EVAL_SETS, EVAL_THRESHOLDS, EVAL_BATCH, EVAL_K = ("dev", "test"), tuple(np.arange(0.1, 0.95, 0.1)), 256, 64
EVAL_CPU_WINDOWS, EVAL_PICK_SHARE = 32, 0.1
GOLDEN_METRICS = ["prob_thre", "tp_thre"] + [  # the reference's {set}_metrics.csv (`eval_taks0.py:722-783`)
    f"{ph}_{c}" for ph in ("p", "s") for c in (
        "TP", "FP", "FN", "precision", "recall", "F1score", "mean", "median", "std", "MAE", "MAD", "out",
        "modified_mean", "modified_median", "modified_std", "modified_RMSE", "modified_MAE", "modified_MAD",
        "modified_mean2", "modified_median2", "modified_std2", "modified_RMSE2", "modified_MAE2",
        "modified_MAD2")]

# H100 SXM data sheet: device memory rate, float32 rate outside the tensor
# cores, and the special-function units (16 a clock an SM against 128 float32
# lanes doing a multiply-add each: 67e12 / 2 / 8)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
PEAK_SFU = PEAK_F32 / 16

OPTIN = "eqtransformer/optin"
# (label, arch, model kwargs, picker kwargs, environment, overlap, blinding, batch)
PATHS = [
    ("eqtransformer", "eqtransformer", {}, {}, {}, 5500, (500, 500), 256),
    ("phasenet", "phasenet", {}, {}, {}, 1500, (0, 0), 256),
    ("tpupicknet/xla", "tpupicknet", {"attn": "xla"}, {}, {}, 1504, (0, 0), 128),
    ("tpupicknet/pallas", "tpupicknet", {"attn": "pallas"}, {}, {}, 1504, (0, 0), 128),
    ("voleqtransformer", "voleqtransformer", {}, {}, {}, 5500, (500, 500), 256),
    (OPTIN, "eqtransformer", {"fused": "plstm+bandattn+pattn"}, {"use_pallas": True},
     {"VOLPICK_TRIGGER_METHOD": "pallas"}, 5500, (500, 500), 256),
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bound(n_bytes: float, flops: float = 0.0, sfu: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take, each
    input byte read once and each output byte written once, float32
    operations at the non-tensor-core rate and transcendentals (tanh, exp,
    sigmoid) one each at the special-function units' rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(flops / PEAK_F32, sfu / PEAK_SFU)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conditioning_rows(rng, n, c, w) -> np.ndarray:
    """Unit-variance noise on an offset and a straight line 20 to 30 times larger."""
    t = np.linspace(-1.0, 1.0, w)
    x = rng.normal(size=(n, c, w))
    x += rng.uniform(-20, 20, (n, c, 1)) + rng.uniform(-30, 30, (n, c, 1)) * t
    return x.astype(np.float32)


def trigger_curves(rng, step: int, piece: int):
    """(24, 120000) curves and the number of constructed rows among them
    (thresholds 0.5 / 0.25 there): runs across every thread-segment boundary of K1
    and across every step and piece boundary of K3 (`step` samples a warp
    scans at a time, `piece` samples a warp), a run longer than two pieces
    whose max sits in its first, a row whose first run starts in its second
    piece, a run touching the row end, rows with far more than K runs, a
    dense alternating row, a row that never triggers, plateaus, and smoothed
    noise rows like real probability curves."""
    w = TRIG_W
    seg = -(-w // 1024)  # samples per thread in K1
    rows = []
    r = np.full(w, 0.1, np.float32)
    for b in range(seg, w, seg):
        r[b - 3 : b + 2] = 0.9
    rows.append(r)
    r = np.full(w, 0.1, np.float32)
    for b in range(step, w, step):  # K3: a piece is a whole number of steps
        r[b - 3 : b + 2] = 0.9 if b % piece else 0.95
    rows.append(r)
    r = np.full(w, 0.1, np.float32)
    r[piece - 100 : 3 * piece + 300] = 0.4  # crosses t1 only at its peak, in the first piece
    r[piece - 40] = 0.97
    r[3 * piece + 900 : 3 * piece + 905] = 0.9
    rows.append(r)
    r = np.full(w, 0.1, np.float32)
    r[piece + 5 : piece + 50] = np.linspace(0.3, 0.9, 45)
    r[5 * piece - 2 : 5 * piece + 2] = 0.8
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
    # K1's count: a run open where a piece begins that ends in it without
    # crossing t1 there emits only if it crossed t1 in an earlier piece
    # (pending, resolved true); the same run without any crossing (resolved
    # false), a later pick keeping its slot either way
    for crossed in (True, False):
        r = np.full(w, 0.1, np.float32)
        r[piece - 30 : 2 * piece + 40] = 0.4
        if crossed:
            r[piece - 20] = 0.9
        r[4 * piece + 7 : 4 * piece + 12] = 0.8
        rows.append(r)
    # the K-th pick is the last run end of one piece, the (K+1)-th the first
    # of the next; and a row with exactly K picks
    ends = [2 * piece - 2 - 3 * j for j in range(TRIG_K)][::-1]
    for more in ([2 * piece + 1], []):
        r = np.full(w, 0.1, np.float32)
        r[ends + more] = 0.9
        rows.append(r)
    n_fixed = len(rows)
    while len(rows) < TRIG_ROWS:
        width = int(rng.integers(5, 400))
        x = np.convolve(rng.random(w), np.ones(width) / width, mode="same")
        rows.append(((x - x.min()) / (x.max() - x.min() + 1e-9)).astype(np.float32))
    return np.stack(rows), n_fixed


def classify_seconds(picker, data, thresholds, kw) -> float:
    """Host-clock seconds of one classify_arrays call (it returns host numpy
    picks, so the call ends synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    picker.classify_arrays(data, thresholds, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def stretch_heads(model, samples) -> None:
    """Stretch every head's logits about their median on its curve `samples`
    (one array a head, detection first): b' = a (b - m) - 5, w' = a w, with a
    one-sigma deviation of the logit made 1.5. Seeded weights give nearly
    flat curves; after this, mostly ~0.007 with isolated peaks."""
    heads = [model.conv_d] + list(model.pick_convs)
    with torch.no_grad():
        for head, pr in zip(heads, samples):
            pr = np.asarray(pr, dtype=np.float64)
            lo_, mid_, hi_ = np.percentile(np.log(pr / (1 - pr)), [16, 50, 84])
            a = 1.5 / float((hi_ - lo_) / 2)
            head.bias.copy_((head.bias - float(mid_)) * a - 5.0)
            head.weight.mul_(a)


def structural_zero_grads(model) -> set:
    """EQTransformer parameters whose gradient is zero by construction, in the
    JAX package as in the port: the conv biases that a train-mode BatchNorm
    subtracts again (res-CNN conv1, BiLSTM conv) and the attention biases
    `ba`, which softmax's max subtraction cancels. Their gradients are
    rounding noise."""
    names = {f"res_cnn_stack.members.{j}.conv1.bias" for j in range(len(model.res_cnn_stack.members))}
    names |= {f"bi_lstm_stack.members.{j}.conv.bias" for j in range(len(model.bi_lstm_stack.members))}
    names |= {"transformer_d0.attention.ba", "transformer_d.attention.ba"}
    return names | {f"pick_attentions.{k}.ba" for k in range(len(model.pick_attentions))}


def train_phase(dev, card, zero_counts, read_counts, waves, meta) -> dict:
    """Phase 7: EQTransformer at full width trained on the card by the port's
    Trainer with the settings of TRAIN_CONFIG, on a synthetic pool resident on
    the card (``RawBatchSource.from_arrays``: the card machine has no h5py, so
    no dataset file is written). Fails on any miss of its checks."""
    import copy

    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.pipeline.augmentations import augment_train_batch, draw_augment
    from volpick_tpu_torch.pipeline.generator import RawBatchSource, TrainGenerator
    from volpick_tpu_torch.train.trainer import Trainer, make_augment_config

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, TRAIN_CONFIG)) as f:
        config = json.load(f)
    margs = config["model_args"]
    batch_size = int(config["batch_size"])

    # ---- the pool: events and noise traces of 3 x TRAIN_SAMPLES, on the card
    t0 = time.perf_counter()
    p = np.array([m["trace_p_arrival_sample"] for m in meta], np.float32)
    s = np.array([m["trace_s_arrival_sample"] for m in meta], np.float32)
    is_lp = np.array([m["source_type"] == "lp" for m in meta], np.float32)
    is_dev = np.array([m["split"] == "dev" for m in meta])
    event = ~np.isnan(p) | ~np.isnan(s)

    def source(mask):
        return RawBatchSource.from_arrays(waves[mask], p[mask], s[mask], is_lp=is_lp[mask])

    model = load_model("eqtransformer", seed=0, device=dev)
    cfg = make_augment_config(model, margs, bool(config["stack_data"]))
    train_gen = TrainGenerator(source(~is_dev), cfg, batch_size, eq_dataset=source(~is_dev & event),
                               noise_dataset=source(~is_dev & ~event), seed=42, device=dev)
    dev_gen = TrainGenerator(source(is_dev), cfg, batch_size, eq_dataset=source(is_dev & event),
                             noise_dataset=source(is_dev & ~event), seed=43, drop_last=False, device=dev)
    if not train_gen.device_data or not dev_gen.device_data:
        fail("training: the trace pools are not resident on the card")
    pool_mb = sum(src.pool_bytes for g in (train_gen, dev_gen) for src in (g.primary, g.eq, g.noise)) / 1e6
    print(f"training: synthetic pool of {TRAIN_EVENTS} events + {TRAIN_NOISE} noise traces of 3 x "
          f"{TRAIN_SAMPLES} samples ({int((~is_dev).sum())} train, {int(is_dev.sum())} dev), {pool_mb:.0f} MB "
          f"of trace pools on the card, made in {time.perf_counter() - t0:.1f} s")

    trainer = Trainer(model, lr=float(margs["lr"]), loss_weights=tuple(margs["loss_weights"]),
                      ema=bool(config["ema"]), warmup_steps=int(config.get("warmup_steps", 500)),
                      lr_scheduler=margs["lr_scheduler"], lr_scheduler_args=margs["lr_scheduler_args"],
                      device=dev)
    print(f"training: EQTransformer {model.in_samples} samples, filters {model.filters[0]}..{model.filters[-1]}, "
          f"{len(model.bi_lstm_stack.members)} BiLSTM blocks, drop_rate {model.drop_rate}; {TRAIN_CONFIG}: batch "
          f"{batch_size}, lr {margs['lr']}, Adam, EMA {config['ema']}, stack_data {config['stack_data']}, "
          f"loss weights {margs['loss_weights']}, norm {cfg.norm}, sigma {cfg.sigma}")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # ---- Trainer.fit: TRAIN_STEPS steps, then one validation pass
    epochs = -(-TRAIN_STEPS // len(train_gen))
    losses, step_counts, step_end = [], [], []
    fit_step, fit_eval = trainer.train_step, trainer.eval_step
    val_batches = [0]

    def recorded_step(batch, lr, generator=None):
        loss = fit_step(batch, lr, generator)
        losses.append(loss)
        step_counts.append(read_counts())
        step_end.append(time.perf_counter())
        if len(step_end) == 1:
            torch.cuda.synchronize()
            step_end[0] = time.perf_counter()
        return loss

    def counted_eval(batch):
        val_batches[0] += 1
        return fit_eval(batch)

    trainer.train_step, trainer.eval_step = recorded_step, counted_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    out_dir = os.path.join(here, "chiprun_out", "train_smoke")
    result = trainer.fit(train_gen, dev_gen, max_epochs=epochs, save_dir=out_dir, experiment="eqtransformer",
                         check_val_every_n_epoch=epochs, hparams=config, tensorboard=False)
    torch.cuda.synchronize()
    t_fit_end = time.perf_counter()
    launches = {"train": {}, "validation": read_counts()}
    trainer.train_step, trainer.eval_step = fit_step, fit_eval
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    loss_values = [float(v) for v in losses]
    n_steps = len(loss_values)
    print(f"training: Trainer.fit {epochs} epochs of {len(train_gen)} steps: {n_steps} steps, losses "
          f"{[round(v, 4) for v in loss_values]}; validation {val_batches[0]} batch(es), val_loss "
          f"{result['history'][-1]['val_loss']:.5f}")
    if n_steps < TRAIN_STEPS or not all(np.isfinite(loss_values)):
        fail(f"training: {n_steps} steps with losses {loss_values}")
    if any(any(c.values()) for c in step_counts):
        fail(f"training: a train step launched a kernel: {[c for c in step_counts if any(c.values())][0]}")
    launches["train"] = step_counts[-1]
    want = dict.fromkeys(launches["validation"], 0)
    want["lstm_multi"] = 4 * val_batches[0]
    if val_batches[0] < 1 or launches["validation"] != want:
        fail(f"training: validation launches {launches['validation']}, want {want} (K2 4 times a forward)")
    if not np.isfinite(result["history"][-1]["val_loss"]):
        fail("training: the validation loss is not finite")
    fit_rate = batch_size * (n_steps - 1) / (t_fit_end - step_end[0])

    # every trained tensor has a gradient (nonzero outside the structural
    # zeros) and moved; the BatchNorm running statistics moved
    zero_by_construction = structural_zero_grads(model)
    gmax = max(float(q.grad.abs().max()) for q in model.parameters())
    noise_max = 0.0
    for name, q in model.named_parameters():
        if q.grad is None or not bool(torch.isfinite(q.grad).all()):
            fail(f"training: {name} has no finite gradient")
        if name in zero_by_construction:
            noise_max = max(noise_max, float(q.grad.abs().max()) / gmax)
            continue
        if not float(q.grad.abs().max()) > 0:
            fail(f"training: {name} has an all-zero gradient: cut from the graph")
        if torch.equal(q.detach(), initial[name]):
            fail(f"training: {name} did not move")
    stats = [k for k in initial if k.endswith(("running_mean", "running_var"))]
    if any(torch.equal(model.state_dict()[k], initial[k]) for k in stats):
        fail("training: a BatchNorm running statistic did not move")
    print(f"training: {sum(1 for _ in model.parameters())} parameter tensors, all with a finite gradient; "
          f"{len(zero_by_construction)} zero by construction (largest {noise_max:.2e} of the largest gradient), "
          f"every other nonzero and moved; {len(stats)} BatchNorm statistics moved")

    # the EMA rule on one more step, against the recorded parameters
    batches = list(train_gen.epoch())
    ema_before = {k: v.clone() for k, v in trainer.ema_params.items()}
    trainer.train_step(batches[0], trainer.lr)
    with torch.no_grad():
        for name, q in model.named_parameters():
            want_e = trainer.ema_decay * ema_before[name] + (1.0 - trainer.ema_decay) * q
            if not torch.equal(trainer.ema_params[name], want_e):
                fail(f"training: EMA of {name} is not decay * ema + (1 - decay) * param")
        for name, b in model.named_buffers():
            if not torch.equal(trainer.ema_params[name], b):
                fail(f"training: EMA buffer {name} is not the model's")
    print(f"training: EMA after one more step = {trainer.ema_decay} ema + {1 - trainer.ema_decay:.3f} params "
          "exactly, buffers copied")

    # ---- time: train steps by CUDA events; the augmentation of a batch alone
    def events_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    zero_counts()
    timed = [events_ms(lambda: trainer.train_step(batches[i % len(batches)], trainer.lr))
             for i in range(TIMED_STEPS)]
    if any(read_counts().values()) or not all(np.isfinite(float(v)) for _, v in timed):
        fail("training: a timed step launched a kernel or gave a non-finite loss")
    step_ms = float(np.median([ms for ms, _ in timed]))
    order = train_gen.rng.permutation(len(train_gen.primary))

    def one_batch():
        raw = train_gen.raw_batches(order, 0, True)
        cfg_w = dataclasses.replace(cfg, pre_windowed=True)
        draws = draw_augment(train_gen.gen, batch_size, 3, cfg_w, dev, stack=True)
        return augment_train_batch(*raw, cfg_w, draws)

    aug_ms = float(np.median([events_ms(one_batch)[0] for _ in range(5)]))
    share = aug_ms / (aug_ms + step_ms)
    rate = batch_size / ((step_ms + aug_ms) / 1e3)
    print(f"training on {card}: train step (forward, backward, Adam, EMA) median {step_ms:.2f} ms by CUDA events "
          f"over {TIMED_STEPS} steps at batch {batch_size}; augmentation of a batch (crops of 5 pools, draws, "
          f"the whole program) median {aug_ms:.2f} ms, {share:.3f} of step + augmentation; {rate:.1f} samples/s "
          f"from the two; Trainer.fit {fit_rate:.1f} samples/s by the host clock over steps 2..{n_steps} "
          f"(validation and checkpoints included); torch.cuda.max_memory_allocated {peak_gib:.2f} GiB")

    # ---- overfit: warmup 0, OVERFIT_STEPS steps on one fixed batch
    fresh = load_model("eqtransformer", seed=1, device=dev)
    over = Trainer(fresh, lr=float(margs["lr"]), loss_weights=tuple(margs["loss_weights"]), warmup_steps=0,
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    over_losses = [float(over.train_step(batches[0], over.lr, gen)) for _ in range(OVERFIT_STEPS)]
    print(f"training: overfit, {OVERFIT_STEPS} steps on one batch, warmup 0: losses "
          f"{[round(v, 4) for v in over_losses]}")
    if not (all(np.isfinite(over_losses)) and over_losses[-1] < over_losses[0]):
        fail(f"training: the overfit steps did not lower the loss: {over_losses}")
    del fresh, over

    # ---- the gradient of one batch on the card against the CPU port, same
    # parameters and windows: float64 on both (float32 sums that nearly
    # cancel differ by up to ~1e-2 of a tensor's largest entry between two
    # summation orders); the float32 difference is printed beside it
    sub = {k: v[:GRAD_WINDOWS] for k, v in batches[0].items()}
    errs = {}
    for dtype in (torch.float64, torch.float32):
        grads = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            m = copy.deepcopy(model).to(where, dtype)
            Trainer(m, device=where).gradients({k: v.to(where, dtype) for k, v in sub.items()})
            grads[key] = {n: q.grad.detach().double().cpu() for n, q in m.named_parameters()}
            del m
        gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
        worst, worst_name = 0.0, ""
        for name, g_cpu in grads["cpu"].items():
            diff = float((grads["card"][name] - g_cpu).abs().max())
            if name in zero_by_construction:
                noise = max(float(g_cpu.abs().max()), float(grads["card"][name].abs().max()))
                if dtype == torch.float64 and noise > 1e-9 * gmax:
                    fail(f"training: the gradient of {name} is not zero up to rounding")
                continue
            rel = diff / float(g_cpu.abs().max())
            if rel > worst:
                worst, worst_name = rel, name
        errs[str(dtype).split(".")[-1]] = (worst, worst_name)
    print(f"training: gradient of {GRAD_WINDOWS} windows, card against the CPU port, same parameters: "
          f"float64 worst {errs['float64'][0]:.2e} of a tensor's largest entry ({errs['float64'][1]}; tol "
          f"{GRAD_TOL}); float32 worst {errs['float32'][0]:.2e} ({errs['float32'][1]}; not held to a tolerance)")
    if not errs["float64"][0] <= GRAD_TOL:
        fail(f"training: card gradient differs from the CPU port's by {errs['float64']}")
    del model, trainer, batches
    torch.cuda.empty_cache()
    return {"steps": n_steps, "batch": batch_size, "losses": loss_values, "val_loss": result["history"][-1]["val_loss"],
            "validation_batches": val_batches[0], "launches": launches, "step_ms": step_ms,
            "augment_ms": aug_ms, "augment_share": share, "samples_per_s": rate, "fit_samples_per_s": fit_rate,
            "max_memory_allocated_gib": peak_gib, "overfit_losses": over_losses,
            "grad_rel_err_f64": errs["float64"][0], "grad_rel_err_f32": errs["float32"][0]}


def eval_phase(dev, card, zero_counts, read_counts, waves, meta) -> dict:
    """Phase 8: the evaluation harness on a full-width EQTransformer with
    seeded weights and stretched heads, on phase 7's synthetic traces read
    through ``data/synthetic.py::synthetic_dataset`` (the card machine has no
    h5py, so no dataset file is written). Fails on any miss of its checks."""
    import copy

    import pandas as pd

    from volpick_tpu_torch.data.synthetic import synthetic_dataset
    from volpick_tpu_torch.device import inference_work
    from volpick_tpu_torch.eval import (
        eval_task0, eval_tasks123, generate_task0, generate_task1, generate_task23, opt_prob_metrics,
        parse_task1, parse_task23)
    from volpick_tpu_torch.eval import task0 as et0
    from volpick_tpu_torch.models import eqtransformer as port_eqt
    from volpick_tpu_torch.models import layers, load_model
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.ops.triggers import trigger_onset_numpy
    from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, "build", "eval_smoke")  # targets and metric CSVs; build/ is not committed
    tdir = os.path.join(out, "targets")
    ds = synthetic_dataset(waves, meta)
    generate_task0(ds, tdir, noise_before_events=True)
    generate_task1(ds, tdir, noise_before_events=True)
    generate_task23(ds, tdir)
    sizes = {t: len(pd.read_csv(os.path.join(tdir, f"{t}.csv"))) for t in ("task0", "task1", "task23")}
    task0 = pd.read_csv(os.path.join(tdir, "task0.csv"))
    evalset = task0[task0["trace_split"].isin(EVAL_SETS)].reset_index(drop=True)
    n_win = len(evalset)
    print(f"evaluation: targets of {len(ds)} traces: task0 {sizes['task0']} windows ({n_win} dev + test), "
          f"task1 {sizes['task1']}, task23 {sizes['task23']}, in {time.perf_counter() - t_phase:.1f} s")

    model = load_model("eqtransformer", seed=0, device=dev)
    runner = et0._SteeredRunner(model, batch_size=EVAL_BATCH, device=dev)
    seeded, borders = runner.prob_curves(ds, evalset.iloc[:EVAL_BATCH])
    t = np.arange(seeded.shape[-1])[None, :]
    stretch_heads(model, [seeded[:, ki][(t >= borders[:, :1]) & (t < borders[:, 1:2])] for ki in range(3)])
    curves, borders = runner.prob_curves(ds, evalset)
    region = (t >= borders[:, :1]) & (t < borders[:, 1:2])
    if curves.shape != (n_win, 3, model.in_samples) or not np.isfinite(curves).all():
        fail(f"evaluation: curves of shape {curves.shape} or not finite")

    # ---- eval_task0 at its default sweep, launches counted; every K2 call
    # of the path recorded, to be held against its twin afterwards
    forwards = [0]
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    k2_calls = []

    def recording(*args, **kw):
        got = cuda_lstm.lstm_branches(*args, **kw)
        k2_calls.append((args, kw, got))
        return got

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    callers = (layers, port_eqt)  # the two modules whose forwards call lstm_branches
    for mod in callers:
        mod.lstm_branches = recording
    try:
        eval_task0(model, ds, tdir, out, prob_thresholds=EVAL_THRESHOLDS, batch_size=EVAL_BATCH, device=dev)
    finally:
        for mod in callers:
            mod.lstm_branches = cuda_lstm.lstm_branches
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = read_counts()
    hook.remove()
    n_batches = sum(-(-int((evalset["trace_split"] == s_).sum()) // EVAL_BATCH) for s_ in EVAL_SETS)
    want = dict.fromkeys(launches, 0)
    want.update(trigger_extract=2 * n_batches, lstm_multi=4 * n_batches)
    print(f"evaluation: eval_task0 on {card}: {n_win} windows x {len(EVAL_THRESHOLDS)} thresholds in "
          f"{eval_s * 1e3:.1f} ms = {n_win / eval_s:.1f} windows/s by the host clock; {forwards[0]} forwards "
          f"({n_batches} batches of up to {EVAL_BATCH}); launches {launches}")
    if forwards[0] != n_batches or launches != want:
        fail(f"evaluation: {forwards[0]} forwards, launches {launches}, want {want} (K1 2 and K2 4 a batch)")
    # K2 at the shapes the path gave it (full and partial batches), on the
    # path's own inputs, against its twin
    k2_err, k2_shapes = 0.0, set()
    with inference_work(dev):
        for args, kw, got in k2_calls:
            k2_err = max(k2_err, float((got - cuda_lstm.lstm_branches_reference(*args, **kw)).abs().max()))
            k2_shapes.add(tuple(args[0].shape))
    print(f"evaluation: the path's {len(k2_calls)} K2 calls at x shapes {sorted(k2_shapes)} against the twin "
          f"on the same inputs: max abs err {k2_err:.3e} (tol {LSTM_TOL})")
    k2_n = len(k2_calls)
    if k2_n != 4 * n_batches or not k2_err <= LSTM_TOL:
        fail(f"evaluation: {k2_n} K2 calls recorded, max abs err {k2_err} against the twin")
    del k2_calls
    columns = list(pd.read_csv(os.path.join(out, "dev_metrics.csv")).columns)
    if columns != GOLDEN_METRICS or list(pd.read_csv(os.path.join(out, "test_metrics.csv")).columns) != columns:
        fail(f"evaluation: metrics columns {columns}")

    # ---- the sweep's pick lists are the per-threshold path's, on the card's curves;
    # the host clock of the sweep alone and of the trace pool it reads first
    t0 = time.perf_counter()
    src = et0.trace_source(ds)
    source_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep = et0.evaluate_sweep(model, ds, evalset, EVAL_THRESHOLDS, batch_size=EVAL_BATCH, device=dev, source=src)
    sweep_s = time.perf_counter() - t0
    print(f"evaluation: host clock on {card}: evaluate_sweep over the {n_win} windows {sweep_s * 1e3:.1f} ms "
          f"given its trace source, building that source {source_s * 1e3:.1f} ms (once an eval_task0 call); "
          f"eval_task0 beyond its sweeps (trace source, ground truth, pick rows, metrics, CSVs) about "
          f"{(eval_s - sweep_s) * 1e3:.1f} ms")
    with_picks = []
    for thr, (p_s, s_s) in zip(EVAL_THRESHOLDS, sweep):
        p_e, s_e = et0.evaluate(model, ds, evalset, thr, batch_size=EVAL_BATCH, curves=(curves, borders),
                                device=dev)
        if any(not np.array_equal(a, b) for a, b in zip(p_s + s_s, p_e + s_e)):
            fail(f"evaluation: at threshold {thr:.1f} the sweep's picks differ from evaluate()'s")
        with_picks.append(sum(1 for a, b in zip(p_s, s_s) if len(a) or len(b)))

    # ---- K1 on the card's curves: its twin and the numpy rule give its picks
    kis = list(et0._phase_channels(model).values())
    thr_t = torch.as_tensor(np.asarray(EVAL_THRESHOLDS, np.float32), device=dev)
    whole_run = []  # windows whose curve stays above thr/2 over the whole region, a threshold
    n_oracle = 0
    for ki in kis:
        rows = torch.as_tensor(curves[:, ki] * region, device=dev).repeat(len(EVAL_THRESHOLDS), 1).contiguous()
        t1 = thr_t.repeat_interleave(n_win)
        got = cuda_trig.trigger_extract(rows, t1, t1 / 2.0, EVAL_K)
        for field, g, w in zip(("peak_idx", "peak_val", "valid", "onset", "offset"), got,
                               cuda_trig.trigger_extract_reference(rows, t1, t1 / 2.0, EVAL_K)):
            if not torch.equal(g, w):
                fail(f"evaluation: K1 {field} on the card's curves differs from its twin")
        lo = slice(0, n_win)  # the lowest threshold's rows also through the twin on the CPU
        for field, g, w in zip(("peak_idx", "peak_val", "valid", "onset", "offset"), got,
                               cuda_trig.trigger_extract_reference(rows[lo].cpu(), t1[lo].cpu(),
                                                                   t1[lo].cpu() / 2.0, EVAL_K)):
            if not torch.equal(g[lo].cpu(), w):
                fail(f"evaluation: K1 {field} on the card's curves differs from the CPU twin")
        idx, valid = got[0].cpu().numpy(), got[2].cpu().numpy()
        host = rows.cpu().numpy()
        t1_np = t1.cpu().numpy()
        for r in range(rows.shape[0]):
            a = np.float32(t1_np[r])
            rule = [on + int(np.argmax(host[r, on : off + 1]))
                    for on, off in trigger_onset_numpy(host[r], a, a / np.float32(2.0))][:EVAL_K]
            if rule != idx[r][valid[r]].tolist():
                fail(f"evaluation: K1 picks of row {r} differ from the numpy trigger rule")
            n_oracle += len(rule)
        above = (rows > (t1 / 2.0)[:, None]).cpu().numpy().reshape(len(EVAL_THRESHOLDS), n_win, -1)
        whole_run.append([int(np.all(above[i] | ~region, axis=1).sum()) for i in range(len(EVAL_THRESHOLDS))])
    print(f"evaluation: on the card's curves K1 equals its twin (card, all {len(EVAL_THRESHOLDS)} thresholds; "
          f"CPU, the lowest) and the numpy trigger rule (ops/triggers.py::trigger_onset_numpy + the argmax in "
          f"each trigger) in {n_oracle} picks; the sweep's pick lists equal evaluate()'s at every threshold; "
          f"windows with a pick by threshold {with_picks}; windows above thr/2 over the whole region, P / S "
          f"{whole_run}")
    informative = [w_ >= EVAL_PICK_SHARE * n_win and min(wp[i] for wp in whole_run) < n_win
                   for i, w_ in enumerate(with_picks)]
    if not any(informative):
        fail("evaluation: no threshold gives picks in a tenth of the windows without one run over every region")

    # ---- the card's curves against the CPU port's, same weights
    cpu_model = copy.deepcopy(model).cpu()
    cpu_curves, _ = et0._SteeredRunner(cpu_model, batch_size=EVAL_CPU_WINDOWS, device="cpu").prob_curves(
        ds, evalset.iloc[:EVAL_CPU_WINDOWS])
    curve_err = float(np.abs(cpu_curves - curves[:EVAL_CPU_WINDOWS]).max())
    print(f"evaluation: {EVAL_CPU_WINDOWS} windows' curves, card against the CPU port: max abs diff "
          f"{curve_err:.3e} (tol {CURVE_TOL})")
    if not curve_err <= CURVE_TOL:
        fail(f"evaluation: card curves differ from the CPU port's by {curve_err}")
    del cpu_model

    # ---- one sweep batch's device work: by CUDA events, and K1's profiler row at (n_thr x 256, 6000)
    batch = evalset.iloc[:EVAL_BATCH]
    frames, b_borders = next(et0._steered_batches(model, src, batch, EVAL_BATCH, dev))
    x_dev = torch.as_tensor(src.take(batch["trace_idx"].to_numpy())["x"]).to(dev)
    w0_dev = torch.as_tensor(batch["start_sample"].to_numpy() - b_borders[:, 0]).to(dev)

    def device_batch():
        return et0._sweep_batch(model, et0.steered_frames(x_dev, w0_dev, model.in_samples, norm=model.norm),
                                b_borders, kis, thr_t, EVAL_K)

    with inference_work(dev):
        batch_ms = cuda_ms(device_batch, iters=10)
        _, batch_kernel_ms, events = profiled(lambda: [device_batch() for _ in range(5)])
    k1_rows = [e for e in events if "trigger_extract_kernel" in e.key]
    k1_n = sum(e.count for e in k1_rows)
    k1_ms = sum(self_device_us(e) for e in k1_rows) / 1e3 / max(k1_n, 1)
    n_rows = len(EVAL_THRESHOLDS) * EVAL_BATCH
    k1_bound = bound(n_rows * model.in_samples * 4 + 2 * n_rows * 4 + n_rows * EVAL_K * 17,
                     flops=8 * n_rows * model.in_samples)
    batch_kernel_ms /= 5
    sweep_rows = torch.as_tensor(curves[:EVAL_BATCH, kis[0]] * region[:EVAL_BATCH], device=dev).repeat(
        len(EVAL_THRESHOLDS), 1).contiguous()
    sweep_t1 = thr_t.repeat_interleave(EVAL_BATCH)
    k1_plain_ms = cuda_ms(lambda: cuda_trig.trigger_extract_reference(sweep_rows, sweep_t1, sweep_t1 / 2.0, EVAL_K),
                          iters=3)
    if not k1_ms > 0:
        fail("evaluation: the profiler saw no trigger_extract_kernel in a sweep batch")
    print(f"evaluation on {card}: one sweep batch of {EVAL_BATCH} windows on the card (framing, forward, "
          f"region mask, K1 on ({n_rows}, {model.in_samples}) rows a phase) {batch_ms:.3f} ms by CUDA events = "
          f"{EVAL_BATCH / batch_ms * 1e3:.1f} windows/s of device work, {batch_kernel_ms:.3f} ms of summed "
          f"kernel time under torch.profiler; K1 at ({n_rows}, {model.in_samples}), K={EVAL_K}: "
          f"{k1_ms:.4f} ms a launch by its profiler row ({k1_n / 5:.0f} launches a batch), bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}; the kernel {k1_ms / k1_bound[0]:.1f}x), twin "
          f"{k1_plain_ms:.4f} ms by CUDA events on the first batch's P rows")

    # ---- true-negative rate, task 1/2/3 scoring and parsing
    tnr = et0.eval_task0_true_negative_rate(model, ds, tdir, out, prob_thresholds=EVAL_THRESHOLDS,
                                            batch_size=EVAL_BATCH, device=dev)
    eval_tasks123(model, ds, tdir, out, batch_size=EVAL_BATCH, device=dev)
    stats = dict(opt_prob_metrics(out), **parse_task1(out), **parse_task23(out))
    for key in ("p_threshold", "test_p_F1score", "dev_det_auc", "test_det_f1", "dev_phase_mcc", "test_P_mae_s"):
        if key not in stats or not np.isfinite(float(stats[key])):
            fail(f"evaluation: {key} missing or not finite: {stats.get(key)}")
    t23 = pd.read_csv(os.path.join(out, "test_task23.csv"))
    if list(t23.columns[-4:]) != ["score_detection", "score_p_or_s", "p_sample_pred", "s_sample_pred"]:
        fail(f"evaluation: task23 columns {list(t23.columns)}")
    summary = {k: float(stats[k]) for k in ("p_threshold", "s_threshold", "test_p_F1score", "test_s_F1score",
                                           "dev_det_auc", "test_det_f1", "dev_phase_mcc", "test_P_mae_s")
               if k in stats}
    tn_rate = [round(float(v), 4) for v in tnr["test"]["p_true_negative_rate"]]
    phase_s = time.perf_counter() - t_phase
    print(f"evaluation: true-negative rate (test, P) by threshold {tn_rate}; opt_prob_metrics + parse_task1 + "
          f"parse_task23: {summary}; the phase took {phase_s:.1f} s")
    del model, runner
    torch.cuda.empty_cache()
    return {"windows": n_win, "batches": n_batches, "launches": launches, "eval_task0_s": eval_s,
            "windows_per_s_host": n_win / eval_s, "sweep_s": sweep_s, "source_s": source_s, "batch_ms": batch_ms,
            "windows_per_s_device": EVAL_BATCH / batch_ms * 1e3, "batch_kernel_ms": batch_kernel_ms,
            "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_launches_a_batch": k1_n / 5, "k1_bound": k1_bound, "k1_rows": n_rows,
            "k2_err": k2_err, "k2_calls": k2_n, "k2_shapes": sorted(k2_shapes), "oracle_picks": n_oracle, "windows_with_picks": with_picks, "curve_err_cpu": curve_err,
            "metrics": summary, "seconds": phase_s}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from volpick_tpu_torch.data.synthetic import synthetic_arrays
    from volpick_tpu_torch.models import eqtransformer as port_eqt
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import _build
    from volpick_tpu_torch.ops.cuda import addattn as cuda_addattn
    from volpick_tpu_torch.ops.cuda import attention as cuda_attn
    from volpick_tpu_torch.ops.cuda import conditioning as cuda_cond
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import rescnn as cuda_rescnn
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.ops.signal import condition_windows_from_span
    from volpick_tpu_torch.ops.triggers import extract_triggers_batched, trigger_onset_numpy
    from volpick_tpu_torch.ops.windows import window_starts
    from volpick_tpu_torch.picker import UTC, Stream, StreamingPicker, Trace, WaveformPicker
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
    scan_piece, scan_pieces = cuda_trig.scan_plan(TRIG_ROWS, TRIG_W)
    curves_np, n_fixed = trigger_curves(rng, cuda_trig.SCAN_STEP, scan_piece)
    prob = torch.as_tensor(curves_np, device=dev)
    t1 = torch.full((TRIG_ROWS,), 0.5, device=dev)
    t1[n_fixed:] = torch.as_tensor(
        rng.uniform(0.3, 0.8, TRIG_ROWS - n_fixed).astype(np.float32), device=dev)
    t2 = t1 / 2.0
    def extract_equal(p, a, b_, k, what):
        got_e = cuda_trig.trigger_extract(p, a, b_, k)
        want_e = cuda_trig.trigger_extract_reference(p, a, b_, k)
        torch.cuda.synchronize()
        err = 0.0
        for field, g, w in zip(("peak_idx", "peak_val", "valid", "onset", "offset"), got_e, want_e):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                fail(f"trigger_extract {what} {field} differs from its twin")
            err = max(err, float((g.double() - w.double()).abs().max()))
        return got_e, err

    def extract_times(p, a, b_, k):
        """(ms by CUDA events, summed ms of its kernels' profiler rows a call, launches a call)"""
        ev = cuda_ms(lambda: cuda_trig.trigger_extract(p, a, b_, k))
        _, _, events = profiled(lambda: [cuda_trig.trigger_extract(p, a, b_, k) for _ in range(10)])
        rows_ = [e for e in events if "trigger_extract_kernel" in e.key]
        return ev, sum(self_device_us(e) for e in rows_) / 1e4, sum(e.count for e in rows_) / 10

    got, trig_err = extract_equal(prob, t1, t2, TRIG_K, f"({TRIG_ROWS}, {TRIG_W})")
    n_valid = got[2].sum(dim=1).tolist()
    # the rows built around K1's count: pending resolved true and false, the
    # cut at K between two pieces, exactly K picks
    if n_valid[n_fixed - 4 : n_fixed] != [2, 1, TRIG_K, TRIG_K] or int(
            got[4][n_fixed - 2, -1]) != 2 * scan_piece - 2:
        fail(f"trigger_extract: the constructed rows give {n_valid[n_fixed - 4 : n_fixed]} picks")
    print(f"K1 trigger_extract ({TRIG_ROWS}, {TRIG_W}) K={TRIG_K}, {scan_pieces} pieces of "
          f"{scan_piece} a row: equal to twin in all five outputs; picks per row {n_valid}")
    trig_event_ms, trig_ms, trig_n = extract_times(prob, t1, t2, TRIG_K)
    trig_plain_ms = cuda_ms(lambda: cuda_trig.trigger_extract_reference(prob, t1, t2, TRIG_K), iters=5)
    # a handful of compares and selects a sample
    trig_bound = bound(nbytes(prob, t1, t2, *got), flops=8 * prob.numel())
    print(f"K1 time on {card}: {trig_ms:.4f} ms of summed kernel time under torch.profiler "
          f"({trig_n:.0f} launch a call: "
          f"{'one cooperative launch' if trig_n == 1 else 'summaries, then emission'}), "
          f"{trig_event_ms:.4f} ms by CUDA events (the host's pace), twin {trig_plain_ms:.4f} ms, "
          f"bound {trig_bound[0]:.4f} ms ({trig_bound[1]}; the kernel {trig_ms / trig_bound[0]:.1f}x), "
          f"no library call computes it")

    # K3: the same curves, the scanned state at every position; then many
    # short rows, one piece each
    def scan_equal(p, a, b_, what):
        got_s = cuda_trig.trigger_scan(p, a, b_)
        want_s = cuda_trig.trigger_scan_reference(p, a, b_)
        torch.cuda.synchronize()
        err = 0.0
        for field, g, w in zip(("onset", "max", "argmax"), got_s, want_s):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                fail(f"trigger_scan {what} {field} differs from its twin")
            err = max(err, float((g.double() - w.double()).abs().max()))
        return got_s, err

    def scan_times(p, a, b_):
        """(ms by CUDA events, summed ms of its kernels' profiler rows a call, launches a call)"""
        ev = cuda_ms(lambda: cuda_trig.trigger_scan(p, a, b_))
        _, _, events = profiled(lambda: [cuda_trig.trigger_scan(p, a, b_) for _ in range(10)])
        rows_ = [e for e in events if "trigger_scan_kernel" in e.key]
        return ev, sum(self_device_us(e) for e in rows_) / 1e4, sum(e.count for e in rows_) / 10

    scan_got, scan_err = scan_equal(prob, t1, t2, f"({TRIG_ROWS}, {TRIG_W})")
    for method in ("pallas", "shift", "blocked"):
        for g, w in zip(extract_triggers_batched(prob, t1, t2, TRIG_K, method=method), got):
            if not torch.equal(g, w):
                fail(f'method="{method}" picks differ from "pallas_full"')
    scan_ms, scan_kernel_ms, scan_n = scan_times(prob, t1, t2)
    scan_plain_ms = cuda_ms(lambda: cuda_trig.trigger_scan_reference(prob, t1, t2), iters=5)
    # what follows the kernel under method="pallas": the emission in plain PyTorch
    emit_ms = cuda_ms(lambda: cuda_trig.emit_picks(prob, t2, scan_got, TRIG_K))
    scan_bound = bound(nbytes(prob, t1, t2, *scan_got), flops=8 * prob.numel())
    if scan_pieces * TRIG_ROWS <= 8 * TRIG_ROWS or scan_n != 2:
        fail(f"trigger_scan ({TRIG_ROWS}, {TRIG_W}): {scan_pieces} pieces a row, {scan_n} launches a call")
    print(f"K3 trigger_scan ({TRIG_ROWS}, {TRIG_W}), {scan_pieces} pieces of {scan_piece} a row = "
          f"{scan_pieces * TRIG_ROWS} warps in {-(-scan_pieces * TRIG_ROWS // 8)} CTAs, {scan_n:.0f} "
          f"launches a call: equal to twin in all three "
          f'outputs; methods "pallas", "shift" and "blocked" give the picks of "pallas_full"; time '
          f"on {card}: {scan_ms:.4f} ms by CUDA events, {scan_kernel_ms:.4f} ms of summed kernel "
          f"time under torch.profiler, twin {scan_plain_ms:.4f} ms, bound {scan_bound[0]:.4f} ms "
          f"({scan_bound[1]}), no library call computes it; the PyTorch emission after it "
          f"(emit_picks, K={TRIG_K}) {emit_ms:.4f} ms by CUDA events")
    short = torch.as_tensor(rng.random((1, SHORT_ROWS, SHORT_W), dtype=np.float32), device=dev)
    short = F.avg_pool1d(short, 25, stride=1, padding=12)[0]
    short = (short - short.amin(1, keepdim=True)) / (short.amax(1, keepdim=True) - short.amin(1, keepdim=True))
    short[7] = 0.95  # a row that is all one run
    short[8] = 0.0
    short = short.contiguous()
    st1 = torch.as_tensor(rng.uniform(0.3, 0.8, SHORT_ROWS).astype(np.float32), device=dev)
    st2 = st1 / 2.0
    short_got, _ = scan_equal(short, st1, st2, f"({SHORT_ROWS}, {SHORT_W})")
    short_ms, short_kernel_ms, short_n = scan_times(short, st1, st2)
    short_plain_ms = cuda_ms(lambda: cuda_trig.trigger_scan_reference(short, st1, st2), iters=3)
    short_bound = bound(nbytes(short, st1, st2, *short_got), flops=8 * short.numel())
    print(f"K3 trigger_scan ({SHORT_ROWS}, {SHORT_W}), {cuda_trig.scan_plan(SHORT_ROWS, SHORT_W)[1]} "
          f"piece a row, {short_n:.0f} launch a call: equal to twin in all three outputs; time on "
          f"{card}: {short_ms:.4f} ms by CUDA events, {short_kernel_ms:.4f} ms of kernel time under "
          f"torch.profiler, twin {short_plain_ms:.4f} ms, bound {short_bound[0]:.4f} ms "
          f"({short_bound[1]})")
    _, short_trig_err = extract_equal(short, st1, st2, SHORT_K, f"({SHORT_ROWS}, {SHORT_W})")
    short_trig_event_ms, short_trig_ms, short_trig_n = extract_times(short, st1, st2, SHORT_K)
    short_trig_plain_ms = cuda_ms(
        lambda: cuda_trig.trigger_extract_reference(short, st1, st2, SHORT_K), iters=3)
    short_trig_bound = bound(nbytes(short, st1, st2) + SHORT_ROWS * SHORT_K * 17, flops=8 * short.numel())
    print(f"K1 trigger_extract ({SHORT_ROWS}, {SHORT_W}) K={SHORT_K}, one piece a row, "
          f"{short_trig_n:.0f} launch a call: equal to twin in all five outputs; time on {card}: "
          f"{short_trig_ms:.4f} ms of kernel time under torch.profiler, {short_trig_event_ms:.4f} ms by "
          f"CUDA events, twin {short_trig_plain_ms:.4f} ms, bound {short_trig_bound[0]:.4f} ms "
          f"({short_trig_bound[1]})")
    trig_err = max(trig_err, short_trig_err)
    del short, short_got

    # K4: rows with an offset and a trend far larger than the signal
    xc = torch.as_tensor(conditioning_rows(rng, COND_N, COND_C, COND_W), device=dev)
    cond_err, cond_ms, cond_event_ms, cond_plain_ms = 0.0, {}, {}, {}
    for detrend in (True, False):
        for norm in ("peak", "std"):
            kw_c = dict(detrend=detrend, norm=norm)
            err = float((cuda_cond.condition_windows(xc, **kw_c)
                         - cuda_cond.condition_windows_reference(xc, **kw_c)).abs().max())
            if not err <= COND_TOL:
                fail(f"condition_windows {kw_c} max abs err {err} > {COND_TOL}")
            cond_err = max(cond_err, err)
            cond_event_ms[detrend, norm] = cuda_ms(lambda: cuda_cond.condition_windows(xc, **kw_c))
            _, _, events = profiled(
                lambda: [cuda_cond.condition_windows(xc, **kw_c) for _ in range(10)])
            cond_ms[detrend, norm] = sum(
                self_device_us(e) for e in events if "condition_kernel" in e.key) / 1e4
            cond_plain_ms[detrend, norm] = cuda_ms(
                lambda: cuda_cond.condition_windows_reference(xc, **kw_c), iters=10)
            print(f"K4 condition_windows ({COND_N}, {COND_C}, {COND_W}) detrend={detrend} "
                  f"norm={norm}: max abs err {err:.3e} (tol {COND_TOL}); kernel "
                  f"{cond_ms[detrend, norm]:.4f} ms (its row under torch.profiler), "
                  f"{cond_event_ms[detrend, norm]:.4f} ms by CUDA events, twin "
                  f"{cond_plain_ms[detrend, norm]:.4f} ms")
    cond_bound = bound(2 * nbytes(xc), flops=10 * xc.numel())
    cond_ctas, cond_bufs = cuda_cond.ring_plan(
        COND_N * COND_C, COND_W, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K4 time on {card} (detrend, peak: EQTransformer's; {cond_ctas} persistent CTAs, "
          f"{cond_bufs} row buffers each): kernel {cond_ms[True, 'peak']:.4f} ms (its row under "
          f"torch.profiler), {cond_event_ms[True, 'peak']:.4f} ms by CUDA events (the host's pace), "
          f"twin {cond_plain_ms[True, 'peak']:.4f} ms, bound {cond_bound[0]:.4f} ms "
          f"({cond_bound[1]}; the kernel {cond_ms[True, 'peak'] / cond_bound[0]:.2f}x), no library "
          f"call computes it")

    lstm_err, lstm_ms, lstm_bound, lstm_lib_ms = 0.0, {}, {}, {}
    rev = (False, True)
    for c in (64, 16):  # one forward: BiLSTM 1 at C=64; BiLSTM 2-3 and the pick LSTMs at C=16
        xs = torch.as_tensor(rng.normal(size=(LSTM_G, LSTM_B, c, LSTM_T)).astype(np.float32), device=dev)
        w_ih = torch.as_tensor((rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, c))).astype(np.float32), device=dev)
        w_hh = torch.as_tensor((rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, LSTM_H))).astype(np.float32), device=dev)
        bias = torch.as_tensor((rng.normal(size=(LSTM_G, 4 * LSTM_H)) * 0.1).astype(np.float32), device=dev)
        err = float((cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias)
                     - cuda_lstm.lstm_multi_reference(xs, w_ih, w_hh, bias)).abs().max())
        if not err <= LSTM_TOL:
            fail(f"lstm_multi C={c} max abs err {err} > {LSTM_TOL}")
        m_ms = cuda_ms(lambda: cuda_lstm.lstm_multi(xs, w_ih, w_hh, bias))
        mp_ms = cuda_ms(lambda: cuda_lstm.lstm_multi_reference(xs, w_ih, w_hh, bias), iters=5)
        print(f"K2 lstm_multi G={LSTM_G} B={LSTM_B} C={c} H={LSTM_H} T={LSTM_T}: max abs err "
              f"{err:.3e} (tol {LSTM_TOL}); time on {card}: whole call {m_ms:.4f} ms, twin {mp_ms:.4f} ms")
        # the form the models call: both directions over one x, the second
        # scanning time backward, states written as (B, G*H, T)
        x = xs[0].contiguous()
        got_b = cuda_lstm.lstm_branches(x, w_ih, w_hh, bias, rev)
        err_b = float((got_b - cuda_lstm.lstm_branches_reference(x, w_ih, w_hh, bias, rev)).abs().max())
        hs = cuda_lstm.lstm_multi(torch.stack([x, x.flip(-1)]), w_ih, w_hh, bias)
        err_old = float((got_b - torch.cat([hs[0], hs[1].flip(-1)], dim=1)).abs().max())
        if not max(err_b, err_old) <= LSTM_TOL:
            fail(f"lstm_branches C={c} max abs err {err_b} vs twin, {err_old} vs the stacked and "
                 f"flipped lstm_multi > {LSTM_TOL}")
        k_ms = cuda_ms(lambda: cuda_lstm.lstm_branches(x, w_ih, w_hh, bias, rev))
        p_ms = cuda_ms(lambda: cuda_lstm.lstm_branches_reference(x, w_ih, w_hh, bias, rev), iters=5)
        xp = cuda_lstm.project_shared(x, w_ih)
        out_b = torch.empty_like(got_b)
        gh4 = LSTM_G * 4 * LSTM_H
        cuda_lstm.recurrence(xp, (4 * LSTM_H, LSTM_T * gh4, gh4), w_hh, bias, out_b,
                             (LSTM_H * LSTM_T, LSTM_G * LSTM_H * LSTM_T), LSTM_B, LSTM_T, 0b10)
        if not torch.equal(out_b, got_b):
            fail(f"lstm recurrence C={c}: the kernel alone differs from the whole call")
        # the whole call is a handful of small launches and the kernel is
        # shorter than a launch from Python, so CUDA events around either read
        # the host's pace; the profiler gives the device's times
        _, call_dev_ms, events = profiled(
            lambda: [cuda_lstm.lstm_branches(x, w_ih, w_hh, bias, rev) for _ in range(10)])
        call_dev_ms /= 10
        rec_ms = sum(self_device_us(e) for e in events if "lstm_multi_kernel" in e.key) / 1e4
        print(f"K2 lstm_branches B={LSTM_B} C={c} H={LSTM_H} T={LSTM_T} reverse={rev}: max abs err "
              f"{err_b:.3e} vs twin, {err_old:.3e} vs stacked + flipped lstm_multi (tol {LSTM_TOL}); "
              f"time on {card}: whole call {k_ms:.4f} ms by CUDA events (the host's pace), "
              f"{call_dev_ms:.4f} ms of summed kernel time under torch.profiler, of it the "
              f"recurrence kernel alone {rec_ms:.4f} ms; twin {p_ms:.4f} ms")
        lstm_err = max(lstm_err, err, err_b, err_old)
        lstm_ms[c] = (k_ms, p_ms, rec_ms, m_ms, call_dev_ms)
        n_cell = LSTM_G * LSTM_B * LSTM_T * LSTM_H
        lstm_bound[c] = bound(
            nbytes(xs, w_ih, w_hh, bias) + n_cell * 4,
            flops=2 * n_cell * 4 * (c + LSTM_H) + 10 * n_cell, sfu=5 * n_cell)
        # the yardstick: the merged pair is a forward and a time-reversed
        # recurrence, which is what one bidirectional nn.LSTM computes
        lib = torch.nn.LSTM(c, LSTM_H, bidirectional=True).to(dev).eval()
        seq = xs[0].permute(2, 0, 1).contiguous()  # (T, B, C)
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: lib(seq))
            lib_dev_ms = profiled(lambda: [lib(seq) for _ in range(10)])[1] / 10
        lstm_lib_ms[c] = (lib_ms, lib_dev_ms)
        print(f"K2 C={c}: bound {lstm_bound[c][0]:.4f} ms ({lstm_bound[c][1]}); "
              f"torch.nn.LSTM(bidirectional=True) on (T {LSTM_T}, B {LSTM_B}, C {c}) "
              f"{lib_ms:.4f} ms by CUDA events, {lib_dev_ms:.4f} ms of summed kernel time")

    # q scaled as TPUPickNet scales it (1/sqrt(Dh)), so the scores have the
    # model's spread
    q0, k, v = (torch.as_tensor(rng.normal(size=(MHA_B, MHA_D, MHA_T)).astype(np.float32), device=dev)
                for _ in range(3))
    mha_scale = (MHA_H / MHA_D) ** 0.5
    q = q0 * mha_scale
    mha_out = cuda_attn.mha(q, k, v, MHA_H)
    mha_twin = cuda_attn.mha_reference(q, k, v, MHA_H)
    mha_f64 = cuda_attn.mha_reference(q.double(), k.double(), v.double(), MHA_H)
    torch.cuda.synchronize()
    mha_err = float((mha_out - mha_twin).abs().max())
    if not mha_err <= MHA_TOL:
        fail(f"mha max abs err {mha_err} > {MHA_TOL}")
    mha_hm_ms = cuda_ms(lambda: cuda_attn.mha(q, k, v, MHA_H), iters=50)
    mha_hm_plain_ms = cuda_ms(lambda: cuda_attn.mha_reference(q, k, v, MHA_H), iters=50)
    print(f"K7 mha ({MHA_B}, {MHA_D}, {MHA_T}) H={MHA_H}: max abs err {mha_err:.3e} vs twin (tol "
          f"{MHA_TOL}); vs float64: kernel {float((mha_out - mha_f64).abs().max()):.3e}, twin "
          f"{float((mha_twin - mha_f64).abs().max()):.3e}; time on {card}: kernel {mha_hm_ms:.4f} ms, "
          f"twin {mha_hm_plain_ms:.4f} ms")
    # the entry the model calls: the same q, k, v read in place from a
    # (B, T, 3, H, Dh) projection, the scale applied inside the kernel
    qkv = torch.stack([a.reshape(MHA_B, MHA_H, MHA_D // MHA_H, MHA_T).permute(0, 3, 1, 2)
                       for a in (q0, k, v)], dim=2).contiguous()
    qkv_out = cuda_attn.mha_qkv(qkv, mha_scale)
    qkv_err = float((qkv_out - cuda_attn.mha_qkv_reference(qkv, mha_scale)).abs().max())
    qkv_vs_hm = float((qkv_out - mha_out.transpose(1, 2)).abs().max())
    qkv_f64 = float((qkv_out - mha_f64.transpose(1, 2)).abs().max())
    if not max(qkv_err, qkv_vs_hm) <= MHA_TOL:
        fail(f"mha_qkv max abs err {qkv_err} vs twin, {qkv_vs_hm} vs the head-major entry > {MHA_TOL}")
    mha_ms = cuda_ms(lambda: cuda_attn.mha_qkv(qkv, mha_scale), iters=50)
    mha_plain_ms = cuda_ms(lambda: cuda_attn.mha_qkv_reference(qkv, mha_scale), iters=50)
    print(f"K7 mha_qkv ({MHA_B}, {MHA_T}, 3, {MHA_H}, {MHA_D // MHA_H}) in place: max abs err "
          f"{qkv_err:.3e} vs twin, {qkv_vs_hm:.3e} vs the head-major entry (tol {MHA_TOL}), "
          f"{qkv_f64:.3e} vs float64; time on {card}: kernel {mha_ms:.4f} ms, twin {mha_plain_ms:.4f} ms")
    mha_err = max(mha_err, qkv_err, qkv_vs_hm)

    n_score = MHA_B * MHA_H * MHA_T * MHA_T
    mha_bound = bound(nbytes(qkv, qkv_out), flops=(4 * MHA_D // MHA_H + 4) * n_score,
                      sfu=n_score)
    # the yardstick on the same projection: (B, H, T, Dh) views of it, no copy
    # before the clock; and on operands laid out contiguously beforehand
    qv, kv, vv = (a.transpose(1, 2) for a in qkv.unbind(2))
    mha_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=mha_scale), iters=50)
    sdpa = F.scaled_dot_product_attention(qv, kv, vv, scale=mha_scale).transpose(1, 2).reshape(qkv_out.shape)
    qs, ks, vs = (a.contiguous() for a in (qv, kv, vv))
    mha_lib_packed_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=mha_scale), iters=50)
    print(f"K7: bound {mha_bound[0]:.4f} ms ({mha_bound[1]}); F.scaled_dot_product_attention on "
          f"views of the projection {mha_lib_ms:.4f} ms (max abs diff to the kernel "
          f"{float((sdpa - qkv_out).abs().max()):.3e}), on contiguous (B, H, T, Dh) operands "
          f"{mha_lib_packed_ms:.4f} ms; time on {card}")

    # K5: q and k at the scale of the model's projections, then saturating
    # tanh; both entries. addattn_x gets weights that give its q and k that scale
    xa = torch.as_tensor(rng.normal(size=(ATT_B, ATT_C, ATT_T)).astype(np.float32), device=dev)
    wa = torch.as_tensor(rng.uniform(-0.3, 0.3, ATT_U).astype(np.float32), device=dev)
    xat = xa.transpose(1, 2)
    att_err = att_f64 = 0.0
    att = {}
    for scale in (0.5, 20.0):
        qa, ka = (torch.as_tensor((rng.normal(size=(ATT_B, ATT_T, ATT_U)) * scale).astype(np.float32),
                                  device=dev) for _ in range(2))
        wt, wx = (torch.as_tensor((rng.normal(size=(ATT_C, ATT_U)) * scale / ATT_C ** 0.5)
                                  .astype(np.float32), device=dev) for _ in range(2))
        bh = torch.as_tensor((rng.normal(size=ATT_U) * 0.1 * scale).astype(np.float32), device=dev)
        calls = {  # entry -> (kernel call, twin call, float64 evaluation)
            "addattn": (lambda: cuda_addattn.addattn(xa, qa, ka, wa),
                        lambda: cuda_addattn.addattn_reference(xa, qa, ka, wa),
                        cuda_addattn.addattn_reference(xa.double(), qa.double(), ka.double(), wa.double())),
            "addattn_x": (lambda: cuda_addattn.addattn_x(xa, wt, bh, wx, wa),
                          lambda: cuda_addattn.addattn_x_reference(xa, wt, bh, wx, wa),
                          cuda_addattn.addattn_x_reference(xa.double(), wt.double(), bh.double(),
                                                           wx.double(), wa.double())),
        }
        for entry_name, (call, twin_call, f64) in calls.items():
            got_a, twin = call(), twin_call()
            torch.cuda.synchronize()
            err = float((got_a - twin).abs().max())
            k64, t64 = float((got_a - f64).abs().max()), float((twin - f64).abs().max())
            print(f"K5 {entry_name} x ({ATT_B}, {ATT_C}, {ATT_T}), U {ATT_U}, at scale {scale}: max abs "
                  f"err {err:.3e} vs twin (tol {ATT_TOL}); vs float64: kernel {k64:.3e}, twin {t64:.3e}")
            if not (max(err, k64) <= ATT_TOL and bool(torch.isfinite(got_a).all())):
                fail(f"{entry_name} at scale {scale}: max abs err {err} vs twin, {k64} vs float64 "
                     f"> {ATT_TOL}, or not finite")
            att_err, att_f64 = max(att_err, err), max(att_f64, k64)
            if scale == 0.5:
                _, _, events = profiled(lambda: [call() for _ in range(10)])
                att[entry_name] = (
                    sum(self_device_us(e) for e in events if "addattn_kernel" in e.key) / 1e4,
                    cuda_ms(call), cuda_ms(twin_call))
        # the entry that projects inside against the other one fed PyTorch's projections
        err = float((cuda_addattn.addattn_x(xa, wt, bh, wx, wa) - cuda_addattn.addattn(
            xa, (xat @ wt + bh).contiguous(), (xat @ wx).contiguous(), wa)).abs().max())
        print(f"K5 addattn_x vs addattn fed PyTorch's projections at scale {scale}: max abs diff "
              f"{err:.3e} (tol {ATT_TOL})")
        if not err <= ATT_TOL:
            fail(f"addattn_x differs from addattn on PyTorch's projections by {err} at scale {scale}")
        att_err = max(att_err, err)
    n_pair = ATT_B * ATT_T * ATT_T
    att_ops = dict(flops=n_pair * (3 * ATT_U + 2 * ATT_C + 4), sfu=n_pair * (ATT_U + 1))
    att_bound_xqk = bound(nbytes(xa, qa, ka, wa, xa), **att_ops)
    att_bound = bound(nbytes(xa, wt, bh, wx, wa, xa),
                      flops=att_ops["flops"] + 4 * ATT_B * ATT_T * ATT_C * ATT_U, sfu=att_ops["sfu"])
    for entry_name, bnd in (("addattn_x", att_bound), ("addattn", att_bound_xqk)):
        k_ms, e_ms, p_ms = att[entry_name]
        print(f"K5 {entry_name} time on {card}: kernel {k_ms:.4f} ms (its row under torch.profiler), "
              f"{e_ms:.4f} ms by CUDA events (the host's pace), twin {p_ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}; one special-function operation a tanh; this kernel's "
              f"tanh takes two: {2 * att_ops['sfu'] / PEAK_SFU * 1e3:.4f} ms), no library call "
              "computes it")

    # ---- 4-6. every picker at full width on the bench stream
    data = bench_stream_array(seed=0)
    t_start = UTC("2024-06-01T00:00:00")
    stream = Stream([
        Trace(data[s, ci], dict(network="XV", station=f"S{s:02d}", channel=f"HH{comp}",
                                sampling_rate=SR, starttime=t_start))
        for s in range(STATIONS) for ci, comp in enumerate("ZNE")
    ])
    cut = np.ascontiguousarray(data[:1, :, : int(5 * 60 * SR)])
    # kernel name -> (module, its launch counter)
    counters = {
        "trigger_extract": (cuda_trig, "launches"), "lstm_multi": (cuda_lstm, "launches"),
        "trigger_scan": (cuda_trig, "scan_launches"), "conditioning": (cuda_cond, "launches"),
        "addattn": (cuda_addattn, "launches"), "rescnn": (cuda_rescnn, "launches"),
        "mha": (cuda_attn, "launches"),
    }

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {kn: getattr(mod, attr) for kn, (mod, attr) in counters.items()}

    by_path, rates, thresholds_of, device_of, curves_of, optin_kernel_ms = {}, {}, {}, {}, {}, {}
    optin_launches = {}  # attention route -> (aten:: calls, kernel launches) of one classify_arrays
    ops_of = {}
    for label, arch, margs, pkw, env, overlap, blinding, batch in PATHS:
        saved_env = {k_: os.environ.get(k_) for k_ in env}
        os.environ.update(env)
        model = load_model(arch, seed=0, device=dev, **margs)
        picker = WaveformPicker(model, device=dev, **pkw)
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
        curves_of[label] = curves
        zero_counts()
        out = picker.classify(stream, P_threshold=thr["P"], S_threshold=thr["S"],
                              detection_threshold=det, **kw)
        torch.cuda.synchronize()
        launches = read_counts()
        hook.remove()
        n_fwd = forwards[0]
        by_path[label] = launches
        print(f"{label}: classify {len(out.picks)} picks, {len(out.detections)} detections, "
              f"{n_fwd} forwards; launches {launches}; thresholds {thr}")
        # one classify_arrays a classify (the stations have one length); one
        # conditioning launch a forward (a step, or the flush window)
        optin = label == OPTIN
        want = {
            "trigger_extract": 0 if optin else 1,
            "trigger_scan": 1 if optin else 0,
            "conditioning": n_fwd if optin else 0,
            "addattn": 2 * n_fwd if optin else 0,
            "lstm_multi": 4 * n_fwd if arch.endswith("eqtransformer") else 0,
            "mha": model.n_layers * n_fwd if margs.get("attn") == "pallas" else 0,
            "rescnn": 0,
        }
        if n_fwd < 1 or launches != want:
            fail(f"{label}: launches {launches}, want {want}")
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
        own = {kn: sum(self_device_us(e) for e in events if kn in e.key) / 1e3
               for kn in ("mha_kernel", "addattn_kernel", "condition_kernel", "trigger_scan_kernel",
                          "trigger_extract_kernel", "lstm_multi_kernel")}
        device_of[label] = dev_ms
        print(f"{label}: one classify_arrays under torch.profiler: summed kernel time "
              f"{dev_ms:.2f} ms (of it "
              + ", ".join(f"{kn} {ms:.3f} ms" for kn, ms in own.items() if ms > 0)
              + f"); idle share against the median {max(0.0, 1 - dev_ms / (med * 1e3)):.3f}")
        ops_of[label] = {op: (sum(e.count for e in events if e.key == f"aten::{op}"),
                              sum(self_device_us(e) for e in events if e.key == f"aten::{op}") / 1e3)
                         for op in ("copy_", "mul")}
        print(f"{label}: in that call " + ", ".join(
            f"aten::{op} x {n} ({ms:.3f} ms)" for op, (n, ms) in ops_of[label].items()))
        if optin:
            optin_kernel_ms = own
            for kn in ("addattn_kernel", "condition_kernel", "trigger_scan_kernel"):
                if not own[kn] > 0:
                    fail(f"{label}: the profiler saw no {kn}")
            # the same call with the attention block in its earlier composition:
            # projections by PyTorch, then the entry that takes q and k
            def composed(x_, p_, eps=1e-5):
                xt_ = x_.transpose(1, 2)
                return cuda_addattn.addattn(
                    x_.contiguous(), (xt_ @ p_["Wt"] + p_["bh"]).contiguous(),
                    (xt_ @ p_["Wx"]).contiguous(), p_["Wa"].reshape(-1).contiguous(), eps)

            in_place = port_eqt.seq_self_attention_kernel
            port_eqt.seq_self_attention_kernel = composed
            _, composed_ms, composed_events = profiled(
                lambda: picker.classify_arrays(data, thresholds, **kw))
            port_eqt.seq_self_attention_kernel = in_place
            for what, evs, ms_ in (("addattn_x", events, dev_ms),
                                   ("matmuls + add + addattn", composed_events, composed_ms)):
                optin_launches[what] = (
                    sum(e.count for e in evs if e.key.startswith("aten::")),
                    sum(e.count for e in evs if str(e.device_type).endswith("CUDA")))
                print(f"{label}: one classify_arrays, attention blocks through {what}: "
                      f"{optin_launches[what][0]} aten:: calls, {optin_launches[what][1]} kernel "
                      f"launches, summed kernel time {ms_:.2f} ms")
            if not all(a < b_ for a, b_ in zip(*optin_launches.values())):
                fail(f"{label}: addattn_x does not save launches: {optin_launches}")
            # same weights as the default EQTransformer path: same curves
            route_err = float(np.abs(curves - curves_of["eqtransformer"]).max())
            print(f"{label}: max abs curve diff to the default eqtransformer path "
                  f"{route_err:.3e} (tol {CURVE_TOL})")
            if not route_err <= CURVE_TOL:
                fail(f"{label}: curves differ from the default route by {route_err}")
            rows = torch.as_tensor(curves.transpose(1, 0, 2).reshape(-1, curves.shape[-1]), device=dev)
            rthr = torch.as_tensor(np.repeat(np.float32([thresholds[c_] for c_ in channels]), STATIONS),
                                   device=dev)
            a_scan = extract_triggers_batched(rows, rthr, max_picks=TRIG_K, method="pallas")
            a_full = extract_triggers_batched(rows, rthr, max_picks=TRIG_K, method="pallas_full")
            for g, w in zip(a_scan, a_full):
                if not torch.equal(g, w):
                    fail(f'{label}: method="pallas" picks differ from "pallas_full" on its curves')
            print(f'{label}: method="pallas" equals "pallas_full" on its own curves '
                  f"({int(a_full[2].sum())} picks in {rows.shape[0]} rows)")

        # CPU cross-check on 1 station x 5 min, same weights
        cpu_model = load_model(arch, device="cpu", **margs)
        cpu_model.load_state_dict({k_: v_.cpu() for k_, v_ in model.state_dict().items()}, strict=True)
        gpu_c = picker.annotate_array(cut, **kw)
        cpu_c = WaveformPicker(cpu_model, device="cpu", **pkw).annotate_array(cut, **kw)
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
        for k_, v_ in saved_env.items():
            if v_ is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v_

    # ---- 4b. K6 on the res-CNN section of the full-width model, every step
    # of the bench stream (232 windows each), against the model's modules
    model = load_model("eqtransformer", seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for blk in model.res_cnn_stack.members:
            for norm in (blk.norm1, blk.norm2):
                norm.running_mean.copy_(torch.randn(RES_C, generator=gen) * 0.3)
                norm.running_var.copy_(torch.rand(RES_C, generator=gen) * 2 + 0.5)
                norm.weight.copy_(torch.randn(RES_C, generator=gen) * 0.5 + 1)
                norm.bias.copy_(torch.randn(RES_C, generator=gen) * 0.1)
    packed = cuda_rescnn.fold_res_cnn_params(model.res_cnn_stack)

    def res_modules(h):
        for blk in model.res_cnn_stack.members:
            h = blk(h)
        return h

    window, stride = model.in_samples, model.in_samples - 5500
    n_uni = len(window_starts(data.shape[-1], window, 5500))
    n_steps = -(-n_uni // (256 // STATIONS))
    wpc = -(-n_uni // n_steps)
    span = (wpc - 1) * stride + window
    datap = F.pad(torch.as_tensor(data, device=dev), (0, (n_steps - 1) * wpc * stride + span - data.shape[-1]))
    res_err = res_twin_err = 0.0
    zero_counts()
    with torch.inference_mode():
        for i in range(n_steps):
            sp = datap[..., i * wpc * stride : i * wpc * stride + span]
            fr = condition_windows_from_span(sp, wpc, stride, window, detrend=True, norm="peak")
            enc = model.encode(fr.reshape(wpc * STATIONS, 3, window)).contiguous()
            if tuple(enc.shape) != (RES_B, RES_C, RES_T):
                fail(f"encoder output {tuple(enc.shape)}, want {(RES_B, RES_C, RES_T)}")
            got_r = cuda_rescnn.res_cnn_stack(enc, packed)
            res_err = max(res_err, float((got_r - res_modules(enc)).abs().max()))
            res_twin_err = max(res_twin_err, float(
                (got_r - cuda_rescnn.res_cnn_stack_reference(enc, packed)).abs().max()))
        torch.cuda.synchronize()
        by_path["eqtransformer/res_cnn section"] = read_counts()
        if by_path["eqtransformer/res_cnn section"]["rescnn"] != n_steps:
            fail(f"rescnn launched {by_path['eqtransformer/res_cnn section']['rescnn']} times in {n_steps} steps")
        print(f"K6 res_cnn_stack ({RES_B}, {RES_C}, {RES_T}) on the encoder output of {n_steps} "
              f"steps: max abs err {res_err:.3e} vs the model's modules, {res_twin_err:.3e} vs twin "
              f"(tol {RES_TOL})")
        if not max(res_err, res_twin_err) <= RES_TOL:
            fail(f"res_cnn_stack max abs err {max(res_err, res_twin_err)} > {RES_TOL}")
        res_ms = cuda_ms(lambda: cuda_rescnn.res_cnn_stack(enc, packed), iters=100)
        _, _, events = profiled(lambda: [cuda_rescnn.res_cnn_stack(enc, packed) for _ in range(20)])
        res_kernel_ms = sum(self_device_us(e) for e in events if "rescnn_kernel" in e.key) / 2e4
        res_plain_ms = cuda_ms(lambda: cuda_rescnn.res_cnn_stack_reference(enc, packed))
        res_mod_ms = cuda_ms(lambda: res_modules(enc))
    n_bct = RES_B * RES_C * RES_T
    n_blk = packed["w1"].shape[0]
    res_bound = bound(2 * nbytes(enc) + nbytes(*packed.values()),
                      flops=n_bct * n_blk * (2 * 3 * RES_C * 2 + 7))
    res_plan = cuda_rescnn.rescnn_plan(
        RES_B, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K6 time on {card} ({res_plan[0]} windows a CTA, {res_plan[1]} CTAs, {res_plan[2]} bytes of "
          f"shared memory each): kernel {res_ms:.4f} ms by CUDA events around 100 calls (the gaps "
          f"between launches included), {res_kernel_ms:.4f} ms its row under torch.profiler, twin "
          f"{res_plain_ms:.4f} ms, the model's seven modules {res_mod_ms:.4f} ms, bound "
          f"{res_bound[0]:.4f} ms ({res_bound[1]}; the kernel {res_ms / res_bound[0]:.2f}x by events, "
          f"{res_kernel_ms / res_bound[0]:.2f}x by its row), no library call computes it")
    del model
    torch.cuda.empty_cache()

    # ---- 4c. the streaming path: 2 stations in 10-second packets a component
    model = load_model("eqtransformer", seed=0, device=dev)
    picker = WaveformPicker(model, device=dev)
    kw = dict(overlap=5500, blinding=(500, 500), batch_size=256)
    sdata = np.ascontiguousarray(data[:STREAM_STATIONS])
    flat_curves = picker.annotate_array(sdata, **kw)
    seeded_state = {k_: v_.clone() for k_, v_ in model.state_dict().items()}
    seeded_cut = picker.annotate_array(cut, **kw)
    # the samples every window blinds (the first and last 500) are 0: left out
    stretch_heads(model, [flat_curves[:, ki, 500:-500] for ki in range(3)])
    curves = picker.annotate_array(sdata, **kw)
    channels = picker._prob_channels()
    thr = {lab: float(np.percentile(curves[:, i], 99.9)) for i, lab in enumerate(channels)}
    print(f"streaming: curves of the seeded heads, percentiles 1 / 50 / 99.9 "
          f"{[[round(float(v), 4) for v in np.percentile(flat_curves[:, i, 500:-500], [1, 50, 99.9])] for i in range(3)]}"
          f"; with the heads stretched "
          f"{[[round(float(v), 4) for v in np.percentile(curves[:, i, 500:-500], [1, 50, 99.9])] for i in range(3)]}"
          f"; thresholds {thr}")
    sstream = Stream([tr for tr in stream if tr.stats.station in ("S00", "S01")])
    offline = picker.classify(sstream, P_threshold=thr["P"], S_threshold=thr["S"],
                              detection_threshold=thr["Detection"], **kw)
    sample_of = lambda p: (p.trace_id, p.phase, int(round((p.peak_time.timestamp - t_start.timestamp) * SR)))  # noqa: E731
    want_picks = sorted(sample_of(p) for p in offline.picks)
    # the oracle's trigger rule on the card's own curves gives offline's picks
    oracle_picks = []
    for si in range(STREAM_STATIONS):
        for lab in ("P", "S"):
            row = curves[si, channels.index(lab)]
            t1_ = np.float32(thr[lab])
            for on_, off_ in trigger_onset_numpy(row, t1_, t1_ / np.float32(2.0)):
                oracle_picks.append((f"XV.S{si:02d}.", lab, on_ + int(np.argmax(row[on_ : off_ + 1]))))
    if sorted(oracle_picks) != want_picks or len(want_picks) < 4:
        fail(f"streaming: offline classify gives {len(want_picks)} picks, the oracle's trigger rule on "
             f"the same curves {len(oracle_picks)}; they must be equal and more than a handful")
    thresholds = dict(thr, Detection_rg=thr["Detection"], Detection_lp=thr["Detection"], N=2.0)
    sp = StreamingPicker(picker, thresholds=thresholds, hop_seconds=HOP_S, **kw)
    pass_ms, forwards = [], [0]
    inner = picker.classify_arrays

    def timed_pass(*a_, **k_):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out_ = inner(*a_, **k_)
        pass_ms.append((time.perf_counter() - t0_) * 1e3)
        return out_

    picker.classify_arrays = timed_pass
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    streamed, n_packets, per_call = [], 0, []
    zero_counts()
    t_feed = time.perf_counter()
    for lo in range(0, sdata.shape[-1], PACKET):
        for si in range(STREAM_STATIONS):
            for ci, comp in enumerate("ZNE"):
                got_ = sp.ingest(Trace(sdata[si, ci, lo : lo + PACKET], dict(
                    network="XV", station=f"S{si:02d}", channel=f"HH{comp}", sampling_rate=SR,
                    starttime=t_start + lo / SR)))
                n_packets += 1
                per_call.append(len(got_))
                streamed += list(got_)
    streamed += list(sp.flush())
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t_feed
    by_path["eqtransformer/streaming"] = read_counts()
    hook.remove()
    picker.classify_arrays = inner
    n_pass, n_fwd = len(pass_ms), forwards[0]
    got_picks = sorted(sample_of(p) for p in streamed)
    print(f"streaming: {n_packets} packets of {PACKET} samples, {n_pass} passes ({n_fwd} forwards), "
          f"{len(streamed)} picks streamed ({sum(1 for n_ in per_call if n_)} ingest calls released some), "
          f"offline classify {len(want_picks)}; launches {by_path['eqtransformer/streaming']}")
    if len(got_picks) != len(set(got_picks)):
        fail("streaming: a pick was released twice")
    if got_picks != want_picks:
        fail(f"streaming: streamed picks differ from offline classify: only streamed "
             f"{sorted(set(got_picks) - set(want_picks))}, only offline {sorted(set(want_picks) - set(got_picks))}")
    want = dict.fromkeys(counters, 0)
    want.update(trigger_extract=n_pass, lstm_multi=4 * n_fwd)
    if n_pass < 2 * STREAM_STATIONS or n_fwd < n_pass or by_path["eqtransformer/streaming"] != want:
        fail(f"streaming: launches {by_path['eqtransformer/streaming']}, want {want}")
    stream_rate, stream_pass_ms = n_packets / feed_s, float(np.median(pass_ms))
    print(f"streaming on {card}: {n_packets} packets in {feed_s:.2f} s = {stream_rate:.1f} packets/s "
          f"(host clock, flush included); a pass (one classify_arrays of one station's buffer) median "
          f"{stream_pass_ms:.2f} ms, min {min(pass_ms):.2f}, max {max(pass_ms):.2f}")

    # ---- 4d. the other routes against the default one on 1 station x 5 min:
    # curves with the seeded weights as they are (the stretched heads multiply
    # a difference between two routes by the heads' gain, a few hundred), picks
    # with the stretched heads (isolated peaks) at thresholds that no sample of
    # any route's curves comes near
    base_c = picker.annotate_array(cut, **kw)

    def clear_threshold(values):
        """(threshold, clearance): of 4000 candidates near the top of the curves the
        one that it and its half keep the farthest from every sample."""
        vals = np.sort(values.ravel().astype(np.float64))
        best = (0.0, -1.0)
        for cand in np.quantile(vals, np.linspace(0.97, 0.9995, 4000)):
            cand = float(np.float32(cand))
            gap = min(np.abs(vals[np.clip(np.searchsorted(vals, t_) + np.array([-1, 0]), 0, vals.size - 1)] - t_).min()
                      for t_ in (cand, float(np.float32(cand) / np.float32(2.0))))
            if gap > best[1]:
                best = (cand, float(gap))
        return best

    state = model.state_dict()
    route_errs, route_pickers, route_curves = {}, {}, {}
    for route in (False, "lstm", "polyup", "grouped", "blockdiag+polyup", "plstm+bandattn+grouped+polyup"):
        other = load_model("eqtransformer", seed=0, device=dev, fused=route)
        rpicker = route_pickers[route] = WaveformPicker(other, device=dev)
        other.load_state_dict(seeded_state, strict=True)
        forwards[0] = 0
        hook = other.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        zero_counts()
        err = route_errs[str(route)] = float(np.abs(rpicker.annotate_array(cut, **kw) - seeded_cut).max())
        other.load_state_dict(state, strict=True)
        route_curves[route] = rpicker.annotate_array(cut, **kw)
        torch.cuda.synchronize()
        k2 = read_counts()["lstm_multi"]
        hook.remove()
        want_k2 = 4 * forwards[0] if "plstm" in str(route) else 0
        print(f"route fused={route!r} ({other.fused!r}): max abs curve diff to the default route "
              f"{err:.3e} (tol {CURVE_TOL}; {float(np.abs(route_curves[route] - base_c).max()):.3e} with "
              f"the heads stretched), K2 launches {k2} in {forwards[0]} forwards")
        if not err <= CURVE_TOL:
            fail(f"route {route!r}: curves differ from the default route by {err}")
        if k2 != want_k2:
            fail(f"route {route!r}: {k2} launches of K2, want {want_k2}")
    # thresholds that every route's curves keep clear of, so that a sample lies
    # on the same side of a threshold and of its half on every route
    every = np.stack([base_c] + list(route_curves.values()))
    cleared = {lab: clear_threshold(every[:, :, i]) for i, lab in enumerate(channels)}
    rthr = {lab: t_ for lab, (t_, _) in cleared.items()}
    print(f"routes: thresholds {rthr}, clear of every sample of every route's curves by "
          f"{ {lab: float(f'{gap:.2e}') for lab, (_, gap) in cleared.items()} }")
    res_d = picker.classify_arrays(cut, rthr, **kw)
    for route, rpicker in route_pickers.items():
        res_r = rpicker.classify_arrays(cut, rthr, **kw)
        n_picks, n_moved = sum(int(v[2].sum()) for v in res_r.values()), 0
        for ki, lab in enumerate(channels):
            row, other_row = base_c[0, ki], route_curves[route][0, ki]
            for t_ in (np.float32(rthr[lab]), np.float32(rthr[lab]) / np.float32(2.0)):
                if not np.array_equal(row > t_, other_row > t_):
                    fail(f"route {route!r}: a sample of {lab} lies across a threshold from the default "
                         "route's: the picks cannot be compared")
            (pk_r, _, ok_r, on_r, off_r), (pk_d, _, ok_d, on_d, off_d) = res_r[lab], res_d[lab]
            if not (np.array_equal(ok_r, ok_d) and np.array_equal(on_r, on_d) and np.array_equal(off_r, off_d)):
                fail(f"route {route!r}: {lab} triggers differ from the default route's")
            # the same peak, or two samples whose values the two routes cannot tell apart
            moved = ok_d & (pk_r != pk_d)
            n_moved += int(moved.sum())
            if (np.abs(row[pk_r[moved]] - row[pk_d[moved]]) > 2 * np.abs(row - other_row).max()).any():
                fail(f"route {route!r}: {lab} peaks differ from the default route's")
        print(f"route fused={route!r}: the default route's {n_picks} picks and detections "
              f"({n_moved} peaks on another sample of the same value)")
        if n_picks == 0:
            fail(f"route {route!r}: no picks to compare")
    del route_pickers
    del model, picker
    torch.cuda.empty_cache()

    # TPUPickNet's attention routes in turns on one model and picker
    label, arch, _, _, _, overlap, blinding, batch = PATHS[3]
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
    xla_ms, pallas_ms = device_of["tpupicknet/xla"], device_of["tpupicknet/pallas"]
    print(f"tpupicknet/pallas against tpupicknet/xla on {card}: summed kernel ms {pallas_ms:.2f} vs "
          f"{xla_ms:.2f} ({(pallas_ms / xla_ms - 1) * 100:+.1f}%); aten::copy_ launches "
          f"{ops_of['tpupicknet/pallas']['copy_'][0]} vs {ops_of['tpupicknet/xla']['copy_'][0]}, "
          f"aten::mul launches {ops_of['tpupicknet/pallas']['mul'][0]} vs "
          f"{ops_of['tpupicknet/xla']['mul'][0]}")
    if optin_kernel_ms:
        print(f"{OPTIN}: summed ms of the route's kernels in one classify_arrays: "
              + ", ".join(f"{kn} {ms:.3f}" for kn, ms in optin_kernel_ms.items() if ms > 0))

    # ---- 7. training at full width
    t0 = time.perf_counter()
    waves, meta = synthetic_arrays(n_events=TRAIN_EVENTS, n_noise=TRAIN_NOISE, n_samples=TRAIN_SAMPLES, seed=0)
    print(f"synthetic traces for phases 7 and 8: {len(meta)} of 3 x {TRAIN_SAMPLES} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    training = train_phase(dev, card, zero_counts, read_counts, waves, meta)
    by_path["eqtransformer/train step"] = training["launches"]["train"]
    by_path["eqtransformer/validation"] = training["launches"]["validation"]

    # ---- 8. evaluation at full width
    evaluation = eval_phase(dev, card, zero_counts, read_counts, waves, meta)
    by_path["eqtransformer/evaluate"] = evaluation["launches"]
    del waves, meta

    def entry(name, source, replaces, path, err, ms, plain_ms, bnd, library_ms=None, **extra):
        return dict({"name": name, "route": "cuda", "source": f"volpick_tpu_torch/csrc/{source}",
                     "replaces": f"volpick_tpu/ops/pallas/{replaces}",
                     "launches": by_path[path][name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": library_ms}, **extra)

    print(json.dumps({"kernels": [
        # ms: the summed profiler rows of its kernels a call (one cooperative
        # launch, or two plain ones); event_ms: CUDA events around whole calls,
        # which read the host's pace; *_short_rows at (3000, 6000), K = 64;
        # *_eval_sweep the evaluation sweep's (9 x 256, 6000), K = 64, by its
        # profiler row, launches those of phase 8's eval_task0
        entry("trigger_extract", "trigger_extract.cu", "triggers.py:250", "eqtransformer",
              trig_err, trig_ms, trig_plain_ms, trig_bound, event_ms=trig_event_ms,
              kernel_launches_a_call=trig_n, x_bound=trig_ms / trig_bound[0],
              ms_short_rows=short_trig_ms, event_ms_short_rows=short_trig_event_ms,
              plain_ms_short_rows=short_trig_plain_ms, bound_ms_short_rows=short_trig_bound[0],
              bound_by_short_rows=short_trig_bound[1], ms_eval_sweep=evaluation["k1_ms"],
              plain_ms_eval_sweep=evaluation["k1_plain_ms"],
              rows_eval_sweep=evaluation["k1_rows"], bound_ms_eval_sweep=evaluation["k1_bound"][0],
              bound_by_eval_sweep=evaluation["k1_bound"][1],
              launches_eval_sweep=by_path["eqtransformer/evaluate"]["trigger_extract"],
              launches_a_batch_eval_sweep=evaluation["k1_launches_a_batch"]),
        # lstm_branches, the form the models call, at C=64 and at C=16 (*_c16).
        # ms, library_ms: summed kernel time of one call under the profiler
        # (projection included); event_ms, library_event_ms: CUDA events
        # around back-to-back calls, which read the host's pace; kernel_only_ms
        # the recurrence kernel alone; multi_event_ms the lstm_multi form
        entry("lstm_multi", "lstm_multi.cu", "lstm.py:76", "eqtransformer", max(lstm_err, evaluation["k2_err"]),
              lstm_ms[64][4], lstm_ms[64][1], lstm_bound[64], lstm_lib_ms[64][1],
              event_ms=lstm_ms[64][0], library_event_ms=lstm_lib_ms[64][0],
              kernel_only_ms=lstm_ms[64][2], multi_event_ms=lstm_ms[64][3],
              ms_c16=lstm_ms[16][4], plain_ms_c16=lstm_ms[16][1], bound_ms_c16=lstm_bound[16][0],
              bound_by_c16=lstm_bound[16][1], library_ms_c16=lstm_lib_ms[16][1],
              event_ms_c16=lstm_ms[16][0], library_event_ms_c16=lstm_lib_ms[16][0],
              kernel_only_ms_c16=lstm_ms[16][2], multi_event_ms_c16=lstm_ms[16][3]),
        # ms by CUDA events around whole calls (two launches each); kernel_ms the
        # summed profiler rows of its kernels; *_short_rows at (3000, 6000)
        entry("trigger_scan", "trigger_scan.cu", "triggers.py:329", OPTIN, scan_err, scan_ms,
              scan_plain_ms, scan_bound, kernel_ms=scan_kernel_ms, emit_ms=emit_ms,
              ms_short_rows=short_ms,
              kernel_ms_short_rows=short_kernel_ms, plain_ms_short_rows=short_plain_ms,
              bound_ms_short_rows=short_bound[0], bound_by_short_rows=short_bound[1]),
        # detrend + peak, EQTransformer's conditioning. ms: the kernel's row
        # under the profiler; event_ms: CUDA events around back-to-back calls;
        # ms_by_mode: the profiler row of every detrend x norm mode
        entry("conditioning", "conditioning.cu", "conditioning.py:50", OPTIN, cond_err,
              cond_ms[True, "peak"], cond_plain_ms[True, "peak"], cond_bound,
              event_ms=cond_event_ms[True, "peak"], x_bound=cond_ms[True, "peak"] / cond_bound[0],
              ms_by_mode={f"detrend={d},norm={n}": ms for (d, n), ms in cond_ms.items()}),
        # addattn_x, the entry the model calls; *_xqk is addattn, fed q and k.
        # ms: the kernel's row under the profiler; event_ms: CUDA events around
        # back-to-back calls, which read the host's pace
        entry("addattn", "addattn.cu", "addattn.py:52", OPTIN, att_err, att["addattn_x"][0],
              att["addattn_x"][2], att_bound, event_ms=att["addattn_x"][1],
              max_abs_err_f64=att_f64, ms_xqk=att["addattn"][0], event_ms_xqk=att["addattn"][1],
              plain_ms_xqk=att["addattn"][2], bound_ms_xqk=att_bound_xqk[0],
              bound_by_xqk=att_bound_xqk[1]),
        # wired into no forward (as in the JAX package): launches are those of phase 4b
        # ms by CUDA events around 100 calls; kernel_ms its row under the profiler
        entry("rescnn", "rescnn.cu", "rescnn.py:112", "eqtransformer/res_cnn section",
              max(res_err, res_twin_err), res_ms, res_plain_ms, res_bound, modules_ms=res_mod_ms,
              kernel_ms=res_kernel_ms, x_bound=res_ms / res_bound[0],
              x_bound_kernel_ms=res_kernel_ms / res_bound[0], windows_per_cta=res_plan[0],
              ctas=res_plan[1], shared_bytes=res_plan[2]),
        # mha_qkv, the entry the model calls; *_head_major is the mha entry
        entry("mha", "mha.cu", "attention.py:55", "tpupicknet/pallas", mha_err, mha_ms,
              mha_plain_ms, mha_bound, mha_lib_ms, ms_head_major=mha_hm_ms,
              plain_ms_head_major=mha_hm_plain_ms, library_ms_contiguous=mha_lib_packed_ms),
    ], "launches_by_path": by_path, "optin_classify_launches": optin_launches,
        "streaming": {"packets": n_packets, "passes": n_pass, "forwards": n_fwd, "picks": len(got_picks),
                      "packets_per_s": stream_rate, "pass_ms_median": stream_pass_ms},
        "route_max_abs_curve_diff": route_errs,
        "training": {k: v for k, v in training.items() if k != "launches"},
        "evaluation": {k: v for k, v in evaluation.items() if k not in ("launches", "k1_bound")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
