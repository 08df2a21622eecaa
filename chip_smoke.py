"""Smoke run of volpick_tpu_torch on one CUDA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

1. prints the card (name, power limit from nvidia-smi), torch/CUDA versions
   and the TF32 flags (both set False: every comparison is float32);
2. builds the hand-written kernels from volpick_tpu_torch/csrc with nvcc
   (one nvcc per source, in parallel) and fails unless every instantiation of
   the bf16 bodies of K7, K2 and K5 has HMMA (tensor-core) instructions in
   its SASS; beside it, the earlier bf16 designs of K7, K2 and K5
   (scripts/k7_bf16_simt.cu, k2_bf16_before.cu, k5_bf16_before.cu), timed in
   phase 3 as yardsticks only;
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
   (phase 4b); K8 upconv_relu at each of the seven decoder layers of the
   full-width EQTransformer at B = 256, 208 and 16 within 1e-5 of the
   layer's largest output, timed at B = 256 by its profiler row beside the
   twin's time by CUDA events and the summed device time of the twin's
   kernels (the cuDNN route, a yardstick only); K9 convpool_relu at each of
   the seven encoder layers at the same batches within 1e-5 of the layer's
   largest output, timed at each by its profiler row beside the cuDNN
   route's kernels, bound by the benchmark's k9_work, and 7 launches a
   float32 EQT-family forward wherever the launches are counted (0 in
   bf16). Beside each kernel it
   prints the least time the card could take for the same work (bytes
   over 3.35 TB/s, float32 operations over 67
   TFLOP/s, transcendentals over the special-function units' 67 / 16 T/s; the
   largest of the three) and, for K2 and K7, the time of the one PyTorch call
   that computes the same function (torch.nn.LSTM(bidirectional=True);
   F.scaled_dot_product_attention on views of the same projection):
   yardsticks only, the port calls neither. Then the bf16 entries of K2
   (lstm_branches and lstm_multi at C 64 and 16: one launch of the fused
   body, projection included; a bf16 lstm_branches call shows one kernel row
   under the profiler and no gemm), K5 (addattn_x and addattn) and K7
   (mha_qkv and mha, the tensor-core body) at the same shapes against their
   bf16 twins, each by a rule that states its reason and with the count of
   elements beyond one bf16 ulp (2^-7 |twin| + 1e-6) printed: K2 within
   2^-7 |twin| + 2^-9 (the kernel sums the projection on the tensor cores,
   the twin in another order, so a gate input can round to the neighbouring
   bf16 value), K5 within one bf16 ulp (its tanh is the twin's correctly
   rounded one; its error from float64 is printed beside the twin's), K7 within 2^-7 |twin| + 2^-8 max|v| of the window and head
   (the tensor cores sum the logits in another order); each timed by its
   profiler row beside its bound (bf16 operands at 2 bytes an element, the
   bf16 products of K2 and K7 at the tensor cores' rate) and beside the
   earlier bf16 design built in step 2 in the same process, and, for K2 and
   K7, the same yardsticks in bf16;
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
   call, on the opt-in route K3 instead; K2 4 times a forward and K8 7
   times a decoder a forward on the EQT family; K7 n_layers times a
   forward under "pallas"; on the opt-in route K5 twice a forward and K4
   once a forward; never otherwise). The opt-in
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
   pallas, pallas, xla; median of 10 each); phasenet, tpupicknet/pallas and
   eqtransformer/optin also run one classify_arrays through a
   precision="bfloat16" picker on the same model: launches as in float32
   with the bf16 entries of K7, K5 and K2 (K4, K3 and K1 stay float32),
   curves within 0.1 of the float32 ones (the pin of
   tests/test_torch_precision.py), summed kernel time beside float32's, and
   on tpupicknet/pallas K7's bf16 launches and its share of that time;
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

9. picks the bench stream from files: 7 stations written to miniSEED
   (write_mseed, float32 encoding) and one to SAC (write_sac), read back
   exactly; a full-width EQTransformer (seeded, heads stretched as in 4c)
   exported with export_pretrained under $VOLPICK_TPU_MODELS; then
   volpick_tpu_torch.__main__.main(["pick", *files, "--weights", ...,
   "--overlap", "5500", "--precision", p, "--output", csv, "--device", ...])
   in-process for p = float32 and bfloat16. Fails unless each run launches
   K1 once and K2 4 times a forward and nothing else (under bf16 the K2
   launches are the bf16 instantiation), the float32 CSV's picks are those
   of WaveformPicker.classify on the in-memory stream, the seeded model's
   bf16 curves lie within 0.1 of its float32 curves, and the strongest P
   pick of each station agrees between the two CSVs by the JAX package's
   rule (within 10 samples and 0.05 in value); prints the read time, the
   classify_arrays windows/s by the host clock and the summed kernel time of
   one classify_arrays under torch.profiler in both precisions.

10. trains and inspects: EQTransformer at full width (seeded) trained with
   examples/configs/eqtransformer_swa.json's settings (swa_lrs 5e-5, its
   lr and plateau) on phase 7's pool, 4 epochs of 2 steps at batch 256 with
   swa_epoch_start 0.5, so that the last 2 epochs collect; fails unless the
   lr of those epochs' steps is swa_lrs and only there, swa_n is 2,
   swa_params is the mean of the two epoch-end states set aside (1e-6),
   a fresh Trainer restored from the run's last.ckpt holds the same
   averages, the steps launch no kernel and validation K2 4 a forward (by
   the counters and by the profiler's rows). Then utils/profiling.py's
   trace() around one classify_arrays of EQTransformer on the bench stream
   (batch 256): summarize_trace's card plane must count the launch
   counters' K2 and K1 (32 and 1); prints its top rows, device_memory_stats'
   peak and a StepTimer summary of 5 classifies. K1 on phase 3's curves at
   thresholds (t, t / 2) must give exactly picks_from_prob_numpy's picks
   and values on every row with fewer than K runs. plot_prediction_examples
   (or, where matplotlib is not installed, the arrays it draws) on 4
   synthetic traces: the card's curves within 2e-4 of device="cpu"'s, K2 4
   a trace; screen_dataset_with_models with the heads stretched, at a
   threshold in the widest gap between the traces' largest probabilities:
   the card's flags equal the CPU port's (plot_flagged where matplotlib is
   installed). Prints the phase's seconds.

11. an archive to picks on the port's acquisition/ modules: the bench
   stream in integer counts (ARCHIVE_SCALE a unit); a JMA deck with the
   stream's onsets at stations 0-3 read by read_jma_catalog into the
   catalog's table; stations 0-3 as one Hi-net event (write_win32 and a
   channel table, zipped) served through HinetSession.get_event_waveform
   over a fake wire and converted by convert_win32_event_dirs on the table;
   stations 4-7 as two SAC event folders under a directory named *_sac_*
   (one folder with upper-case .SAC names and .PICK sidecars) converted by
   convert_sac_to_mseed in two spawn workers. Fails unless every converted
   miniSEED file reads back (stream_to_array) as the quantised array from
   the sidecar's start time, read_sac_with_sidecar finds each sidecar, and
   main(["pick", *8 files, ...]) on phase 9's model launches K1 once and K2
   4 times a forward and writes exactly the rows of classify() on the
   in-memory arrays (1832 windows). Where h5py is installed (not on the
   card machine), convert_catalog_to_dataset, extract_noise_from_dataset
   and convert_from_old_format also run on the files. Prints the host-clock
   seconds of each step, the MB written and the pick count.

12. the multi-GPU layer (volpick_tpu_torch/parallel/mesh.py) in ranks that
   are child processes of scripts/mesh_ranks.py: (a) NCCL over
   torch.cuda.device_count() ranks, one a card (a world of one on a
   one-card machine, which still runs the process group, the global
   BatchNorm's all-reduces and the gathers), and (b) gloo, two ranks both on
   cuda:0 (NCCL refuses two ranks on one card). Each rank fits
   EQTransformer at full width with the training config of phase 7 (EMA,
   drop_rate 0.1) through Trainer.fit on the world's mesh: one epoch of 3
   global batches of 256 rows from phase 7's pool (128 rows a gloo rank)
   and one validation pass; then classifies the bench stream through
   WaveformPicker(mesh=) on a full-width EQTransformer with 4c's stretched
   heads (4 stations a gloo rank), with its K1 and K2 launches counted.
   Meanwhile this process runs the same fit and classify on one device.
   Fails unless every rank's global losses lie within 1e-4 relative of the
   one-process run's, its parameters and EMA within the distance Adam lets
   two float32 runs drift apart (2 x 1.0027 x the sum of the step lrs, plus
   one rounding of the largest parameter a step: a gradient near 0 may
   change sign between summation orders, and a first Adam step is about
   lr x sign(g)), its BatchNorm statistics within that plus 1e-4 of their
   size, the ranks of a world hold the same tensors bit for bit, only rank
   0 wrote the fit's files, every rank's picks equal the one-device picks
   exactly, and every rank launched K1 once and K2 at least once (16 on a
   gloo rank: 4 forwards). Prints each rank's launches and host seconds;
   a rank that fails or outlasts 300 s fails the phase.

13. the bench command (volpick_tpu_torch/bench.py): bench.throughput on the
   bench workload (1832 windows a call, the bench's model and thresholds)
   in float32 and in bf16, each a warm-up and 2 x (4 + 24) timed
   classify_arrays calls, launches counted (K1 once and K2 32 times a call,
   K2's bf16 entry under bf16, nothing else); the last timed call's pick
   buffers exactly the warm-up call's, and exactly the oracle's trigger rule
   (picker/oracle.py: trigger_onset_numpy(curve, t, t / 2), the peak the
   argmax over [on, off]) on the card's own curves, at the bench's
   thresholds and at each label's largest curve value below its 99.9th
   percentile (picks on every label).
   Then `python -m volpick_tpu_torch bench` as a subprocess from an empty
   directory with BENCH_AXES set: its last stdout line exactly the four
   keys, value > 0 and a numeric vs_baseline, and BENCH_AXES.json written
   there with the bf16 rate; and once more under CUDA_VISIBLE_DEVICES="",
   which must exit non-zero with no metric line. Prints a {"bench": ...}
   line before the kernels line.

Exits non-zero on any failure and without a CUDA device. The last two lines
are a JSON summary of the kernels and {"ok": true, "device": {...}}.
"""

import ctypes
import dataclasses
import json
import os
import re
import subprocess
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
# the bf16 entries against their bf16 twins: one bf16 ulp (2^-7 of the value
# bounds it from above); bf16 curves against float32 ones: the CPU test's pin
# (tests/test_torch_precision.py); the strongest P pick of a station in the
# two precisions: the JAX package's rule (tests/test_picker.py)
BF16_ULP, BF16_ABS, BF16_CURVE_TOL = 2.0 ** -7, 1e-6, 0.1
# K7's bf16 entries only: the tensor cores sum the logits in another order
# than the twin, which can flip the bf16 rounding of one probability and move
# an output near zero by up to 2^-8 max|v| of its window and head
MHA16_V_SHARE = 2.0 ** -8
# K2's bf16 body sums its projection on the tensor cores, the twin in another
# order: a gate input can round to the neighbouring bf16 value, which moves
# the states by far less than 2^-9
K2_BF16_ABS = 2.0 ** -9
PICK_SAMPLES, PICK_VALUE = 10, 0.05
COND_TOL, ATT_TOL, RES_TOL = 2e-5, 1e-5, 3e-4
# K8 against its twin: the folded taps sum the same products in another
# order, so a layer's outputs differ by rounding of its largest terms
UPCONV_TOL, UPCONV_BATCHES = 1e-5, (256, 208, 16)
# K9 against its twin: the kernel sums the K x I products of a conv output in
# another order than cuDNN's float32 conv (TF32 would be ~1e-3 off); at the
# same batches (eqt.archive's step, eqt.live's, a short one)
CONVPOOL_TOL = 1e-5
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
# phase 10: SWA with the published SWA config, SWA_EPOCHS epochs of 2 steps at
# SWA_BATCH, collecting from int(SWA_START * SWA_EPOCHS) on; the prediction
# panels' curves on the card against the CPU's (the EQT forward pin); the QC
# screen over QC_EVENTS + QC_NOISE traces at a threshold in a gap > QC_GAP
SWA_CONFIG = "examples/configs/eqtransformer_swa.json"
SWA_START, SWA_EPOCHS, SWA_BATCH, SWA_TOL = 0.5, 4, 256, 1e-6
PLOT_TOL, QC_EVENTS, QC_NOISE, QC_GAP = 2e-4, 16, 8, 2e-3
# phase 11: the bench stream in integer counts (|counts| < 2^24: exact as the
# float32 samples of SAC and miniSEED, and inside WIN32's int32); the WIN32
# trim's margins before the first pick and after the last reach past the
# 20 minutes
ARCHIVE_SCALE, CUT_PRE_S, CUT_POST_S = 1e4, 400.0, 1200.0
# phase 12: the data-parallel fit at a global batch of MESH_BATCH rows,
# MESH_STEPS steps; the ranks' global losses against one process's; Adam's
# step over lr for t <= 3 (Cauchy-Schwarz on the bias-corrected moments:
# sqrt(sum_i a_i^2 / b_i) <= 1.0027); BatchNorm statistics' share beyond the
# parameter bound (sums of float32 in other orders); the ranks' time limit
MESH_BATCH, MESH_STEPS, MESH_LOSS_RTOL, ADAM_U_MAX, MESH_STAT_RTOL, MESH_TIMEOUT = 256, 3, 1e-4, 1.0027, 1e-4, 300
# and the float64 steps that check the mechanism: MESH64_STEPS global batches
# of MESH64_BATCH rows against one process to the CPU tests' pins (losses
# relative, parameters / EMA / BatchNorm statistics absolute)
MESH64_BATCH, MESH64_STEPS, MESH64_LOSS_RTOL, MESH64_ATOL = 32, 3, 1e-6, 1e-7
# phase 13: the bench's timed runs (bench.py's 4 and 24 calls), its windows and forwards a call
BENCH_ITERS, BENCH_WINDOWS, BENCH_FORWARDS = (4, 24), 1832, 8
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
PEAK_BF16 = 989e12  # dense bf16 on the tensor cores (the bf16 projections of K2)

OPTIN = "eqtransformer/optin"
# the paths phase 5 also runs with precision="bfloat16" (phase 9 runs the default EQTransformer one)
BF16_PATHS = ("phasenet", "tpupicknet/pallas", OPTIN)
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


def bound(n_bytes: float, flops: float = 0.0, sfu: float = 0.0, bf16_flops: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take, each
    input byte read once and each output byte written once, float32
    operations at the non-tensor-core rate, bf16 matrix products at the
    tensor cores' rate and transcendentals (tanh, exp, sigmoid) one each at
    the special-function units' rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(flops / PEAK_F32 + bf16_flops / PEAK_BF16, sfu / PEAK_SFU)
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


def cudnn_ms(events) -> float:
    """Summed device ms of cuDNN's kernels in a profiler's events: its
    convolutions (implicit_convolve_sgemm, the tensor cores' xmma fprop) and
    the layout transposes it adds around the bf16 ones."""
    from volpick_tpu_torch.picker.stage_times import self_device_us

    return sum(self_device_us(e) for e in events if str(e.device_type).endswith("CUDA")
               and any(w in e.key.lower() for w in ("conv", "xmma", "cudnn"))) / 1e3


def relaxed_check(got, want, extra, rule: str, what: str):
    """Fail unless bf16 `got` is within 2^-7 |want| + `extra` of its bf16
    twin `want` (`extra` broadcastable to the output; `rule` names it);
    (largest |d|, the number of elements beyond the plain one-ulp rule
    2^-7 |want| + 1e-6)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16 or got.shape != want.shape:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} against the twin's {want.dtype} {tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    ulp = BF16_ULP * want.float().abs()
    over = d - (ulp + extra)
    if not bool(torch.isfinite(got.float()).all()) or float(over.max()) > 0:
        fail(f"{what}: {int((over > 0).sum())} elements beyond 2^-7 |twin| + {rule} "
             f"(largest |d| {float(d.max()):.3e})")
    return float(d.max()), int((d > ulp + BF16_ABS).sum())


def mha16_check(got, want, v_max, what: str):
    """K7's bf16 rule: within 2^-7 |want| + 2^-8 v_max of the twin (v_max: the
    largest |v| of each element's window and head, broadcastable to the
    output)."""
    return relaxed_check(got, want, MHA16_V_SHARE * v_max, "2^-8 max|v|", what)


def classify_seconds(picker, data, thresholds, kw) -> float:
    """Host-clock seconds of one classify_arrays call (it returns host numpy
    picks, so the call ends synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    picker.classify_arrays(data, thresholds, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def decoder_layers(model):
    """(I, O, K, T in, crop) of each decoder layer of an EQTransformer, at its
    in_samples: the encoder's pooled length doubles layer by layer, cropped
    by one where the encoder padded."""
    from volpick_tpu_torch.models.eqtransformer import _encoder_pool_paddings

    t = model.in_samples
    for pad in _encoder_pool_paddings(model.in_samples, len(model.filters)):
        t = (t + pad) // 2
    layers = []
    for i, conv in enumerate(model.decoder_d.convs):
        o, c, k = conv.weight.shape
        crop = int(i in model._crops)
        layers.append((c, o, k, t, crop))
        t = 2 * t - crop
    return layers


def upconv_rows(dev, rng, batches=UPCONV_BATCHES):
    """K8 upconv_relu at every decoder layer of the full-width EQTransformer:
    the kernel against its twin at each batch of ``batches`` (within
    UPCONV_TOL of the layer's largest output), and at the first batch its
    profiler row (20 calls), its time by CUDA events, the twin's by CUDA
    events, the summed device time of the twin's kernels (the cuDNN route:
    the upsampling copy, the pad copy, cuDNN's conv, the ReLU; a yardstick
    only) and the bound of the folded work. → (rows, largest relative error)."""
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import upconv as cuda_upconv
    from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us

    model = load_model("eqtransformer", seed=0, device="cpu")
    rows, worst = [], 0.0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        for li, (c, o, k, t, crop) in enumerate(decoder_layers(model)):
            w = torch.as_tensor((rng.normal(size=(o, c, k)) / np.sqrt(c * k)).astype(np.float32), device=dev)
            b = torch.as_tensor(rng.normal(size=o).astype(np.float32) * 0.1, device=dev)
            for bi, nb in enumerate(batches):
                x = torch.as_tensor(np.abs(rng.normal(size=(nb, c, t))).astype(np.float32), device=dev)
                got = cuda_upconv.upconv_relu(x, w, b, crop)
                want = cuda_upconv.upconv_relu_reference(x, w, b, crop)
                torch.cuda.synchronize()
                if got.shape != want.shape:
                    fail(f"upconv_relu L{li} B={nb}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
                err = float((got - want).abs().max() / want.abs().max())
                worst = max(worst, err)
                if not err <= UPCONV_TOL:
                    fail(f"upconv_relu L{li} B={nb} (I {c}, O {o}, K {k}, T {t}, crop {crop}): "
                         f"max |d| {err:.3e} of the largest output > {UPCONV_TOL}")
                if bi:
                    continue
                _, twin_dev_ms, _ = profiled(lambda: [cuda_upconv.upconv_relu_reference(x, w, b, crop)
                                                      for _ in range(20)])
                _, _, events = profiled(lambda: [cuda_upconv.upconv_relu(x, w, b, crop) for _ in range(20)])
                row_ms = sum(self_device_us(e) for e in events if "upconv_relu_kernel" in e.key) / 2e4
                n_out = 2 * t - crop
                # folded: p + 1 taps a parity, a multiply-add each
                flops = 2.0 * nb * o * n_out * c * ((k - 1) // 2 + 1)
                bnd = bound(nbytes(x, w, b) + nb * o * n_out * 4, flops=flops)
                plan = cuda_upconv.upconv_plan(nb, c, o, t, k, n_sm)
                rows.append({"layer": li, "b": nb, "i": c, "o": o, "k": k, "t": t, "crop": crop,
                             "ms": row_ms, "event_ms": cuda_ms(lambda: cuda_upconv.upconv_relu(x, w, b, crop)),
                             "plain_ms": cuda_ms(lambda: cuda_upconv.upconv_relu_reference(x, w, b, crop)),
                             "library_ms": twin_dev_ms / 20, "bound_ms": bnd[0], "bound_by": bnd[1],
                             "x_bound": row_ms / bnd[0], "flops": flops, "max_rel_err": err,
                             "plan": dict(zip(("nt", "tiles", "cblocks", "threads", "shared_bytes"), plan))})
    return rows, worst


def k9_work():
    """``k9_work(batch, c_in, c_out, k, length)`` → (bytes, float32
    operations, special-function operations) of one K9 launch, and
    ``encoder_layers(model_args)``, from the benchmark's reader of K9's
    roofline share (``benchmark/metrics/k9_roofline.archive.py``), so that
    this bound is the one the benchmark divides by."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "metrics",
                        "k9_roofline.archive.py")
    spec = importlib.util.spec_from_file_location("k9_roofline_archive", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.k9_work, mod.encoder_layers


def convpool_rows(dev, rng, batches=UPCONV_BATCHES):
    """K9 convpool_relu at every encoder layer of the full-width
    EQTransformer: the kernel against its twin at each batch of ``batches``
    (within CONVPOOL_TOL of the layer's largest output), and at each batch
    its profiler row (20 calls), its time by CUDA events, the summed device
    time of the twin's kernels (the cuDNN route: the pad copy, cuDNN's conv,
    the ReLU, the odd length's -inf pad copy, the pooling; a yardstick only)
    and the bound of the layer's work (``k9_work``). → (rows, largest
    relative error)."""
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import convpool as cuda_convpool
    from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us

    work, encoder_layers = k9_work()
    model = load_model("eqtransformer", seed=0, device="cpu")
    layers = encoder_layers({"filters": model.filters, "kernel_sizes": model.kernel_sizes,
                             "in_samples": model.in_samples, "in_channels": model.in_channels})
    if [tuple(c.weight.shape[1::-1]) + (c.weight.shape[-1],) for c in model.encoder.convs] != [
            lay[:3] for lay in layers]:
        fail(f"K9: the benchmark's encoder layers {layers} are not the model's")
    rows, worst = [], 0.0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        for li, (c, o, k, length) in enumerate(layers):
            w = torch.as_tensor((rng.normal(size=(o, c, k)) / np.sqrt(c * k)).astype(np.float32), device=dev)
            b = torch.as_tensor(rng.normal(size=o).astype(np.float32) * 0.1, device=dev)
            for nb in batches:
                x = torch.as_tensor(rng.normal(size=(nb, c, length)).astype(np.float32), device=dev)
                before = cuda_convpool.launches
                got = cuda_convpool.convpool_relu(x, w, b)
                want = cuda_convpool.convpool_relu_reference(x, w, b)
                torch.cuda.synchronize()
                if cuda_convpool.launches != before + 1 or got.shape != want.shape:
                    fail(f"convpool_relu L{li} B={nb}: {cuda_convpool.launches - before} launches, shape "
                         f"{tuple(got.shape)}, want 1 and {tuple(want.shape)}")
                err = float((got - want).abs().max() / want.abs().max())
                worst = max(worst, err)
                if not err <= CONVPOOL_TOL:
                    fail(f"convpool_relu L{li} B={nb} (I {c}, O {o}, K {k}, L {length}): "
                         f"max |d| {err:.3e} of the largest output > {CONVPOOL_TOL}")
                _, twin_dev_ms, _ = profiled(lambda: [cuda_convpool.convpool_relu_reference(x, w, b)
                                                      for _ in range(20)])
                _, _, events = profiled(lambda: [cuda_convpool.convpool_relu(x, w, b) for _ in range(20)])
                row_ms = sum(self_device_us(e) for e in events if "convpool_relu_kernel" in e.key) / 2e4
                n_bytes, flops, _ = work(nb, c, o, k, length)
                bnd = bound(n_bytes, flops=flops)
                plan = cuda_convpool.convpool_plan(nb, c, o, length, k, n_sm)
                rows.append({"layer": li, "b": nb, "i": c, "o": o, "k": k, "l": length,
                             "ms": row_ms, "event_ms": cuda_ms(lambda: cuda_convpool.convpool_relu(x, w, b)),
                             "library_ms": twin_dev_ms / 20, "bound_ms": bnd[0], "bound_by": bnd[1],
                             "x_bound": row_ms / bnd[0], "flops": flops, "max_rel_err": err,
                             "plan": dict(zip(("nt", "tiles", "cblocks", "threads", "shared_bytes"), plan))})
    return rows, worst


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
    want.update(lstm_multi=4 * val_batches[0], convpool=7 * val_batches[0])
    if val_batches[0] < 1 or launches["validation"] != want:
        fail(f"training: validation launches {launches['validation']}, want {want} (K2 4 and K9 7 times a forward)")
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
    want.update(trigger_extract=2 * n_batches, lstm_multi=4 * n_batches, convpool=7 * n_batches)
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


def pick_phase(dev, card, zero_counts, read_counts, data, t_start) -> dict:
    """Phase 9: the file-to-picks path at full width. The bench stream goes
    to files (7 stations to miniSEED through write_mseed, float32 encoding,
    one to SAC through write_sac) and is read back; a full-width
    EQTransformer with heads stretched as in 4c is exported with
    export_pretrained and picked from the files through the command line's
    main(["pick", ...]) in both precisions, the launch counts set to 0 just
    before and read just after each run."""
    import csv
    import shutil
    import tempfile

    from volpick_tpu_torch import __main__ as cli
    from volpick_tpu_torch.core.sacio import read_sac, write_sac
    from volpick_tpu_torch.io import read_mseed, write_mseed
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.models.eqtransformer import EQTransformer
    from volpick_tpu_torch.ops.windows import window_starts
    from volpick_tpu_torch.picker import UTC, Stream, Trace, WaveformPicker
    from volpick_tpu_torch.picker.stage_times import SR, device_rows, profiled, self_device_us
    from volpick_tpu_torch.train.model_io import export_pretrained

    stations, _, n = data.shape
    overlap, blinding, batch = 5500, (500, 500), 256
    kw = dict(overlap=overlap, blinding=blinding, batch_size=batch)
    tmp = tempfile.mkdtemp(prefix="volpick_pick_")
    saved_models = os.environ.get("VOLPICK_TPU_MODELS")
    try:
        # ---- the stream as files, and back
        files = []
        for s_ in range(stations):
            trs = [Trace(data[s_, ci].copy(), dict(network="XV", station=f"S{s_:02d}", channel=f"HH{comp}",
                                                   sampling_rate=SR, starttime=t_start))
                   for ci, comp in enumerate("ZNE")]
            if s_ < stations - 1:
                files.append(os.path.join(tmp, f"S{s_:02d}.mseed"))
                write_mseed(Stream(trs), files[-1], encoding="float32")
            else:
                for tr in trs:
                    files.append(os.path.join(tmp, f"S{s_:02d}.{tr.stats.channel}.sac"))
                    write_sac(tr, files[-1])
        t0 = time.perf_counter()
        back = Stream()
        for path in files:
            if path.endswith(".sac"):
                back.append(read_sac(path))
            else:
                back += read_mseed(path)
        read_ms = (time.perf_counter() - t0) * 1e3
        file_mb = sum(os.path.getsize(p_) for p_ in files) / 1e6
        seen = set()
        for tr in back:
            s_, ci = int(tr.stats.station[1:]), "ZNE".index(tr.stats.channel[-1])
            seen.add((s_, ci))
            # SAC keeps the sample interval as a float32
            if (tr.stats.starttime.timestamp != t_start.timestamp
                    or np.float32(1.0 / tr.stats.sampling_rate) != np.float32(1.0 / SR)
                    or not np.array_equal(np.asarray(tr.data, np.float64), data[s_, ci].astype(np.float64))):
                fail(f"pick: {tr.id} read back from its file is not the array written")
        if len(back) != 3 * stations or len(seen) != 3 * stations:
            fail(f"pick: {len(back)} traces read back from {len(files)} files, want {3 * stations}")
        print(f"pick: {stations} stations x 3 x {n} samples written to {stations - 1} miniSEED files "
              f"(float32) and 3 SAC files, {file_mb:.1f} MB, read back exactly in {read_ms:.1f} ms "
              f"(host clock)")

        # ---- the weights: full width, heads stretched, exported
        model = load_model("eqtransformer", seed=0, device=dev)
        picker = WaveformPicker(model, device=dev)
        flat = picker.annotate_array(data, **kw)
        # bf16 against float32 on the seeded heads, where the CPU test's pin
        # applies: the stretch below multiplies a head's logit by up to a few
        # hundred, and with it the bf16 rounding of the features under it
        seed_err = float(np.abs(WaveformPicker(model, device=dev, precision="bfloat16").annotate_array(
            data, **kw) - flat).max())
        if not seed_err <= BF16_CURVE_TOL:
            fail(f"pick: bf16 curves of the seeded model {seed_err} from its float32 curves "
                 f"(tol {BF16_CURVE_TOL})")
        stretch_heads(model, [flat[:, ki, 500:-500] for ki in range(3)])
        gains = [float(h.weight.abs().max()) for h in [model.conv_d] + list(model.pick_convs)]
        curves32 = picker.annotate_array(data, **kw)
        channels = picker._prob_channels()
        thr = {lab: float(np.percentile(curves32[:, i], 99.9)) for i, lab in enumerate(channels)}
        export_pretrained(model, os.path.join(tmp, "models"), name="smoke", default_args={
            "detection_threshold": thr["Detection"], "P_threshold": thr["P"], "S_threshold": thr["S"]})
        os.environ["VOLPICK_TPU_MODELS"] = os.path.join(tmp, "models")
        mem = Stream([Trace(data[s_, ci], dict(network="XV", station=f"S{s_:02d}", channel=f"HH{comp}",
                                               sampling_rate=SR, starttime=t_start))
                      for s_ in range(stations) for ci, comp in enumerate("ZNE")])
        ref = picker.classify(mem, P_threshold=thr["P"], S_threshold=thr["S"],
                              detection_threshold=thr["Detection"], **kw)
        ref_rows = [[p_.trace_id, p_.phase, p_.peak_time.isoformat(), f"{p_.peak_value:.4f}",
                     p_.start_time.isoformat(), p_.end_time.isoformat()] for p_ in ref.picks]

        # ---- python -m volpick_tpu_torch pick, in-process, in both precisions
        forwards = [0]

        def count(mod, *_):
            forwards[0] += isinstance(mod, EQTransformer)

        rows_of, launches_of, pick_s = {}, {}, {}
        for precision in ("float32", "bfloat16"):
            out_csv = os.path.join(tmp, f"picks_{precision}.csv")
            handle = torch.nn.modules.module.register_module_forward_hook(count)
            forwards[0] = 0
            zero_counts()
            t0 = time.perf_counter()
            cli.main(["pick", *files, "--weights", "smoke", "--overlap", str(overlap),
                      "--precision", precision, "--output", out_csv, "--device", str(dev)])
            torch.cuda.synchronize()
            pick_s[precision] = time.perf_counter() - t0
            launches_of[precision] = launches = read_counts()
            handle.remove()
            want = dict.fromkeys(launches, 0)
            want.update(trigger_extract=1, lstm_multi=4 * forwards[0])
            if precision == "bfloat16":
                want["lstm_multi_bf16"] = 4 * forwards[0]
            else:
                want["convpool"] = 7 * forwards[0]
            if forwards[0] < 1 or launches != want:
                fail(f"pick --precision {precision}: launches {launches}, want {want} ({forwards[0]} forwards)")
            with open(out_csv, newline="") as f:
                rows_of[precision] = list(csv.reader(f))
            if rows_of[precision][0] != ["trace_id", "phase", "peak_time", "peak_value", "start_time",
                                         "end_time"] or len(rows_of[precision]) < 2:
                fail(f"pick --precision {precision}: {len(rows_of[precision]) - 1} rows under "
                     f"{rows_of[precision][0]}")
            print(f"pick --precision {precision}: {len(rows_of[precision]) - 1} picks from {len(files)} "
                  f"files in {pick_s[precision]:.2f} s of host clock (weights, reading and picking), "
                  f"{forwards[0]} forwards; launches {launches}")
        if rows_of["float32"][1:] != ref_rows:
            fail(f"pick: the float32 CSV's {len(rows_of['float32']) - 1} picks are not classify()'s "
                 f"{len(ref_rows)} on the in-memory stream")

        # ---- bf16 against float32 with the stretched heads: the strongest P
        # pick of each station by the JAX package's rule; the curves' distance
        # is printed (the stretch amplifies the bf16 rounding of the features)
        picker16 = WaveformPicker(model, device=dev, precision="bfloat16")
        curve_err = float(np.abs(picker16.annotate_array(data, **kw) - curves32).max())
        strongest = {}
        for precision, rows in rows_of.items():
            for tid, phase, peak, val, *_ in rows[1:]:
                cur = strongest.get((tid, precision))
                if phase == "P" and (cur is None or float(val) > cur[1]):
                    strongest[tid, precision] = (UTC(peak).timestamp, float(val))
        ids = sorted({tid for tid, pr in strongest if pr == "float32"})
        agree = [tid for tid in ids if (tid, "bfloat16") in strongest
                 and abs(strongest[tid, "float32"][0] - strongest[tid, "bfloat16"][0]) < PICK_SAMPLES / SR
                 and abs(strongest[tid, "float32"][1] - strongest[tid, "bfloat16"][1]) < PICK_VALUE]
        if len(ids) < stations // 2 or agree != ids:
            fail(f"pick: the strongest P pick agrees between the precisions at {len(agree)} of "
                 f"{len(ids)} stations with a P pick (rule: < {PICK_SAMPLES} samples, < {PICK_VALUE})")
        print(f"pick: the float32 CSV equals classify() on the in-memory stream ({len(ref_rows)} picks); "
              f"bf16 curves of the seeded model within {seed_err:.3e} of float32 (tol {BF16_CURVE_TOL}); "
              f"with the heads stretched (largest head weight {[round(g, 2) for g in gains]}) bf16 curves "
              f"{curve_err:.3e} from float32 and the strongest P pick agrees by the JAX rule (< "
              f"{PICK_SAMPLES} samples, < {PICK_VALUE}) at {len(agree)} of {len(ids)} stations")

        # ---- classify_arrays by the host clock and under the profiler, both precisions
        thresholds = dict(thr)
        n_windows = stations * len(window_starts(n, model.in_samples, overlap))
        timing = {}
        for precision, pk in (("float32", picker), ("bfloat16", picker16)):
            pk.classify_arrays(data, thresholds, **kw)
            times = [classify_seconds(pk, data, thresholds, kw) for _ in range(5)]
            med = float(np.median(times))
            _, dev_ms, events = profiled(lambda: pk.classify_arrays(data, thresholds, **kw))
            conv_ms = cudnn_ms(events)
            k2_ms = sum(self_device_us(e) for e in events if "lstm_multi_kernel" in e.key) / 1e3
            top = sorted(((self_device_us(e) / 1e3, e.count, e.key) for e in device_rows(events)
                          if self_device_us(e) > 0), reverse=True)[:10]
            timing[precision] = dict(windows_per_s=n_windows / med, wall_ms=med * 1e3, kernel_ms=dev_ms,
                                     conv_ms=conv_ms, k2_ms=k2_ms,
                                     top=[(key[:80], count, round(ms, 3)) for ms, count, key in top])
            print(f"pick: classify_arrays {precision} on {card}: {n_windows} windows in {med * 1e3:.2f} ms "
                  f"(median of 5, host clock) = {n_windows / med:.1f} windows/s; one call under "
                  f"torch.profiler: summed kernel time {dev_ms:.2f} ms (cuDNN's convolutions and layout "
                  f"transposes {conv_ms:.2f} ms, K2 {k2_ms:.3f} ms); its ten largest kernels (ms, launches): "
                  + "; ".join(f"{key[:80]} {ms:.3f} x {count}" for ms, count, key in top))
        return dict(launches=launches_of, files=len(files), file_mb=file_mb, read_ms=read_ms,
                    picks={p_: len(r) - 1 for p_, r in rows_of.items()}, forwards=forwards[0],
                    cli_s=pick_s, seeded_curve_err=seed_err, stretched_curve_err=curve_err,
                    head_gains=gains, strongest_p_agree=len(agree), strongest_p_stations=len(ids),
                    timing=timing, model=model, thresholds=thr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_models is None:
            os.environ.pop("VOLPICK_TPU_MODELS", None)
        else:
            os.environ["VOLPICK_TPU_MODELS"] = saved_models


def inspect_phase(dev, card, zero_counts, read_counts, waves, meta, eqt_thresholds, eqt_launches,
                  trig_inputs) -> dict:
    """Phase 10, train and inspect: SWA training with the published SWA config
    on the card, the profiled classify, the host oracle of the picks against
    K1, the prediction-example panels and the QC screen. Fails on any miss of
    its checks."""
    import importlib.util
    import shutil
    import tempfile

    from scipy.signal import butter, sosfilt

    from volpick_tpu_torch.data.synthetic import synthetic_dataset
    from volpick_tpu_torch.device import inference_work
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.ops.triggers import picks_from_prob_numpy
    from volpick_tpu_torch.ops.windows import frame_windows, window_starts
    from volpick_tpu_torch.picker import WaveformPicker
    from volpick_tpu_torch.picker.stage_times import SR, bench_stream_array, profiled
    from volpick_tpu_torch.pipeline.generator import RawBatchSource, TrainGenerator, _onset_arrays
    from volpick_tpu_torch.train.trainer import Trainer, make_augment_config
    from volpick_tpu_torch.utils import plotting, qc
    from volpick_tpu_torch.utils.profiling import StepTimer, device_memory_stats, summarize_trace, trace

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    tmp = tempfile.mkdtemp(prefix="volpick_inspect_")
    launches = {}
    try:
        # ---- SWA with eqtransformer_swa.json's settings: SWA_EPOCHS epochs of 2
        # steps, a fractional start that collects in the last two
        with open(os.path.join(here, SWA_CONFIG)) as f:
            config = json.load(f)
        margs = config["model_args"]
        swa = dict(config["swa"], swa_epoch_start=SWA_START)
        p = np.array([m["trace_p_arrival_sample"] for m in meta], np.float32)
        s = np.array([m["trace_s_arrival_sample"] for m in meta], np.float32)
        is_lp = np.array([m["source_type"] == "lp" for m in meta], np.float32)
        is_dev = np.array([m["split"] == "dev" for m in meta])
        event = ~np.isnan(p) | ~np.isnan(s)
        n_noise = SWA_BATCH // 2
        tr_idx = np.r_[np.where(~is_dev & event)[0][: 2 * SWA_BATCH - n_noise],
                       np.where(~is_dev & ~event)[0][:n_noise]]

        def source(idx):
            return RawBatchSource.from_arrays(waves[idx], p[idx], s[idx], is_lp=is_lp[idx])

        model = load_model("eqtransformer", seed=0, device=dev)
        cfg = make_augment_config(model, margs, bool(config["stack_data"]))
        dev_idx = np.where(is_dev)[0]
        train_gen = TrainGenerator(source(tr_idx), cfg, SWA_BATCH, eq_dataset=source(tr_idx[event[tr_idx]]),
                                   noise_dataset=source(tr_idx[~event[tr_idx]]), seed=42, device=dev)
        dev_gen = TrainGenerator(source(dev_idx), cfg, SWA_BATCH, eq_dataset=source(dev_idx[event[dev_idx]]),
                                 noise_dataset=source(dev_idx[~event[dev_idx]]), seed=43, drop_last=False,
                                 device=dev)
        if len(train_gen) != 2:
            fail(f"swa: {len(train_gen)} steps an epoch, want 2")
        trainer = Trainer(model, lr=float(margs["lr"]), swa=swa, lr_scheduler=margs["lr_scheduler"],
                          lr_scheduler_args=margs["lr_scheduler_args"], device=dev)
        start = int(SWA_START * SWA_EPOCHS)
        lrs, aside, val_batches = [], [], [0]
        timer = StepTimer(device=dev)
        fit_step, fit_eval = trainer.train_step, trainer.eval_step

        def recorded_step(batch, lr, generator=None):
            with timer:
                loss = fit_step(batch, lr, generator)
            lrs.append(lr)
            # the state after an epoch's last step is the one SWA collects at its end
            if len(lrs) % 2 == 0 and len(lrs) // 2 - 1 >= start:
                aside.append({k: v.detach().clone() for k, v in model.state_dict().items()})
            return loss

        def counted_eval(batch):
            val_batches[0] += 1
            return fit_eval(batch)

        trainer.train_step, trainer.eval_step = recorded_step, counted_eval
        zero_counts()
        result = trainer.fit(train_gen, dev_gen, max_epochs=SWA_EPOCHS, save_dir=tmp, experiment="swa",
                             hparams=config, tensorboard=False)
        torch.cuda.synchronize()
        launches["eqtransformer/swa fit"] = got = read_counts()
        trainer.train_step, trainer.eval_step = fit_step, fit_eval
        want = dict.fromkeys(got, 0)
        want.update(lstm_multi=4 * val_batches[0], convpool=7 * val_batches[0])
        if val_batches[0] < SWA_EPOCHS or got != want:
            fail(f"swa: launches {got} over {val_batches[0]} validation batches, want {want} "
                 "(no kernel in a train step, K2 4 and K9 7 a validation forward)")
        losses = [h["train_loss"] for h in result["history"]] + [h["val_loss"] for h in result["history"]]
        if not all(np.isfinite(losses)):
            fail(f"swa: losses {losses}")
        swa_lr = float(config["swa"]["swa_lrs"])
        if lrs[2 * start:] != [swa_lr] * (2 * (SWA_EPOCHS - start)) or swa_lr in lrs[: 2 * start]:
            fail(f"swa: learning rates {lrs}, want {swa_lr} from epoch {start} on and only there")
        if trainer.swa_n != SWA_EPOCHS - start or len(aside) != 2:
            fail(f"swa: swa_n {trainer.swa_n} with {len(aside)} epoch-end states set aside, want 2")
        mean_err = 0.0
        for k, v in trainer.swa_params.items():
            if v.is_floating_point():
                mean_err = max(mean_err, float((v - (aside[0][k] + aside[1][k]) / 2).abs().max()))
            elif not torch.equal(v, aside[1][k]):
                fail(f"swa: {k} is not the latest value")
        if not mean_err <= SWA_TOL:
            fail(f"swa: swa_params {mean_err} from the mean of the two epoch-end states (tol {SWA_TOL})")
        ckpt = os.path.join(tmp, "swa", "checkpoints", "last.ckpt")
        fresh = Trainer(load_model("eqtransformer", seed=1, device=dev), swa=swa, device=dev).restore(ckpt)
        if fresh.swa_n != trainer.swa_n or set(fresh.swa_params) != set(trainer.swa_params) or not all(
                torch.equal(fresh.swa_params[k], v) for k, v in trainer.swa_params.items()):
            fail("swa: the restored swa_params / swa_n are not the run's")
        dev_batch = next(iter(dev_gen.epoch()))
        _, _, events = profiled(lambda: trainer.eval_step(dev_batch))
        k2_rows = sum(e.count for e in events if "lstm_multi_kernel" in e.key)
        if k2_rows != 4:
            fail(f"swa: the profiler counts {k2_rows} K2 kernels in a validation forward, want 4")
        steps = timer.summary()
        print(f"swa: EQTransformer at full width, {SWA_CONFIG} (swa_lrs {swa_lr}, swa_epoch_start {SWA_START} "
              f"for {SWA_EPOCHS} epochs of 2 steps at batch {SWA_BATCH}): lrs {lrs}; swa_n {trainer.swa_n}, "
              f"swa_params within {mean_err:.2e} of the mean of the two epoch-end states (tol {SWA_TOL}); "
              f"restored from last.ckpt equal; launches {got} ({val_batches[0]} validation batches), K2 "
              f"{k2_rows} in a validation forward by the profiler; train step on {card}: p50 "
              f"{steps['p50_s'] * 1e3:.2f} ms, mean {steps['mean_s'] * 1e3:.2f} ms over {steps['steps']} steps "
              f"(StepTimer, synchronised; the first step's warm-up included)")
        swa_out = dict(lrs=lrs, swa_n=trainer.swa_n, mean_err=mean_err, steps=steps, k2_profiler=k2_rows,
                       val_batches=val_batches[0])
        del model, trainer, fresh, train_gen, dev_gen, aside

        # ---- the profiled classify: EQTransformer on the bench stream, batch 256
        data = bench_stream_array(seed=0)
        kw = dict(overlap=5500, blinding=(500, 500), batch_size=256)
        model = load_model("eqtransformer", seed=0, device=dev)
        picker = WaveformPicker(model, device=dev)
        picker.classify_arrays(data, eqt_thresholds, **kw)
        log_dir = os.path.join(tmp, "trace")
        zero_counts()
        with trace(log_dir):
            picker.classify_arrays(data, eqt_thresholds, **kw)
            torch.cuda.synchronize()
        launches["eqtransformer/traced classify"] = got = read_counts()
        if got != eqt_launches:
            fail(f"profiling: launches {got} under trace(), want phase 4's {eqt_launches}")
        planes = summarize_trace(log_dir, top=10**6)
        card_planes = [name for name in planes if "GPU" in name]
        if len(card_planes) != 1:
            fail(f"profiling: planes {list(planes)}, want one of the card")
        rows = planes[card_planes[0]]
        seen = {kn: sum(r["count"] for r in rows if f"{kn}_kernel" in r["name"])
                for kn in ("lstm_multi", "trigger_extract")}
        if seen != {kn: got[kn] for kn in seen}:
            fail(f"profiling: the card plane counts {seen}, the launch counters {got}")
        peak = device_memory_stats()[str(dev)]["allocated_bytes.all.peak"]
        timer = StepTimer(device=dev)
        for _ in range(5):
            with timer:
                picker.classify_arrays(data, eqt_thresholds, **kw)
        classify = timer.summary()
        print(f"profiling: trace() around one classify_arrays (EQTransformer, bench stream, batch 256) -> "
              f"planes {list(planes)}; {card_planes[0]} counts {seen} = the launch counters; its top rows: "
              + "; ".join(f"{r['name'][:60]} {r['total_ms']} ms x {r['count']}" for r in rows[:5])
              + f"; device_memory_stats() peak {peak} bytes; StepTimer(device) over 5 classify_arrays on "
              f"{card}: p50 {classify['p50_s'] * 1e3:.2f} ms, mean {classify['mean_s'] * 1e3:.2f} ms")
        prof_out = dict(planes=list(planes), card_counts=seen, top=rows[:5], peak_bytes=peak, classify=classify)
        del picker

        # ---- picks_from_prob_numpy against K1 on phase 3's curves, thresholds (t, t / 2)
        prob, t1, t2 = trig_inputs
        k1 = [a.cpu().numpy() for a in cuda_trig.trigger_extract(prob, t1, t2, TRIG_K)]
        rows_np, t1_np, t2_np = prob.cpu().numpy(), t1.cpu().numpy(), t2.cpu().numpy()
        checked = n_picks = 0
        for i in range(rows_np.shape[0]):
            pk, val = picks_from_prob_numpy(rows_np[i], float(t1_np[i]), float(t2_np[i]))
            if len(pk) >= TRIG_K:
                continue
            valid = k1[2][i].astype(bool)
            if not (np.array_equal(k1[0][i][valid].astype(np.int64), pk)
                    and np.array_equal(k1[1][i][valid].astype(np.float64), val)):
                fail(f"oracle: K1's picks of row {i} are not picks_from_prob_numpy's")
            checked += 1
            n_picks += len(pk)
        if checked < rows_np.shape[0] // 2:
            fail(f"oracle: only {checked} rows of {rows_np.shape[0]} have fewer than {TRIG_K} picks")
        print(f"oracle: K1 at ({rows_np.shape[0]}, {rows_np.shape[1]}), thresholds (t, t/2): its valid "
              f"(peak_idx, peak_val) equal picks_from_prob_numpy's on all {checked} rows with fewer than "
              f"{TRIG_K} runs ({n_picks} picks)")

        # ---- prediction examples and the QC screen on synthetic traces
        idx = np.r_[np.where(event)[0][:QC_EVENTS], np.where(~event)[0][:QC_NOISE]]
        ds = synthetic_dataset(waves[idx], [meta[i] for i in idx])
        cpu_model = load_model("eqtransformer", device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
        shown = [0, 1, QC_EVENTS, QC_EVENTS + 1]
        p_all, s_all = _onset_arrays(ds.metadata)

        def panel_curves(m_, d_):
            """The curves each panel draws: read from the figures, or where
            matplotlib is not installed from the arrays the panels would draw."""
            if have_mpl:
                return [{ln.get_label(): np.asarray(ln.get_ydata()) for ln in fig.axes[3].get_lines()
                         if not ln.get_label().startswith("_")}
                        for fig in plotting.plot_prediction_examples(m_, ds, shown, device=d_)]
            return [plotting._prediction_arrays(m_, ds.get_sample(i)[0], p_all[i], s_all[i], torch.device(d_))[1]
                    for i in shown]

        zero_counts()
        curves_card = panel_curves(model, dev)
        launches["eqtransformer/prediction examples"] = got = read_counts()
        curves_cpu = panel_curves(cpu_model, "cpu")
        plot_err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(curves_card, curves_cpu) for k in a)
        want = dict.fromkeys(got, 0)
        want.update(lstm_multi=4 * len(shown), convpool=7 * len(shown))
        if got != want or not plot_err <= PLOT_TOL:
            fail(f"plot: launches {got} (want {want}); card curves {plot_err} from the CPU's (tol {PLOT_TOL})")
        drawn = ("drawn by plot_prediction_examples" if have_mpl else
                 "figures not drawn: matplotlib is not installed on this machine; _prediction_arrays' arrays held")
        print(f"plot: prediction examples of {len(shown)} traces ({drawn}): curves on the card within "
              f"{plot_err:.2e} of device='cpu' (tol {PLOT_TOL}); launches {got}")

        # QC: each head's logit on these traces stretched so that its median sits
        # at -5 and its 99.9th percentile at 0 (the rule of tests/torch_heads.py;
        # 4c's stretch saturates every trace's largest probability at 1 here); the
        # threshold in the widest gap between the traces' largest P/S probabilities
        picker = WaveformPicker(model, device=dev)
        window = model.in_samples
        starts = torch.as_tensor(window_starts(waves.shape[-1], window, window // 2))
        with inference_work(dev):
            fr = frame_windows(torch.as_tensor(waves[idx], device=dev), starts, window)
            heads = model(picker._condition(fr.reshape(-1, 3, window)))
        with torch.no_grad():
            for head, pr in zip([model.conv_d] + list(model.pick_convs), heads):
                pr = pr.double().cpu().numpy()
                mid_, top_ = np.percentile(np.log(pr / (1 - pr)), [50, 99.9])
                a = 5.0 / float(top_ - mid_)
                head.bias.copy_((head.bias - float(mid_)) * a - 5.0)
                head.weight.mul_(a)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
        sos = butter(4, (1.0, 20.0), btype="bandpass", fs=SR, output="sos")
        largest = np.zeros(len(idx))
        for x in (waves[idx], sosfilt(sos, waves[idx], axis=-1)):
            with inference_work(dev):
                fr = frame_windows(torch.as_tensor(np.asarray(x, np.float32), device=dev), starts, window)
                n, b = fr.shape[:2]
                pr = picker._apply_model(picker._condition(fr.reshape(n * b, 3, window))).cpu().numpy()
            ps = [i for i, lab in enumerate(picker._prob_channels()) if lab in ("P", "S")]
            largest = np.maximum(largest, pr[:, ps].max(axis=(1, 2)).reshape(n, b).max(0))
        srt = np.sort(largest)
        k = int(np.argmax(np.diff(srt)))
        thr = float((srt[k] + srt[k + 1]) / 2)
        if not srt[k + 1] - srt[k] > QC_GAP:
            fail(f"qc: the widest gap between the traces' largest probabilities is {srt[k + 1] - srt[k]}")
        zero_counts()
        flags = qc.screen_dataset_with_models(ds, [picker], threshold=thr, out_dir=os.path.join(tmp, "qc"),
                                              plot_flagged=have_mpl)
        launches["eqtransformer/qc"] = got = read_counts()
        cpu_flags = qc.screen_dataset_with_models(ds, [WaveformPicker(cpu_model, device="cpu")], threshold=thr)
        if not np.array_equal(flags, cpu_flags) or not 0 < flags.sum() < len(flags) or not got["lstm_multi"] > 0:
            fail(f"qc: card flags {flags.astype(int)} against the CPU's {cpu_flags.astype(int)}; launches {got}")
        n_png = len([f_ for f_ in os.listdir(os.path.join(tmp, "qc")) if f_.startswith("flagged_")])
        print(f"qc: screen_dataset_with_models over {len(ds)} synthetic traces at threshold {thr:.4f} (the "
              f"middle of a {srt[k + 1] - srt[k]:.4f} gap): {int(flags.sum())} flagged, equal to the CPU port's; "
              f"plot_flagged={have_mpl}, {n_png} figures; launches {got}")
        seconds = time.perf_counter() - t_phase
        print(f"train and inspect: the phase took {seconds:.1f} s")
        return dict(launches=launches, swa=swa_out, profiling=prof_out, oracle_rows=checked,
                    oracle_picks=n_picks, plot_err=plot_err, matplotlib=have_mpl, qc_flagged=int(flags.sum()),
                    qc_traces=len(ds), seconds=seconds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _jma_hypo_line(t: "UTC", lat=34.5, lon=139.2, dep_km=8.5, mag=2.3, etype="5") -> str:
    """A JMA deck hypocenter record (the line builder of tests/test_jma.py,
    copied: an installed `tests` package shadows the repo's on the card
    machine)."""
    d = t.datetime
    sec = d.second + d.microsecond / 1e6
    s = "J" + f"{d.year:04d}{d.month:02d}{d.day:02d}{d.hour:02d}{d.minute:02d}{int(sec):02d}"
    s += f"{int(round(sec % 1 * 100)):02d}"
    s = s.ljust(21)[:21]
    s += f"{int(lat):3d}{int(round((lat - int(lat)) * 60 * 100)):4d}"
    s = s.ljust(32)[:32]
    s += f"{int(lon):4d}{int(round((lon - int(lon)) * 60 * 100)):4d}"
    s = s.ljust(44)[:44]
    s += f"{int(round(dep_km * 100)):5d}"
    s = s.ljust(52)[:52]
    s += f"{int(round(mag * 10)):2d}V"
    s = s.ljust(60)[:60] + etype
    return s.ljust(96)[:96]


def _jma_arrival_line(sta: str, p: "UTC", s_: "UTC") -> str:
    """A JMA deck arrival record with a P and an S time in the same hour
    (the line builder of tests/test_jma.py, copied)."""
    dp, ds = p.datetime, s_.datetime
    psec, ssec = dp.second + dp.microsecond / 1e6, ds.second + ds.microsecond / 1e6
    s = ("_" + sta.ljust(6)[:6]).ljust(13)[:13]
    s += f"{dp.day:2d}" + "IP".ljust(4)
    s += f"{dp.hour:02d}{dp.minute:02d}{int(psec):02d}{int(round(psec % 1 * 100)):02d}"
    s += "ES".ljust(4)
    s += f"{ds.minute:02d}{int(ssec):02d}{int(round(ssec % 1 * 100)):02d}"
    s = s.ljust(87)[:87] + f"{dp.year % 100:02d}{dp.month:02d}" + "18"
    return s.ljust(96)[:96]


def archive_phase(dev, card, zero_counts, read_counts, data, t_start, model, thresholds) -> dict:
    """Phase 11: an archive to picks on the port alone. The bench stream,
    quantised to integer counts, is written as a Hi-net event (stations
    0-3: a WIN32 archive and its channel table, zipped, served through
    HinetSession over a fake wire) and as two SAC event folders (stations
    4-7, one with upper-case names and .PICK sidecars, under a directory
    named *_sac_*); a JMA deck lists the stream's onsets at stations 0-3.
    The WIN32 archive goes to miniSEED through convert_win32_event_dirs on
    the catalog's table, the SAC folders through convert_sac_to_mseed in two
    spawn workers; every converted file must read back as the quantised
    array, from the sidecar's start time; `python -m volpick_tpu_torch pick`
    on the 8 files (phase 9's model) must launch K1 once and K2 4 times a
    forward and write exactly classify()'s rows on the in-memory arrays.
    Where h5py is installed, the three dataset writers also run."""
    import csv
    import io
    import shutil
    import tempfile
    import zipfile
    from datetime import datetime
    from pathlib import Path

    import pandas as pd

    from volpick_tpu_torch import __main__ as cli
    from volpick_tpu_torch.acquisition import convert as acq_convert
    from volpick_tpu_torch.acquisition.hinet import convert_win32_event_dirs
    from volpick_tpu_torch.acquisition.hinet_net import HinetEvent, HinetSession
    from volpick_tpu_torch.acquisition.jma import read_jma_catalog
    from volpick_tpu_torch.acquisition.sac_convert import (
        convert_sac_to_mseed, read_sac_with_sidecar, read_sidecar_info)
    from volpick_tpu_torch.core.sacio import write_sac
    from volpick_tpu_torch.io import read_mseed
    from volpick_tpu_torch.io.win32 import write_win32
    from volpick_tpu_torch.models.eqtransformer import EQTransformer
    from volpick_tpu_torch.ops.windows import window_starts
    from volpick_tpu_torch.picker import UTC, Stream, Trace, WaveformPicker
    from volpick_tpu_torch.picker.stage_times import SR
    from volpick_tpu_torch.train.model_io import export_pretrained

    stations, _, n = data.shape
    hinet_st, sac_st = range(stations // 2), range(stations // 2, stations)
    overlap, blinding, batch = 5500, (500, 500), 256
    counts = np.round(data.astype(np.float64) * ARCHIVE_SCALE)
    if not np.abs(counts).max() < 2 ** 24:  # exact in float32 (SAC, miniSEED), inside WIN32's int32
        fail(f"archive: counts up to {np.abs(counts).max()} at scale {ARCHIVE_SCALE}")
    counts32 = counts.astype(np.float32)
    sta = [f"S{s_:02d}" for s_ in range(stations)]
    # where each station's traces come from: (network, channel of component ci)
    ident = {s_: ("N", "ZNE") if s_ in hinet_st else ("HV", ("HHZ", "HHN", "HHE")) for s_ in range(stations)}
    # (P, S) of stations 0-3 in each of stage_times.bench_stream_array's two events
    onsets = [[(t_start + first + step * s_, t_start + first + step * s_ + 4.0) for s_ in hinet_st]
              for first, step in ((100.0, 97), (380.0, 41))]
    tmp = tempfile.mkdtemp(prefix="volpick_archive_")
    saved_models = os.environ.get("VOLPICK_TPU_MODELS")
    step_s = {}
    try:
        root = Path(tmp)
        # ---- catalog: a JMA deck with the onsets at stations 0-3
        t0 = time.perf_counter()
        deck = root / "jma_deck.txt"
        with open(deck, "w") as f:
            for e, picks in enumerate(onsets):
                f.write(_jma_hypo_line(picks[0][0] - 5.0) + "\n")
                for s_, (p_t, s_t) in zip(hinet_st, picks):
                    f.write(_jma_arrival_line(sta[s_], p_t, s_t) + "\n")
                f.write("E\n")
        cat, skipped = read_jma_catalog(deck)
        got_picks = [[(p_.station, p_.phase, p_.time.timestamp) for p_ in ev.picks] for ev in cat.events]
        want_picks = [[(sta[s_], ph, t.timestamp) for s_, pair in zip(hinet_st, picks) for ph, t in zip("PS", pair)]
                      for picks in onsets]
        if skipped or got_picks != want_picks:
            fail(f"archive: the JMA deck read back as {got_picks} (skipped {skipped}), want {want_picks}")
        # JMA arrival records carry no weights, and the per-station table
        # averages by weight: the station rows take their times from the
        # per-pick table
        per_pick = cat.to_dataframe(by_station=False)
        table = cat.to_dataframe().drop(columns=["trace_p_arrival_time", "trace_s_arrival_time"]).merge(
            per_pick.groupby(["source_id", "station_code"], as_index=False)[
                ["trace_p_arrival_time", "trace_s_arrival_time"]].first(), on=["source_id", "station_code"])
        times = table[["trace_p_arrival_time", "trace_s_arrival_time"]]
        if len(table) != 2 * len(hinet_st) or times.isna().any().any():
            fail(f"archive: the catalog's table has {len(table)} rows with times {times.values.tolist()}")
        step_s["catalog"] = time.perf_counter() - t0

        # ---- Hi-net: stations 0-3 as one event, zipped, through the session's wire
        t0 = time.perf_counter()
        origin = cat.events[0].origin.time
        trs, chan_ids, table_lines = [], {}, []
        for s_ in hinet_st:
            for ci, comp in enumerate("UNE"):
                tr = Trace(counts[s_, ci], dict(network="N", station=sta[s_], channel=comp, sampling_rate=SR,
                                                starttime=t_start))
                chan_ids[tr.id] = 0x200 + 3 * s_ + ci
                table_lines.append(f"{0x200 + 3 * s_ + ci:04X} 1 0 {sta[s_]} {comp} 1 27 1.0 m/s 1.0 0.7 0.0 1.0")
                trs.append(tr)
        write_win32(Stream(trs), root / "event.cnt", chan_ids=chan_ids)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("event/event.cnt", (root / "event.cnt").read_bytes())
            zf.writestr("event/event.ch", "\n".join(table_lines))
        blob = buf.getvalue()
        ev_origin = origin.datetime.replace(tzinfo=None)

        class FakeWire:
            """The portal's four calls over the one event (tests/test_hinet_net.py's fake, copied)."""

            def __init__(self):
                self.calls = []

            def login(self):
                self.calls.append("login")

            def search_events(self, day, **kwargs):
                self.calls.append(("search", day))
                return [HinetEvent(ev_origin, 34.5, 139.2, 8.5, cat.events[0].magnitude.mag)] \
                    if day == ev_origin.date() else []

            def request_event(self, event, span_minutes):
                self.calls.append(("request", event.origin))
                return event.origin.strftime("%Y%m%d%H%M%S")

            def download_event(self, request_id):
                self.calls.append(("download", request_id))
                return blob

        wire = FakeWire()
        dirs = HinetSession(wire, root / "hinet", span_minutes=20).get_event_waveform(
            datetime.combine(ev_origin.date(), datetime.min.time()), ev_origin.replace(hour=23),
            minmagnitude=cat.events[0].magnitude.mag)
        if [d.name for d in dirs] != [ev_origin.strftime("%Y%m%d%H%M%S")] or not (dirs[0] / "event.cnt").exists():
            fail(f"archive: the Hi-net session extracted {dirs} (wire calls {wire.calls})")
        step_s["wire and extract"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        hinet_rows = table[table["source_id"] == cat.events[0].event_id].assign(source_id=dirs[0].name)
        log = convert_win32_event_dirs(root / "hinet", hinet_rows, cut_pre_s=CUT_PRE_S, cut_post_s=CUT_POST_S)
        if len(log) != len(hinet_st) or not (log["error"] == "").all() or not (log["n_components"] == 3).all():
            fail(f"archive: convert_win32_event_dirs logged {log.to_dict('records')}")
        files = {s_: root / "hinet" / "mseed" / f"{dirs[0].name}_N.{sta[s_]}.mseed" for s_ in hinet_st}
        step_s["WIN32 convert"] = time.perf_counter() - t0

        # ---- SAC: stations 4-7 as two event folders, one in upper case
        t0 = time.perf_counter()
        d0 = t_start.datetime
        sidecar = (f"start_time: {d0.year} {d0.month} {d0.day} {d0.hour} {d0.minute} "
                   f"{d0.second + d0.microsecond / 1e6:.2f}\n")
        folders, sources = [root / "hvo_sac_archive" / "ev_lower", root / "hvo_sac_archive" / "ev_upper"], []
        for k, s_ in enumerate(sac_st):
            folder, upper = folders[k * 2 // len(sac_st)], k * 2 >= len(sac_st)
            folder.mkdir(parents=True, exist_ok=True)
            for ci, cha in enumerate(ident[s_][1]):
                stem = folder / f"{sta[s_].lower()}_{cha[-1].lower()}"
                path = stem.with_suffix(".SAC" if upper else ".sac")
                write_sac(Trace(counts32[s_, ci], dict(network="HV", station=sta[s_], channel=cha,
                                                       sampling_rate=SR, starttime=t_start)), path)
                path.with_suffix(".PICK" if upper else ".pick").write_text(sidecar)
                sources.append(path)
        log = convert_sac_to_mseed(folders, root / "sac_mseed", num_processes=2)
        if len(log) != len(sac_st) or not (log["error"].fillna("") == "").all():
            fail(f"archive: convert_sac_to_mseed logged {log.to_dict('records')}")
        for k, s_ in enumerate(sac_st):
            files[s_] = root / "sac_mseed" / folders[k * 2 // len(sac_st)].name / f"HV.{sta[s_]}..mseed"
        step_s["SAC convert"] = time.perf_counter() - t0

        # ---- every file read back exactly, from the sidecar's start time
        t0 = time.perf_counter()
        side = read_sidecar_info(sources[0].with_suffix(".pick"))["start_time"]
        side_t = UTC(f"{side[0]}-{int(side[1]):02d}-{int(side[2]):02d}T{int(side[3]):02d}:{int(side[4]):02d}:00") \
            + float(side[5])
        for path in sources:  # the sidecar is found beside either case, under a *_sac_* directory
            got = read_sac_with_sidecar(path, t_offset=1.0).stats.starttime.timestamp
            if got != side_t.timestamp + 1.0:
                fail(f"archive: read_sac_with_sidecar({path.name}, t_offset=1) starts at {got}, want "
                     f"{side_t.timestamp + 1.0}")
        mem = Stream()
        for s_ in range(stations):
            st = read_mseed(files[s_])
            start, arr, complete = acq_convert.stream_to_array(st, "ZNE")
            want = counts[s_].copy()
            want -= want.mean(axis=1, keepdims=True)
            net, chans = ident[s_]
            if (start.timestamp != side_t.timestamp or complete != 1.0 or not np.array_equal(arr, want)
                    or sorted(tr.id for tr in st) != sorted(f"{net}.{sta[s_]}..{c}" for c in chans)
                    or not all(np.array_equal(tr.data, counts32[s_, list(chans).index(tr.stats.channel)])
                               for tr in st)):
                fail(f"archive: {files[s_].name} read back is not the quantised array of station {s_} "
                     f"from {side_t} (start {start}, completeness {complete})")
            for ci, cha in enumerate(chans):
                mem.append(Trace(counts32[s_, ci].copy(), dict(network=net, station=sta[s_], channel=cha,
                                                               sampling_rate=SR, starttime=t_start)))
        step_s["read back"] = time.perf_counter() - t0
        file_mb = sum(p_.stat().st_size for p_ in files.values()) / 1e6

        # ---- python -m volpick_tpu_torch pick on the 8 files, phase 9's model
        export_pretrained(model, root / "models", name="smoke", default_args={
            "detection_threshold": thresholds["Detection"], "P_threshold": thresholds["P"],
            "S_threshold": thresholds["S"]})
        os.environ["VOLPICK_TPU_MODELS"] = str(root / "models")
        forwards = [0]

        def count(mod, *_):
            forwards[0] += isinstance(mod, EQTransformer)

        out_csv = root / "picks.csv"
        handle = torch.nn.modules.module.register_module_forward_hook(count)
        zero_counts()
        t0 = time.perf_counter()
        try:
            cli.main(["pick", *[str(files[s_]) for s_ in range(stations)], "--weights", "smoke",
                      "--overlap", str(overlap), "--output", str(out_csv), "--device", str(dev)])
            torch.cuda.synchronize()
            step_s["pick"] = time.perf_counter() - t0
            launches = read_counts()
        finally:
            handle.remove()
        want = dict.fromkeys(launches, 0)
        want.update(trigger_extract=1, lstm_multi=4 * forwards[0], convpool=7 * forwards[0])
        if forwards[0] < 1 or launches != want:
            fail(f"archive: pick launches {launches}, want {want} ({forwards[0]} forwards)")
        with open(out_csv, newline="") as f:
            rows = list(csv.reader(f))
        n_windows = stations * len(window_starts(n, model.in_samples, overlap))
        ref = WaveformPicker(model, device=dev).classify(
            mem, P_threshold=thresholds["P"], S_threshold=thresholds["S"],
            detection_threshold=thresholds["Detection"], overlap=overlap, blinding=blinding, batch_size=batch)
        ref_rows = [[p_.trace_id, p_.phase, p_.peak_time.isoformat(), f"{p_.peak_value:.4f}",
                     p_.start_time.isoformat(), p_.end_time.isoformat()] for p_ in ref.picks]
        if len(rows) < 2 or rows[1:] != ref_rows:
            fail(f"archive: the pick CSV's {len(rows) - 1} rows are not classify()'s {len(ref_rows)} on the "
                 f"quantised arrays")

        # ---- the dataset writers, where h5py is installed
        try:
            import h5py  # noqa: F401
            have_h5py = True
        except ImportError:
            have_h5py = False
        datasets = {}
        if have_h5py:
            datasets = _archive_datasets(root, hinet_rows, files, sta, hinet_st, sac_st)
        print("archive: " + (f"h5py installed: the dataset writers wrote {datasets} traces" if have_h5py else
                             "no h5py: convert_catalog_to_dataset, extract_noise_from_dataset and "
                             "convert_from_old_format not run (the CPU tests hold them)"))
        print(f"archive on {card}: {stations} stations x 3 x {n} samples at {ARCHIVE_SCALE:g} counts a unit; "
              f"{len(cat)} JMA events, {len(files)} miniSEED files ({len(hinet_st)} from WIN32, {len(sac_st)} "
              f"from SAC) of {file_mb:.1f} MB read back exactly; pick: {len(rows) - 1} picks over {n_windows} "
              f"windows, equal to classify(), {forwards[0]} forwards, launches {launches}; host-clock s: "
              + ", ".join(f"{k} {v:.3f}" for k, v in step_s.items()))
        return dict(launches=launches, seconds=step_s, file_mb=file_mb, picks=len(rows) - 1, windows=n_windows,
                    forwards=forwards[0], h5py=have_h5py, datasets=datasets)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_models is None:
            os.environ.pop("VOLPICK_TPU_MODELS", None)
        else:
            os.environ["VOLPICK_TPU_MODELS"] = saved_models


def _archive_datasets(root, hinet_rows, files, sta, hinet_st, sac_st) -> dict:
    """Phase 11's dataset writers, where h5py is installed: the converted
    files through convert_catalog_to_dataset (the catalog's stations with
    their picks, the SAC stations outside the catalog as noise rows), its
    noise rows through extract_noise_from_dataset, and the Hi-net files as
    one event folder through convert_from_old_format. Each written waveform
    must equal what the writer was given, and the sample indices the picks."""
    import shutil

    import pandas as pd

    from volpick_tpu_torch.acquisition import convert as acq_convert
    from volpick_tpu_torch.data.dataset import WaveformDataset
    from volpick_tpu_torch.io import read_mseed
    from volpick_tpu_torch.picker import UTC
    from volpick_tpu_torch.picker.stage_times import SR

    by_name = {p_.stem: p_ for p_ in files.values()}
    rows = hinet_rows.assign(trace_name=[files[s_].stem for s_ in hinet_st]).to_dict("records")
    rows += [{"source_id": f"noise_{sta[s_]}", "source_type": "noise", "station_network_code": "HV",
              "station_code": sta[s_], "trace_name": files[s_].stem} for s_ in sac_st]
    acq_convert.convert_catalog_to_dataset(pd.DataFrame(rows), lambda name: read_mseed(by_name[name]),
                                           root / "dataset", seed=0)
    ds = WaveformDataset(root / "dataset")
    if len(ds) != len(rows):
        fail(f"archive: convert_catalog_to_dataset wrote {len(ds)} traces of {len(rows)}")
    for i, row in enumerate(rows):
        st = read_mseed(by_name[row["trace_name"]])
        for tr in st:
            tr.detrend_demean()
        start, want, _ = acq_convert.stream_to_array(st, "ZNE")
        got = ds.get_waveforms(i)
        p_at = row.get("trace_p_arrival_time")
        p_want = int((UTC(p_at) - start) * SR) if isinstance(p_at, str) else None
        p_got = ds.metadata["trace_p_arrival_sample"].iloc[i]
        if not np.array_equal(got, want.astype(got.dtype)) or (p_want is None) != pd.isna(p_got) \
                or (p_want is not None and int(p_got) != p_want):
            fail(f"archive: convert_catalog_to_dataset's trace {i} is not its file's (P sample {p_got}, "
                 f"want {p_want})")
    noise = acq_convert.extract_noise_from_dataset(ds, root / "noise", n_traces=len(sac_st), seed=0)
    nds = WaveformDataset(noise)
    pool = [ds.get_waveforms(i) for i in range(len(rows)) if rows[i]["source_type"] == "noise"]
    if len(nds) != len(sac_st) or not all(any(np.array_equal(nds.get_waveforms(i), w) for w in pool)
                                          for i in range(len(nds))):
        fail(f"archive: extract_noise_from_dataset wrote {len(nds)} traces, want the {len(sac_st)} noise rows")
    ev = root / "old" / "ev0"
    ev.mkdir(parents=True)
    pd.DataFrame([{"event_id": "ev0", "origin_time": hinet_rows["source_origin_time"].iloc[0],
                   "hypo_lat": 34.5, "hypo_lon": 139.2, "hypo_depth": 8.5, "magnitude": 2.3,
                   "event_type": "lp"}]).to_csv(ev / "event_info.csv")
    picks = {}
    for s_, (_, row) in zip(hinet_st, hinet_rows.iterrows()):
        shutil.copy(files[s_], ev / files[s_].name)
        picks[files[s_].name] = {"network": "N", "station": sta[s_], "instrument": "", "latitude": 35.0,
                                 "longitude": 139.0, "elevation_m": 0.0, "p_time": row["trace_p_arrival_time"],
                                 "s_time": row["trace_s_arrival_time"], "first_motion": None}
    pd.DataFrame.from_dict(picks, orient="index").to_csv(ev / "picks.csv")
    acq_convert.convert_from_old_format(root / "old", root / "old_ds", seed=0)
    ods = WaveformDataset(root / "old_ds")
    if len(ods) != len(hinet_st):
        fail(f"archive: convert_from_old_format wrote {len(ods)} traces, want {len(hinet_st)}")
    for i, (name, pick) in enumerate(picks.items()):
        start, want, _ = acq_convert.stream_to_array(read_mseed(ev / name), "ZNE")
        got = ods.get_waveforms(i)
        if not np.array_equal(got, want.astype(got.dtype)) or \
                int(ods.metadata["trace_p_arrival_sample"].iloc[i]) != int((UTC(pick["p_time"]) - start) * SR):
            fail(f"archive: convert_from_old_format's trace {i} is not {name}'s")
    return {"convert_catalog_to_dataset": len(ds), "extract_noise_from_dataset": len(nds),
            "convert_from_old_format": len(ods)}


def mesh_phase(dev, card, waves, meta, data) -> dict:
    """Phase 12: the multi-GPU layer through its entry points, in ranks that
    are child processes (``scripts/mesh_ranks.py``, which imports nothing of
    this file). (a) NCCL over every card of the machine, each rank on its
    own; (b) gloo, two ranks both on cuda:0 (NCCL refuses two ranks on one
    card). Each rank fits EQTransformer at full width with the training
    config (EMA, drop_rate 0.1) for one epoch of MESH_STEPS global batches of
    MESH_BATCH rows and one validation pass through ``Trainer.fit`` on the
    world's mesh, takes MESH64_STEPS steps of the same model in float64 on
    global batches of MESH64_BATCH rows, and classifies the bench stream
    through ``WaveformPicker(mesh=)`` (its share of the stations). Meanwhile
    this process runs the same fit, steps and classify on one device.

    The float64 steps check the mechanism (global BatchNorm, dropout at the
    global shape, the gradients' all-reduce): losses within MESH64_LOSS_RTOL
    and parameters, EMA and BatchNorm statistics within MESH64_ATOL of one
    process. The float32 fit checks its losses to MESH_LOSS_RTOL; its
    parameters and EMA are held only to a sanity limit, the distance Adam
    lets two float32 runs drift apart whatever their gradients
    (``adam_bound``; BatchNorm statistics that plus MESH_STAT_RTOL of their
    size). Fails unless those hold, the ranks of a world hold the same
    tensors bit for bit, only rank 0 wrote the fit's files, every rank's
    picks equal the one-device picks exactly, and every rank launched K1
    once and K2 its share of the one-device launches (forwards of its
    stations: the one device's over the world size). Prints each rank's
    launches and host seconds."""
    import importlib.util
    import shutil
    import socket
    import subprocess
    import tempfile
    from pathlib import Path

    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.picker import WaveformPicker

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "mesh_ranks.py")
    spec = importlib.util.spec_from_file_location("mesh_ranks", script)
    ranks_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks_mod)
    t_phase = time.perf_counter()
    io = Path(tempfile.mkdtemp(prefix="volpick_mesh_"))
    procs = []
    try:
        np.save(io / "pool.npy", waves)
        np.savez(io / "pool_meta.npz",
                 p=np.array([m["trace_p_arrival_sample"] for m in meta], np.float32),
                 s=np.array([m["trace_s_arrival_sample"] for m in meta], np.float32),
                 is_lp=np.array([m["source_type"] == "lp" for m in meta], np.float32),
                 is_dev=np.array([m["split"] == "dev" for m in meta]))
        (io / "spec.json").write_text(json.dumps({"batch": MESH_BATCH, "train_traces": MESH_STEPS * MESH_BATCH,
                                                  "batch64": MESH64_BATCH, "steps64": MESH64_STEPS}))
        np.save(io / "stream.npy", data)
        # the classify model: seeded, heads stretched on its own curves (4c)
        model = load_model("eqtransformer", seed=0, device=dev)
        picker = WaveformPicker(model, device=dev)
        kw = dict(overlap=5500, blinding=(500, 500), batch_size=256)
        flat = picker.annotate_array(data, **kw)
        stretch_heads(model, [flat[:, ki, 500:-500] for ki in range(3)])
        curves = picker.annotate_array(data, **kw)
        thr = {lab: float(np.percentile(curves[:, i], 99.9)) for i, lab in enumerate(picker._prob_channels())}
        torch.save({"state": {k: v.cpu() for k, v in model.state_dict().items()}, "thresholds": thr},
                   io / "classify.pt")
        del model, picker
        t_inputs = time.perf_counter() - t_phase

        worlds = {"nccl": (torch.cuda.device_count(), lambda r: f"cuda:{r}"), "gloo": (2, lambda r: "cuda:0")}
        for tag, (world, device_of) in worlds.items():
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            for r in range(world):
                log = open(io / f"{tag}_{r}.log", "w")
                env = dict(os.environ, LOCAL_RANK=str(r), PYTHONPATH=here)
                procs.append((tag, r, log, subprocess.Popen(
                    [sys.executable, script, str(io), tag, tag, str(r), str(world), str(port), device_of(r)],
                    cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)))
        # the one-process runs, while the ranks start
        ref = dict(ranks_mod.fit(io, dev, None, save_dir=io / "weights_one"), **ranks_mod.steps64(io, dev, None),
                   **ranks_mod.classify(io, dev, None))
        deadline = time.monotonic() + MESH_TIMEOUT
        for tag, r, log, p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"mesh: {tag} rank {r} still running after {MESH_TIMEOUT} s")
            log.close()
            if p.returncode != 0:
                fail(f"mesh: {tag} rank {r} exited {p.returncode}:\n{(io / f'{tag}_{r}.log').read_text()[-4000:]}")
        phase_s = time.perf_counter() - t_phase

        bound = adam_bound(ref["lrs"], ref["state"])
        summary = {"phase_s": phase_s, "inputs_s": t_inputs, "one_process": {
            "fit_s": ref["fit_s"], "steps64_s": ref["steps64_s"], "classify_s": ref["classify_s"],
            "launches": ref["launches"]}, "param_bound": bound}
        for tag, (world, _) in worlds.items():
            outs = [torch.load(io / f"{tag}_{r}.pt", weights_only=False) for r in range(world)]
            rows = (io / f"weights_{tag}" / "mesh" / "metrics.csv").read_text().strip().splitlines()
            if len(rows) != 2 or sorted(os.listdir(io / f"weights_{tag}")) != ["mesh"]:
                fail(f"mesh {tag}: rank 0 must write one metrics row, got {rows}")
            worst = {"loss": 0.0, "param": 0.0, "ema": 0.0, "stat": 0.0, "loss64": 0.0, "state64": 0.0}
            for out in outs:
                if len(out["losses"]) != MESH_STEPS or out["lrs"] != ref["lrs"]:
                    fail(f"mesh {tag} rank {out['rank']}: {len(out['losses'])} steps at lrs {out['lrs']}, "
                         f"want {MESH_STEPS} at {ref['lrs']}")
                got = out["losses"] + [out["history"][0]["val_loss"]]
                want = ref["losses"] + [ref["history"][0]["val_loss"]]
                rel = float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))
                worst["loss"] = max(worst["loss"], rel)
                if not rel <= MESH_LOSS_RTOL:
                    fail(f"mesh {tag} rank {out['rank']}: losses {got}, one process {want}")
                for part, key in (("state", "param"), ("ema", "ema")):
                    for name, v in ref[part].items():
                        if not v.is_floating_point():
                            continue
                        d = float((out[part][name] - v).abs().max())
                        stat = "running_" in name
                        lim = bound + (MESH_STAT_RTOL * float(v.abs().max()) if stat else 0.0)
                        which = "stat" if stat else key
                        worst[which] = max(worst[which], d)
                        if not d <= lim:
                            fail(f"mesh {tag} rank {out['rank']}: {part} {name} differs by {d:.3e} > {lim:.3e}")
                rel = float(np.max(np.abs(np.subtract(out["losses64"], ref["losses64"])) / np.abs(ref["losses64"])))
                worst["loss64"] = max(worst["loss64"], rel)
                if len(out["losses64"]) != MESH64_STEPS or not rel <= MESH64_LOSS_RTOL:
                    fail(f"mesh {tag} rank {out['rank']}: float64 losses {out['losses64']}, one process "
                         f"{ref['losses64']}")
                for part in ("state64", "ema64"):
                    for name, v in ref[part].items():
                        if not v.is_floating_point():
                            continue
                        d = float((out[part][name] - v).abs().max())
                        worst["state64"] = max(worst["state64"], d)
                        if not d <= MESH64_ATOL:
                            fail(f"mesh {tag} rank {out['rank']}: float64 {part} {name} differs by {d:.3e} > "
                                 f"{MESH64_ATOL}")
                for label, arrs in ref["picks"].items():
                    for i, a in enumerate(arrs):
                        if not np.array_equal(out["picks"][label][i], a):
                            fail(f"mesh {tag} rank {out['rank']}: picks of {label} (output {i}) differ from the "
                                 f"one-device classify")
                k2 = ref["launches"]["lstm_multi"] // world
                if out["launches"]["trigger_extract"] != 1 or out["launches"]["lstm_multi"] != k2:
                    fail(f"mesh {tag} rank {out['rank']}: launches {out['launches']}, want K1 1 and K2 {k2}")
            for out in outs[1:]:
                for part in ("state", "ema", "state64", "ema64"):
                    if any(not torch.equal(out[part][k], outs[0][part][k]) for k in out[part]):
                        fail(f"mesh {tag}: rank {out['rank']}'s {part} is not rank 0's")
                if out["losses"] != outs[0]["losses"] or out["losses64"] != outs[0]["losses64"]:
                    fail(f"mesh {tag}: rank {out['rank']}'s losses are not rank 0's")
            n_picks = int(sum(v[2].sum() for v in ref["picks"].values()))
            summary[tag] = {"world": world, "worst": worst, "picks": n_picks, "ranks": [
                {k: out[k] for k in ("rank", "device", "join_s", "fit_s", "steps64_s", "classify_s", "total_s",
                                     "launches")}
                for out in outs]}
            print(f"mesh {tag} on {card}: {world} rank(s) x {MESH_BATCH // world} rows of a {MESH_BATCH}-row global "
                  f"batch, {MESH_STEPS} steps + validation, losses {[round(v, 6) for v in outs[0]['losses']]} "
                  f"(largest relative difference to one process {worst['loss']:.2e}), parameters / EMA / BN "
                  f"statistics within {worst['param']:.2e} / {worst['ema']:.2e} / {worst['stat']:.2e} "
                  f"(sanity limit {bound:.2e}); float64, {MESH64_STEPS} steps x {MESH64_BATCH} rows: losses within "
                  f"{worst['loss64']:.2e} relative, parameters / EMA / BN statistics within "
                  f"{worst['state64']:.2e}; classify of {data.shape[0] // world} stations a rank: "
                  f"{n_picks} picks equal to one device's")
            for out in outs:
                print(f"  rank {out['rank']} on {out['device']}: K1 {out['launches']['trigger_extract']}, "
                      f"K2 {out['launches']['lstm_multi']}; host s: join {out['join_s']:.2f}, fit "
                      f"{out['fit_s']:.2f}, float64 steps {out['steps64_s']:.2f}, classify "
                      f"{out['classify_s']:.3f}, whole rank {out['total_s']:.2f}")
        print(f"mesh: one process: fit {ref['fit_s']:.2f} s, float64 steps {ref['steps64_s']:.2f} s, classify "
              f"{ref['classify_s']:.3f} s (K1 "
              f"{ref['launches']['trigger_extract']}, K2 {ref['launches']['lstm_multi']}); inputs "
              f"{t_inputs:.2f} s; the phase took {phase_s:.1f} s")
        return summary
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(io, ignore_errors=True)


def bench_phase(dev, card, zero_counts, read_counts) -> dict:
    """Phase 13: the bench command, in this process and as `python -m
    volpick_tpu_torch bench` (see the module docstring)."""
    import shutil
    import tempfile

    from volpick_tpu_torch import bench
    from volpick_tpu_torch.ops.triggers import trigger_onset_numpy
    from volpick_tpu_torch.picker.stage_times import bench_stream_array

    t_phase = time.perf_counter()
    model, pretrained = bench.load_bench_model(dev)
    data = bench_stream_array(0)
    upload = bench.upload_ms(data, dev)
    kw = dict(overlap=bench.OVERLAP, blinding=bench.BLINDING, batch_size=bench.BATCH)
    out, launches = {}, {}
    for precision in ("float32", "bfloat16"):
        picker = bench.make_picker(model, dev, precision)
        forwards = [0]
        hook = picker._net.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        zero_counts()
        try:
            res = bench.throughput(picker, data, *BENCH_ITERS)
            launches[precision] = got = read_counts()
        finally:
            hook.remove()
        calls = 1 + 2 * sum(BENCH_ITERS)
        want = dict.fromkeys(got, 0)
        want.update(trigger_extract=calls, lstm_multi=4 * forwards[0])
        if precision == "bfloat16":
            want["lstm_multi_bf16"] = 4 * forwards[0]
        else:
            want["convpool"] = 7 * forwards[0]
        if got != want or forwards[0] != BENCH_FORWARDS * calls:
            fail(f"bench {precision}: launches {got}, want {want} ({calls} calls, {forwards[0]} forwards, "
                 f"want {BENCH_FORWARDS} a call)")
        if res.windows != BENCH_WINDOWS or not (np.isfinite(res.windows_per_s) and res.windows_per_s > 0):
            fail(f"bench {precision}: {res.windows} windows a call at {res.windows_per_s} windows/s")
        for lab in ("Detection", "P", "S"):
            if not all(np.array_equal(a, b) for a, b in zip(res.first[lab], res.last[lab])):
                fail(f"bench {precision}: {lab}: the last timed call's pick buffers are not the warm-up's")
        # the oracle's trigger rule on the card's own curves, at the bench's
        # thresholds and at each label's 99.9th percentile
        curves = picker.annotate_array(data, **kw)
        # (the largest value below it: bf16 curves hold runs of equal values)
        near = {}
        for k, lab in enumerate(("Detection", "P", "S")):
            vals = np.unique(curves[:, k])
            near[lab] = float(vals[vals < np.percentile(curves[:, k], 99.9)][-1])
        n_oracle = {}
        for name, thr, got_picks in (("bench", bench.THRESHOLDS, res.last),
                                     ("99.9th percentile", near, bench.classify(picker, data, near))):
            n = 0
            for k, lab in enumerate(("Detection", "P", "S")):
                pk, val, valid, on, off = got_picks[lab]
                t1 = np.float32(thr[lab])
                for si in range(data.shape[0]):
                    row = curves[si, k]
                    rule = [(on_ + int(np.argmax(row[on_ : off_ + 1])), on_, off_)
                            for on_, off_ in trigger_onset_numpy(row, t1, t1 / np.float32(2.0))][: bench.MAX_PICKS]
                    mine = [(int(p_), int(a_), int(b_)) for p_, a_, b_, v_ in zip(pk[si], on[si], off[si], valid[si])
                            if v_]
                    if mine != rule or not np.array_equal(val[si][valid[si]], row[[p_ for p_, _, _ in rule]]):
                        fail(f"bench {precision}: {lab} station {si} at the {name} thresholds: K1 gives "
                             f"{len(mine)} picks, the oracle's rule on the same curves {len(rule)}; not equal")
                    n += len(rule)
                if name != "bench" and not valid.any():
                    fail(f"bench {precision}: no {lab} pick at its 99.9th percentile {thr[lab]}")
            n_oracle[name] = n
        out[precision] = {"windows_per_s": res.windows_per_s, "median_ms": res.median_ms,
                          "n_picks": res.n_picks, "oracle_picks": n_oracle}
        print(f"bench {precision} on {card}: {res.windows_per_s:.2f} windows/s (differenced, {res.windows} "
              f"windows a call), single-call median {res.median_ms:.2f} ms, n_picks {res.n_picks}; "
              f"picks equal to the warm-up's and to the oracle's rule ({n_oracle}); launches {got}")
        del picker

    # ---- the command, from an empty directory, with the bf16 axis on
    tmp = tempfile.mkdtemp(prefix="volpick_bench_")
    try:
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo, BENCH_AXES="1")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "volpick_tpu_torch", "bench"], cwd=tmp, env=env,
                             capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        lines = run.stdout.strip().splitlines()
        print("bench command: " + " | ".join(lines) + f" ({cli_s:.1f} s)")
        if run.returncode != 0 or not lines:
            fail(f"bench command: exit {run.returncode}\n{run.stderr[-3000:]}")
        line = json.loads(lines[-1])
        if (list(line) != ["metric", "value", "unit", "vs_baseline"] or line["metric"] != "eqt_classify_windows_per_s"
                or line["unit"] != "windows/s" or not line["value"] > 0
                or not isinstance(line["vs_baseline"], (int, float))):
            fail(f"bench command: last line {line}\n{run.stderr[-3000:]}")
        cpu = re.search(r"cpu-torch baseline ([0-9.]+) windows/s", run.stdout)
        with open(os.path.join(tmp, "BENCH_AXES.json")) as f:
            axes = json.load(f)
        if sorted(axes) != ["bf16_classify_windows_per_s", "fp32_classify_windows_per_s", "method"] or not (
                axes["bf16_classify_windows_per_s"] > 0):
            fail(f"bench command: BENCH_AXES.json {axes}")
        hidden = subprocess.run([sys.executable, "-m", "volpick_tpu_torch", "bench"], cwd=tmp,
                                env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                                timeout=300)
        if hidden.returncode == 0 or "eqt_classify_windows_per_s" in hidden.stdout:
            fail(f"bench command without a visible card: exit {hidden.returncode}, stdout {hidden.stdout!r}")
        print(f"bench command without a visible card: exit {hidden.returncode}, "
              f"{(hidden.stderr.strip().splitlines() or [''])[-1]!r}, no metric line")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {"card": card, "pretrained": pretrained, "upload_ms": upload, **{
        f"{'fp32' if p_ == 'float32' else 'bf16'}_{k}": v for p_, r in out.items() for k, v in r.items()},
        "cpu_baseline_windows_per_s": float(cpu.group(1)) if cpu else None, "command": line,
        "command_axes": axes, "command_s": cli_s, "phase_s": time.perf_counter() - t_phase}
    return dict(summary=summary, launches=launches)


def adam_bound(lrs, state) -> float:
    """How far two float32 runs of the same Adam steps may leave a parameter
    apart: each moves it by at most ADAM_U_MAX * lr a step, in either
    direction (a gradient near 0 can change sign between summation orders,
    and Adam's first steps are about lr * sign(g)), plus one float32 rounding
    of the largest parameter a step. A sanity limit: any gradient, even one
    of the wrong sign, stays inside it; the float64 steps check gradients."""
    top = max(float(v.abs().max()) for k, v in state.items() if v.is_floating_point() and "running_" not in k)
    return 2 * ADAM_U_MAX * float(sum(lrs)) + len(lrs) * float(np.spacing(np.float32(top)))


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
    from volpick_tpu_torch.ops.cuda import convpool as cuda_convpool
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import rescnn as cuda_rescnn
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.ops.cuda import upconv as cuda_upconv
    from volpick_tpu_torch.ops.signal import condition_windows_from_span
    from volpick_tpu_torch.ops.triggers import extract_triggers_batched, trigger_onset_numpy
    from volpick_tpu_torch.ops.windows import window_starts
    from volpick_tpu_torch.picker import UTC, Stream, StreamingPicker, Trace, WaveformPicker
    from volpick_tpu_torch.picker.stage_times import (
        SR, STATIONS, bench_stream_array, cuda_ms, device_rows, profiled, self_device_us, smi)

    name = torch.cuda.get_device_name(0)
    limit = smi("name,power.limit")
    card = f"{name} ({limit})"
    print(f"device: {name}; nvidia-smi: {limit}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build; beside it, the earlier bf16 designs of K7, K2 and K5
    # (scripts/k7_bf16_simt.cu, k2_bf16_before.cu, k5_bf16_before.cu), timed
    # in phase 3 as yardsticks only
    t0 = time.perf_counter()
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    quiet = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    before_builds = {
        stem: (_build.BUILD_DIR / f"{stem}.so", subprocess.Popen(
            [_build._nvcc(), *quiet, "-shared", "-o", str(_build.BUILD_DIR / f"{stem}.so"),
             os.path.join(scripts, f"{stem}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for stem in ("k7_bf16_simt", "k2_bf16_before", "k5_bf16_before")}
    lib = _build.build()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, one per source in parallel -> {lib.name} "
          f"in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    _build.library()
    # the bf16 bodies of K7, K2 and K5 must run on the tensor cores: HMMA in
    # the SASS of every instantiation
    sass = subprocess.run([os.path.join(os.path.dirname(os.path.realpath(_build._nvcc())), "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    bodies = {  # body -> (mangled-name pattern, instantiations, ops to count)
        "mha_kernel_bf16<tiles, vec>": (r"mha_kernel_bf16ILi(\d+)ELb(\d)E", 16, ("HMMA", "LDSM", "MUFU.EX2")),
        "lstm_multi_kernel_bf16<HP>": (r"lstm_multi_kernel_bf16ILi(\d+)E", 3, ("HMMA", "LDSM", "LDGSTS")),
        "addattn_kernel_bf16<kUP, project>": (r"addattn_kernel_bf16ILi(\d+)ELb(\d)E", 4,
                                              ("HMMA", "LDSM", "MUFU.TANH", "HADD2")),
    }
    for body, (pattern, n_inst, ops) in bodies.items():
        found = {}
        for part in sass.split("Function : ")[1:]:
            tmpl = re.search(pattern, part.split(None, 1)[0])
            if tmpl:
                found["<" + ", ".join(tmpl.groups()) + ">"] = {op: part.count(op) for op in ops}
        if len(found) != n_inst or not all(c["HMMA"] > 0 for c in found.values()):
            fail(f"{body}: not {n_inst} instantiations with HMMA in their SASS: {found}")
        print(f"SASS of the bf16 body {body}: " + "; ".join(f"{k} {c}" for k, c in sorted(found.items())))
    before = {}
    for stem, (so, proc) in before_builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            fail(f"nvcc failed on scripts/{stem}.cu:\n{log}")
        before[stem] = ctypes.CDLL(str(so))
    simt = before["k7_bf16_simt"]
    simt.mha_qkv_bf16_simt.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    simt.mha_bf16_simt.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    k2_before = before["k2_bf16_before"].lstm_recurrence_bf16_before
    k2_before.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 5
                          + [ctypes.c_uint, ctypes.c_void_p])
    k5_before = before["k5_bf16_before"]
    k5_before.addattn_x_bf16_before.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                                + [ctypes.c_float, ctypes.c_void_p])
    k5_before.addattn_bf16_before.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                              + [ctypes.c_float, ctypes.c_void_p])

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

    # ---- 3, K8: upconv_relu at each decoder layer of the full-width EQTransformer
    up_rows, up_err = upconv_rows(dev, rng)
    for r in up_rows:
        print(f"K8 upconv_relu L{r['layer']} (B {r['b']}, I {r['i']}, O {r['o']}, K {r['k']}, T {r['t']}, "
              f"crop {r['crop']}; plan {r['plan']}) on {card}: kernel {r['ms']:.4f} ms (its row under "
              f"torch.profiler), {r['event_ms']:.4f} ms by CUDA events, twin {r['plain_ms']:.4f} ms by CUDA "
              f"events, the cuDNN route's kernels {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['x_bound']:.2f}x); max |d| {r['max_rel_err']:.2e} of the largest output")
    print(f"K8 upconv_relu: a decoder at B {UPCONV_BATCHES[0]}: kernel {sum(r['ms'] for r in up_rows):.4f} ms, "
          f"cuDNN route {sum(r['library_ms'] for r in up_rows):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in up_rows):.4f} ms; every layer at B {UPCONV_BATCHES} within "
          f"{UPCONV_TOL} of its largest output (worst {up_err:.2e})")

    # ---- 3, K9: convpool_relu at each encoder layer of the full-width EQTransformer
    cp_rows, cp_err = convpool_rows(dev, rng)
    for r in cp_rows:
        print(f"K9 convpool_relu L{r['layer']} (B {r['b']}, I {r['i']}, O {r['o']}, K {r['k']}, L {r['l']}; "
              f"plan {r['plan']}) on {card}: kernel {r['ms']:.4f} ms (its row under torch.profiler), "
              f"{r['event_ms']:.4f} ms by CUDA events, the cuDNN route's kernels {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {r['x_bound']:.2f}x); max |d| "
              f"{r['max_rel_err']:.2e} of the largest output")
    for nb in UPCONV_BATCHES:
        enc = [r for r in cp_rows if r["b"] == nb]
        print(f"K9 convpool_relu: an encoder at B {nb}: kernel {sum(r['ms'] for r in enc):.4f} ms, cuDNN route "
              f"{sum(r['library_ms'] for r in enc):.4f} ms, bound {sum(r['bound_ms'] for r in enc):.4f} ms")
    print(f"K9 convpool_relu: every layer at B {UPCONV_BATCHES} within {CONVPOOL_TOL} of its largest output "
          f"(worst {cp_err:.2e})")

    # ---- 3, bf16: the bf16 entries of K2, K5 and K7 at the same shapes
    # against their bf16 twins, each by its stated rule, each timed by its
    # profiler row beside the earlier bf16 design built in step 2
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rows_ms(fn, key, n=10):
        """(summed ms of all kernels of a call, of the rows whose name holds `key`)"""
        _, total, events = profiled(lambda: [fn() for _ in range(n)])
        return total / n, sum(self_device_us(e) for e in events if key in e.key) / (1e3 * n)

    lstm16 = {}
    for c in (64, 16):
        x16 = torch.as_tensor(rng.normal(size=(LSTM_B, c, LSTM_T)).astype(np.float32), device=dev).to(bf)
        w16 = [torch.as_tensor(a.astype(np.float32), device=dev).to(bf) for a in (
            rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, c)),
            rng.uniform(-0.25, 0.25, (LSTM_G, 4 * LSTM_H, LSTM_H)),
            rng.normal(size=(LSTM_G, 4 * LSTM_H)) * 0.1)]
        n0 = cuda_lstm.bf16_launches
        err16, strict16 = relaxed_check(cuda_lstm.lstm_branches(x16, *w16, rev),
                                        cuda_lstm.lstm_branches_reference(x16, *w16, rev), K2_BF16_ABS, "2^-9",
                                        f"lstm_branches bf16 C={c}")
        xs16 = torch.stack([x16, x16.flip(-1)])
        err_m, strict_m = relaxed_check(cuda_lstm.lstm_multi(xs16, *w16), cuda_lstm.lstm_multi_reference(xs16, *w16),
                                        K2_BF16_ABS, "2^-9", f"lstm_multi bf16 C={c}")
        if cuda_lstm.bf16_launches != n0 + 2:
            fail(f"K2 bf16 C={c}: {cuda_lstm.bf16_launches - n0} launches for two calls")
        # one call is one launch: one kernel row a call under the profiler, no
        # gemm. A session that records no device row at all measured nothing
        # (a process's first one has come back so on an H100): run it again
        for _ in range(3):
            _, call16, events = profiled(lambda: [cuda_lstm.lstm_branches(x16, *w16, rev) for _ in range(10)])
            kernels = {e.key: e.count for e in events if str(e.device_type).endswith("CUDA")}
            if kernels:
                break
        call16 /= 10
        if set(kernels) != {k for k in kernels if "lstm_multi_kernel_bf16" in k} or sum(kernels.values()) != 10:
            fail(f"K2 bf16 lstm_branches C={c}: kernels of 10 calls {kernels}, want 10 of lstm_multi_kernel_bf16")
        plain16 = cuda_ms(lambda: cuda_lstm.lstm_branches_reference(x16, *w16, rev), iters=5)
        # the earlier design: bf16 bmm against the unit-major W_ih, then the
        # float body instantiated on bf16 (scripts/k2_bf16_before.cu)
        out_before = torch.empty(LSTM_B, LSTM_G * LSTM_H, LSTM_T, device=dev, dtype=bf)
        gh4 = LSTM_G * 4 * LSTM_H

        def k2_earlier():
            xp = cuda_lstm.project_shared(x16, w16[0])
            if k2_before(xp.data_ptr(), w16[1].data_ptr(), w16[2].data_ptr(), out_before.data_ptr(), LSTM_G,
                         LSTM_B, LSTM_T, LSTM_H, 4 * LSTM_H, LSTM_T * gh4, gh4, LSTM_H * LSTM_T,
                         LSTM_G * LSTM_H * LSTM_T, 0b10, stream):
                fail("lstm_recurrence_bf16_before failed to launch")

        before16, before16_rec = rows_ms(k2_earlier, "lstm_multi_kernel")
        n_cell = LSTM_G * LSTM_B * LSTM_T * LSTM_H
        # the projection is a bf16 product on the tensor cores, the recurrence float32
        bnd16 = bound(nbytes(x16, *w16) + 2 * n_cell, flops=2 * n_cell * 4 * LSTM_H + 10 * n_cell,
                      sfu=5 * n_cell, bf16_flops=2 * n_cell * 4 * c)
        lib16 = torch.nn.LSTM(c, LSTM_H, bidirectional=True).to(dev).to(bf).eval()
        seq16 = x16.permute(2, 0, 1).contiguous()
        with torch.no_grad():
            lib16_ms = profiled(lambda: [lib16(seq16) for _ in range(10)])[1] / 10
        lstm16[c] = (call16, before16, plain16, bnd16, lib16_ms, max(err16, err_m), (strict16, strict_m),
                     before16_rec)
        print(f"K2 bf16 lstm_branches B={LSTM_B} C={c} H={LSTM_H} T={LSTM_T}, one launch (projection inside): "
              f"within 2^-7 |twin| + 2^-9 of its bf16 twin, lstm_multi too (largest |d| {max(err16, err_m):.3e}); "
              f"beyond one bf16 ulp: {strict16} / {strict_m} of {x16.shape[0] * LSTM_G * LSTM_H * LSTM_T} "
              f"elements (lstm_branches / lstm_multi); time on {card}: {call16:.4f} ms, its one kernel row "
              f"under torch.profiler (float32 call {lstm_ms[c][4]:.4f}); the earlier bf16 design in this process "
              f"{before16:.4f} ms of summed kernel time (its recurrence {before16_rec:.4f}); twin {plain16:.4f} ms; "
              f"bound {bnd16[0]:.4f} ms ({bnd16[1]}); torch.nn.LSTM(bidirectional=True) in bf16 {lib16_ms:.4f} ms "
              "of summed kernel time")
    lstm16_err = max(v[5] for v in lstm16.values())

    xa16 = xa.to(bf)
    wt16, wx16 = (torch.as_tensor((rng.normal(size=(ATT_C, ATT_U)) * 0.5 / ATT_C ** 0.5).astype(np.float32),
                                  device=dev).to(bf) for _ in range(2))
    bh16 = torch.as_tensor((rng.normal(size=ATT_U) * 0.05).astype(np.float32), device=dev).to(bf)
    wa16 = wa.to(bf)
    # the strict rule: the kernel rounds q, k, q + k and tanh where its twin does
    att16_err = relaxed_check(
        cuda_addattn.addattn_x(xa16, wt16, bh16, wx16, wa16),
        cuda_addattn.addattn_x_reference(xa16, wt16, bh16, wx16, wa16), BF16_ABS, "1e-6", "addattn_x bf16")[0]
    xt16 = xa16.transpose(1, 2)
    qa16 = (xt16 @ wt16 + bh16).contiguous()
    ka16 = (xt16 @ wx16).contiguous()
    att16_err = max(att16_err, relaxed_check(
        cuda_addattn.addattn(xa16, qa16, ka16, wa16), cuda_addattn.addattn_reference(xa16, qa16, ka16, wa16),
        BF16_ABS, "1e-6", "addattn bf16")[0])
    # the kernel and its twin against float64 on the same bf16 values
    att64 = cuda_addattn.addattn_x_reference(*(a.double() for a in (xa16, wt16, bh16, wx16, wa16)))
    att16_f64 = tuple(float((y.double() - att64).abs().mean()) for y in (
        cuda_addattn.addattn_x(xa16, wt16, bh16, wx16, wa16),
        cuda_addattn.addattn_x_reference(xa16, wt16, bh16, wx16, wa16)))
    _, att16_ms = rows_ms(lambda: cuda_addattn.addattn_x(xa16, wt16, bh16, wx16, wa16), "addattn_kernel")
    _, att16_xqk_ms = rows_ms(lambda: cuda_addattn.addattn(xa16, qa16, ka16, wa16), "addattn_kernel")
    # the earlier design (scripts/k5_bf16_before.cu) at the float body's windows a CTA
    g_before = cuda_addattn.windows_per_cta(ATT_B, ATT_C, ATT_T, ATT_U,
                                            torch.cuda.get_device_properties(dev).multi_processor_count, True)
    out_before = torch.empty_like(xa16)

    def k5_earlier(project):
        if project:
            err = k5_before.addattn_x_bf16_before(
                xa16.data_ptr(), wt16.data_ptr(), bh16.data_ptr(), wx16.data_ptr(), wa16.data_ptr(),
                out_before.data_ptr(), ATT_B, ATT_C, ATT_T, ATT_U, g_before, 1e-5, stream)
        else:
            err = k5_before.addattn_bf16_before(
                xa16.data_ptr(), qa16.data_ptr(), ka16.data_ptr(), wa16.data_ptr(), out_before.data_ptr(),
                ATT_B, ATT_C, ATT_T, ATT_U, g_before, 1e-5, stream)
        if err:
            fail("the earlier K5 bf16 design failed to launch")

    _, att16_before_ms = rows_ms(lambda: k5_earlier(True), "addattn_kernel")
    _, att16_before_xqk_ms = rows_ms(lambda: k5_earlier(False), "addattn_kernel")
    att16_plain_ms = cuda_ms(lambda: cuda_addattn.addattn_x_reference(xa16, wt16, bh16, wx16, wa16))
    # one special-function operation a tanh: the body issues one tanh.approx.f32
    # for each (tanh.approx.bf16x2 gives two but issues at half the rate;
    # scripts/k2_k5_bf16_designs.py measures both)
    att16_bound = bound(nbytes(xa16, wt16, bh16, wx16, wa16, xa16),
                        flops=att_ops["flops"] + 4 * ATT_B * ATT_T * ATT_C * ATT_U, sfu=att_ops["sfu"])
    print(f"K5 bf16 addattn_x x ({ATT_B}, {ATT_C}, {ATT_T}), U {ATT_U}: within one bf16 ulp of its bf16 twin, "
          f"addattn too (largest |d| {att16_err:.3e}); mean |d| from float64 on the same "
          f"bf16 values: kernel {att16_f64[0]:.3e}, twin {att16_f64[1]:.3e}; time on {card}: kernel "
          f"{att16_ms:.4f} ms, addattn {att16_xqk_ms:.4f} ms (their rows under torch.profiler; float32 "
          f"{att['addattn_x'][0]:.4f} / {att['addattn'][0]:.4f}); the earlier bf16 design in this process "
          f"{att16_before_ms:.4f} / {att16_before_xqk_ms:.4f} ms; twin {att16_plain_ms:.4f} ms, bound "
          f"{att16_bound[0]:.4f} ms ({att16_bound[1]}), no library call computes it")

    qkv16 = qkv.to(bf)
    q16, k16, v16 = (a.to(bf) for a in (q, k, v))
    # the relaxed rule's term: the largest |v| of each window and head, (B, H*Dh)
    v16_max = qkv16[:, :, 2].float().abs().amax(dim=(1, 3)).repeat_interleave(MHA_D // MHA_H, dim=1)
    mha16_err, mha16_strict = mha16_check(
        cuda_attn.mha_qkv(qkv16, mha_scale), cuda_attn.mha_qkv_reference(qkv16, mha_scale),
        v16_max[:, None, :], "mha_qkv bf16")
    hm_err, hm_strict = mha16_check(
        cuda_attn.mha(q16, k16, v16, MHA_H), cuda_attn.mha_reference(q16, k16, v16, MHA_H),
        v16_max[:, :, None], "mha bf16")
    mha16_err, mha16_strict = max(mha16_err, hm_err), (mha16_strict, hm_strict)
    _, mha16_ms = rows_ms(lambda: cuda_attn.mha_qkv(qkv16, mha_scale), "mha_kernel")
    _, mha16_hm_ms = rows_ms(lambda: cuda_attn.mha(q16, k16, v16, MHA_H), "mha_kernel")
    _, mha32_row_ms = rows_ms(lambda: cuda_attn.mha_qkv(qkv, mha_scale), "mha_kernel")
    # the earlier design (float32 FMAs on widened bf16; q scaled in float32),
    # built from scripts/k7_bf16_simt.cu, in the same process
    simt_out, simt_hm = torch.empty(MHA_B, MHA_T, MHA_D, device=dev, dtype=bf), torch.empty_like(q16)

    def simt_qkv():
        if simt.mha_qkv_bf16_simt(qkv16.data_ptr(), simt_out.data_ptr(), MHA_B, MHA_H, MHA_D // MHA_H, MHA_T,
                                  mha_scale, stream):
            fail("mha_qkv_bf16_simt failed to launch")

    def simt_mha():
        if simt.mha_bf16_simt(q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), simt_hm.data_ptr(), MHA_B, MHA_H,
                              MHA_D // MHA_H, MHA_T, stream):
            fail("mha_bf16_simt failed to launch")

    simt_mha()
    simt_err = float((simt_hm.float() - cuda_attn.mha_reference(q16, k16, v16, MHA_H).float()).abs().max())
    _, simt_ms = rows_ms(simt_qkv, "mha_kernel")
    _, simt_hm_ms = rows_ms(simt_mha, "mha_kernel")
    mha16_plain_ms = cuda_ms(lambda: cuda_attn.mha_qkv_reference(qkv16, mha_scale), iters=20)
    # bytes: the projection read once, the output written once; the two
    # products at the tensor cores' bf16 rate, the softmax's subtract, max,
    # sum and divide in float32, one exponential a score
    mha16_bound = bound(nbytes(qkv16) * 4 // 3, flops=4 * n_score, sfu=n_score,
                        bf16_flops=4 * (MHA_D // MHA_H) * n_score)
    qv16, kv16, vv16 = (a.transpose(1, 2) for a in qkv16.unbind(2))
    mha16_lib_ms = profiled(lambda: [F.scaled_dot_product_attention(qv16, kv16, vv16, scale=mha_scale)
                                     for _ in range(10)])[1] / 10
    print(f"K7 bf16 mha_qkv ({MHA_B}, {MHA_T}, 3, {MHA_H}, {MHA_D // MHA_H}) in place, tensor cores: within "
          f"2^-7 |twin| + 2^-8 max|v| of its bf16 twin, mha too (largest |d| {mha16_err:.3e}); beyond one "
          f"bf16 ulp (2^-7 |twin| + 1e-6): {mha16_strict[0]} / {mha16_strict[1]} of {qkv_out.numel()} elements "
          f"(mha_qkv / mha); time on {card}: kernel {mha16_ms:.4f} ms, mha {mha16_hm_ms:.4f} ms (their rows "
          f"under torch.profiler; float32 mha_qkv's row {mha32_row_ms:.4f}), twin {mha16_plain_ms:.4f} ms, "
          f"bound {mha16_bound[0]:.4f} ms ({mha16_bound[1]}); F.scaled_dot_product_attention in bf16 on views "
          f"of the projection {mha16_lib_ms:.4f} ms of summed kernel time")
    print(f"K7 bf16, the earlier SIMT design (scripts/k7_bf16_simt.cu) in this process on {card}: mha_qkv "
          f"{simt_ms:.4f} ms, mha {simt_hm_ms:.4f} ms by their profiler rows (mha within {simt_err:.3e} of the "
          f"twin); the tensor-core body {mha16_ms:.4f} / {mha16_hm_ms:.4f} ms")

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
        "mha": (cuda_attn, "launches"), "convpool": (cuda_convpool, "launches"),
        # the launches of the bf16 instantiations, counted in the above too
        "lstm_multi_bf16": (cuda_lstm, "bf16_launches"), "addattn_bf16": (cuda_addattn, "bf16_launches"),
        "mha_bf16": (cuda_attn, "bf16_launches"),
    }

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {kn: getattr(mod, attr) for kn, (mod, attr) in counters.items()}

    def want_launches(label, arch, margs, model, n_fwd, bf16):
        """The launches of one classify (one classify_arrays) of a path with
        n_fwd forwards: K1 once a call, on the opt-in route K3 instead; K2 4
        times a forward on the EQT family; K7 n_layers times a forward under
        "pallas"; on the opt-in route K5 twice and K4 once a forward; K9 7
        times a float32 forward on the EQT family; the bf16 instantiations
        where the forward runs in bf16 (K4 stays float32, K9 does not run)."""
        optin = label == OPTIN
        want = {
            "trigger_extract": 0 if optin else 1,
            "trigger_scan": 1 if optin else 0,
            "conditioning": n_fwd if optin else 0,
            "addattn": 2 * n_fwd if optin else 0,
            "lstm_multi": 4 * n_fwd if arch.endswith("eqtransformer") else 0,
            "mha": model.n_layers * n_fwd if margs.get("attn") == "pallas" else 0,
            "rescnn": 0,
            # K9: each encoder layer of the EQT family's float32 forwards
            "convpool": 0 if bf16 or not arch.endswith("eqtransformer") else 7 * n_fwd,
        }
        for kn in ("lstm_multi", "addattn", "mha"):
            want[f"{kn}_bf16"] = want[kn] if bf16 else 0
        return want

    by_path, rates, thresholds_of, device_of, curves_of, optin_kernel_ms = {}, {}, {}, {}, {}, {}
    upconv_of = {}  # label -> K8 launches of its classify
    bf16_of = {}  # label -> the bf16 run of phase 5
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
        cuda_upconv.launches = 0
        out = picker.classify(stream, P_threshold=thr["P"], S_threshold=thr["S"],
                              detection_threshold=det, **kw)
        torch.cuda.synchronize()
        launches = read_counts()
        # K8: each decoder layer of the EQT family's float32 forwards, 7 a decoder
        n_dec = len(model.detection_branches) + len(model.pick_decoders) if arch.endswith("eqtransformer") else 0
        upconv_of[label] = cuda_upconv.launches
        hook.remove()
        n_fwd = forwards[0]
        by_path[label] = launches
        print(f"{label}: classify {len(out.picks)} picks, {len(out.detections)} detections, "
              f"{n_fwd} forwards; launches {launches}; thresholds {thr}")
        # one classify_arrays a classify (the stations have one length); one
        # conditioning launch a forward (a step, or the flush window)
        optin = label == OPTIN
        want = want_launches(label, arch, margs, model, n_fwd, bf16=False)
        if n_fwd < 1 or launches != want:
            fail(f"{label}: launches {launches}, want {want}")
        if upconv_of[label] != 7 * n_dec * n_fwd:
            fail(f"{label}: upconv_relu launched {upconv_of[label]} times, want {7 * n_dec * n_fwd}")
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
                          "trigger_extract_kernel", "lstm_multi_kernel", "upconv_relu_kernel",
                          "convpool_relu_kernel")}
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
                    sum(e.count for e in device_rows(evs)))
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

        if label in BF16_PATHS:
            # phase 5 in bf16: the same model through a bf16 picker
            bf_picker = WaveformPicker(model, device=dev, precision="bfloat16", **pkw)
            bf_err = float(np.abs(bf_picker.annotate_array(data, **kw) - curves).max())
            fwd16 = [0]
            hook16 = bf_picker._net.register_forward_hook(lambda *_: fwd16.__setitem__(0, fwd16[0] + 1))
            zero_counts()
            bf_picker.classify_arrays(data, thresholds, **kw)
            torch.cuda.synchronize()
            by_path[f"{label} bfloat16"] = bl = read_counts()
            hook16.remove()
            want16 = want_launches(label, arch, margs, model, fwd16[0], bf16=True)
            if fwd16[0] < 1 or bl != want16:
                fail(f"{label} bf16: launches {bl}, want {want16}")
            if not bf_err <= BF16_CURVE_TOL:
                fail(f"{label} bf16: curves {bf_err} from the float32 curves (tol {BF16_CURVE_TOL})")
            _, dev16_ms, ev16 = profiled(lambda: bf_picker.classify_arrays(data, thresholds, **kw))
            own16 = {kn: sum(self_device_us(e) for e in ev16 if kn in e.key) / 1e3
                     for kn in ("mha_kernel", "addattn_kernel", "condition_kernel", "trigger_scan_kernel",
                                "trigger_extract_kernel", "lstm_multi_kernel")}
            conv16, conv32 = cudnn_ms(ev16), cudnn_ms(events)
            bf16_of[label] = dict(curve_err=bf_err, kernel_ms=dev16_ms, kernel_ms_f32=dev_ms,
                                  conv_ms=conv16, conv_ms_f32=conv32, forwards=fwd16[0],
                                  kernels={kn: ms for kn, ms in own16.items() if ms > 0})
            print(f"{label} bf16: curves within {bf_err:.3e} of the float32 curves (tol {BF16_CURVE_TOL}); "
                  f"launches {bl}; one classify_arrays under torch.profiler on {card}: summed kernel "
                  f"time {dev16_ms:.2f} ms against float32 {dev_ms:.2f} ms (cuDNN's convolutions and "
                  f"layout transposes {conv16:.2f} / {conv32:.2f} ms; of it "
                  + ", ".join(f"{kn} {ms:.3f} ms" for kn, ms in own16.items() if ms > 0) + ")")
            if bl["mha_bf16"]:
                print(f"{label} bf16: K7's tensor-core body launched {bl['mha_bf16']} times, "
                      f"{own16['mha_kernel']:.3f} ms of the {dev16_ms:.2f} ms of summed kernel time on {card}")
            del bf_picker

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
    want.update(trigger_extract=n_pass, lstm_multi=4 * n_fwd, convpool=7 * n_fwd)
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
        k2, k9 = read_counts()["lstm_multi"], read_counts()["convpool"]
        hook.remove()
        want_k2 = 4 * forwards[0] if "plstm" in str(route) else 0
        print(f"route fused={route!r} ({other.fused!r}): max abs curve diff to the default route "
              f"{err:.3e} (tol {CURVE_TOL}; {float(np.abs(route_curves[route] - base_c).max()):.3e} with "
              f"the heads stretched), K2 launches {k2}, K9 {k9} in {forwards[0]} forwards")
        if not err <= CURVE_TOL:
            fail(f"route {route!r}: curves differ from the default route by {err}")
        if k2 != want_k2 or k9 != 7 * forwards[0]:
            fail(f"route {route!r}: {k2} launches of K2 and {k9} of K9, want {want_k2} and {7 * forwards[0]}")
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

    # ---- 9. the file-to-picks path at full width, both precisions
    picking = pick_phase(dev, card, zero_counts, read_counts, data, t_start)
    by_path["eqtransformer/pick float32"] = picking["launches"]["float32"]
    by_path["eqtransformer/pick bfloat16"] = picking["launches"]["bfloat16"]

    # ---- 10. train and inspect: SWA, the profiled classify, the pick oracle
    # against K1, prediction examples and the QC screen
    inspecting = inspect_phase(dev, card, zero_counts, read_counts, waves, meta, thresholds_of["eqtransformer"],
                               by_path["eqtransformer"], (prob, t1, t2))
    by_path.update(inspecting["launches"])

    # ---- 11. an archive to picks: JMA deck, Hi-net wire, WIN32 / SAC to
    # miniSEED, pick on phase 9's model
    archive_phase(dev, card, zero_counts, read_counts, data, t_start, picking.pop("model"),
                  picking.pop("thresholds"))

    # ---- 12. the multi-GPU layer: NCCL over the machine's cards, two gloo
    # ranks on cuda:0; a data-parallel fit and a station-sharded classify
    meshing = mesh_phase(dev, card, waves, meta, data)
    del waves, meta
    for tag in ("nccl", "gloo"):
        for r in meshing[tag]["ranks"]:
            by_path[f"eqtransformer/mesh {tag} rank {r['rank']}"] = r["launches"]

    # ---- 13. the bench command: in this process and as a subprocess
    benching = bench_phase(dev, card, zero_counts, read_counts)
    for precision, got in benching["launches"].items():
        by_path[f"eqtransformer/bench {precision}"] = got
    print(json.dumps({"bench": benching["summary"]}))

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
        # K8 replaces no TPU kernel; launches those of phase 4's classify; ms
        # the summed profiler rows of the seven decoder layers at B 256 (one
        # decoder), plain_ms the twin's by CUDA events, library_ms the cuDNN
        # route's kernels; layers: each layer's row
        {"name": "upconv_relu", "route": "cuda", "source": "volpick_tpu_torch/csrc/upconv.cu", "replaces": None,
         "launches": upconv_of["eqtransformer"], "max_rel_err": up_err, "ms": sum(r["ms"] for r in up_rows),
         "plain_ms": sum(r["plain_ms"] for r in up_rows), "bound_ms": sum(r["bound_ms"] for r in up_rows),
         "bound_by": "per layer", "library_ms": sum(r["library_ms"] for r in up_rows), "layers": up_rows},
        # K9 replaces no TPU kernel; launches those of phase 4's classify; ms
        # the summed profiler rows of the seven encoder layers at B 256 (one
        # encoder), library_ms the cuDNN route's kernels (the twin's), bound_ms
        # the benchmark's k9_work; layers: each layer's row at every batch
        {"name": "convpool_relu", "route": "cuda", "source": "volpick_tpu_torch/csrc/convpool.cu",
         "replaces": None, "launches": by_path["eqtransformer"]["convpool"], "max_rel_err": cp_err,
         "ms": sum(r["ms"] for r in cp_rows if r["b"] == UPCONV_BATCHES[0]),
         "bound_ms": sum(r["bound_ms"] for r in cp_rows if r["b"] == UPCONV_BATCHES[0]), "bound_by": "per layer",
         "library_ms": sum(r["library_ms"] for r in cp_rows if r["b"] == UPCONV_BATCHES[0]), "layers": cp_rows},
        # mha_qkv, the entry the model calls; *_head_major is the mha entry
        entry("mha", "mha.cu", "attention.py:55", "tpupicknet/pallas", mha_err, mha_ms,
              mha_plain_ms, mha_bound, mha_lib_ms, ms_head_major=mha_hm_ms,
              plain_ms_head_major=mha_hm_plain_ms, library_ms_contiguous=mha_lib_packed_ms),
        # the bf16 bodies at phase 3's shapes against their bf16 twins
        # (max_abs_err: the largest |d|, each within its stated rule;
        # beyond_one_ulp: K2's elements held by that rule only), launches those of
        # the bf16 runs of phases 9 and 5. K2 (lstm_multi_kernel_bf16, one
        # launch a call, projection inside): ms its kernel row, the whole call;
        # ms_before the earlier design's summed kernel time (bf16 bmm +
        # recurrence), kernel_only_ms_before its recurrence; K5
        # (addattn_kernel_bf16): ms the kernel's profiler row (addattn_x),
        # *_xqk the addattn entry, ms_before* the earlier design's rows
        entry("lstm_multi_bf16", "lstm_multi.cu", "lstm.py:76", "eqtransformer/pick bfloat16", lstm16_err,
              lstm16[64][0], lstm16[64][2], lstm16[64][3], lstm16[64][4], body="lstm_multi_kernel_bf16",
              beyond_one_ulp=list(lstm16[64][6]), ms_before=lstm16[64][1], kernel_only_ms_before=lstm16[64][7],
              ms_c16=lstm16[16][0], plain_ms_c16=lstm16[16][2], bound_ms_c16=lstm16[16][3][0],
              bound_by_c16=lstm16[16][3][1], library_ms_c16=lstm16[16][4],
              beyond_one_ulp_c16=list(lstm16[16][6]), ms_before_c16=lstm16[16][1],
              kernel_only_ms_before_c16=lstm16[16][7]),
        entry("addattn_bf16", "addattn.cu", "addattn.py:52", f"{OPTIN} bfloat16", att16_err, att16_ms,
              att16_plain_ms, att16_bound, body="addattn_kernel_bf16", ms_xqk=att16_xqk_ms,
              ms_before=att16_before_ms, ms_before_xqk=att16_before_xqk_ms,
              mean_abs_err_f64=list(att16_f64)),
        # K7 bf16: the tensor-core body; ms_simt*: the earlier design's rows in
        # this process; beyond_one_ulp: elements of mha_qkv / mha held by the
        # relaxed rule (2^-7 |twin| + 2^-8 max|v|) only
        entry("mha_bf16", "mha.cu", "attention.py:55", "tpupicknet/pallas bfloat16", mha16_err, mha16_ms,
              mha16_plain_ms, mha16_bound, mha16_lib_ms, ms_head_major=mha16_hm_ms, ms_f32_row=mha32_row_ms,
              ms_simt=simt_ms, ms_simt_head_major=simt_hm_ms, beyond_one_ulp=list(mha16_strict)),
    ], "launches_by_path": by_path, "upconv_launches_by_path": upconv_of,
        "optin_classify_launches": optin_launches,
        "streaming": {"packets": n_packets, "passes": n_pass, "forwards": n_fwd, "picks": len(got_picks),
                      "packets_per_s": stream_rate, "pass_ms_median": stream_pass_ms},
        "route_max_abs_curve_diff": route_errs,
        "training": {k: v for k, v in training.items() if k != "launches"},
        "evaluation": {k: v for k, v in evaluation.items() if k not in ("launches", "k1_bound")},
        "bf16_paths": bf16_of, "pick": {k: v for k, v in picking.items() if k != "launches"},
        "inspect": {k: v for k, v in inspecting.items() if k != "launches"}, "mesh": meshing}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
