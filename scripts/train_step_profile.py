"""Where a training step of the port goes on one CUDA GPU.

    python3 scripts/train_step_profile.py [--batch 1024] [--steps 10]

EQTransformer at full width (6000 samples, 3 BiLSTM blocks, drop_rate 0.1)
and the optimiser settings of examples/configs/eqtransformer_vcseis.json, fed
augmented batches of a synthetic pool on the card (as chip_smoke.py phase 7,
smaller pool). Prints, beside the card's name and power limit:

- medians over --steps steps by CUDA events: the train-mode forward and loss,
  the backward, Adam + EMA, and the whole step;
- the forward's stages by CUDA events recorded from module hooks (res-CNN
  blocks, BiLSTM blocks, transformer blocks; the encoder before them, the
  pick branches and decoders after them);
- one step under torch.profiler: summed kernel time and kernel launches,
  `aten::` calls, and the 20 rows of most device time (full table in
  chiprun_out/train_step_profile.txt).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.data.synthetic import synthetic_arrays
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.pipeline.generator import RawBatchSource, TrainGenerator
    from volpick_tpu_torch.train.trainer import Trainer, make_augment_config

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)} ({smi('name,power.limit')})"
    with open(os.path.join(here, "examples/configs/eqtransformer_vcseis.json")) as f:
        margs = json.load(f)["model_args"]

    waves, meta = synthetic_arrays(n_events=384, n_noise=96, n_samples=12_288, seed=0)
    p = np.array([m["trace_p_arrival_sample"] for m in meta], np.float32)
    s = np.array([m["trace_s_arrival_sample"] for m in meta], np.float32)
    event = ~np.isnan(p)
    model = load_model("eqtransformer", seed=0, device=dev)
    cfg = make_augment_config(model, margs, stack=True)
    gen = TrainGenerator(RawBatchSource.from_arrays(waves, p, s), cfg, args.batch,
                         eq_dataset=RawBatchSource.from_arrays(waves[event], p[event], s[event]),
                         noise_dataset=RawBatchSource.from_arrays(waves[~event], p[~event], s[~event]),
                         device=dev)
    batches = list(gen.epoch())
    trainer = Trainer(model, lr=float(margs["lr"]), loss_weights=tuple(margs["loss_weights"]), ema=True,
                      device=dev)
    drop = torch.Generator(device=dev).manual_seed(0)

    # forward stages from module hooks
    stage_events = []

    def mark(name):
        def hook(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            stage_events.append((name, e))
        return hook

    groups = [("res-CNN", model.res_cnn_stack.members), ("BiLSTM", model.bi_lstm_stack.members),
              ("transformer", [model.transformer_d0, model.transformer_d])]
    for name, mods in groups:
        mods[0].register_forward_pre_hook(mark(f"{name} start"))
        mods[-1].register_forward_hook(mark(f"{name} end"))

    rows = {k: [] for k in ("forward + loss", "backward", "Adam + EMA", "step", "encoder", "res-CNN",
                            "BiLSTM", "transformer", "pick branches + decoders + heads + loss")}
    for i in range(args.steps + 3):
        batch = batches[i % len(batches)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        stage_events.clear()
        model.train()
        for q in model.parameters():
            q.grad = None
        ev[0].record()
        loss = trainer._loss(model, batch, drop)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.apply_gradients(trainer.lr)
        ev[3].record()
        torch.cuda.synchronize()
        if i < 3:
            continue
        rows["forward + loss"].append(ev[0].elapsed_time(ev[1]))
        rows["backward"].append(ev[1].elapsed_time(ev[2]))
        rows["Adam + EMA"].append(ev[2].elapsed_time(ev[3]))
        rows["step"].append(ev[0].elapsed_time(ev[3]))
        marks = dict(stage_events)
        rows["encoder"].append(ev[0].elapsed_time(marks["res-CNN start"]))
        for name, _ in groups:
            rows[name].append(marks[f"{name} start"].elapsed_time(marks[f"{name} end"]))
        rows["pick branches + decoders + heads + loss"].append(marks["transformer end"].elapsed_time(ev[1]))
    print(f"train step of EQTransformer (6000 samples, batch {args.batch}, float32, TF32 off) on {card}, "
          f"medians of {args.steps} steps by CUDA events:")
    for name, vals in rows.items():
        print(f"  {name}: {np.median(vals):.2f} ms")
    print(f"  torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    def one_step():
        trainer.train_step(batches[0], trainer.lr, drop)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return float(v if v is not None else e.self_cuda_time_total)

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    print(f"one step under torch.profiler on {card}: summed kernel time {kernel_ms:.2f} ms, {launches} kernel "
          f"launches, {aten} aten:: calls; rows of most device time:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:6d}  {e.key[:110]}")
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "train_step_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))


if __name__ == "__main__":
    main()
