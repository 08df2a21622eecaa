"""One rank of a data mesh on the card: the data-parallel fit and the
station-sharded classify of ``chip_smoke.py`` phase 12.

    python3 scripts/mesh_ranks.py DIR TAG BACKEND RANK WORLD PORT DEVICE

joins a world of WORLD ranks (BACKEND "nccl" or "gloo", rank 0 listening on
localhost:PORT), makes the world's mesh with this rank on DEVICE, then

- fits EQTransformer at full width with the settings of
  ``examples/configs/eqtransformer_vcseis.json`` (EMA, drop_rate 0.1) on the
  pool that DIR holds (``pool.npy``, ``pool_meta.npz``; ``spec.json`` names
  the global batches and the number of training traces): one epoch of
  ``Trainer.fit`` over the mesh, each rank on its rows of every global
  batch, validation on the dev traces;
- takes the same model's first training steps in float64 on smaller global
  batches at the config's lr, a check of the mechanism to the CPU tests'
  pins;
- classifies ``stream.npy`` (stations x 3 x samples) with the model of
  ``classify.pt`` through ``WaveformPicker(mesh=)``, counting the launches of
  K1 (trigger_extract) and K2 (lstm_multi);

and writes ``TAG_RANK.pt``: the step losses, the fit's history, the state
dict and EMA (of the fit and of the float64 steps), the picks, the launch
counts and the host seconds of each part. It imports nothing of
chip_smoke.py, whose one-process runs of the same functions (``fit``,
``steps64`` and ``classify`` below with ``mesh=None``) are the reference.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parents[1] / "examples" / "configs" / "eqtransformer_vcseis.json"


def _generators(io: Path, model, batch: int, dev: torch.device):
    """The training and dev ``TrainGenerator``s of `io`'s pool for `model`
    at a global batch of `batch` rows, as the training config sets them."""
    from volpick_tpu_torch.pipeline.generator import RawBatchSource, TrainGenerator
    from volpick_tpu_torch.train.trainer import make_augment_config

    spec = json.loads((io / "spec.json").read_text())
    config = json.loads(CONFIG.read_text())
    waves = np.load(io / "pool.npy", mmap_mode="r")
    meta = np.load(io / "pool_meta.npz")
    p, s, is_lp, is_dev = meta["p"], meta["s"], meta["is_lp"], meta["is_dev"]
    event = ~np.isnan(p) | ~np.isnan(s)

    def source(mask):
        idx = np.flatnonzero(mask)
        return RawBatchSource.from_arrays(np.ascontiguousarray(waves[idx]), p[idx], s[idx], is_lp=is_lp[idx])

    train_rows = np.flatnonzero(~is_dev)[: spec["train_traces"]]
    primary = np.zeros(len(p), bool)
    primary[train_rows] = True
    cfg = make_augment_config(model, config["model_args"], bool(config["stack_data"]))
    train_gen = TrainGenerator(source(primary), cfg, batch, eq_dataset=source(~is_dev & event),
                               noise_dataset=source(~is_dev & ~event), seed=42, device=dev)
    dev_gen = TrainGenerator(source(is_dev), cfg, batch, eq_dataset=source(is_dev & event),
                             noise_dataset=source(is_dev & ~event), seed=43, drop_last=False, device=dev)
    return train_gen, dev_gen


def _trainer(model, dev: torch.device, mesh):
    """The training config's Trainer of `model`: on `dev`, or on `mesh`."""
    from volpick_tpu_torch.train.trainer import Trainer

    config = json.loads(CONFIG.read_text())
    margs = config["model_args"]
    return Trainer(model, lr=float(margs["lr"]), loss_weights=tuple(margs["loss_weights"]),
                   ema=bool(config["ema"]), warmup_steps=int(config.get("warmup_steps", 500)),
                   lr_scheduler=margs["lr_scheduler"], lr_scheduler_args=margs["lr_scheduler_args"],
                   device=None if mesh is not None else dev, mesh=mesh)


def _state(sd) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def fit(io: Path, dev: torch.device, mesh=None, save_dir=None) -> dict:
    """One epoch of the training config's fit on the pool of `io` (one
    process, or this rank of `mesh`): step losses, history, state, EMA."""
    from volpick_tpu_torch.models import load_model

    spec = json.loads((io / "spec.json").read_text())
    model = load_model("eqtransformer", seed=0, device=dev)
    train_gen, dev_gen = _generators(io, model, spec["batch"], dev)
    trainer = _trainer(model, dev, mesh)
    losses, lrs = [], []
    step = trainer.train_step

    def recorded(b, lr, generator=None):
        loss = step(b, lr, generator)
        losses.append(float(loss))
        lrs.append(lr)
        return loss

    trainer.train_step = recorded
    t0 = time.perf_counter()
    out = trainer.fit(train_gen, dev_gen, max_epochs=1, save_dir=str(save_dir or io / "weights"),
                      experiment="mesh", tensorboard=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"losses": losses, "lrs": lrs, "history": out["history"], "fit_s": time.perf_counter() - t0,
            "state": _state(model.state_dict()), "ema": _state(trainer.ema_params)}


def steps64(io: Path, dev: torch.device, mesh=None) -> dict:
    """The first ``spec["steps64"]`` training steps of the same model in
    float64, on global batches of ``spec["batch64"]`` rows at the config's
    lr, with dropout (one process, or this rank of `mesh`): step losses,
    state, EMA."""
    from volpick_tpu_torch.models import load_model

    spec = json.loads((io / "spec.json").read_text())
    model = load_model("eqtransformer", seed=0, device=dev)
    train_gen, _ = _generators(io, model, spec["batch64"], dev)
    trainer = _trainer(model.double(), dev, mesh)
    generator = trainer.dropout_generator(7)
    batches = trainer.batches(train_gen)
    losses = []
    t0 = time.perf_counter()
    for _ in range(spec["steps64"]):
        batch = {k: v.double() if v.is_floating_point() else v for k, v in next(batches).items()}
        losses.append(float(trainer.train_step(batch, trainer.lr, generator)))
    batches.close()
    return {"losses64": losses, "steps64_s": time.perf_counter() - t0, "state64": _state(model.state_dict()),
            "ema64": _state(trainer.ema_params)}


def classify(io: Path, dev: torch.device, mesh=None) -> dict:
    """``classify_arrays`` of `io`'s stream with `io`'s model (EQTransformer
    at full width, heads stretched) at the bench settings; K1 and K2
    launches counted around the call."""
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
    from volpick_tpu_torch.ops.cuda import triggers as cuda_trig
    from volpick_tpu_torch.picker import WaveformPicker

    saved = torch.load(io / "classify.pt")
    model = load_model("eqtransformer", seed=0, device=dev)
    model.load_state_dict(saved["state"], strict=True)
    picker = WaveformPicker(model, device=None if mesh is not None else dev, mesh=mesh)
    data = np.load(io / "stream.npy")
    kw = dict(overlap=5500, blinding=(500, 500), batch_size=256)
    picker.classify_arrays(data, saved["thresholds"], **kw)  # cuDNN's first call
    cuda_trig.launches = cuda_lstm.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    picks = picker.classify_arrays(data, saved["thresholds"], **kw)
    seconds = time.perf_counter() - t0
    return {"picks": picks, "classify_s": seconds,
            "launches": {"trigger_extract": cuda_trig.launches, "lstm_multi": cuda_lstm.launches}}


def main(argv) -> None:
    import datetime

    import torch.distributed as dist

    from volpick_tpu_torch.parallel import initialize_distributed, make_mesh

    io, tag, backend = Path(argv[0]), argv[1], argv[2]
    rank, world, port, device = int(argv[3]), int(argv[4]), int(argv[5]), argv[6]
    # the comparisons are float32 against the parent's runs, TF32 off there too
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if world > 1:
        initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
    else:  # initialize_distributed leaves a world of one alone, as JAX's does
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device=device)
        joined = time.perf_counter() - t0
        out = {"rank": rank, "world": world, "backend": backend, "device": str(mesh.device),
               "join_s": joined, **fit(io, mesh.device, mesh, save_dir=io / f"weights_{tag}"),
               **steps64(io, mesh.device, mesh), **classify(io, mesh.device, mesh)}
        out["total_s"] = time.perf_counter() - t0
        torch.save(out, io / f"{tag}_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
