"""Config-driven trainer on one device (PyTorch port of
``volpick_tpu/train/trainer.py``; the reference's `train.py` surface).

The JSON config schema is the JAX package's (`examples/configs/*.json`,
reference `volpick/model/train.py:67-78`):
{
  "model": "PhaseNet" | "EQTransformer" | "VolEQTransformer" | "TPUPickNet",
  "model_args": {lr, sigma, prob_label_shape, sample_boundaries,
                 detection_fixed_window, loss_weights, lr_scheduler,
                 lr_scheduler_args, ...model kwargs},
  "data": <dataset path>, "batch_size": 512,
  "trainer_args": {"max_epochs": 400, "check_val_every_n_epoch": 1},
  "stack_data": true, "ema": true, "early_stop": true,
  "swa": {"swa_lrs": ..., "swa_epoch_start": ...},
  "restrict_to_phase": "P"|"S"|null, "training_fraction": 1.0,
  "whole_dataset": false, "resume": false, "warmup_steps": 500,
  "save_dir": "weights"
}

A step: the train-mode forward (BatchNorm on batch statistics, running
statistics updated by the forward; dropout from the trainer's generator),
the loss, autograd, then Adam as ``optax.scale_by_adam()`` computes it
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected) and p ← p − lr·u, with lr =
base × 500-step linear warm-up × ReduceLROnPlateau scale set each step, then
the EMA update. With SWA (PyTorch Lightning's StochasticWeightAveraging
semantics, as the JAX trainer reads them) every batch from the start epoch
on takes the lr ``swa_lrs`` instead, and at each of those epochs' ends,
before validation, the state dict goes into a running mean (``swa_params``,
``swa_n``; checkpointed and restored). As in the JAX package, the averages
are only collected: nothing swaps them into the model. Validation runs the
eval-mode forward under ``torch.no_grad()``, on the EMA weights when EMA is
on (the reference swaps them in around validation). The train step
launches none of the CUDA kernels (the EQT family's train forward is the
per-branch program, TPUPickNet's takes "xla"); validation takes the model's
eval route, on the EQT family the LSTM kernel.

Data parallel (``mesh=``, the JAX trainer's argument): one process a rank,
each holding the replicated model on ``mesh.device``. A step takes the rank's
rows of the global batch (``TrainGenerator.epoch(shard=)``,
``parallel.mesh.shard_batch``); in its forward and backward BatchNorm
normalises by the global batch's statistics (``parallel.mesh.global_batch_norm``
puts a ``GlobalBatchNorm1d`` in the place of each ``nn.BatchNorm1d`` for the
step only), dropout keeps the rank's
rows of masks drawn at the global shape (``models.layers.RankRows``), and the
gradients and the loss are averaged over the ranks in one all-reduce, so
every rank takes the step one process would take on the whole batch and the
ranks' parameters stay equal. Adam, EMA, SWA, plateau and early stopping run
alike on every rank; only rank 0 writes the CSV, TensorBoard and checkpoint
files.
"""

from __future__ import annotations

import copy
import gc
import json
import logging
import contextlib
import math
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from volpick_tpu_torch.device import resolve_device
from volpick_tpu_torch.models.convert import ARCHS
from volpick_tpu_torch.models.eqtransformer import EQTransformer, VolEQTransformer
from volpick_tpu_torch.models.layers import RankRows
from volpick_tpu_torch.parallel.mesh import (
    data_shard, global_batch_norm, initialize_distributed, make_mesh, mesh_device)
from volpick_tpu_torch.pipeline.augmentations import AugmentConfig
from volpick_tpu_torch.pipeline.generator import TrainGenerator
from volpick_tpu_torch.train.checkpoints import CheckpointManager, CSVMetricsLogger, load_checkpoint
from volpick_tpu_torch.train.ema import ema_state_of, ema_update, swa_update
from volpick_tpu_torch.train.losses import vector_cross_entropy, vol_eqt_loss, weighted_bce
from volpick_tpu_torch.train.schedules import EarlyStopper, PlateauScheduler, warmup_scale
from volpick_tpu_torch.utils.tensorboard import TensorBoardLogger

logger = logging.getLogger("volpick_tpu_torch")

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_augment_config(model, model_args: Dict, stack: bool) -> AugmentConfig:
    sigma = float(model_args.get("sigma", 20))
    shape = model_args.get("prob_label_shape", "gaussian")
    if shape == "triangle":
        sigma *= 2  # reference `models.py:154-155`
    boundaries = model_args.get("sample_boundaries") or (None, None)
    common = dict(
        sigma=sigma,
        label_shape=shape,
        norm=model.norm,
        stack=stack,
        rotate_array=bool(model_args.get("rotate_array", False)),
        low=boundaries[0],
        high=boundaries[1],
    )
    if isinstance(model, EQTransformer):
        return AugmentConfig(
            window=model.in_samples,
            pre_window=2 * model.in_samples,
            samples_before=model.in_samples,
            noise_column=False,
            detection=True,
            detection_fixed_window=model_args.get("detection_fixed_window"),
            detrend=True,
            **common,
        )
    return AugmentConfig(
        window=model.in_samples,
        pre_window=6000,
        samples_before=3000,
        noise_column=True,
        detection=False,
        detrend=False,
        **common,
    )


class Trainer:
    """Trains `model` (an nn.Module of the port, which holds its parameters)
    on `device`: the card unless ``device="cpu"``.

    ``mesh`` (``parallel.mesh.make_mesh``) trains data parallel over its
    "data" axis on ``mesh.device``; ``None`` is the world's data mesh when a
    process group is initialised (as JAX's default is every device of the
    job) and the one device otherwise. Under a mesh ``train_step``,
    ``gradients`` and ``eval_step`` take this rank's rows of a global batch
    and return the global batch's loss; the model's BatchNorm modules take
    the global batch's statistics inside a step and are the caller's plain
    ones outside it."""

    def __init__(
        self,
        model: torch.nn.Module,
        lr: float = 1e-3,
        loss_weights=(0.05, 0.40, 0.55),
        ema: bool = False,
        ema_decay: float = 0.999,
        swa: Optional[dict] = None,
        warmup_steps: int = 500,
        lr_scheduler: Optional[str] = "ReduceLROnPlateau",
        lr_scheduler_args: Optional[dict] = None,
        monitor: str = "val_loss",
        seed: int = 42,
        device=None,
        mesh=None,
    ):
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = make_mesh(device=device)
        if mesh is not None:
            device = mesh_device(mesh, device, "Trainer")
        self.device = resolve_device(device, "Trainer")
        self.mesh = mesh
        # (rank on the data axis, its size) under a mesh, else None
        self.shard = data_shard(mesh) if mesh is not None else None
        self._group = mesh.get_group("data") if mesh is not None else None
        self.model = model.to(self.device)
        self.lr = lr
        self.loss_weights = tuple(loss_weights)
        self.ema = ema
        self.ema_decay = ema_decay
        self.swa = swa or None
        self.warmup_steps = warmup_steps
        self.monitor = monitor
        self.seed = seed
        self.is_voleqt = isinstance(model, VolEQTransformer)
        self.is_eqt = isinstance(model, EQTransformer) and not self.is_voleqt

        args = dict(lr_scheduler_args or {})
        args.setdefault("factor", 0.5)
        args.setdefault("patience", 20)
        args.setdefault("min_lr", 1e-6)
        if lr_scheduler == "ReduceLROnPlateau":
            self.plateau = PlateauScheduler(base_lr=1.0, **{k: args[k] for k in ("factor", "patience", "min_lr")})
            self.plateau.lr = 1.0  # the plateau controls a scale, not the lr itself
            self.plateau.min_lr = args["min_lr"] / lr  # floor in scale space
        else:
            self.plateau = None

        params = dict(self.model.named_parameters())
        self.opt_state = {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }
        self.ema_params = ema_state_of(self.model) if ema else None
        self.swa_params = None
        self.swa_n = 0
        self.step = 0
        self.start_epoch = 0
        # best monitored value carried across restarts, so a resumed run
        # cannot overwrite the pre-restart best checkpoint with a worse one
        self._restored_best = None
        self._eval_model = None

    # ------------------------------------------------------------- resume
    def restore(self, checkpoint_path) -> "Trainer":
        """Resume training state (parameters, BatchNorm statistics, EMA, SWA,
        optimiser moments, step, epoch, plateau) from a checkpoint written by
        this trainer."""
        raw = load_checkpoint(checkpoint_path)
        self.model.load_state_dict(raw["params"], strict=True)
        opt = raw.get("opt_state")
        if opt is not None:
            self.opt_state = {
                "count": int(opt["count"]),
                "mu": {k: v.to(self.device) for k, v in opt["mu"].items()},
                "nu": {k: v.to(self.device) for k, v in opt["nu"].items()},
            }
        if raw.get("ema_params") is not None:
            self.ema_params = {k: v.to(self.device) for k, v in raw["ema_params"].items()}
        if raw.get("swa_params") is not None:
            self.swa_params = {k: v.to(self.device) for k, v in raw["swa_params"].items()}
        self.step = int(raw.get("step", 0))
        self.swa_n = int(raw.get("swa_n", 0) or 0)
        # continue epoch numbering where the interrupted run stopped, like
        # Lightning's `fit(ckpt_path=...)` (reference `train.py:214-222`)
        if raw.get("epoch") is not None:
            self.start_epoch = int(raw["epoch"]) + 1
        if self.plateau is not None and raw.get("plateau") is not None:
            p = raw["plateau"]
            self.plateau.best = float(p.get("best", math.inf))
            self.plateau.num_bad_epochs = int(p.get("num_bad_epochs", 0))
            self.plateau.cooldown_counter = int(p.get("cooldown_counter", 0))
            self.plateau.lr = float(p.get("lr", self.plateau.base_lr))
        if raw.get("best_monitor") is not None and math.isfinite(float(raw["best_monitor"])):
            self._restored_best = float(raw["best_monitor"])
        return self

    # ------------------------------------------------------------------ steps
    def _loss(self, model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of `model` (in whichever mode it is) on `batch`; the EQT
        family's dropout draws from `generator` in train mode."""
        x = batch["X"]
        if self.is_voleqt:
            rg, lp, p, s = model(x, generator=generator)
            # detection labels gated per trace by source type: LP traces zero
            # the regular head's target and vice versa (EventTypeDetectionLabeller,
            # reference `models.py:1376-1456`)
            det = batch["detections"][:, 0]
            is_lp = batch["is_lp"][:, None]
            weights = self.loss_weights
            if len(weights) == 3:  # the EQT default: the detection weight twice
                weights = (weights[0], weights[0], weights[1], weights[2])
            return vol_eqt_loss(rg, lp, p, s, det * (1.0 - is_lp), det * is_lp,
                                batch["y"][:, 0], batch["y"][:, 1], weights)
        if self.is_eqt:
            det, p, s = model(x, generator=generator)
            return weighted_bce(det, p, s, batch["detections"][:, 0], batch["y"][:, 0],
                                batch["y"][:, 1], self.loss_weights)
        return vector_cross_entropy(model(x), batch["y"])

    def _mean_over_ranks(self, tensors) -> None:
        """Replace each tensor by its mean over the data axis' ranks, in one
        all-reduce of their concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self._group)
        flat /= self.shard[1]
        off = 0
        for t in tensors:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()

    def gradients(self, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train-mode loss of `batch` with every parameter's ``.grad`` set
        (BatchNorm running statistics updated as in a step); no update. Under
        a mesh the loss and the gradients are the global batch's."""
        self.model.train()
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        with global_batch_norm(self.model, self._group) if self.mesh is not None else contextlib.nullcontext():
            loss = self._loss(self.model, batch, generator)
            loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss = loss.reshape(1).clone()
            self._mean_over_ranks([p.grad for p in params] + [loss])
            loss = loss[0]
        return loss

    @torch.no_grad()
    def apply_gradients(self, lr: float) -> None:
        """Adam (``optax.scale_by_adam()``) on the parameters' ``.grad``, then
        p ← p − lr·u, then the EMA update. A parameter without a gradient
        counts as a zero gradient, as JAX's would be."""
        count = self.opt_state["count"] + 1
        self.opt_state["count"] = count
        for name, p in self.model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = self.opt_state["mu"][name], self.opt_state["nu"][name]
            mu.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            # bias corrections in the moments' dtype, as optax computes them
            bc1 = 1 - torch.tensor(ADAM_B1, dtype=mu.dtype) ** count
            bc2 = 1 - torch.tensor(ADAM_B2, dtype=nu.dtype) ** count
            u = (mu / bc1.item()) / (torch.sqrt(nu / bc2.item()) + ADAM_EPS)
            p.copy_(p - lr * u)
        if self.ema_params is not None:
            ema_update(self.ema_params, self.model, self.ema_decay)

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One optimiser step on `batch` at learning rate `lr` → the loss (a
        device scalar)."""
        loss = self.gradients(batch, generator)
        self.apply_gradients(lr)
        return loss

    def eval_model(self) -> torch.nn.Module:
        """The model validation runs: the live model, or with EMA on a copy
        holding the EMA weights; in eval mode."""
        if self.ema_params is None:
            return self.model.eval()
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model)
        self._eval_model.load_state_dict(self.ema_params, strict=True)
        return self._eval_model.eval()

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self._loss(self.eval_model(), batch)
        if self.mesh is not None:
            loss = loss.reshape(1).clone()
            self._mean_over_ranks([loss])
            loss = loss[0]
        return loss

    def batches(self, gen: TrainGenerator):
        """An epoch of `gen`: under a mesh, this rank's rows of each batch."""
        return gen.epoch() if self.shard is None else gen.epoch(shard=self.shard)

    def dropout_generator(self, seed: int):
        """The dropout masks' generator on the trainer's device, seeded
        `seed`; under a mesh wrapped in ``RankRows`` for this rank."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return gen if self.shard is None else RankRows(gen, *self.shard)

    # -------------------------------------------------------------------- fit
    def fit(
        self,
        train_gen: TrainGenerator,
        dev_gen: Optional[TrainGenerator] = None,
        max_epochs: int = 100,
        save_dir: Optional[str] = None,
        experiment: str = "exp",
        early_stop: bool = False,
        log_every: int = 5,
        check_val_every_n_epoch: int = 1,
        checkpoint_every_n_steps: Optional[int] = None,
        hparams: Optional[dict] = None,
        tensorboard: bool = True,
    ) -> Dict:
        monitor = self.monitor if dev_gen is not None else "train_loss"
        exp_dir = Path(save_dir or "weights") / experiment
        # under a mesh only rank 0 writes files; every rank computes alike
        writer = self.mesh is None or dist.get_rank() == 0
        csvlog = CSVMetricsLogger(exp_dir, hparams=hparams or {}) if writer else None
        # CSV and TensorBoard side by side, like the reference
        # (`volpick/model/train.py:122-130`; TB skipped for test runs there)
        tblog = TensorBoardLogger(exp_dir / "tensorboard") if tensorboard and writer else None
        ckpt = CheckpointManager(exp_dir / "checkpoints", monitor=monitor, save_ema=self.ema) if writer else None
        if self._restored_best is not None and writer:
            ckpt.best = self._restored_best
        stopper = EarlyStopper(patience=100) if early_stop else None
        # dropout stream folded with the resumed epoch, so that a resumed run
        # does not replay the pre-restart epochs' masks
        dropout_gen = self.dropout_generator((self.seed + 1) * 1_000_003 + self.start_epoch)

        plateau_scale = self.plateau.lr if self.plateau is not None else 1.0
        t_start = time.perf_counter()
        history = []
        # PL StochasticWeightAveraging semantics: swa_epoch_start is an epoch
        # index or a fraction of max_epochs; swa_lrs may be a list
        if self.swa:
            raw = self.swa.get("swa_epoch_start", 0.8)
            swa_start_epoch = int(raw) if raw >= 1 else int(float(raw) * max_epochs)
            swa_lr_cfg = self.swa.get("swa_lrs")
            if isinstance(swa_lr_cfg, (list, tuple)):
                swa_lr_cfg = swa_lr_cfg[0]
        else:
            swa_start_epoch = None
            swa_lr_cfg = None

        for epoch in range(self.start_epoch, max_epochs):
            # --- train
            losses = []
            for batch in self.batches(train_gen):
                lr = self.lr * warmup_scale(self.step, self.warmup_steps) * plateau_scale
                if self.swa and epoch >= swa_start_epoch and swa_lr_cfg is not None:
                    lr = float(swa_lr_cfg)
                loss = self.train_step(batch, lr, dropout_gen)
                self.step += 1
                losses.append(loss)  # device scalar; synchronised once an epoch
                if writer and checkpoint_every_n_steps and self.step % checkpoint_every_n_steps == 0:
                    ckpt.update(self._state(epoch), {monitor: float(loss)}, epoch, self.step)
            train_loss = float(np.mean(torch.stack(losses).cpu().numpy())) if losses else math.nan

            # --- SWA collection at epoch end
            if self.swa and epoch >= swa_start_epoch:
                if self.swa_params is None:
                    self.swa_params = ema_state_of(self.model)
                    self.swa_n = 1
                else:
                    swa_update(self.swa_params, self.model.state_dict(), self.swa_n)
                    self.swa_n += 1

            # --- validation (Lightning `check_val_every_n_epoch`: every Nth
            # epoch and always the last; skipped epochs log val_loss=nan, which
            # checkpoint selection, plateau and early stopping ignore)
            run_val = (epoch + 1) % max(int(check_val_every_n_epoch), 1) == 0 \
                or epoch == max_epochs - 1
            val_loss = math.nan
            if dev_gen is not None and run_val:
                vlosses = [float(self.eval_step(b)) for b in self.batches(dev_gen)]
                val_loss = float(np.mean(vlosses)) if vlosses else math.nan

            metrics = {
                "epoch": epoch,
                "step": self.step,
                "train_loss": train_loss,
                "val_loss": val_loss,
                # warm-up x plateau, as the JAX trainer logs it in SWA epochs too
                "lr": self.lr * warmup_scale(self.step, self.warmup_steps) * plateau_scale,
                "time_s": time.perf_counter() - t_start,
            }
            if writer:
                csvlog.log(metrics)
            if tblog is not None:
                tblog.log_scalars(metrics, self.step)
                tblog.flush()
            history.append(metrics)
            logger.info(
                f"epoch {epoch}: train_loss={train_loss:.5f} val_loss={val_loss:.5f} lr={metrics['lr']:.2e}"
            )
            gc.collect()

            monitored = metrics[monitor]
            if writer:
                ckpt.update(self._state(epoch), metrics, epoch, self.step)
            if self.plateau is not None and not math.isnan(monitored):
                plateau_scale = self.plateau.step(monitored)
            if stopper is not None and not math.isnan(monitored) and stopper.step(monitored):
                logger.info(f"early stopping at epoch {epoch}")
                break

        self.model.train()
        if tblog is not None:
            tblog.close()
        best = None
        if writer:
            with open(exp_dir / "running_time.txt", "w") as f:
                f.write(str(time.perf_counter() - t_start))
            best = str(ckpt.best_path)
        if self.mesh is not None:
            # rank 0 has written every file when the others learn the path
            box = [best]
            dist.broadcast_object_list(box, src=0)
            best = box[0]
        return {"history": history, "best_checkpoint": best, "exp_dir": str(exp_dir)}

    def _state(self, epoch: int) -> Dict:
        # CheckpointManager.update stamps `best_monitor` on top before writing
        state = {
            "params": self.model.state_dict(),
            "ema_params": self.ema_params,
            "swa_params": self.swa_params,
            "swa_n": self.swa_n,
            "opt_state": self.opt_state,
            "step": self.step,
            "epoch": epoch,
        }
        if self.plateau is not None:
            state["plateau"] = {
                "best": self.plateau.best,
                "num_bad_epochs": self.plateau.num_bad_epochs,
                "cooldown_counter": self.plateau.cooldown_counter,
                "lr": self.plateau.lr,
            }
        return state


# --------------------------------------------------------------- config entry
_LIT_ONLY_ARGS = {
    "lr",
    "sigma",
    "prob_label_shape",
    "sample_boundaries",
    "rotate_array",
    "lr_scheduler",
    "lr_scheduler_args",
    "lr_monitor",
    "loss_weights",
    "detection_fixed_window",
}


def apply_training_fraction(training_fraction: float, train_ds) -> None:
    """Seeded block subsampling by `trace_name` bucket, as the reference
    (`volpick/model/train.py:335-359`): the unique bucket names (trace_name
    before '$') are shuffled with np.random.seed(42) and the first fraction
    kept, so a fraction always selects the same traces and traces of one
    HDF5 bucket are kept or dropped together."""
    blocks = train_ds.metadata["trace_name"].astype(str).str.split("$").str[0]
    unique_blocks = blocks.unique()
    np.random.seed(42)
    np.random.shuffle(unique_blocks)
    # at least one bucket: fewer buckets than 1/fraction would empty the set
    target = set(unique_blocks[: max(int(training_fraction * len(unique_blocks)), 1)])
    train_ds.filter(blocks.isin(target).to_numpy())


def prepare_data(config: Dict, model, test_run: bool = False, cfg: Optional[AugmentConfig] = None,
                 device=None):
    """Dataset → (train_gen, dev_gen) following `train.py:225-332`, the
    generators augmenting on `device`."""
    from volpick_tpu_torch.data.dataset import load_dataset
    from volpick_tpu_torch.pipeline.generator import _onset_arrays

    dataset = load_dataset(config["data"])
    md = dataset.metadata

    restrict = config.get("restrict_to_phase")
    if restrict:
        # keep only traces carrying a requested phase (noise traces dropped;
        # `train.py:362-372` generate_phase_mask)
        keep = np.zeros(len(md), dtype=bool)
        p, s = _onset_arrays(md)
        if "P" in restrict:
            keep |= ~np.isnan(p)
        if "S" in restrict:
            keep |= ~np.isnan(s)
        dataset.filter(keep)
        md = dataset.metadata

    if config.get("remove_spikes") and "trace_has_spikes" in md.columns:
        dataset.filter(~md["trace_has_spikes"].fillna(False).astype(bool))
        md = dataset.metadata

    if not getattr(dataset, "had_split_column", True) or md["split"].isna().all():
        # auxiliary 60/10/30 split (`train.py:256-262`)
        logger.warning("dataset has no split column; injecting auxiliary 60/10/30 split")
        split = np.array(["train"] * len(md), dtype=object)
        split[int(0.6 * len(md)) : int(0.7 * len(md))] = "dev"
        split[int(0.7 * len(md)) :] = "test"
        dataset.metadata["split"] = split

    if config.get("whole_dataset"):
        dataset.metadata["split"] = "train"

    train_ds = dataset.get_split("train")
    dev_ds = dataset.get_split("dev")

    frac = float(config.get("training_fraction", 1.0))
    if not 0.0 < frac <= 1.0:
        raise ValueError("Training fraction needs to be between 0 and 1.")
    if frac < 1.0:
        apply_training_fraction(frac, train_ds)

    if test_run:
        for ds in (train_ds, dev_ds):
            if len(ds) > 1000:
                ds.filter(np.arange(len(ds)) < 1000)

    batch_size = 10 if test_run else int(config.get("batch_size", 256))
    stack = bool(config.get("stack_data", False))
    if cfg is None:
        cfg = make_augment_config(model, config.get("model_args", {}), stack)

    def subsets(ds):
        if not stack:
            return None, None
        p, s = _onset_arrays(ds.metadata)
        eq = ds.filter(~np.isnan(p) | ~np.isnan(s), inplace=False)
        noise = ds.filter(np.isnan(p) & np.isnan(s), inplace=False)
        return (eq if len(eq) else None), (noise if len(noise) else None)

    eq_tr, no_tr = subsets(train_ds)
    eq_dev, no_dev = subsets(dev_ds)
    # device-resident trace pools (None = auto: on when the pools fit)
    device_data = config.get("device_data")
    train_gen = TrainGenerator(
        train_ds, cfg, batch_size, eq_dataset=eq_tr, noise_dataset=no_tr, seed=42,
        device_data=device_data, device=device,
    )
    dev_gen = (
        TrainGenerator(
            dev_ds, cfg, batch_size, eq_dataset=eq_dev, noise_dataset=no_dev, seed=43,
            drop_last=False, device_data=device_data, device=device,
        )
        if len(dev_ds)
        else None
    )
    return train_gen, dev_gen


def train(config: Dict, experiment_name: str = "exp", test_run: bool = False, device=None) -> Dict:
    """The `train.py --config` entry point (reference `train.py:63-222`) on
    `device`: the card unless ``device="cpu"``. In an initialised process
    group it trains data parallel on the world's mesh (the ``Trainer``'s
    default), this rank on ``cuda:$LOCAL_RANK`` unless `device` names one."""
    model_args = dict(config.get("model_args", {}))
    model_name = config["model"].lower()
    arch_args = {k: v for k, v in model_args.items() if k not in _LIT_ONLY_ARGS}
    seed = 42
    model = ARCHS[model_name](generator=torch.Generator().manual_seed(seed), **arch_args)

    if config.get("pretrained"):
        from volpick_tpu_torch.models.registry import from_pretrained

        warm = from_pretrained(model_name, config["pretrained"], device="cpu")
        model.load_state_dict(warm.state_dict(), strict=True)
        logger.info(f"warm start from pretrained {config['pretrained']}")

    trainer = Trainer(
        model,
        lr=float(model_args.get("lr", 0.01)),
        loss_weights=tuple(model_args.get("loss_weights", (0.05, 0.40, 0.55))),
        ema=bool(config.get("ema", False)),
        swa=config.get("swa") or None,
        warmup_steps=int(config.get("warmup_steps", 500)),
        lr_scheduler=model_args.get("lr_scheduler", "ReduceLROnPlateau"),
        lr_scheduler_args=model_args.get("lr_scheduler_args"),
        monitor="train_loss" if config.get("whole_dataset") else "val_loss",
        seed=seed,
        device=device,
    )
    if config.get("resume"):
        ckpt = Path(config.get("save_dir", "weights")) / experiment_name / "checkpoints" / "last.ckpt"
        if ckpt.exists():
            trainer.restore(ckpt)
            logger.info(f"resumed from {ckpt} at step {trainer.step}")
    train_gen, dev_gen = prepare_data(config, model, test_run, device=trainer.device)
    if config.get("whole_dataset"):
        dev_gen = None
    return trainer.fit(
        train_gen,
        dev_gen,
        max_epochs=int(config.get("trainer_args", {}).get("max_epochs", 100)),
        check_val_every_n_epoch=int(
            config.get("trainer_args", {}).get("check_val_every_n_epoch", 1)
        ),
        save_dir=config.get("save_dir", "weights"),
        experiment=experiment_name,
        early_stop=bool(config.get("early_stop", False)),
        checkpoint_every_n_steps=5 if config.get("whole_dataset") else None,
        hparams=config,
        # the reference skips the TensorBoard logger on test runs (`train.py:127-130`)
        tensorboard=not test_run,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Train a picking model from a JSON config")
    ap.add_argument("--config", required=True)
    ap.add_argument("--test_run", action="store_true")
    ap.add_argument("--whole_dataset", action="store_true")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--fraction", type=float, default=None)
    ap.add_argument("--device", default=None, help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)
    # under torchrun (WORLD_SIZE > 1) each rank joins the world: NCCL on the
    # card, gloo when the CPU is asked for
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        initialize_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
                               int(os.environ["RANK"]), backend="gloo" if args.device == "cpu" else None)
    with open(args.config) as f:
        config = json.load(f)
    if args.whole_dataset:
        config["whole_dataset"] = True
    if args.lr is not None:
        config.setdefault("model_args", {})["lr"] = args.lr
    if args.fraction is not None:
        config["training_fraction"] = args.fraction
    name = Path(args.config).stem
    if args.lr is not None:
        name += f"_lr{args.lr}"
    if args.fraction is not None:
        name += f"_frac{args.fraction}"
    return train(config, experiment_name=name, test_run=args.test_run, device=args.device)


if __name__ == "__main__":
    main()
