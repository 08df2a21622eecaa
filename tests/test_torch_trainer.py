"""The port's trainer against the JAX trainer, and its artefacts.

- the update rule: the same gradients through the port's step and through
  ``optax.scale_by_adam`` + p − lr·u + ``merge_bn_updates`` + ``ema_update``
  give, after 3 steps, parameters, Adam moments and EMA within 1e-6;
- a few-step trajectory: the same batches through both trainers (PhaseNet
  with EMA, its BatchNorm statistics merged each step, float64) give losses
  within 1e-6 relative over 3 steps, parameters and EMA within 1e-7;
- a missing CUDA device raises; the SWA config trains through the CLI.
"""

import copy
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_train_common import make_batch, perturbed_params, state_dict_from_jax
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.train import ema as jema
from volpick_tpu.train.trainer import Trainer as JaxTrainer
from volpick_tpu.train.trainer import merge_bn_updates
from volpick_tpu_torch.models import EQTransformer, PhaseNet
from volpick_tpu_torch.models.convert import jax_tree_from_model
from volpick_tpu_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(in_samples=1504, lstm_blocks=1)


def _as_params(model, values):
    """A copy of `model` whose parameters are `values` (name → tensor) and
    whose buffers are zero: its JAX tree puts each value where the
    converter puts that parameter."""
    other = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in other.named_parameters():
            p.copy_(values[name])
        for b in other.buffers():
            b.zero_()
    return jax_tree_from_model(other)


def _close(tree_a, tree_b, tol=1e-6, skip=()):
    la, lb = jax.tree_util.tree_leaves_with_path(tree_a), jax.tree_util.tree_leaves(tree_b)
    assert len(la) == len(lb)
    for (path, a), b in zip(la, lb):
        if getattr(path[-1], "key", None) in skip:
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, err_msg=jax.tree_util.keystr(path))


def test_update_rule_matches_optax_and_the_jax_trainer():
    rng = np.random.default_rng(0)
    model = PhaseNet(generator=torch.Generator().manual_seed(1))
    trainer = ttrainer.Trainer(model, ema=True, ema_decay=0.9, device="cpu")
    params = jax_tree_from_model(model)
    tx = optax.scale_by_adam()
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    for lr in (1e-3, 3e-3, 5e-4):
        grads = {n: torch.as_tensor(rng.normal(size=p.shape).astype(np.float32)) for n, p in model.named_parameters()}
        stats = {n: torch.as_tensor(rng.uniform(0.5, 1.5, size=b.shape).astype(np.float32))
                 for n, b in model.named_buffers() if b.dtype == torch.float32}
        # the port: a forward would have set the statistics; the step reads .grad
        with torch.no_grad():
            for n, b in model.named_buffers():
                if n in stats:
                    b.copy_(stats[n])
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        trainer.apply_gradients(lr)
        # JAX: scale_by_adam, p - lr u, merge the BN updates, EMA
        jgrads = _as_params(model, grads)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p - lr * u, params, updates)
        bn_up = {}
        sd_stats = jax_tree_from_model(model)  # the port's buffers in tree layout
        for path, leaf in jax.tree_util.tree_leaves_with_path(sd_stats):
            if getattr(path[-1], "key", None) in ("mean", "var"):
                node = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path[:-1])
                bn_up.setdefault(node, {})[path[-1].key] = jnp.asarray(leaf)
        params = merge_bn_updates(params, bn_up)
        ema = jema.ema_update(ema, params, 0.9)
    assert trainer.opt_state["count"] == int(opt_state.count) == 3
    _close(jax_tree_from_model(model), params)
    _close(_as_params(model, trainer.opt_state["mu"]), opt_state.mu, skip=("mean", "var"))
    _close(_as_params(model, trainer.opt_state["nu"]), opt_state.nu, skip=("mean", "var"))
    ema_model = copy.deepcopy(model)
    ema_model.load_state_dict(trainer.ema_params)
    _close(jax_tree_from_model(ema_model), ema)


def test_three_steps_follow_the_jax_trainer():
    """PhaseNet with EMA, the same three batches and learning rates, both
    trainers in float64: the losses agree within 1e-6 relative, the
    parameters (BatchNorm statistics included) and the EMA within 1e-7
    (1e-4 of the largest learning rate: Adam divides gradients that a
    train-mode BatchNorm all but cancels by their own size).
    (In float32 the first Adam step is u = g / (|g| + eps), about ±1 even
    where |g| is rounding noise, as for the gradients that are zero by
    construction; there the two packages step apart by 2 lr.)"""
    port = PhaseNet(generator=torch.Generator().manual_seed(2))
    params = perturbed_params(port)
    port.load_state_dict(state_dict_from_jax("phasenet", params, np.float64), strict=True)
    port.double()
    rng = np.random.default_rng(6)
    batches = [make_batch(rng, 8, port.in_samples, eqt=False) for _ in range(3)]
    lrs = [1e-3 * (i + 1) / 3 for i in range(3)]
    want = []
    with jax.enable_x64(True):
        jt = JaxTrainer(JaxPhaseNet(), params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params),
                        ema=True)
        jt._build_steps()
        p, o, e = jt.params, jt.opt_state, jt.ema_params
        for b, lr in zip(batches, lrs):
            p, o, e, loss = jt._train_step(p, o, e, {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}, lr, None)
            want.append(float(loss))
        p, e = jax.device_get((p, e))
    tt = ttrainer.Trainer(port, ema=True, device="cpu")
    got = [float(tt.train_step({k: torch.as_tensor(v, dtype=torch.float64) for k, v in b.items()}, lr))
           for b, lr in zip(batches, lrs)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    for name, v in state_dict_from_jax("phasenet", p, np.float64).items():
        assert (port.state_dict()[name].double() - v).abs().max().item() <= 1e-7 or "num_batches" in name, name
    ema = copy.deepcopy(port)
    ema.load_state_dict(tt.ema_params)
    for name, v in state_dict_from_jax("phasenet", e, np.float64).items():
        assert (ema.state_dict()[name].double() - v).abs().max().item() <= 1e-7 or "num_batches" in name, name


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrainer.Trainer(PhaseNet())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrainer.train({"model": "PhaseNet", "data": "nowhere"})


def test_swa_config_trains(tmp_path):
    """examples/configs/eqtransformer_swa.json trains through
    ``python -m volpick_tpu_torch train`` on the CPU, cut to test size (a
    synthetic dataset, batch 8, 2 epochs, 1504 samples, one BiLSTM block):
    swa_epoch_start 0.75 of 2 epochs collects at the end of epoch 1 only,
    so the last checkpoint holds swa_n 1 and averages equal to its
    parameters."""
    from volpick_tpu_torch import __main__ as cli
    from volpick_tpu_torch.data.synthetic import make_synthetic_dataset
    from volpick_tpu_torch.train.checkpoints import load_checkpoint

    config = json.loads((REPO / "examples/configs/eqtransformer_swa.json").read_text())
    assert config["swa"] == {"swa_lrs": 5e-05, "swa_epoch_start": 0.75}
    make_synthetic_dataset(tmp_path / "ds", n_events=16, n_noise=4, n_samples=3600, seed=5)
    config.update(data=str(tmp_path / "ds"), batch_size=8, trainer_args={"max_epochs": 2}, warmup_steps=2,
                  save_dir=str(tmp_path / "weights"))
    config["model_args"].update(SMALL)
    path = tmp_path / "eqtransformer_swa.json"
    path.write_text(json.dumps(config))
    out = cli.main(["train", "--config", str(path), "--device", "cpu"])
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert all(math.isfinite(h["train_loss"]) for h in out["history"])
    raw = load_checkpoint(tmp_path / "weights" / "eqtransformer_swa" / "checkpoints" / "last.ckpt")
    assert raw["swa_n"] == 1 and raw["epoch"] == 1
    assert set(raw["swa_params"]) == set(raw["params"])
    for k, v in raw["params"].items():
        assert torch.equal(raw["swa_params"][k], v), k


def test_make_augment_config_matches_jax():
    from volpick_tpu.models import PhaseNet as JaxPhaseNet
    from volpick_tpu.train.trainer import make_augment_config as jax_make

    args = {"sigma": 10, "prob_label_shape": "triangle", "sample_boundaries": [100, 5000],
            "detection_fixed_window": 300, "rotate_array": True}
    for port, jm in ((PhaseNet(), JaxPhaseNet()), (EQTransformer(**SMALL), JaxEQT(**SMALL))):
        for stack in (False, True):
            a = ttrainer.make_augment_config(port, args, stack)
            b = jax_make(jm, args, stack)
            assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
                {k: getattr(b, k) for k in b.__dataclass_fields__}
    assert math.isclose(ttrainer.make_augment_config(PhaseNet(), args, False).sigma, 20.0)
