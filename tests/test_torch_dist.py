"""The port's data-parallel Trainer on two gloo ranks of the CPU.

- PhaseNet with EMA, 3 steps of a global batch of 4 (2 rows a rank), float64,
  on the world's mesh (``Trainer(mesh=None)`` in an initialised group): each
  rank's losses within 1e-6 relative of the JAX ``Trainer(mesh=make_mesh(2))``
  on the same parameters and batches, parameters, BatchNorm statistics and
  EMA within 1e-7 (the pins of ``tests/test_torch_trainer.py``); both ranks
  hold the same tensors bit for bit;
- EQTransformer with dropout 0.1 (1504 samples, one BiLSTM block), the same
  3 steps over ``make_mesh``: equal to the port's single-process steps on the
  4 rows with the same dropout seed, to the same pins (the ranks draw the
  masks at the global shape and keep their rows);
- ``train(config)`` over the two ranks writes one set of files (one CSV row
  an epoch, one checkpoint directory), both ranks report the same losses and
  best checkpoint, and a fresh trainer on each rank restores the run;
- ``python -m volpick_tpu_torch train`` under torchrun's environment joins the
  world: gloo for ``--device cpu``, NCCL otherwise.

The ranks run once for the file (``tests/torch_dist_common.py``).
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_common import LOSS_RTOL, PARAM_ATOL, WORLD, results, run_ranks, unprefix
from tests.torch_train_common import make_batch, perturbed_params, state_dict_from_jax
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.parallel import make_mesh as jax_make_mesh
from volpick_tpu.train.trainer import Trainer as JaxTrainer
from volpick_tpu_torch.data.synthetic import make_synthetic_dataset
from volpick_tpu_torch.models import EQTransformer, PhaseNet
from volpick_tpu_torch.train import trainer as ttrainer

ROWS = 2 * WORLD
LRS = [1e-3 * (i + 1) / 3 for i in range(3)]
EQT = {"in_samples": 1504, "lstm_blocks": 1, "drop_rate": 0.1}
DROPOUT_SEED = 17


def _save_steps(io, case, arch, margs, sd, batches, explicit_mesh):
    meta = {"arch": arch, "model": margs, "lrs": LRS, "dropout_seed": DROPOUT_SEED,
            "explicit_mesh": explicit_mesh}
    arrays = {f"sd.{k}": v.numpy() for k, v in sd.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}.{k}": np.asarray(v, np.float64) for k, v in b.items()})
    np.savez(io / f"{case}_in.npz", meta=json.dumps(meta), **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("dist_ranks")
    rng = np.random.default_rng(6)
    pn = PhaseNet(generator=torch.Generator().manual_seed(2))
    pn_params = perturbed_params(pn)
    pn_batches = [make_batch(rng, ROWS, pn.in_samples, eqt=False) for _ in LRS]
    _save_steps(io, "phasenet_steps", "phasenet", {}, state_dict_from_jax("phasenet", pn_params, np.float64),
                pn_batches, explicit_mesh=False)

    eqt = EQTransformer(generator=torch.Generator().manual_seed(3), **EQT)
    eqt_sd = {k: v.double() if v.is_floating_point() else v for k, v in eqt.state_dict().items()}
    eqt_batches = [make_batch(rng, ROWS, eqt.in_samples, eqt=True) for _ in LRS]
    _save_steps(io, "eqt_steps", "eqtransformer", EQT, eqt_sd, eqt_batches, explicit_mesh=True)

    make_synthetic_dataset(io / "ds", n_events=20, n_noise=6, n_samples=3600, seed=5)
    config = {"model": "PhaseNet", "model_args": {"lr": 2e-3, "sigma": 20}, "data": str(io / "ds"),
              "batch_size": 8, "trainer_args": {"max_epochs": 2}, "stack_data": True, "ema": True,
              "warmup_steps": 4, "save_dir": str(io / "weights")}
    (io / "train_config_in.json").write_text(json.dumps(config))
    run_ranks(io, ["phasenet_steps", "eqt_steps", "train_config"])
    return {"io": io, "pn_params": pn_params, "pn_batches": pn_batches, "eqt_sd": eqt_sd,
            "eqt_batches": eqt_batches}


def _assert_state(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, v in want.items():
        if "num_batches" in name:
            continue
        err = np.abs(got[name] - np.asarray(v, np.float64)).max()
        assert err <= PARAM_ATOL, (what, name, err)


def _assert_callers_model(out, what):
    """The trained model holds plain BatchNorm modules, and a bf16 picker
    built from it (a deep copy) holds bf16 parameters."""
    assert out["plain_bn"].size > 0 and out["plain_bn"].all(), what
    assert list(out["bf16_dtypes"]) == ["torch.bfloat16"], what


def _ranks_agree(outs):
    for key in outs[0]:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)


def test_phasenet_dp_steps_follow_the_sharded_jax_trainer(ranks):
    params = ranks["pn_params"]
    with jax.enable_x64(True):
        jt = JaxTrainer(JaxPhaseNet(), params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params),
                        ema=True, mesh=jax_make_mesh(WORLD))
        jt._build_steps()
        p, o, e = jt.params, jt.opt_state, jt.ema_params
        want = []
        for b, lr in zip(ranks["pn_batches"], LRS):
            p, o, e, loss = jt._train_step(p, o, e, {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}, lr, None)
            want.append(float(loss))
        p, e = jax.device_get((p, e))
    outs = results(ranks["io"], "phasenet_steps")
    _ranks_agree(outs)
    for out in outs:
        np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
        _assert_state(unprefix(out, "p."), {k: v.numpy() for k, v in state_dict_from_jax("phasenet", p, np.float64).items()},
                      "params")
        _assert_state(unprefix(out, "ema."), {k: v.numpy() for k, v in state_dict_from_jax("phasenet", e, np.float64).items()},
                      "ema")
        _assert_callers_model(out, "phasenet")
    assert outs[0]["losses"][-1] < outs[0]["losses"][0]


def test_eqt_dp_steps_with_dropout_equal_one_process(ranks):
    model = EQTransformer(**EQT).double()
    model.load_state_dict(ranks["eqt_sd"], strict=True)
    trainer = ttrainer.Trainer(model, ema=True, device="cpu")
    gen = trainer.dropout_generator(DROPOUT_SEED)
    want = [float(trainer.train_step({k: torch.as_tensor(v, dtype=torch.float64) for k, v in b.items()}, lr, gen))
            for b, lr in zip(ranks["eqt_batches"], LRS)]
    outs = results(ranks["io"], "eqt_steps")
    _ranks_agree(outs)
    moved = max(float(np.abs(outs[0][f"p.{k}"] - v.numpy()).max()) for k, v in ranks["eqt_sd"].items()
                if v.is_floating_point())
    assert moved > 100 * PARAM_ATOL
    for out in outs:
        np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
        _assert_state(unprefix(out, "p."), {k: v.numpy() for k, v in model.state_dict().items()}, "params")
        _assert_state(unprefix(out, "ema."), {k: v.numpy() for k, v in trainer.ema_params.items()}, "ema")
        _assert_callers_model(out, "eqtransformer")


def test_train_config_over_two_ranks(ranks):
    io = ranks["io"]
    outs = results(io, "train_config")
    _ranks_agree(outs)
    exp = io / "weights" / "dp"
    with open(exp / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    np.testing.assert_allclose([float(r["train_loss"]) for r in rows], outs[0]["train_loss"], rtol=1e-6)
    assert np.isfinite(outs[0]["val_loss"]).all()
    ckpts = sorted(os.listdir(exp / "checkpoints"))
    assert "last.ckpt" in ckpts and os.path.basename(str(outs[0]["best"])) in ckpts
    assert sorted(os.listdir(io / "weights")) == ["dp"]
    assert int(outs[0]["restored_step"]) > 0


def test_cli_train_joins_torchruns_world(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(ttrainer, "initialize_distributed", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(ttrainer, "train", lambda config, **kw: kw["device"])
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"model": "PhaseNet", "data": "nowhere"}))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert ttrainer.main(["--config", str(path), "--device", "cpu"]) == "cpu"
    ttrainer.main(["--config", str(path)])
    assert calls == [(("localhost:29500", 2, 1), {"backend": "gloo"}), (("localhost:29500", 2, 1), {"backend": None})]
    monkeypatch.setenv("WORLD_SIZE", "1")
    ttrainer.main(["--config", str(path), "--device", "cpu"])
    assert len(calls) == 2
