"""``train(config)`` of the port end to end on the CPU, on a tiny dataset
written by the port's ``data/synthetic.py``: the artefacts of
tests/test_train.py (metrics.csv, hparams.json, TensorBoard events,
last.ckpt, one best checkpoint, the -EMA pairs), resume continuing epoch
numbering with save_top_k held, ``check_val_every_n_epoch``, and the models
``load_best_model`` / ``load_last_model`` give back.
"""

import csv
import glob
import math
import os

import pytest
import torch

from volpick_tpu_torch.data.synthetic import make_synthetic_dataset
from volpick_tpu_torch.train.checkpoints import load_checkpoint
from volpick_tpu_torch.train.model_io import load_best_model, load_last_model
from volpick_tpu_torch.train.trainer import train


@pytest.fixture(scope="module")
def synth_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_ds")
    make_synthetic_dataset(d, n_events=20, n_noise=6, n_samples=3600, seed=5)
    return d


def _phasenet(synth_path, tmp_path, **extra):
    return dict({
        "model": "PhaseNet",
        "model_args": {"lr": 2e-3, "sigma": 20},
        "data": str(synth_path),
        "batch_size": 8,
        "trainer_args": {"max_epochs": 1},
        "stack_data": True,
        "warmup_steps": 4,
        "save_dir": str(tmp_path / "weights"),
    }, **extra)


def test_phasenet_resume_and_artefacts(synth_path, tmp_path):
    config = _phasenet(synth_path, tmp_path)
    first = train(config, experiment_name="resumable", device="cpu")
    hist = first["history"]
    assert [h["epoch"] for h in hist] == [0]
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"]) for h in hist)
    exp = first["exp_dir"]
    for f in ("metrics.csv", "hparams.json", "running_time.txt", "checkpoints/last.ckpt"):
        assert os.path.exists(os.path.join(exp, f)), f
    assert glob.glob(os.path.join(exp, "tensorboard", "events.out.tfevents.*"))
    assert first["best_checkpoint"] != "None"

    config["trainer_args"]["max_epochs"] = 3
    config["resume"] = True
    second = train(config, experiment_name="resumable", device="cpu")
    assert [h["epoch"] for h in second["history"]] == [1, 2]
    assert second["history"][0]["step"] > hist[-1]["step"]
    with open(os.path.join(exp, "metrics.csv")) as f:
        assert [int(r["epoch"]) for r in csv.DictReader(f)] == [0, 1, 2]
    raw = load_checkpoint(os.path.join(exp, "checkpoints", "last.ckpt"))
    assert int(raw["epoch"]) == 2 and raw["best_monitor"] is not None and math.isfinite(raw["best_monitor"])
    assert raw["opt_state"]["count"] == raw["step"] == second["history"][-1]["step"]
    assert len(glob.glob(os.path.join(exp, "checkpoints", "epoch=*-step=*.ckpt"))) == 1

    last = load_last_model(exp, "phasenet", device="cpu")
    best = load_best_model(exp, "phasenet", device="cpu")
    for k, v in last.state_dict().items():
        assert torch.equal(v, raw["params"][k])
    assert not best.training and next(best.parameters()).device.type == "cpu"


def test_eqt_with_ema_and_validation_cadence(synth_path, tmp_path):
    config = {
        "model": "EQTransformer",
        "model_args": {"lr": 1e-3, "sigma": 20, "in_samples": 1504, "lstm_blocks": 1},
        "data": str(synth_path),
        "batch_size": 8,
        "trainer_args": {"max_epochs": 3, "check_val_every_n_epoch": 2},
        "stack_data": False,
        "ema": True,
        "warmup_steps": 2,
        "save_dir": str(tmp_path / "weights"),
    }
    result = train(config, experiment_name="smoke_eqt", test_run=True, device="cpu")
    hist = result["history"]
    assert all(math.isfinite(h["train_loss"]) for h in hist)
    # validation on epoch 1 ((1+1) % 2 == 0) and on the last one
    assert [h["epoch"] for h in hist if math.isfinite(h["val_loss"])] == [1, 2]
    ckpts = sorted(os.path.basename(p) for p in glob.glob(os.path.join(result["exp_dir"], "checkpoints", "*")))
    assert "last-EMA.ckpt" in ckpts and "last.ckpt" in ckpts
    assert sum(c.endswith("-EMA.ckpt") and c.startswith("epoch=") for c in ckpts) == 1
    # test runs write no TensorBoard events, as the reference
    assert not os.path.exists(os.path.join(result["exp_dir"], "tensorboard"))
    ema = load_best_model(result["exp_dir"], "eqtransformer", {"in_samples": 1504, "lstm_blocks": 1},
                          device="cpu")
    live = load_best_model(result["exp_dir"], "eqtransformer", {"in_samples": 1504, "lstm_blocks": 1},
                           prefer_ema=False, device="cpu")
    assert not torch.equal(ema.encoder.convs[0].weight, live.encoder.convs[0].weight)
