"""The port's command line (``python -m volpick_tpu_torch``) and its training
helpers (``train/lr_finder.py``, ``train/sweep.py``) against the JAX package.

- ``targets`` writes the JAX package's target CSVs byte for byte;
  ``evaluate --device cpu`` runs the harness on a small PhaseNet exported
  with ``train/model_io.py::export_pretrained`` and writes what the library
  calls write; without ``--device`` it asks for the card and, with none,
  raises naming ``device="cpu"``; ``train`` hands ``--device`` on.
- ``lr_find`` leaves the trainer's parameters, BatchNorm statistics,
  gradients, Adam state, EMA and mode bit-equal, and, fed the same loss
  sequence, returns what JAX's ``lr_find`` returns (suggestion, lrs,
  smoothed losses; divergence, a non-finite loss, fewer than 5 steps, a
  generator that runs out).
- ``generate_sweep_configs`` writes JAX's file names and contents;
  ``run_sweep`` hands each config to the port's ``train`` with `device`.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_eval_common import DS
from tests.torch_train_common import make_batch, torch_alone
from volpick_tpu.data.synthetic import make_synthetic_dataset
from volpick_tpu.eval import targets as jtargets
from volpick_tpu.train import lr_finder as jlr
from volpick_tpu.train import sweep as jsweep
from volpick_tpu_torch import __main__ as cli
from volpick_tpu_torch.eval import eval_task0
from volpick_tpu_torch.models import PhaseNet, from_pretrained
from volpick_tpu_torch.train import lr_finder as plr
from volpick_tpu_torch.train import sweep as psweep
from volpick_tpu_torch.train import trainer as ptrainer
from volpick_tpu_torch.train.model_io import export_pretrained
from volpick_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the
    CPU, XLA's threads among them."""
    with torch_alone():
        yield


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_ds")
    make_synthetic_dataset(d, **DS)
    return d


def _run(args, env=None, timeout=300):
    """The command line in a fresh interpreter, torch on one thread as in this module."""
    out = subprocess.run([sys.executable, "-m", "volpick_tpu_torch", *args], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_targets_and_evaluate_commands(ds_dir, tmp_path):
    from volpick_tpu.data import VCSEIS

    _run(["targets", "--data", str(ds_dir), "--output", str(tmp_path / "t")])
    jds = VCSEIS(ds_dir)
    jtargets.generate_task0(jds, tmp_path / "jt", noise_before_events=True)
    jtargets.generate_task1(jds, tmp_path / "jt", noise_before_events=True)
    jtargets.generate_task23(jds, tmp_path / "jt")
    for name in ("task0", "task1", "task23"):
        assert (tmp_path / "t" / f"{name}.csv").read_bytes() == (tmp_path / "jt" / f"{name}.csv").read_bytes()

    model = PhaseNet(generator=torch.Generator().manual_seed(2)).eval()
    export_pretrained(model, tmp_path / "models", name="mine")
    stdout = _run(["evaluate", "--data", str(ds_dir), "--targets", str(tmp_path / "t"), "--output",
                   str(tmp_path / "e"), "--model", "phasenet", "--weights", "mine", "--batch-size", "8",
                   "--device", "cpu"], env={"VOLPICK_TPU_MODELS": str(tmp_path / "models")})
    stats = json.loads(stdout)
    assert {"p_threshold", "s_threshold", "dev_det_auc", "test_det_f1"} <= set(stats)
    for name in ("dev_metrics", "test_metrics", "dev_task0", "dev_task1", "test_task23"):
        assert (tmp_path / "e" / f"{name}.csv").exists(), name
    # the command's sweep is the library call's
    from volpick_tpu_torch.data.dataset import load_dataset

    again = from_pretrained("phasenet", "mine", search_paths=[str(tmp_path / "models")], device="cpu")
    eval_task0(again, load_dataset(ds_dir), tmp_path / "t", tmp_path / "lib", batch_size=8, device="cpu")
    for name in ("test_metrics", "test_task0"):
        assert (tmp_path / "e" / f"{name}.csv").read_bytes() == (tmp_path / "lib" / f"{name}.csv").read_bytes()


def test_evaluate_defaults_to_the_card(ds_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = PhaseNet(generator=torch.Generator().manual_seed(2)).eval()
    export_pretrained(model, tmp_path / "models", name="mine")
    monkeypatch.setenv("VOLPICK_TPU_MODELS", str(tmp_path / "models"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["evaluate", "--data", str(ds_dir), "--targets", str(tmp_path), "--output", str(tmp_path / "e"),
                  "--weights", "mine"])


def test_train_command_hands_the_device_on(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(ptrainer, "main", lambda argv: seen.append(argv))
    cli.main(["train", "--config", "c.json", "--test_run", "--device", "cpu"])
    cli.main(["train", "--config", "c.json"])
    assert seen == [["--config", "c.json", "--test_run", "--device", "cpu"], ["--config", "c.json"]]


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


def test_lr_find_leaves_the_trainer_as_it_was():
    rng = np.random.default_rng(0)
    model = PhaseNet(generator=torch.Generator().manual_seed(1), in_samples=1001, depth=3)
    batches = [{k: torch.as_tensor(v) for k, v in make_batch(rng, 4, 1001, eqt=False).items()} for _ in range(3)]
    trainer = Trainer(model, ema=True, warmup_steps=0, device="cpu")
    trainer.train_step(batches[0], 1e-3)  # moments, EMA and gradients that are not zero
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in trainer.opt_state.items()}
    ema = {k: v.clone() for k, v in trainer.ema_params.items()}
    res = plr.lr_find(trainer, _Batches(batches), num_training=7)
    assert len(res["losses"]) == len(res["lrs"]) == 7 and res["suggestion"] in res["lrs"]
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, grads[n]), n
    assert trainer.opt_state["count"] == opt["count"]
    for part in ("mu", "nu"):
        for n, t in opt[part].items():
            assert torch.equal(trainer.opt_state[part][n], t), (part, n)
    for k, v in ema.items():
        assert torch.equal(trainer.ema_params[k], v), k


class _JaxTrainer:
    """What JAX's lr_find touches of its trainer, with float32 losses from a
    list (the port's fake returns the same float32 scalars as tensors)."""

    def __init__(self, losses):
        self._losses = iter(losses)
        self._train_step = lambda p, o, e, batch, lr, key: (p, o, e, np.float32(next(self._losses)))
        self.params = self.opt_state = self.ema_params = self.batch_sharding = None


class _PortTrainer:
    def __init__(self, losses):
        self._losses = iter(losses)
        self.model = torch.nn.Linear(2, 1)
        self.opt_state, self.ema_params, self.device = {}, None, torch.device("cpu")

    def train_step(self, batch, lr, generator=None):
        return torch.tensor(np.float32(next(self._losses)))

    def batches(self, gen):
        return gen.epoch()

    def dropout_generator(self, seed):
        return torch.Generator().manual_seed(seed)


LOSS_CASES = {
    "dip": [2.0 - np.sin(i / 6) * (1 + i / 40) for i in range(30)],
    "diverges": [1.0, 0.9, 0.8, 0.7, 0.65, 0.6, 0.7, 1.5, 4.0, 30.0, 90.0] + [100.0] * 19,
    "nan": [1.0, 0.9, 0.8, 0.75, 0.7, 0.68, float("nan")] + [1.0] * 23,
    "early": [1.0, 0.5, 50.0] + [1.0] * 27,
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lr_find_follows_jax_on_a_loss_list(case):
    losses = LOSS_CASES[case]
    gen = _Batches([{"x": np.zeros(1, np.float32)}] * 4)  # an epoch of 4: the finder restarts it
    got = plr.lr_find(_PortTrainer(losses), gen, num_training=len(losses))
    want = jlr.lr_find(_JaxTrainer(losses), gen, num_training=len(losses))
    assert got["suggestion"] == want["suggestion"]
    assert got["lrs"] == want["lrs"]
    np.testing.assert_array_equal(got["losses"], want["losses"])


def test_sweep_configs_are_jax_files(tmp_path):
    base = json.loads((REPO / "examples" / "configs" / "phasenet_vcseis.json").read_text())
    grid = {"batch_size": [256, 512], "model_args.lr": [5e-4, 1e-3], "model_args.sigma": [10, 20]}
    for name_keys in (None, ["model_args.lr"]):
        got = psweep.generate_sweep_configs(base, grid, tmp_path / "port", name_keys=name_keys)
        want = jsweep.generate_sweep_configs(base, grid, tmp_path / "jax", name_keys=name_keys)
        assert [p.name for p in got] == [p.name for p in want]
        for g, w in zip(got, want):
            assert g.read_bytes() == w.read_bytes()


def test_run_sweep_trains_each_config_on_the_device(tmp_path, monkeypatch):
    calls = []

    def fake_train(cfg, experiment_name, test_run, device):
        calls.append((cfg["batch_size"], experiment_name, test_run, device))
        return {"best": 1.0}

    monkeypatch.setattr(ptrainer, "train", fake_train)
    paths = psweep.generate_sweep_configs({"model": "PhaseNet", "batch_size": 8}, {"batch_size": [8, 16]}, tmp_path)
    res = psweep.run_sweep(paths, test_run=True, device="cpu")
    assert calls == [(8, "p_batch_size=8", True, "cpu"), (16, "p_batch_size=16", True, "cpu")]
    assert [r["config"] for r in res] == [str(p) for p in paths]
    assert pd.Series([r["best"] for r in res]).eq(1.0).all()
