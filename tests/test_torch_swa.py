"""SWA in the port's trainer against the JAX trainer's.

- ``train/ema.py::swa_update`` equals JAX's ``swa_update`` on one seeded
  sequence of parameters (float64, 1e-12); the entries it averages are
  exactly the leaves of the JAX params tree, for every architecture, and an
  integer buffer takes the latest value;
- the learning rate of every batch equals the JAX trainer's for
  ``swa_epoch_start`` 2 and 0.75 and ``swa_lrs`` as a scalar and as a list
  (exact; both trainers' steps replaced by recorders), and the history's
  ``lr`` is what JAX logs: the warm-up x plateau lr, not the applied one;
- a short PhaseNet ``fit`` in float64 with SWA follows JAX's
  ``swa_params`` (1e-7, the pin of ``test_torch_trainer.py``'s trajectory
  test) and ``swa_n``;
- ``swa_params`` and ``swa_n`` survive a checkpoint and ``restore``; None
  stays None.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import make_batch, perturbed_params, state_dict_from_jax
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.train import ema as jema
from volpick_tpu.train.trainer import Trainer as JaxTrainer
from volpick_tpu_torch.models import EQTransformer, PhaseNet, TPUPickNet, VolEQTransformer
from volpick_tpu_torch.models.convert import jax_tree_from_model
from volpick_tpu_torch.train import ema as pema
from volpick_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from volpick_tpu_torch.train.trainer import Trainer

SMALL_PN = dict(in_samples=1001, depth=3)


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


def test_swa_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"conv.weight": (4, 3, 5), "conv.bias": (4,), "bn.running_mean": (4,), "bn.running_var": (4,)}
    seq = [{k: rng.normal(size=s) for k, s in shapes.items()} for _ in range(5)]
    with jax.enable_x64(True):
        want = jax.tree_util.tree_map(jnp.asarray, seq[0])
        for n, p in enumerate(seq[1:], start=1):
            want = jema.swa_update(want, jax.tree_util.tree_map(jnp.asarray, p), n)
        want = jax.device_get(want)
    got = {k: torch.as_tensor(v) for k, v in seq[0].items()}
    got["bn.num_batches_tracked"] = torch.tensor(0)
    for n, p in enumerate(seq[1:], start=1):
        state = {k: torch.as_tensor(v) for k, v in p.items()}
        state["bn.num_batches_tracked"] = torch.tensor(10 * n)
        pema.swa_update(got, state, n)
    for k in shapes:
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12)
    assert int(got["bn.num_batches_tracked"]) == 40  # the latest value, not a mean


@pytest.mark.parametrize("cls,kw", [(PhaseNet, {}), (EQTransformer, dict(in_samples=1504, lstm_blocks=1)),
                                    (VolEQTransformer, dict(in_samples=1504, lstm_blocks=1)), (TPUPickNet, {})])
def test_swa_averages_exactly_the_jax_leaves(cls, kw):
    """The floating-point entries of the state dict are the JAX tree's leaves,
    one for one (the converter maps them); the others are integer buffers."""
    model = cls(generator=torch.Generator().manual_seed(0), **kw)
    sd = model.state_dict()
    floating = {k for k, v in sd.items() if v.is_floating_point()}
    leaves = jax.tree_util.tree_leaves(jax_tree_from_model(model))
    assert len(leaves) == len(floating)
    assert sum(v.numel() for k, v in sd.items() if k in floating) == sum(np.size(leaf) for leaf in leaves)
    assert all(k.endswith("num_batches_tracked") for k in set(sd) - floating)


def _jax_lrs(swa, epochs, n_batches, warmup, tmp_path):
    model = PhaseNet(generator=torch.Generator().manual_seed(1), **SMALL_PN)
    jt = JaxTrainer(JaxPhaseNet(**SMALL_PN), params=jax_tree_from_model(model), swa=swa, warmup_steps=warmup)
    lrs = []

    def step(p, o, e, batch, lr, rng):
        lrs.append(lr)
        return p, o, e, jnp.float32(0.5)

    jt._train_step = step
    batch = {"X": np.zeros((8, 3, 8), np.float32)}  # the batch sharding splits 8 ways
    out = jt.fit(_Batches([batch] * n_batches), None, max_epochs=epochs, save_dir=str(tmp_path / "jax"),
                 tensorboard=False)
    return lrs, out["history"], jt.swa_n


def _port_lrs(swa, epochs, n_batches, warmup, tmp_path):
    model = PhaseNet(generator=torch.Generator().manual_seed(1), **SMALL_PN)
    tt = Trainer(model, swa=swa, warmup_steps=warmup, device="cpu")
    lrs = []

    def step(batch, lr, generator=None):
        lrs.append(lr)
        return torch.tensor(0.5)

    tt.train_step = step
    out = tt.fit(_Batches([{}] * n_batches), None, max_epochs=epochs, save_dir=str(tmp_path / "port"),
                 tensorboard=False)
    return lrs, out["history"], tt.swa_n


@pytest.mark.parametrize("start", [2, 0.75])
@pytest.mark.parametrize("swa_lrs", [5e-5, [5e-5, 1e-4]])
def test_swa_lr_sequence_matches_jax(start, swa_lrs, tmp_path):
    swa = {"swa_lrs": swa_lrs, "swa_epoch_start": start}
    epochs, n_batches, warmup = 4, 3, 5
    got, got_hist, got_n = _port_lrs(swa, epochs, n_batches, warmup, tmp_path)
    want, want_hist, want_n = _jax_lrs(swa, epochs, n_batches, warmup, tmp_path)
    assert got == want
    first = {2: 2, 0.75: 3}[start]  # int(2), int(0.75 * 4)
    assert got[first * n_batches:] == [5e-5] * ((epochs - first) * n_batches)
    assert all(lr != 5e-5 for lr in got[: first * n_batches])
    assert got_n == want_n == epochs - first
    # the history logs the warm-up x plateau lr, as JAX's does, also in SWA epochs
    assert [h["lr"] for h in got_hist] == [h["lr"] for h in want_hist]
    assert all(h["lr"] != 5e-5 for h in got_hist)


def test_phasenet_fit_with_swa_follows_jax(tmp_path):
    """PhaseNet, 3 epochs of 2 batches, SWA from epoch 1 at swa_lrs 5e-4:
    both trainers in float64 collect the same averages of the parameters
    and BatchNorm statistics (1e-7) over the same 2 epochs."""
    port = PhaseNet(generator=torch.Generator().manual_seed(2), **SMALL_PN)
    params = perturbed_params(port)
    port.load_state_dict(state_dict_from_jax("phasenet", params, np.float64), strict=True)
    port.double()
    rng = np.random.default_rng(6)
    batches = [make_batch(rng, 8, port.in_samples, eqt=False) for _ in range(2)]
    swa = {"swa_lrs": 5e-4, "swa_epoch_start": 1}
    kw = dict(max_epochs=3, tensorboard=False)
    with jax.enable_x64(True):
        jt = JaxTrainer(JaxPhaseNet(**SMALL_PN), params=jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params), lr=2e-3, swa=swa, warmup_steps=2)
        jb = [{k: np.asarray(v, np.float64) for k, v in b.items()} for b in batches]
        want = jt.fit(_Batches(jb), None, save_dir=str(tmp_path / "jax"), **kw)
        want_swa = jax.device_get(jt.swa_params)
    tt = Trainer(port, lr=2e-3, swa=swa, warmup_steps=2, device="cpu")
    tb = [{k: torch.as_tensor(v, dtype=torch.float64) for k, v in b.items()} for b in batches]
    got = tt.fit(_Batches(tb), None, save_dir=str(tmp_path / "port"), **kw)
    assert tt.swa_n == jt.swa_n == 2
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in want["history"]], rtol=1e-6)
    for name, v in state_dict_from_jax("phasenet", want_swa, np.float64).items():
        if "num_batches" in name:
            assert torch.equal(tt.swa_params[name], port.state_dict()[name])
            continue
        assert (tt.swa_params[name] - v).abs().max().item() <= 1e-7, name
    # the averages are not the weights: SWA collects only, as in JAX
    assert any(not torch.equal(tt.swa_params[k], v) for k, v in port.state_dict().items())
    raw = load_checkpoint(tmp_path / "port" / "exp" / "checkpoints" / "last.ckpt")
    assert raw["swa_n"] == 2
    for k, v in tt.swa_params.items():
        assert torch.equal(raw["swa_params"][k], v)


def test_checkpoint_round_trip_and_restore(tmp_path):
    model = PhaseNet(generator=torch.Generator().manual_seed(3), **SMALL_PN)
    swa = {"swa_lrs": 5e-5, "swa_epoch_start": 0.75}
    t1 = Trainer(model, ema=True, swa=swa, device="cpu")
    t1.swa_params = {k: v + 1 if v.is_floating_point() else v + 7 for k, v in pema.ema_state_of(model).items()}
    t1.swa_n, t1.step = 3, 12
    save_checkpoint(tmp_path / "c.ckpt", t1._state(epoch=4))
    fresh = PhaseNet(generator=torch.Generator().manual_seed(4), **SMALL_PN)
    t2 = Trainer(fresh, ema=True, swa=swa, device="cpu").restore(tmp_path / "c.ckpt")
    assert t2.swa_n == 3 and t2.step == 12 and t2.start_epoch == 5
    assert set(t2.swa_params) == set(t1.swa_params)
    for k, v in t1.swa_params.items():
        assert torch.equal(t2.swa_params[k], v) and t2.swa_params[k].device.type == "cpu"
    # no SWA: None written, None read back
    t3 = Trainer(PhaseNet(**SMALL_PN), device="cpu")
    save_checkpoint(tmp_path / "d.ckpt", t3._state(epoch=0))
    raw = load_checkpoint(tmp_path / "d.ckpt")
    assert raw["swa_params"] is None and raw["swa_n"] == 0
    t4 = Trainer(PhaseNet(**SMALL_PN), swa=swa, device="cpu").restore(tmp_path / "d.ckpt")
    assert t4.swa_params is None and t4.swa_n == 0
    assert math.isinf(t4.plateau.best)
