"""The port's labels, losses, schedules, EMA rule, checkpoints, tensorboard
writer and the autograd guard of the CUDA wrappers, against the JAX package.

Same seeded numpy inputs through both packages; the JAX side is computed
(and waited for) first, the torch side then runs on one thread
(``torch_alone``, see tests/torch_train_common.py). Tolerance 1e-6 absolute
on labels, losses and the EMA rule; schedules, event files and checkpoint
bookkeeping exactly equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import torch_alone
from volpick_tpu.ops import labels as jlabels
from volpick_tpu.train import ema as jema
from volpick_tpu.train import losses as jlosses
from volpick_tpu.train import schedules as jsched
from volpick_tpu.utils import tensorboard as jtb
from volpick_tpu_torch.ops import labels as tlabels
from volpick_tpu_torch.ops.cuda import refuse_autograd
from volpick_tpu_torch.train import checkpoints as tckpt
from volpick_tpu_torch.train import ema as tema
from volpick_tpu_torch.train import losses as tlosses
from volpick_tpu_torch.train import schedules as tsched
from volpick_tpu_torch.utils import tensorboard as ttb

TOL = 1e-6


def _onsets(rng, b=6, w=400):
    on = rng.uniform(-60, w + 60, (b, 2)).astype(np.float32)
    on[1, 0] = np.nan  # no P
    on[2, :] = np.nan  # noise trace
    on[3, 1] = np.nan  # no S
    on[4] = [-30.5, 17.25]  # a P before the window paints its tail
    return on


@pytest.mark.parametrize("shape", ["gaussian", "triangle", "box"])
@pytest.mark.parametrize("noise_column", [True, False])
def test_probabilistic_labels_match_jax(shape, noise_column):
    on = _onsets(np.random.default_rng(1))
    want = np.asarray(jlabels.probabilistic_labels(jnp.asarray(on), 400, sigma=20.0, shape=shape,
                                                   noise_column=noise_column))
    with torch_alone():
        got = tlabels.probabilistic_labels(torch.as_tensor(on), 400, sigma=20.0, shape=shape,
                                           noise_column=noise_column).numpy()
    assert got.shape == want.shape == (6, 3 if noise_column else 2, 400)
    np.testing.assert_allclose(got, want, atol=TOL)
    with pytest.raises(ValueError):
        tlabels.probabilistic_labels(torch.as_tensor(on), 400, shape="cosine")


def test_renormalize_and_detection_labels_match_jax():
    rng = np.random.default_rng(2)
    y = rng.uniform(0, 0.8, (4, 3, 300)).astype(np.float32)
    want = np.asarray(jlabels.renormalize_labels(jnp.asarray(y)))
    with torch_alone():
        np.testing.assert_allclose(tlabels.renormalize_labels(torch.as_tensor(y)).numpy(), want, atol=TOL)
    on = _onsets(rng)
    for fixed in (None, 150):
        want = np.asarray(jlabels.detection_labels(jnp.asarray(on[:, 0]), jnp.asarray(on[:, 1]), 400,
                                                   factor=1.4, fixed_window=fixed))
        got = tlabels.detection_labels(torch.as_tensor(on[:, 0]), torch.as_tensor(on[:, 1]), 400,
                                       factor=1.4, fixed_window=fixed).numpy()
        assert got.shape == (6, 1, 400)
        np.testing.assert_array_equal(got, want)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    yp = rng.random((4, 3, 200)).astype(np.float32)
    yp /= yp.sum(1, keepdims=True)
    yt = rng.random((4, 3, 200)).astype(np.float32)
    heads = [rng.random((4, 200)).astype(np.float32) for _ in range(4)]
    heads[0][0, :5] = [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5]  # the clip at eps
    targets = [(rng.random((4, 200)) > 0.5).astype(np.float32) for _ in range(4)]
    w3, w4 = (0.05, 0.40, 0.55), (0.05, 0.1, 0.4, 0.45)
    j = [jnp.asarray(a) for a in heads + targets]
    want = [float(jlosses.vector_cross_entropy(jnp.asarray(yp), jnp.asarray(yt))),
            float(jlosses.bce(j[0], j[4])),
            float(jlosses.weighted_bce(j[0], j[1], j[2], j[4], j[5], j[6], w3)),
            float(jlosses.vol_eqt_loss(*j, w4))]
    t = [torch.as_tensor(a) for a in heads + targets]
    with torch_alone():
        got = [float(tlosses.vector_cross_entropy(torch.as_tensor(yp), torch.as_tensor(yt))),
               float(tlosses.bce(t[0], t[4])),
               float(tlosses.weighted_bce(t[0], t[1], t[2], t[4], t[5], t[6], w3)),
               float(tlosses.vol_eqt_loss(*t, w4))]
    np.testing.assert_allclose(got, want, atol=TOL)


def test_schedules_give_the_same_sequences():
    assert [tsched.warmup_scale(s, w) for s in range(-1, 700, 7) for w in (0, 1, 500)] == \
        [jsched.warmup_scale(s, w) for s in range(-1, 700, 7) for w in (0, 1, 500)]
    metrics = list(np.random.default_rng(4).uniform(0.5, 1.0, 60)) + [0.4] * 40 + [0.39999] * 10
    for kw in (dict(base_lr=1.0, factor=0.5, patience=2, min_lr=0.1),
               dict(base_lr=1e-3, factor=0.3, patience=0, cooldown=3, threshold_mode="abs")):
        a, b = tsched.PlateauScheduler(**kw), jsched.PlateauScheduler(**kw)
        assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
        assert (a.best, a.num_bad_epochs, a.cooldown_counter) == (b.best, b.num_bad_epochs, b.cooldown_counter)
    for patience in (0, 3):
        a, b = tsched.EarlyStopper(patience=patience), jsched.EarlyStopper(patience=patience)
        assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]


def test_ema_rule_matches_jax():
    """Parameters averaged, BatchNorm running statistics copied from the live
    model: the JAX rule on the converter's tree."""
    rng = np.random.default_rng(5)
    model = torch.nn.Sequential(torch.nn.Conv1d(3, 4, 3), torch.nn.BatchNorm1d(4))
    ema = tema.ema_state_of(model)
    tree_e = {"conv": {"w": ema["0.weight"].numpy().copy(), "b": ema["0.bias"].numpy().copy()},
              "bn": {"scale": ema["1.weight"].numpy().copy(), "bias": ema["1.bias"].numpy().copy(),
                     "mean": ema["1.running_mean"].numpy().copy(), "var": ema["1.running_var"].numpy().copy()}}
    for _ in range(3):
        with torch.no_grad():
            for v in model.state_dict().values():
                if v.dtype == torch.float32:
                    v.copy_(torch.as_tensor(rng.normal(size=v.shape).astype(np.float32)))
        sd = model.state_dict()
        tree_p = {"conv": {"w": sd["0.weight"].numpy(), "b": sd["0.bias"].numpy()},
                  "bn": {"scale": sd["1.weight"].numpy(), "bias": sd["1.bias"].numpy(),
                         "mean": sd["1.running_mean"].numpy(), "var": sd["1.running_var"].numpy()}}
        tema.ema_update(ema, model, 0.9)
        tree_e = jema.ema_update(tree_e, tree_p, 0.9)
    pairs = {"0.weight": ("conv", "w"), "0.bias": ("conv", "b"), "1.weight": ("bn", "scale"),
             "1.bias": ("bn", "bias"), "1.running_mean": ("bn", "mean"), "1.running_var": ("bn", "var")}
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(ema[name].numpy(), np.asarray(tree_e[a][b]), atol=TOL, err_msg=name)
    np.testing.assert_array_equal(ema["1.running_mean"].numpy(), model.state_dict()["1.running_mean"].numpy())


def test_tensorboard_events_are_the_jax_bytes(tmp_path, monkeypatch):
    assert ttb.crc32c(b"volpick") == jtb.crc32c(b"volpick")
    for step, (tag, value) in enumerate([("train_loss", 0.25), ("lr", 1e-3), ("val_loss", math.nan)]):
        assert ttb.encode_scalar_event(1700000000.5, step, tag, value) == \
            jtb.encode_scalar_event(1700000000.5, step, tag, value)
        payload = ttb.encode_scalar_event(1.0, step, tag, value)
        assert ttb.frame_record(payload) == jtb.frame_record(payload)
    monkeypatch.setattr(ttb.time, "time", lambda: 1234.5)
    monkeypatch.setattr(jtb.time, "time", lambda: 1234.5)
    paths = []
    for mod, sub in ((ttb, "t"), (jtb, "j")):
        with mod.TensorBoardLogger(tmp_path / sub) as log:
            log.log_scalars({"epoch": 1, "step": 3, "train_loss": 0.5, "flag": True, "lr": 2e-3}, 3)
            paths.append(log.path)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_checkpoint_manager_keeps_one_best_across_restarts(tmp_path):
    d = tmp_path / "checkpoints"
    state = {"params": {"w": torch.zeros(2)}, "ema_params": {"w": torch.ones(2)}}
    first = tckpt.CheckpointManager(d, monitor="val_loss", save_ema=True)
    first.update(state, {"val_loss": 1.0}, epoch=0, step=10)
    first.update(state, {"val_loss": math.nan}, epoch=1, step=20)  # the NaN guard
    first.update(state, {"val_loss": 0.5}, epoch=2, step=30)
    assert sorted(p.name for p in d.glob("epoch=*.ckpt")) == ["epoch=2-step=30-EMA.ckpt", "epoch=2-step=30.ckpt"]
    ema = tckpt.load_checkpoint(d / "epoch=2-step=30-EMA.ckpt")
    assert torch.equal(ema["params"]["w"], torch.ones(2)) and ema["best_monitor"] == 0.5
    second = tckpt.CheckpointManager(d, monitor="val_loss", save_ema=True)
    second.best = 0.5
    assert second.best_path == d / "epoch=2-step=30.ckpt"
    second.update(state, {"val_loss": 0.6}, epoch=3, step=40)
    second.update(state, {"val_loss": 0.25}, epoch=4, step=50)
    assert sorted(p.name for p in d.glob("epoch=*.ckpt")) == ["epoch=4-step=50-EMA.ckpt", "epoch=4-step=50.ckpt"]
    # find_best_checkpoint reads metrics.csv as the JAX function does
    (tmp_path / "metrics.csv").write_text("epoch,step,val_loss\n4,50,0.25\n3,40,0.6\n")
    assert tckpt.find_best_checkpoint(tmp_path) == d / "epoch=4-step=50-EMA.ckpt"
    assert tckpt.find_best_checkpoint(tmp_path, prefer_ema=False) == d / "epoch=4-step=50.ckpt"


def test_refuse_autograd():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    refuse_autograd("k", a=y)
    with pytest.raises(ValueError, match="k: b require\\(s\\) grad.*no backward"):
        refuse_autograd("k", a=y, b=x)
    with torch.no_grad():
        refuse_autograd("k", a=y, b=x)
    with torch.inference_mode():
        refuse_autograd("k", b=x)


def test_port_modules_import_no_jax_optax_flax_pandas_or_h5py():
    """Every module of the port, the training slice among them, imports none
    of JAX, optax, flax or the JAX package, and leaves pandas and h5py to
    the functions that read or write files (the card machine has no h5py)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, pkgutil, sys, volpick_tpu_torch\n"
        "for m in pkgutil.walk_packages(volpick_tpu_torch.__path__, 'volpick_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for want in ('ops.labels', 'data.dataset', 'data.writer', 'data.synthetic', 'acquisition.convert',\n"
        "             'pipeline.augmentations', 'pipeline.generator', 'train.losses', 'train.schedules',\n"
        "             'train.ema', 'train.checkpoints', 'train.trainer', 'train.model_io', 'utils.tensorboard'):\n"
        "    assert 'volpick_tpu_torch.' + want in sys.modules, want\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'flax', 'volpick_tpu', 'pandas', 'h5py')]\n"
        "print('BAD', sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
