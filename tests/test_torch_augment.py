"""The port's augmentation blocks against the JAX package's, fed the JAX
blocks' own draws.

JAX draws from split PRNG keys; the port's blocks take their draws as
tensors. Each test re-derives the draws from the key the JAX block gets, by
the split structure of that block (``select_window_offsets``:
split(split(key)[0], 4); ``stack_block``: split(key, 10), a superimpose
pass split(key); rotation split(key); gap split(key, 3);
``augment_train_batch``: split(key, 8)), hands them to the port, and holds
X, y, detections and the window-relative onsets to the JAX output within
1e-6. The degenerate configurations of tests/test_pipeline.py
(TestSuperimposeMechanics: one mode drawn with probability 1, a placement
range of width 1) are held to JAX as well as to their closed form.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import (
    as_jax,
    as_torch,
    assert_close,
    jcfg,
    raw_batch,
    torch_alone,
    stack_draws,
    window_draws,
)
from volpick_tpu.ops.labels import probabilistic_labels
from volpick_tpu.pipeline import augmentations as jaug
from volpick_tpu_torch.pipeline import augmentations as taug

CFG_PN = taug.AugmentConfig(window=3001, stack=True)
CFG_EQT = taug.AugmentConfig(window=6000, pre_window=12000, samples_before=6000, noise_column=False,
                             detection=True, detrend=True, stack=True)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("cfg", [
    CFG_PN, CFG_EQT, CFG_EQT.for_secondary(), CFG_PN.for_secondary(),
    dataclasses.replace(CFG_PN, low=500, high=5000, label_shape="triangle", norm="std"),
    dataclasses.replace(CFG_PN, pre_windowed=True),
], ids=["phasenet", "eqt", "eqt-secondary", "phasenet-secondary", "bounds-triangle-std", "pre-windowed"])
def test_window_and_label_matches_jax(cfg):
    rng = np.random.default_rng(0)
    w_raw = cfg.window if cfg.pre_windowed else 15000
    raw = raw_batch(rng, 16, w_raw, short=None if cfg.pre_windowed else 7000)
    raw["p"][3] = raw["s"][3] = np.nan  # a noise trace among them
    key = jax.random.PRNGKey(11)
    want = jax.block_until_ready(
        jaug.window_and_label(key, *(jnp.asarray(raw[k]) for k in ("x", "len", "p", "s")), jcfg(cfg)))
    draws = window_draws(key, 16, cfg)
    with torch_alone():
        got = taug.window_and_label(*(torch.as_tensor(raw[k]) for k in ("x", "len", "p", "s")), cfg, draws)
    keys = ["X", "y", "p", "s"] + (["detections"] if cfg.detection else [])
    assert set(got) == set(want)
    for k in ("p", "s"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert_close(got, want, keys)


@pytest.mark.parametrize("cfg", [CFG_PN, CFG_EQT, dataclasses.replace(CFG_PN, p_event_modes=(0.4, 0.4, 0.2),
                                                                        p_two_events=0.7)],
                         ids=["phasenet", "eqt", "stack-often"])
def test_stack_block_matches_jax(cfg):
    """Every event and noise mode drawn across 48 rows: the windows come from
    JAX's own window block, the same for both packages."""
    rng = np.random.default_rng(1)
    b, jc = 48, jcfg(cfg)
    sec_cfg = jc.for_secondary()
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    wins = [jaug.window_and_label(k, *(jnp.asarray(r[f]) for f in ("x", "len", "p", "s")), c)
            for k, r, c in zip(keys, [raw_batch(rng, b, 15000) for _ in range(3)]
                               + [raw_batch(rng, b, 15000, picks=False) for _ in range(2)],
                               (jc, sec_cfg, sec_cfg, jc, jc))]
    prim, sec, sec2, noi, noi2 = wins
    want = jax.block_until_ready(jaug.stack_block(keys[5], prim, sec, sec2, noi["X"], noi2["X"], jc))
    draws = stack_draws(keys[5], b, 3, cfg)
    with torch_alone():
        got = taug.stack_block(as_torch(prim), as_torch(sec), as_torch(sec2), torch.as_tensor(np.array(noi["X"])),
                               torch.as_tensor(np.array(noi2["X"])), cfg, draws)
    modes = draws["mode_e"].numpy()
    assert {0, 1, 2} <= set(modes.tolist()) and {0, 1, 2} <= set(draws["mode_n"].numpy().tolist())
    assert_close(got, want, ["X", "y"] + (["detections"] if cfg.detection else []))
    # the stacking changed rows of both event modes
    changed = np.abs(np.asarray(want["y"]) - np.asarray(prim["y"])).max(axis=(1, 2)) > 0.5
    assert changed[modes == 0].any() and changed[modes == 1].any()


def _mechanics_case(mode, sep=200, p1=1000.0, s1=1200.0):
    fee = int(s1 + max(1.4 * (s1 - p1), sep) + 0.2 * sep)
    n = fee + 2 * sep + 1 if mode == 0 else fee + 3 * sep
    cfg = taug.AugmentConfig(window=n, stack=True, sep=sep, p_event_modes=(1.0, 0.0, 0.0) if mode == 0
                             else (0.0, 1.0, 0.0), p_two_events=0.0, p_noise_modes=(0.0, 0.0, 1.0))
    return cfg, fee, n


@pytest.mark.parametrize("mode", [0, 1], ids=["superimpose", "duplicate"])
def test_superimpose_mechanics_match_jax_and_closed_form(mode):
    """tests/test_pipeline.py::TestSuperimposeMechanics's configurations."""
    sep, p1, s1, op = 200, 1000.0, 1200.0, 500.0
    cfg, fee, n = _mechanics_case(mode)
    b = 4
    rng = np.random.default_rng(2)
    x1 = rng.normal(size=(b, 3, n)).astype(np.float32)
    y1 = np.array(probabilistic_labels(jnp.asarray(np.tile([[p1, s1]], (b, 1))), n, sigma=20))
    x2 = rng.normal(size=(b, 3, n)).astype(np.float32)
    y2 = np.array(probabilistic_labels(jnp.asarray(np.tile([[op, op + 150.0]], (b, 1))), n, sigma=20))
    prim = {"X": x1, "y": y1, "p": np.full(b, p1, np.float32), "s": np.full(b, s1, np.float32)}
    sec = {"X": x2, "y": y2}
    zeros = np.zeros((b, 3, n), np.float32)
    key = jax.random.PRNGKey(3 + 8 * mode)
    want = jax.block_until_ready(jaug.stack_block(key, as_jax(prim), as_jax(sec), as_jax(sec), jnp.asarray(zeros),
                                                  jnp.asarray(zeros), jcfg(cfg)))
    draws = stack_draws(key, b, 3, cfg)
    with torch_alone():
        got = taug.stack_block(as_torch(prim), as_torch(sec), as_torch(sec), torch.as_tensor(zeros),
                               torch.as_tensor(zeros), cfg, draws)
    assert_close(got, want, ["X", "y"])
    xo, yo = got["X"].numpy(), got["y"].numpy()
    for i in range(b):
        scale = 1.0 / float(draws["pass1"]["inv"][i])
        src_x, src_p = (x2[i], op) if mode == 0 else (x1[i], p1)
        placed = fee if mode == 0 else int(np.argmax(yo[i, 0][1400:])) + 1400
        assert fee <= placed < n - (2 * sep if mode == 0 else sep)
        shift = placed - int(src_p)
        x2i = src_x.copy()
        x2i[:, : int(src_p) - sep] = 0.0
        x2s = np.zeros_like(x2i)
        x2s[:, shift:] = x2i[:, :-shift]
        x1z = x1[i].copy()
        x1z[:, fee:] = 0.0
        np.testing.assert_allclose(xo[i], x1z + scale * x2s, rtol=1e-5, atol=1e-5)
        if mode == 0:
            y2s = np.zeros_like(y2[i])
            y2s[:, shift:] = y2[i][:, :-shift]
            ym = np.maximum(y1[i], y2s)
            phases = ym[:2] / np.maximum(1.0, ym[:2].sum(0, keepdims=True))
            np.testing.assert_allclose(yo[i, :2], phases, atol=1e-5)
            np.testing.assert_allclose(yo[i, 2], 1.0 - phases.sum(0), atol=1e-5)
