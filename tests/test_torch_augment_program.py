"""The port's rotation and gap blocks and its whole augmentation program
against the JAX package's, fed the JAX blocks' own draws (re-derived from the
key by each block's split structure, tests/torch_train_common.py), within
1e-6; and the port's own draws against the JAX program's in kind and shape.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_train_common import (
    as_jax,
    as_torch,
    assert_close,
    augment_draws,
    gap_draws,
    jcfg,
    raw_batch,
    torch_alone,
    rotation_draws,
)
from volpick_tpu.pipeline import augmentations as jaug
from volpick_tpu_torch.pipeline import augmentations as taug

CFG_PN = taug.AugmentConfig(window=3001, stack=True)
CFG_EQT = taug.AugmentConfig(window=6000, pre_window=12000, samples_before=6000, noise_column=False,
                             detection=True, detrend=True, stack=True)


@pytest.mark.parametrize("cfg", [dataclasses.replace(CFG_PN, rotate_array=True, rotate_prob=0.5, gap_prob=0.5),
                                 dataclasses.replace(CFG_EQT, rotate_array=True, rotate_prob=0.5, gap_prob=1.0)],
                         ids=["phasenet", "eqt"])
def test_rotation_and_gap_blocks_match_jax(cfg):
    rng = np.random.default_rng(4)
    b, w = 16, cfg.window
    c = 2 if not cfg.noise_column else 3
    out = {"X": rng.normal(size=(b, 3, w)).astype(np.float32),
           "y": rng.random((b, c, w)).astype(np.float32)}
    if cfg.detection:
        out["detections"] = (rng.random((b, 1, w)) > 0.5).astype(np.float32)
    keys = list(out)
    key_r, key_g = jax.random.split(jax.random.PRNGKey(6))
    want = jax.block_until_ready(jaug.rotation_block(key_r, as_jax(out), jcfg(cfg)))
    rd = rotation_draws(key_r, b, cfg)
    with torch_alone():
        got = taug.rotation_block(as_torch(out), cfg, rd)
    assert_close(got, want, keys)
    want = jax.block_until_ready(jaug.gap_block(key_g, as_jax(out), jcfg(cfg)))
    gd = gap_draws(key_g, b, cfg)
    with torch_alone():
        got = taug.gap_block(as_torch(out), cfg, gd)
    assert_close(got, want, keys)
    if cfg.noise_column:  # the noise row is 1 inside every gap
        gap = (got["X"] == 0).all(dim=1) & gd["do"][:, None]
        assert gap.any() and bool((got["y"][:, -1][gap] == 1.0).all())


@pytest.mark.parametrize("cfg", [CFG_PN, dataclasses.replace(CFG_EQT, rotate_array=True),
                                 dataclasses.replace(CFG_PN, stack=False)],
                         ids=["phasenet", "eqt-rotate", "phasenet-no-stack"])
def test_augment_train_batch_matches_jax(cfg):
    rng = np.random.default_rng(7)
    b = 12
    raws = [raw_batch(rng, b, 15000) for _ in range(3)] + [raw_batch(rng, b, 15000, picks=False)
                                                           for _ in range(2)]
    if not cfg.stack:
        raws = raws[:1] + [None] * 4
    key = jax.random.PRNGKey(9)
    want = jax.block_until_ready(
        jaug.augment_train_batch(key, *[as_jax(r) if r is not None else None for r in raws], jcfg(cfg)))
    draws = augment_draws(key, b, 3, cfg, stack=cfg.stack)
    with torch_alone():
        got = taug.augment_train_batch(*[as_torch(r) if r is not None else None for r in raws], cfg, draws)
    assert set(got) == set(want)
    assert_close(got, want, list(want))


def test_draws_have_the_shapes_the_blocks_take():
    """``draw_augment`` makes every draw the JAX program makes, in kind and
    shape, and the program runs on them."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(CFG_EQT, rotate_array=True)
    draws = taug.draw_augment(gen, 5, 3, cfg, "cpu", stack=True)
    want = augment_draws(jax.random.PRNGKey(0), 5, 3, cfg, stack=True)

    def kinds(d):
        return {k: kinds(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype.is_floating_point)
                for k, v in d.items()}

    assert kinds(draws) == kinds(want)
    pre = taug.draw_augment(gen, 5, 3, dataclasses.replace(CFG_PN, pre_windowed=True, stack=False), "cpu",
                            stack=True)
    assert pre["prim"] == {} and set(pre) == {"prim", "gap"}
    modes = taug.draw_stack(torch.Generator().manual_seed(1), 4000, 3, CFG_PN, "cpu")["mode_e"]
    freq = np.bincount(modes.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, CFG_PN.p_event_modes, atol=0.03)
    rng = np.random.default_rng(8)
    raws = [as_torch(raw_batch(rng, 5, 15000)) for _ in range(5)]
    out = taug.augment_train_batch(*raws, cfg, draws)
    assert out["X"].shape == (5, 3, 6000) and torch.isfinite(out["X"]).all()
