"""Shared pieces of the tests that hold the port's training path against the
JAX package: seeded batches, perturbed JAX parameters, JAX trainer gradients
and the converter's key map at any float dtype."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from volpick_tpu.ops.labels import detection_labels, probabilistic_labels
from volpick_tpu.pipeline import augmentations as jaug
from volpick_tpu_torch.models import convert


def perturbed_params(port_model, seed=5):
    """The JAX tree of a seeded port model (``convert.jax_tree_from_model``:
    no JAX ``init`` to compile) with BN statistics, scales and biases moved off
    their initial values so that they matter."""
    params = convert.jax_tree_from_model(port_model)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in ("b", "bias", "mean"):
                    v = v + rng.normal(size=v.shape).astype(np.float32) * 0.05
                elif k in ("var", "scale"):
                    v = v * rng.uniform(0.7, 1.3, size=v.shape).astype(np.float32)
                else:
                    v = perturb(v)
                out[k] = v
            return out
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree

    return perturb(params)


def make_batch(rng, b, w, eqt: bool, is_lp=None):
    """Peak-normalised random windows with label curves painted at random
    onsets: {"X", "y"[, "detections", "is_lp"]} as numpy float32."""
    x = rng.normal(size=(b, 3, w)).astype(np.float32)
    x /= np.abs(x).max(axis=-1, keepdims=True)
    on = np.empty((b, 2), np.float32)
    on[:, 0] = rng.uniform(0.1 * w, 0.6 * w, b)
    on[:, 1] = on[:, 0] + rng.uniform(0.03 * w, 0.2 * w, b)
    on[-1] = np.nan  # a noise window
    batch = {"X": x, "y": np.array(probabilistic_labels(jnp.asarray(on), w, noise_column=not eqt))}
    if eqt:
        batch["detections"] = np.array(detection_labels(jnp.asarray(on[:, 0]), jnp.asarray(on[:, 1]), w))
    if is_lp is not None:
        batch["is_lp"] = np.asarray(is_lp, np.float32)
    return batch


def jax_loss_and_grads(trainer, params, batch, dtype=np.float32):
    """(loss, BN updates, gradients) of the JAX trainer's train-mode loss, at
    `dtype` (float64 inside ``jax.enable_x64``)."""
    with jax.enable_x64(dtype == np.float64):
        f = jax.jit(jax.value_and_grad(lambda p, bt: trainer._loss(p, bt, train=True), has_aux=True))
        pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        bj = {k: jnp.asarray(v, dtype) for k, v in batch.items()}
        (loss, updates), grads = f(pj, bj)
        return float(loss), jax.device_get(updates), jax.device_get(grads)


def state_dict_from_jax(arch, tree, dtype=np.float32):
    """The converter's state dict of a JAX tree, leaves kept at `dtype`."""
    with mock.patch.object(convert, "_tensor", lambda v: torch.from_numpy(np.array(v, dtype=dtype))):
        return convert.STATE_DICT_FROM_JAX[arch](tree)


def assert_grads_match(model, jax_sd, zero_by_construction=()):
    """Each parameter's .grad within atol = 1e-4 max|g_jax|, rtol = 1e-3 of the
    JAX gradient under the converter's key map. Parameters whose gradient is
    zero by construction in both packages (a bias that a train-mode BatchNorm
    subtracts again, an attention bias that softmax's max subtraction
    cancels) are held to |g| <= 1e-9 of the model's largest gradient in both."""
    gmax = max(float(v.abs().max()) for k, v in jax_sd.items() if "running" not in k and "num_" not in k)
    names = [n for n, _ in model.named_parameters()]
    assert set(zero_by_construction) <= set(names)
    for name, p in model.named_parameters():
        want = jax_sd[name].numpy()
        got = p.grad.detach().to(torch.float64).numpy()
        if name in zero_by_construction:
            assert np.abs(want).max() <= 1e-9 * gmax and np.abs(got).max() <= 1e-9 * gmax, name
            continue
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-3, err_msg=name)


# ------------------------------------------ augmentation draws of the JAX blocks
AUG_TOL = 1e-6


@contextlib.contextmanager
def torch_alone():
    """Run torch on one thread, after the caller has waited for JAX's
    asynchronous CPU work (``jax.block_until_ready``): under a loaded
    parallel test run the float32 exp of a label curve was seen 5e-5 off in
    the 1/8 of a tensor one of torch's 8 threads computes, with XLA's CPU
    work of the same process beside it; a 1e-6 comparison must not see that."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def jcfg(cfg):
    return jaug.AugmentConfig(**dataclasses.asdict(cfg))


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------- JAX draws
def window_draws(key, b, cfg):
    if cfg.pre_windowed:
        return {}
    k1, _ = jax.random.split(key)
    a, b_, c, d = jax.random.split(k1, 4)
    return {"pick_s": t(jax.random.bernoulli(a, 0.5, (b,))), "rand_u": t(jax.random.uniform(b_, (b,))),
            "gate": t(jax.random.bernoulli(c, cfg.window_around_prob, (b,))),
            "u": t(jax.random.uniform(d, (b,)))}


def superimpose_draws(key, b, cfg):
    k1, k2 = jax.random.split(key)
    return {"u": t(jax.random.uniform(k1, (b,))),
            "inv": t(jax.random.uniform(k2, (b,), minval=cfg.inv_scale_event[0], maxval=cfg.inv_scale_event[1]))}


def stack_draws(key, b, c, cfg):
    k = jax.random.split(key, 10)
    lo_n, hi_n = cfg.inv_scale_noise
    return {
        "mode_e": t(jax.random.choice(k[0], 3, (b,), p=jnp.asarray(cfg.p_event_modes)), torch.int64),
        "two_events": t(jax.random.bernoulli(k[1], cfg.p_two_events, (b,))),
        "pass1": superimpose_draws(k[2], b, cfg),
        "pass2": superimpose_draws(k[3], b, cfg),
        "mode_n": t(jax.random.choice(k[4], 3, (b,), p=jnp.asarray(cfg.p_noise_modes)), torch.int64),
        "two_noise": t(jax.random.bernoulli(k[5], cfg.p_two_events, (b,))),
        "noise_inv1": t(jax.random.uniform(k[6], (b,), minval=lo_n, maxval=hi_n)),
        "noise_inv2": t(jax.random.uniform(k[7], (b,), minval=lo_n, maxval=hi_n)),
        "g_scale": t(jax.random.uniform(k[8], (b,), minval=cfg.gaussian_scale[0], maxval=cfg.gaussian_scale[1])),
        "gnoise": t(jax.random.normal(k[9], (b, c, cfg.window))),
    }


def rotation_draws(key, b, cfg):
    k1, k2 = jax.random.split(key)
    return {"do": t(jax.random.bernoulli(k1, cfg.rotate_prob, (b,))),
            "shift": t(jax.random.randint(k2, (b,), 0, cfg.window), torch.int64)}


def gap_draws(key, b, cfg):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"do": t(jax.random.bernoulli(k1, cfg.gap_prob, (b,))), "u0": t(jax.random.uniform(k2, (b,))),
            "u1": t(jax.random.uniform(k3, (b,)))}


def augment_draws(key, b, c, cfg, stack):
    ks = jax.random.split(key, 8)
    draws = {"prim": window_draws(ks[0], b, cfg), "gap": gap_draws(ks[6], b, cfg)}
    if cfg.stack and stack:
        sec_cfg = cfg.for_secondary()
        draws.update(sec=window_draws(ks[1], b, sec_cfg), sec2=window_draws(ks[2], b, sec_cfg),
                     noi=window_draws(ks[3], b, cfg), noi2=window_draws(ks[4], b, cfg),
                     stack=stack_draws(ks[5], b, c, cfg))
    if cfg.rotate_array:
        draws["rotate"] = rotation_draws(ks[7], b, cfg)
    return draws


# ---------------------------------------------------------------- batches
def raw_batch(rng, b, w, picks=True, short=None):
    x = rng.normal(size=(b, 3, w)).astype(np.float32)
    lens = np.full(b, w, np.int32)
    if short is not None:
        lens[0] = short
    if picks:
        p = rng.uniform(0.2 * w, 0.55 * w, b).astype(np.float32)
        s = (p + rng.uniform(100, 600, b)).astype(np.float32)
        p[1] = np.nan  # S only
        s[2] = np.nan  # P only
    else:
        p = np.full(b, np.nan, np.float32)
        s = np.full(b, np.nan, np.float32)
    return {"x": x, "len": lens, "p": p, "s": s, "is_lp": (rng.random(b) < 0.4).astype(np.float32)}


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def assert_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=AUG_TOL, err_msg=k)
