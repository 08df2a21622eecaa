"""EQTransformer of the port vs the JAX package and the torch oracle.

A small EQTransformer (in_samples 1504, one BiLSTM block, the geometry of
tests/test_voleqt.py) and one at the published width (6000 samples, 3
BiLSTM blocks: the encoder paddings and decoder crops of the main path) are
initialised by JAX, carried over with ``models/convert.py`` and run by both
packages on the same windows. Tolerance: 2e-4 absolute on the output
probabilities (the README's EQT forward pin; convolutions and LSTM sums
reduce in another order); 1e-5 on the attention layers alone.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_oracle import EQTransformerTorch
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import layers as jlayers
from volpick_tpu_torch.models import EQTransformer, from_pretrained, load_model
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models.convert import eqtransformer_state_dict_from_jax

ATOL = 2e-4
ATTN_ATOL = 1e-5
SMALL = dict(in_samples=1504, lstm_blocks=1)


def _jax_params(model):
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
    # move BN statistics and biases off their init values so they matter
    rng = np.random.default_rng(5)

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


def _port_from_jax(params, **kw):
    model = EQTransformer(**kw)
    model.load_state_dict(eqtransformer_state_dict_from_jax(params), strict=True)
    return model.eval()


def _windows(n, w, seed=11):
    x = np.random.default_rng(seed).normal(size=(n, 3, w)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def jax_model_params():
    model = JaxEQT(**SMALL)
    return model, _jax_params(model)


@pytest.fixture(scope="module")
def port_model(jax_model_params):
    return _port_from_jax(jax_model_params[1], **SMALL)


@pytest.fixture(scope="module")
def windows():
    return _windows(3, 1504)


def _port(model, x):
    with torch.inference_mode():
        return [o.numpy() for o in model(torch.as_tensor(x))]


@pytest.mark.parametrize("fused", ["plstm+bandattn", False])
def test_forward_matches_jax(jax_model_params, port_model, windows, fused):
    jmodel, params = jax_model_params
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jmodel.apply(jparams, jnp.asarray(windows), fused=fused)  # plstm: Pallas interpreted
    got = _port(port_model, windows)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (3, 1504)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


def test_forward_matches_jax_full_width():
    jmodel = JaxEQT()
    params = _jax_params(jmodel)
    port = _port_from_jax(params)
    assert port.in_samples == 6000 and len(port.bi_lstm_stack.members) == 3
    x = _windows(2, 6000, seed=12)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), fused=False)
    got = _port(port, x)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (2, 6000) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


def test_attention_layers_match_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 16, 47)).astype(np.float32)
    p = {"Wx": rng.uniform(-0.3, 0.3, (16, 32)), "Wt": rng.uniform(-0.3, 0.3, (16, 32)),
         "bh": rng.normal(size=(32,)) * 0.1, "Wa": rng.uniform(-0.3, 0.3, (32, 1)),
         "ba": rng.normal(size=(1,)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    dense = tlayers.seq_self_attention(torch.as_tensor(x), tp).numpy()
    np.testing.assert_allclose(
        dense, np.asarray(jlayers.seq_self_attention(jnp.asarray(x), jp)[0]), atol=ATTN_ATOL
    )
    banded = tlayers.seq_self_attention_banded(torch.as_tensor(x), tp, 3).numpy()
    np.testing.assert_allclose(
        banded, np.asarray(jlayers.seq_self_attention_banded(jnp.asarray(x), jp, 3)), atol=ATTN_ATOL
    )


def test_state_dict_keys_match_torch_oracle(port_model, windows):
    for kw in ({}, SMALL):
        oracle = EQTransformerTorch(**kw)
        port = EQTransformer(**kw)
        want = {k: tuple(v.shape) for k, v in oracle.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    # the oracle's state dict loads strictly and the forwards agree
    oracle = EQTransformerTorch(**SMALL).eval()
    oracle.load_state_dict(port_model.state_dict(), strict=True)
    port = EQTransformer(**SMALL).eval()
    port.load_state_dict(oracle.state_dict(), strict=True)
    with torch.inference_mode():
        want = oracle(torch.as_tensor(windows))
    for g, w in zip(_port(port, windows), want):
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL)


def test_load_model_is_seeded(windows):
    a = load_model("eqtransformer", seed=3, device="cpu", **SMALL)
    b = load_model("eqtransformer", seed=3, device="cpu", **SMALL)
    c = load_model("eqtransformer", seed=4, device="cpu", **SMALL)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.encoder.convs[0].weight, c.encoder.convs[0].weight)
    with pytest.raises(ValueError):
        load_model("nosuchnet", device="cpu")


def test_from_pretrained_reads_json_and_weights(tmp_path, windows):
    src = load_model("eqtransformer", seed=7, device="cpu", **SMALL)
    d = tmp_path / "eqtransformer"
    d.mkdir()
    torch.save(src.state_dict(), d / "volpick.pt.v1")
    meta = {"model_args": dict(SMALL, sampling_rate=100.0),
            "default_args": {"P_threshold": 0.21, "S_threshold": 0.22}}
    (d / "volpick.json.v1").write_text(json.dumps(meta))
    model = from_pretrained("eqtransformer", search_paths=[str(tmp_path)], device="cpu")
    assert model.default_args == meta["default_args"]
    for g, w in zip(_port(model, windows), _port(src, windows)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        from_pretrained("eqtransformer", search_paths=[str(tmp_path / "nowhere")], device="cpu")


def test_published_weights_load_strict():
    base = os.environ.get("VOLPICK_TPU_MODELS", "")
    if not os.path.exists(os.path.join(base, "eqtransformer", "volpick.pt.v1")):
        pytest.skip("published volpick weights not available (set VOLPICK_TPU_MODELS)")
    model = from_pretrained("eqtransformer", search_paths=[base], device="cpu")
    assert model.in_samples == 6000 and "P_threshold" in model.default_args
