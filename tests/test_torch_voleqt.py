"""VolEQTransformer of the port vs the JAX package.

A small VolEQTransformer (in_samples 1504, one BiLSTM block) and one at the
published EQT width (6000 samples, 3 BiLSTM blocks) are initialised by JAX,
carried over with ``models/convert.py`` and run by both packages on the same
windows: four outputs (regular and long-period detection, P, S). Tolerance
2e-4 absolute on the probabilities, the EQT forward pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_eqtransformer import _jax_params, _windows
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.train.model_io import export_pretrained
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer, from_pretrained, load_model
from volpick_tpu_torch.models.convert import load_npz_v1, voleqtransformer_state_dict_from_jax

ATOL = 2e-4
SMALL = dict(in_samples=1504, lstm_blocks=1)


def _port_from_jax(params, **kw):
    model = VolEQTransformer(**kw)
    model.load_state_dict(voleqtransformer_state_dict_from_jax(params), strict=True)
    return model.eval()


def _port(model, x):
    with torch.inference_mode():
        return [o.numpy() for o in model(torch.as_tensor(x))]


@pytest.fixture(scope="module")
def small():
    jmodel = JaxVolEQT(**SMALL)
    params = _jax_params(jmodel)
    return jmodel, params, _port_from_jax(params, **SMALL)


@pytest.mark.parametrize("fused", [None, False])  # default (banded pick attention), per-branch
def test_forward_matches_jax(small, fused):
    jmodel, params, port = small
    x = _windows(3, 1504, seed=41)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), fused=fused)
    got = _port(port, x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (3, 1504)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    # the two detection heads have their own weights
    assert np.abs(got[0] - got[1]).max() > 1e-3


def test_forward_matches_jax_full_width():
    jmodel = JaxVolEQT()
    params = _jax_params(jmodel)
    port = _port_from_jax(params)
    x = _windows(2, 6000, seed=42)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), fused=False)
    got = _port(port, x)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, 6000) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


def test_one_more_head_than_eqtransformer():
    eqt = set(EQTransformer(**SMALL).state_dict())
    vol = set(VolEQTransformer(**SMALL).state_dict())
    assert eqt < vol
    assert {k.split(".")[0] for k in vol - eqt} == {"decoder_lp", "conv_lp"}
    assert VolEQTransformer.name == "VolEQTransformer"
    assert VolEQTransformer(**SMALL).detection_branches == (
        ("decoder_d", "conv_d"), ("decoder_lp", "conv_lp"))
    a, b = (load_model("voleqtransformer", seed=5, device="cpu", **SMALL) for _ in range(2))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_npz_v1_and_pt_v1_load(small, tmp_path):
    jmodel, params, port = small
    d = export_pretrained(jmodel, params, tmp_path, name="vol")
    arch, model = load_npz_v1(d / "vol.json.v1", d / "vol.npz.v1")
    assert arch == "voleqtransformer" and model.name == "VolEQTransformer"
    x = _windows(2, 1504, seed=43)
    for g, w in zip(_port(model, x), _port(port, x)):
        np.testing.assert_array_equal(g, w)
    torch.save(port.state_dict(), d / "vol.pt.v1")
    loaded = from_pretrained("voleqtransformer", "vol", search_paths=[str(tmp_path)], device="cpu")
    for g, w in zip(_port(loaded, x), _port(port, x)):
        np.testing.assert_array_equal(g, w)
