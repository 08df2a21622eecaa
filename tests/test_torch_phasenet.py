"""PhaseNet of the port vs the JAX package and the torch oracle.

A JAX ``PhaseNet`` at the published width (3001 samples, depth 5, filters
8..128, kernel 7, stride 4), with its BN statistics and biases moved off
their init values, is carried over with ``models/convert.py`` and both
packages run the same windows. Tolerance: 2e-5 absolute on the softmax
probabilities (the README's PhaseNet forward pin; convolutions sum in
another order). The oracle (``tests/torch_oracle.py::PhaseNetTorch``, the
SeisBench module the published weights load into) must load the port's state
dict strictly and agree to the same 2e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_oracle import PhaseNetTorch
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.models import layers as jlayers
from volpick_tpu.models.torch_import import import_phasenet
from volpick_tpu.train.model_io import export_pretrained
from volpick_tpu_torch.models import PhaseNet, from_pretrained, load_model
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models.convert import load_npz_v1, phasenet_state_dict_from_jax

ATOL = 2e-5


def _perturbed_params(model, seed=0):
    """JAX init with BN statistics, scales and biases moved off identity."""
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 5)

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


def _windows(n, w, seed=21):
    x = np.random.default_rng(seed).normal(size=(n, 3, w)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def jax_and_port():
    jmodel = JaxPhaseNet()
    params = _perturbed_params(jmodel)
    port = PhaseNet()
    port.load_state_dict(phasenet_state_dict_from_jax(params), strict=True)
    return jmodel, params, port.eval()


def _port(model, x):
    with torch.inference_mode():
        return model(torch.as_tensor(x)).numpy()


def test_forward_matches_jax_at_published_width(jax_and_port):
    jmodel, params, port = jax_and_port
    x = _windows(2, 3001)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    got = _port(port, x)
    assert got.shape == (2, 3, 3001) and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("sr", [100.0, 50.0])
def test_pred_sample_rate_matches_jax(sr):
    assert PhaseNet(sampling_rate=sr).pred_sample_rate == JaxPhaseNet(sampling_rate=sr).pred_sample_rate == sr


def test_oracle_state_dict_loads_strict(jax_and_port):
    _, _, port = jax_and_port
    oracle = PhaseNetTorch().eval()
    assert {k: tuple(v.shape) for k, v in PhaseNet().state_dict().items()} == {
        k: tuple(v.shape) for k, v in oracle.state_dict().items()}
    oracle.load_state_dict(port.state_dict(), strict=True)
    fresh = PhaseNet().eval()
    fresh.load_state_dict(oracle.state_dict(), strict=True)
    x = _windows(2, 3001, seed=22)
    with torch.inference_mode():
        want = oracle(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(_port(fresh, x), want, atol=ATOL)


def test_converter_inverts_the_jax_importer(tmp_path):
    """Port state dict → file → JAX ``import_phasenet`` (which flips and
    transposes the ConvTranspose weights) → ``phasenet_state_dict_from_jax``
    gives back every tensor exactly."""
    model = load_model("phasenet", seed=4, device="cpu")
    path = tmp_path / "volpick.pt.v1"
    torch.save(model.state_dict(), path)
    back = phasenet_state_dict_from_jax(import_phasenet(str(path)))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("k,stride,pad", [(7, 4, (3, 3)), (7, 4, (2, 3)), (7, 4, (1, 3)), (5, 2, (2, 2))])
def test_strided_conv_matches_jax(k, stride, pad):
    rng = np.random.default_rng(k + stride + pad[0])
    x = rng.normal(size=(2, 8, 751)).astype(np.float32)
    w = rng.normal(size=(16, 8, k)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    got = tlayers.conv1d(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                         stride=stride, padding=pad).numpy()
    want = np.asarray(jlayers.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     stride=stride, padding=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("length", [12, 47, 188])
def test_conv_transpose_matches_jax(length):
    """torch's (I, O, K) weight in the port; the JAX layer takes it
    transposed and flipped, as ``import_phasenet`` stores it."""
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, 32, length)).astype(np.float32)
    w = rng.normal(size=(32, 16, 7)).astype(np.float32)  # (I, O, K)
    got = tlayers.conv_transpose1d(torch.as_tensor(x), torch.as_tensor(w), 4).numpy()
    w_flipped = np.ascontiguousarray(w.transpose(1, 0, 2)[:, :, ::-1])
    want = np.asarray(jlayers.conv_transpose1d(jnp.asarray(x), jnp.asarray(w_flipped), stride=4, k=7))
    assert got.shape == want.shape == (2, 16, (length - 1) * 4 + 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_npz_v1_export_loads_without_jax_and_pt_wins(tmp_path, jax_and_port):
    """A ``.npz.v1`` written by the JAX trainer's ``export_pretrained`` loads
    through ``load_npz_v1`` and ``from_pretrained``; with a ``.pt.v1`` beside
    it, the ``.pt.v1`` is taken (the JAX registry's order)."""
    jmodel, params, port = jax_and_port
    d = export_pretrained(jmodel, params, tmp_path, name="mine", default_args={"P_threshold": 0.4})
    arch, model = load_npz_v1(d / "mine.json.v1", d / "mine.npz.v1")
    assert arch == "phasenet" and model.default_args == {"P_threshold": 0.4}
    x = _windows(1, 3001, seed=23)
    np.testing.assert_array_equal(_port(model, x), _port(port, x))
    loaded = from_pretrained("phasenet", "mine", search_paths=[str(tmp_path)], device="cpu")
    np.testing.assert_array_equal(_port(loaded, x), _port(port, x))

    other = load_model("phasenet", seed=9, device="cpu")
    torch.save(other.state_dict(), d / "mine.pt.v1")
    picked = from_pretrained("phasenet", "mine", search_paths=[str(tmp_path)], device="cpu")
    np.testing.assert_array_equal(_port(picked, x), _port(other, x))
    meta = json.loads((d / "mine.json.v1").read_text())
    assert picked.in_samples == meta["model_args"]["in_samples"] == 3001
