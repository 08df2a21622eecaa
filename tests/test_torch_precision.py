"""The picker's ``precision="bfloat16"`` mode against the JAX picker's.

Each model runs at a small size (EQTransformer and VolEQTransformer 1504
samples and one BiLSTM block, as ``tests/test_torch_eqtransformer.py``'s
SMALL; TPUPickNet 512 samples, d 32, 2 heads, one layer; PhaseNet as
published), on the port's seeded weights carried to JAX's tree with
``models/convert.py::jax_tree_from_model``, on 8 conditioned windows made from
a numpy seed. JAX's float32 and bf16
forwards are ``jax.jit(WaveformPicker(..., precision=...)._apply_model)``, as
``classify`` runs them (called eagerly on numpy parameters, JAX's bf16
``batch_norm`` promotes to float32 and its conv refuses the mixed types). The
port's bf16 forward is its picker's ``_apply_model``, which runs its bf16
copy of the model with the kernels' bf16 twins on the CPU.

What is held, for every model and route:
- the port's bf16 curves lie within 0.1 of JAX's bf16 curves (max |Δ|);
- the port's bf16 mode is as accurate as JAX's: its mean |Δ| from JAX's
  float32 curves is no larger than that of JAX's bf16 curves.
The stricter rule "the port's bf16 curves lie no farther from JAX's bf16
curves than those from JAX's float32 curves" (max |Δ|) is held for the
EQTransformer family (both routes) and VolEQTransformer, where the port's
bf16 error is a fraction of JAX's. For PhaseNet and TPUPickNet the two bf16
errors are of one size: the packages round at different places (PyTorch
after every operation, XLA where a fusion ends), the two errors add up, and
the rule holds on these weights but failed on JAX-initialised ones (PhaseNet
4.93e-3 against 4.52e-3, TPUPickNet 4.78e-2 against 2.84e-2), so it is not
asserted there. Measured here, max |Δ| port-vs-JAX-bf16 / JAX-bf16-vs-
float32 and mean |Δ| port-vs-float32 / JAX-bf16-vs-float32: PhaseNet
2.94e-3 / 3.22e-3, 5.48e-4 / 6.41e-4; TPUPickNet 2.65e-2 / 3.55e-2, 2.85e-3 /
3.20e-3; EQTransformer 1.17e-2 / 9.72e-2, 3.37e-3 / 3.49e-3 (the pattn route
1.56e-2, 3.36e-3); VolEQTransformer 1.17e-2 / 9.72e-2, 4.52e-3 / 4.64e-3.
The float32 path is untouched by a bf16 picker: same curves, bit for bit,
before and after one is built on the same model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import torch_alone
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.models import TPUPickNet as JaxTPUPickNet
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.models import EQTransformer, PhaseNet, TPUPickNet, VolEQTransformer
from volpick_tpu_torch.models.convert import jax_tree_from_model
from volpick_tpu_torch.picker import WaveformPicker

EQT_SMALL = dict(in_samples=1504, lstm_blocks=1)
WINDOWS = 8
TPN_SMALL = dict(in_samples=512, d_model=32, n_heads=2, n_layers=1, attn="pallas")

# name: (JAX class, port class, JAX kwargs, port kwargs)
CASES = {
    "phasenet": (JaxPhaseNet, PhaseNet, {}, {}),
    "tpupicknet": (JaxTPUPickNet, TPUPickNet, TPN_SMALL, TPN_SMALL),
    "eqtransformer": (JaxEQT, EQTransformer, EQT_SMALL, EQT_SMALL),
    "eqtransformer-pattn": (JaxEQT, EQTransformer, EQT_SMALL, dict(EQT_SMALL, fused="plstm+bandattn+pattn")),
    "voleqtransformer": (JaxVolEQT, VolEQTransformer, EQT_SMALL, EQT_SMALL),
}
# the stricter rule of the module's note, where it holds
STRICT = {"eqtransformer", "eqtransformer-pattn", "voleqtransformer"}


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the CPU."""
    with torch_alone():
        yield


def _windows(n: int, w: int) -> np.ndarray:
    x = np.random.default_rng(11).normal(size=(n, 3, w)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


def _models(case):
    """(JAX model, its parameters, port model): the port's seeded weights,
    carried to JAX's tree by ``jax_tree_from_model``."""
    jcls, pcls, jkw, pkw = CASES[case]
    model = pcls(generator=torch.Generator().manual_seed(0), **pkw).eval()
    return jcls(**jkw), jax.tree_util.tree_map(jnp.asarray, jax_tree_from_model(model)), model


_JAX_CURVES = {}  # JAX kwargs -> (float32, bf16) curves: the two EQT routes share JAX's


def _jax_curves(jmodel, params, x):
    key = repr(dataclasses.asdict(jmodel))
    if key not in _JAX_CURVES:
        _JAX_CURVES[key] = tuple(
            np.asarray(jax.jit(JaxPicker(jmodel, params, precision=p)._apply_model)(params, jnp.asarray(x)))
            for p in ("float32", "bfloat16"))
    return _JAX_CURVES[key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_follows_jax_bf16(case):
    jmodel, params, model = _models(case)
    x = _windows(WINDOWS, model.in_samples)
    f32, b16 = _jax_curves(jmodel, params, x)
    picker = WaveformPicker(model, device="cpu", precision="bfloat16")
    with torch.inference_mode():
        got = picker._apply_model(torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == f32.shape
    got = got.numpy()
    jax_err = np.abs(b16 - f32)
    assert jax_err.max() > 0  # JAX's bf16 forward is not its float32 one
    assert np.abs(got - b16).max() <= 0.1
    assert np.abs(got - f32).mean() <= jax_err.mean()
    if case in STRICT:
        assert np.abs(got - b16).max() <= jax_err.max()


def test_bf16_picker_keeps_the_callers_model_and_the_float32_path():
    """The bf16 copy is made once; the caller's model keeps float32 weights
    and a float32 picker gives the same curves, bit for bit, before and after
    a bf16 picker is built on the same model. ``precision`` is validated as
    in JAX."""
    _, _, model = _models("eqtransformer")
    data = np.random.default_rng(3).normal(size=(2, 3, 4000)).astype(np.float32)
    kw = dict(overlap=752, blinding=(100, 100), batch_size=4)
    before = WaveformPicker(model, device="cpu").annotate_array(data, **kw)
    bf = WaveformPicker(model, device="cpu", precision="bfloat16")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in bf._net.parameters())
    assert all(b.dtype == torch.bfloat16 for b in bf._net.buffers() if b.is_floating_point())
    assert bf._net is not model
    curves = bf.annotate_array(data, **kw)
    assert curves.dtype == np.float32 and curves.shape == before.shape
    assert 0 < np.abs(curves - before).max() <= 0.1
    after = WaveformPicker(model, device="cpu").annotate_array(data, **kw)
    np.testing.assert_array_equal(after, before)
    for bad in ("fp8", "float16", "tf32"):
        with pytest.raises(ValueError, match="float32|bfloat16"):
            WaveformPicker(model, device="cpu", precision=bad)
