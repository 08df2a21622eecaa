"""TPUPickNet of the port and K7's plain twin vs the JAX package.

K7 (``ops/cuda/attention.py``): ``mha`` on a CPU tensor runs the twin
``mha_reference``, held against the Pallas kernel ``mha_pallas`` in
interpret mode and against per-head softmax attention in jnp. Tolerance
1e-5 absolute (the MHA pin of tests/test_pallas.py).

The model: a small TPUPickNet (in_samples 512, d_model 32, 2 heads, 1 layer)
under both attention routes and one at the published width (3008 samples,
d_model 128, 4 heads, 4 layers) are initialised by JAX, carried over with
``models/convert.py`` and run by both packages on the same windows.
Tolerance 2e-5 absolute on the softmax probabilities (the PhaseNet forward
pin; matmuls and convolutions sum in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import volpick_tpu_torch.models.tpupicknet as tpn
from volpick_tpu.models import TPUPickNet as JaxTPUPickNet
from volpick_tpu.models import layers as jlayers
from volpick_tpu.ops.pallas.attention import mha_pallas
from volpick_tpu.train.model_io import export_pretrained
from volpick_tpu_torch.models import TPUPickNet, from_pretrained
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models.convert import load_npz_v1, tpupicknet_state_dict_from_jax
from volpick_tpu_torch.ops.cuda import attention as cuda_attn
from volpick_tpu_torch.picker import WaveformPicker

MHA_ATOL = 1e-5
ATOL = 2e-5
SMALL = dict(in_samples=512, d_model=32, n_heads=2, n_layers=1)


def _qkv(rng, b, d, t):
    return [rng.normal(size=(b, d, t)).astype(np.float32) for _ in range(3)]


def test_mha_twin_matches_pallas_kernel():
    """At TPUPickNet's shape, (3, 128, 94) with 4 heads of 32."""
    q, k, v = _qkv(np.random.default_rng(0), 3, 128, 94)
    before = cuda_attn.launches
    got = cuda_attn.mha(*(torch.as_tensor(a) for a in (q, k, v)), 4).numpy()
    assert cuda_attn.launches == before  # a CPU tensor never reaches the kernel
    want = np.asarray(mha_pallas(*(jnp.asarray(a) for a in (q, k, v)), 4, interpret=True))
    assert got.shape == want.shape == (3, 128, 94)
    np.testing.assert_allclose(got, want, atol=MHA_ATOL)


@pytest.mark.parametrize("b,d,t,h", [(2, 32, 16, 2), (1, 96, 33, 3), (2, 64, 127, 2)])
def test_mha_twin_matches_softmax_attention(b, d, t, h):
    q, k, v = _qkv(np.random.default_rng(b * t), b, d, t)
    got = cuda_attn.mha_reference(*(torch.as_tensor(a) for a in (q, k, v)), h).numpy()
    qh, kh, vh = (jnp.asarray(a).reshape(b, h, d // h, t) for a in (q, k, v))
    p = jax.nn.softmax(jnp.einsum("bhdt,bhds->bhts", qh, kh), axis=-1)
    want = np.asarray(jnp.einsum("bhts,bhds->bhdt", p, vh).reshape(b, d, t))
    np.testing.assert_allclose(got, want, atol=MHA_ATOL)


@pytest.mark.parametrize("b,t,h,dh", [(3, 16, 2, 16), (2, 94, 4, 32), (2, 127, 2, 32)])
def test_mha_qkv_twin_matches_head_major_twin_and_pallas(b, t, h, dh):
    """The in-place entry on a (B, T, 3, H, Dh) projection against the
    head-major twin and the Pallas kernel on the same q, k, v, packed and
    scaled as ``volpick_tpu/models/tpupicknet.py`` packs them."""
    qkv = np.random.default_rng(t + dh).normal(size=(b, t, 3, h, dh)).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(dh))
    before = cuda_attn.launches
    got = cuda_attn.mha_qkv(torch.as_tensor(qkv), float(scale)).numpy()
    assert cuda_attn.launches == before  # a CPU tensor never reaches the kernel
    assert got.shape == (b, t, h * dh)
    q, k, v = (qkv[:, :, i].transpose(0, 2, 3, 1).reshape(b, h * dh, t) for i in range(3))
    q = q * scale
    packed = cuda_attn.mha_reference(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (q, k, v)), h)
    np.testing.assert_allclose(got, packed.numpy().transpose(0, 2, 1), atol=MHA_ATOL)
    want = np.asarray(mha_pallas(*(jnp.asarray(a) for a in (q, k, v)), h, interpret=True))
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=MHA_ATOL)


def _within_one_bf16_ulp(got, want):
    d = np.abs(got - want)
    over = d > 2.0 ** -7 * np.abs(want) + 1e-6
    assert not over.any(), f"{int(over.sum())} of {d.size} beyond one bf16 ulp, largest |d| {d.max():.3e}"


@pytest.mark.parametrize("b,t,h,dh", [(4, 94, 4, 32), (2, 127, 2, 32)])
def test_bf16_twins_match_pallas_kernel_on_the_models_scaled_q(b, t, h, dh):
    """bf16 ``mha_qkv`` (its twin here) against the Pallas kernel fed q as the
    JAX model feeds it: ``to_pk(q) * scale`` on a bf16 array rounds the weakly
    typed scale to bf16 and the product to bf16 again. bf16 ``mha`` on that
    same q against the kernel too. One bf16 ulp everywhere (|d| <= 2^-7
    |want| + 1e-6)."""
    qkv = (np.random.default_rng(0).normal(size=(b, t, 3, h, dh)) * 2).astype(np.float32)
    scale = float(1.0 / np.sqrt(dh))
    qkv16 = jnp.asarray(qkv, dtype=jnp.bfloat16)
    to_pk = lambda a: a.transpose(0, 2, 3, 1).reshape(b, h * dh, t)  # noqa: E731
    q, k, v = to_pk(qkv16[:, :, 0]) * scale, to_pk(qkv16[:, :, 1]), to_pk(qkv16[:, :, 2])
    assert q.dtype == jnp.bfloat16
    want = np.asarray(mha_pallas(q, k, v, h, interpret=True).astype(jnp.float32))
    got = cuda_attn.mha_qkv(torch.as_tensor(qkv).to(torch.bfloat16), scale)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got.float().numpy(), want.transpose(0, 2, 1))
    packed = [torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (q, k, v)]
    _within_one_bf16_ulp(cuda_attn.mha(*packed, h).float().numpy(), want)


def test_attention_hands_the_kernel_entry_the_projection_itself(small, monkeypatch):
    """Under "pallas" no packing copy, scale pass or transpose stands between
    the block's projection and K7's entry: ``_attention`` passes its argument
    on untouched, and the forward hands it the reshaped matmul output."""
    _, _, port = small
    seen = []

    def spy(qkv, scale):
        seen.append((qkv, scale))
        return cuda_attn.mha_qkv(qkv, scale)

    monkeypatch.setattr(tpn, "mha_qkv", spy)
    b, t, h, dh = 2, port.n_tokens, port.n_heads, port.d_model // port.n_heads
    qkv = torch.as_tensor(np.random.default_rng(9).normal(size=(b, t, 3, h, dh)).astype(np.float32))
    out = port._attention(qkv, "pallas")
    assert out.shape == (b, t, h * dh) and out.is_contiguous()
    assert seen[0][0] is qkv and seen[0][0].data_ptr() == qkv.data_ptr()
    assert seen[0][1] == pytest.approx(dh ** -0.5)
    np.testing.assert_allclose(out.numpy(), port._attention(qkv, "xla").numpy(), atol=MHA_ATOL)

    seen.clear()
    with torch.no_grad():  # views keep their ._base here, unlike under inference_mode
        port(torch.as_tensor(_windows(2, 512)), attn="pallas")
    assert len(seen) == port.n_layers
    for arg, _ in seen:
        assert tuple(arg.shape) == (2, t, 3, h, dh) and arg.is_contiguous()
        # a view of the matmul's output: exactly its B*T*3*D elements, from its start
        assert arg._base is not None and arg._base.data_ptr() == arg.data_ptr()
        assert arg._base.numel() == arg.numel()


def test_mha_qkv_rejects_what_the_kernel_does_not_take():
    qkv = torch.zeros(2, 10, 3, 2, 16)
    with pytest.raises(ValueError):
        cuda_attn.mha_qkv(qkv[:, :, :2], 0.25)
    with pytest.raises(ValueError):
        cuda_attn.mha_qkv(qkv[0], 0.25)
    with pytest.raises(TypeError):
        cuda_attn.mha_qkv(qkv.double(), 0.25)
    assert cuda_attn.shared_bytes(32, 94) == (3 * 96 * 36 + 96 * 100) * 4
    assert cuda_attn.shared_bytes(cuda_attn.MAX_HEAD_DIM, cuda_attn.MAX_TOKENS) <= cuda_attn.MAX_SHARED_BYTES


def test_mha_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 64, 10)
    with pytest.raises(ValueError):
        cuda_attn.mha(q, q, torch.zeros(2, 64, 11), 2)
    with pytest.raises(ValueError):
        cuda_attn.mha(q, q, q, 3)  # 64 channels do not split into 3 heads
    with pytest.raises(TypeError):
        cuda_attn.mha(q.double(), q.double(), q.double(), 2)
    with pytest.raises(ValueError):
        cuda_attn.mha(q[0], q[0], q[0], 2)


def _port_from_jax(jmodel, params, **kw):
    model = TPUPickNet(**kw)
    model.load_state_dict(tpupicknet_state_dict_from_jax(params), strict=True)
    return model.eval()


def _windows(n, w, seed=31):
    x = np.random.default_rng(seed).normal(size=(n, 3, w)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


def _perturbed(params, seed):
    """Biases and layer-norm affines off their init values so they matter."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if key in ("b", "bias"):
            return tree + rng.normal(size=tree.shape).astype(np.float32) * 0.05
        if key == "scale":
            return tree * rng.uniform(0.7, 1.3, size=tree.shape).astype(np.float32)
        return tree

    return walk(params)


@pytest.fixture(scope="module")
def small():
    jmodel = JaxTPUPickNet(**SMALL)
    params = _perturbed(jax.device_get(jmodel.init(jax.random.PRNGKey(2))), 2)
    return jmodel, params, _port_from_jax(jmodel, params, **SMALL)


def _port(model, x, **kw):
    with torch.inference_mode():
        return model(torch.as_tensor(x), **kw).numpy()


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_forward_matches_jax_small(small, attn):
    jmodel, params, port = small
    x = _windows(3, 512)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), attn=attn))
    got = _port(port, x, attn=attn)
    assert got.shape == (3, 3, 512)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_matches_jax_at_published_width():
    jmodel = JaxTPUPickNet()
    params = _perturbed(jax.device_get(jmodel.init(jax.random.PRNGKey(3))), 3)
    port = _port_from_jax(jmodel, params)
    assert (port.in_samples, port.d_model, port.n_heads, port.n_layers, port.n_tokens) == (
        3008, 128, 4, 4, 94)
    x = _windows(2, 3008, seed=32)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), attn="xla"))
    for attn in ("xla", "pallas"):
        got = _port(port, x, attn=attn)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_gelu_is_the_tanh_approximation(small, monkeypatch):
    """jax.nn.gelu defaults to tanh; torch's default (erf) must not be used:
    with it the forward leaves the JAX tolerance."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = tpn._gelu(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)
    assert np.abs(F.gelu(torch.as_tensor(x)).numpy() - got).max() > 1e-4

    jmodel, params, port = small
    w = _windows(2, 512, seed=33)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(w), attn="xla"))
    monkeypatch.setattr(tpn, "_gelu", lambda a: F.gelu(a))
    assert np.abs(_port(port, w, attn="xla") - want).max() > ATOL


def test_attn_resolution_and_picker_freeze(monkeypatch):
    """field > $VOLPICK_TPN_ATTN > "xla", as the JAX resolve_attn; the
    picker freezes the route when it is built."""
    monkeypatch.delenv("VOLPICK_TPN_ATTN", raising=False)
    model = TPUPickNet(**SMALL)
    assert model.resolve_attn() == "xla"
    monkeypatch.setenv("VOLPICK_TPN_ATTN", " Pallas ")
    assert model.resolve_attn() == "pallas"
    assert TPUPickNet(attn="xla", **SMALL).resolve_attn() == "xla"
    picker = WaveformPicker(model, device="cpu")
    assert model.attn == "pallas" and picker.model is model
    monkeypatch.setenv("VOLPICK_TPN_ATTN", "xla")
    assert model.resolve_attn() == "pallas"
    with pytest.raises(ValueError):
        model(torch.zeros(1, 3, 512), attn="flash")
    assert picker._default_batch_size() == 128


def test_state_dict_names_are_the_npz_keys():
    jmodel = JaxTPUPickNet(**SMALL)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    flat = tpupicknet_state_dict_from_jax(params)
    port = TPUPickNet(**SMALL).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape) for k, v in flat.items()}
    assert "blocks.0.qkv.w" in port and "enc.4.b" in port and "pos" in port


@pytest.mark.parametrize("legacy", [False, True])
def test_npz_v1_export_roundtrip(small, tmp_path, legacy):
    """``export_pretrained`` writes the pair; ``load_npz_v1`` reads it without
    JAX, also from a legacy file without the ``architecture`` field (the
    kwargs are sniffed)."""
    jmodel, params, _ = small
    d = export_pretrained(jmodel, params, tmp_path, name="tpn", default_args={"S_threshold": 0.2})
    js = d / "tpn.json.v1"
    if legacy:
        meta = json.loads(js.read_text())
        del meta["architecture"]
        js.write_text(json.dumps(meta))
    arch, model = load_npz_v1(js, d / "tpn.npz.v1")
    assert arch == "tpupicknet" and model.default_args == {"S_threshold": 0.2}
    assert (model.d_model, model.n_heads, model.n_layers, model.attn) == (32, 2, 1, None)
    x = _windows(2, 512, seed=34)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), attn="xla"))
    np.testing.assert_allclose(_port(model, x, attn="xla"), want, atol=ATOL)
    loaded = from_pretrained("tpupicknet", "tpn", search_paths=[str(tmp_path)], device="cpu")
    np.testing.assert_array_equal(_port(loaded, x, attn="xla"), _port(model, x, attn="xla"))


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("crop_last", [False, True])
def test_upsample2_conv_matches_jax_and_definition(k, crop_last):
    rng = np.random.default_rng(k * 2 + crop_last)
    x = rng.normal(size=(2, 6, 23)).astype(np.float32)
    w = rng.normal(size=(4, 6, k)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    tx, tw, tb = (torch.as_tensor(a) for a in (x, w, b))
    got = tlayers.upsample2_conv1d_same(tx, tw, tb, crop_last=crop_last).numpy()
    want = np.asarray(jlayers.upsample2_conv1d_same(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), crop_last=crop_last))
    up = tlayers.upsample_nearest(tx, 2)
    plain = tlayers.conv1d_same(up[..., :-1] if crop_last else up, tw, tb).numpy()
    assert got.shape == want.shape == plain.shape == (2, 4, 46 - crop_last)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)
    with pytest.raises(ValueError):
        tlayers.upsample2_conv1d_same(tx, tw[..., :2])
