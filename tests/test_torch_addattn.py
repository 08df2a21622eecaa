"""Additive attention of the port (``ops/cuda/addattn.py``) and the EQT
``fused`` route vs the JAX package.

On the CPU the wrappers run their plain twins. Both entries (``addattn`` from
projected q and k, ``addattn_x`` from x and the weights, which
``seq_self_attention`` calls) are held against the Pallas kernel
``seq_self_attention_pallas`` in interpret mode and against
``layers.seq_self_attention`` at 1e-5 (the tests/test_pallas.py pin: the
same arithmetic, sums in another order). The kernel's tanh,
1 - 2 / (exp(2a) + 1), is evaluated in float32 against a float64 tanh: no
NaN where exp overflows or vanishes, at most 5e-7 off. A small EQTransformer under
``fused="plstm+bandattn+pattn"`` is held against the JAX ``apply`` with the
same flag and converted weights at 2e-4 (the EQT forward pin).

In bf16 the twin rounds at JAX's points for q, k, q + k and tanh and keeps
the probabilities float32 (``ops/cuda/addattn.py`` says why); it is not the
Pallas kernel's bf16 arithmetic, whose XLA-CPU rounding the port does not
restate, so it is held by the repo's bf16 rule: within 2^-7 of the largest
|out| of JAX's bf16 kernel, and no farther from JAX's float32 kernel than
JAX's bf16 kernel is, in max and in mean |d| (measured: 3.91e-3 against a
4.76e-3 limit and 2.70e-3 / 4.36e-4 against 4.11e-3 / 6.01e-4 at scale 0.3;
3.91e-3 against 6.23e-3 and 1.00e-2 / 1.09e-3 against 1.00e-2 / 1.22e-3 at
scale 6, where the largest errors of both lie on an element whose input
rounding dominates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.models import layers as jlayers
from volpick_tpu.ops.pallas.addattn import seq_self_attention_pallas
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer, load_model
from volpick_tpu_torch.models import eqtransformer as port_eqt
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models.convert import (
    eqtransformer_state_dict_from_jax,
    voleqtransformer_state_dict_from_jax,
)
from volpick_tpu_torch.ops.cuda import addattn
from volpick_tpu_torch.picker import WaveformPicker

ATTN_ATOL = 1e-5
EQT_ATOL = 2e-4
SMALL = dict(in_samples=1504, lstm_blocks=1)
PATTN = "plstm+bandattn+pattn"


def _params(rng, c, u, scale):
    p = {"Wx": rng.uniform(-scale, scale, (c, u)), "Wt": rng.uniform(-scale, scale, (c, u)),
         "bh": rng.normal(size=(u,)) * 0.1, "Wa": rng.uniform(-0.3, 0.3, (u, 1)),
         "ba": rng.normal(size=(1,)) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


# B not a multiple of the Pallas block of 8; T = 1; a scale that saturates tanh
SHAPES = [(3, 16, 47, 32, 0.3), (8, 16, 47, 32, 0.3), (13, 16, 47, 32, 0.02), (5, 8, 12, 16, 0.3),
          (2, 16, 1, 32, 0.3), (9, 16, 47, 32, 6.0)]


@pytest.mark.parametrize("b,c,t,u,scale", SHAPES)
def test_twin_matches_pallas_and_layers(b, c, t, u, scale):
    rng = np.random.default_rng(b * 100 + t)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    p = _params(rng, c, u, scale)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    before = addattn.launches
    got = addattn.seq_self_attention(torch.as_tensor(x), tp).numpy()
    assert addattn.launches == before  # a CPU tensor launches nothing
    assert got.shape == x.shape and np.isfinite(got).all()
    pallas = np.asarray(seq_self_attention_pallas(jnp.asarray(x), jp, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATTN_ATOL)
    dense = np.asarray(jlayers.seq_self_attention(jnp.asarray(x), jp)[0])
    np.testing.assert_allclose(got, dense, atol=ATTN_ATOL)
    # and the port's own dense layer, which keeps `ba`
    np.testing.assert_allclose(got, tlayers.seq_self_attention(torch.as_tensor(x), tp).numpy(),
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("b,c,t,u,scale", SHAPES)
def test_addattn_x_twin_matches_pallas_and_layers(b, c, t, u, scale):
    """The entry that projects inside, on the CPU its twin, against the Pallas
    kernel interpreted, the JAX dense layer, and ``addattn`` fed the same
    projections."""
    rng = np.random.default_rng(b * 100 + t + 1)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    p = _params(rng, c, u, scale)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx = torch.as_tensor(x)
    wt, bh, wx = (torch.as_tensor(p[k]) for k in ("Wt", "bh", "Wx"))
    wa = torch.as_tensor(p["Wa"]).reshape(-1)
    before = addattn.launches
    got = addattn.addattn_x(tx, wt, bh, wx, wa).numpy()
    assert addattn.launches == before  # a CPU tensor launches nothing
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, addattn.addattn_x_reference(tx, wt, bh, wx, wa).numpy())
    pallas = np.asarray(seq_self_attention_pallas(jnp.asarray(x), jp, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATTN_ATOL)
    dense = np.asarray(jlayers.seq_self_attention(jnp.asarray(x), jp)[0])
    np.testing.assert_allclose(got, dense, atol=ATTN_ATOL)
    xt = tx.transpose(1, 2)
    old = addattn.addattn(tx, (xt @ wt + bh).contiguous(), (xt @ wx).contiguous(), wa).numpy()
    np.testing.assert_allclose(got, old, atol=ATTN_ATOL)


@pytest.mark.parametrize("b,c,t,u,scale", [(16, 16, 47, 32, 0.3), (9, 16, 47, 32, 6.0)])
def test_bf16_twin_against_jax_bf16_and_float32(b, c, t, u, scale):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    p = _params(rng, c, u, scale)
    jax16 = np.asarray(seq_self_attention_pallas(
        jnp.asarray(x, jnp.bfloat16), {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        interpret=True).astype(jnp.float32))
    jax32 = np.asarray(seq_self_attention_pallas(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, interpret=True))
    got = addattn.seq_self_attention(torch.as_tensor(x).to(torch.bfloat16),
                                     {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in p.items()})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - jax16).max() <= 2.0 ** -7 * np.abs(jax16).max()
    jax_err, port_err = np.abs(jax16 - jax32), np.abs(got - jax32)
    assert port_err.max() <= jax_err.max()
    assert port_err.mean() <= jax_err.mean()


@pytest.mark.parametrize("form", ["exp", "exp2"])
def test_kernel_tanh_form_in_float32(form):
    """tanh(a) = 1 - 2 / (exp(2a) + 1) as the kernel evaluates it, in float32
    (``"exp2"``: exp(2a) as 2^(a * 2 log2 e), the kernel's instruction),
    against float64 tanh over [-200, 200]: exp(2a) overflows to inf above
    a = 44.4 and vanishes below -52, and the form gives exactly 1 and -1
    there, never NaN. Max abs error 1.8e-7 (exp) / 2.4e-7 (exp2) here; the
    kernel's approximate ex2 and rcp add about 1e-7 each; pinned at 5e-7."""
    rng = np.random.default_rng(0)
    a = np.concatenate([np.linspace(-200, 200, 400001), rng.normal(size=200000) * 3,
                        rng.normal(size=100000) * 0.01,
                        [0.0, 44.0, 44.5, 88.8, -52.0, -104.0, 200.0, -200.0]]).astype(np.float32)
    a = torch.as_tensor(a)
    if form == "exp":
        e = torch.exp(2 * a)
    else:
        e = torch.exp2(a * np.float32(2.8853900817779268))
    assert torch.isinf(e).any() and (e == 0).any()  # both saturations are in the range
    got = 1 - 2 / (e + 1)
    assert got.dtype == torch.float32 and not torch.isnan(got).any()
    assert (got[torch.isinf(e)] == 1).all() and (got[e == 0] == -1).all()
    err = (got.double() - torch.tanh(a.double())).abs().max().item()
    assert err <= 5e-7, err


def test_wrapper_checks_its_arguments():
    x = torch.zeros(2, 16, 47)
    q = torch.zeros(2, 47, 32)
    wa = torch.zeros(32)
    with pytest.raises(ValueError):
        addattn.addattn(x[0], q, q, wa)
    with pytest.raises(ValueError):
        addattn.addattn(x, q[:, :40], q[:, :40], wa)
    with pytest.raises(ValueError):
        addattn.addattn(x, q, q[..., :16], wa)
    with pytest.raises(ValueError):
        addattn.addattn(x, q, q, wa[:8])
    with pytest.raises(TypeError):
        addattn.addattn(x.double(), q, q, wa)
    with pytest.raises(ValueError):
        addattn.addattn(x, q, q, wa.to("meta"))
    # the kernel's shared-memory budget (227 KB a CTA with the opt-in attribute):
    # the main path's two windows a CTA and one window of T = 128 fit, T = 256 does not
    assert addattn.windows_per_cta(232, 16, 47, 32, 132, project=True) == 2
    assert addattn._smem_bytes(16, 47, 32, 2, True) <= 57 * 1024
    assert addattn._smem_bytes(16, 128, 32, 1, True) <= addattn.MAX_SHARED_BYTES
    assert addattn._smem_bytes(16, 256, 32) > addattn.MAX_SHARED_BYTES
    assert addattn.windows_per_cta(1, 16, 256, 32, 132) == 0
    assert addattn.windows_per_cta(3000, 16, 47, 32, 132) == addattn.MAX_WINDOWS_PER_CTA


def test_addattn_x_checks_its_arguments():
    x = torch.zeros(2, 16, 47)
    wt = torch.zeros(16, 32)
    bh = torch.zeros(32)
    assert addattn.addattn_x(x, wt, bh, wt, bh).shape == x.shape
    with pytest.raises(ValueError):
        addattn.addattn_x(x[0], wt, bh, wt, bh)
    with pytest.raises(ValueError):
        addattn.addattn_x(x, wt[:8], bh, wt[:8], bh)  # C of the weights is not x's
    with pytest.raises(ValueError):
        addattn.addattn_x(x, wt, bh, wt[:, :16], bh)
    with pytest.raises(ValueError):
        addattn.addattn_x(x, wt, bh[:8], wt, bh)
    with pytest.raises(ValueError):
        addattn.addattn_x(x, wt, bh, wt, bh[:, None])  # Wa as the model stores it, (U, 1)
    with pytest.raises(TypeError):
        addattn.addattn_x(x, wt.double(), bh, wt, bh)
    with pytest.raises(ValueError):
        addattn.addattn_x(x, wt, bh, wt.to("meta"), bh)


def _jax_init(model, seed):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed)))


def _windows(n, w, seed):
    x = np.random.default_rng(seed).normal(size=(n, 3, w)).astype(np.float32)
    return x / np.abs(x).max(axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def small_pair():
    jmodel = JaxEQT(**SMALL)
    params = _jax_init(jmodel, 3)
    # attention weights at a scale where the softmax is far from uniform
    rng = np.random.default_rng(4)
    for name in ("transformer_d0", "transformer_d"):
        att = params[name]["attention"]
        for k in ("Wx", "Wt", "Wa"):
            att[k] = rng.uniform(-0.5, 0.5, att[k].shape).astype(np.float32)
    model = EQTransformer(**SMALL)
    model.load_state_dict(eqtransformer_state_dict_from_jax(params), strict=True)
    return jmodel, params, model.eval()


def test_forward_under_pattn_matches_jax(small_pair, monkeypatch):
    jmodel, params, model = small_pair
    x = _windows(3, 1504, seed=21)  # B = 3: not a multiple of the Pallas block
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jmodel.apply(jparams, jnp.asarray(x), fused=PATTN)  # Pallas interpreted
    calls = []
    monkeypatch.setattr(port_eqt, "seq_self_attention_kernel",
                        lambda *a, **k: calls.append(1) or addattn.seq_self_attention(*a, **k))
    with torch.inference_mode():
        got = model(torch.as_tensor(x), fused=PATTN)
        assert len(calls) == 2  # once per transformer block
        plain = model(torch.as_tensor(x))
        assert len(calls) == 2  # the default route does not go through the wrapper
    for g, w, d in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=EQT_ATOL)
        np.testing.assert_allclose(g.numpy(), d.numpy(), atol=EQT_ATOL)


def test_voleqt_inherits_the_route():
    jmodel = JaxVolEQT(**SMALL)
    params = _jax_init(jmodel, 5)
    model = VolEQTransformer(fused=PATTN, **SMALL)
    model.load_state_dict(voleqtransformer_state_dict_from_jax(params), strict=True)
    assert model.resolve_fused() == PATTN
    x = _windows(2, 1504, seed=22)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), fused=PATTN)
    with torch.inference_mode():
        got = model.eval()(torch.as_tensor(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=EQT_ATOL)


def test_fused_resolution_order(monkeypatch):
    monkeypatch.delenv("VOLPICK_EQT_FUSED", raising=False)
    assert EQTransformer(**SMALL).resolve_fused() == "plstm+bandattn"
    monkeypatch.setenv("VOLPICK_EQT_FUSED", PATTN)
    assert EQTransformer(**SMALL).resolve_fused() == PATTN
    # the constructor field wins over the environment
    assert EQTransformer(fused="plstm+bandattn", **SMALL).resolve_fused() == "plstm+bandattn"
    assert load_model("eqtransformer", fused=True, device="cpu", **SMALL).resolve_fused() == "plstm+bandattn"
    monkeypatch.setenv("VOLPICK_EQT_FUSED", "1")
    assert EQTransformer(**SMALL).resolve_fused() == "plstm+bandattn"
    assert load_model("voleqtransformer", fused="pattn+bandattn+plstm", device="cpu", **SMALL).resolve_fused() == PATTN


def test_picker_freezes_the_route(monkeypatch):
    monkeypatch.setenv("VOLPICK_EQT_FUSED", PATTN)
    model = load_model("eqtransformer", device="cpu", **SMALL)
    WaveformPicker(model, device="cpu")
    monkeypatch.setenv("VOLPICK_EQT_FUSED", "plstm+bandattn")
    assert model.fused == PATTN and model.resolve_fused() == PATTN


# every token of the JAX grammar is taken (tests/test_torch_eqt_routes.py); what
# is left to refuse is a token that grammar does not have
@pytest.mark.parametrize("flag,error", [
    ("plstm+bandattn+nosuch", ValueError), ("fast", ValueError), ("lstm+bandattn+", ValueError),
    ("plstm,bandattn", ValueError), ("plstm bandattn", ValueError), ("grouped+blockdiag+dense", ValueError),
    ("polyup2", ValueError), ("2", ValueError), ("none", ValueError),
])
def test_fused_flags_the_port_refuses(flag, error, monkeypatch):
    model = EQTransformer(**SMALL)
    x = torch.zeros(1, 3, 1504)
    with pytest.raises(error):
        model(x, fused=flag)
    with pytest.raises(error):
        EQTransformer(fused=flag, **SMALL).resolve_fused()
    if isinstance(flag, str):
        monkeypatch.setenv("VOLPICK_EQT_FUSED", flag)
        with pytest.raises(error):
            model.resolve_fused()


def test_jax_refuses_the_same_unknown_token():
    jmodel = JaxEQT(**SMALL)
    with pytest.raises(ValueError, match="unknown fused flags"):
        jmodel.apply({}, jnp.zeros((1, 3, 1504)), fused="plstm+bandattn+nosuch")
    with pytest.raises(ValueError, match="unknown fused flags"):
        port_eqt.parse_fused("plstm+bandattn+nosuch")
