"""Every ``fused`` route of the port's EQTransformer family vs the JAX package.

A small EQTransformer and a small VolEQTransformer (in_samples 1504, one
BiLSTM block) are initialised by JAX, carried over with ``models/convert.py``
and run by both packages on the same windows under the same ``fused`` flag
(where the JAX route reaches a Pallas kernel it runs in interpret mode, as in
the JAX package's own tests). Tolerances: 2e-4 absolute on probabilities
against JAX (the README's EQT forward pin) and on every ``stop_after`` stage;
1e-4 between two routes of the port; 1e-5 for ``polyup`` against the plain
decoder (the JAX package's own pin of the polyphase re-association) and for
the grouped convolutions alone.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_eqtransformer import _jax_params, _windows
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.models import layers as jlayers
from volpick_tpu.models.eqtransformer import _block_diag_kernel as jax_block_diag
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer, load_model
from volpick_tpu_torch.models import eqtransformer as port_eqt
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models.convert import (
    eqtransformer_state_dict_from_jax,
    voleqtransformer_state_dict_from_jax,
)
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm
from volpick_tpu_torch.ops.cuda import upconv as cuda_upconv
from volpick_tpu_torch.picker import WaveformPicker

ATOL = 2e-4
ROUTE_ATOL = 1e-4
POLY_ATOL = 1e-5
SMALL = dict(in_samples=1504, lstm_blocks=1)
ROUTES = [False, "lstm", "plstm", "bandattn", "lstm+bandattn", "polyup", "plstm+bandattn+polyup",
          "grouped", "blockdiag", "lstm+grouped+polyup", "plstm+bandattn+blockdiag+polyup",
          "plstm+bandattn+pattn+grouped"]


@pytest.fixture(scope="module", params=["eqtransformer", "voleqtransformer"])
def pair(request):
    """(JAX model, its parameters as jnp arrays, the port's model, windows)."""
    jcls, cls, convert = {
        "eqtransformer": (JaxEQT, EQTransformer, eqtransformer_state_dict_from_jax),
        "voleqtransformer": (JaxVolEQT, VolEQTransformer, voleqtransformer_state_dict_from_jax),
    }[request.param]
    jmodel = jcls(**SMALL)
    params = _jax_params(jmodel)
    model = cls(**SMALL)
    model.load_state_dict(convert(params), strict=True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model.eval(), _windows(2, 1504)


def _port(model, x, **kw):
    with torch.inference_mode():
        out = model(torch.as_tensor(x), **kw)
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("fused", ROUTES, ids=str)
def test_route_matches_jax_and_the_default_route(pair, fused):
    jmodel, jparams, model, x = pair
    want = jmodel.apply(jparams, jnp.asarray(x), fused=fused)
    got = _port(model, x, fused=fused)
    default = _port(model, x)
    assert len(got) == len(want) == len(model.labels) + len(model.detection_branches) - 1
    for g, w, d in zip(got, want, default):
        assert g.shape == (2, 1504) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g, d, atol=ROUTE_ATOL)


@pytest.mark.parametrize("merge", ["", "grouped", "blockdiag"])
def test_polyup_within_1e5_of_the_plain_decoder(pair, merge):
    _, _, model, x = pair
    base = "plstm+bandattn" + ("+" + merge if merge else "")
    for g, w in zip(_port(model, x, fused=base + "+polyup"), _port(model, x, fused=base)):
        np.testing.assert_allclose(g, w, atol=POLY_ATOL)


@pytest.mark.parametrize("fused", [None, False, "lstm+grouped", "plstm+bandattn+blockdiag+polyup"], ids=str)
def test_logits_are_the_logit_of_the_probabilities(pair, fused):
    jmodel, jparams, model, x = pair
    logits = _port(model, x, fused=fused, logits=True)
    probs = _port(model, x, fused=fused)
    jfused = "plstm+bandattn" if fused is None else fused
    want = jmodel.apply(jparams, jnp.asarray(x), fused=jfused, logits=True)
    for lg, pr, w in zip(logits, probs, want):
        np.testing.assert_allclose(1.0 / (1.0 + np.exp(-lg.astype(np.float64))), pr, atol=1e-6)
        # a logit moves by the probability's error over p (1 - p): compare as probabilities
        np.testing.assert_allclose(jax.nn.sigmoid(lg), jax.nn.sigmoid(w), atol=ATOL)
        assert (lg < 0).any() or (lg > 1).any()  # not probabilities


@pytest.mark.parametrize("fused", ["plstm+bandattn", False, "lstm"], ids=str)
@pytest.mark.parametrize("stage", port_eqt.STAGES)
def test_stop_after_matches_jax(pair, stage, fused):
    jmodel, jparams, model, x = pair
    want = jmodel.apply(jparams, jnp.asarray(x), fused=fused, stop_after=stage)
    got = _port(model, x, fused=fused, stop_after=stage)
    if stage == "pick":
        assert isinstance(got, list) and len(got) == len(want) == len(model.detection_branches) + 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    else:
        assert got.shape == tuple(want.shape)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    if stage == "encoder":
        np.testing.assert_array_equal(got, model.encode(torch.as_tensor(x)).detach().numpy())


def test_stop_after_refuses_an_unknown_stage(pair):
    jmodel, jparams, model, x = pair
    with pytest.raises(ValueError, match="stop_after must be one of"):
        model(torch.as_tensor(x), stop_after="decoder")
    with pytest.raises(ValueError, match="stop_after must be one of"):
        jmodel.apply(jparams, jnp.asarray(x), stop_after="decoder")


# (flag, the canonical route): the JAX grammar, "plstm" implying "lstm", "grouped"
# winning over "blockdiag", tokens in any order and case
GRAMMAR = [
    (True, "plstm+bandattn"), ("1", "plstm+bandattn"), ("true", "plstm+bandattn"), ("ON", "plstm+bandattn"),
    ("yes", "plstm+bandattn"), (False, "0"), ("0", "0"), ("false", "0"), ("off", "0"), ("No", "0"), ("", "0"),
    ("lstm", "lstm"), ("plstm", "plstm"), ("lstm+plstm", "plstm"), ("bandattn", "bandattn"),
    ("lstm+bandattn", "lstm+bandattn"), ("bandattn+plstm", "plstm+bandattn"),
    ("pattn+bandattn+plstm", "plstm+bandattn+pattn"), ("pattn", "pattn"), ("polyup", "polyup"),
    ("grouped", "grouped"), ("blockdiag", "blockdiag"), ("blockdiag+grouped", "grouped"),
    ("plstm+bandattn+grouped", "plstm+bandattn+grouped"),
    ("plstm+bandattn+blockdiag", "plstm+bandattn+blockdiag"),
    ("plstm+bandattn+polyup", "plstm+bandattn+polyup"),
    (" Polyup+BlockDiag+lstm ", "lstm+blockdiag+polyup"),
    ("polyup+grouped+pattn+bandattn+plstm", "plstm+bandattn+pattn+grouped+polyup"),
]


@pytest.mark.parametrize("flag,route", GRAMMAR, ids=[repr(f) for f, _ in GRAMMAR])
def test_parse_fused_takes_the_jax_grammar(flag, route, monkeypatch):
    assert port_eqt.parse_fused(flag) == route
    assert port_eqt.parse_fused(route) == route  # canonical names are fixed points
    assert EQTransformer(fused=flag, **SMALL).resolve_fused() == route
    # the picker freezes the canonical route, whatever the environment says later
    monkeypatch.setenv("VOLPICK_EQT_FUSED", "lstm+polyup")
    model = load_model("eqtransformer", fused=flag, device="cpu", **SMALL)
    WaveformPicker(model, device="cpu")
    assert model.fused == route and model.resolve_fused() == route
    if isinstance(flag, str) and flag.strip():
        monkeypatch.setenv("VOLPICK_EQT_FUSED", flag)
        assert EQTransformer(**SMALL).resolve_fused() == route
    # the JAX forward parses the same flag without complaint
    if flag not in ("",):
        jflag = flag.strip().lower() if isinstance(flag, str) else flag
        if jflag in ("1", "true", "on", "yes"):
            jflag = True
        elif jflag in ("0", "false", "off", "no"):
            jflag = False
        JaxEQT(**SMALL).apply({"encoder": []}, jnp.zeros((1, 3, 1504)), fused=jflag, stop_after="encoder")


def test_default_route_is_unchanged(pair, monkeypatch):
    _, _, model, x = pair
    monkeypatch.delenv("VOLPICK_EQT_FUSED", raising=False)
    assert port_eqt.DEFAULT_FUSED == "plstm+bandattn" and model.resolve_fused() == "plstm+bandattn"
    for g, w in zip(_port(model, x), _port(model, x, fused="plstm+bandattn")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fused,merged_calls,plain_calls", [
    ("plstm+bandattn", 2, 0),  # one BiLSTM block + the pick LSTMs through lstm_branches
    ("lstm", 0, 2),  # the same two merged recurrences, without the kernel's wrapper
    (False, 0, 4),  # two directions + two pick LSTMs, one recurrence each
], ids=str)
def test_which_recurrence_a_route_calls(pair, fused, merged_calls, plain_calls, monkeypatch):
    """On a CUDA tensor ``lstm_branches`` launches the kernel; the routes without
    "plstm" must not reach it."""
    _, _, model, x = pair
    calls = {"kernel": 0, "plain": 0}
    for mod in (tlayers, port_eqt):
        real_k, real_p = mod.lstm_branches, mod.lstm_branches_reference
        monkeypatch.setattr(mod, "lstm_branches", lambda *a, _r=real_k, **k: (
            calls.__setitem__("kernel", calls["kernel"] + 1), _r(*a, **k))[1])
        monkeypatch.setattr(mod, "lstm_branches_reference", lambda *a, _r=real_p, **k: (
            calls.__setitem__("plain", calls["plain"] + 1), _r(*a, **k))[1])
    before = cuda_lstm.launches
    _port(model, x, fused=fused)
    assert calls == {"kernel": merged_calls, "plain": plain_calls}
    assert cuda_lstm.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("fused,takes", [
    ("plstm+bandattn", True), (False, True), ("lstm", True), ("plstm+bandattn+pattn", True),
    ("polyup", False), ("plstm+bandattn+polyup", False), ("grouped", False), ("blockdiag", False),
    ("plstm+bandattn+pattn+grouped", False), ("lstm+grouped+polyup", False),
], ids=str)
def test_which_routes_take_the_decoder_kernel(pair, fused, takes, monkeypatch):
    """The float32 eval forward of a per-branch decoder route without
    "polyup" sends every decoder layer through ``upconv_relu`` (on the card,
    its kernel); the other routes keep their own decoder code."""
    _, _, model, x = pair
    calls = []
    real = port_eqt.upconv_relu
    monkeypatch.setattr(port_eqt, "upconv_relu", lambda *a, **k: (calls.append(k["crop_last"]), real(*a, **k))[1])
    before = cuda_upconv.launches
    _port(model, x, fused=fused)
    n_dec = len(model.detection_branches) + len(model.pick_decoders)
    assert len(calls) == (7 * n_dec if takes else 0)
    if takes:  # each decoder crops where the encoder padded
        assert calls == [int(i in model._crops) for i in range(7)] * n_dec and sum(calls) == n_dec
    assert cuda_upconv.launches == before  # CPU tensors launch nothing


def test_train_mode_and_bf16_keep_the_plain_decoder(pair, monkeypatch):
    _, _, model, x = pair
    calls = []
    monkeypatch.setattr(port_eqt, "upconv_relu", lambda *a, **k: calls.append(1))
    xt = torch.as_tensor(x)
    model.train()
    try:
        with torch.no_grad():
            model(xt)
    finally:
        model.eval()
    half = copy.deepcopy(model).to(torch.bfloat16)
    with torch.inference_mode():
        out = half(xt.to(torch.bfloat16))
    assert calls == [] and all(o.dtype == torch.bfloat16 for o in out)


def test_branches_span_counts_the_kernel_layers(pair):
    """``eqt.branches`` carries ``upconv``: the decoder layers run through the
    kernel in that forward, 0 on the CPU (the twin runs there)."""
    from torch.profiler import ProfilerActivity, profile

    from volpick_tpu_torch.utils import profiling

    _, _, model, x = pair
    with profile(activities=[ProfilerActivity.CPU]):
        _port(model, x)
        _port(model, x, fused="polyup")
    got = [s for s in profiling.spans() if s.name == "eqt.branches"][-2:]
    assert [s.counts for s in got] == [{"upconv": 0}, {"upconv": 0}]


@pytest.mark.parametrize("groups,k,crop", [(1, 3, False), (3, 7, False), (3, 7, True), (4, 11, True),
                                           (2, 1, True)])
def test_grouped_convs_match_jax(groups, k, crop):
    rng = np.random.default_rng(groups * 100 + k)
    x = rng.normal(size=(2, groups * 4, 23)).astype(np.float32)
    w = rng.normal(size=(groups * 6, 4, k)).astype(np.float32) * 0.2
    b = rng.normal(size=(groups * 6,)).astype(np.float32)
    tx, tw, tb = (torch.as_tensor(a) for a in (x, w, b))
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    np.testing.assert_allclose(tlayers.conv1d_same(tx, tw, tb, groups=groups).numpy(),
                               np.asarray(jlayers.conv1d_same(jx, jw, jb, groups=groups)), atol=POLY_ATOL)
    np.testing.assert_allclose(
        tlayers.conv1d(tx, tw, tb, stride=2, padding=(2, 1), groups=groups).numpy(),
        np.asarray(jlayers.conv1d(jx, jw, jb, stride=2, padding=(2, 1), groups=groups)), atol=POLY_ATOL)
    got = tlayers.upsample2_conv1d_same(tx, tw, tb, crop_last=crop, groups=groups).numpy()
    want = jlayers.upsample2_conv1d_same(jx, jw, jb, crop_last=crop, groups=groups)
    np.testing.assert_allclose(got, np.asarray(want), atol=POLY_ATOL)
    up = tlayers.upsample_nearest(tx, 2)
    plain = tlayers.conv1d_same(up[..., :-1] if crop else up, tw, tb, groups=groups).numpy()
    np.testing.assert_allclose(got, plain, atol=POLY_ATOL)
    with pytest.raises(ValueError, match="odd kernels"):
        tlayers.upsample2_conv1d_same(tx, tw[..., :2] if k > 1 else tw.repeat(1, 1, 2), tb)


def test_block_diag_kernel_matches_jax():
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=(5, 4, 3)).astype(np.float32) for _ in range(3)]
    got = port_eqt._block_diag_kernel([torch.as_tensor(w) for w in ws]).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_block_diag([jnp.asarray(w) for w in ws])))
    assert got.shape == (15, 12, 3)


def test_masked_attention_matches_jax_and_the_band():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 16, 47)).astype(np.float32)
    p = {"Wx": rng.uniform(-0.3, 0.3, (16, 32)), "Wt": rng.uniform(-0.3, 0.3, (16, 32)),
         "bh": rng.normal(size=(32,)) * 0.1, "Wa": rng.uniform(-0.3, 0.3, (32, 1)),
         "ba": rng.normal(size=(1,)) * 0.1}
    jp = {k: jnp.asarray(v.astype(np.float32)) for k, v in p.items()}
    tp = {k: torch.as_tensor(v.astype(np.float32)) for k, v in p.items()}
    for width in (3, 5, 1):
        got = tlayers.seq_self_attention_masked(torch.as_tensor(x), tp, width).numpy()
        want = jlayers.seq_self_attention(jnp.asarray(x), jp, attention_width=width)[0]
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    # at the model's scale of weights (uniform +-0.02) the band's own max moves
    # the result by O(eps): 1e-5, the JAX package's pin of the two forms
    small = {k: v * (0.02 / 0.3) for k, v in tp.items()}
    got = tlayers.seq_self_attention_masked(torch.as_tensor(x), small, 3).numpy()
    banded = tlayers.seq_self_attention_banded(torch.as_tensor(x), small, 3).numpy()
    np.testing.assert_allclose(got, banded, atol=1e-5)


def test_layers_lstm_routes_agree():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(3, 8, 11)).astype(np.float32))
    p = {}
    for suf in ("", "_rev"):
        p["w_ih" + suf] = torch.as_tensor(rng.uniform(-0.3, 0.3, (16, 8)).astype(np.float32))
        p["w_hh" + suf] = torch.as_tensor(rng.uniform(-0.3, 0.3, (16, 4)).astype(np.float32))
        p["b_ih" + suf] = torch.as_tensor(rng.normal(size=16).astype(np.float32) * 0.1)
        p["b_hh" + suf] = torch.as_tensor(rng.normal(size=16).astype(np.float32) * 0.1)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = np.asarray(jlayers.bilstm(jnp.asarray(x.numpy()), jp, fused=False))
    for fused in ("pallas", True, False):
        np.testing.assert_allclose(tlayers.bilstm(x, p, fused=fused).numpy(), want, atol=1e-5)
    one = tlayers.lstm(x, p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"], reverse=True, kernel=False)
    np.testing.assert_array_equal(
        one.numpy(), tlayers.lstm(x, p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"], reverse=True).numpy())
