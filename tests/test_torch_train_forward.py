"""Train-mode forwards of the port's EQTransformer and VolEQTransformer
against JAX ``apply(train=True, rng=None)`` (no dropout in either: the port
gets no generator and ``drop_rate=0``).

Small models (in_samples 1504, one BiLSTM block, as
tests/test_torch_eqtransformer.py) with perturbed BatchNorm statistics.
Tolerances: outputs 2e-4 (the EQT forward pin), BatchNorm running-statistics
updates 1e-5 and the trainer's loss 1e-6 relative, in float32; the gradients of the trainer's loss per
tensor within atol = 1e-4 max|g_jax|, rtol = 1e-3, computed in float64 by
both packages (float32 sums of thousands of terms that nearly cancel, such as
a decoder bias's gradient, differ by up to ~1e-2 of the tensor's largest
entry between any two summation orders, JAX's and PyTorch's float32 against
float64 alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import (
    assert_grads_match,
    jax_loss_and_grads,
    make_batch,
    perturbed_params,
    state_dict_from_jax,
)
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.train.losses import vol_eqt_loss, weighted_bce
from volpick_tpu.train.trainer import Trainer as JaxTrainer
from volpick_tpu.train.trainer import merge_bn_updates
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer
from volpick_tpu_torch.models import eqtransformer as port_eqt
from volpick_tpu_torch.models import layers as port_layers
from volpick_tpu_torch.train.trainer import Trainer

SMALL = dict(in_samples=1504, lstm_blocks=1)
ATOL = 2e-4
BN_TOL = 1e-5
CASES = {
    "eqtransformer": (JaxEQT, EQTransformer, None),
    "voleqtransformer": (JaxVolEQT, VolEQTransformer, [0.0, 1.0, 1.0, 0.0]),
}


def _zero_by_construction(model):
    """Biases a train-mode BatchNorm subtracts again and the attention `ba`."""
    names = [f"res_cnn_stack.members.{j}.conv1.bias" for j in range(len(model.res_cnn_stack.members))]
    names += [f"bi_lstm_stack.members.{j}.conv.bias" for j in range(len(model.bi_lstm_stack.members))]
    names += ["transformer_d0.attention.ba", "transformer_d.attention.ba"]
    return names + [f"pick_attentions.{k}.ba" for k in range(len(model.pick_attentions))]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch = request.param
    jcls, tcls, is_lp = CASES[arch]
    jmodel = jcls(**SMALL)
    params = perturbed_params(tcls(generator=torch.Generator().manual_seed(0), **SMALL))
    batch = make_batch(np.random.default_rng(3), 4, SMALL["in_samples"], eqt=True, is_lp=is_lp)
    jtrainer = JaxTrainer(jmodel, params=params)

    def port(dtype=torch.float32):
        model = tcls(drop_rate=0.0, **SMALL)
        model.load_state_dict(state_dict_from_jax(arch, params), strict=True)
        return model.to(dtype)

    return arch, jmodel, params, batch, jtrainer, port


def test_train_forward_bn_updates_and_loss_match_jax(case):
    arch, jmodel, params, batch, jtrainer, port = case
    want, updates = jax.jit(lambda p, x: jmodel.apply(p, x, train=True))(params, jnp.asarray(batch["X"]))
    model = port().train()
    trainer = Trainer(model, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(batch["X"]))
        loss = trainer._loss(port().train(), {k: torch.as_tensor(v) for k, v in batch.items()})
    assert len(got) == len(want) == (4 if arch == "voleqtransformer" else 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # the loss the JAX trainer takes of these outputs (Trainer._loss's formulas)
    if arch == "voleqtransformer":
        det, is_lp = batch["detections"][:, 0], batch["is_lp"][:, None]
        w3 = jtrainer.loss_weights
        want_loss = vol_eqt_loss(*want, det * (1 - is_lp), det * is_lp, batch["y"][:, 0], batch["y"][:, 1],
                                 (w3[0], w3[0], w3[1], w3[2]))
    else:
        want_loss = weighted_bce(*want, batch["detections"][:, 0], batch["y"][:, 0], batch["y"][:, 1],
                                 jtrainer.loss_weights)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    # the BN updates, merged into the JAX tree, are the port's running buffers
    merged = state_dict_from_jax(arch, merge_bn_updates(params, jax.device_get(updates)))
    n_bn = 0
    for name, buf in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            n_bn += 1
            np.testing.assert_allclose(buf.numpy(), merged[name].numpy(), atol=BN_TOL, err_msg=name)
            assert not np.allclose(buf.numpy(), state_dict_from_jax(arch, params)[name].numpy())
    assert n_bn == 2 * (2 * 7 + 1)


def test_trainer_gradients_match_jax(case):
    arch, _, params, batch, jtrainer, port = case
    loss64, _, grads64 = jax_loss_and_grads(jtrainer, params, batch, np.float64)
    model = port(torch.float64)
    got64 = Trainer(model, device="cpu").gradients(
        {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()})
    np.testing.assert_allclose(float(got64), loss64, rtol=1e-12)
    assert all(p.grad is not None for p in model.parameters())
    assert_grads_match(model, state_dict_from_jax(arch, grads64, np.float64), _zero_by_construction(model))


def test_train_mode_takes_the_per_branch_program(case, monkeypatch):
    """No kernel wrapper is reached in train mode; an explicit route raises."""
    arch, _, _, batch, _, port = case

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called in train mode")

    for mod in (port_eqt, port_layers):
        monkeypatch.setattr(mod, "lstm_branches", refuse)
    monkeypatch.setattr(port_eqt, "seq_self_attention_kernel", refuse)
    monkeypatch.setenv("VOLPICK_EQT_FUSED", "plstm+bandattn+pattn")
    model = port().train()
    x = torch.as_tensor(batch["X"][:2])
    model(x)
    model(x, fused=False)
    for fused in ("plstm+bandattn", True, "lstm"):
        with pytest.raises(ValueError, match="inference-only"):
            model(x, fused=fused)
    with pytest.raises(ValueError, match="inference-only"):
        model(x, stop_after="encoder")
    model.fused = "plstm"
    with pytest.raises(ValueError, match="inference-only"):
        model(x)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        model.eval()(x)  # eval mode takes the kernel route of the field


def test_dropout_sits_where_jax_puts_it(case):
    """With a generator and drop_rate > 0 the train forward draws 21 masks in
    the order of the JAX program (14 spatial on the res-CNN, one a BiLSTM
    block, one a transformer feed-forward, one a pick LSTM): the same
    generator seed gives the same outputs, another seed others."""
    arch, _, _, batch, _, port = case
    model = port()
    model.drop_rate = 0.1
    model.train()
    x = torch.as_tensor(batch["X"][:2])
    calls = []
    real_drop, real_spatial = port_eqt.dropout, port_eqt.spatial_dropout1d

    def count(fn, kind):
        def wrapped(h, rate, gen, train):
            calls.append((kind, tuple(h.shape)))
            return fn(h, rate, gen, train)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_eqt, "dropout", count(real_drop, "dropout"))
        mp.setattr(port_eqt, "spatial_dropout1d", count(real_spatial, "spatial"))
        a = model(x, generator=torch.Generator().manual_seed(1))
    assert [k for k, _ in calls] == ["spatial"] * 14 + ["dropout"] * (1 + 2 + 2)
    b = model(x, generator=torch.Generator().manual_seed(1))
    c = model(x, generator=torch.Generator().manual_seed(2))
    none = model(x)
    for i in range(len(a)):
        assert torch.equal(a[i], b[i])
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[1], none[1])
