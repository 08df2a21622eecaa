"""Train-mode forwards of the port's PhaseNet and TPUPickNet against JAX
``apply(train=True)``, and the dropout layers' invariants.

PhaseNet at full size (3001 samples, depth 5) with perturbed BatchNorm
statistics; TPUPickNet small (in_samples 512, d_model 32, 2 heads, 1 layer,
as tests/test_torch_tpupicknet.py). Tolerances: outputs 2e-5 (the PhaseNet
and TPUPickNet forward pins), BatchNorm running-statistics updates 1e-5 and
the trainer's loss 1e-6 relative, in float32; gradients of the trainer's
loss per tensor within atol = 1e-4 max|g_jax|, rtol = 1e-3 in float64 (see
tests/test_torch_train_forward.py for why float64).
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
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.models import TPUPickNet as JaxTPUPickNet
from volpick_tpu.train.losses import vector_cross_entropy
from volpick_tpu.train.trainer import Trainer as JaxTrainer
from volpick_tpu.train.trainer import merge_bn_updates
from volpick_tpu_torch.models import PhaseNet, TPUPickNet
from volpick_tpu_torch.models import layers as tlayers
from volpick_tpu_torch.models import tpupicknet as port_tpn
from volpick_tpu_torch.train.trainer import Trainer

ATOL = 2e-5
BN_TOL = 1e-5
CASES = {
    "phasenet": (JaxPhaseNet, PhaseNet, {}, ["inc.bias"]),
    "tpupicknet": (JaxTPUPickNet, TPUPickNet, dict(in_samples=512, d_model=32, n_heads=2, n_layers=1,
                                                   attn="pallas"), []),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch = request.param
    jcls, tcls, kw, zero = CASES[arch]
    jmodel = jcls(**kw)
    params = perturbed_params(tcls(generator=torch.Generator().manual_seed(0), **kw))
    batch = make_batch(np.random.default_rng(4), 4, jmodel.in_samples, eqt=False)

    def port(dtype=torch.float32):
        model = tcls(**kw)
        model.load_state_dict(state_dict_from_jax(arch, params), strict=True)
        return model.to(dtype)

    return arch, jmodel, params, batch, JaxTrainer(jmodel, params=params), port, zero


def test_train_forward_bn_updates_and_loss_match_jax(case, monkeypatch):
    arch, jmodel, params, batch, _, port, _ = case

    def refuse(*a, **k):
        raise AssertionError("K7 was called in train mode")

    monkeypatch.setattr(port_tpn, "mha_qkv", refuse)  # TPUPickNet trains on "xla"
    want, updates = jax.jit(lambda p, x: jmodel.apply(p, x, train=True))(params, jnp.asarray(batch["X"]))
    model = port().train()
    with torch.no_grad():
        got = model(torch.as_tensor(batch["X"]))
        loss = Trainer(port().train(), device="cpu")._loss(
            port().train(), {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(loss), float(vector_cross_entropy(want, jnp.asarray(batch["y"]))),
                               rtol=1e-6)
    merged = state_dict_from_jax(arch, merge_bn_updates(params, jax.device_get(updates)))
    stats = [n for n in model.state_dict() if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == (2 * (1 + 4 * 2 + 1 + 4 * 2) if arch == "phasenet" else 0)
    for name in stats:
        np.testing.assert_allclose(model.state_dict()[name].numpy(), merged[name].numpy(), atol=BN_TOL,
                                   err_msg=name)


def test_trainer_gradients_match_jax(case):
    arch, _, params, batch, jtrainer, port, zero = case
    loss64, _, grads64 = jax_loss_and_grads(jtrainer, params, batch, np.float64)
    model = port(torch.float64)
    got64 = Trainer(model, device="cpu").gradients(
        {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()})
    np.testing.assert_allclose(float(got64), loss64, rtol=1e-12)
    assert_grads_match(model, state_dict_from_jax(arch, grads64, np.float64), zero)


def test_dropout_invariants():
    x = torch.ones(64, 32, 500)
    for fn in (tlayers.dropout, tlayers.spatial_dropout1d):
        assert fn(x, 0.3, torch.Generator().manual_seed(0), train=False) is x
        assert fn(x, 0.3, None, train=True) is x
        assert fn(x, 0.0, torch.Generator().manual_seed(0), train=True) is x
        a = fn(x, 0.3, torch.Generator().manual_seed(0), train=True)
        b = fn(x, 0.3, torch.Generator().manual_seed(0), train=True)
        c = fn(x, 0.3, torch.Generator().manual_seed(1), train=True)
        assert torch.equal(a, b) and not torch.equal(a, c)
        kept = a != 0
        # the kept entries are scaled by 1 / keep, the others zero
        torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7), rtol=0, atol=0)
        assert abs(kept.float().mean().item() - 0.7) < 0.01
    # the spatial form keeps or drops whole channels
    s = tlayers.spatial_dropout1d(x, 0.5, torch.Generator().manual_seed(3), train=True)
    per_channel = (s != 0).float().mean(dim=-1)
    assert set(per_channel.unique().tolist()) == {0.0, 1.0}
    d = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(3), train=True)
    assert 0.0 < (d != 0).float().mean(dim=-1).min() and (d != 0).float().mean(dim=-1).max() < 1.0
    # the gradient passes the kept entries, scaled
    xg = torch.ones(4, 8, 16, requires_grad=True)
    tlayers.dropout(xg, 0.25, torch.Generator().manual_seed(5), train=True).sum().backward()
    assert set(xg.grad.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
