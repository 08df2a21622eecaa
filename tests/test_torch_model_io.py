"""``export_pretrained`` of the port against the JAX package: the pair it
writes (`<name>.json.v1` + `<name>.npz.v1`) loads in JAX's
``load_pretrained_npz`` with the same forward (1e-5 PhaseNet, 2e-4
EQTransformer), and back in the port exactly (``convert.load_npz_v1``,
``from_pretrained``); the port's ``load_pretrained_npz`` reads such a pair,
with and without the ``architecture`` field, as the model JAX's reads
(architecture, arguments, every weight).

``load_pretrained_npz`` takes only the tree structure from the JAX model's
``init``; the test has ``init`` traced abstractly (``jax.eval_shape``), the
same structure without ~18 s of eager CPU work an architecture.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_train_common import perturbed_params, state_dict_from_jax
from volpick_tpu.train import model_io as jax_model_io
from volpick_tpu.train.model_io import load_pretrained_npz
from volpick_tpu_torch.models import EQTransformer, PhaseNet, TPUPickNet, from_pretrained
from volpick_tpu_torch.models.convert import MODEL_FIELDS, load_npz_v1
from volpick_tpu_torch.train import model_io as port_model_io
from volpick_tpu_torch.train.model_io import export_pretrained

SMALL = dict(in_samples=1504, lstm_blocks=1)


@pytest.mark.parametrize("arch,kw,atol", [("phasenet", {}, 1e-5), ("eqtransformer", SMALL, 2e-4)])
def test_export_pretrained_loads_in_jax_and_back(tmp_path, arch, kw, atol):
    cls = {"phasenet": PhaseNet, "eqtransformer": EQTransformer}[arch]
    model = cls(generator=torch.Generator().manual_seed(3), **kw)
    model.load_state_dict(state_dict_from_jax(arch, perturbed_params(model)), strict=True)
    model.eval()
    d = export_pretrained(model, tmp_path, name="mine", default_args={"P_threshold": 0.3})
    meta = json.loads((d / "mine.json.v1").read_text())
    assert meta["architecture"] == arch and meta["default_args"] == {"P_threshold": 0.3}
    jcls = jax_model_io._MODELS[arch]
    init = jcls.init
    with mock.patch.object(jcls, "init", lambda self, key: jax.eval_shape(lambda k: init(self, k), key)):
        jmodel, jparams = load_pretrained_npz(d / "mine.json.v1", d / "mine.npz.v1")
    x = np.random.default_rng(4).normal(size=(2, 3, model.in_samples)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    kw_apply = {"fused": False} if arch != "phasenet" else {}
    want = jax.jit(lambda p, v: jmodel.apply(p, v, **kw_apply))(jparams, jnp.asarray(x))
    for g, w in zip(got if isinstance(got, tuple) else [got], want if isinstance(want, tuple) else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    # the port reads the pair back exactly, through convert.py and the registry
    arch2, back = load_npz_v1(d / "mine.json.v1", d / "mine.npz.v1")
    again = from_pretrained(arch, "mine", search_paths=[str(tmp_path)], device="cpu")
    assert arch2 == arch and again.default_args == {"P_threshold": 0.3}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back.state_dict()[k], v) and torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("legacy", [False, True], ids=["architecture", "legacy"])
@pytest.mark.parametrize("arch,cls,kw", [
    ("phasenet", PhaseNet, {"filters_root": 4}),
    ("eqtransformer", EQTransformer, SMALL),
    ("tpupicknet", TPUPickNet, dict(in_samples=512, d_model=32, n_heads=2, n_layers=1)),
])
def test_load_pretrained_npz_reads_what_jax_reads(tmp_path, arch, cls, kw, legacy):
    """A legacy export (no ``architecture`` field) is sniffed from its
    arguments by both packages alike."""
    model = cls(generator=torch.Generator().manual_seed(5), **kw)
    d = export_pretrained(model, tmp_path, name="mine", default_args={"S_threshold": 0.2})
    meta_path = d / "mine.json.v1"
    if legacy:
        meta = json.loads(meta_path.read_text())
        del meta["architecture"]
        meta_path.write_text(json.dumps(meta))
    jcls = jax_model_io._MODELS[arch]
    init = jcls.init
    with mock.patch.object(jcls, "init", lambda self, key: jax.eval_shape(lambda k: init(self, k), key)):
        jmodel, jparams = load_pretrained_npz(meta_path, d / "mine.npz.v1")
    got = port_model_io.load_pretrained_npz(meta_path, d / "mine.npz.v1")
    assert type(got) is cls and got.name == jmodel.name and not got.training
    assert got.default_args == jmodel.default_args == {"S_threshold": 0.2}
    for field in MODEL_FIELDS[arch]:
        assert getattr(got, field) == getattr(jmodel, field), field
    want = state_dict_from_jax(arch, jax.device_get(jparams))
    assert set(want) <= set(got.state_dict())
    for k, v in want.items():
        assert torch.equal(got.state_dict()[k], v), k
