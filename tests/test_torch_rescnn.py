"""The fused residual CNN stack of the port (``ops/cuda/rescnn.py``) vs the
JAX package.

``fold_res_cnn_params`` of the port, fed the port's modules loaded from
converted JAX weights, must give the arrays of the JAX
``fold_res_cnn_params`` (1e-6: one division and one product per channel in
float32 vs numpy's float64-free float32). On the CPU ``res_cnn_stack`` runs
its plain twin; it is held against the Pallas kernel ``res_cnn_stack_pallas``
in interpret mode, against the JAX model's own res-CNN section and against
the port's module loop at 3e-4 (the tests/test_pallas.py pin: 14 convs of 64
channels accumulate in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.ops.pallas.rescnn import fold_res_cnn_params as jax_fold
from volpick_tpu.ops.pallas.rescnn import res_cnn_stack_pallas
from volpick_tpu_torch.models import EQTransformer
from volpick_tpu_torch.models.convert import eqtransformer_state_dict_from_jax
from volpick_tpu_torch.ops.cuda import rescnn

ATOL = 3e-4
FOLD_ATOL = 1e-6
SMALL = dict(in_samples=1504, lstm_blocks=1)


@pytest.fixture(scope="module")
def pair():
    """JAX res-CNN parameters with BN statistics away from (0, 1), and the
    port's model loaded from them."""
    jmodel = JaxEQT(**SMALL)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(6)
    for blk in params["res_cnn"]:
        for nk in ("norm1", "norm2"):
            blk[nk]["mean"] = rng.normal(size=64).astype(np.float32) * 0.3
            blk[nk]["var"] = (rng.random(64) * 2 + 0.5).astype(np.float32)
            blk[nk]["scale"] = (rng.normal(size=64) * 0.5 + 1).astype(np.float32)
            blk[nk]["bias"] = (rng.normal(size=64) * 0.1).astype(np.float32)
        for ck in ("conv1", "conv2"):
            blk[ck]["b"] = (rng.normal(size=64) * 0.1).astype(np.float32)
    model = EQTransformer(**SMALL)
    model.load_state_dict(eqtransformer_state_dict_from_jax(params), strict=True)
    return params["res_cnn"], model.eval()


def test_fold_matches_jax(pair):
    jres, model = pair
    mine = rescnn.fold_res_cnn_params(model.res_cnn_stack)
    theirs = jax_fold(jres)
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert tuple(mine[k].shape) == v.shape and mine[k].dtype == torch.float32, k
        assert mine[k].is_contiguous() and not mine[k].requires_grad
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(v), atol=FOLD_ATOL, err_msg=k)
    # kernel-2 convs (blocks 4 and 6) carry a zero -1 tap; kernel-3 ones do not
    assert model.res_cnn_kernels == (3, 3, 3, 3, 2, 3, 2)
    for j, k in enumerate(model.res_cnn_kernels):
        assert (mine["w1"][j, 0].abs().max() == 0) == (k == 2)
        assert (mine["w2"][j, 0].abs().max() == 0) == (k == 2)


def _jax_section(jres, x):
    from volpick_tpu.models.layers import batch_norm, conv1d_same

    h = x
    for blk in jres:
        y = jax.nn.relu(batch_norm(h, blk["norm1"], train=False, eps=1e-3)[0])
        y = conv1d_same(y, blk["conv1"]["w"], blk["conv1"]["b"])
        y = jax.nn.relu(batch_norm(y, blk["norm2"], train=False, eps=1e-3)[0])
        h = h + conv1d_same(y, blk["conv2"]["w"], blk["conv2"]["b"])
    return h


# B not a multiple of the Pallas tile; T = 47 (the main path), 12 (the small model), 1
@pytest.mark.parametrize("b,t,tile", [(5, 47, 4), (16, 47, 16), (3, 12, 2), (2, 1, 2)])
def test_twin_matches_pallas_and_the_module_loop(pair, b, t, tile):
    jres, model = pair
    x = np.random.default_rng(b + t).normal(size=(b, 64, t)).astype(np.float32)
    packed = rescnn.fold_res_cnn_params(model.res_cnn_stack)
    before = rescnn.launches
    got = rescnn.res_cnn_stack(torch.as_tensor(x), packed).numpy()
    assert rescnn.launches == before  # a CPU tensor launches nothing
    assert got.shape == x.shape and np.isfinite(got).all()
    pallas = res_cnn_stack_pallas(jnp.asarray(x), jax_fold(jres), tile=tile, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    jtree = jax.tree_util.tree_map(jnp.asarray, jres)
    np.testing.assert_allclose(got, np.asarray(_jax_section(jtree, jnp.asarray(x))), atol=ATOL)
    with torch.inference_mode():
        h = torch.as_tensor(x)
        for block in model.res_cnn_stack.members:
            h = block(h)
    np.testing.assert_allclose(got, h.numpy(), atol=ATOL)


def test_fold_refuses_other_kernel_sizes():
    model = EQTransformer(res_cnn_kernels=(3, 5), **SMALL)
    with pytest.raises(ValueError, match="kernel size 5"):
        rescnn.fold_res_cnn_params(model.res_cnn_stack)


def test_wrapper_checks_its_arguments(pair):
    _, model = pair
    packed = rescnn.fold_res_cnn_params(model.res_cnn_stack)
    x = torch.zeros(2, 64, 47)
    with pytest.raises(ValueError):
        rescnn.res_cnn_stack(x[0], packed)
    with pytest.raises(ValueError):
        rescnn.res_cnn_stack(x[:, :32], packed)
    with pytest.raises(ValueError):
        rescnn.res_cnn_stack(x, {k: v for k, v in packed.items() if k != "g2"})
    with pytest.raises(ValueError):
        rescnn.res_cnn_stack(x, dict(packed, cb1=packed["cb1"][:3]))
    with pytest.raises(TypeError):
        rescnn.res_cnn_stack(x.double(), packed)
    with pytest.raises(ValueError):
        rescnn.res_cnn_stack(x.to("meta"), packed)


@pytest.mark.parametrize("b,want", [
    (1, (1, 1)), (2, (1, 2)), (131, (1, 131)), (132, (1, 132)), (133, (2, 67)), (232, (2, 116)),
    (233, (2, 117)), (256, (2, 128)), (264, (2, 132)), (265, (3, 89)), (396, (3, 132)), (397, (4, 100)),
    (528, (4, 132)), (529, (4, 133)), (5000, (4, 1250)),
])
def test_rescnn_plan(b, want):
    """Windows a CTA and CTAs on a card of 132 SMs: as few windows a CTA as
    leave no SM a second CTA, at most 4; every window in exactly one CTA."""
    wpc, ctas, smem = rescnn.rescnn_plan(b, 132)
    assert (wpc, ctas) == want
    assert (ctas - 1) * wpc < b <= ctas * wpc and 1 <= wpc <= rescnn.MAX_WINDOWS
    assert ctas <= 132 or wpc == rescnn.MAX_WINDOWS
    # two weight buffers of 48 KB, two parameter buffers, two activation buffers a window
    assert smem == 4 * (2 * 3 * 64 * 64 + 2 * 6 * 64 + wpc * 2 * (64 * 56 + 64))
    assert smem <= 232448  # what a block may take on an H100
    assert rescnn.rescnn_plan(b, 132, wpc=1) == (1, b, 4 * (24576 + 768 + 7296))


def test_rescnn_plan_refuses():
    for bad in ((0, 132), (5, 0)):
        with pytest.raises(ValueError, match="needs b >= 1"):
            rescnn.rescnn_plan(*bad)
    for wpc in (0, 5):
        with pytest.raises(ValueError, match="windows a CTA"):
            rescnn.rescnn_plan(10, 132, wpc)
    assert rescnn.rescnn_plan(10, 4) == (3, 4, rescnn.rescnn_plan(3, 1)[2])  # a small card


def test_no_blocks_and_no_windows_on_the_cpu(pair):
    _, model = pair
    packed = rescnn.fold_res_cnn_params(model.res_cnn_stack)
    none = {k: v[:0] for k, v in packed.items()}
    x = torch.randn(2, 64, 5)
    assert torch.equal(rescnn.res_cnn_stack(x, none), x)
    assert rescnn.res_cnn_stack(x[:0], packed).shape == (0, 64, 5)
