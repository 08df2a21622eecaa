"""The port's mesh layer on two gloo ranks of the CPU, against the JAX package.

- ``parallel/mesh.py``: ``make_mesh`` shapes (1-D and 2-D) and placements,
  ``shard_batch``'s rows, the ``ValueError``s (a batch that does not divide,
  ``n_devices`` other than the world) and the refusal of a rank beyond the
  cards; ``initialize_distributed()`` a no-op, NCCL unless gloo is named;
- ``GlobalBatchNorm1d``: a train-mode step on two ranks gives the output,
  input gradient, summed parameter gradients and running statistics of
  ``nn.BatchNorm1d`` on the whole batch (float64, 1e-12);
- ``WaveformPicker(mesh=)``: a narrow PhaseNet classifies 2 stations a rank;
  on every rank the picks are exactly those of the JAX picker over
  ``make_mesh(2)`` and of the port's single-process picker, and the gathered
  curves lie within 1e-6 of the single-process ones (each rank stacks its
  stations' windows in other steps: float32 sums grouped otherwise);
- a TPUPickNet picker over a mesh resolves "xla" under
  ``VOLPICK_TPN_ATTN=pallas``, as in ``tests/test_picker.py``; the field
  still picks "pallas".

The ranks run once for the file (``tests/torch_dist_common.py``).
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_picker_models import _threshold
from tests.torch_dist_common import WORLD, results, run_ranks
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.parallel import make_mesh as jax_make_mesh
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.models import PhaseNet
from volpick_tpu_torch.models.convert import phasenet_state_dict_from_jax
from volpick_tpu_torch.parallel import mesh as pm
from volpick_tpu_torch.picker import WaveformPicker

NARROW = {"filters_root": 4}
STATIONS, SAMPLES = 2 * WORLD, 9000
KW = {"overlap": 1500, "blinding": [250, 250], "batch_size": 8}
CURVE_TOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("mesh_ranks")
    rng = np.random.default_rng(3)
    np.savez(io / "mesh_api_in.npz", bn_x=rng.normal(size=(8, 5, 7)) * 3 + 1, bn_w=rng.uniform(0.5, 1.5, 5),
             bn_b=rng.normal(size=5), bn_g=rng.normal(size=(8, 5, 7)))

    jmodel = JaxPhaseNet(**NARROW)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(7)))
    sd = phasenet_state_dict_from_jax(params)
    model = PhaseNet(**NARROW)
    model.load_state_dict(sd, strict=True)
    t = np.arange(SAMPLES) / 100.0
    data = (rng.normal(size=(STATIONS, 3, SAMPLES)) * 0.05).astype(np.float32)
    for s in range(STATIONS):
        data[s] += (np.sin(2 * np.pi * 6 * t) * np.where(t >= 20 + 9 * s, np.exp(-(t - 20 - 9 * s) / 2.0), 0.0)
                    ).astype(np.float32)
    kw = dict(KW, blinding=tuple(KW["blinding"]))
    single = WaveformPicker(model, device="cpu")
    curves = single.annotate_array(data, **kw)
    jcurves = JaxPicker(jmodel, jax.tree_util.tree_map(jnp.asarray, params)).annotate_array(data, **kw)
    margin = 10 * float(np.abs(curves - jcurves).max()) + 1e-6
    thr = {lab: _threshold(jcurves[:, i], 0.99, margin) for i, lab in enumerate("PS")}
    np.savez(io / "picker_in.npz", data=data, meta=json.dumps({"model": NARROW, "thresholds": thr, "kw": KW}),
             **{f"sd.{k}": v.numpy() for k, v in sd.items()})
    run_ranks(io, ["mesh_api", "picker"])
    return {"io": io, "jmodel": jmodel, "params": params, "data": data, "thr": thr, "kw": kw,
            "single": single.classify_arrays(data, thr, **kw), "curves": curves}


def test_make_mesh_shapes_and_placements(ranks):
    for rank, out in enumerate(results(ranks["io"], "mesh_api")):
        assert tuple(out["mesh1_shape"]) == (WORLD,)
        assert tuple(out["mesh1_names"]) == ("data",)
        assert str(out["mesh1_device"]) == "cpu"
        assert list(out["mesh1_placements"]) == ["Replicate()", "Shard(dim=0)"]
        assert tuple(out["mesh2x1_shape"]) == (WORLD, 1) and tuple(out["mesh2x1_shard"]) == (rank, WORLD)
        assert tuple(out["mesh1x2_shape"]) == (1, WORLD) and tuple(out["mesh1x2_shard"]) == (0, 1)
        assert list(out["mesh2x1_placements"]) == ["Shard(dim=0)", "Replicate()"]


def test_shard_batch_gives_each_rank_its_block(ranks):
    per = 8 // WORLD
    for rank, out in enumerate(results(ranks["io"], "mesh_api")):
        want = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)[rank * per : (rank + 1) * per]
        np.testing.assert_array_equal(out["shard_X"], want)
        np.testing.assert_array_equal(out["shard_y"], np.arange(8)[rank * per : (rank + 1) * per])


def test_mesh_refusals(ranks):
    """A batch that does not divide and n_devices other than the world raise
    ValueError; a rank whose LOCAL_RANK names no card raises (here: none)."""
    for out in results(ranks["io"], "mesh_api"):
        assert list(out["refused"]) == ["indivisible", "n_devices", "local_rank"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pm.make_mesh(device="cpu")


def test_initialize_distributed(monkeypatch):
    calls = []
    monkeypatch.setattr(pm.dist, "init_process_group", lambda **kw: calls.append(kw))
    pm.initialize_distributed()
    pm.initialize_distributed("localhost:1234", 1, 0)
    assert calls == []
    pm.initialize_distributed("localhost:1234", 2, 1)
    pm.initialize_distributed("localhost:1234", 2, 0, backend="gloo")
    assert [c["backend"] for c in calls] == ["nccl", "gloo"]
    for rank, c in zip((1, 0), calls):
        assert c["init_method"] == "tcp://localhost:1234" and c["world_size"] == 2 and c["rank"] == rank
        assert 0 < c["timeout"].total_seconds() < 3600


def test_global_batch_norm_equals_one_process(ranks):
    inputs = np.load(ranks["io"] / "mesh_api_in.npz")
    x = torch.as_tensor(inputs["bn_x"]).requires_grad_(True)
    bn = torch.nn.BatchNorm1d(5, eps=1e-3).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(inputs["bn_w"]))
        bn.bias.copy_(torch.as_tensor(inputs["bn_b"]))
    y = bn(x)
    (y * torch.as_tensor(inputs["bn_g"])).sum().backward()
    outs = results(ranks["io"], "mesh_api")
    per = 8 // WORLD
    np.testing.assert_allclose(np.concatenate([o["bn_y"] for o in outs]), y.detach().numpy(), atol=1e-12)
    np.testing.assert_allclose(np.concatenate([o["bn_dx"] for o in outs]), x.grad.numpy(), atol=1e-12)
    np.testing.assert_allclose(sum(o["bn_dw"] for o in outs), bn.weight.grad.numpy(), atol=1e-12)
    np.testing.assert_allclose(sum(o["bn_db"] for o in outs), bn.bias.grad.numpy(), atol=1e-12)
    for o in outs:
        assert o["bn_y"].shape[0] == per
        np.testing.assert_allclose(o["bn_mean"], bn.running_mean.numpy(), atol=1e-12)
        np.testing.assert_allclose(o["bn_var"], bn.running_var.numpy(), atol=1e-12)
        assert int(o["bn_count"]) == int(bn.num_batches_tracked) == 1


def test_global_batch_norm_takes_every_batchnorm_in_place():
    """Inside the block every nn.BatchNorm1d is a GlobalBatchNorm1d holding
    the same tensors under the same names; after it the plain modules are
    back, also when the block raises."""
    model = PhaseNet(**NARROW)
    before = dict(model.state_dict(keep_vars=True))
    plain = [m for m in model.modules() if type(m) is torch.nn.BatchNorm1d]
    with pm.global_batch_norm(model, group=None):
        assert plain and sum(isinstance(m, pm.GlobalBatchNorm1d) for m in model.modules()) == len(plain)
        assert not any(type(m) is torch.nn.BatchNorm1d for m in model.modules())
        inside = model.state_dict(keep_vars=True)
        assert list(inside) == list(before) and all(inside[k] is before[k] for k in before)
    with pytest.raises(KeyError), pm.global_batch_norm(model, group=None):
        raise KeyError
    assert [m for m in model.modules() if type(m) is torch.nn.BatchNorm1d] == plain
    assert not any(isinstance(m, pm.GlobalBatchNorm1d) for m in model.modules())


def test_a_model_trained_on_a_mesh_stays_the_callers(tmp_path):
    """A world of one gloo rank in this process: after data-parallel steps
    the model holds plain BatchNorm modules and no process group, so it
    deep-copies, a bf16 picker builds from it (a deep copy) and gives the
    float32 picker's curves within bf16's rounding, and it runs a train-mode
    forward after the group is gone. A device the mesh does not place the
    rank on is refused."""
    import datetime

    import torch.distributed as dist

    from volpick_tpu_torch.train.trainer import Trainer

    model = PhaseNet(**NARROW)
    rng = np.random.default_rng(4)
    batch = {"X": torch.as_tensor(rng.normal(size=(4, 3, model.in_samples)), dtype=torch.float32),
             "y": torch.softmax(torch.as_tensor(rng.normal(size=(4, 3, model.in_samples)), dtype=torch.float32), 1)}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        trainer = Trainer(model, ema=True, device="cpu")
        assert trainer.mesh is not None and trainer.shard == (0, 1)
        with pytest.raises(ValueError, match="places this rank on cpu"):
            WaveformPicker(model, device="cuda", mesh=trainer.mesh)
        for lr in (1e-3, 2e-3):
            trainer.train_step(batch, lr)
        trainer.eval_step(batch)
    finally:
        dist.destroy_process_group()
    assert not any(isinstance(m, pm.GlobalBatchNorm1d) for m in model.modules())
    data = (rng.normal(size=(1, 3, model.in_samples)) * 0.1).astype(np.float32)
    kw = dict(overlap=0, batch_size=1)
    want = WaveformPicker(copy.deepcopy(model), device="cpu").annotate_array(data, **kw)
    got = WaveformPicker(model, device="cpu", precision="bfloat16").annotate_array(data, **kw)
    assert got.shape == want.shape and np.abs(got - want).max() <= 0.05
    model.train()
    assert torch.isfinite(model(batch["X"])).all()


def test_sharded_generator_rows_make_the_one_process_batch():
    """The ranks' blocks of ``TrainGenerator.epoch(shard=(r, 2))``, joined,
    are the one-process batches exactly, every key of every batch: stacking
    with secondary events and noise, EQTransformer's augmentation (detection
    labels, detrend, peak norm), a last batch padded from a partial one
    (drop_last=False), host crop and device-resident crop."""
    from volpick_tpu_torch.data.synthetic import synthetic_arrays
    from volpick_tpu_torch.models import EQTransformer
    from volpick_tpu_torch.pipeline.generator import RawBatchSource, TrainGenerator
    from volpick_tpu_torch.train.trainer import make_augment_config

    waves, meta = synthetic_arrays(n_events=14, n_noise=5, n_samples=3200, seed=2)
    p = np.array([m["trace_p_arrival_sample"] for m in meta], np.float32)
    s = np.array([m["trace_s_arrival_sample"] for m in meta], np.float32)
    event = ~np.isnan(p) | ~np.isnan(s)

    def source(mask):
        return RawBatchSource.from_arrays(waves[mask], p[mask], s[mask], is_lp=np.zeros(int(mask.sum()), np.float32))

    config = json.loads((Path(__file__).resolve().parents[1] / "examples/configs/eqtransformer_vcseis.json").read_text())
    cfg = make_augment_config(EQTransformer(in_samples=1504, lstm_blocks=1), config["model_args"], True)
    for device_data in (False, True):
        def epochs(shard):
            g = TrainGenerator(source(np.ones(len(p), bool)), cfg, 6, eq_dataset=source(event),
                               noise_dataset=source(~event), seed=11, drop_last=False, device_data=device_data,
                               device="cpu")
            assert g.device_data == device_data and len(g) * 6 > len(p)
            return [list(g.epoch(shard=shard)) for _ in range(2)]

        whole = epochs(None)
        parts = [epochs((r, WORLD)) for r in range(WORLD)]
        for e, batches in enumerate(whole):
            assert len(batches) == 4
            for i, b in enumerate(batches):
                assert set(b) == {"X", "y", "detections", "is_lp"}
                for k, v in b.items():
                    joined = torch.cat([part[e][i][k] for part in parts])
                    assert all(part[e][i][k].shape[0] == 6 // WORLD for part in parts)
                    assert torch.equal(joined, v), (device_data, e, i, k)


def test_sharded_picks_equal_jax_and_one_process(ranks):
    jax_res = JaxPicker(ranks["jmodel"], jax.tree_util.tree_map(jnp.asarray, ranks["params"]),
                        mesh=jax_make_mesh(WORLD)).classify_arrays(ranks["data"], ranks["thr"], **ranks["kw"])
    single = ranks["single"]
    assert set(single) == set(jax_res) == {"P", "S"}
    assert sum(int(single[lab][2].sum()) for lab in single) > 0
    for out in results(ranks["io"], "picker"):
        for label in single:
            for i, what in enumerate(("peak", "value", "valid", "onset", "offset")):
                got = out[f"{label}.{i}"]
                assert got.shape[0] == STATIONS
                np.testing.assert_array_equal(got, single[label][i], err_msg=f"{label} {what}")
                valid = single[label][2]
                if what == "value":
                    np.testing.assert_allclose(got[valid], np.asarray(jax_res[label][i])[valid], atol=2e-5)
                else:
                    np.testing.assert_array_equal(np.asarray(got)[valid], np.asarray(jax_res[label][i])[valid],
                                                  err_msg=f"{label} {what}")
            np.testing.assert_array_equal(out[f"{label}.2"], np.asarray(jax_res[label][2]))
        np.testing.assert_allclose(out["curves"], ranks["curves"], atol=CURVE_TOL)
        assert bool(out["refused_indivisible"])


def test_sharded_tpupicknet_takes_xla(ranks):
    for out in results(ranks["io"], "picker"):
        assert str(out["tpn_sharded"]) == "xla"
        assert list(out["tpn_resolve"]) == ["pallas", "xla"]
        assert str(out["tpn_field"]) == "pallas"
