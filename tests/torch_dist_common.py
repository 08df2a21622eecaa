"""Ranks of a data mesh on the CPU for the mesh tests: `WORLD` gloo processes
of this file, each running the named cases in turn.

``run_ranks(io_dir, cases)`` starts them and waits at most `TIMEOUT_S`
seconds, killing every rank and failing the test when one exits non-zero
or time runs out. The ranks meet through a ``file://`` store under
`io_dir` (no TCP port to race for), give up on a collective after 60 s,
read their inputs from ``<case>_in.npz`` and write ``<case>_<rank>.npz``
there. This file imports neither JAX nor the JAX package, so a rank does
not either: the JAX side of each comparison runs in the pytest process.

    python tests/torch_dist_common.py IO_DIR RANK WORLD CASE [CASE ...]
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 120
# a stretched float64 step: the pins of tests/test_torch_trainer.py
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-7


def run_ranks(io_dir: Path, cases, world: int = WORLD, timeout: float = TIMEOUT_S) -> None:
    """Run `cases` on `world` gloo ranks; fail the calling test on a rank's
    error or when the ranks outlast `timeout` seconds."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(io_dir), str(rank), str(world), *cases],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the ranks of {cases} did not finish in {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {rank} of {cases} exited {p.returncode}:\n{out}")


def results(io_dir: Path, case: str, world: int = WORLD):
    """Each rank's output arrays of `case`."""
    return [dict(np.load(io_dir / f"{case}_{rank}.npz", allow_pickle=False)) for rank in range(world)]


def state_arrays(prefix: str, sd) -> dict:
    return {f"{prefix}{k}": v.detach().cpu().numpy() for k, v in sd.items()}


def unprefix(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


# ------------------------------------------------------------------ rank bodies
def _mesh_api(io: Path, rank: int, world: int) -> dict:
    """make_mesh shapes and placements, shard_batch's rows and refusals, and
    a GlobalBatchNorm1d step beside nn.BatchNorm1d on the whole batch."""
    from volpick_tpu_torch.parallel import mesh as pm

    out = {}
    mesh = pm.make_mesh(device="cpu")
    out["mesh1_shape"] = np.array(mesh.mesh.shape)
    out["mesh1_names"] = np.array(mesh.mesh_dim_names)
    out["mesh1_placements"] = np.array([repr(p) for p in pm.replicated(mesh) + pm.batch_sharding(mesh)])
    out["mesh1_device"] = np.array(str(mesh.device))
    for tag, shape in (("2x1", (world, 1)), ("1x2", (1, world))):
        m2 = pm.make_mesh(world, axis_names=("data", "model"), shape=shape, device="cpu")
        out[f"mesh{tag}_shape"] = np.array(m2.mesh.shape)
        out[f"mesh{tag}_shard"] = np.array(pm.data_shard(m2))
        out[f"mesh{tag}_placements"] = np.array([repr(p) for p in pm.batch_sharding(m2)])
    batch = {"X": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "y": np.arange(8)}
    got = pm.shard_batch(batch, mesh)
    out["shard_X"], out["shard_y"] = got["X"].numpy(), got["y"].numpy()
    refused = []
    for what, call in (
        ("indivisible", lambda: pm.shard_batch({"X": np.zeros((3, 2))}, mesh)),
        ("n_devices", lambda: pm.make_mesh(world + 1, device="cpu")),
    ):
        try:
            call()
        except ValueError:
            refused.append(what)
    os.environ["LOCAL_RANK"] = str(torch.cuda.device_count())
    try:
        pm.make_mesh()
    except RuntimeError:
        refused.append("local_rank")
    finally:
        del os.environ["LOCAL_RANK"]
    out["refused"] = np.array(refused)

    inputs = np.load(io / "mesh_api_in.npz")
    x = torch.as_tensor(inputs["bn_x"])
    per = x.shape[0] // world
    bn = torch.nn.BatchNorm1d(x.shape[1], eps=1e-3).double()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(inputs["bn_w"]))
        bn.bias.copy_(torch.as_tensor(inputs["bn_b"]))
    gbn = pm.GlobalBatchNorm1d(bn, mesh.get_group("data")).train()
    xl = x[rank * per : (rank + 1) * per].clone().requires_grad_(True)
    y = gbn(xl)
    # a loss of the whole batch: the mean over ranks of each rank's sum
    (y * torch.as_tensor(inputs["bn_g"])[rank * per : (rank + 1) * per]).sum().backward()
    out["bn_y"], out["bn_dx"] = y.detach().numpy(), xl.grad.numpy()
    out["bn_dw"], out["bn_db"] = bn.weight.grad.numpy(), bn.bias.grad.numpy()
    out["bn_mean"], out["bn_var"] = bn.running_mean.numpy(), bn.running_var.numpy()
    out["bn_count"] = bn.num_batches_tracked.numpy()
    return out


def _picker(io: Path, rank: int, world: int) -> dict:
    """A narrow PhaseNet's classify_arrays / annotate_array over the mesh,
    and a TPUPickNet picker's attention route under $VOLPICK_TPN_ATTN."""
    from volpick_tpu_torch.models import PhaseNet, TPUPickNet
    from volpick_tpu_torch.parallel import make_mesh
    from volpick_tpu_torch.picker import WaveformPicker

    inputs = np.load(io / "picker_in.npz")
    meta = json.loads(str(inputs["meta"]))
    model = PhaseNet(**meta["model"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in unprefix(inputs, "sd.").items()}, strict=True)
    mesh = make_mesh(device="cpu")
    picker = WaveformPicker(model, mesh=mesh)
    res = picker.classify_arrays(inputs["data"], meta["thresholds"], **meta["kw"])
    out = {f"{label}.{i}": a for label, arrs in res.items() for i, a in enumerate(arrs)}
    out["curves"] = picker.annotate_array(inputs["data"], **meta["kw"])
    try:
        picker.classify_arrays(inputs["data"][:world + 1], meta["thresholds"], **meta["kw"])
    except ValueError:
        out["refused_indivisible"] = np.array(True)

    os.environ["VOLPICK_TPN_ATTN"] = "pallas"
    try:
        tpn = TPUPickNet(in_samples=512, d_model=32, n_heads=2, n_layers=1)
        WaveformPicker(tpn, mesh=mesh)
        out["tpn_sharded"] = np.array(tpn.attn)
        out["tpn_resolve"] = np.array([TPUPickNet(n_layers=1).resolve_attn(sharded=s) for s in (False, True)])
        pinned = TPUPickNet(n_layers=1, attn="pallas")
        WaveformPicker(pinned, mesh=mesh)
        out["tpn_field"] = np.array(pinned.attn)
    finally:
        del os.environ["VOLPICK_TPN_ATTN"]
    return out


def _steps(io: Path, rank: int, world: int, case: str) -> dict:
    """`case`'s three data-parallel steps in float64: the model of its
    input's state dict, each rank stepping on its rows of each global batch
    (``shard_batch``) with the trainer's dropout generator. Then the trained
    model's BatchNorm modules (plain ones) and the parameter dtypes of the
    bf16 copy that a picker of precision "bfloat16" makes of it."""
    from volpick_tpu_torch.models.convert import ARCHS
    from volpick_tpu_torch.parallel import make_mesh
    from volpick_tpu_torch.parallel.mesh import shard_batch
    from volpick_tpu_torch.picker import WaveformPicker
    from volpick_tpu_torch.train.trainer import Trainer

    inputs = np.load(io / f"{case}_in.npz")
    meta = json.loads(str(inputs["meta"]))
    model = ARCHS[meta["arch"]](**meta["model"]).double()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in unprefix(inputs, "sd.").items()}, strict=True)
    trainer = Trainer(model, ema=True, device="cpu", mesh=make_mesh(device="cpu") if meta["explicit_mesh"] else None)
    assert trainer.shard == (rank, world), trainer.shard
    gen = trainer.dropout_generator(meta["dropout_seed"])
    losses = []
    for i, lr in enumerate(meta["lrs"]):
        batch = shard_batch(unprefix(inputs, f"b{i}."), trainer.mesh)
        losses.append(float(trainer.train_step(batch, lr, gen)))
    out = {"losses": np.array(losses), **state_arrays("p.", model.state_dict()),
           **state_arrays("ema.", trainer.ema_params)}
    out["plain_bn"] = np.array([type(m) is torch.nn.BatchNorm1d for m in model.modules()
                                if isinstance(m, torch.nn.BatchNorm1d)])
    picker = WaveformPicker(model.float(), device="cpu", precision="bfloat16")
    out["bf16_dtypes"] = np.array(sorted({str(p.dtype) for p in picker._net.parameters()}))
    return out


def _train_config(io: Path, rank: int, world: int) -> dict:
    """``train(config)`` over the world, then every rank restores the run's
    last checkpoint into a fresh trainer."""
    from volpick_tpu_torch.models.convert import ARCHS
    from volpick_tpu_torch.train.trainer import Trainer, train

    config = json.loads((io / "train_config_in.json").read_text())
    res = train(config, experiment_name="dp", device="cpu")
    ckpt = Path(res["exp_dir"]) / "checkpoints" / "last.ckpt"
    fresh = Trainer(ARCHS["phasenet"](), device="cpu").restore(ckpt)
    return {"train_loss": np.array([h["train_loss"] for h in res["history"]]),
            "val_loss": np.array([h["val_loss"] for h in res["history"]]),
            "best": np.array(res["best_checkpoint"]), "restored_step": np.array(fresh.step),
            **state_arrays("p.", fresh.model.state_dict())}


CASES = {
    "mesh_api": _mesh_api,
    "picker": _picker,
    "phasenet_steps": lambda io, r, w: _steps(io, r, w, "phasenet_steps"),
    "eqt_steps": lambda io, r, w: _steps(io, r, w, "eqt_steps"),
    "train_config": _train_config,
}


def main(argv) -> None:
    import torch.distributed as dist

    io, rank, world, cases = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3:]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{io / 'rendezvous'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for case in cases:
            np.savez(io / f"{case}_{rank}.npz", **CASES[case](io, rank, world))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
