"""Device-mesh and data-parallel helpers (PyTorch port of
``volpick_tpu/parallel/mesh.py``).

The picking models are small, so the parallelism is pure data / window
parallel: parameters replicated, the batch (training samples or classify
stations) split over the ranks, gradients all-reduced. JAX runs that as one
program over every device of the job; PyTorch runs one process per card
over ``torch.distributed``: NCCL on the card, gloo only where the caller
asks for it (the CPU tests, two ranks sharing one card). Each process calls
``initialize_distributed`` (or ``torch.distributed.init_process_group``
itself), then ``make_mesh``; the mesh it returns is the world's
``DeviceMesh`` and carries the rank's device in ``mesh.device``.

Also here: ``GlobalBatchNorm1d``, the train-mode BatchNorm of a data mesh
(statistics of the global batch, as JAX's jit of a sharded batch computes
them), and ``global_batch_norm``, which puts it in a model's place of every
``nn.BatchNorm1d`` for the length of a ``with`` block.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

# the rendezvous and every collective give up after this long instead of
# waiting forever on a rank that died
TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group of `num_processes` ranks whose rank 0 listens
    at `coordinator_address` ("host:port"); this process is rank
    `process_id`. A no-op when `num_processes` is None or <= 1.

    ``backend=None`` is NCCL, the card's. gloo runs only where the caller
    names it (CPU tensors, or several ranks on one card): a missing card is
    an error here, never a reason to fall back."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        backend="nccl" if backend is None else backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device=None,
):
    """The world's ``DeviceMesh``: 1-D over the data axis by default, or
    `shape` with `axis_names` (e.g. ("data", "model")). Needs an
    initialised process group. ``mesh.device`` is this rank's device:
    `device` when it names one ("cpu", "cuda:1"), else ``cuda:$LOCAL_RANK``
    (the global rank when LOCAL_RANK is unset), which must exist.

    `n_devices` must be the world size: JAX takes the first n devices, here
    a smaller mesh would need a subgroup, which nothing uses."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the world has {world} ranks")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"make_mesh: rank {dist.get_rank()} wants cuda:{local}, but this host has "
                f"{torch.cuda.device_count()} CUDA devices; pass device= to place the rank"
            )
        device = torch.device("cuda", local)
    if device.type == "cuda":
        # before the mesh, which otherwise picks a card by rank
        torch.cuda.set_device(device)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    mesh = DeviceMesh(device.type, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))
    mesh.device = device
    return mesh


def mesh_device(mesh, device, who: str) -> torch.device:
    """The device of an entry point under `mesh`: the rank's. A `device` the
    caller names must be it ("cuda" without an index names any card)."""
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
            raise ValueError(f"{who}: device={device} but the mesh places this rank on {mesh.device}")
    return mesh.device


def replicated(mesh) -> List:
    """Parameters: the same on every rank of every mesh axis."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def batch_sharding(mesh, axis: str = "data") -> List:
    """The batch's leading axis split over `axis`, replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def data_shard(mesh, axis: str = "data") -> Tuple[int, int]:
    """(this rank's index on `axis`, the axis' size)."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def shard_batch(batch: Dict, mesh, axis: str = "data") -> Dict[str, torch.Tensor]:
    """This rank's rows of every array of `batch` (leading axis split in
    equal blocks over `axis`, block r to rank r), as tensors on
    ``mesh.device``. A leading size that does not divide raises ValueError."""
    rank, n = data_shard(mesh, axis)
    out = {}
    for key, value in batch.items():
        value = torch.as_tensor(value)
        if value.shape[0] % n:
            raise ValueError(f"shard_batch: {key} has {value.shape[0]} rows, not divisible by {n} ranks")
        rows = value.shape[0] // n
        out[key] = value[rank * rows : (rank + 1) * rows].to(mesh.device)
    return out


class GlobalBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train mode normalises by the statistics of
    the batch of every rank of `group`, and updates the running statistics
    with them (momentum, unbiased variance over the global count), as one
    process holding the whole batch would.

    The per-channel count and sum, then the sum of squares about the global
    mean (two passes: E[x^2] - E[x]^2 cancels in float32), are all-reduced
    by ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the gradients of those sums, on every backend. Eval mode is
    ``nn.BatchNorm1d``'s."""

    def __init__(self, bn: nn.BatchNorm1d, group):
        # on "meta": the tensors of `bn` take the place of the new ones
        super().__init__(bn.num_features, eps=bn.eps, momentum=bn.momentum, device="meta")
        self.weight, self.bias = bn.weight, bn.bias
        self.running_mean, self.running_var = bn.running_mean, bn.running_var
        self.num_batches_tracked = bn.num_batches_tracked
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        local = torch.full((1,), x.shape[0] * x.shape[2], dtype=x.dtype, device=x.device)
        sums = all_reduce(torch.cat([local, x.sum(dim=(0, 2))]), group=self.group)
        n, mean = sums[0], sums[1:] / sums[0]
        xc = x - mean[None, :, None]
        var = all_reduce((xc * xc).sum(dim=(0, 2)), group=self.group) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var * n / torch.clamp(n - 1, min=1))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return xc * (inv * self.weight)[None, :, None] + self.bias[None, :, None]


@contextlib.contextmanager
def global_batch_norm(model: nn.Module, group):
    """Inside the block, a ``GlobalBatchNorm1d`` over `group` stands in the
    place of every ``nn.BatchNorm1d`` of `model`, holding the same parameters
    and statistics under the same state-dict names; the plain modules are
    back when the block ends. The model outside the block holds no process
    group: it can be deep-copied, and runs after the group is destroyed."""
    swapped = []

    def swap(parent: nn.Module) -> None:
        for name, child in list(parent.named_children()):
            if type(child) is nn.BatchNorm1d:
                setattr(parent, name, GlobalBatchNorm1d(child, group))
                swapped.append((parent, name, child))
            else:
                swap(child)

    try:
        swap(model)
        yield model
    finally:
        for parent, name, child in swapped:
            setattr(parent, name, child)
