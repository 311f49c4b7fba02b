"""The process group the sharded functions run on.

Port of kmerutils_tpu/parallel/mesh.py.  JAX's 1-D device mesh becomes the
default ``torch.distributed`` process group with one rank per device: NCCL
with rank r on ``cuda:<local rank>``, or gloo when the caller asks for the
CPU (as the tests do).  A ``shard_map`` step becomes plain code on the
rank's local rows, and a collective over the mesh axis a collective over
the group.

The JAX sharding objects have no counterpart of their own:
``reads_sharding`` becomes the rank's block of rows of a global batch
(JAX's reads-sharded layout: world-size equal row blocks, block d on
device d), and ``replicated`` a no-op beyond placing the data on the
rank's device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..base.sequence import ReadBatch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the group: its rank, the world size, the device
    its tensors live on and the group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str


def make_mesh(device="cuda", *, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout: float | None = None) -> Mesh:
    """Join the default process group (initialising it when it is not yet)
    and return this rank's :class:`Mesh`.

    ``device`` "cuda" puts rank r on ``cuda:<LOCAL_RANK>`` (else ``r`` mod
    the visible cards) over NCCL; "cpu" runs the group on gloo.  A group
    that is not initialised yet is created from ``init_method`` (e.g.
    ``tcp://localhost:29500`` or ``file:///path``; None reads the
    ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE`` environment), ``rank``,
    ``world_size`` and ``timeout`` seconds: a collective that some rank
    never enters fails after it instead of waiting for ever.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: unsupported device {dev}")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        r = (dist.get_rank() if dist.is_initialized() else
             rank if rank is not None else int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK",
                                   r % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(want, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    backend = str(dist.get_backend())
    if backend != want:
        raise ValueError(f"make_mesh: the process group runs {backend}, "
                         f"device {dev} needs {want}")
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, backend)


def _row_block(mesh: Mesh, x):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split into {mesh.world} equal "
                         "blocks")
    b = n // mesh.world
    return x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device).contiguous()


def reads_sharding(mesh: Mesh, x):
    """This rank's block of the leading (reads) axis of a global ``x`` (a
    ReadBatch, tensor or numpy array), on the rank's device: rows
    [rank * n / world, (rank + 1) * n / world).  The row count must divide
    by the world size, as JAX's ``shard_map`` requires."""
    if isinstance(x, ReadBatch):
        return ReadBatch(_row_block(mesh, x.words),
                         _row_block(mesh, x.lengths))
    return _row_block(mesh, x)


def replicated(mesh: Mesh, x):
    """Every rank holds the whole of ``x``: only its placement on the rank's
    device remains of JAX's replicated sharding."""
    if isinstance(x, ReadBatch):
        return x.to(mesh.device)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh.device)
