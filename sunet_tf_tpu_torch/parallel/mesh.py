"""Process groups and the (data, spatial) mesh over them
(``sunet_tf_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``('data', 'spatial')`` device mesh; here
each rank of a ``torch.distributed`` group is one device (one card, or one
CPU process under gloo) and runs the same program on its share:

- ``data``: the batch rows. Rank (d, s) holds rows d*B/D .. (d+1)*B/D of
  every global batch (``shard_batch``, JAX ``P('data')``); the gradient is
  summed over the ranks of one spatial coordinate (the data group).
- ``spatial``: the activation rows H of the Swin stages the spatial runner
  takes (``parallel/spatial.py``); the ranks of one data coordinate (the
  spatial group) hold the same batch rows.

The ranks are laid out ``(data, spatial)`` in row order, as
``np.array(devices).reshape(data, spatial)``: rank r sits at (r //
spatial, r % spatial). Every collective of the two tiers goes through
``parallel/comm.py``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# A collective that waits longer than this fails instead of hanging.
TIMEOUT_S = 300


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments the rendezvous comes from the environment torchrun
    sets (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); else
    ``coordinator`` is a ``tcp://host:port`` address (or ``host:port``)
    with ``num_processes`` and ``process_id``. ``backend``: NCCL where CUDA
    is available, else gloo, unless named. ``device``: this rank's device;
    by default ``cuda:{LOCAL_RANK}`` where CUDA is available (LOCAL_RANK
    defaults to the process id), else the CPU (gloo only). A rank whose card
    is missing raises; NCCL never runs on the CPU."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw.update(init_method=addr, world_size=int(num_processes), rank=int(process_id))
        local = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        kw["init_method"] = "env://"
        local = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        device = (torch.device("cuda", local) if backend == "nccl" or torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {kw.get('rank', os.environ.get('RANK'))}: no CUDA device "
                               f"cuda:{index} ({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the NCCL backend runs on CUDA devices only")
    dist.init_process_group(**kw)
    return device


class Mesh:
    """The ranks of the group as a (data, spatial) grid, and this rank's
    place in it. ``shape``: {"data": D, "spatial": S}; ``ranks``: the (D, S)
    array of ranks; ``data_index`` / ``spatial_index``: this rank's
    coordinates; ``data_group``: the ranks of this rank's spatial
    coordinate (one per data coordinate), ``spatial_group``: those of its
    data coordinate. ``backend``: the group's backend ("nccl", "gloo"), or
    None for the one-process mesh, whose collectives do nothing."""

    def __init__(self, data: int, spatial: int, rank: int, backend: Optional[str],
                 data_group=None, spatial_group=None):
        self.shape = {"data": int(data), "spatial": int(spatial)}
        self.ranks = np.arange(data * spatial).reshape(data, spatial)
        self.rank = int(rank)
        self.data_index, self.spatial_index = divmod(self.rank, spatial)
        self.backend = backend
        self.data_group = data_group
        self.spatial_group = spatial_group

    def data_peers(self) -> list:
        """The ranks of this rank's data group, by data coordinate."""
        return [int(r) for r in self.ranks[:, self.spatial_index]]

    def spatial_peers(self) -> list:
        """The ranks of this rank's spatial group, by spatial coordinate."""
        return [int(r) for r in self.ranks[self.data_index]]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, spatial={self.shape['spatial']}, "
                f"rank={self.rank} at ({self.data_index}, {self.spatial_index}), "
                f"backend={self.backend})")


def make_mesh(data: int = 0, spatial: int = 1) -> Mesh:
    """The (data, spatial) mesh over the process group; ``data=0`` means
    world size // spatial. Without a process group, the one-process mesh
    (1, 1). Every rank must call it, in the same order as its other group
    calls: it creates one group per grid row and per grid column."""
    spatial = max(1, int(spatial))
    if not dist.is_initialized():
        if max(1, data) * spatial != 1:
            raise RuntimeError(f"a ({data}, {spatial}) mesh needs a process group; "
                               "call init_distributed (or run under torchrun)")
        return Mesh(1, 1, 0, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data <= 0:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f"a ({data}, {spatial}) mesh needs {data * spatial} ranks; the "
                         f"group has {world}")
    grid = np.arange(world).reshape(data, spatial)
    data_group = spatial_group = None
    for s in range(spatial):            # data groups: one per spatial coordinate
        g = dist.new_group([int(r) for r in grid[:, s]])
        if rank in grid[:, s]:
            data_group = g
    for d in range(data):               # spatial groups: one per data coordinate
        g = dist.new_group([int(r) for r in grid[d]])
        if rank in grid[d]:
            spatial_group = g
    return Mesh(data, spatial, rank, dist.get_backend(), data_group, spatial_group)


def data_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's rows of a global batch of ``n`` rows (``P('data')``)."""
    if mesh is None or mesh.shape["data"] == 1:
        return slice(0, n)
    D = mesh.shape["data"]
    if n % D:
        raise ValueError(f"batch {n} does not divide over {D} data ranks")
    k = n // D
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's rows of every entry of a global batch dict (tensors,
    arrays and lists alike)."""
    out = {}
    for k, v in batch.items():
        out[k] = v[data_rows(mesh, len(v))]
    return out
