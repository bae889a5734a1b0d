"""Every collective of the parallel tiers, in one place.

NCCL takes CUDA tensors for every operation here. gloo takes CPU tensors
for point-to-point and all-gather, and CUDA tensors too for all-reduce;
so on a gloo group a CUDA tensor goes through host memory for
``exchange`` and ``all_gather_cat`` (and for those alone), and the result
comes back to the tensor's device. On NCCL nothing goes through the host.

Each function takes the ``Mesh`` (for the backend) and one of its groups.
A group of None is the one-process mesh's: the operation is the identity.
Every rank of a group must make the same calls in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Tags of the two directions of a row exchange (gloo matches messages by
# peer and tag; NCCL ignores tags).
TAG_DOWN = 1    # to the next rank of the group
TAG_UP = 2      # to the previous rank


def _host_copy(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(mesh, group, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ``group``, in place; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(mesh, group, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ``t`` of every rank of ``group`` (equal shapes), concatenated
    along ``dim`` in the group's rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _host_copy(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def exchange(mesh, group, sends: list, recvs: list) -> list:
    """Point-to-point exchange in one batch: ``sends`` is a list of
    (tensor, global peer rank, tag), ``recvs`` a list of (shape, dtype,
    global peer rank, tag); returns the received tensors on the device of
    the first send (or the CPU), in ``recvs``' order."""
    if not sends and not recvs:
        return []
    device = sends[0][0].device if sends else torch.device("cpu")
    host = mesh.backend == "gloo" and device.type == "cuda"
    where = torch.device("cpu") if host else device
    ops, bufs = [], []
    for t, peer, tag in sends:
        src = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, src.cpu() if host else src, peer, group, tag))
    for shape, dtype, peer, tag in recvs:
        buf = torch.empty(shape, dtype=dtype, device=where)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(device) for b in bufs]
