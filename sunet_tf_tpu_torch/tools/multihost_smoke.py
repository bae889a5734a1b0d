"""Two-process ``torch.distributed`` smoke for ``parallel/mesh.py``
(``tools/multihost_smoke.py``'s counterpart).

Each process joins one group (``init_distributed``), builds the
(data,) mesh over every rank, holds rows of a global (n, 8) array whose row
i is i (LOCAL_ROWS rows a rank: its ``shard_batch`` share), all-reduces the
sums and counts into the global mean over the data group, and asserts that
it equals the closed form (n - 1) / 2.

    python -m sunet_tf_tpu_torch.tools.multihost_smoke [--nproc 2] [--backend gloo|nccl]
    python -m sunet_tf_tpu_torch.tools.multihost_smoke <process_id> <num_processes> [port]

The first form starts the ranks itself (gloo on the CPU by default; NCCL
needs one card per rank); the second runs one rank of a group that the
caller starts, at ``tcp://localhost:<port>``.
"""

from __future__ import annotations

import argparse
import sys

import torch

LOCAL_ROWS = 2


def check(rank: int, device: torch.device) -> float:
    """One rank's part: the global mean, asserted against its closed form."""
    import torch.distributed as dist

    from sunet_tf_tpu_torch.parallel import comm
    from sunet_tf_tpu_torch.parallel.mesh import make_mesh, shard_batch

    world = dist.get_world_size()
    mesh = make_mesh(data=world)
    n = LOCAL_ROWS * world
    rows = torch.arange(n, dtype=torch.float32, device=device)[:, None].expand(n, 8)
    mine = shard_batch(mesh, {"x": rows})["x"]
    total = comm.all_reduce_sum(mesh, mesh.data_group, mine.sum().reshape(1))
    count = comm.all_reduce_sum(mesh, mesh.data_group,
                                torch.tensor([float(mine.numel())], device=device))
    got = float(total / count)
    want = (n - 1) / 2
    assert abs(got - want) < 1e-6, f"rank {rank}: {got} != {want}"
    print(f"multihost_smoke rank {rank}/{world} ({mesh.backend}, {device}): OK "
          f"(global rows={n}, mean={got})")
    return got


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0].isdigit():      # one rank of a group the caller starts
        from sunet_tf_tpu_torch.parallel.mesh import init_distributed

        pid, nproc = int(argv[0]), int(argv[1])
        port = int(argv[2]) if len(argv) > 2 else 12421
        import torch.distributed as dist

        dev = init_distributed(f"localhost:{port}", nproc, pid, backend="gloo", device="cpu")
        try:
            return [check(pid, dev)]
        finally:
            dist.destroy_process_group()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = p.parse_args(argv)
    from sunet_tf_tpu_torch.parallel.launch import run_ranks

    return run_ranks(check, args.nproc, backend=args.backend,
                     device="cpu" if args.backend == "gloo" else None, timeout_s=120)


if __name__ == "__main__":
    main()
