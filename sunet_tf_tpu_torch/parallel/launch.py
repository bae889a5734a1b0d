"""Start a group of local ranks and collect their results.

``run_ranks(fn, world, ...)`` starts ``world`` processes with the ``spawn``
method (a forked child of a process that has used CUDA cannot use it),
each of which joins one group at ``tcp://localhost:<free port>``, runs
``fn(rank, device, *args)`` and sends back its result. The parent waits at
most ``timeout_s`` in all; a rank that raises, dies or outlasts the limit
fails the call, and every child still alive is killed. No rank's failure
is swallowed. ``fn`` must be importable by name (a module-level function).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str, device, args: tuple,
               queue, timeout_s: float):
    try:
        import torch.distributed as dist

        from sunet_tf_tpu_torch.parallel.mesh import init_distributed

        os.environ.setdefault("LOCAL_RANK", str(rank))
        dev = init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend=backend,
                               device=device, timeout_s=timeout_s)
        try:
            result = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, result))
    except BaseException:   # noqa: B036 - the parent reports every failure
        queue.put((rank, False, traceback.format_exc()))


class RankGroup:
    """Ranks started by :func:`start_ranks`; ``join`` waits for them."""

    def __init__(self, procs: list, queue, world: int, timeout_s: float):
        self.procs, self.queue, self.world = procs, queue, world
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s

    def join(self) -> list:
        """The ranks' results in rank order; raises if a rank raised, died
        or outlasted the limit, and kills every child still alive."""
        results: dict = {}
        try:
            while len(results) < self.world:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {self.world - len(results)} of {self.world} "
                                       f"ranks gave no result within {self.timeout_s:.0f} s")
                try:
                    rank, ok, value = self.queue.get(timeout=min(left, 1.0))
                except queue_mod.Empty:     # did a rank die without a word?
                    dead = [p for p in self.procs if p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(f"run_ranks: a rank process exited with code "
                                           f"{dead[0].exitcode} before sending its result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
            for p in self.procs:
                p.join(timeout=max(1.0, self.deadline - time.monotonic()))
            return [results[r] for r in range(self.world)]
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)


def start_ranks(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
                device=None, timeout_s: float = 120.0, env: Optional[dict] = None) -> RankGroup:
    """Start ``fn(rank, device, *args)`` for each rank of ``world``, each in its
    own spawned process in one ``backend`` group, and return without
    waiting; ``device``: every rank's device (e.g. "cuda:0" for ranks that
    share one card; default: see ``init_distributed``). ``env``: variables
    set in the children."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, port, backend, device, args, queue, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return RankGroup(procs, queue, world, timeout_s)


def run_ranks(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
              device=None, timeout_s: float = 120.0, env: Optional[dict] = None) -> list:
    """``[fn(rank, device, *args) for rank in range(world)]``, each rank in its
    own spawned process (:func:`start_ranks`), waited for."""
    return start_ranks(fn, world, args, backend, device, timeout_s, env).join()
