"""Process-group set-up (counterpart of ``wt_pse_tpu/parallel/distributed.py``).

The port runs data parallelism as PyTorch does: one process per card, each a
rank of one ``torch.distributed`` process group. ``torchrun`` (``python -m
torch.distributed.run``) starts the processes and sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
:func:`initialize_multihost` reads them, or takes the same facts as
arguments. :func:`run_local_ranks` starts ranks on this machine without
``torchrun``, each with its group up, for tests and smoke runs.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, local_rank: int | None = None,
                         backend: str | None = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group, from the arguments or from torchrun's
    environment. Returns False, and does nothing, when neither names one (a
    single-process run), True once the group is up.

    ``backend`` defaults to NCCL where CUDA is available and gloo elsewhere.
    With CUDA, the card ``local_rank`` (``LOCAL_RANK``) becomes this process's
    current device before anything is launched on it. Every collective of the
    group times out after ``timeout_s``."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if not {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"} <= set(env):
            return False
        init_method = "env://"
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        if not 0 <= local_rank < torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: this machine has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local_rank)
    # bound to its card, NCCL's group makes its communicator here rather than
    # at its first collective, which a CUDA graph capture could not hold
    device_id = torch.device("cuda", local_rank) if backend == "nccl" else None
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device_id)
    return True


def rank_and_world() -> tuple[int, int]:
    """This process's rank and the size of its process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_main(fn, rank: int, world_size: int, init_method: str, backend: str,
               local_rank: int, timeout_s: float, args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        initialize_multihost(init_method, world_size, rank, local_rank, backend, timeout_s)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(fn, world_size: int, init_method: str, args: tuple = (),
                    backend: str = "gloo", local_rank: int | None = 0,
                    timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (the spawn
    method), rank ``r`` in process ``r``, each with the process group of all
    of them up (``init_method``, e.g. ``file://<path>``; ``backend``; every
    rank's card ``local_rank``, where there is CUDA, or card ``r`` for rank
    ``r`` with ``local_rank=None``: NCCL takes one rank a card). Returns the results by
    rank. Raises with the rank's traceback if one fails, and kills every rank
    still running when ``timeout_s`` passes. ``fn`` and its arguments and
    results are pickled, so ``fn`` is a module-level function."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, backend,
                               r if local_rank is None else local_rank, timeout_s, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict[int, object] = {}
    try:
        while len(out) < world_size:  # drain the queue before joining its writers
            try:
                rank, ok, value = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"did not finish within {timeout_s:g} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [out[r] for r in range(world_size)]
