"""Process-group set-up (counterpart of ``wt_pse_tpu/parallel/distributed.py``).

The port runs data parallelism as PyTorch does: one process per card, each a
rank of one ``torch.distributed`` process group. ``torchrun`` (``python -m
torch.distributed.run``) starts the processes and sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
:func:`initialize_multihost` reads them, or takes the same facts as
arguments. Without ``torchrun``, :func:`launch_ranks` starts one NCCL rank a
card on this machine, as the training CLI does to span every card it sees
(JAX's one process spans every chip it sees), and :func:`run_local_ranks`
starts ranks for tests and smoke runs; both watch their ranks and end the
whole run when one fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import gc
import multiprocessing
import os
import queue
import signal
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0  # NCCL's and gloo's collective timeout: a stuck collective raises
TEARDOWN_S = 30.0  # a rank that gave its result and is still up this long after fails the run
_POLL_S = 0.5      # how often the parent looks at its ranks' exit codes
_TORCHRUN_ENV = {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"}
_ENVIRON_LOCK = threading.Lock()  # launches from two threads edit one os.environ


def launched_by_torchrun() -> bool:
    """Whether torchrun's environment names a process group to join."""
    return _TORCHRUN_ENV <= set(os.environ)


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
        if not launched_by_torchrun():
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


def _die_with_parent() -> None:
    """Have Linux kill this process when the one that started it ends, so that
    no rank outlives a launcher that was killed."""
    prctl = getattr(ctypes.CDLL(None, use_errno=True), "prctl", None)
    if prctl is None:  # not Linux
        return
    prctl.argtypes, prctl.restype = [ctypes.c_int, ctypes.c_ulong], ctypes.c_int
    if prctl(1, signal.SIGKILL) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")


def _teardown() -> None:
    """Leave the process group. NCCL's destroy waits until every CUDA graph
    that holds its collectives is gone, and a graph that a reference cycle
    keeps (a ``Trainer`` whose method was replaced by a closure over it) lives
    until the collector runs: collect first."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()


def _rank_main(fn, rank: int, world_size: int, init_method: str, backend: str,
               local_rank: int, timeout_s: float, args: tuple, results) -> None:
    _die_with_parent()
    torch.set_num_threads(1)
    try:
        initialize_multihost(init_method, world_size, rank, local_rank, backend, timeout_s)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        _teardown()


@contextlib.contextmanager
def _environ(**values: str):
    """``os.environ`` with ``values`` set, for the processes started inside."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_ranks(fn, world_size: int, init_method: str, args: tuple, backend: str,
               local_ranks: list[int], timeout_s: float, deadline_s: float | None) -> list:
    """Start the ranks and watch them until each has given its result and
    exited 0; the results by rank. Raises, and kills every rank still up,
    as soon as one rank fails: it raises (its traceback), exits without a
    result or with a code other than 0 (its code), or is still up
    :data:`TEARDOWN_S` after its result; or when ``deadline_s`` passes."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, backend, local_ranks[r],
                               timeout_s, args, results))
             for r in range(world_size)]
    deadline = None if deadline_s is None else time.monotonic() + deadline_s
    out: dict[int, object] = {}
    given: dict[int, float] = {}

    def take(timeout: float) -> bool:
        try:
            rank, ok, value = results.get(timeout=timeout)
        except queue.Empty:
            return False
        if not ok:  # a peer that died first is the likelier cause: name it too
            dead = [f"rank {r} had exited with code {p.exitcode}" for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r != rank and r not in out]
            raise RuntimeError(f"rank {rank} failed{' (' + ', '.join(dead) + ')' if dead else ''}"
                               f":\n{value}")
        out[rank], given[rank] = value, time.monotonic()
        return True

    try:
        # one OpenMP thread a rank, as torchrun sets it
        with _ENVIRON_LOCK, _environ(OMP_NUM_THREADS="1"):
            for p in procs:
                p.start()
        while not (len(out) == world_size and all(p.exitcode == 0 for p in procs)):
            if take(_POLL_S):
                continue
            now = time.monotonic()
            for r, p in enumerate(procs):
                code = p.exitcode
                if code is None:
                    if r in out and now - given[r] > TEARDOWN_S:
                        raise RuntimeError(f"rank {r} gave its result but did not exit within "
                                           f"{TEARDOWN_S:g} s")
                    continue
                while r not in out and take(1.0):  # a result still in the pipe
                    pass
                if r not in out:
                    raise RuntimeError(f"rank {r} exited with code {code} without a result")
                if code != 0:
                    raise RuntimeError(f"rank {r} exited with code {code} after its result")
            if deadline is not None and now > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did not "
                                   f"finish within {deadline_s:g} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    return [out[r] for r in range(world_size)]


def run_local_ranks(fn, world_size: int, init_method: str, args: tuple = (),
                    backend: str = "gloo", local_rank: int | None = 0,
                    timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (the spawn
    method), rank ``r`` in process ``r``, each with the process group of all
    of them up (``init_method``, e.g. ``file://<path>``; ``backend``; every
    rank's card ``local_rank``, where there is CUDA, or card ``r`` for rank
    ``r`` with ``local_rank=None``: NCCL takes one rank a card). Returns the
    results by rank. Raises with the rank's traceback or exit code as soon as
    one fails, and kills every rank still running then, or when
    ``timeout_s`` passes. ``fn`` and its arguments and results are pickled,
    so ``fn`` is a module-level function."""
    local_ranks = [r if local_rank is None else local_rank for r in range(world_size)]
    return _run_ranks(fn, world_size, init_method, args, backend, local_ranks, timeout_s,
                      timeout_s)


def launch_ranks(fn, world_size: int, args: tuple = (), backend: str = "nccl",
                 timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: float | None = None):
    """Run ``fn(rank, *args)`` on ``world_size`` ranks started here, one a
    card: rank ``r`` on card ``r`` of the visible ones (``CUDA_VISIBLE_DEVICES``
    chooses them, as it chooses JAX's devices), with one OpenMP thread, as
    torchrun starts them. Returns rank 0's result.

    The rendezvous is a file in a temporary directory, and the covariance
    kernels are built here, once, before any rank starts. A training run
    lasts hours, so by default nothing bounds the run's length; the ranks
    are watched instead: one that raises, exits without its result or does
    not exit after it ends the run: every rank still up is killed, within
    seconds, and this raises with that rank's traceback or exit code. A
    collective that never completes raises in its rank after ``timeout_s``.
    ``deadline_s`` bounds the whole run (tests). ``backend="gloo"`` runs the
    ranks on the CPU (tests)."""
    if backend == "nccl":
        if not 1 <= world_size <= torch.cuda.device_count():
            raise ValueError(f"{world_size} NCCL ranks, one a card, need {world_size} visible "
                             f"cards; this machine shows {torch.cuda.device_count()}")
        from wt_pse_tpu_torch.ops import covariance_cuda

        covariance_cuda.build()
    with tempfile.TemporaryDirectory(prefix="wtpse_rdzv_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        return _run_ranks(fn, world_size, init_method, args, backend,
                          list(range(world_size)), timeout_s, deadline_s)[0]
