#!/usr/bin/env python3
"""Does a rank leave its NCCL process group after a graphed data-parallel run?

    python3 scripts/nccl_teardown.py [unrepaired] [repaired]

On every visible card (two or more), one NCCL rank a card runs
``tests/torch_dp_worker.py::dp_graph_rank``: a graphed ``Trainer(dp=True)``
to its checkpoint, a resume under the loop, and a resume under the DP graph
whose second epoch's loss is made non-finite and rolled back
(``nan_recovery``) before it trains to its last epoch. That last trainer is
kept alive by a reference cycle (its ``epoch_step`` is a closure over it),
and with it its CUDA graph, which holds NCCL collectives.

Each rank then leaves the process group as a rank of
``parallel/distributed.py`` leaves it: ``unrepaired`` calls
``dist.destroy_process_group()`` at once (the teardown before the repair),
``repaired`` through ``_teardown`` (the garbage collector first). The script
prints, for each variant, one JSON line: when each rank gave its result,
the live ``GraphedStep`` objects it held then, how long its destroy took,
and its exit code, or that it was still in the destroy ``GRACE_S`` after its
result (it is then killed).
"""

from __future__ import annotations

import gc
import json
import multiprocessing
import os
import queue
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

GRACE_S = 20.0


def rank_main(variant: str, rank: int, world: int, init: str, tmp: str, results) -> None:
    from torch_dp_worker import dp_graph_rank

    from wt_pse_tpu_torch.parallel.distributed import _teardown, initialize_multihost
    from wt_pse_tpu_torch.train.graph import GraphedStep

    torch.set_num_threads(1)
    initialize_multihost(init, world, rank, rank, "nccl", 180.0)
    t0 = time.monotonic()
    res = dp_graph_rank(rank, tmp)
    live = sum(isinstance(o, GraphedStep) for o in gc.get_objects())
    results.put(("result", rank, {"digest": res["digest"], "rollbacks":
                                  res["resumed_graph"]["rollbacks"], "live_graphed_steps": live,
                                  "run_s": round(time.monotonic() - t0, 2)}))
    t1 = time.monotonic()
    if variant == "repaired":
        _teardown()
    else:
        dist.destroy_process_group()
    results.put(("left", rank, round(time.monotonic() - t1, 3)))


def run(variant: str, world: int) -> dict:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main, args=(variant, r, world,
                                                     f"file://{tmp}/rendezvous",
                                                     os.path.join(tmp, "run"), results))
                 for r in range(world)]
        t0 = time.monotonic()
        for p in procs:
            p.start()
        rec = {"variant": variant, "ranks": world, "result_at_s": {}, "result": {},
               "destroy_s": {}}
        last = None
        while any(p.is_alive() for p in procs) or not results.empty():
            try:
                kind, rank, value = results.get(timeout=0.5)
            except queue.Empty:
                if last is not None and time.monotonic() - last > GRACE_S:
                    break
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if kind == "result":
                rec["result_at_s"][rank] = round(time.monotonic() - t0, 2)
                rec["result"][rank] = value
                if len(rec["result"]) == world:
                    last = time.monotonic()
            else:
                rec["destroy_s"][rank] = value
        rec["still_in_destroy"] = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        rec["exit_codes"] = [p.exitcode for p in procs]
    return rec


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(f"needs two or more cards (one NCCL rank a card); this machine shows {n}")
        return 2
    for variant in sys.argv[1:] or ["unrepaired", "repaired"]:
        print(json.dumps(run(variant, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
