"""Sweep parallelism: the 4 leave-one-domain-out splits x {OC, OD} (counterpart
of ``wt_pse_tpu/parallel/sweep.py``).

The reference runs these as 8 sequential invocations of ``train.py``. Each is
an independent training, so the launcher runs one job at a time on each
card: a round-robin over the cards, one queue of jobs a card, and no
collectives. The job function enters its card with ``with
torch.cuda.device(device):`` (JAX: ``jax.default_device``).
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SweepJob:
    target_domain: int
    label: str  # 'OD' | 'OC'

    @property
    def train_domains(self) -> list[int]:
        return [d for d in (1, 2, 3, 4) if d != self.target_domain]


def leave_one_out_jobs(labels=("OD", "OC")) -> list[SweepJob]:
    return [SweepJob(t, l) for t, l in itertools.product((1, 2, 3, 4), labels)]


def run_sweep(job_fn, jobs: list[SweepJob] | None = None, devices=None,
              concurrency: int = 1) -> dict:
    """Run ``job_fn(job, device)`` for each sweep job, the devices assigned
    round-robin (default: every visible card). Returns {job: result}.

    ``concurrency > 1`` runs up to that many device queues at once, one
    thread each (capped at ``len(devices)``): each device's jobs run one
    after another in its thread, so two trainings never share a card. The
    card work of distinct threads overlaps while their kernels run. A job
    that raises is recorded as the exception (later jobs keep running), and
    a ``SystemExit`` (the CLIs raise it) as a ``RuntimeError``; callers
    decide whether to re-raise. ``concurrency == 1`` runs the jobs in order
    and stops at the first failure."""
    jobs = jobs if jobs is not None else leave_one_out_jobs()
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("run_sweep found no CUDA card; pass devices= (e.g. "
                           "[torch.device('cpu')])")
    assignment = [(job, devices[i % len(devices)]) for i, job in enumerate(jobs)]

    concurrency = max(1, min(concurrency, len(devices)))
    if concurrency == 1:
        return {job: job_fn(job, dev) for job, dev in assignment}

    per_device: dict = {}
    for job, dev in assignment:
        per_device.setdefault(dev, []).append(job)
    results: dict = {}

    def drain(dev, dev_jobs):
        for job in dev_jobs:
            try:
                results[job] = job_fn(job, dev)
            except Exception as e:  # noqa: BLE001 - surfaced in the result dict
                results[job] = e
            except SystemExit as e:  # a BaseException: it would end the queue's thread
                results[job] = RuntimeError(f"job exited: {e}")

    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        futures = [pool.submit(drain, dev, dev_jobs) for dev, dev_jobs in per_device.items()]
    for f in futures:
        f.result()  # drain() keeps job errors; this surfaces the scheduler's own
    return {job: results[job] for job, _ in assignment}
