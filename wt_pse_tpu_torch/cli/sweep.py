"""Leave-one-domain-out sweep CLI of the port (counterpart of
``wt_pse_tpu/cli/sweep.py``).

The reference runs the 4 leave-one-out splits x {OD, OC} as 8 separate
``python train.py`` invocations (one ``--datasetTest`` / ``--label`` pair a
run). This entry point launches the whole sweep from one command, the jobs
assigned to the cards round-robin (``parallel/sweep.py``):

    python -m wt_pse_tpu_torch.cli.sweep --data-dir /path/to/Fundus \\
        [--targets 1 2 3 4] [--labels OD OC] [--parallel-jobs N] [any cli.train flag ...]

Every ``cli.train`` flag (and hparam leftover, e.g. ``--compute_dtype
bfloat16``) passes through to each job; ``--datasetTrain`` / ``--datasetTest``
/ ``--label`` and the card (``-g``) are set per job. Results land under
``<out>/target{t}_{label}/`` plus an aggregate ``sweep_results.json``, and a
summary table is printed. With ``--device cpu`` every job runs on the CPU,
``--parallel-jobs`` of them at once.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import date

import numpy as np
import torch

from wt_pse_tpu_torch.cli import train as train_cli
from wt_pse_tpu_torch.parallel.sweep import SweepJob, run_sweep
from wt_pse_tpu_torch.runtime import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = train_cli.build_parser()
    p.add_argument("--targets", nargs="+", type=int, default=[1, 2, 3, 4],
                   help="target (held-out) domain ids to sweep")
    p.add_argument("--labels", nargs="+", type=str, default=["OD", "OC"],
                   choices=["OD", "OC"], help="structure labels to sweep")
    p.add_argument("--parallel-jobs", type=int, default=1,
                   help="run this many sweep jobs at once (threads, capped at the "
                        "card count): jobs are independent, so jobs on distinct "
                        "cards overlap")
    return p


def job_args(args: argparse.Namespace, job: SweepJob, out_root: str,
             device: torch.device | None = None) -> argparse.Namespace:
    """The job's namespace: the sweep flags become the train CLI's split
    flags, and ``device``'s index its ``-g``."""
    ns = argparse.Namespace(**vars(args))
    ns.datasetTrain = job.train_domains
    ns.datasetTest = [job.target_domain]
    ns.label = job.label
    ns.out = os.path.join(out_root, f"target{job.target_domain}_{job.label}")
    if device is not None and device.type == "cuda":
        ns.gpu = device.index
    if ns.dp is None:
        # the sweep is the decomposition over the cards: each job owns one.
        # Auto-DP would span every rank of a process group; only an explicit
        # --dp opts a job into it
        ns.dp = False
    return ns


def main(args=None, left_argv=None):
    parser = build_parser()
    if args is None:
        args, left_argv = parser.parse_known_args()
    if getattr(args, "resume", None):
        # vars(args) is copied into every job: one checkpoint would warm-start
        # every split and label (and its step count skip epochs of each job's
        # schedule)
        raise SystemExit(
            "--resume is not supported by the sweep launcher (it would restore ONE "
            "checkpoint into every split/label job); resume the affected job with "
            "python -m wt_pse_tpu_torch.cli.train --resume ... --datasetTest <t> "
            "--label <l>")

    out_root = args.out or os.path.join("runs", f"sweep_{date.today()}")
    jobs = [SweepJob(t, l) for t in args.targets for l in args.labels]
    if len(set(jobs)) != len(jobs):
        # duplicates would race on one output directory and collapse in the
        # results dict (keyed by the frozen SweepJob)
        dupes = list(dict.fromkeys(j for j in jobs if jobs.count(j) > 1))
        raise SystemExit(f"duplicate sweep jobs requested: {dupes} - pass each "
                         "target/label at most once")

    resolve_device(args.device)  # the card, or a clear error without one

    def job_fn(job: SweepJob, device: torch.device):
        print("=" * 20, f"sweep job: target {job.target_domain}, {job.label}, "
              f"device {device}", "=" * 20)
        ns = job_args(args, job, out_root, device)
        if device.type != "cuda":
            return train_cli.main(ns, left_argv)
        with torch.cuda.device(device):
            return train_cli.main(ns, left_argv)

    # on the CPU, --parallel-jobs queues share it (their index is a label only)
    devices = ([torch.device("cpu", i) for i in range(max(1, args.parallel_jobs))]
               if args.device == "cpu" else None)
    results = run_sweep(job_fn, jobs, devices=devices, concurrency=args.parallel_jobs)
    failed = {j: r for j, r in results.items() if isinstance(r, Exception)}
    for job, err in failed.items():
        print(f"FAILED: target {job.target_domain} {job.label}: {err!r}")
    results = {j: r for j, r in results.items() if not isinstance(r, Exception)}

    summary = {f"target{job.target_domain}_{job.label}":
               {m: [float(v) for v in vals] for m, vals in res.items()}
               for job, res in results.items()}
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "sweep_results.json"), "w") as f:
        json.dump(summary, f, indent=1)

    # per job, the mean over running_times of the label's Dice
    print("\n" + "=" * 20, "sweep summary", "=" * 20)
    for job, res in results.items():
        dice_key = "DSC_OD" if job.label == "OD" else "DSC_OC"
        vals = res[dice_key]
        print(f"target {job.target_domain} {job.label}: {dice_key}={np.mean(vals):.4f}"
              + (f"+-{np.std(vals, ddof=1):.4f}" if len(vals) > 1 else ""))
    if failed:
        # a caller gating on the exit code must not see a sweep with dropped
        # jobs as a success; the survivors' artifacts are on disk
        raise SystemExit(f"{len(failed)}/{len(failed) + len(results)} sweep jobs failed")
    return results


if __name__ == "__main__":
    main()
