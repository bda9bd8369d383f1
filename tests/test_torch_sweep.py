"""The port's leave-one-out sweep launcher (``wt_pse_tpu_torch/parallel/sweep.py``,
``python -m wt_pse_tpu_torch.cli.sweep``): the 8 cases of ``tests/test_sweep.py``,
without JAX, the training of each job stubbed. The CPU takes the place of the
cards: jobs go round-robin onto ``torch.device('cpu', i)`` queues."""

import json
import os
import threading
import time

import pytest
import torch

from wt_pse_tpu_torch.cli import sweep as sweep_cli
from wt_pse_tpu_torch.parallel.sweep import SweepJob, leave_one_out_jobs, run_sweep

from torch_port import torch_single_thread  # noqa: F401

QUEUES = [torch.device("cpu", i) for i in range(8)]


def _result(dice_od=0.9, dice_oc=0.8):
    return {"DSC_OC": [dice_oc], "HD_OC": [10.0], "ASD_OC": [2.0],
            "DSC_OD": [dice_od], "HD_OD": [8.0], "ASD_OD": [1.0]}


def test_jobs_enumeration():
    jobs = leave_one_out_jobs()
    assert len(jobs) == 8  # 4 targets x {OD, OC}
    assert SweepJob(3, "OD") in jobs
    assert SweepJob(3, "OD").train_domains == [1, 2, 4]
    assert SweepJob(1, "OC").train_domains == [2, 3, 4]


def test_run_sweep_round_robin_assignment():
    seen = {}

    def job_fn(job, device):
        seen[job] = device
        return f"{job.target_domain}-{job.label}"

    results = run_sweep(job_fn, devices=QUEUES)
    assert len(results) == 8
    assert len(set(seen.values())) == 8
    assert results[SweepJob(1, "OD")] == "1-OD"
    if not torch.cuda.is_available():  # the default is every card: none here
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run_sweep(job_fn)


def test_sweep_cli_job_args(tmp_path):
    args, left = sweep_cli.build_parser().parse_known_args(
        ["--data-dir", "/d", "--targets", "3", "--labels", "OD", "OC", "--running_times", "1"])
    assert left == []
    job = SweepJob(3, "OC")
    ns = sweep_cli.job_args(args, job, str(tmp_path), torch.device("cuda", 2))
    assert ns.datasetTrain == [1, 2, 4]
    assert ns.datasetTest == [3]
    assert ns.label == "OC"
    assert ns.out.endswith("target3_OC")
    assert ns.gpu == 2  # the job's card
    # the original namespace is untouched (each job gets its own copy)
    assert args.label != "OC" or args.datasetTest != [3]
    assert args.gpu == 0
    # auto-DP must not leak into sweep jobs: each owns one card; only an
    # explicit --dp opts in
    assert ns.dp is False
    args_dp, _ = sweep_cli.build_parser().parse_known_args(
        ["--data-dir", "/d", "--targets", "3", "--labels", "OD", "--dp"])
    assert sweep_cli.job_args(args_dp, job, str(tmp_path)).dp is True


def test_sweep_cli_end_to_end_stubbed(tmp_path, monkeypatch):
    """Fan-out and aggregation, with each job's training stubbed out."""
    calls = []

    def fake_train_main(args=None, left_argv=None):
        calls.append((tuple(args.datasetTrain), tuple(args.datasetTest), args.label,
                      args.out, tuple(left_argv)))
        d = 0.9 if args.label == "OD" else 0.8
        return _result(d, d - 0.1)

    monkeypatch.setattr(sweep_cli.train_cli, "main", fake_train_main)
    out = str(tmp_path / "sweep")
    args, left = sweep_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--data-dir", "/d", "--out", out, "--compute_dtype=bfloat16"])
    results = sweep_cli.main(args, left)

    assert len(calls) == 8  # 4 targets x {OD, OC}
    trains = {c[0] for c in calls}
    assert (1, 2, 4) in trains and (2, 3, 4) in trains
    for tr, te, _label, _out, la in calls:
        assert te[0] not in tr and len(tr) == 3
        assert la == ("--compute_dtype=bfloat16",)  # hparam passthrough
    # the non-`=` form: argparse's configs positional takes the value; each
    # job's namespace keeps it so train.main's _repair_left_argv re-pairs it
    args2, left2 = sweep_cli.build_parser().parse_known_args(
        ["--data-dir", "/d", "--compute_dtype", "bfloat16"])
    ns = sweep_cli.job_args(args2, SweepJob(2, "OD"), out)
    assert ns.configs == ["bfloat16"] and left2 == ["--compute_dtype"]
    summary = json.load(open(os.path.join(out, "sweep_results.json")))
    assert len(summary) == 8
    assert summary["target1_OD"]["DSC_OD"] == [0.9]
    assert len(results) == 8


def test_run_sweep_concurrent():
    """concurrency > 1 runs device queues in threads: every job completes, a
    job's exception is kept, queues overlap, and two jobs of one queue never
    do."""
    lock = threading.Lock()
    active, active_per_dev = 0, {}
    max_active, max_per_dev = 0, 0

    def job_fn(job, device):
        nonlocal active, max_active, max_per_dev
        with lock:
            active += 1
            active_per_dev[device] = active_per_dev.get(device, 0) + 1
            max_active = max(max_active, active)
            max_per_dev = max(max_per_dev, active_per_dev[device])
        try:
            if job.target_domain == 2 and job.label == "OC":
                raise RuntimeError("boom")
            time.sleep(0.05)
            # a real op on the assigned device, from the worker thread
            return float(torch.ones(3, device=device.type).sum() * job.target_domain)
        finally:
            with lock:
                active -= 1
                active_per_dev[device] -= 1

    # 8 jobs round-robin onto 2 queues (4 each), 2 workers
    results = run_sweep(job_fn, devices=QUEUES[:2], concurrency=2)
    assert len(results) == 8
    assert isinstance(results[SweepJob(2, "OC")], RuntimeError)
    ok = {j: r for j, r in results.items() if not isinstance(r, Exception)}
    assert ok[SweepJob(3, "OD")] == 9.0
    assert max_active == 2, f"no cross-queue overlap observed: {max_active}"
    assert max_per_dev == 1, "two jobs overlapped on one queue"
    # concurrency is capped at len(devices); a huge value must not crash
    max_active = max_per_dev = 0
    assert len(run_sweep(job_fn, devices=QUEUES, concurrency=999)) == 8
    assert max_per_dev == 1


def test_run_sweep_concurrent_survives_system_exit():
    """A job's SystemExit (a CLI's, a BaseException) must not end its queue's
    thread: later jobs run and the failure is an Exception instance."""

    def job_fn(job, device):
        if job.target_domain == 1 and job.label == "OD":
            raise SystemExit("ambiguous hparam arguments")
        return f"{job.target_domain}-{job.label}"

    results = run_sweep(job_fn, devices=QUEUES[:2], concurrency=2)
    assert len(results) == 8  # the queue drained fully despite the exit
    failed = results[SweepJob(1, "OD")]
    assert isinstance(failed, Exception)  # not a bare SystemExit
    assert "ambiguous hparam arguments" in str(failed)
    # (1, OD) is job 0 on queue 0; (2, OD), job 2, is the next on that queue
    assert results[SweepJob(2, "OD")] == "2-OD"


def test_sweep_cli_failed_jobs_exit_nonzero(tmp_path, monkeypatch):
    """A sweep with failed jobs reports them, aggregates the survivors and
    raises SystemExit."""

    def fake_train_main(args=None, left_argv=None):
        if args.datasetTest == [2]:
            raise RuntimeError("synthetic job failure")
        return _result()

    monkeypatch.setattr(sweep_cli.train_cli, "main", fake_train_main)
    out = str(tmp_path / "sweep")
    args, left = sweep_cli.build_parser().parse_known_args(
        ["--device", "cpu", "--data-dir", "/d", "--out", out, "--parallel-jobs", "4"])
    with pytest.raises(SystemExit, match="2/8 sweep jobs failed"):
        sweep_cli.main(args, left)
    summary = json.load(open(os.path.join(out, "sweep_results.json")))
    assert len(summary) == 6
    assert "target2_OD" not in summary and "target2_OC" not in summary


def test_sweep_cli_rejects_resume_and_duplicates(tmp_path):
    parser = sweep_cli.build_parser()
    # --resume would restore one checkpoint into every split/label job
    args, left = parser.parse_known_args(["--resume", str(tmp_path / "ckpt"), "--out",
                                          str(tmp_path)])
    with pytest.raises(SystemExit, match="resume"):
        sweep_cli.main(args, left)
    # duplicate jobs would race on one output dir and collapse in the results
    args, left = parser.parse_known_args(["--targets", "1", "1", "--labels", "OD", "--out",
                                          str(tmp_path)])
    with pytest.raises(SystemExit, match="duplicate"):
        sweep_cli.main(args, left)
