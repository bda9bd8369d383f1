"""What the program's device spans cost, and how well its clocks agree with
the profiler's, at a cell's own sizes on one card.

    python3 benchmark/spans_check.py --workload <cell> --seed <n> [--pairs 3] [--epochs 2]

Two Trainers of the cell are built from one seed as a run builds its one
(``drivers/train.py``): one as the window runs it, one with its device spans
turned on (``Trainer.start_device_spans``). Then:

- cost: windows of ``--epochs`` epochs through ``Trainer._train_epoch``, in
  turns off, on, on, off, ... (``--pairs`` pairs), each read as ``run.py``
  reads ``train_img_per_s``, with each graph's pool;
- clock: one more epoch of the marked Trainer under ``torch.profiler``:
  each stamp kernel's start in the profile against its stamp on the host
  clock, and each host span against the profiler range of its name;
- the same epoch's ``step`` spans summed against its busy seconds in the
  profile.

Prints one JSON line a window, then one with the clock's readings and one
summary line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(__file__).resolve().parent), str(ROOT)]


def quartiles(xs) -> list[float]:
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3


def window(trainer, epoch: int, epochs: int, batch: int) -> float:
    """Images a second over ``epochs`` epochs back to back, to the end of
    the last epoch's copy."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(epochs):
        trainer._train_epoch(epoch + e)
    return epochs * trainer.iter_per_epoch * batch / (time.perf_counter() - t0)


def clock_residuals(trainer, epoch: int) -> dict:
    """One epoch of ``trainer`` (device spans on) under the profiler: the
    residuals, in us, of each stamp against its kernel's start and of each
    host span against its range, and the step spans against the busy time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from harness.trace import union_us

    first = len(trainer.tracer.spans)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._train_epoch(epoch)
    rec = trainer.tracer.stamped[-1]
    spans = [s for s in trainer.tracer.spans[first:] if s.end is not None]
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted(e.start_ns() for e in events if e.device_type() == DeviceType.CUDA
                     and "stamp_kernel" in e.name())
    # 5 bracket stamps at each end of the epoch, the marks of every step between
    marks = kernels[5:-5]
    converted = rec.to_host(rec.stamps.T.reshape(-1))
    if len(marks) != len(converted):  # the profiler dropped records: no pairing by order
        return {"stamps": len(converted), "stamp_kernels_in_profile": len(kernels) - 10}
    stamp_us = (converted - np.array(marks, np.int64)) / 1e3
    host = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            host.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    starts, ends, unmatched = [], [], 0
    for name in {s.name for s in spans}:
        ours = sorted((s.start, s.end) for s in spans if s.name == name)
        theirs = sorted(host.get(name, []))
        if len(ours) != len(theirs):
            unmatched += len(ours)
            continue
        for (a, b), (c, d) in zip(ours, theirs):
            starts.append((a - c) / 1e3)  # the range opens before the span's clock read
            ends.append((d - b) / 1e3)  # and closes after its last
    span_us = starts + ends
    epoch_span = next(s for s in spans if s.name == "epoch")
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", lambda: False)()]
    busy_s = union_us([(max(a, epoch_span.start) / 1e3, min(b, epoch_span.end) / 1e3)
                       for a, b in dev if b > epoch_span.start and a < epoch_span.end]) / 1e6
    step_s = float((rec.stamps[-1] - rec.stamps[0]).sum()) / 1e9
    (d0, h0, w0), (d1, h1, w1) = rec.clock[0], rec.clock[-1]
    return {"stamps": len(stamp_us), "stamp_minus_kernel_start_us": quartiles(list(stamp_us)),
            "stamp_abs_median_us": statistics.median(abs(x) for x in stamp_us),
            "stamp_minus_kernel_start_us_first_last_step": [
                float(np.median(stamp_us[:len(rec.names)])),
                float(np.median(stamp_us[-len(rec.names):]))],
            "host_spans": len(starts), "host_spans_unmatched": unmatched,
            "span_start_after_range_us": quartiles(starts),
            "span_end_before_range_us": quartiles(ends),
            "span_abs_median_us": statistics.median(abs(x) for x in span_us),
            "bracket_width_us": [w0 / 1e3, w1 / 1e3],
            "drift_ppm": ((h1 - d1) - (h0 - d0)) / (d1 - d0) * 1e6,
            "step_spans_s": step_s, "busy_s": busy_s, "step_over_busy": step_s / busy_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from drivers.train import build_trainer, host_domains
    from harness import spec
    from harness.inputs import make_pools

    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    cfg, traffic = cell.config, cell.traffic
    pools = make_pools(traffic["pools"], cfg["image_size"], args.seed, dev)
    domains = host_domains(pools)
    del pools
    with tempfile.TemporaryDirectory(prefix="wtbench-spans-") as out:
        off = build_trainer(cfg, traffic, domains, args.seed, dev, out + "/off")
        on = build_trainer(cfg, traffic, domains, args.seed, dev, out + "/on")
        on.start_device_spans()
        pools = {"off": off._graph.pool_bytes, "on": on._graph.pool_bytes}
        rates = {"off": [], "on": []}
        epoch = 0
        for turn in range(2 * args.pairs):
            which = ("off", "on", "on", "off")[turn % 4]
            trainer = off if which == "off" else on
            rate = window(trainer, epoch, args.epochs, cfg["batch_size"])
            epoch += args.epochs
            rates[which].append(rate)
            print(json.dumps({"window": turn, "spans": which, "train_img_per_s": rate}),
                  flush=True)
        clock = clock_residuals(on, epoch)
        print(json.dumps({"clock": clock}), flush=True)
        med = {k: statistics.median(v) for k, v in rates.items()}
        print(json.dumps({
            "workload": cell.name, "seed": args.seed, "card": torch.cuda.get_device_name(dev),
            "train_img_per_s": {k: quartiles(v) for k, v in rates.items()},
            "on_over_off": med["on"] / med["off"], "pool_bytes": pools,
            "stamp_launches_off": off._graph.stamp_launches,
            "marks": len(on._graph.marks.names)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
