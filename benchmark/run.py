"""Run one cell of the benchmark of ``wt_pse_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and, with
``--trace 1``, ``breakdown``; its last key, ``check``, holds each number the
output check compared with its limit, which the last lines of standard error
repeat. Without CUDA, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result and
exits with a non-zero code.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(__file__).resolve().parent), str(ROOT)]
# every kernel cache at a fixed place in the checkout: only a checkout's first
# run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "wtbench" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "wt_pse_tpu")  # top-level module names, whole


@dataclasses.dataclass
class Job:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    readers: dict


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float
             ) -> tuple[dict, list[str]]:
    """One run of ``cell`` on ``device``: the result line as a dict, and
    lines on what lies behind the check's numbers. The look for the cards is
    the caller's (:func:`main`)."""
    from harness import spec
    from harness.check import verdict

    job = Job(cell, seed, seconds, trace, device, t_start, spec.readers(cell) if trace else {})
    out = spec.driver(cell).run(job)
    limits = cell.config["limits"]
    nums = out["check"]
    wanted = cell.per_layer if trace else cell.end_to_end
    values = out["layer_metrics"] if trace else out["metrics"]
    result = {
        "correct": verdict(nums, limits),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted if m["name"] in values},
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": device_kind(device), "count": cell.entry["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        result["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["check"] = {k: {"value": plain(nums[k]), "limit": limits[k]} for k in limits}
    return result, out["explain"]


def plain(x: float):
    """``x`` as strict JSON takes it: a non-finite number as its name."""
    return x if x == x and abs(x) != float("inf") else str(x)


def device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    try:
        cell = spec.load_cell(ROOT, args.workload)
    except KeyError:
        print(f"no cell named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {cell.name} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    result, explain = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
        return 1
    for line in explain:
        print(f"check detail: {line}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
