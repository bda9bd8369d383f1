"""The readings the output check's limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 [--program] [--json PATH]

For each seed, at the cell's own sizes and on the card, it prints one JSON
line a reading, each with every number of ``harness/check.py``:

- ``program`` (with ``--program``): the program's first steps against the
  reference, as a run of ``run.py`` reads them, with the Trainer built once
  for all the seeds: each seed's pools are copied into it, its weights
  loaded and its Adam state zeroed, and the first steps run through the
  captured graph as in a run;
- ``again``: the reference against itself, run twice on the card;
- ``again_rounded``: the reference against a copy of itself whose every
  training-mode BatchNorm forward takes its mean and variance in float64 and
  rounds once to the output type (:func:`forward_f64`): as exact as cuDNN or
  more, but rounding otherwise, so that a few OD logits at the 0.75 threshold
  of the OC phases' ROI land on its other side;
- ``control``: the reference in the precision below the configuration's
  (``control_precision``: TF32 operands for float32, fp8 operands for
  bfloat16), put in the program's place;
- ``half_batch``: the reference with every loss taken over the first half of
  the batch, the mean over the rest;
- ``roi_full``, ``roi_threshold``, ``roi_post_update``, ``pos_weight_one``:
  the reference with a fault of the OC phases' ROI planted
  (``reference/step.py``): the whole image, the cut at 0.5, the OD logits
  after phase 1's update, ``pos_weight`` at 1;
- ``again_det`` (only when asked for with ``--kinds``): the reference against
  itself with ``torch.use_deterministic_algorithms`` on and the bilinear
  upsample as matmuls with its weights (``F.interpolate``'s backward sums
  atomically on a card and has no deterministic kernel); any other
  nondeterministic op it meets is named in a warning.

After each line, the entry behind the worst gap of each kind (``check.explain``).

A step that leaves its state unchanged reads 1 on ``change_median`` by the
check's measure and needs no run; on one card there is no exchange between
chips to leave out.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(Path(__file__).resolve().parent), str(ROOT)]


def inputs(cell, seed: int, device):
    from drivers.train import weight_shapes
    from harness.inputs import derive, make_pools, make_weights

    cfg = cell.config
    pools = make_pools(cell.traffic["pools"], cfg["image_size"], seed, device)
    weights = make_weights(weight_shapes(cfg), seed, device, cfg.get("init"))
    return pools, weights, derive(seed, "steps")


def follow(cell, pools, weights, gen_seed, device, precision=None, fault=None):
    from harness import check

    cfg, traffic = cell.config, cell.traffic
    return check.reference_readings(cfg, pools, weights,
                                    cfg["batch_size"] // len(traffic["pools"]), gen_seed,
                                    traffic["check_steps"], precision or cfg["precision"],
                                    device, fault)


KINDS = ("again", "again_rounded", "control", "half_batch", "roi_full", "roi_threshold",
         "roi_post_update", "pos_weight_one")


def forward_f64(x, weight, bias, running_mean, running_var, num_batches_tracked,
                momentum: float, eps: float, relu: bool = False):
    """Training-mode BatchNorm (+ ReLU) with the batch's mean and variance
    taken in float64 and y rounded once to ``x``'s type: (y, mean, invstd),
    the statistics in f32, with the running statistics and
    ``num_batches_tracked`` updated as ``nn.BatchNorm2d`` updates them. The
    signature of the program's ``ops/batchnorm_cuda.py::forward_library``."""
    import torch

    xd = x.double()
    var, mean = torch.var_mean(xd, (0, 2, 3), correction=0)
    invstd = torch.rsqrt(var + eps)
    col = (slice(None), None, None)
    y = ((xd - mean[col]) * (invstd * weight.double())[col] + bias.double()[col]).to(x.dtype)
    with torch.no_grad():
        n = x.numel() // x.shape[1]
        running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
        running_var.mul_(1 - momentum).add_(momentum * (var * n / max(n - 1, 1))
                                            .to(running_var.dtype))
        num_batches_tracked.add_(1)
    return torch.relu(y) if relu else y, mean.detach().float(), invstd.detach().float()


def rounded_reference(cell, pools, weights, gen_seed, device):
    """The reference with every training-mode ``nn.BatchNorm2d`` forward by
    :func:`forward_f64`."""
    from unittest import mock

    from torch import nn

    before = nn.BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return before(self, x)
        return forward_f64(x, self.weight, self.bias, self.running_mean, self.running_var,
                           self.num_batches_tracked, self.momentum, self.eps)[0]

    with mock.patch.object(nn.BatchNorm2d, "forward", forward):
        return follow(cell, pools, weights, gen_seed, device)


def upsample_by_matmul(x):
    """``reference.nets.upsample2x`` as matmuls with the bilinear weights
    (half-pixel centres, edges clamped), one axis at a time: a backward with
    a fixed order of sums."""
    import torch

    def axis(n):
        src = ((torch.arange(2 * n, dtype=torch.float64) + 0.5) / 2 - 0.5).clamp(min=0)
        lo = src.floor().long()
        hi = (lo + 1).clamp(max=n - 1)
        m = torch.zeros(2 * n, n, dtype=torch.float64)
        rows = torch.arange(2 * n)
        m.index_put_((rows, lo), 1 - (src - lo), accumulate=True)
        m.index_put_((rows, hi), src - lo, accumulate=True)
        return m.to(x.device, x.dtype)

    x = torch.einsum("oh,bchw->bcow", axis(x.shape[2]), x)
    return torch.einsum("pw,bchw->bchp", axis(x.shape[3]), x)


def deterministic_reference(cell, pools, weights, gen_seed, device):
    import torch

    from reference import nets

    before = nets.upsample2x
    nets.upsample2x = upsample_by_matmul
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return follow(cell, pools, weights, gen_seed, device)
    finally:
        torch.use_deterministic_algorithms(False)
        nets.upsample2x = before


def readings(cell, seed: int, device, kinds=KINDS) -> list[dict]:
    from harness import check

    pools, weights, gen_seed = inputs(cell, seed, device)
    want = follow(cell, pools, weights, gen_seed, device)
    out = []
    for kind in kinds:
        base = want
        if kind == "again_det":
            base = deterministic_reference(cell, pools, weights, gen_seed, device)
            got = deterministic_reference(cell, pools, weights, gen_seed, device)
        elif kind == "again":
            got = follow(cell, pools, weights, gen_seed, device)
        elif kind == "again_rounded":
            got = rounded_reference(cell, pools, weights, gen_seed, device)
        elif kind == "control":
            got = follow(cell, pools, weights, gen_seed, device, cell.config["control_precision"])
        else:
            got = follow(cell, pools, weights, gen_seed, device, fault=kind)
        out.append({"cell": cell.name, "seed": seed, "reading": kind, **check.numbers(got, base)})
        print(json.dumps(out[-1]), flush=True)
        for line in check.explain(got, base, 1):
            print("   ", line, flush=True)
    return out


def program_readings(cell, seeds, device) -> list[dict]:
    import torch

    from drivers.train import build_trainer, first_steps, host_domains
    from harness import check

    cfg = cell.config
    out_dir = tempfile.mkdtemp(prefix="wtbench-")
    try:
        pools, _, _ = inputs(cell, seeds[0], device)
        trainer = build_trainer(cfg, cell.traffic, host_domains(pools), seeds[0], device,
                                out_dir)
        out = []
        for seed in seeds:
            pools, weights, gen_seed = inputs(cell, seed, device)
            for k in ("images", "labels", "sizes"):
                trainer.data[k].copy_(pools[k])
            with torch.no_grad():
                for ns in trainer.state.net_states():
                    for st in ns.opt.state.values():
                        for v in st.values():
                            v.zero_()
            got = first_steps(trainer, weights, gen_seed, cell.traffic["check_steps"],
                              cfg["adam"]["betas"][0])
            want = follow(cell, pools, weights, gen_seed, device)
            out.append({"cell": cell.name, "seed": seed, "reading": "program",
                        **check.numbers(got, want)})
            print(json.dumps(out[-1]), flush=True)
            for line in check.explain(got, want, 1):
                print("   ", line, flush=True)
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="read the program's first steps instead of the reference's variants")
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=list(KINDS) + ["again_det"],
                    help="the reference's variants to read (without --program)")
    ap.add_argument("--json", help="also append the lines to this file")
    args = ap.parse_args(argv)
    if "again_det" in args.kinds:  # cuBLAS is deterministic only with a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    lines = (program_readings(cell, args.seeds, dev) if args.program else
             [line for seed in args.seeds for line in readings(cell, seed, dev, args.kinds)])
    for line in lines:
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
