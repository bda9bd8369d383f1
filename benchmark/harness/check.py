"""The comparison that decides ``correct``: what the program's first training
steps produced against the plain reference's, from the same weights, pools
and generator seed.

Readings (``Readings``), taken the same way from either side:

- each step's losses, by the program's metric names (``loss_*``);
- each parameter's first gradient, as Adam holds it after one step
  (``exp_avg / (1 - beta1)``), by its norm;
- each parameter's change over the first three steps, by its norm;
- the batch the third step trained on.

Numbers, each held to its limit where the configuration's ``limits`` name
it; a run computes only those, ``calibrate.py`` all of them. A gap is
``|p - r| / max(|r|, median |r|)``, the median taken over the reference's
entries of that kind. "Kept" parameters leave out those whose reference
first gradient is under a thousandth of the median parameter's: a conv bias
ahead of BatchNorm has a gradient of zero up to rounding, and Adam moves it
by rounding alone.

- ``loss_step1``: the worst gap of the first step's losses;
- ``grad_worst``: the worst gap of the kept parameters' first-gradient norms;
- ``grad_median``: the median gap of all the parameters' first-gradient norms;
- ``change_median``: the median gap of the kept parameters' change norms;
- ``batch``: the largest absolute difference between the two batches;
- ``loss_3steps``: the worst gap of all the steps' losses;
- ``change_worst``: the worst gap of the kept parameters' changes.

The later steps follow the card's nondeterministic kernels (such as the
atomic sums of the bilinear upsample's backward) through Adam, whose first
steps move every element by about its learning rate whatever the size of its
gradient; the numbers a configuration does not hold are those that the
reference run twice on one card reads as far apart as the program does.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median parameter's first-gradient norm


@dataclasses.dataclass
class Readings:
    losses: list[dict[str, float]]       # a dict a step
    grad: dict[str, float]               # "net.param" -> norm of the first gradient
    change: dict[str, float]             # "net.param" -> norm of the change after the steps
    batch: dict[str, torch.Tensor]       # on the host


def first_grad_norms(nets: dict, opts: dict, beta1: float) -> dict[str, float]:
    """Each parameter's first gradient, read back from its Adam state after
    one step (0 where the step gave it none)."""
    out = {}
    for k, net in nets.items():
        for name, p in net.named_parameters():
            st = opts[k].state.get(p, {})
            g = st["exp_avg"].cpu() / (1.0 - beta1) if "exp_avg" in st else torch.zeros(0)
            out[f"{k}.{name}"] = float(torch.linalg.vector_norm(g.double()))
    return out


def change_norms(nets: dict, start: dict) -> dict[str, float]:
    """Each parameter's change from ``start`` (net -> name -> tensor), worked
    out on the host."""
    return {f"{k}.{name}": float(torch.linalg.vector_norm(
                p.detach().cpu().double() - start[k][name].cpu().double()))
            for k, net in nets.items() for name, p in net.named_parameters()}


def gaps(got: dict[str, float], want: dict[str, float], keys=None) -> dict[str, float]:
    """Each key's gap (module docstring); ``inf`` for a key one side lacks."""
    floor = max(statistics.median(abs(v) for v in want.values()), 1e-30)
    return {k: (abs(got[k] - want[k]) / max(abs(want[k]), floor) if k in got else math.inf)
            for k in (want if keys is None else keys)}


def _kept(want: Readings) -> list[str]:
    floor = statistics.median(want.grad.values()) * NEGLIGIBLE_GRAD
    return [k for k, v in want.grad.items() if v >= floor]


NUMBERS = {
    "loss_step1": lambda g, w: max(gaps(g.losses[0], w.losses[0]).values()),
    "grad_worst": lambda g, w: max(gaps(g.grad, w.grad, _kept(w)).values()),
    "grad_median": lambda g, w: statistics.median(gaps(g.grad, w.grad).values()),
    "change_median": lambda g, w: statistics.median(gaps(g.change, w.change, _kept(w)).values()),
    "batch": lambda g, w: max(float((g.batch[k].float() - w.batch[k].float()).abs().max())
                              for k in w.batch),
    "loss_3steps": lambda g, w: max(max(gaps(a, b).values()) for a, b in zip(g.losses, w.losses)),
    "change_worst": lambda g, w: max(gaps(g.change, w.change, _kept(w)).values()),
}


def numbers(got: Readings, want: Readings, keys=tuple(NUMBERS)) -> dict[str, float]:
    """The numbers ``keys`` of the program (``got``) against the reference."""
    if len(got.losses) != len(want.losses) or set(got.grad) != set(want.grad):
        return dict.fromkeys(keys, math.inf)
    return {k: NUMBERS[k](got, want) for k in keys}


def explain(got: Readings, want: Readings, n: int = 3) -> list[str]:
    """The ``n`` worst entries behind each kind of number, with both
    readings."""
    kept = _kept(want)
    per = {"grad": (got.grad, want.grad, kept), "change": (got.change, want.change, kept)}
    for step, (g, w) in enumerate(zip(got.losses, want.losses)):
        per[f"loss step {step + 1}"] = (g, w, None)
    lines = []
    for name, (g, w, keys) in per.items():
        worst = sorted(gaps(g, w, keys).items(), key=lambda kv: -kv[1])[:n]
        lines += [f"{name}: {k} gap {gap:.3g} program {g.get(k, math.nan):.6g} "
                  f"reference {w[k]:.6g}" for k, gap in worst]
    return lines


def reference_readings(cfg: dict, pools: dict, weights: dict, per_domain: int, gen_seed: int,
                       steps: int, precision: str, device, fault: str | None = None
                       ) -> Readings:
    """The plain reference's readings: its nets at ``precision`` built from
    ``weights``, trained ``steps`` steps on ``pools`` with a generator
    seeded ``gen_seed``, as the program's first steps were."""
    from reference.nets import Policy, build
    from reference.step import train_step

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        nets = build(cfg, Policy(precision), device)
        for k, net in nets.items():
            net.load_state_dict(weights[k])
        opt_cfg = cfg["adam"]
        opts = {k: torch.optim.Adam(net.parameters(), lr=opt_cfg["lr"],
                                    betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
                for k, net in nets.items()}
        gen = torch.Generator(device=device).manual_seed(gen_seed)
        losses, grad = [], {}
        for i in range(steps):
            batch, step_losses = train_step(nets, opts, pools, len(pools["sizes"]), per_domain,
                                            Policy(precision), gen, fault)
            losses.append({k: float(v) for k, v in step_losses.items()})
            if i == 0:
                grad = first_grad_norms(nets, opts, opt_cfg["betas"][0])
        change = change_norms(nets, weights)
        return Readings(losses, grad, change, {k: v.cpu() for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def verdict(nums: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number that has a limit within it (a NaN is not)."""
    return all(nums[k] <= limits[k] for k in limits)
