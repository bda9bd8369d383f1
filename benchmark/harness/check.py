"""The comparison that decides ``correct``: what the program's first training
steps produced against the plain reference's, from the same weights, pools
and generator seed.

Readings (``Readings``), taken the same way from either side:

- each step's losses, by the program's metric names (``loss_*``);
- each parameter's first gradient, as Adam holds it after one step
  (``exp_avg / (1 - beta1)``), by its norm;
- each parameter's change over the first three steps, by its norm;
- the batch the third step trained on;
- each step's ``pos_weight`` of the OC segmentation loss: the ROI's pixels
  over its cup pixels (the program's ``pos_weight_oc`` metric).

The numbers come in two sides. The OD side holds the nets ``od`` and
``od_shape`` (phases 1-2) and the losses without the ``_oc`` suffix; the OC
side holds ``oc`` and ``oc_shape`` (phases 3-4) and the ``_oc`` losses. The
OC phases train on a ROI cut from phase 1's OD logits at 0.75, and the
configurations start those logits at that threshold, so an OD forward that
rounds otherwise, however exactly, moves a few ROI pixels and with them every
OC gradient. The two sides run the same classes through the same code: an
arithmetic or precision fault shows on the OD side, which the ROI cannot
reach and which is held as tightly as the arithmetic allows; the OC side
answers for the ROI, its ``pos_weight`` and the masked loss, by limits set
between the ROI's rounding and the ROI faults.

Numbers, each held to its limit where the configuration's ``limits`` name
it; a run computes only those, ``calibrate.py`` all of them. A gap is
``|p - r| / max(|r|, median |r|)``, the median taken over the reference's
entries of that kind on that side. "Kept" parameters leave out those whose
reference first gradient is under a thousandth of the median parameter's of
their side: a conv bias ahead of BatchNorm has a gradient of zero up to
rounding, and Adam moves it by rounding alone. On the OD side, with the
``_oc`` twin of each on the OC side:

- ``loss_step1``: the worst gap of the first step's losses but the
  distillation loss;
- ``loss_kd``: the gap of the first step's distillation loss, the mean square
  of the teacher's shape mean less the student's. The teacher is the
  segmenter after its first Adam step, which moves each element by the
  learning rate in the direction of its gradient's sign, so an element whose
  gradient lies within rounding of zero moves the other way under any other
  rounding: this loss carries the rounding further than the others and has a
  limit of its own;
- ``grad_worst``: the worst gap of the kept parameters' first-gradient norms;
- ``grad_median``: the median gap of all the parameters' first-gradient norms;
- ``change_median``: the median gap of the kept parameters' change norms;
- ``loss_3steps``: the worst gap of all the steps' losses but the
  distillation loss;
- ``change_worst``: the worst gap of the kept parameters' changes.

And once for the step:

- ``batch``: the largest absolute difference between the two batches;
- ``pos_weight_oc``: the relative gap ``|p - r| / |r|`` of the first step's
  ``pos_weight``. A ROI pixel that flips moves it by about 1e-5-1e-4; a ROI
  cut wrongly, by percents. The later steps' are left out: after one Adam
  step of the OD nets a forward that rounds otherwise has moved enough OD
  logits across the threshold to read as far off there as a wrong ROI does
  on some seeds.

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

from reference.nets import NETS

NEGLIGIBLE_GRAD = 1e-3  # of the median parameter's first-gradient norm


@dataclasses.dataclass
class Readings:
    losses: list[dict[str, float]]       # a dict a step
    grad: dict[str, float]               # "net.param" -> norm of the first gradient
    change: dict[str, float]             # "net.param" -> norm of the change after the steps
    batch: dict[str, torch.Tensor]       # on the host
    pos_weight: list[float]              # a step


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


SIDES = {"": NETS[:2], "_oc": NETS[2:]}  # suffix -> nets: the OD pair, then the OC pair


def side(r: Readings, suffix: str) -> Readings:
    """``r`` cut to one side: the parameters of its nets and its losses."""
    nets = SIDES[suffix]

    def params(d):
        return {k: v for k, v in d.items() if k.split(".", 1)[0] in nets}

    losses = [{k: v for k, v in step.items() if k.endswith("_oc") == (suffix == "_oc")}
              for step in r.losses]
    return Readings(losses, params(r.grad), params(r.change), r.batch, r.pos_weight)


def _kept(want: Readings) -> list[str]:
    floor = statistics.median(want.grad.values()) * NEGLIGIBLE_GRAD
    return [k for k, v in want.grad.items() if v >= floor]


def _is_kd(loss: str) -> bool:
    return loss.removesuffix("_oc") == "loss_kd"


def _loss_gaps(got: dict[str, float], want: dict[str, float]) -> float:
    """The worst gap of the losses but the distillation loss, over theirs."""
    rest = lambda d: {k: v for k, v in d.items() if not _is_kd(k)}  # noqa: E731
    return max(gaps(rest(got), rest(want)).values())


def _kd_gap(got: dict[str, float], want: dict[str, float]) -> float:
    """The relative gap of the distillation loss."""
    k = next(k for k in want if _is_kd(k))
    return abs(got.get(k, math.inf) - want[k]) / abs(want[k])


PER_SIDE = {
    "loss_step1": lambda g, w: _loss_gaps(g.losses[0], w.losses[0]),
    "loss_kd": lambda g, w: _kd_gap(g.losses[0], w.losses[0]),
    "grad_worst": lambda g, w: max(gaps(g.grad, w.grad, _kept(w)).values()),
    "grad_median": lambda g, w: statistics.median(gaps(g.grad, w.grad).values()),
    "change_median": lambda g, w: statistics.median(gaps(g.change, w.change, _kept(w)).values()),
    "loss_3steps": lambda g, w: max(_loss_gaps(a, b) for a, b in zip(g.losses, w.losses)),
    "change_worst": lambda g, w: max(gaps(g.change, w.change, _kept(w)).values()),
}

NUMBERS = {
    name + suffix: (lambda g, w, f=f, s=suffix: f(side(g, s), side(w, s)))
    for suffix in SIDES for name, f in PER_SIDE.items()
}
NUMBERS["batch"] = lambda g, w: max(float((g.batch[k].float() - w.batch[k].float()).abs().max())
                                    for k in w.batch)
NUMBERS["pos_weight_oc"] = lambda g, w: abs(g.pos_weight[0] - w.pos_weight[0]) / abs(w.pos_weight[0])


def numbers(got: Readings, want: Readings, keys=tuple(NUMBERS)) -> dict[str, float]:
    """The numbers ``keys`` of the program (``got``) against the reference."""
    if (len(got.losses) != len(want.losses) or set(got.grad) != set(want.grad)
            or len(got.pos_weight) != len(want.pos_weight)):
        return dict.fromkeys(keys, math.inf)
    return {k: NUMBERS[k](got, want) for k in keys}


def explain(got: Readings, want: Readings, n: int = 3) -> list[str]:
    """The ``n`` worst entries behind each kind of number, side by side, with
    both readings, then each step's ``pos_weight``."""
    lines = []
    for suffix in SIDES:
        g, w = side(got, suffix), side(want, suffix)
        kept = _kept(w)
        per = {f"grad{suffix}": (g.grad, w.grad, kept),
               f"change{suffix}": (g.change, w.change, kept)}
        for step, (a, b) in enumerate(zip(g.losses, w.losses)):
            per[f"loss{suffix} step {step + 1}"] = (a, b, None)
        for name, (a, b, keys) in per.items():
            worst = sorted(gaps(a, b, keys).items(), key=lambda kv: -kv[1])[:n]
            lines += [f"{name}: {k} gap {gap:.3g} program {a.get(k, math.nan):.6g} "
                      f"reference {b[k]:.6g}" for k, gap in worst]
    lines += [f"pos_weight_oc step {step + 1}: program {p:.8g} reference {r:.8g}"
              for step, (p, r) in enumerate(zip(got.pos_weight, want.pos_weight))]
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
        losses, pos_weight, grad = [], [], {}
        for i in range(steps):
            batch, step_losses, pos_w = train_step(nets, opts, pools, len(pools["sizes"]),
                                                   per_domain, Policy(precision), gen, fault)
            losses.append({k: float(v) for k, v in step_losses.items()})
            pos_weight.append(float(pos_w))
            if i == 0:
                grad = first_grad_norms(nets, opts, opt_cfg["betas"][0])
        change = change_norms(nets, weights)
        return Readings(losses, grad, change, {k: v.cpu() for k, v in batch.items()},
                        pos_weight)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def verdict(nums: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number that has a limit within it (a NaN is not)."""
    return all(nums[k] <= limits[k] for k in limits)
