"""Reading the program's span record (``Trainer.tracer``,
``wt_pse_tpu_torch/utils/trace.py``) for the per-layer metrics that read it.

The device spans come from one stamped epoch: the first reader to ask turns
the program's device spans on (``Trainer.start_device_spans``: the step is
captured again with its marks) and runs one more epoch through
``Trainer._train_epoch``, the window's entry, without the profiler; later
readers share it. Its record holds each mark's name and an int64 array of
stamps (marks x steps, ns on the card's clock). The span ending at a mark is
named after the mark; its kind is the mark's last path part (``forward``,
``backward``, ``optimizer``), ``sample``, or ``other`` (``roi``,
``metrics``). A program without device spans (one that predates them, or
the eager loop) gives nothing to read, and every reader returns None.
"""

from __future__ import annotations

import sys

import numpy as np

KINDS = ("sample", "forward", "backward", "optimizer", "other")


def kind(mark: str) -> str:
    if mark == "sample":
        return mark
    last = mark.rsplit("/", 1)[-1]
    return last if "/" in mark and last in KINDS else "other"


def stamped_epoch(ctx) -> tuple[list[str], np.ndarray] | None:
    """``(names, stamps)`` of the stamped epoch, made at the first call and
    kept on ``ctx``; None where the program has no device spans."""
    if "stamped" in vars(ctx):
        return ctx.stamped
    ctx.stamped = None
    trainer = ctx.trainer
    start = getattr(trainer, "start_device_spans", None)
    if ctx.device.type != "cuda" or start is None or getattr(trainer, "_graph", None) is None:
        return None
    start()
    trainer._train_epoch(ctx.steps // trainer.iter_per_epoch + 1)
    rec = trainer.tracer.stamped[-1]
    names, stamps = list(rec.names), np.asarray(rec.stamps, np.int64)
    if not (stamps > 0).all() or (np.diff(stamps, axis=0) < 0).any():
        raise RuntimeError("the stamped epoch has a mark unwritten or out of order")
    ctx.stamped = names, stamps
    kinds = per_step_ms(names, stamps)
    print(f"[wtbench] stamped epoch: {stamps.shape[1]} steps of {len(names)} marks; step "
          f"{kinds['step'].mean():.4f} ms mean, x {stamps.shape[1]} = "
          f"{kinds['step'].sum() / 1e3:.4f} s; busy {getattr(ctx, 'busy_s', float('nan')):.4f} s "
          f"in the profiled epoch; " + ", ".join(f"{k} {kinds[k].mean():.4f}" for k in KINDS) +
          f" ms; replay gap {replay_gaps_ms(stamps).mean():.4f} ms", file=sys.stderr, flush=True)
    return ctx.stamped


def per_step_ms(names: list[str], stamps: np.ndarray) -> dict[str, np.ndarray]:
    """Each kind's milliseconds in each step (its spans summed), and the
    ``step`` span's, from the first mark to the last: the kinds sum to it."""
    spans = np.diff(stamps, axis=0) / 1e6  # the span that ends at mark i + 1
    out = {k: np.zeros(stamps.shape[1]) for k in KINDS}
    for name, row in zip(names[1:], spans):
        out[kind(name)] += row
    out["step"] = (stamps[-1] - stamps[0]) / 1e6
    return out


def replay_gaps_ms(stamps: np.ndarray) -> np.ndarray:
    """For each consecutive pair of steps, the first mark of the later less
    the last mark of the earlier: the card's time between replays."""
    return (stamps[0, 1:] - stamps[-1, :-1]) / 1e6


def mean_ms(ctx, what: str) -> float | None:
    """The stamped epoch's mean per step of a kind's milliseconds."""
    got = stamped_epoch(ctx)
    return None if got is None else float(per_step_ms(*got)[what].mean())


def setup_span_s(ctx, name: str) -> float | None:
    """Seconds of the construction's child span ``name`` (the first
    ``trainer.init`` span's); None where the program has no such span."""
    tracer = getattr(ctx.trainer, "tracer", None)
    spans = getattr(tracer, "spans", None) or []
    init = next((i for i, s in enumerate(spans) if s.name == "trainer.init"), None)
    if init is None:
        return None
    child = next((s for s in spans if s.parent == init and s.name == name), None)
    return None if child is None or child.end is None else (child.end - child.start) / 1e9
