"""The per-layer metrics that read the program's span record
(``harness/spans.py``): each reader on a synthetic record returns what the
record holds, the stamped epoch is made once for all of them, and each
returns None where the program has no spans (a program that predates them,
the eager loop, or no card)."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from harness import spec

ROOT = Path(__file__).resolve().parents[2]
DEVICE = ("sample_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
          "optimizer_ms_per_step", "replay_gap_ms_per_step")
SETUP = ("setup_init_s", "setup_capture_s")
NAMES = ["step.start", "sample", "phase1.od_seg/forward", "phase1.od_seg/backward",
         "phase1.od_seg/optimizer", "roi", "phase2.od_shape/forward", "metrics"]
# ns from the previous mark: sample 1 ms, forward 2 + 1 ms, backward 3 ms,
# optimizer 0.5 ms, other (roi, metrics) 0.25 + 0.25 ms: 8 ms a step
SPANS = [1_000_000, 2_000_000, 3_000_000, 500_000, 250_000, 1_000_000, 250_000]
STARTS = [5_000_000_000, 5_008_100_000, 5_016_300_000]  # gaps of 0.1 and 0.2 ms


def reader(name):
    return spec.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", "metric")


class FakeTrainer:
    """What the readers use of the program's Trainer: a graph, the switch
    of its device spans, the epoch entry, and the tracer's record."""

    iter_per_epoch = 3

    def __init__(self):
        self._graph = object()
        self.calls = []
        span = SimpleNamespace
        self.tracer = SimpleNamespace(stamped=[], spans=[
            span(name="trainer.init", start=0, end=9_000_000_000, parent=None),
            span(name="init_ensemble", start=10, end=2_500_000_010, parent=0),
            span(name="stack_domains", start=2_500_000_020, end=2_600_000_000, parent=0),
            span(name="capture", start=3_000_000_000, end=4_250_000_000, parent=0),
            span(name="capture", start=20_000_000_000, end=29_000_000_000, parent=None)])

    def start_device_spans(self):
        self.calls.append("start")

    def _train_epoch(self, epoch):
        self.calls.append(("epoch", epoch))
        stamps = np.array([[s + sum(SPANS[:i]) for s in STARTS] for i in range(len(NAMES))],
                          np.int64)
        self.tracer.stamped.append(SimpleNamespace(names=list(NAMES), stamps=stamps))


def ctx_for(trainer, device="cuda"):
    return SimpleNamespace(trainer=trainer, device=SimpleNamespace(type=device), steps=156,
                           busy_s=0.024)


def test_each_reader_reads_the_synthetic_record():
    trainer = FakeTrainer()
    ctx = ctx_for(trainer)
    got = {name: reader(name).read(ctx) for name in DEVICE + SETUP}
    want = {"sample_ms_per_step": 1.0, "forward_ms_per_step": 3.0, "backward_ms_per_step": 3.0,
            "optimizer_ms_per_step": 0.5, "replay_gap_ms_per_step": 0.15,
            "setup_init_s": 2.5, "setup_capture_s": 1.25}
    assert got == pytest.approx(want, rel=1e-12)
    # one stamped epoch for every reader, after the window's epochs
    assert trainer.calls == ["start", ("epoch", 156 // 3 + 1)]


def test_the_kinds_sum_to_the_step_span():
    from harness.spans import KINDS, per_step_ms

    stamps = np.cumsum(np.random.RandomState(0).randint(1, 10_000, (len(NAMES), 4)), axis=0)
    kinds = per_step_ms(NAMES, stamps)
    assert np.allclose(sum(kinds[k] for k in KINDS), kinds["step"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["no device spans", "eager loop", "no card", "no tracer"])
def test_each_reader_returns_none_without_spans(case):
    trainer = FakeTrainer()
    if case == "no device spans":
        trainer = SimpleNamespace(_graph=object(), iter_per_epoch=3,
                                  tracer=SimpleNamespace(spans=[]))
    elif case == "eager loop":
        trainer._graph = None
    elif case == "no tracer":
        trainer = SimpleNamespace(_graph=object(), iter_per_epoch=3)
    ctx = ctx_for(trainer, "cpu" if case == "no card" else "cuda")
    got = {name: reader(name).read(ctx) for name in DEVICE}
    assert got == dict.fromkeys(DEVICE)
    if case in ("no device spans", "no tracer"):
        assert {name: reader(name).read(ctx) for name in SETUP} == dict.fromkeys(SETUP)
    if isinstance(trainer, FakeTrainer):
        assert trainer.calls == []


def test_a_stamped_epoch_with_an_unwritten_mark_raises():
    trainer = FakeTrainer()
    epoch = trainer._train_epoch

    def broken(n):
        epoch(n)
        trainer.tracer.stamped[-1].stamps[3, 1] = 0

    trainer._train_epoch = broken
    with pytest.raises(RuntimeError, match="unwritten or out of order"):
        reader("sample_ms_per_step").read(ctx_for(trainer))
