"""The port's tracer (``wt_pse_tpu_torch/utils/trace.py``) on the CPU, through
:meth:`GraphedStep.body` at 32x32 with batch 3 = 3 domains x 1, whose marks
stamp ``time.perf_counter_ns()`` into the buffer the card's kernel writes:

- every step takes every mark, in order, in the column ``row`` points at;
- the device spans nest (step > phase > forward, backward, optimizer) and
  their kinds sum to the ``step`` span; host spans nest in their parents;
- without marks the body issues exactly the operations of a step without
  spans, and launches no stamp;
- ``spans.json`` is a Chrome trace with a host and a device track;
- ``epoch_seconds``, ``enqueue_seconds``, ``validation_seconds`` and
  ``capture_seconds`` read the span record as the clocks they replace;
- a host span is a ``record_function`` range while a profiler runs.

The marked capture on the card: ``tests/test_torch_cuda.py``.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wt_pse_tpu_torch.train.trainer import _draw_seed
from wt_pse_tpu_torch.utils.trace import KINDS, StampedSteps, Tracer, span_kind

from test_torch_graph_driver import SEED, _graphed, _trainer
from torch_port import torch_single_thread  # noqa: F401

PHASES = ("phase1.od_seg", "phase2.od_shape", "phase3.oc_seg", "phase4.oc_shape")
MARKS = (["step.start", "sample"]
         + [f"{PHASES[0]}/{w}" for w in ("forward", "backward", "optimizer")]
         + [f"{PHASES[1]}/{w}" for w in ("forward", "forward", "backward", "optimizer")]
         + ["roi"]
         + [f"{PHASES[2]}/{w}" for w in ("forward", "backward", "optimizer")]
         + [f"{PHASES[3]}/{w}" for w in ("forward", "forward", "backward", "optimizer")]
         + ["metrics"])


def _steps(gs, trainer, n, epoch=0):
    trainer._gen.manual_seed(_draw_seed(SEED, epoch, 0))
    gs.rewind()
    for _ in range(n):
        gs.body()


def _fake_graph(trainer, gs):
    """Let ``trainer`` drive ``gs`` as its graph on the CPU: a replay runs
    the body, and the host's step count moves once a step, as a replay's."""
    def replay():
        gs.body()
        trainer.state.step -= 1

    gs.graph = SimpleNamespace(replay=replay)
    trainer._graph = gs


def test_every_step_takes_every_mark_in_order_in_its_column(tmp_path):
    trainer = _trainer(tmp_path, "run")
    gs = _graphed(trainer, marks=True)
    _steps(gs, trainer, 3)
    assert gs.marks.names == MARKS and int(gs.row) == 3
    stamps = gs.read_marks(3).numpy()
    assert stamps.shape == (len(MARKS), 3) and (stamps > 0).all()
    assert (np.diff(stamps, axis=0) >= 0).all()  # in order within a step
    assert (stamps[0, 1:] >= stamps[-1, :-1]).all()  # and step after step
    # a step writes the column row points at, and no other
    before = gs.marks.buf.clone()
    gs.row.fill_(1)
    gs.body()
    changed = (gs.marks.buf != before).any(dim=0)
    assert changed.tolist() == [False, True, False] and int(gs.row) == 2
    # past the buffer's columns a mark stamps nothing
    gs.row.fill_(3)
    before = gs.marks.buf.clone()
    gs.marks.begin()
    gs.marks.mark("step.start")
    assert torch.equal(gs.marks.buf, before)
    # a step that takes other marks than the first raises, as does a new one once fixed
    with pytest.raises(RuntimeError, match="earlier steps"):
        gs.marks.begin()
        gs.marks.mark("sample")
    gs.marks.freeze()
    gs.marks.begin()
    for name in MARKS:
        gs.marks.mark(name)
    with pytest.raises(RuntimeError, match="fixed"):
        gs.marks.mark("one.more")


def test_spans_nest_and_their_kinds_sum_to_the_step(tmp_path):
    trainer = _trainer(tmp_path, "run")
    gs = _graphed(trainer, marks=True, tracer=trainer.tracer)
    _fake_graph(trainer, gs)
    trainer._train_epoch(0)
    rec = trainer.tracer.stamped[-1]
    assert rec.names == MARKS and rec.stamps.shape == (len(MARKS), 3) and rec.first_step == 0
    assert len(rec.clock) == 2 and all(w >= 0 for _, _, w in rec.clock)
    for j in range(3):
        spans = rec.step_spans(j)
        kinds = dict.fromkeys(KINDS, 0)
        for name, a, b in spans:
            kinds[span_kind(name)] += b - a
        assert sum(kinds.values()) == rec.stamps[-1, j] - rec.stamps[0, j]
        assert [span_kind(n) for n, _, _ in spans].count("forward") == 6
    assert {span_kind(n) for n in MARKS[1:]} == set(KINDS)

    events = [e for e in trainer.tracer.chrome_events() if e["ph"] == "X"]
    device = [e for e in events if e["tid"] == 1]
    steps = [e for e in device if e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    eps = 1.0  # us: a float64 keeps 0.25 us of today's Unix time in us
    for e in device:
        step = steps[e["args"]["step"]]
        assert step["ts"] - eps <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"] + eps
        if "/" in e["name"]:
            phase = next(p for p in device if p["name"] == e["name"].split("/")[0]
                         and p["args"]["step"] == e["args"]["step"])
            assert phase["ts"] - eps <= e["ts"]
            assert e["ts"] + e["dur"] <= phase["ts"] + phase["dur"] + eps
    # host spans: each inside its parent, with the epoch or the step as identifier
    spans = trainer.tracer.spans
    for s in spans:
        if s.parent is not None:
            assert spans[s.parent].start <= s.start <= s.end <= spans[s.parent].end
    epoch = next(i for i, s in enumerate(spans) if s.name == "epoch")
    children = [s.name for s in spans if s.parent == epoch]
    assert children == ["epoch.reseed", "epoch.steps", "epoch.copy"]
    steps_span = next(i for i, s in enumerate(spans) if s.name == "epoch.steps")
    assert [(s.name, s.step) for s in spans if s.parent == steps_span] == \
        [("replay", 0), ("replay", 1), ("replay", 2)]


def test_stamps_convert_to_the_host_clock_between_the_brackets():
    rec = StampedSteps(0, 0, ["step.start", "metrics"], np.array([[100], [300]], np.int64),
                       [(100, 1_700_000_000_000_000_000, 6), (1100, 1_700_000_000_000_002_000, 4)])
    assert rec.to_host(np.array([100, 600, 1100])).tolist() == \
        [1_700_000_000_000_000_000, 1_700_000_000_000_001_000, 1_700_000_000_000_002_000]
    one = StampedSteps(0, 0, ["step.start"], np.array([[5]], np.int64), [(5, 1_000, 2)])
    assert one.to_host([5, 7]).tolist() == [1_000, 1_002]


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _unmarked_body(gs):
    """A step on the graph's buffers with no span in it: sample, train,
    write the metric column, advance the row."""
    for k, v in gs._batch_fn(gs._data, gs.generator).items():
        gs.batch[k].copy_(v)
    metrics = gs._train_step(gs.state, gs.batch, generator=gs.generator, eps=gs.eps)
    values = torch.stack([metrics[k].reshape(()) for k in gs.names])
    gs.metrics.index_copy_(1, gs.row, values[:, None].to(gs.metrics.dtype))
    gs.row.add_(1)


@pytest.mark.parametrize("marks", [False, True])
def test_without_marks_the_body_issues_the_operations_it_did_before(tmp_path, marks):
    """Off, the body takes no mark and issues exactly the operations of a
    step with no span in it, in order; on the CPU a mark is a numpy write,
    so on it issues them too (on the card it adds the stamp kernels, outside
    the dispatcher)."""
    logs = []
    for body in ("unmarked", "body"):
        trainer = _trainer(tmp_path, f"{body}_{marks}")
        gs = _graphed(trainer, marks=marks)
        _steps(gs, trainer, 1)  # makes the metric buffer
        trainer._gen.manual_seed(_draw_seed(SEED, 0, 0))
        with OpLog() as log:
            _unmarked_body(gs) if body == "unmarked" else gs.body()
        logs.append(log.ops)
        assert gs.stamp_launches == 0  # the CPU launches no kernel
        assert (gs.marks is None) == (not marks)
    assert logs[0] == logs[1] and len(logs[0]) > 1000


def test_spans_json_is_a_chrome_trace_with_a_host_and_a_device_track(tmp_path):
    trainer = _trainer(tmp_path, "run", trace_dir=str(tmp_path / "trace"))
    assert trainer._graph is None
    with pytest.raises(RuntimeError, match="graph driver"):
        trainer.start_device_spans()
    _fake_graph(trainer, _graphed(trainer, marks=True, tracer=trainer.tracer))
    trainer.train()
    doc = json.loads((tmp_path / "trace" / "spans.json").read_text())
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ns" and "time.time_ns" in doc["otherData"]["host_clock"]
    assert [c["epoch"] for c in doc["otherData"]["clock"]] == [0, 0, 1, 1]
    for e in events:
        assert e["ph"] in ("X", "M") and isinstance(e["name"], str) and e["pid"] == 0
        if e["ph"] == "X":
            assert e["tid"] in (0, 1) and e["dur"] >= 0 and e["ts"] > 1.5e15  # us since 1970
    names = [(e["tid"], e["name"]) for e in events if e["ph"] == "X"]
    assert names.count((1, "step")) == 6 and names.count((0, "replay")) == 6
    assert names.count((0, "epoch")) == names.count((0, "epoch.copy")) == 2
    assert (0, "trainer.init") in names and (0, "init_ensemble") in names
    assert names.count((1, "phase2.od_shape/forward")) == 12


def test_the_clock_views_keep_their_meaning(tmp_path):
    trainer = _trainer(tmp_path, "run", max_epoch=4, interval_validate=1)
    trainer.train()
    tr = trainer.tracer
    assert len(trainer.epoch_seconds) == len(trainer.enqueue_seconds) == 4
    for epoch, steps in zip(tr.closed("epoch"), tr.closed("epoch.steps")):
        assert epoch.start <= steps.start and steps.end <= epoch.end
        assert trainer.epoch_seconds[epoch.epoch] == epoch.seconds > steps.seconds > 0
    # the eager loop: a host sample span a step, named by its global step
    assert [s.step for s in tr.closed("sample")] == list(range(12))
    assert [set(v) for v in trainer.validation_seconds] == [{"predict", "upsample", "score"}]
    validate = tr.closed("validate")[0]
    assert sum(trainer.validation_seconds[0].values()) <= validate.seconds
    assert validate.epoch == 3
    trainer._checkpoint(7)
    assert tr.closed("checkpoint")[-1].epoch == 7
    # set-up: the construction's span and its children
    init = tr.spans[0]
    assert init.name == "trainer.init" and init.parent is None
    assert [s.name for s in tr.spans if s.parent == 0] == ["init_ensemble", "stack_domains"]
    # a capture's span (on the card) is what capture_seconds reads
    gs = _graphed(trainer)
    assert gs.capture_seconds is None
    with gs.tracer.span("capture"):
        pass
    assert gs.capture_seconds == gs.tracer.closed("capture")[-1].seconds


def test_a_host_span_is_a_profiler_range_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer()
    with tracer.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("outer", epoch=2):
            with tracer.span("inner", step=5):
                torch.ones(3).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner", "outside")}
    assert set(ranges) == {"outer", "inner"}
    for s in tracer.spans[1:]:
        r = ranges[s.name]
        # the range opens before the span's clock read and closes after it
        assert r.start_ns() <= s.start and s.end <= r.start_ns() + r.duration_ns()
        assert s.start - r.start_ns() < 5_000_000  # one timeline: the profiler's clock
    with pytest.raises(RuntimeError, match="closed while"):
        a = tracer.begin("a")
        tracer.begin("b")
        tracer.end(a)
