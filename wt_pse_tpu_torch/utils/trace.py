"""The port's one tracer: host spans and device marks, kept in memory and
written out only when asked (:func:`write_chrome`). The counts a run needs
are counts of spans: the replays of an epoch are its ``replay`` spans.

Host spans (:meth:`Tracer.span`) are always on: a pair of clock reads and one
append each. Every span has a name, a start and an end in ns, the span that
was open when it began (its parent), and a shared identifier: the global
step for a step's span, the epoch for an epoch's. Their clock is
:data:`host_clock`, ``time.time_ns``: torch.profiler stamps its host events
in Unix time (Kineto converts its approximate clock to ``CLOCK_REALTIME``),
so a span and the profiler's range of the same name sit on one timeline.
Only while a profiler is active is a span also emitted as a profiler range
under its own name (the check costs one bool), by the C++ context that
``record_function`` wraps without its dispatcher ops, so the range brackets
the span's clock reads by microseconds.

Device marks (:class:`DeviceMarks`) stamp the card's clock into a buffer on
the card from inside the captured step (``train/graph.py``), so that a CUDA
graph's replays keep the time of every mark of every step with no host sync.
On CUDA a mark launches ``csrc/stamp.cu``'s one-thread kernel, which writes
``%globaltimer`` (ns) into an int64 buffer of shape ``(n_marks, capacity)``
at the column the step's device-side row counter points at. Slots are taken
in call order, the same at every step; a ``multi-turn`` shape phase records
its marks again, and readers sum spans by name. On the CPU a mark writes
``time.perf_counter_ns()`` into the same buffer. The span that ends at a
mark is named after the mark: what just finished. :class:`StampedSteps`
holds one epoch's marks with the brackets that convert them to the host
clock: a stamp bracketed by two host-clock reads around a synchronize, at
the epoch's start and end, and linear between them.

The library is built at first use, as the kernels' libraries are
(``ops/cuda_lib.py::build``): nvcc into ``build/kernels/``, named by the hash
of the source, loaded with ctypes. Nothing is built or loaded at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import profiler as _profiler

STAMP_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stamp.cu"
KINDS = ("sample", "forward", "backward", "optimizer", "other")

host_clock = time.time_ns


@dataclasses.dataclass
class Span:
    """A host span: ``start`` and ``end`` in ns on :data:`host_clock`
    (``end`` is None while it is open); ``parent`` the index in
    :attr:`Tracer.spans` of the span that was open when it began."""
    name: str
    start: int
    end: int | None
    parent: int | None
    step: int | None = None
    epoch: int | None = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclasses.dataclass
class StampedSteps:
    """The device marks of consecutive steps: ``stamps[i, j]`` is mark
    ``names[i]`` of global step ``first_step + j`` on the device clock (ns).
    ``clock`` holds ``(device_ns, host_ns, width_ns)`` brackets: a device
    stamp, the midpoint of the host-clock reads around it and their distance."""
    epoch: int
    first_step: int
    names: list[str]
    stamps: np.ndarray
    clock: list[tuple[int, int, int]]

    def to_host(self, device_ns):
        """Device-clock ns on the host clock: shifted by the brackets'
        offset, linear between the first bracket and the last."""
        (d0, h0, _), (d1, h1, _) = self.clock[0], self.clock[-1]
        rate = (h1 - h0) / (d1 - d0) if d1 != d0 else 1.0
        # int64 throughout: ns since 1970 need 61 bits, a float64 keeps 53
        return h0 + np.rint((np.asarray(device_ns, np.int64) - d0) * rate).astype(np.int64)

    def step_spans(self, j: int) -> list[tuple[str, int, int]]:
        """Step ``first_step + j``'s spans on the device clock: each mark's
        name with the previous mark's stamp and its own."""
        col = self.stamps[:, j]
        return [(self.names[i], int(col[i - 1]), int(col[i])) for i in range(1, len(col))]


def span_kind(name: str) -> str:
    """The kind of a device span, by the mark that ends it: ``sample``,
    ``forward``, ``backward``, ``optimizer`` or ``other`` (``roi``,
    ``metrics``)."""
    if name == "sample":
        return name
    last = name.rsplit("/", 1)[-1]
    return last if last in KINDS and "/" in name else "other"


class Tracer:
    """The host spans and the device-marked epochs of one process."""

    def __init__(self):
        self.spans: list[Span] = []
        self.stamped: list[StampedSteps] = []
        self._open: list[tuple[int, object]] = []

    def begin(self, name: str, *, step: int | None = None, epoch: int | None = None) -> Span:
        """Open a span; :meth:`end` closes it. Spans close in the reverse
        order they opened."""
        rf = None
        if _profiler._is_profiler_enabled:
            rf = torch._C._profiler._RecordFunctionFast(name)
            rf.__enter__()
        parent = self._open[-1][0] if self._open else None
        span = Span(name, host_clock(), None, parent, step, epoch)
        self._open.append((len(self.spans), rf))
        self.spans.append(span)
        return span

    def end(self, span: Span) -> None:
        span.end = host_clock()
        index, rf = self._open.pop()
        if self.spans[index] is not span:
            raise RuntimeError(f"span {span.name!r} closed while "
                               f"{self.spans[index].name!r} was open inside it")
        if rf is not None:
            rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str, *, step: int | None = None, epoch: int | None = None):
        span = self.begin(name, step=step, epoch=epoch)
        try:
            yield span
        finally:
            self.end(span)

    def closed(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name and s.end is not None]

    def seconds(self, name: str) -> list[float]:
        """The length of each closed span named ``name``, in order."""
        return [s.seconds for s in self.closed(name)]

    def child_seconds(self, span: Span) -> dict[str, float]:
        """The seconds of ``span``'s closed children, summed by name."""
        index = next(i for i, s in enumerate(self.spans) if s is span)
        out: dict[str, float] = {}
        for s in self.spans[index + 1:]:
            if s.parent == index and s.end is not None:
                out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    def chrome_events(self, pid: int = 0) -> list[dict]:
        """The spans as Chrome trace events (``ph`` ``X``, ``ts`` and
        ``dur`` in us on the host clock): host spans on thread 0 of process
        ``pid``, device spans on thread 1, each step's ``step`` span holding
        its phases, which hold their ``forward``, ``backward`` and
        ``optimizer``."""
        events = [{"ph": "M", "name": "process_name", "pid": pid, "args": {"name": f"rank {pid}"}},
                  {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0, "args": {"name": "host"}},
                  {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
                   "args": {"name": "device"}}]

        def event(name, start, end, tid, **args):
            start, end = int(start), int(end)
            events.append({"ph": "X", "name": name, "pid": pid, "tid": tid, "ts": start / 1e3,
                           "dur": (end - start) / 1e3, "args": args})

        for i, s in enumerate(self.spans):
            if s.end is not None:
                ids = {k: v for k, v in (("step", s.step), ("epoch", s.epoch)) if v is not None}
                event(s.name, s.start, s.end, 0, span=i, parent=s.parent, **ids)
        for rec in self.stamped:
            for j in range(rec.stamps.shape[1]):
                step = rec.first_step + j
                spans = rec.step_spans(j)
                host = rec.to_host(np.array([[a, b] for _, a, b in spans]))
                event("step", host[0, 0], host[-1, 1], 1, step=step, epoch=rec.epoch)
                phases: dict[str, list[int]] = {}
                for (name, _, _), (a, b) in zip(spans, host):
                    event(name, a, b, 1, step=step, kind=span_kind(name))
                    if "/" in name:
                        ends = phases.setdefault(name.split("/")[0], [a, b])
                        ends[1] = b
                for name, (a, b) in phases.items():
                    event(name, a, b, 1, step=step)
        return events

    def clock_record(self) -> list[dict]:
        """Each stamped epoch's clock brackets, for the trace's metadata."""
        return [{"epoch": rec.epoch, "device_ns": d, "host_ns": h, "width_ns": w}
                for rec in self.stamped for d, h, w in rec.clock]


def write_chrome(path, events: list[dict], clocks: list[dict]) -> None:
    """Write ``events`` as a Chrome trace-event file (Perfetto and
    ``chrome://tracing`` open it), with the clocks in its metadata."""
    doc = {"traceEvents": events, "displayTimeUnit": "ns",
           "otherData": {"host_clock": "time.time_ns: Unix time, the clock of "
                                       "torch.profiler's host events",
                         "device_clock": "%globaltimer on CUDA, time.perf_counter_ns on "
                                         "the CPU, converted by the brackets in clock",
                         "clock": clocks}}
    with open(path, "w") as f:
        json.dump(doc, f)


@functools.cache
def _library() -> ctypes.CDLL:
    from wt_pse_tpu_torch.ops import cuda_lib

    path, _ = cuda_lib.build(STAMP_SOURCE, "stamp")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wtpse_stamp.argtypes, lib.wtpse_stamp.restype = [p, p, i, i, p], i
    return lib


class DeviceMarks:
    """Named marks of a step on the device clock, in an int64 buffer of
    shape ``(n_marks, capacity)`` at the column that ``row`` (a device
    int64 tensor of one element) points at when the mark runs.

    The buffer grows while marks are new (the warm-up ahead of a capture)
    and is then fixed: :meth:`freeze`, called ahead of a capture, makes a
    new mark raise, so a captured graph never stamps past it. Every step
    takes the same marks in the same order; :meth:`begin` starts a step.
    ``launches`` counts the stamp kernels the host launched (warm-up,
    capture and clock brackets; a replay launches none from the host)."""

    def __init__(self, row: torch.Tensor, capacity: int):
        self.row, self.capacity, self.device = row, capacity, row.device
        self.names: list[str] = []
        self.buf = torch.zeros((0, capacity), dtype=torch.int64, device=self.device)
        self.launches = 0
        self._slot = 0
        self._frozen = False
        # on the CPU a mark writes through numpy views, outside the dispatcher
        self._row_np = row.numpy() if self.device.type == "cpu" else None
        self._buf_np = self.buf.numpy() if self.device.type == "cpu" else None
        self._probe: tuple[torch.Tensor, torch.Tensor] | None = None

    def begin(self) -> None:
        self._slot = 0

    def freeze(self) -> None:
        self._frozen = True

    def mark(self, name: str) -> None:
        slot = self._slot
        self._slot += 1
        if slot == len(self.names):
            if self._frozen:
                raise RuntimeError(f"mark {name!r} (slot {slot}) is past the {len(self.names)} "
                                   "marks the buffer was fixed at")
            self.names.append(name)
            self.buf = torch.cat([self.buf, self.buf.new_zeros((1, self.capacity))])
            if self._buf_np is not None:
                self._buf_np = self.buf.numpy()
        elif self.names[slot] != name:
            raise RuntimeError(f"mark {slot} is {name!r}; earlier steps took "
                               f"{self.names[slot]!r} there")
        if self.device.type == "cuda":
            self._launch(self.buf, slot, self.row)
        else:
            col = int(self._row_np[0])
            if 0 <= col < self.capacity:
                self._buf_np[slot, col] = time.perf_counter_ns()

    def _launch(self, buf: torch.Tensor, slot: int, row: torch.Tensor) -> None:
        """The stamp kernel into ``buf[slot, row]``, on the current stream."""
        rc = _library().wtpse_stamp(buf.data_ptr(), row.data_ptr(), slot, buf.shape[1],
                                    torch._C._cuda_getCurrentRawStream(self.device.index))
        if rc != 0:
            raise RuntimeError(f"stamp kernel launch failed with CUDA error {rc}")
        self.launches += 1

    def clock_bracket(self, tries: int = 5) -> tuple[int, int, int]:
        """``(device_ns, host_ns, width_ns)``: a stamp taken between two
        host-clock reads around a synchronize, the narrowest of ``tries``;
        ``host_ns`` is the reads' midpoint."""
        best = None
        for _ in range(tries):
            if self.device.type == "cuda":
                if self._probe is None:
                    self._probe = (torch.zeros((1, 1), dtype=torch.int64, device=self.device),
                                   torch.zeros(1, dtype=torch.int64, device=self.device))
                out, zero = self._probe
                torch.cuda.synchronize(self.device)
                h0 = host_clock()
                self._launch(out, 0, zero)
                torch.cuda.synchronize(self.device)
                h1 = host_clock()
                stamp = int(out.cpu()[0, 0])
            else:
                h0 = host_clock()
                stamp = time.perf_counter_ns()
                h1 = host_clock()
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0, h1, stamp)
        h0, h1, stamp = best
        return stamp, (h0 + h1) // 2, h1 - h0
