"""One training step captured as a CUDA graph and replayed: the port's
counterpart of the JAX Trainer's one-program epoch (``scan_epochs=True``,
``wt_pse_tpu/train/trainer.py:295-317``, a ``lax.scan`` over the fused
sample + step).

A graph of a whole epoch would hold about 14,000 nodes a step for every step
of it; :class:`GraphedStep` captures one step, the sampler
(``data/augment.py::make_device_batch_fn``) followed by the 4-phase step
(``train/step.py::make_train_step``) exactly as the eager loop calls them, and
replays it once a step: one host launch where the eager step makes about
13,800.

What the graph holds, and how the rest of the port keeps it valid:

- static buffers: the batch (``batch``, sampled into each replay, or written
  by the caller when there is no sampler), the injected draws (``eps``), and
  one device tensor of per-step metrics, ``(n_metrics, capacity)``, whose
  column a device-side row counter picks, so a replay records its metrics
  with no host sync;
- the state's tensors: weights, BatchNorm statistics, the capturable Adams'
  state and tensor lr. They are updated in place from then on
  (``train/state.py``), never rebound;
- the run's generator, registered with the graph: each replay draws from its
  current seed and offset, as an eager step would, so re-seeding it between
  replays decides what they draw.

Host state that only the capture sees is kept by the replay instead: the
state's ``step`` count, and the hand-written kernels' launch counters (the
covariance's, ``ops/covariance_cuda.py``, BatchNorm's,
``ops/batchnorm_cuda.py``, and the upsample's, ``ops/upsample_cuda.py``),
from which the capture's launches are taken back and to which each replay
adds them (:attr:`GraphedStep.launches_per_step`).

Data parallelism (``parallel/dp.py::make_dp_fused``, the counterpart of
JAX's ``epoch`` over ``make_dp_fused``): the graph holds the step's NCCL
collectives (sync BatchNorm, the gradient and metric means, the
``pos_weight`` sums, the MMD gather), launched on the capture stream in the
forward and on autograd's thread in the backward. Every rank captures in
lockstep and replays as often: the warm-up's collectives are real ones, the
step's Python branches that decide which collectives run depend on the
configuration alone, and the Trainer's replay counts and rollbacks depend on
global or rank-meaned values. NCCL's communicator is made before the capture
(at ``init_process_group``, and in any case by the warm-up); the collectives
that run between replays (checkpoint barriers, the validation's) share it,
in the same order on every rank. Gloo's host-staged collectives cannot be
captured.

There is no fallback: a capture that fails, or a replay that raises, raises
to the caller. The capture runs with CUDA's sync debug mode set to error, so
a host sync in the step (``.item()``, ``nonzero``, a Python branch on a
value) fails the capture rather than being recorded wrongly.

Device spans (``utils/trace.py``): with ``marks=True``, or after
:meth:`GraphedStep.start_marks`, the body stamps the device clock at each of
about 17 marks a step (``step.start``, ``sample``, each phase's
``forward``, ``backward`` and ``optimizer``, ``roi`` and ``metrics``) into
the column :attr:`GraphedStep.row` points at, so every replayed step keeps
its stamps with no host sync. They are off by default: a step captured
without them holds the step's own kernels alone, with no stamp kernel in
it. The host spans of the capture (``capture``, with ``capture.warmup``
and ``capture.record``) and of each replay (``replay``, with its global
step) go to the step's :class:`~wt_pse_tpu_torch.utils.trace.Tracer`.

On the CPU there is no graph; :meth:`GraphedStep.body`, the callable the
graph records, runs eagerly on the same buffers, and its marks stamp
``time.perf_counter_ns()``.
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from typing import Callable

import torch

from wt_pse_tpu_torch.ops import batchnorm_cuda as bn
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.ops import upsample_cuda as up
from wt_pse_tpu_torch.ops.cuda_lib import add_launches, launch_counts
from wt_pse_tpu_torch.train.state import WTPSETrainState, init_adam_state
from wt_pse_tpu_torch.utils.trace import DeviceMarks, Tracer

WARMUP_STEPS = 3
# the hand-written kernels' wrappers, each counting its launches by element type
COUNTED = (cc.covariance_forward, cc.covariance_backward, bn.batch_norm_forward,
           bn.batch_norm_backward, up.upsample2x_forward, up.upsample2x_backward)


class GraphedStep:
    """The sample + step of a training state as one replayable CUDA graph.

    ``state``, ``train_step`` (``make_train_step``'s function) and
    ``generator`` are the run's own. ``batch`` is a batch of the run's
    shapes and dtypes, from which the static batch buffers are made.
    ``batch_fn(data, generator)`` samples each step's batch into them; with
    ``batch_fn=None`` the step trains on what the caller last wrote into
    :attr:`batch`. ``eps_keys`` names draws of ``train_step.EPS_KEYS`` that
    come from the static :attr:`eps` buffers (zeros until written) instead
    of the generator. ``capacity`` is the most steps one :meth:`replay` runs.
    ``tracer`` records the host spans (a tracer of its own by default);
    ``marks`` turns the device spans on (module docstring).
    """

    def __init__(self, state: WTPSETrainState, train_step: Callable, batch: dict, *,
                 capacity: int, batch_fn: Callable | None = None, data: dict | None = None,
                 generator: torch.Generator | None = None, eps_keys=(),
                 tracer: Tracer | None = None, marks: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.state = state
        self.capacity = capacity
        self._train_step = train_step
        self._batch_fn, self._data, self.generator = batch_fn, data, generator
        self.batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        image = self.batch["image"]
        self.device = image.device
        self.eps = {k: torch.zeros(image.shape[:1] + (1,) + image.shape[2:],
                                   dtype=image.dtype, device=self.device) for k in eps_keys}
        self.row = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.metrics: torch.Tensor | None = None  # made at the first step
        self.names: list[str] = []
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches_per_step: dict = {}
        self.pool_bytes: int | None = None  # the device memory the capture reserved
        self.tracer = tracer if tracer is not None else Tracer()
        # made here, before any capture: the stamps live outside the graph's pool
        self.marks = DeviceMarks(self.row, capacity) if marks else None

    @property
    def capture_seconds(self) -> float | None:
        """Host seconds of the latest capture, warm-up included (its
        ``capture`` span); None before the first."""
        spans = self.tracer.seconds("capture")
        return spans[-1] if spans else None

    @property
    def stamp_launches(self) -> int:
        """Stamp kernels the host launched for this step's marks: 0 without
        them (``utils/trace.py``)."""
        return self.marks.launches if self.marks is not None else 0

    def body(self, state: WTPSETrainState | None = None,
             generator: torch.Generator | None = None) -> None:
        """One step on the static buffers: sample into :attr:`batch` (with a
        sampler), train ``state`` (the run's by default) on it, and write its
        metrics into the column :attr:`row` points at, then advance
        :attr:`row`. This is what the graph records. With :attr:`marks`, it
        stamps the device clock at the step's marks; without, it launches
        nothing more than the step."""
        state = self.state if state is None else state
        gen = self.generator if generator is None else generator
        marks = self.marks
        if marks is not None:
            marks.begin()
            marks.mark("step.start")
        if self._batch_fn is not None:
            for k, v in self._batch_fn(self._data, gen).items():
                self.batch[k].copy_(v)
        if marks is None:
            metrics = self._train_step(state, self.batch, generator=gen, eps=self.eps)
        else:
            marks.mark("sample")
            metrics = self._train_step(state, self.batch, generator=gen, eps=self.eps,
                                       mark=marks.mark)
        if self.metrics is None:
            self.names = sorted(metrics)
            self.metrics = torch.zeros((len(self.names), self.capacity),
                                       dtype=metrics[self.names[0]].dtype, device=self.device)
        values = torch.stack([metrics[k].reshape(()) for k in self.names])
        self.metrics.index_copy_(1, self.row, values[:, None].to(self.metrics.dtype))
        if marks is not None:
            marks.mark("metrics")
        self.row.add_(1)

    def rewind(self) -> None:
        """Point the metric row back at column 0."""
        self.row.zero_()

    def read(self, n: int) -> dict[str, torch.Tensor]:
        """Each metric's (n,) stack of columns 0..n-1, as device tensors (one
        copy, no host sync)."""
        return dict(zip(self.names, self.metrics[:, :n].clone()))

    def read_marks(self, n: int) -> torch.Tensor:
        """The stamps of columns 0..n-1, ``(n_marks, n)`` int64 on the
        device (one copy, no host sync); the marks must be on."""
        return self.marks.buf[:, :n].clone()

    def start_marks(self) -> None:
        """Turn the device spans on. A step already captured is captured
        again with its marks, after the old graph is freed. Does nothing
        when they are on. Under data parallelism every rank must call it,
        in lockstep, as :meth:`capture`."""
        if self.marks is not None:
            return
        self.marks = DeviceMarks(self.row, self.capacity)
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            self.capture()

    def prepare(self, warmup: int = WARMUP_STEPS,
                stream: torch.cuda.Stream | None = None) -> None:
        """What a capture needs made before it starts, on CUDA or the CPU.

        Runs ``warmup`` steps of :meth:`body` on a ``copy.deepcopy`` of the
        state with a generator of its own (on ``stream``, the capture's side
        stream, when given): cuDNN's and cuBLAS's handles and plans, the
        covariance library's per-device caches and, under data parallelism,
        NCCL's communicator and buffers are made there, and Adam creates the
        state of the parameters a step gives a gradient, which is then
        created in the run's optimizers too (still zero). The run's
        weights, BatchNorm statistics, Adam state, step count and generator
        stay as they were.

        Under data parallelism every rank must call it, in lockstep: the
        copy shares the run's mesh (``DataMesh.__deepcopy__``), so its
        collectives are real ones, and every rank's warm-up issues the same
        sequence of them."""
        warm = copy.deepcopy(self.state)
        gen = torch.Generator(device=self.device).manual_seed(0)
        with (torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()), \
                warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            for _ in range(warmup):
                self.rewind()
                self.body(warm, gen)
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        for ns, ns_warm in zip(self.state.net_states(), warm.net_states()):
            init_adam_state(ns.opt, [p for p, q in zip(ns.net.parameters(),
                                                       ns_warm.net.parameters())
                                     if q in ns_warm.opt.state])
        del warm
        self.rewind()

    def capture(self, warmup: int = WARMUP_STEPS) -> None:
        """:meth:`prepare` on the capture's side stream, then capture
        :meth:`body` on the run's state. The capture runs nothing: the
        weights, BatchNorm statistics, Adam state and the run's generator
        stay as they were, and so do the step count and the launch counters,
        which only the host saw move. Under data parallelism every rank
        captures, in lockstep, the same sequence of collectives."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device; this step is on {self.device}")
        with self.tracer.span("capture"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with self.tracer.span("capture.warmup"):
                self.prepare(warmup, side)
            if self.marks is not None:
                self.marks.freeze()  # the buffer the graph stamps into, fixed from here
            with self.tracer.span("capture.record"):
                self._record(side)

    def _record(self, side: torch.cuda.Stream) -> None:
        """Capture :meth:`body` on ``side`` under the sync debug mode
        "error"; then wait for the card."""
        step, before = self.state.step, launch_counts(COUNTED)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            with torch.cuda.graph(graph, stream=side):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:  # the host state only the capture saw move, also when it fails
            after = launch_counts(COUNTED)
            self.launches_per_step = {k: after[k] - before[k] for k in after}
            add_launches(self.launches_per_step, -1, COUNTED)
            self.state.step = step
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        torch.cuda.synchronize(self.device)

    def replay(self, n: int) -> dict[str, torch.Tensor]:
        """Replay the captured step ``n`` times, its metrics in columns
        0..n-1; returns them as :meth:`read` does. Adds ``n`` to the state's
        step count and ``n`` steps' launches to the launch counters. Each
        ``graph.replay()`` call is a ``replay`` span with its global step (the
        state's step count)."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        if not 1 <= n <= self.capacity:
            raise ValueError(f"replay of {n} steps; this graph records 1..{self.capacity}")
        self.rewind()
        for i in range(n):
            with self.tracer.span("replay", step=self.state.step + i):
                self.graph.replay()
        self.state.step += n
        add_launches(self.launches_per_step, n, COUNTED)
        return self.read(n)
