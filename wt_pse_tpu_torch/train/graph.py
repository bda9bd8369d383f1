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
state's ``step`` count, and the covariance kernels' launch counters
(``ops/covariance_cuda.py``), from which the capture's launches are taken
back and to which each replay adds them.

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

On the CPU there is no graph; :meth:`GraphedStep.body`, the callable the
graph records, runs eagerly on the same buffers.
"""

from __future__ import annotations

import contextlib
import copy
import time
import warnings
from typing import Callable

import torch

from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.train.state import WTPSETrainState, init_adam_state

WARMUP_STEPS = 3


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
    """

    def __init__(self, state: WTPSETrainState, train_step: Callable, batch: dict, *,
                 capacity: int, batch_fn: Callable | None = None, data: dict | None = None,
                 generator: torch.Generator | None = None, eps_keys=()):
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
        self.capture_seconds: float | None = None
        self.pool_bytes: int | None = None  # the device memory the capture reserved

    def body(self, state: WTPSETrainState | None = None,
             generator: torch.Generator | None = None) -> None:
        """One step on the static buffers: sample into :attr:`batch` (with a
        sampler), train ``state`` (the run's by default) on it, and write its
        metrics into the column :attr:`row` points at, then advance
        :attr:`row`. This is what the graph records."""
        state = self.state if state is None else state
        gen = self.generator if generator is None else generator
        if self._batch_fn is not None:
            for k, v in self._batch_fn(self._data, gen).items():
                self.batch[k].copy_(v)
        metrics = self._train_step(state, self.batch, generator=gen, eps=self.eps)
        if self.metrics is None:
            self.names = sorted(metrics)
            self.metrics = torch.zeros((len(self.names), self.capacity),
                                       dtype=metrics[self.names[0]].dtype, device=self.device)
        values = torch.stack([metrics[k].reshape(()) for k in self.names])
        self.metrics.index_copy_(1, self.row, values[:, None].to(self.metrics.dtype))
        self.row.add_(1)

    def rewind(self) -> None:
        """Point the metric row back at column 0."""
        self.row.zero_()

    def read(self, n: int) -> dict[str, torch.Tensor]:
        """Each metric's (n,) stack of columns 0..n-1, as device tensors (one
        copy, no host sync)."""
        return dict(zip(self.names, self.metrics[:, :n].clone()))

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
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        self.prepare(warmup, side)

        step, before = self.state.step, cc.launch_counts()
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
            after = cc.launch_counts()
            self.launches_per_step = {k: after[k] - before[k] for k in after}
            cc.add_launches(self.launches_per_step, -1)
            self.state.step = step
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0

    def replay(self, n: int) -> dict[str, torch.Tensor]:
        """Replay the captured step ``n`` times, its metrics in columns
        0..n-1; returns them as :meth:`read` does. Adds ``n`` to the state's
        step count and ``n`` steps' launches to the launch counters."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        if not 1 <= n <= self.capacity:
            raise ValueError(f"replay of {n} steps; this graph records 1..{self.capacity}")
        self.rewind()
        for _ in range(n):
            self.graph.replay()
        self.state.step += n
        cc.add_launches(self.launches_per_step, n)
        return self.read(n)
