"""The window's rate and the device's idle share are taken over all of the
window: a stall inside it lowers the rate and raises the idle share."""

import time
from pathlib import Path
from types import SimpleNamespace

from harness import spec
from harness.trace import Trace
from drivers.train import run_window

ROOT = Path(__file__).resolve().parents[2]


class FakeTrainer:
    """Epochs of ``steps`` steps that each take ``epoch_s`` on a fake clock,
    one of them ``stall_s`` longer."""

    def __init__(self, steps, epoch_s, stall_at=None, stall_s=0.0):
        self.iter_per_epoch, self.epoch_s = steps, epoch_s
        self.stall_at, self.stall_s = stall_at, stall_s
        self.now, self.epochs = 0.0, 0

    def clock(self):
        return self.now

    def _train_epoch(self, epoch):
        self.now += self.epoch_s + (self.stall_s if epoch == self.stall_at else 0.0)
        self.epochs += 1
        return {"loss_seg": 0.5}


def test_the_rate_counts_every_step_over_the_whole_window():
    t = FakeTrainer(52, 12.0)
    w = run_window(t, 30.0, t.clock)
    assert w.epochs == 3 and w.steps == 156 and w.window_s == 36.0 and w.failed == 0
    stalled = FakeTrainer(52, 12.0, stall_at=1, stall_s=3.0)
    s = run_window(stalled, 30.0, stalled.clock)
    assert s.steps == w.steps and s.window_s == 39.0
    assert s.steps / s.window_s < w.steps / w.window_s


def test_a_non_finite_epoch_counts_its_steps_as_failed():
    t = FakeTrainer(52, 12.0)
    t._train_epoch = lambda epoch, f=t._train_epoch: dict(f(epoch), loss_seg=float("nan"))
    assert run_window(t, 30.0, t.clock).failed == 156


def idle(trace, start, end):
    reader = spec.load_module(ROOT / "benchmark" / "metrics" / "device_idle_pct.train.py",
                              "metric")
    busy = trace.busy_us(start, end) / 1e6
    return reader.read(SimpleNamespace(device=SimpleNamespace(type="cuda"), busy_s=busy,
                                       traced_window_s=(end - start) / 1e6))


def test_the_idle_share_covers_the_whole_traced_window():
    kernels = [(i * 100.0, i * 100.0 + 99.0, "k") for i in range(100)]
    steady = Trace(kernels, [])
    assert abs(idle(steady, 0.0, 10_000.0) - 1.0) < 1e-9
    stalled = Trace(kernels[:50] + [(s + 5_000.0, e + 5_000.0, n) for s, e, n in kernels[50:]],
                    [(4_950.0, 10_000.0, "cudaStreamSynchronize")])
    assert abs(idle(stalled, 0.0, 15_000.0) - 34.0) < 1e-9
    assert stalled.gaps(0.0, 15_000.0, 1) == [("cudaStreamSynchronize", 0.005001)]
    overlapping = Trace([(0.0, 60.0, "a"), (40.0, 100.0, "b")], [])
    assert overlapping.busy_us(0.0, 100.0) == 100.0
    assert overlapping.busy_us(50.0, 80.0) == 30.0


def test_the_clock_default_is_the_host_clock():
    assert run_window.__defaults__ == (time.perf_counter,)


def test_the_step_utilisation_is_taken_over_the_busy_seconds():
    reader = spec.load_module(ROOT / "benchmark" / "metrics" / "train_mfu.py", "metric")
    cfg = {"flops_per_step": 2e12, "peak_flop_per_s": 1e14}
    ctx = SimpleNamespace(device=SimpleNamespace(type="cuda"), config=cfg, traced_steps=50,
                          busy_s=10.0, traced_window_s=12.0)
    assert abs(reader.read(ctx) - 10.0) < 1e-12
    assert reader.read(SimpleNamespace(**{**vars(ctx), "traced_window_s": 20.0})) == reader.read(ctx)
    assert reader.read(SimpleNamespace(**{**vars(ctx), "busy_s": 0.0})) is None
