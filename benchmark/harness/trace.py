"""Reduction of a ``torch.profiler`` trace to what the per-layer readers and
the result's ``breakdown`` need: the device's busy time, kernel time by
group, and the longest idle gaps with what the host was doing in them.

The raw events are read (``prof.profiler.kineto_results.events()``):
``prof.events()`` builds every host op's event tree first, which took tens
of seconds for one traced epoch. ``union_us`` and the kernel groups follow
``chip_smoke.py`` (``union_us``, ``KERNEL_GROUPS``), with Adam and the
elementwise and reduction kernels named too.
"""

from __future__ import annotations

import dataclasses
import math
import re

# device kernels by the layer they belong to (first match wins: cuDNN's
# BatchNorm kernels also carry "cudnn")
KERNEL_GROUPS = (("covariance", r"gram_\w+_kernel|dz_(\w+_)?kernel"),
                 ("batchnorm", r"batch_norm|bn_fw|bn_bw|welford"),
                 ("convolution", r"conv|cudnn|fft|implicit|xmma|wgrad|dgrad|winograd|"
                                 r"nchwToNhwc|nhwcToNchw|sm90_|sm80_|gemm"),
                 ("upsample", r"upsample"),
                 ("adam", r"adam|multi_tensor_apply"),
                 ("cast", r"direct_copy|copy_kernel"),
                 ("reduction", r"reduce_kernel"),
                 ("elementwise", r"elementwise"),
                 ("memcpy", r"memcpy|memset"),
                 ("nccl", r"nccl"))


def kernel_group(name: str) -> str:
    for group, pattern in KERNEL_GROUPS:
        if re.search(pattern, name, re.I):
            return group
    return "other"


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


@dataclasses.dataclass
class Trace:
    """Device intervals (us, the profiler's clock) with their names, and the
    host events (name, start, end)."""
    device: list[tuple[float, float, str]]
    host: list[tuple[float, float, str]]

    def busy_us(self, start: float = -math.inf, end: float = math.inf) -> float:
        return union_us([(max(s, start), min(e, end)) for s, e, _ in self.device
                         if e > start and s < end])

    def by_group_us(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, name in self.device:
            g = kernel_group(name)
            out[g] = out.get(g, 0.0) + (e - s)
        return out

    def gaps(self, start: float, end: float, n: int = 10) -> list[tuple[str, float]]:
        """The ``n`` longest stretches of ``[start, end]`` with no device
        work, each named by the innermost host event running at its middle
        ("host idle" where none is)."""
        spans = sorted((s, e) for s, e, _ in self.device if e > start and s < end)
        holes, at = [], start
        for s, e in spans:
            if s > at:
                holes.append((at, s))
            at = max(at, e)
        if end > at:
            holes.append((at, end))
        holes = sorted(holes, key=lambda h: h[0] - h[1])[:n]
        out = []
        for a, b in holes:
            mid = (a + b) / 2
            running = [(e - s, name) for s, e, name in self.host if s <= mid <= e]
            out.append((min(running)[1] if running else "host idle", (b - a) / 1e6))
        return out


def read_profile(prof) -> Trace:
    """The device and host events of a finished ``torch.profiler.profile``;
    the annotation ranges on the device timeline are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        span = (start, start + e.duration_ns() / 1e3, e.name())
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)():
                device.append(span)
        else:
            host.append(span)
    return Trace(device, host)
