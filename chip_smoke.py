#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wt_pse_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase falls back to the CPU:

1. build the hand-written kernels from ``wt_pse_tpu_torch/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, forward and
   backward, at shapes that reach every variant: the main-path shape
   (9, 16, 256, 256), ragged HW, other C, and a z whose storage starts 4 bytes
   past a 16-byte boundary; and check that two calls are bitwise equal;
3. hold one small step and a predict on the card against the same on the CPU
   (the port's plain path, which the CPU tests hold against the JAX package);
4. the main path: full-width training steps (256x256, batch 9 = 3 domains x 3,
   base width 16, f32, TF32 off) from seeded weights on a synthetic batch, with
   the launch counts set to 0 just before and read just after; two more steady
   steps traced with ``torch.profiler`` (device time by kernel, the card's busy
   share of the step: the breakdown in PERF.md; the hand-written kernels'
   device time a call); both kernels held against their plain versions on the
   main path's own DeepWT maps (the OD net's, since the OC ROI is empty at
   initialisation); then the two-stage predict;
5. time each kernel beside its bound, its plain version and one PyTorch call
   that computes the same function (a yardstick the port never calls), in
   turns in one loop, so that all three are timed on one card at one time:
   after a write that fills the L2 with dirty lines (the record), then after a
   read (a second reading); and the host time of a wrapper call.

The line before the last is a JSON ``kernels`` record; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
F32_REDUCE_RTOL = 2e-5     # tolerance class f32_reduce (tests/test_goldens.py:49)
CONV = (5e-4, 1e-5)        # tolerance class conv
STEPS = 4
MAIN_SHAPE = (9, 16, 256, 256)
# (shape, storage offset in floats): HW % 4 == 0 with an aligned base (the
# 16-byte variants, at C = 16 and at another C); ragged HW and an unaligned
# base (the 4-byte variants)
CHECK_CASES = ((MAIN_SHAPE, 0), ((9, 16, 64, 64), 0), ((2, 32, 16, 16), 0),
               ((9, 16, 250, 250), 0), ((3, 16, 47, 47), 0), ((2, 32, 33, 31), 0),
               ((1, 5, 1, 3), 0), (MAIN_SHAPE, 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def cov_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max error relative to sqrt(cov_cc * cov_dd))."""
    d = torch.sqrt(torch.diagonal(want, dim1=1, dim2=2).abs())
    scale = d[:, :, None] * d[:, None, :]
    err = (got - want).abs()
    return float(err.max()), float((err / scale).max())


def check_pair(cc, z: torch.Tensor, g: torch.Tensor, what: str) -> dict:
    """Both kernels against their plain versions on (z, g), and a second call of
    each bitwise equal to the first. Returns the max abs errors."""
    got_f, want_f = cc.covariance_forward(z), cc.covariance_forward_plain(z)
    got_b, want_b = cc.covariance_backward(z, g), cc.covariance_backward_plain(z, g)
    again_f, again_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    f_abs, f_rel = cov_error(got_f, want_f)
    b_abs = float((got_b - want_b).abs().max())
    b_rel = b_abs / float(want_b.abs().max())
    repeat = torch.equal(got_f, again_f) and torch.equal(got_b, again_b)
    log(f"kernel check {what}: gram max_abs {f_abs:.3e} scaled {f_rel:.3e}; "
        f"dz max_abs {b_abs:.3e} rel-to-max {b_rel:.3e}; tolerance {F32_REDUCE_RTOL} "
        f"(f32_reduce); second call bitwise equal: {repeat}")
    if not (f_rel <= F32_REDUCE_RTOL and b_rel <= F32_REDUCE_RTOL):
        raise SystemExit(f"kernel disagrees with its plain version at {what}")
    if not repeat:
        raise SystemExit(f"a second kernel call differs from the first at {what}")
    return {"gram": f_abs, "dz": b_abs}


def check_kernels(cc, dev) -> dict:
    """Phase 2. Returns the max abs errors at the main-path shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for shape, offset in CHECK_CASES:
        n = math.prod(shape)
        z = torch.randn(n + offset, device=dev, generator=gen)[offset:].view(shape)
        g = torch.randn(shape[0], shape[1], shape[1], device=dev, generator=gen)
        got = check_pair(cc, z, g, f"{shape} storage offset {offset}")
        if (shape, offset) == (MAIN_SHAPE, 0):
            errs = got
    return errs


def synthetic_batch(n_dom: int, per_dom: int, hw: int, seed: int) -> dict:
    """Domain-contiguous batch: images in [-1, 1] with a per-domain brightness
    shift, binary disk masks for OD and OC (NCHW, numpy)."""
    r = np.random.RandomState(seed)
    b = n_dom * per_dom
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    img = r.rand(b, 3, hw, hw).astype(np.float32) * 1.6 - 0.8
    od = np.zeros((b, 1, hw, hw), np.float32)
    oc = np.zeros((b, 1, hw, hw), np.float32)
    for i in range(b):
        cy, cx = r.uniform(0.35, 0.65, 2) * hw
        rad = r.uniform(0.15, 0.22) * hw
        dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
        od[i, 0] = dist2 < rad ** 2
        oc[i, 0] = dist2 < (0.5 * rad) ** 2
        img[i] += 0.2 * (i // per_dom) - 0.2 + 0.3 * od[i]
    return {"image": np.clip(img, -1, 1), "target_od": od, "target_oc": oc}


def check_against_cpu(dev) -> None:
    """Phase 3: a 32x32, batch-3 step and predict on the card against the CPU."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

    hp = default_hparams("WT_PSE")
    cfg = ModelConfig.from_hparams(hp)
    batch = synthetic_batch(3, 1, 32, seed=1)
    r = np.random.RandomState(2)
    eps = {k: torch.from_numpy(r.randn(3, 1, 32, 32).astype(np.float32)) for k in EPS_KEYS}
    out = {}
    for d in ("cpu", dev):
        state = init_ensemble(cfg, device=d, generator=torch.Generator().manual_seed(1))
        nets = (state.od.net, state.od_shape.net, state.oc.net, state.oc_shape.net)
        pred = make_predict_fn(*nets, device=d)(batch["image"])
        metrics = make_train_step(StepConfig(hp, 3, 1), device=d)(
            state, batch, eps={k: v.to(d) for k, v in eps.items()})
        out[str(d)] = (pred, metrics)
    (p_cpu, m_cpu), (p_gpu, m_gpu) = out["cpu"], out[str(dev)]
    rtol, atol = CONV
    worst = 0.0
    for a, b in zip(p_gpu, p_cpu):
        err = float((a.cpu() - b).abs().max())
        bound = atol + rtol * float(b.abs().max())
        worst = max(worst, err / bound)
    # loss_kd{,_oc} read the teacher after an Adam step; a gradient at f32 noise
    # flips its lr*sign(grad) update between devices, so they are only finite-checked
    for k, v in m_cpu.items():
        got = float(m_gpu[k])
        if not math.isfinite(got):
            raise SystemExit(f"non-finite {k} on the card")
        if k.startswith(("loss_kd", "train_dice")):
            continue
        worst = max(worst, abs(got - float(v)) / (atol + rtol * abs(float(v))))
    log(f"card vs CPU (32x32, batch 3): worst error / conv tolerance = {worst:.3f}")
    if worst > 1.0:
        raise SystemExit("the card disagrees with the CPU reference on a small input")


def profile_steps(step, state, batch, gen, step_ms: float, n: int = 2) -> None:
    """Device time by kernel over ``n`` steady traced steps, and the device's
    busy share of ``step_ms``, the untraced steady step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, calls = [], {}, {}
    for e in prof.events():  # device kernels and copies; not the annotation ranges
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            calls[e.name] = calls.get(e.name, 0) + 1
    if not spans:
        raise SystemExit("the profiler saw no device time")
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):  # union of the kernels' intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    total = sum(by_name.values())
    log(f"profile ({n} steps): traced wall {wall_us / n / 1e3:.2f} ms/step, device "
        f"busy {busy / n / 1e3:.2f} ms/step = {busy / n / 1e3 / step_ms:.1%} of the "
        f"untraced {step_ms:.2f} ms step, {busy / window:.1%} of the traced "
        f"first-to-last-kernel window; {len(spans) // n} device events/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        log(f"  {us / n / 1e3:8.3f} ms/step {us / total:6.1%}  {name[:110]}")
    # the hand-written kernels as the step calls them, the L2 left as the
    # step's other kernels leave it
    own = {re.sub(r"^void |\(anonymous namespace\)::|[(<].*$", "", k): (v, calls[k])
           for k, v in by_name.items() if re.search(r"gram_\w+_kernel|dz_kernel", k)}
    own_us = sum(v for v, _ in own.values())
    log(f"the hand-written kernels: {own_us / n / 1e3:.3f} ms/step, "
        f"{own_us / total:.2%} of device time; " +
        ", ".join(f"{k} {v / n / 1e3:.3f} ms/step ({v / k_n:.2f} us a call)"
                  for k, (v, k_n) in sorted(own.items())))


def main_path(cc, dev) -> dict:
    """Phase 4: full-width steps and the two-stage predict."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import StepConfig, make_train_step

    hp = default_hparams("WT_PSE")
    n_dom, per_dom, hw = 3, 3, 256
    cfg = ModelConfig.from_hparams(hp)
    state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(StepConfig(hp, n_dom, per_dom), device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(n_dom, per_dom, hw, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()

    cc.covariance_forward.launches = 0
    cc.covariance_backward.launches = 0
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"non-finite metrics at step {state.step}: {bad}")
    launches = {"gram": cc.covariance_forward.launches, "dz": cc.covariance_backward.launches}
    log(f"train steps ({STEPS}, 256x256, batch 9 = 3x3, f32): " +
        ", ".join(f"{t * 1e3:.2f} ms" for t in times) +
        f"; steady median {statistics.median(times[1:]) * 1e3:.2f} ms/step")
    log("last step metrics: " + json.dumps({k: float(v) for k, v in sorted(metrics.items())}))
    log(f"covariance launches over the {STEPS} steps: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if launches != {"gram": 8 * STEPS, "dz": 8 * STEPS}:
        raise SystemExit(f"expected 8 gram and 8 dz launches a step, got {launches}")
    profile_steps(step, state, batch, gen, statistics.median(times[1:]) * 1e3)

    # the maps in train mode, as the step makes them; the BatchNorm running
    # statistics that this forward updates are put back before the predict
    wt = state.od.net.wt_model
    saved = [b.clone() for b in wt.buffers()]
    with torch.no_grad():
        maps = wt(batch["image"])[:2]  # the DeepWT maps 0 and 1
        for b, s in zip(wt.buffers(), saved):
            b.copy_(s)
    g = torch.randn(9, 16, 16, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    for i, z in enumerate(maps):
        if tuple(z.shape) != MAIN_SHAPE:
            raise SystemExit(f"DeepWT map {i} has shape {tuple(z.shape)}, not {MAIN_SHAPE}")
        check_pair(cc, z.contiguous(), g, f"OD DeepWT map {i} after the steps")

    predict = make_predict_fn(state.od.net, state.od_shape.net, state.oc.net,
                              state.oc_shape.net, device=dev)
    ptimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        od, oc = predict(batch["image"])
        torch.cuda.synchronize()
        ptimes.append(time.perf_counter() - t0)
    for name, t in (("od", od), ("oc", oc)):
        if t.shape != (9, 1, hw, hw) or not torch.isfinite(t).all():
            raise SystemExit(f"predict {name}: shape {tuple(t.shape)}, finite "
                             f"{bool(torch.isfinite(t).all())}")
    log("two-stage predict (batch 9, 256x256): " +
        ", ".join(f"{t * 1e3:.2f} ms" for t in ptimes) +
        f"; od>0.75 share {float((torch.sigmoid(od) > 0.75).float().mean()):.4f}")
    return {k: v // STEPS for k, v in launches.items()}


def time_in_turns(fns, flush, iters: int = 30) -> list[float]:
    """Median ms of one call of each of ``fns``, with ``flush()`` (which evicts
    the L2) before every call, the functions taken in turns in one loop."""
    for fn in fns:
        for _ in range(3):
            fn()
    events = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)] for _ in fns]
    for i in range(iters):
        for fn, ev in zip(fns, events):
            flush()
            ev[i][0].record()
            fn()
            ev[i][1].record()
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in ev) for ev in events]


def host_us(fn, iters: int = 100) -> float:
    """Median host time of one call of ``fn`` in microseconds: the time the
    caller is held, none of the calls waiting for the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def time_kernels(cc, dev, errs: dict, launches: dict) -> list[dict]:
    """Phase 5, at the main-path shape. Cold L2: a 256 MB write before every
    call leaves the L2 full of dirty lines, as the training step leaves it;
    the call then also writes those back as it reads. That is ``ms``, the
    yardstick the earlier times were taken with. A 256 MB read instead leaves
    clean lines, which is what the bound assumes; those times are printed
    beside it as a second reading."""
    b, c, h, w = MAIN_SHAPE
    hw = h * w
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(MAIN_SHAPE, device=dev, generator=gen)
    g = torch.randn(b, c, c, device=dev, generator=gen)
    f = z.view(b, c, hw)
    s_sym = (g + g.transpose(1, 2)) / (hw - 1)
    buf = torch.zeros(64 * 1024 * 1024, device=dev)
    ops = 2.0 * b * c * c * hw
    # the library's C entry points on preallocated outputs: the host time of a
    # wrapper call less these is the wrapper's Python and allocations
    clib, cstream = cc._library(), torch.cuda.current_stream().cuda_stream
    partial = torch.empty(b * clib.wtpse_covariance_gram_chunks(b, c, hw) * c * c, device=dev)
    cov, dz = torch.empty(b, c, c, device=dev), torch.empty_like(z)
    c_calls = {"gram": lambda: clib.wtpse_covariance_gram_f32(
                   z.data_ptr(), partial.data_ptr(), cov.data_ptr(), b, c, hw, cc.EPS, cstream),
               "dz": lambda: clib.wtpse_covariance_dz_f32(
                   z.data_ptr(), g.data_ptr(), dz.data_ptr(), b, c, hw, cstream)}
    rows = []
    # each with a PyTorch call that moves the same bytes and computes nothing
    # (z.sum reads z once; z.clone reads it and writes a copy): what streaming
    # those bytes costs on this card, beside the bound's 3.35 TB/s
    for name, line, kern, plain, lib, stream, nbytes in (
            ("covariance_gram", "wt_pse_tpu/ops/whitening_pallas.py:68",
             lambda: cc.covariance_forward(z), lambda: cc.covariance_forward_plain(z),
             lambda: torch.bmm(f, f.transpose(1, 2)), z.sum, 4.0 * (b * c * hw + b * c * c)),
            ("covariance_dz", "wt_pse_tpu/ops/whitening_pallas.py:100",
             lambda: cc.covariance_backward(z, g), lambda: cc.covariance_backward_plain(z, g),
             lambda: torch.bmm(s_sym, f), z.clone, 4.0 * (2 * b * c * hw + b * c * c))):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
        short = name.split("_")[1]
        ms, lib_ms, plain_ms = time_in_turns((kern, lib, plain), buf.zero_)
        row = {"name": name, "route": "cuda", "source": "wt_pse_tpu_torch/csrc/covariance.cu",
               "replaces": line, "launches": launches[short],
               "max_abs_err": errs[short], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        log(f"{name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of it); plain "
            f"{row['plain_ms']:.4f} ms; torch.bmm yardstick {row['library_ms']:.4f} ms "
            f"(in turns, write flush)")
        r_ms, r_lib, stream_ms = time_in_turns((kern, lib, stream), buf.sum)
        log(f"{name} after a read flush: {r_ms:.4f} ms ({row['bound_ms'] / r_ms:.1%} of the "
            f"bound); torch.bmm yardstick {r_lib:.4f} ms; z.{stream.__name__} moving the "
            f"same bytes {stream_ms:.4f} ms")
        h_kern, h_c, h_lib = host_us(kern), host_us(c_calls[short]), host_us(lib)
        log(f"{name} host time a call: wrapper {h_kern:.1f} us (its C entry point alone "
            f"{h_c:.1f} us), torch.bmm {h_lib:.1f} us")
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.runtime import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib, compiler_out = cc.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in compiler_out.splitlines():  # each kernel's name, then its numbers
        if "Function properties for" in line or "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]

    errs = check_kernels(cc, dev)
    check_against_cpu(dev)
    launches = main_path(cc, dev)
    rows = time_kernels(cc, dev, errs, launches)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
