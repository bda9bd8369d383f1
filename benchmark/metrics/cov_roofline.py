"""The covariance's share of its roofline: the public entry
``ops/whitening.py::feature_covariance`` at the step's site shape
z = (batch, base width, side, side) in the configuration's compute type. The
forward and the backward are timed apart on the card by CUDA events, each
after a 256 MB write that evicts the L2 and behind a spin kernel, so that
each half reads z from HBM as in the step, where the two run far apart, and
the host's launches are not timed; the time is their sum. The bound is the
bytes at the card's HBM rate: z read once for the Gram, z read once and dz
written once for the backward, and the (B, C, C) f32 covariance and its
gradient. It reads the same work whatever kernels implement the entry."""

import statistics

ITERS = 30
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clocks


def read(ctx):
    import torch

    from wt_pse_tpu_torch.ops.whitening import feature_covariance

    if ctx.device.type != "cuda":
        return None
    cfg, dev = ctx.config, ctx.device
    b, c, hw = cfg["batch_size"], cfg["widths"]["base_width"], cfg["image_size"]
    dtype = torch.bfloat16 if cfg["precision"] == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    z = torch.randn((b, c, hw, hw), generator=gen, device=dev).to(dtype).requires_grad_()
    g = torch.randn((b, c, c), generator=gen, device=dev)
    flush = torch.empty(64 * 2 ** 20, device=dev)

    def cold():
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)

    def event():
        return torch.cuda.Event(enable_timing=True)

    for _ in range(3):
        torch.autograd.grad(feature_covariance(z), z, g)
    marks = []
    for _ in range(ITERS):
        m = [event() for _ in range(4)]
        cold()
        m[0].record()
        cov = feature_covariance(z)
        m[1].record()
        cold()
        m[2].record()
        torch.autograd.grad(cov, z, g)
        m[3].record()
        marks.append(m)
    torch.cuda.synchronize(dev)
    ms = statistics.median(a.elapsed_time(b) + c.elapsed_time(d) for a, b, c, d in marks)
    nbytes = 3 * z.numel() * z.element_size() + 2 * 4 * b * c * c
    return 100.0 * nbytes / cfg["hbm_bytes_per_s"] / (ms / 1e3)
