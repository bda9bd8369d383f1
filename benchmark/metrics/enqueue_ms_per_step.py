"""Host milliseconds the Trainer and its epoch driver take to enqueue one
step while the card's launch queue has room: ahead of the traced epoch, one
epoch's worth of single-step ``Trainer.epoch_step`` calls, each started on
an idle card, timed on the host clock from the call to its return and
summed. In the window a replay waits on the full launch queue, so the host's
time there is the card's; this is what the host would cost a step if the
card were faster. One step a call: a second bf16 replay already waits on the
queue (a call of 2 steps reads 18 ms a step, of 1 step 1.5-1.7 ms, on an
H100). Ahead of the profiler: once it has run, these calls took 2-8 times
as long."""

import time


def before(ctx):
    import torch

    ctx.enqueue_ms_per_step = None
    if ctx.device.type != "cuda" or getattr(ctx.trainer, "_graph", None) is None:
        return
    host = 0.0
    for step in range(ctx.traced_steps):
        torch.cuda.synchronize(ctx.device)
        t0 = time.perf_counter()
        ctx.trainer.epoch_step(step, 1)
        host += time.perf_counter() - t0
    torch.cuda.synchronize(ctx.device)
    ctx.enqueue_ms_per_step = 1e3 * host / ctx.traced_steps


def read(ctx):
    return ctx.enqueue_ms_per_step
