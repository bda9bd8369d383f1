"""The training step's share of the card's peak while the card works: the
configuration's FLOPs a step (counted by ``harness/flops.py`` over the
reference's step) times the traced epoch's steps, over the seconds in which
a kernel or copy ran on the card in that epoch (the device trace), over the
configuration's dense peak for its precision. Idle time is
``device_idle_pct.train``'s, not this."""


def read(ctx):
    if ctx.device.type != "cuda" or ctx.busy_s <= 0:
        return None
    cfg = ctx.config
    return 100.0 * cfg["flops_per_step"] * ctx.traced_steps / ctx.busy_s / cfg["peak_flop_per_s"]
