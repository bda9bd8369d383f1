"""Device milliseconds a step spends in the four capturable Adams (under
data parallelism with the gradient means ahead of them): the stamped epoch's
mean per step of its ``optimizer`` spans summed (``harness/spans.py``)."""

from harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "optimizer")
