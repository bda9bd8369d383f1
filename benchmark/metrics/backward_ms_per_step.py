"""Device milliseconds a step spends in the four phases' backwards (the
covariance kernels' included): the stamped epoch's mean per step of its
``backward`` spans summed (``harness/spans.py``)."""

from harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "backward")
