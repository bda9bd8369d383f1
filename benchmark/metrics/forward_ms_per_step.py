"""Device milliseconds a step spends in the four phases' forwards: the nets'
forwards with their losses and the whitening covariances, the teachers'
no-grad forwards of phases 2 and 4 included; the stamped epoch's mean per
step of its ``forward`` spans summed (``harness/spans.py``)."""

from harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "forward")
