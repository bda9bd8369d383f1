"""Device milliseconds a step spends in the sampler (``data/augment.py``)
inside the CUDA graph: the stamped epoch's mean per step of the ``sample``
span, from the step's first mark to the end of the batch's copy into the
graph's static batch (``harness/spans.py``)."""

from harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "sample")
