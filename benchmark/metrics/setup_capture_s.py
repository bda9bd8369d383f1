"""Host seconds the Trainer's construction spends capturing the step as a
CUDA graph, its eager warm-up included (``train/graph.py``): its
``capture`` span, a child of ``trainer.init``; a later capture is not
counted (``harness/spans.py``)."""

from harness.spans import setup_span_s


def read(ctx):
    return setup_span_s(ctx, "capture")
