"""Host seconds the Trainer's construction spends making the four nets and
their optimizers from the seed (``train/state.py::init_ensemble``): its
``init_ensemble`` span, a child of ``trainer.init`` (``harness/spans.py``)."""

from harness.spans import setup_span_s


def read(ctx):
    return setup_span_s(ctx, "init_ensemble")
