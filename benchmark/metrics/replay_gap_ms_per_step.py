"""Device milliseconds between one replayed step and the next, which the
host decides: over the stamped epoch's consecutive pairs of steps, the mean
of the later's first mark less the earlier's last (``harness/spans.py``)."""

from harness.spans import replay_gaps_ms, stamped_epoch


def read(ctx):
    got = stamped_epoch(ctx)
    return None if got is None else float(replay_gaps_ms(got[1]).mean())
