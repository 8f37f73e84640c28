"""Milliseconds of host time per train step in the traced window: the
program's `train.step` span, which never waits for the card, so its time
is the step's dispatch (program spans, host clock)."""

from portbench.metrics import _spans


def read(observed):
    steps = _spans.requests(_spans.recorded(), "train")
    if not steps:
        return None
    return sum(g[0].end_ns - g[0].start_ns for g in steps) / len(steps) / 1e6
