"""The program's `wait` spans (the host waiting for the card) per
compress request in the traced window (program spans, host clock)."""

from portbench.metrics import _spans


def read(observed):
    return _spans.host_waits(observed, "compress")
