"""Milliseconds per compress request inside the program's `container.*`
spans in which no kernel, copy or fill ran on the card (program spans
aligned to the device trace)."""

from portbench.metrics import _spans


def read(observed):
    return _spans.container_idle_ms(observed, "compress")
