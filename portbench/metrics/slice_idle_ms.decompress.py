"""Milliseconds per decompress request inside the program's `slices.loop`
spans in which no kernel, copy or fill ran on the card: the slice loop's
bubbles (program spans aligned to the device trace)."""

from portbench.metrics import _slices


def read(observed):
    return _slices.idle_ms(observed, "decompress")
