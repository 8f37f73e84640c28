"""The share of the decompress requests' time in which no kernel, copy or fill
ran on the card (device trace)."""

from portbench.metrics import _trace


def read(observed):
    summary = observed.get("trace")
    return _trace.idle_pct(summary, "decompress") if summary else None
