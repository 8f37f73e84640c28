"""The share of the traced window in which no kernel, copy or fill ran on
the card (device trace)."""

from portbench.metrics import _trace


def read(observed):
    summary = observed.get("trace")
    return _trace.idle_pct(summary) if summary else None
