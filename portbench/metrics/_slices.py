"""Helpers of the readers of a slice loop's spans: the program's
``slices.loop`` span around each request's autoregression (ms2020's
``MS2020Model.slice_loop``), aligned to the device trace as
``_spans.container_idle_s`` aligns the ``container.*`` spans."""

from __future__ import annotations

from portbench import trace as trace_lib
from portbench.metrics import _spans

LOOP = "ctpu.slices.loop"


def idle_ms(observed, direction):
    """Milliseconds a request of ``direction`` inside its ``slices.loop``
    spans with no kernel, copy or fill on the card; None where the
    program records no such span or the spans cannot be aligned."""
    summary = observed.get("trace")
    groups = _spans.requests(_spans.recorded(), direction)
    loops = [r for g in groups for r in g if r.label == LOOP]
    if not summary or not loops:
        return None
    w0 = _spans.window_start_ns(groups, summary, direction)
    if w0 is None:
        return None
    spans = trace_lib.union(((r.start_ns - w0) / 1e9, (r.end_ns - w0) / 1e9)
                            for r in loops)
    idle = sum(e - s for s, e in spans) - trace_lib.covered(summary["busy"],
                                                            spans)
    return _spans.per_unit(groups, direction, idle * 1e3)
