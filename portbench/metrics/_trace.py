"""Helpers of the per-layer readers over a traced window's summary
(``trace.summarize``)."""

from __future__ import annotations

import re

from portbench import trace as trace_lib

# K3': the in-stream-gamma decode, one warp a stream (or one thread a
# stream above 16384 streams); template mode 2 is kGamma.
K3 = re.compile(r"decode_(?:symbols_warp_)?kernel(?:<2\b|ILi2E)")
# The symbol encoders: K1 (mode 0) and K6' (mode 2), either form.
ENCODE = re.compile(r"encode_(?:symbols_warp_)?kernel(?:<|I)")


def per_span(summary, span, pattern):
    """[[(start, end) of each matching kernel] for each span ``span``]."""
    spans = summary["spans"].get(span, [])
    kernels = sorted((s, e) for n, s, e in summary["kernels"]
                     if pattern.search(n))
    return [[(s, e) for s, e in kernels if s >= a and e <= b]
            for a, b in spans]


def whole(containers, launches, count):
    """(container, its launches) of the requests whose spans hold exactly
    ``count`` launches; empty unless that is most of them."""
    if len(containers) != len(launches):
        return []
    pairs = [(c, k) for c, k in zip(containers, launches) if len(k) == count]
    return pairs if 2 * len(pairs) > len(launches) else []


def idle_pct(summary, span=None):
    """The share (%) of the spans named ``span`` (or of the whole window)
    in which nothing ran on the card."""
    if span is None:
        whole = summary["window_s"]
        return 100.0 * (1.0 - summary["busy_s"] / whole) if whole else None
    spans = summary["spans"].get(span, [])
    total = sum(b - a for a, b in spans)
    if not total:
        return None
    return 100.0 * (1.0 - trace_lib.covered(summary["busy"], spans) / total)
