"""The traced window: runs a loop under ``torch.profiler`` and reduces the
trace to what the per-layer metrics read.

Spans are the harness's own, around its calls into the program
(``portbench.compress``, ``portbench.decompress``, ...); the device's
activity is every kernel, copy and fill the profiler saw on the card.
Times are seconds from the window's start.
"""

from __future__ import annotations

import bisect
import collections

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."


def _ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return fn()
    return getattr(event, f"{what}_us")() * 1000


def _raw(prof):
    """(cpu events, device events) as (name, start_ns, end_ns)."""
    import torch

    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        kind = e.device_type()
        if kind == torch.autograd.DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not annotation and end > start \
                    and not e.name().startswith(SPAN_PREFIX):
                dev.append((e.name(), start, end))
        elif kind == torch.autograd.DeviceType.CPU:
            cpu.append((e.name(), start, end))
    return cpu, dev


def union(intervals):
    """Sorted, disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(busy, spans):
    """Total length of ``spans`` that the disjoint, sorted ``busy``
    intervals cover."""
    starts = [b[0] for b in busy]
    total = 0.0
    for s, e in spans:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            lo, hi = max(busy[i][0], s), min(busy[i][1], e)
            if hi > lo:
                total += hi - lo
            i += 1
    return total


def summarize(prof):
    """The traced window's summary: its length, the device's busy time,
    every device operation and harness span, the operations that took
    most time and the idle gaps by what the host was doing."""
    cpu, dev = _raw(prof)
    roots = [(s, e) for n, s, e in cpu if n == WINDOW]
    if not roots:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = roots[0]

    def rel(t):
        return (t - w0) / 1e9

    kernels = [(n, rel(s), rel(e)) for n, s, e in dev if e > w0 and s < w1]
    busy = union((max(s, 0.0), min(e, rel(w1))) for _, s, e in kernels)
    spans = collections.defaultdict(list)
    for n, s, e in cpu:
        if n.startswith(SPAN_PREFIX) and n != WINDOW:
            spans[n[len(SPAN_PREFIX):]].append((rel(s), rel(e)))
    by_op = collections.Counter()
    for n, s, e in kernels:
        by_op[n[:120]] += e - s
    # What the host was doing in each gap: the innermost host event under
    # the gap's middle, else the harness span it lies in (Python code of
    # the program that the profiler records no event for).
    host = sorted((rel(s), rel(e), n) for n, s, e in cpu if n != WINDOW)
    host_starts = [h[0] for h in host]
    outer = sorted((s, e, f"{n} (untraced host code)")
                   for n, spans_ in spans.items() for s, e in spans_)
    gaps = collections.Counter()
    edges = [(0.0, 0.0)] + busy + [(rel(w1), rel(w1))]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(host_starts, mid)
        best = None
        for s, e, n in reversed(host[max(i - 64, 0): i]):
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        if best is None or best[2].startswith(SPAN_PREFIX):
            best = next((o for o in outer if o[0] <= mid <= o[1]), best)
        gaps[best[2][:120] if best else "(between requests)"] += b - a
    return dict(
        window_s=rel(w1),
        busy_s=sum(e - s for s, e in busy),
        busy=busy,
        kernels=kernels,
        spans=dict(spans),
        device_ops=[[n, t] for n, t in by_op.most_common(10)],
        idle_gaps=[[n, t] for n, t in gaps.most_common(10)])


def traced(body, device):
    """Runs ``body()`` under the profiler inside the window's span; returns
    (its result, the summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = getattr(device, "type", "") == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            result = body()
            if cuda:
                torch.cuda.synchronize(device)
    return result, summarize(prof)


def span(name):
    """A harness span around one call into the program."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)
