"""Profiling and observability hooks (PyTorch counterpart of
compression_tpu/util/profiling.py).

Per-phase wall-clock timers (``PhaseTimer``, ``phase`` on a process-wide
timer), ``torch.profiler`` traces written as Chrome trace files, and the
program's own spans (``span``, ``wait``, read back with ``spans``).

Spans record only while ``torch.profiler`` is recording (``trace``, or
any other profile): each enters ``record_function("ctpu.<layer>.<name>")``, so it
shows in the profiler's trace, and appends a ``SpanRecord`` timed with
``time.time_ns()``, the clock the profiler's events carry.  With the
profiler off a span is one flag check that returns a shared null context.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["PhaseTimer", "trace", "phase", "global_summary", "span",
           "wait", "spans", "clear_spans", "dropped_spans", "SpanRecord"]


def _cuda_devices(tree, found):
    """Collects the CUDA devices of the tensors in a nested structure."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _cuda_devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _cuda_devices(value, found)
    return found


def block_until_ready(tree):
    """Waits for the CUDA devices that hold the tensors of ``tree`` (a
    tensor, or dicts, lists and tuples of them); does nothing for CPU
    tensors and other values.  Returns ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class PhaseTimer:
    """Accumulates wall-clock per named phase; thread-unsafe by design."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        """Times the body under ``name``.  ``block_on``: tensors whose CUDA
        devices are synchronized before the clock stops (kernel launches
        return before the device finishes)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": round(self.totals[name], 6),
                   "count": self.counts[name],
                   "mean_ms": round(
                       1e3 * self.totals[name] / max(self.counts[name], 1),
                       3)}
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


_GLOBAL = PhaseTimer()


def phase(name: str):
    """Context manager timing a phase on the global timer."""
    return _GLOBAL(name)


def global_summary() -> dict:
    return _GLOBAL.summary()


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: Optional[int] = None):
    """``torch.profiler`` trace of the body, written to
    ``<log_dir>/trace.json`` (Chrome trace format: chrome://tracing,
    Perfetto).  The card's kernels are traced when CUDA is available.

    ``host_tracer_level`` is JAX's host tracer level, mapped to what
    ``torch.profiler`` records on the host: None or 2 (JAX's default) the
    operators; 3 (JAX's verbose level) the operators with their input
    shapes and Python stacks.  Levels 0 (no host tracing) and 1 (user
    annotations only) have no counterpart there and raise ValueError.
    """
    if host_tracer_level not in (None, 2, 3):
        raise ValueError(
            f"host_tracer_level {host_tracer_level} has no torch.profiler "
            "counterpart (2: operators; 3: operators with shapes and stacks)")
    verbose = host_tracer_level == 3
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities,
                                  record_shapes=verbose, with_stack=verbose)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- the program's spans -------------------------------------------------------
# Records kept at most; later ones are counted in ``dropped_spans()``.
MAX_SPANS = 1_000_000


class SpanRecord:
    """One span: ``id``; ``parent`` (the enclosing span's id, or None);
    ``request`` (the request's id, or None outside any request);
    ``layer``, ``name``, ``kind`` ("host": host work, "dispatch": kernel
    launches the host does not wait for, "wait": the host waits for the
    card); ``start_ns`` and ``end_ns`` by ``time.time_ns()`` (``end_ns``
    is None while the span is open)."""

    __slots__ = ("id", "parent", "request", "layer", "name", "kind",
                 "start_ns", "end_ns")

    def __init__(self, id, parent, request, layer, name, kind, start_ns,
                 end_ns=None):
        self.id, self.parent, self.request = id, parent, request
        self.layer, self.name, self.kind = layer, name, kind
        self.start_ns, self.end_ns = start_ns, end_ns

    @property
    def label(self):
        """The name of its ``record_function``: ``ctpu.<layer>.<name>``."""
        return f"ctpu.{self.layer}.{self.name}"

    def __repr__(self):
        return (f"SpanRecord({self.label}, kind={self.kind}, id={self.id}, "
                f"parent={self.parent}, request={self.request})")


_records: list = []
_dropped = 0
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("record", "function")

    def __init__(self, layer, name, kind, request):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        if request is True:
            request = next(_requests)
        elif request is None and top is not None:
            request = top.request
        self.record = SpanRecord(next(_ids), top.id if top else None,
                                 request, layer, name, kind, 0)
        if len(_records) < MAX_SPANS:
            _records.append(self.record)
        else:
            _dropped += 1
        self.function = torch.profiler.record_function(self.record.label)

    def __enter__(self):
        _local.stack.append(self.record)
        self.record.start_ns = time.time_ns()
        self.function.__enter__()
        return self.record.request

    def __exit__(self, *exc):
        self.function.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _local.stack.pop()
        return False


def span(layer: str, name: str, kind: str = "host", request=None):
    """A span of the program around the body, recorded while
    ``torch.profiler`` is recording; otherwise a shared null context.

    ``kind``: "host", "dispatch" or "wait" (``SpanRecord``).  ``request``:
    None carries the enclosing span's request id, True begins a new
    request (an entry point, or one image of a batch), an id resumes that
    request.  ``with span(...) as request_id`` gives the id (None when
    nothing records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(layer, name, kind, request)


def wait(name: str):
    """A span in which the host waits for the card: a copy to the host, a
    read of a device value, an upload from pageable memory."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span("wait", name, "wait", None)


def spans() -> list:
    """The recorded ``SpanRecord``s, in the order the spans began."""
    return list(_records)


def clear_spans():
    """Forgets the recorded spans and the count of dropped ones."""
    global _dropped
    _records.clear()
    _dropped = 0


def dropped_spans() -> int:
    """Spans not kept since the last ``clear_spans`` (past MAX_SPANS)."""
    return _dropped
