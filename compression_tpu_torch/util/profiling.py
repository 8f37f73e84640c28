"""Profiling and observability hooks (PyTorch counterpart of
compression_tpu/util/profiling.py).

Per-phase wall-clock timers (``PhaseTimer``, ``phase`` on a process-wide
timer) and ``torch.profiler`` traces written as Chrome trace files.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

__all__ = ["PhaseTimer", "trace", "phase", "global_summary"]


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
