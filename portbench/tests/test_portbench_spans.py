"""The readers of the program's spans (``metrics/_spans.py`` and the
``host_waits``, ``container_ms``, ``container_idle_ms`` and ``dispatch_ms``
readers) on hand-made span records and summaries, then on tiny traced runs
of every cell on the CPU."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench import trace as trace_lib
from portbench.metrics import _spans
from portbench.tests.conftest import run_tiny

from compression_tpu_torch.util import profiling

# The window's start on the spans' clock (ns); summaries count seconds
# from it.
W0 = 1_700_000_000_000_000_000
MS = 1_000_000


class Records:
    """Hand-made span records; times in ms from the window's start."""

    def __init__(self):
        self.records = []
        self.stack = []

    def span(self, label, start, end, kind="host", children=()):
        layer, name = label.split(".", 1)
        parent = self.stack[-1] if self.stack else None
        r = profiling.SpanRecord(len(self.records), parent, None, layer, name,
                                 kind, W0 + round(start * MS),
                                 W0 + round(end * MS))
        self.records.append(r)
        self.stack.append(r.id)
        for child in children:
            self.span(*child)
        self.stack.pop()
        return r


def _summary(harness_spans, busy=()):
    busy = trace_lib.union(busy)
    return dict(spans=harness_spans, busy=busy,
                busy_s=sum(e - s for s, e in busy), window_s=10.0)


def _read(name, records, observed, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return harness.load_metric_reader(name)(observed)


def _compress(rec, t, delay=0.0):
    """A classic compress at ``t`` ms (entry ``delay`` ms after the
    harness's span): 10 ms in all, two container spans of 2 ms with a 0.5
    ms wait each, one wait outside them."""
    t += delay
    rec.span("codec.compress", t, t + 10, children=[
        ("transforms.analysis", t + 0.5, t + 1, "dispatch"),
        ("entropy.encode.y", t + 1, t + 5, "host", [
            ("wait.route", t + 1.5, t + 2, "wait"),
            ("container.pack", t + 3, t + 5, "host", [
                ("wait.fetch", t + 3, t + 3.5, "wait")])]),
        ("container.pack", t + 6, t + 8, "host", [
            ("wait.fetch", t + 6, t + 6.5, "wait")])])


def test_waits_and_container_self_time_per_request(monkeypatch):
    rec = Records()
    _compress(rec, 0)
    _compress(rec, 20)
    rec.span("codec.decompress", 40, 45, children=[
        ("container.parse", 40, 41, "host", [
            ("wait.upload", 40.5, 41, "wait")])])
    observed = {}
    assert _read("host_waits.compress", rec.records, observed,
                 monkeypatch) == 3
    assert _read("host_waits.decompress", rec.records, observed,
                 monkeypatch) == 1
    # Two container spans of 2 ms, each less its 0.5 ms wait.
    assert _read("container_ms.compress", rec.records, observed,
                 monkeypatch) == pytest.approx(3.0)
    assert _read("container_ms.decompress", rec.records, observed,
                 monkeypatch) == pytest.approx(0.5)


def test_entry_spans_align_to_the_harness_spans():
    rec = Records()
    # Entries 7 us, 3 us and 5 us after the harness's spans open.
    for t, delay in ((100, 0.007), (200, 0.003), (300, 0.005)):
        _compress(rec, t, delay)
    groups = _spans.requests(rec.records, "compress")
    summary = _summary({"compress": [(0.1, 0.111), (0.2, 0.211),
                                     (0.3, 0.311)]})
    assert _spans.window_start_ns(groups, summary, "compress") == \
        W0 + 3_000
    # The k-th entry pairs with the k-th harness span: counts that
    # disagree give nothing.
    summary["spans"]["compress"].append((0.4, 0.411))
    assert _spans.window_start_ns(groups, summary, "compress") is None


def test_container_idle_time_is_the_complement_of_busy(monkeypatch):
    rec = Records()
    _compress(rec, 100)
    _compress(rec, 200)
    harness_spans = {"compress": [(0.1, 0.110), (0.2, 0.210)]}
    # Containers at 103-105 and 106-108 ms of each request.  The card is
    # busy 104-106.5 ms in the first and 200-300 ms (all of it) in the
    # second: 2.5 ms idle in all.
    summary = _summary(harness_spans, [(0.104, 0.1065), (0.2, 0.3)])
    observed = dict(trace=summary)
    assert _read("container_idle_ms.compress", rec.records, observed,
                 monkeypatch) == pytest.approx(2.5 / 2)
    # Nothing busy: all 4 ms of containers a request.
    observed = dict(trace=_summary(harness_spans))
    assert _read("container_idle_ms.compress", rec.records, observed,
                 monkeypatch) == pytest.approx(4.0)


def test_the_batch_cell_is_per_image(monkeypatch):
    rec = Records()
    for t in (0, 100):
        rec.span("codec.compress_native_many", t, t + 30, children=[
            ("codec.image", t, t + 5, "host", [
                ("wait.escapes", t + 1, t + 2, "wait")]),
            ("codec.image", t + 5, t + 10, "host", [
                ("wait.escapes", t + 6, t + 7, "wait")]),
            ("container.pack", t + 10, t + 20, "host", [
                ("wait.fetch", t + 10, t + 11, "wait")]),
            ("container.pack", t + 20, t + 30, "host", [
                ("wait.fetch", t + 20, t + 21, "wait")])])
        rec.span("codec.decompress_native_many", t + 30, t + 60, children=[
            ("codec.image", t + 30, t + 40, "host", [
                ("container.parse", t + 30, t + 32)]),
            ("codec.image", t + 40, t + 50, "host", [
                ("container.parse", t + 40, t + 42)]),
            ("codec.finish", t + 50, t + 55, "host", [
                ("wait.sanity", t + 50, t + 51, "wait")]),
            ("codec.finish", t + 55, t + 60, "host", [
                ("wait.sanity", t + 55, t + 56, "wait")])])
    summary = _summary({"round_trip": [(0.0, 0.06), (0.1, 0.16)]})
    observed = dict(trace=summary)
    # Four images; six waits a round trip of two.
    assert _read("host_waits.batch", rec.records, observed,
                 monkeypatch) == 3
    # Containers: 2 x 10 + 2 x 2 ms a round trip, the card idle.
    assert _read("container_idle_ms.batch", rec.records, observed,
                 monkeypatch) == pytest.approx(24 / 2)


def test_dispatch_ms_is_the_step_span(monkeypatch):
    rec = Records()
    for t in (0, 50, 100):
        rec.span("train.step", t, t + 12, children=[
            ("train.forward", t, t + 4, "dispatch"),
            ("train.backward", t + 4, t + 10, "dispatch"),
            ("train.optimizer", t + 10, t + 12, "dispatch")])
    assert _read("dispatch_ms.train", rec.records, {},
                 monkeypatch) == pytest.approx(12.0)


READERS = ["host_waits.compress", "host_waits.decompress", "host_waits.batch",
           "container_ms.compress", "container_ms.decompress",
           "container_idle_ms.compress", "container_idle_ms.decompress",
           "container_idle_ms.batch", "dispatch_ms.train"]


@pytest.mark.parametrize("name", READERS)
def test_none_when_nothing_was_recorded(name, monkeypatch):
    rec = Records()
    rec.span("codec.upload", 0, 1)  # no entry span around it
    observed = dict(trace=_summary({"compress": [(0.0, 0.001)]}))
    assert _read(name, [], observed, monkeypatch) is None
    assert _read(name, rec.records, observed, monkeypatch) is None
    # A program without spans (the parent of this reader's commit).
    monkeypatch.delattr(profiling, "spans")
    assert harness.load_metric_reader(name)(observed) is None


@pytest.mark.parametrize("cell", ["bmshj2018.tfci-kodak", "hific.native-kodak",
                                  "bmshj2018.train-b8", "hific.native-batch8"])
def test_a_traced_tiny_run_reports_its_span_metrics(cell):
    profiling.clear_spans()
    line, _ = run_tiny(cell, trace=True)
    names = {m["name"] for m in harness.resolve(cell).per_layer
             if m["name"] in READERS}
    assert names and names <= set(line["metrics"])
    for name in names:
        value = line["metrics"][name]["value"]
        assert value >= 0
        if name.startswith("host_waits."):
            assert value == int(value) > 0
