"""Helpers of the readers of the program's own spans: the records that
``compression_tpu_torch.util.profiling`` kept in the traced window (it
records only while the profiler is recording, and the traced window is
the run's only profile).

A request is the tree under one entry span: ``codec.compress``,
``codec.compress_native`` or ``codec.decompress`` for one image; a batch
round trip's ``codec.compress_native_many`` and
``codec.decompress_native_many``, whose images are their ``codec.image``
spans; a train step's ``train.step``.  Span times are ``time.time_ns()``,
the profiler's clock; the summary's are seconds from the window's start,
so the window's start on that clock is found from the harness's spans
around the same calls.  Readers return None where the program records no
spans (a program without them, or no request in the window).
"""

from __future__ import annotations

from portbench import trace as trace_lib

# The entry spans of each direction, and the harness's span around the
# entry spans that open a request.
ENTRIES = {
    "compress": ("ctpu.codec.compress", "ctpu.codec.compress_native"),
    "decompress": ("ctpu.codec.decompress",),
    "batch": ("ctpu.codec.compress_native_many",
              "ctpu.codec.decompress_native_many"),
    "train": ("ctpu.train.step",),
}
HARNESS = {"compress": ("compress", ENTRIES["compress"]),
           "decompress": ("decompress", ENTRIES["decompress"]),
           "batch": ("round_trip", ENTRIES["batch"][:1]),
           "train": ("train_step", ENTRIES["train"])}
CONTAINER = "ctpu.container."
IMAGE = "ctpu.codec.image"


def recorded():
    """The program's span records, or None where it keeps none."""
    from compression_tpu_torch.util import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def requests(records, direction):
    """[[the spans of one request, its entry span first]] of
    ``direction``, in the order the requests began."""
    root_of, groups = {}, {}
    for r in records or ():
        top = r.id if r.parent is None else root_of.get(r.parent, r.id)
        root_of[r.id] = top
        groups.setdefault(top, []).append(r)
    return [g for g in groups.values()
            if g[0].label in ENTRIES[direction] and g[0].end_ns is not None]


def units(groups, direction):
    """What a metric of ``direction`` is per: a request, or in the batch
    cell an image (its ``codec.image`` spans under compress)."""
    if direction != "batch":
        return len(groups)
    return sum(r.label == IMAGE for g in groups
               if g[0].label == ENTRIES["batch"][0] for r in g)


def per_unit(groups, direction, total):
    n = units(groups, direction)
    return total / n if n else None


def waits(groups):
    return sum(r.kind == "wait" for g in groups for r in g)


def containers(group):
    return [r for r in group if r.label.startswith(CONTAINER)]


def self_ns(group, span):
    """A span's time less that of its ``wait`` children."""
    return (span.end_ns - span.start_ns) - sum(
        r.end_ns - r.start_ns for r in group
        if r.parent == span.id and r.kind == "wait")


def window_start_ns(groups, summary, direction):
    """The traced window's start on the spans' clock: the k-th request's
    entry span pairs with the k-th harness span around it, and the
    smallest (entry start - harness start) is the closest bound; None
    where the counts disagree."""
    name, labels = HARNESS[direction]
    harness = summary["spans"].get(name, [])
    entries = [g[0] for g in groups if g[0].label in labels]
    if not entries or len(entries) != len(harness):
        return None
    return min(e.start_ns - round(h[0] * 1e9)
               for e, h in zip(entries, harness))


def container_idle_s(groups, summary, direction):
    """Seconds inside ``container.*`` spans in which nothing ran on the
    card, summed over the requests; None where they cannot be aligned."""
    w0 = window_start_ns(groups, summary, direction)
    if w0 is None:
        return None
    spans = trace_lib.union(((r.start_ns - w0) / 1e9, (r.end_ns - w0) / 1e9)
                            for g in groups for r in containers(g))
    inside = sum(e - s for s, e in spans)
    return inside - trace_lib.covered(summary["busy"], spans)


def host_waits(observed, direction):
    groups = requests(recorded(), direction)
    return per_unit(groups, direction, waits(groups)) if groups else None


def container_ms(observed, direction):
    groups = requests(recorded(), direction)
    if not groups:
        return None
    total = sum(self_ns(g, r) for g in groups for r in containers(g))
    return per_unit(groups, direction, total / 1e6)


def container_idle_ms(observed, direction):
    summary = observed.get("trace")
    groups = requests(recorded(), direction)
    if not summary or not groups:
        return None
    idle = container_idle_s(groups, summary, direction)
    return None if idle is None else per_unit(groups, direction, idle * 1e3)
