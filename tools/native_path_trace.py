#!/usr/bin/env python3
"""Where the time of the native containers goes, by torch.profiler.

Runs ``compress_native`` and ``decompress`` of a native container for
bls2017 and bmshj2018 at chip_smoke.py's widths, seed and first image
(512x512), a few times after warm-up, three ways: on the host clock alone
(work ending in a synchronize); with every step of the front end in a span
of its own, timed on the host clock; and so under torch.profiler.  The
spans: the image's upload, the
transforms and the coder's launches, the copy back and packing of
``_container`` (``to_bytes_list``, ``esc_to_pairs``, ``PackedTensors.pack``
and its serialization), and on the way back the container's parsing
(``PackedTensors``, ``unpack``), ``from_bytes_list``, ``sidecar_flatten``,
the decode's launches (the uploads of ``torch.as_tensor`` fall between the
spans), the synthesis and ``_finish`` (the sanity check's wait and the copy
of the image back).

Prints one JSON line a call (model and direction): the host-clock ms
without and with the spans, each span's host ms a call (inclusive, on the
host clock: the time the host spent in it, waits for the card included),
and from the trace (the profiler slows the host, so its times are longer)
the traced ms, the device time of every kernel and copy (name, launches and
ms a call) and their sum (one stream: nothing overlaps), the card's idle
ms, the idle ms by the innermost span the host was in while the card
waited, and the host operators with the most self time.  Given a path,
it also writes the whole record there as JSON.  Run on a machine with an
NVIDIA GPU, from the root of a checkout (copy the file into another
checkout to trace that one):

    python3 tools/native_path_trace.py [record.json]
"""

import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUNS = 5
#: Device idle stretches shorter than this (us) are not attributed to a
#: span: they are the launch gaps between back-to-back kernels.
MIN_GAP_US = 20.0


def _spans(codec, models):
    """(owner, attribute, label) of every step of the front end that the
    trace puts in a span of its own."""
    from compression_tpu_torch.codec import torch_coder
    from compression_tpu_torch.models import native_format
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    own = [(codec, name, name) for name in (
        "_upload", "_container", "_unpack", "_decode_latent",
        "_synthesis_u8", "_finish")]
    own += [(codec, "_analysis" if models == "bls2017" else "_encode",
             "transforms")]
    if models == "bmshj2018":
        own += [(codec, "_indexes", "_indexes")]
    ems = [("em", codec.em)] + (
        [("side_em", codec.side_em)] if models == "bmshj2018" else [])
    for label, em in ems:
        own += [(em, "compress_sidecar_device",
                 f"{label}.compress_sidecar_device"),
                (em, "decompress_sidecar_device",
                 f"{label}.decompress_sidecar_device")]
    own += [(torch_coder, name, name) for name in (
        "to_bytes_list", "from_bytes_list", "sidecar_flatten",
        "decode_dispatch", "encode_dispatch", "sidecar_apply")]
    own += [(native_format, "esc_to_pairs", "esc_to_pairs"),
            (PackedTensors, "pack", "PackedTensors.pack"),
            (PackedTensors, "unpack", "PackedTensors.unpack"),
            (PackedTensors, "__init__", "PackedTensors.parse")]
    return own


@contextlib.contextmanager
def _instrumented(spans, host_s):
    """Wraps every span's callable in a torch.profiler.record_function of
    its label, and PackedTensors.string's getter in one more, adding the
    host seconds spent in each to ``host_s[label]``; restores them
    after."""
    from torch.profiler import record_function
    from compression_tpu_torch.util.packed_tensors import PackedTensors

    def wrap(fn, label):
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with record_function(label):
                    return fn(*args, **kwargs)
            finally:
                host_s[label] = host_s.get(label, 0.0) + (
                    time.perf_counter() - t0)
        return inner

    saved = []
    for owner, attr, label in spans:
        orig = owner.__dict__[attr] if isinstance(owner, type) else \
            getattr(owner, attr)
        saved.append((owner, attr, orig))
        setattr(owner, attr, wrap(orig, label))
    prop = PackedTensors.__dict__["string"]
    PackedTensors.string = property(
        wrap(prop.fget, "PackedTensors.serialize"), prop.fset)
    try:
        yield
    finally:
        PackedTensors.string = prop
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def _is_device(event):
    from torch.autograd import DeviceType
    return event.device_type != DeviceType.CPU


def _account(events, call_label, labels, runs):
    """Device time by kernel, busy and idle ms, and idle ms by the
    innermost span the host was in, over the calls marked ``call_label``.
    A span's own device-side entry (the profiler's annotation of the
    kernels inside it) is not a kernel and is left out."""
    marks = labels | {call_label}
    calls = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == call_label and not _is_device(e)]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in labels and not _is_device(e)]
    device = [e for e in events if _is_device(e) and e.name not in marks
              and any(a <= e.time_range.start < b for a, b in calls)]
    kernels = {}
    for e in device:
        k = kernels.setdefault(e.name[:80], [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.end - e.time_range.start
    busy = sum(v[1] for v in kernels.values())
    idle_by = {}
    traced = 0.0
    for a, b in calls:
        traced += b - a
        mine = sorted((e.time_range.start, e.time_range.end) for e in device
                      if a <= e.time_range.start < b)
        edges = [a] + [t for iv in mine for t in iv] + [b]
        at = a
        for start, end in [(edges[i], edges[i + 1])
                           for i in range(0, len(edges), 2)]:
            start = max(start, at)
            if end - start >= MIN_GAP_US:
                mid = 0.5 * (start + end)
                inner = [s for s in spans if s[0] <= mid < s[1]]
                name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                    else "(between spans)"
                idle_by[name] = idle_by.get(name, 0.0) + end - start
            at = max(at, end)
    return {
        "traced_ms": traced / runs / 1e3,
        "device_ms": busy / runs / 1e3,
        "idle_ms": (traced - busy) / runs / 1e3,
        "idle_ms_by_span": {k: v / runs / 1e3 for k, v in sorted(
            idle_by.items(), key=lambda kv: -kv[1])},
        "device": sorted(({"name": k, "launches": v[0] / runs,
                           "ms": v[1] / runs / 1e3}
                          for k, v in kernels.items()),
                         key=lambda r: -r["ms"]),
    }


def trace(model_name, device="cuda", num_filters=None, shape=None,
          runs=RUNS):
    """The records of ``compress_native`` and ``decompress`` of one
    model's native container (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from compression_tpu_torch.models import bls2017, bmshj2018

    first = next(iter(chip_smoke.IMAGES))
    if model_name == "bls2017":
        codec = bls2017.BLS2017Codec(bls2017.BLS2017Model(
            num_filters=num_filters or chip_smoke.NUM_FILTERS, seed=0),
            device=device)
    else:
        codec = bmshj2018.BMSHJ2018Codec(bmshj2018.BMSHJ2018Model(
            num_filters=num_filters or chip_smoke.BMSHJ_FILTERS, seed=0),
            device=device)
    img = np.random.RandomState(0).randint(
        0, 256, shape or chip_smoke.IMAGES[first]).astype(np.uint8)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    container = codec.compress_native(img)
    calls = {"compress_native": lambda: codec.compress_native(img),
             "decompress": lambda: codec.decompress(container)}
    spans = _spans(codec, model_name)
    labels = {label for _, _, label in spans} | {"PackedTensors.serialize"}
    out = []

    def timed():
        wall = []
        for _ in range(runs):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        return wall

    for direction, call in calls.items():
        for _ in range(2):
            call()
        wall = timed()
        host_s = {}
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        label = f"call:{direction}"
        with _instrumented(spans, host_s):
            call()
            host_s.clear()
            wall_spans = timed()
            span_ms = {k: v / runs * 1e3 for k, v in host_s.items()}
            with profile(activities=activities) as prof:
                for _ in range(runs):
                    with record_function(label):
                        call()
                        sync()
        averages = prof.key_averages()
        host = sorted(
            ({"name": e.key[:80], "calls": e.count / runs,
              "self_ms": e.self_cpu_time_total / runs / 1e3}
             for e in averages if e.key not in labels
             and not e.key.startswith("call:")),
            key=lambda r: -r["self_ms"])[:12]
        record = {
            "call": f"{model_name} {direction}, native container, {first}, "
                    "seed 0",
            "wall_ms": wall, "wall_ms_median": float(np.median(wall)),
            "wall_ms_with_spans_median": float(np.median(wall_spans)),
            **_account(prof.events(), label, labels, runs),
            "span_host_ms": dict(sorted(span_ms.items(),
                                        key=lambda kv: -kv[1])),
            "host_self": host,
            "container_bytes": len(container)}
        out.append(record)
    return out


def main(record_path=None):
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("native_path_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    records = []
    for model_name in ("bls2017", "bmshj2018"):
        for record in trace(model_name):
            record["card"] = chip_smoke.nvidia_smi_line()
            records.append(record)
            short = {k: record[k] for k in (
                "call", "wall_ms_median", "wall_ms_with_spans_median",
                "span_host_ms", "traced_ms", "device_ms", "idle_ms",
                "idle_ms_by_span")}
            short["device"] = record["device"][:6]
            print(json.dumps(short), flush=True)
    if record_path:
        with open(record_path, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
