"""One client in a closed loop of batches: each request compresses
``batch`` images of the pool with one call (``compress``, e.g.
``compress_native_many``) and decompresses the containers with one call
(``decompress``), the work of each call dispatched ahead of its first
copy to the host.

Traffic parameters: ``pool``, ``height``, ``width``, ``batch``,
``compress``, ``decompress``, ``warmup`` (round trips before the window),
``check`` (images the reference judges).

End to end: megapixels of the images whose round trip finished in the
window, over the window's seconds.
"""

from __future__ import annotations

import itertools

from portbench import harness
from portbench import trace as trace_lib
from portbench.loops import _codec

clock = harness.clock


def _round_trips(codec, tr, images, picks, until, spans=False):
    """Round trips of ``batch`` images in ``picks`` order until the clock
    passes ``until``; returns ([(picks, seconds, containers, images)], the
    number of round trips that raised or answered short)."""
    compress = getattr(codec, tr["compress"])
    decompress = getattr(codec, tr["decompress"])
    b = tr["batch"]
    out, failed = [], 0
    while True:
        batch = list(itertools.islice(picks, b))
        if len(batch) < b:
            break
        t0 = clock()
        try:
            with _codec.span("round_trip", spans):
                containers = compress([images[p] for p in batch])
                decoded = decompress(containers)
            if len(containers) != b or len(decoded) != b:
                raise ValueError(f"{len(containers)} containers and "
                                 f"{len(decoded)} images for {b} images")
            out.append((batch, clock() - t0, containers, decoded))
        except Exception:  # noqa: BLE001 -- a failed request is counted
            failed += _codec.report_failure(failed)
        if clock() >= until:
            break
    return out, failed


def run(ctx):
    cell = ctx.cell
    tr = cell.traffic
    w, codec, images = _codec.setup(ctx)
    picks = _codec.order(ctx.seed, len(images))
    _round_trips(codec, tr, images,
                 itertools.islice(picks, tr["warmup"] * tr["batch"]),
                 float("inf"))
    start = ctx.window_opens()
    done, failed = _round_trips(codec, tr, images, picks,
                                start + ctx.seconds)
    window_s = clock() - start
    summary = traced = None
    t_trace = clock()
    if ctx.trace:
        seconds = min(ctx.seconds, harness.TRACE_SECONDS)
        (traced, _), summary = trace_lib.traced(lambda: _round_trips(
            codec, tr, images, picks, clock() + seconds,
            spans=True), ctx.device)
    t_trace = clock() - t_trace
    peak = _codec.memory_peak(ctx.device)
    del codec
    _codec.free(ctx.device)
    answers = [(images[p], c, d) for batch, _, cs, ds in done
               for p, c, d in zip(batch, cs, ds)]
    t_ref = clock()
    numbers, _ = _codec.judge(ctx, w, answers, tr["check"])
    notes = dict(
        window_s=window_s, trace_s=t_trace, reference_s=clock() - t_ref,
        requests=len(done), traced_requests=len(traced) if traced else 0,
        round_trip_ms={q: harness.percentile([r[1] * 1e3 for r in done], q)
                       for q in (50, 95, 100)},
        **numbers)
    n_images = len(answers)
    flops = cell.config_module.flops(cell.config, tr["height"], tr["width"])
    observed = dict(
        window_s=window_s, images=n_images, flops=flops, trace=summary,
        traced_images=sum(len(r[0]) for r in traced) if traced else 0)
    mpix = n_images * tr["height"] * tr["width"] / 1e6
    return harness.Outcome(
        attempted=len(done) + failed, failed=failed,
        end_to_end=dict(mpix_per_s=mpix / window_s),
        observed=observed,
        checks={k: numbers.get(k) for k in cell.limits},
        memory_peak_bytes=peak, trace=summary, notes=notes)
