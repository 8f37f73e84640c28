"""One client in a closed loop: each request compresses one image of the
pool and then decompresses the container it got back.

Traffic parameters: ``pool``, ``height``, ``width`` (the images),
``compress`` and ``decompress`` (the codec's entry points), ``warmup``
(requests before the window), ``check`` (answers the reference judges).

End to end: the 95th percentile of every compress and of every
decompress request of the window, by the host's clock from the call to
its bytes or image returned.
"""

from __future__ import annotations

import itertools

from portbench import harness
from portbench import trace as trace_lib
from portbench.loops import _codec

clock = harness.clock


def _requests(codec, tr, images, picks, until, spans=False):
    """Runs requests in ``picks`` order until the clock passes ``until``;
    returns ([(pick, compress s, decompress s, container, image)], the
    number of requests that raised)."""
    compress = getattr(codec, tr["compress"])
    decompress = getattr(codec, tr["decompress"])
    out, failed = [], 0
    for pick in picks:
        image = images[pick]
        t0 = clock()
        try:
            with _codec.span("compress", spans):
                container = compress(image)
            t1 = clock()
            with _codec.span("decompress", spans):
                decoded = decompress(container)
            out.append((pick, t1 - t0, clock() - t1, container, decoded))
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
    _requests(codec, tr, images, itertools.islice(picks, tr["warmup"]),
              float("inf"))
    start = ctx.window_opens()
    done, failed = _requests(codec, tr, images, picks, start + ctx.seconds)
    window_s = clock() - start
    summary = traced = None
    t_trace = clock()
    if ctx.trace:
        seconds = min(ctx.seconds, harness.TRACE_SECONDS)
        (traced, _), summary = trace_lib.traced(lambda: _requests(
            codec, tr, images, picks, clock() + seconds,
            spans=True), ctx.device)
    t_trace = clock() - t_trace
    peak = _codec.memory_peak(ctx.device)
    del codec
    _codec.free(ctx.device)
    answers = [(images[p], c, d) for p, _, _, c, d in done]
    t_ref = clock()
    numbers, tables = _codec.judge(ctx, w, answers, tr["check"])
    compress_ms = [r[1] * 1e3 for r in done]
    decompress_ms = [r[2] * 1e3 for r in done]
    notes = dict(
        window_s=window_s, trace_s=t_trace, reference_s=clock() - t_ref,
        requests=len(done), traced_requests=len(traced) if traced else 0,
        compress_ms={q: harness.percentile(compress_ms, q)
                     for q in (50, 90, 95, 99, 100)},
        decompress_ms={q: harness.percentile(decompress_ms, q)
                       for q in (50, 90, 95, 99, 100)},
        **numbers)
    flops = cell.config_module.flops(cell.config, tr["height"], tr["width"])
    observed = dict(
        compress_ms=compress_ms, decompress_ms=decompress_ms,
        window_s=window_s, images=len(done), flops=flops,
        tables=_codec.table_sizes(tables), trace=summary,
        latent_depths=cell.config_module.latent_depths(cell.config),
        traced_containers=[r[3] for r in traced] if traced else [])
    return harness.Outcome(
        attempted=len(done) + failed, failed=failed,
        end_to_end=dict(compress_p95_ms=harness.percentile(compress_ms, 95),
                        decompress_p95_ms=harness.percentile(decompress_ms,
                                                             95)),
        observed=observed,
        checks={k: numbers.get(k) for k in cell.limits},
        memory_peak_bytes=peak, trace=summary, notes=notes)
