"""One client in a closed loop, as ``codec_closed_loop`` (whose timed
requests it runs), for a codec whose latent decodes slice by slice: each
request compresses one image of the pool and then decompresses the
container it got back, and the reference judges a sample of the answers
slice by slice (``reference/check_slices.py``).

Traffic parameters and end-to-end metrics: ``codec_closed_loop``'s.
"""

from __future__ import annotations

import itertools

import numpy as np

from portbench import harness
from portbench import trace as trace_lib
from portbench import weights as weights_lib
from portbench.loops import _codec
from portbench.loops.codec_closed_loop import _requests
from portbench.reference import check_slices

clock = harness.clock


def judge(ctx, w, answers, count):
    """The largest of each number over ``count`` answers drawn from the
    seed, as ``_codec.judge`` draws them; an answer is (image, container,
    decoded image)."""
    cell = ctx.cell
    tables = check_slices.SliceTables(cell.config, w)
    rng = np.random.default_rng(weights_lib.sub_seed(ctx.seed, _codec.SAMPLE))
    picks = rng.choice(len(answers), size=min(count, len(answers)),
                       replace=False)
    worst = {}
    for i in sorted(int(p) for p in picks):
        numbers = check_slices.judge(cell.reference, cell.config, w, tables,
                                     *answers[i], ctx.device)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, tables


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
    numbers, tables = judge(ctx, w, answers, tr["check"])
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
