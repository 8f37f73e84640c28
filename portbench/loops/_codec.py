"""Set-up and checks that the codec loops share: the weights and the
program's codec, the image pool, and the reference's judgement of a
sample of the window's answers."""

from __future__ import annotations

import contextlib
import gc
import sys
import traceback

import numpy as np

from portbench import textures
from portbench import weights as weights_lib
from portbench.reference import check_codec

# Sub-seeds of a run's seed.
WEIGHTS, IMAGES, ORDER, SAMPLE = 1, 2, 3, 4


def precision(cfg):
    """The configuration's precision: float32 with TF32 off."""
    import torch

    if cfg["dtype"] != "float32" or cfg["tf32"]:
        raise ValueError("the loops run the configurations' float32")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def setup(ctx):
    """(weights, codec, host images [n] uint8 [H, W, 3])."""
    cell = ctx.cell
    precision(cell.config)
    w = weights_lib.make(cell.config_module.spec(cell.config),
                         weights_lib.sub_seed(ctx.seed, WEIGHTS), ctx.device)
    codec = cell.config_module.codec(cell.config, w, ctx.device)
    tr = cell.traffic
    pool = textures.pool(tr["pool"], tr["height"], tr["width"],
                         weights_lib.sub_seed(ctx.seed, IMAGES), ctx.device)
    return w, codec, list(pool.cpu().numpy())


def span(name, on):
    """The harness's span ``name`` around a call, in a traced window."""
    from portbench import trace

    return trace.span(name) if on else contextlib.nullcontext()


def report_failure(count):
    """Prints the first failed request's traceback; returns 1."""
    if not count:
        traceback.print_exc(file=sys.stderr)
    return 1


def order(seed, pool):
    """Which pool image each request takes, without end: the pool shuffled
    again for each pass, from the seed.  (An iterator: a list of a
    million picks would lengthen every full collection of the garbage
    collector inside the window.)"""
    rng = np.random.default_rng(weights_lib.sub_seed(seed, ORDER))
    while True:
        yield from (int(i) for i in rng.permutation(pool))


def sync(device):
    import torch

    if getattr(device, "type", "") == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device):
    import torch

    if getattr(device, "type", "") != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def free(device):
    import torch

    gc.collect()
    if getattr(device, "type", "") == "cuda":
        torch.cuda.empty_cache()


def judge(ctx, w, answers, count):
    """The largest of each number over ``count`` answers drawn from the
    seed; an answer is (image, container, decoded image)."""
    cell = ctx.cell
    tables = check_codec.CodecTables(cell.config, w)
    rng = np.random.default_rng(weights_lib.sub_seed(ctx.seed, SAMPLE))
    picks = rng.choice(len(answers), size=min(count, len(answers)),
                       replace=False)
    worst = {}
    for i in sorted(int(p) for p in picks):
        numbers = check_codec.judge(cell.reference, cell.config, w, tables,
                                    *answers[i], ctx.device)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, tables


def table_sizes(tables):
    """(entries, longest row) of the y and z tables."""
    return {name: (sum(len(r) for r in t.rows), max(len(r) for r in t.rows))
            for name, t in (("y", tables.y), ("z", tables.z))}
