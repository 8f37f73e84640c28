"""Training steps dispatched back to back: each step takes a batch of
crops of the image pool (made on the device in set-up) and the noise of
both latents, drawn from the seed, and updates the weights with Adam.

Traffic parameters: ``pool``, ``height``, ``width`` (the images the
crops come from), ``batch`` and ``crop``, ``lr`` (Adam's learning rate).

Set-up builds one step (the model, the optimizer and their state) and
drives it through its first three steps, which the reference follows;
the window goes on with the same object.  End to end: the window's
seconds over the steps it completed, the window closed by a device
synchronization.
"""

from __future__ import annotations

import numpy as np

from portbench import harness
from portbench import textures
from portbench import trace as trace_lib
from portbench import weights as weights_lib
from portbench.loops import _codec
from portbench.reference import check_train

clock = harness.clock
NOISE = 5


class Feed:
    """Batches of crops and the latents' noise, from the seed."""

    def __init__(self, ctx, pool):
        import torch

        tr, cfg = ctx.cell.traffic, ctx.cell.config
        self.pool = pool
        self.batch, self.crop = tr["batch"], tr["crop"]
        self.rng = np.random.default_rng(
            weights_lib.sub_seed(ctx.seed, _codec.ORDER))
        self.gen = torch.Generator(device=ctx.device)
        self.gen.manual_seed(weights_lib.sub_seed(ctx.seed, NOISE))
        self.shapes = ctx.cell.config_module.latent_shapes(
            cfg, self.batch, self.crop, self.crop)
        self.device = ctx.device

    def __call__(self):
        import torch

        n, h, w = self.pool.shape[:3]
        c = self.crop
        idx = self.rng.integers(n, size=self.batch)
        ys = self.rng.integers(h - c + 1, size=self.batch)
        xs = self.rng.integers(w - c + 1, size=self.batch)
        batch = torch.stack([self.pool[i, y: y + c, x: x + c]
                             for i, y, x in zip(idx, ys, xs)])
        noise = tuple(
            torch.empty(s, device=self.device).uniform_(
                -0.5, 0.5, generator=self.gen) for s in self.shapes)
        return batch, noise


def _steps(step, feed, until, spans=False):
    count = 0
    while True:
        batch, noise = feed()
        if spans:
            with trace_lib.span("train_step"):
                step(batch, u=noise)
        else:
            step(batch, u=noise)
        count += 1
        if clock() >= until:
            return count


def run(ctx):
    import torch

    cell = ctx.cell
    tr, cfg, cm = cell.traffic, cell.config, cell.config_module
    _codec.precision(cfg)
    w = weights_lib.make(cm.spec(cfg), weights_lib.sub_seed(
        ctx.seed, _codec.WEIGHTS), ctx.device)
    model = cm.model(cfg, w, ctx.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=tr["lr"])
    step = cm.train_step(model, optimizer)
    pool = textures.pool(tr["pool"], tr["height"], tr["width"],
                         weights_lib.sub_seed(ctx.seed, _codec.IMAGES),
                         ctx.device)
    feed = Feed(ctx, pool)
    params = dict(model.named_parameters())
    fed, metrics, first_grad = [], [], None
    for _ in range(check_train.STEPS):
        batch, noise = feed()
        out = step(batch, u=noise)
        fed.append((batch, noise))
        metrics.append(tuple(float(out[k]) for k in ("loss", "bpp", "mse")))
        if first_grad is None:
            first_grad = {
                k: float(torch.linalg.vector_norm(
                    optimizer.state[p]["exp_avg"]) / (1 - check_train.BETAS[0]))
                if p in optimizer.state else 0.0 for k, p in params.items()}
    change = {k: float(torch.linalg.vector_norm(p.detach() - w[k]))
              for k, p in params.items()}
    start = ctx.window_opens()
    steps = _steps(step, feed, start + ctx.seconds)
    _codec.sync(ctx.device)
    window_s = clock() - start
    summary = None
    traced_steps = 0
    t_trace = clock()
    if ctx.trace:
        seconds = min(ctx.seconds, harness.TRACE_SECONDS)
        traced_steps, summary = trace_lib.traced(
            lambda: _steps(step, feed, clock() + seconds, spans=True), ctx.device)
    t_trace = clock() - t_trace
    # A step that went wrong anywhere in the window leaves a non-finite
    # weight behind.
    failed = int(not all(bool(torch.isfinite(p).all())
                         for p in params.values()))
    peak = _codec.memory_peak(ctx.device)
    del model, optimizer, step, params
    _codec.free(ctx.device)
    t_ref = clock()
    reference = check_train.reference_steps(
        cell.reference, cfg, w, [b for b, _ in fed], [u for _, u in fed],
        tr["lr"])
    numbers = check_train.gaps((metrics, first_grad, change), reference)
    notes = dict(window_s=window_s, trace_s=t_trace, steps=steps,
                 traced_steps=traced_steps,
                 reference_s=clock() - t_ref, first_steps=metrics, **numbers)
    fwd = sum(cm.flops(cfg, tr["crop"], tr["crop"]).values()) * tr["batch"]
    observed = dict(steps=steps, window_s=window_s, step_flops=3 * fwd,
                    trace=summary)
    return harness.Outcome(
        attempted=steps, failed=failed,
        end_to_end=dict(train_step_ms=window_s / steps * 1e3),
        observed=observed,
        checks={k: numbers.get(k) for k in cell.limits},
        memory_peak_bytes=peak, trace=summary, notes=notes)
