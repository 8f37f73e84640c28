"""Judges a training step's first three steps against the plain reference.

The reference starts from the same weights, takes the same three batches
and the same noise, and steps with Adam written out (TFC's trainer, Adam
at the cell's learning rate, beta 0.9 / 0.999, eps 1e-8).  Three numbers:

* ``loss_gap``: the largest relative gap of the loss, bpp or mse of any
  of the three steps;
* ``grad_gap``: the first gradient as the optimizer got it (the program's
  first moment after one step over 1 - beta1), the worst leaf's gap of
  norms over the larger of that leaf's reference norm and the median
  leaf's;
* ``update_gap``: the same for the change of the parameters over the
  three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the last two: under Adam they move by round-off
alone.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops as ops_lib

BETAS = (0.9, 0.999)
EPS = 1e-8
STEPS = 3


def reference_steps(model, cfg, w0, batches, noises, lr, tf32=False):
    """(metrics [(loss, bpp, mse)] * 3, first gradient {name: norm},
    change after the steps {name: norm}) of the reference."""
    ops = ops_lib.Ops(tf32=tf32)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    metrics, first_grad = [], None
    with ops.precision():
        for t, (x, (u_z, u_y)) in enumerate(zip(batches, noises), start=1):
            for p in params.values():
                p.grad = None
            loss, bpp, mse = model.forward_train(ops, params, x, u_z, u_y,
                                                 cfg)
            loss.backward()
            metrics.append(tuple(float(v.detach()) for v in (loss, bpp, mse)))
            with torch.no_grad():
                if first_grad is None:
                    first_grad = {k: float(torch.linalg.vector_norm(
                        p.grad if p.grad is not None
                        else torch.zeros_like(p)))
                        for k, p in params.items()}
                for k, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    m_hat = m[k] / (1 - BETAS[0] ** t)
                    v_hat = v2[k] / (1 - BETAS[1] ** t)
                    p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - w0[k]))
              for k in params}
    return metrics, first_grad, change


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def gaps(program, reference):
    """The three numbers (module docstring) of ``program`` against
    ``reference``, each a (metrics, first gradient, change) triple."""
    p_metrics, p_grad, p_change = program
    r_metrics, r_grad, r_change = reference
    loss_gap = 0.0
    for p_row, r_row in zip(p_metrics, r_metrics):
        for a, b in zip(p_row, r_row):
            gap = abs(a - b) / max(abs(b), 1e-30)
            loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    med_grad = _median(list(r_grad.values()))
    counted = [k for k, g in r_grad.items() if g >= 1e-3 * med_grad]

    def worst(p, r):
        med = _median([r[k] for k in counted])
        out = 0.0
        for k in counted:
            gap = abs(p.get(k, 0.0) - r[k]) / max(r[k], med, 1e-30)
            out = max(out, gap if math.isfinite(gap) else math.inf)
        return out

    return dict(loss_gap=loss_gap, grad_gap=worst(p_grad, r_grad),
                update_gap=worst(p_change, r_change),
                leaves_counted=len(counted), leaves=len(r_grad))
