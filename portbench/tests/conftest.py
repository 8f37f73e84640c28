"""Fixtures of the benchmark's CPU tests: cells cut to a size the CPU runs
in seconds (the configurations' widths divided, images of 128 x 192), and
a check for a CUDA device made inside a fixture."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

TINY = {
    "bmshj2018": dict(num_filters=16),
    "hific": dict(num_filters_base=4, num_filters_bottleneck=12,
                  num_residual_blocks=1, hyper_filters=16),
}


def tiny_cell(name):
    """The cell ``name`` with its configuration's widths cut and its
    traffic at 128 x 192 images (crops of 64 for training)."""
    cell = harness.resolve(name)
    cell.config = dict(cell.config, **TINY[cell.config["name"]])
    tr = dict(cell.traffic, pool=3, height=128, width=192)
    if "crop" in tr:
        tr.update(crop=64, batch=2, height=128, width=128)
    else:
        tr.update(check=2, warmup=1)
    cell.traffic = tr
    return cell


def run_tiny(name, seconds=0.5, seed=2**33 + 7, trace=False, cell=None):
    """(result line, outcome) of a tiny run of ``name`` on the CPU."""
    cell = cell or tiny_cell(name)
    ctx = harness.Context(cell=cell, device=torch.device("cpu"), seed=seed,
                          seconds=seconds, trace=trace, t0=harness.clock())
    outcome = cell.loop.run(ctx)
    line, _ = harness.result_line(cell, outcome, ctx.setup_s, trace,
                                  {"platform": "cpu"})
    return line, outcome


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
