"""The harness: finds a cell's configuration, traffic, limits and per-layer
metrics by their names, runs the cell's loop, and prints the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in files of its own:

* ``BENCHMARK.json`` names each cell's configuration and traffic, and
  each metric with the cells that report it;
* ``configs/<config>.json`` holds the configuration as it is run, and
  ``configs/<config>.py`` makes its weights and builds the program on
  them; its plain reference is ``reference/<reference>.py``;
* ``traffic/<traffic>.json`` holds a mix's parameters, and the name of the
  loop in ``loops/`` that drives it;
* ``limits/<cell>.json`` holds the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py`` reads one per-layer metric from what the loop
  observed; it returns None when it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Top-level modules that no run may load: JAX and the JAX package, whose
# name the port's begins with (so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "compression_tpu")

# The traced window of a --trace 1 run is at most this long (s).
TRACE_SECONDS = 10.0

# Window boundaries are read from the host clock.
clock = time.perf_counter


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_metric_reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Cell:
    """One cell, resolved by name."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def config_module(self):
        return importlib.import_module(
            f"portbench.configs.{self.config['name']}")

    @property
    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['reference']}")

    @property
    def loop(self):
        return importlib.import_module(
            f"portbench.loops.{self.traffic['loop']}")


def resolve(workload, bench=None):
    """The cell named ``workload`` of BENCHMARK.json, with its files."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(HERE, "configs", f"{w['config']}.json"),
        traffic=load_json(HERE, "traffic", f"{w['traffic']}.json"),
        limits=load_json(HERE, "limits", f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Outcome:
    """What a loop hands back.

    ``end_to_end``: {metric: value} of the untraced window; ``observed``:
    what the per-layer readers read; ``checks``: {number: value} compared
    with the cell's limits; ``trace``: the traced window's summary, when
    there is one."""

    attempted: int
    failed: int
    end_to_end: dict
    observed: dict
    checks: dict
    memory_peak_bytes: int
    trace: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def percentile(values, q):
    """The q-th percentile, linear between order statistics (None of no
    values)."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def result_line(cell, outcome, setup_s, trace, device_info):
    """The result's JSON object and the checks' lines for standard error."""
    checks = {}
    correct = outcome.failed == 0
    for name, value in outcome.checks.items():
        limit = cell.limits[name]
        ok = value is not None and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_metric_reader(m["name"])(outcome.observed)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=outcome.memory_peak_bytes)
    line = {"correct": bool(correct), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace:
        device["busy_s"] = outcome.trace["busy_s"]
        device["window_s"] = outcome.trace["window_s"]
        line["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                             "idle_gaps": outcome.trace["idle_gaps"]}
    line["checks"] = checks
    lines = [f"check {k} {v['value']} limit {v['limit']}"
             for k, v in checks.items()]
    return line, lines


def run(args, t0):
    """One run of one cell; returns the process's exit code."""
    try:
        cell = resolve(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    ctx = Context(cell=cell, device=device, seed=int(args.seed),
                  seconds=float(args.seconds), trace=bool(args.trace), t0=t0)
    outcome = cell.loop.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line, lines = result_line(cell, outcome, ctx.setup_s, ctx.trace, info)
    print("portbench: " + json.dumps(dict(outcome.notes,
                                          setup_s=ctx.setup_s)),
          file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


@dataclasses.dataclass
class Context:
    """A run's settings, and the set-up clock: a loop calls
    ``window_opens`` when set-up ends."""

    cell: Cell
    device: object
    seed: int
    seconds: float
    trace: bool
    t0: float
    setup_s: float = 0.0

    def window_opens(self):
        import torch

        if getattr(self.device, "type", "") == "cuda":
            torch.cuda.synchronize(self.device)
        now = clock()
        self.setup_s = now - self.t0
        return now
