"""BENCHMARK.json resolves to files found by name, a new cell and metric
are found as new files, and nothing loads JAX."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    for attr in ("config_module", "reference", "loop"):
        assert getattr(c, attr) is not None
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(harness.load_metric_reader(m["name"]))


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_a_new_cell_and_metric_are_found_as_new_files(tmp_path):
    """A copy gains a traffic mix, a cell's limits and a metric reader as
    new files, and entries in BENCHMARK.json; no other file changes."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="bmshj2018.tfci-small", config="bmshj2018",
        traffic="small_tfci", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(
        name="requests.compress", unit="count", better="higher",
        source="host_clock", layer="codec entry points",
        moves="compress_p95_ms", workloads=["bmshj2018.tfci-small"]))
    for m in bench["end_to_end"]:
        if m["name"] == "compress_p95_ms":
            m["workloads"].append("bmshj2018.tfci-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = dict(harness.load_json(harness.HERE, "traffic",
                                     "kodak_tfci.json"), height=256)
    (tmp_path / "portbench/traffic/small_tfci.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits/bmshj2018.tfci-small.json").write_text(
        json.dumps({"latent_mismatch": 0.0}))
    (tmp_path / "portbench/metrics/requests.compress.py").write_text(
        "def read(observed):\n    return len(observed['compress_ms'])\n")
    code = (
        "from portbench import harness\n"
        "c = harness.resolve('bmshj2018.tfci-small')\n"
        "assert c.traffic['height'] == 256, c.traffic\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert 'requests.compress' in names, names\n"
        "read = harness.load_metric_reader('requests.compress')\n"
        "assert read({'compress_ms': [1.0, 2.0]}) == 2\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the harness and the port's entry points load
    without JAX; names are compared whole (the port's name begins with
    the JAX package's)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import portbench\n"
        "from portbench import harness, calibrate, faults\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from compression_tpu_torch.models import bmshj2018, hific, bls2017\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "compression_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    found = harness.forbidden_modules()
    assert "compression_tpu_torch_x" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(harness.HERE, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".", 1)[0]
                assert top in {"torch", "numpy", "portbench", "math",
                               "bisect", "struct", "contextlib",
                               "__future__"}, (name, mod)
                if top == "portbench":
                    assert mod.startswith("portbench.reference"), (name, mod)
