"""On the card: one short run of each cell prints a correct result
(``python3 -m pytest --noconftest -m cuda portbench/tests`` runs it there;
without a CUDA device it skips)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, cuda_device):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         cell, "--seed", str(2**31 + 17), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
