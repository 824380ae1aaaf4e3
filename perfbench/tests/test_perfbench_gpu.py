"""The benchmark on the card: each cell's command, a short window, correct
and every metric it reports. Marked ``gpu``: without a CUDA device every
test here skips. On a machine with one, from the checkout's root:
``python3 -m pytest perfbench/tests/test_perfbench_gpu.py -q -m gpu``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import harness

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in harness.load_spec(ROOT)["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace, cuda):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 99), "--seconds", "8", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    files = harness.resolve(harness.load_spec(ROOT), cell)
    want = files["per_layer"] if trace else files["end_to_end"]
    assert {m["name"] for m in want} == set(r["metrics"])
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
