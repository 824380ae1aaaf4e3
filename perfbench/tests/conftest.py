"""Shared pieces of the benchmark's own tests (``pytest perfbench/tests``
from the checkout's root): the cells at sizes a CPU test holds, run through
the harness on the program's plain versions."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell cut to a CPU test's size: the same code paths, tiny widths
TINY = {
    "gauss50.smc": {"config": {"n_dim": 4, "sampler": {"n_effective": 128, "n_active": 64},
                               "run": {"n_total": 256, "n_evidence": 256}}},
    "rosen50_nsfc12.sweep": {"config": {"n_dim": 6}, "traffic": {"particles": 256}},
}


def run_tiny(cell, seed=7, seconds=2.0, trace=False, **kw):
    import torch
    from perfbench import harness
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, trace, cuda=False, overrides=TINY[cell], **kw)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
