"""The control of ``correct``: the plain reference one precision below the
configuration's float32 (TF32 products for the flows, bfloat16 for the
rest), put in the program's place, has to fail the cell's limits, and so
has each fault the generator reads beside it (gauss50's training step on
half of each batch). The route is ``calibrate.py``'s (``run_cell`` with
``calibrate``), here at the CPU test's sizes; on the card at the cells'
own sizes, whose readings PERF.md gives."""

import pytest

from conftest import TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    r = run_tiny(cell, seed=5, seconds=2.0, calibrate=True)
    assert r["correct"], r["checks"]
    assert r["calibration"] and "control" in r["calibration"]
    for mode, c in r["calibration"].items():
        assert not c["correct"], (mode, c["checks"])
