"""Each roofline's flops and bytes: the frozen copies in perfbench/arith.py
against chip_smoke.py's made_bounds and coupling_bounds, at two shapes."""

import pytest
import torch

import chip_smoke
from perfbench.arith import coupling_bounds, made_bounds
from perfbench.peaks import FP32_FLOPS, HBM_BYTES, bound_s
from pocomc_tpu_torch.models.flow import Flow


def _ms(flops_bytes):
    return bound_s(*flops_bytes) * 1e3


def test_peaks_are_chip_smokes():
    assert (FP32_FLOPS, HBM_BYTES) == (chip_smoke.FP32_FLOPS, chip_smoke.HBM_BYTES)


@pytest.mark.parametrize("d,n,flow,bins", [(50, 1024, "nsf6", 8), (10, 2048, "nsf6", 8),
                                           (7, 256, "nsf3", 16)])
def test_made_bounds(d, n, flow, bins):
    want = chip_smoke.made_bounds(n, Flow(d, flow, bins=bins, device="cpu"))
    got = made_bounds(n, d, bins, flow)
    for k in want:
        assert _ms(got[k]) == pytest.approx(want[k][0], rel=1e-12), k


@pytest.mark.parametrize("d,n,flow,bins", [(50, 65536, "nsfc12", 8), (9, 1024, "nsfc6", 8),
                                           (10, 4096, "nsfc3", 32)])
def test_coupling_bounds(d, n, flow, bins):
    want = chip_smoke.coupling_bounds(n, Flow(d, flow, bins=bins, device="cpu"))
    got = coupling_bounds(n, d, bins, flow)
    for k in want:
        assert _ms(got[k]) == pytest.approx(want[k][0], rel=1e-12), k


def test_flop_counts_are_the_products():
    """At a size where the bytes bound, the flops still count every masked
    multiply-add twice: K2's forward at n rows is 2 n sum(masks)."""
    f = Flow(5, "nsf6", device="cpu")
    total = sum(int(m.sum()) for m in f.masks)
    assert made_bounds(3, 5)["made_rqs_forward"][0] == 2 * 3 * total
    torch.manual_seed(0)
