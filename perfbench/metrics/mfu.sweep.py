"""The traced sweep calls' share of the card's fp32 peak: the flow's
product flops (particle-steps through K5's inverse, and each call's start
through K5's forward) over the stretch's seconds at 67 TFLOP/s (no tensor
cores: TF32 is off). Moves ``psteps_per_s``."""

from perfbench.arith import coupling_bounds


def read(v):
    d, bins, flow = int(v.cfg["n_dim"]), int(v.cfg["bins"]), v.cfg["flow"]
    b = lambda n, k: coupling_bounds(n, d, bins, flow)[k][0]
    flops = (sum(b(n, "coupling_inverse") for n in v.rows.get("k5inv", []))
             + sum(b(n, "coupling_forward") for n in v.rows.get("k5", [])))
    return v.mfu(flops)
