"""The whole iteration's share of the card's fp32 peak: the flow's product
flops in the traced iteration (rows trained through K2's forward and
backward, rows validated and refitted through K2's forward, particle-steps
through K1) over the stretch's seconds at 67 TFLOP/s (no tensor cores:
TF32 is off). Moves ``device_s_per_iter``."""

from perfbench.arith import made_bounds


def read(v):
    d, bins, flow = int(v.cfg["n_dim"]), int(v.cfg["bins"]), v.cfg["flow"]
    b = lambda n, k: made_bounds(n, d, bins, flow)[k][0]
    rows = v.rows
    flops = (sum(b(n, "made_rqs_forward") for n in rows.get("k2", []) + rows.get("k2_train", []))
             + sum(b(n, "made_rqs_backward") for n in rows.get("k2_bwd", []))
             + sum(b(n, "ar_inverse") for n in rows.get("k1", [])))
    return v.mfu(flops)
