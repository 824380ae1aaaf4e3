"""K2's backward (``made_rqs_backward``: its pack and backward kernels and
the weight-gradient products) against its bound: the least seconds of the
traced calls' products and bytes at the fp32 peak and HBM rate, over the
device seconds of the kernels each call ran. Moves ``device_s_per_iter``."""

from perfbench.arith import made_bounds


def read(v):
    d, bins, flow = int(v.cfg["n_dim"]), int(v.cfg["bins"]), v.cfg["flow"]
    return v.roofline("k2bwd", "k2_bwd", lambda n: made_bounds(n, d, bins, flow)["made_rqs_backward"])
