"""K1 (``ar_inverse``, the autoregressive inverse of a sweep step's
proposals) against its bound: the least seconds of the traced calls'
products and bytes at the fp32 peak and HBM rate, over the device seconds
of the kernels each call ran. Moves ``device_s_per_iter``."""

from perfbench.arith import made_bounds


def read(v):
    d, bins, flow = int(v.cfg["n_dim"]), int(v.cfg["bins"]), v.cfg["flow"]
    return v.roofline("k1", "k1", lambda n: made_bounds(n, d, bins, flow)["ar_inverse"])
