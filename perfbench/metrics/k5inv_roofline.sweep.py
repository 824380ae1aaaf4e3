"""K5's inverse (``coupling_inverse``) against its bound: the least
seconds of the traced calls' products and bytes at the fp32 peak and HBM
rate, over the device seconds of the kernels each call ran. Moves
``psteps_per_s``."""

from perfbench.arith import coupling_bounds


def read(v):
    d, bins, flow = int(v.cfg["n_dim"]), int(v.cfg["bins"]), v.cfg["flow"]
    return v.roofline("k5inv", "k5inv",
                      lambda n: coupling_bounds(n, d, bins, flow)["coupling_inverse"])
