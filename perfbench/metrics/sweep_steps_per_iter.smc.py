"""Sweep steps an iteration of phase C (each step one proposal a particle
through K1 and the likelihood), over the whole window. Moves ``device_s_per_iter``."""


def read(v):
    c = v.counts
    return c["sweep_steps"] / c["iterations"] if c.get("iterations") else None
