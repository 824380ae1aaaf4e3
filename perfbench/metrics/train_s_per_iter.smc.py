"""Phase B's host seconds an iteration (``phases.train``: the fit and the
geometry refit), over the whole window. Moves ``device_s_per_iter``."""


def read(v):
    c = v.counts
    return c["phase_s"]["train"] / c["iterations"] if c.get("iterations") else None
