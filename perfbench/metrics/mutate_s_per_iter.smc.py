"""Phase C's host seconds an iteration (``phases.mutate``: resample, the
sweep, the history push), over the whole window. Moves ``device_s_per_iter``."""


def read(v):
    c = v.counts
    return c["phase_s"]["mutate"] / c["iterations"] if c.get("iterations") else None
