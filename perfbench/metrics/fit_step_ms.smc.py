"""Milliseconds an optimizer step of phase B's fits: the train span's host
seconds over the fits' steps (epochs run times batches an epoch), over
the whole window. Moves ``device_s_per_iter``."""


def read(v):
    c = v.counts
    return 1e3 * c["phase_s"]["train"] / c["fit_steps"] if c.get("fit_steps") else None
