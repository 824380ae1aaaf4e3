"""The device loop's host seconds an iteration: the window's seconds from
its start (the prior stage and the first fit inside) to the first traced
iteration, over the iterations completed in them. The host paces it, and
its runs spread with the host's load. Moves ``device_s_per_iter``."""


def read(v):
    c = v.counts
    return c["seconds"] / c["iterations"] if c.get("iterations") else None
