"""The share of the traced sweep calls in which no operation ran on the
card (one less the union of the device's operations over the stretch's
host seconds). Moves ``psteps_per_s``."""


def read(v):
    return v.idle_percent()
