"""The share of the traced iteration in which no operation ran on the
card (one less the union of the device's operations over the stretch's
host seconds). Moves ``device_s_per_iter``."""


def read(v):
    return v.idle_percent()
