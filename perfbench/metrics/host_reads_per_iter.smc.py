"""The host's blocking reads of the card in the traced iteration (the
program's ``read`` spans in its device stretch: an epoch's loss, a sweep
step's stopping rule, the geometry fit's EM test, host values copied to
the card, the iteration's stats). Moves ``device_s_per_iter`` (the host's
pace first)."""

from perfbench import spans


def read(v):
    return spans.count(spans.iteration_stretch(), "read")
