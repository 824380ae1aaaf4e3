"""Host milliseconds a sweep step takes to enqueue (the program's
``sweep_step`` spans less their ``read`` of the stopping rule: noise, the
proposal through K5's inverse, the likelihood, the accept step), over the
steps of the first ``TRACE_CALLS`` traced sweep calls (the device
stretch). Moves ``psteps_per_s``."""

from perfbench import spans
from perfbench.generators.sweep import TRACE_CALLS


def read(v):
    return spans.mean_ms(spans.seconds_less_children(spans.sweep_stretch(TRACE_CALLS),
                                                     "sweep_step", ("read",)))
