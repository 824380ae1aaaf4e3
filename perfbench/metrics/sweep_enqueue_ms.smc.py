"""Host milliseconds a sweep step of phase C takes to enqueue (the
program's ``sweep_step`` spans less their ``read`` of the stopping rule:
noise, the proposal through K1, the likelihood, the accept step), over the
steps of the traced iteration's device stretch. Moves
``device_s_per_iter`` (the host's pace first)."""

from perfbench import spans


def read(v):
    return spans.mean_ms(spans.seconds_less_children(spans.iteration_stretch(), "sweep_step",
                                                     ("read",)))
