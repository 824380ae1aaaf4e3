"""Host milliseconds an optimizer step of phase B's fit takes to enqueue
(the program's ``step`` spans: forward, backward, clip and AdamW, with no
read inside), over the steps of the traced iteration's device stretch.
Moves ``device_s_per_iter`` (the host's pace, ``iter_s.smc``, first)."""

from perfbench import spans


def read(v):
    return spans.mean_ms(spans.seconds_less_children(spans.iteration_stretch(), "step", ()))
