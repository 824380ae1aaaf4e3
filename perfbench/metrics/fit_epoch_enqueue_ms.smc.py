"""Host milliseconds an epoch of phase B's fit spends outside its
optimizer steps and its read (the program's ``epoch`` spans less their
``step`` and ``read`` children: the permutation, the validation and the
best-parameter snapshot), over the epochs of the traced iteration's
device stretch. Moves ``device_s_per_iter`` (the host's pace first)."""

from perfbench import spans


def read(v):
    return spans.mean_ms(spans.seconds_less_children(spans.iteration_stretch(), "epoch",
                                                     ("step", "read")))
