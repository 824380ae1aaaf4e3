"""rosen50_nsfc12's likelihood: the chained 50-D Rosenbrock of coefficient
100 under N(0, 3^2) priors (``bench.py:276-286``). Plain torch in any
dtype: the program runs it in float32, the reference in float64 and the
control in bfloat16. Its evidence has no closed form."""

from __future__ import annotations

import torch


class Likelihood:
    def __init__(self, cfg):
        self.a = float(cfg["likelihood"]["coefficient"])

    def __call__(self, x):
        return -(self.a * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2).sum(-1)


def truth(cfg):
    return None
