"""Plain log-priors of the configurations' prior specifications."""

from __future__ import annotations

import math

import torch


def log_prior(x, spec):
    """Sum over the dimensions of the prior's log density at rows x."""
    if spec["kind"] == "normal":
        loc, scale = float(spec["loc"]), float(spec["scale"])
        r = (x - loc) / scale
        return (-0.5 * r * r - math.log(scale) - 0.5 * math.log(2 * math.pi)).sum(-1)
    raise ValueError(f"no plain prior for {spec['kind']!r}")
