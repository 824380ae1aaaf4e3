"""Priors: a product of independent 1-D distributions (torch).

Counterpart of ``pocomc_tpu/prior.py`` for ``Prior``, ``Normal`` and
``Uniform``: the duck-typed protocol the sampler relies on (``logpdf`` /
``rvs`` / ``bounds`` / ``dim``). ``logpdf`` takes an (n, d) tensor on any
device and returns (n,); ``rvs`` draws on the host in f64 numpy from a
numpy seed. The other ten distributions and the conversion of scipy.stats
frozen distributions are not ported yet (ROADMAP.md, port queue: priors).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class BaseDist:
    """1-D distribution protocol: logpdf (tensor) / sample (numpy) / support."""

    def logpdf(self, x):
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        raise NotImplementedError

    def support(self):
        raise NotImplementedError

    def rvs(self, size=1, random_state=None):
        return self.sample(np.random.default_rng(random_state), int(size))


class Normal(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        return -0.5 * y * y - math.log(self.scale) - 0.5 * math.log(2 * math.pi)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.standard_normal(size)

    def support(self):
        return (-np.inf, np.inf)


class Uniform(BaseDist):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def logpdf(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -math.log(self.high - self.low), -math.inf)

    def sample(self, rng, size):
        return rng.uniform(self.low, self.high, size)

    def support(self):
        return (self.low, self.high)


class Prior:
    """Product of independent 1-D distributions of this module."""

    def __init__(self, dists):
        self.dists = list(dists)
        for d in self.dists:
            if not isinstance(d, BaseDist):
                raise NotImplementedError(
                    f"{type(d).__name__}: only pocomc_tpu_torch.Normal and "
                    f"Uniform are ported; scipy.stats conversion and the other "
                    f"distributions wait for their ROADMAP.md item (priors)")

    @property
    def dim(self):
        return len(self.dists)

    @property
    def bounds(self):
        return np.array([d.support() for d in self.dists], dtype=np.float64)

    def logpdf(self, x):
        """Log prior density of an (n, d) tensor."""
        lp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i, d in enumerate(self.dists):
            lp = lp + d.logpdf(x[:, i])
        return lp

    def rvs(self, size=1, random_state=None):
        """(size, d) host f64 draws; each column from its own child seed."""
        rng = np.random.default_rng(random_state)
        seeds = rng.integers(0, 2**31 - 1, size=len(self.dists))
        return np.stack([d.rvs(size, int(s)) for d, s in zip(self.dists, seeds)],
                        axis=1).astype(np.float64)
