"""Priors: a product of independent 1-D distributions (torch).

Counterpart of ``pocomc_tpu/prior.py``: twelve distributions, the
conversion of scipy.stats frozen distributions into them, and ``Prior``,
the duck-typed protocol the sampler relies on (``logpdf`` / ``rvs`` /
``bounds`` / ``dim``). A distribution's ``logpdf`` takes a (n,) tensor on
any device and returns (n,), -inf outside its support; ``sample`` and
``rvs`` draw on the host in float64 numpy from a numpy generator or seed.
Parameters are scipy's (``TruncatedNormal`` takes ``a, b`` in
standard-normal units, ``LogNormal`` is ``lognorm(s, loc, scale)``).

A ``Prior`` whose columns are all of this module, or scipy.stats
distributions of the twelve families, is ``traceable``: its ``logpdf``
maps an (n, d) tensor to (n,) on the tensor's device. Any other column
(an unknown scipy family, an object with ``logpdf``/``rvs``/``support``)
makes the whole prior a host one: ``logpdf`` then runs in numpy on host
rows, and the sampler routes it through the host (``sampler.make_logprior``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


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


class LogUniform(BaseDist):
    def __init__(self, low, high):
        self.low, self.high = float(low), float(high)
        self._norm = math.log(math.log(high / low))

    def logpdf(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -torch.log(x) - self._norm, -math.inf)

    def sample(self, rng, size):
        return self.low * np.exp(rng.random(size) * math.log(self.high / self.low))

    def support(self):
        return (self.low, self.high)


class TruncatedNormal(BaseDist):
    """scipy.truncnorm parameterization: a, b in standard-normal units."""

    def __init__(self, a, b, loc=0.0, scale=1.0):
        self.a, self.b = float(a), float(b)
        self.loc, self.scale = float(loc), float(scale)
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        self._log_mass = math.log(max(cdf(self.b) - cdf(self.a), 1e-300))

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        inside = (z >= self.a) & (z <= self.b)
        lp = -0.5 * z * z - (_LOG_SQRT_2PI + math.log(self.scale) + self._log_mass)
        return torch.where(inside, lp, -math.inf)

    def sample(self, rng, size):
        from scipy.stats import truncnorm
        return self.loc + self.scale * truncnorm.rvs(self.a, self.b, size=size,
                                                     random_state=rng)

    def support(self):
        return (self.loc + self.a * self.scale, self.loc + self.b * self.scale)


class LogNormal(BaseDist):
    """scipy.lognorm(s, loc=0, scale): log(x) ~ N(log(scale), s^2)."""

    def __init__(self, s, loc=0.0, scale=1.0):
        self.s, self.loc, self.scale = float(s), float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        # the smallest normal of x's type: a float64 floor (1e-300) is 0 in
        # float32, where log would give -inf inside the support's edge
        log_y = torch.log(torch.clamp(y, min=torch.finfo(y.dtype).tiny))
        lp = (-log_y - 0.5 * (log_y / self.s) ** 2
              - (math.log(self.s) + _LOG_SQRT_2PI + math.log(self.scale)))
        return torch.where(y > 0, lp, -math.inf)

    def sample(self, rng, size):
        return self.loc + self.scale * np.exp(self.s * rng.standard_normal(size))

    def support(self):
        return (self.loc, np.inf)


class Beta(BaseDist):
    def __init__(self, a, b, loc=0.0, scale=1.0):
        self.a, self.b = float(a), float(b)
        self.loc, self.scale = float(loc), float(scale)
        self._const = (math.lgamma(self.a + self.b) - math.lgamma(self.a)
                       - math.lgamma(self.b) - math.log(self.scale))

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        # xlogy / xlog1py: a = 1 at y = 0 (b = 1 at y = 1) gives a finite
        # density, as scipy's
        lp = (torch.special.xlogy(self.a - 1.0, y)
              + torch.special.xlog1py(self.b - 1.0, -y) + self._const)
        return torch.where((y >= 0) & (y <= 1), lp, -math.inf)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.beta(self.a, self.b, size)

    def support(self):
        return (self.loc, self.loc + self.scale)


class Gamma(BaseDist):
    def __init__(self, a, loc=0.0, scale=1.0):
        self.a, self.loc, self.scale = float(a), float(loc), float(scale)
        self._const = math.lgamma(self.a) + math.log(self.scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        lp = torch.special.xlogy(self.a - 1.0, y) - y - self._const
        return torch.where(y >= 0, lp, -math.inf)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.standard_gamma(self.a, size)

    def support(self):
        return (self.loc, np.inf)


class Exponential(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        return torch.where(y >= 0, -y - math.log(self.scale), -math.inf)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.standard_exponential(size)

    def support(self):
        return (self.loc, np.inf)


class HalfNormal(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        lp = 0.5 * math.log(2.0 / math.pi) - 0.5 * y * y - math.log(self.scale)
        return torch.where(y >= 0, lp, -math.inf)

    def sample(self, rng, size):
        return self.loc + self.scale * np.abs(rng.standard_normal(size))

    def support(self):
        return (self.loc, np.inf)


class Cauchy(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -torch.log1p(z * z) - math.log(math.pi * self.scale)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.standard_cauchy(size)

    def support(self):
        return (-np.inf, np.inf)


class StudentT(BaseDist):
    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = float(df), float(loc), float(scale)
        self._const = (math.lgamma(0.5 * (self.df + 1.0)) - math.lgamma(0.5 * self.df)
                       - 0.5 * math.log(self.df * math.pi * self.scale ** 2))

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return self._const - 0.5 * (self.df + 1.0) * torch.log1p(z * z / self.df)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.standard_t(self.df, size)

    def support(self):
        return (-np.inf, np.inf)


class Laplace(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        return -torch.abs(x - self.loc) / self.scale - math.log(2.0 * self.scale)

    def sample(self, rng, size):
        return self.loc + self.scale * rng.laplace(0.0, 1.0, size)

    def support(self):
        return (-np.inf, np.inf)


# ---------------------------------------------------------------------------
# scipy.stats frozen distribution conversion
# ---------------------------------------------------------------------------

def _convert_scipy(dist):
    """The distribution of this module a scipy.stats frozen distribution
    stands for (the JAX package's twelve families, read from positional
    or keyword arguments alike), or None for any other object. Parameters
    a family's class cannot take raise here, where the JAX package returns
    None and so moves the column to the host."""
    name = getattr(getattr(dist, "dist", None), "name", None)
    if name is None:
        return None
    args = tuple(dist.args)
    kwds = dict(dist.kwds)

    def get(i, keyname, default):
        if keyname in kwds:
            return kwds[keyname]
        if len(args) > i:
            return args[i]
        return default

    if name == "norm":
        return Normal(get(0, "loc", 0.0), get(1, "scale", 1.0))
    if name == "uniform":
        loc, scale = get(0, "loc", 0.0), get(1, "scale", 1.0)
        return Uniform(loc, loc + scale)
    if name == "truncnorm":
        return TruncatedNormal(get(0, "a", -np.inf), get(1, "b", np.inf),
                               get(2, "loc", 0.0), get(3, "scale", 1.0))
    if name == "lognorm":
        return LogNormal(get(0, "s", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
    if name == "beta":
        return Beta(get(0, "a", 1.0), get(1, "b", 1.0),
                    get(2, "loc", 0.0), get(3, "scale", 1.0))
    if name == "gamma":
        return Gamma(get(0, "a", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
    if name == "expon":
        return Exponential(get(0, "loc", 0.0), get(1, "scale", 1.0))
    if name == "halfnorm":
        return HalfNormal(get(0, "loc", 0.0), get(1, "scale", 1.0))
    if name == "cauchy":
        return Cauchy(get(0, "loc", 0.0), get(1, "scale", 1.0))
    if name == "t":
        return StudentT(get(0, "df", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
    if name == "laplace":
        return Laplace(get(0, "loc", 0.0), get(1, "scale", 1.0))
    if name == "loguniform":
        return LogUniform(get(0, "a", 1.0), get(1, "b", 10.0))
    return None


def seeded_rvs(dist, size, seed):
    """``dist.rvs(size=size, random_state=seed)``; for an ``rvs`` without
    ``random_state`` (``TypeError``), the draw runs under the global
    ``np.random`` seeded with ``seed``, whose state is restored after, so
    a fixed seed still repeats the draw."""
    try:
        return dist.rvs(size=size, random_state=seed)
    except TypeError:
        saved = np.random.get_state()
        try:
            np.random.seed(seed)
            return dist.rvs(size=size)
        finally:
            np.random.set_state(saved)


class Prior:
    """Product of independent 1-D distributions: of this module, scipy.stats
    frozen distributions (converted when their family is one of the
    twelve), or any object with ``logpdf``/``rvs``/``support``.
    ``traceable`` is True when every column has a distribution of this
    module (see module docstring)."""

    def __init__(self, dists):
        self.dists = list(dists)
        self._native = [d if isinstance(d, BaseDist) else _convert_scipy(d)
                        for d in self.dists]
        self.traceable = all(nd is not None for nd in self._native)

    @property
    def dim(self):
        return len(self.dists)

    @property
    def bounds(self):
        return np.array([nd.support() if nd is not None else tuple(d.support())
                         for d, nd in zip(self.dists, self._native)], dtype=np.float64)

    def logpdf(self, x):
        """Log prior density of an (n, d) tensor (traceable prior), or of
        host rows (n, d) in numpy, returning float64 numpy."""
        if self.traceable:
            lp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for i, nd in enumerate(self._native):
                lp = lp + nd.logpdf(x[:, i])
            return lp
        x = np.asarray(x)
        lp = np.zeros(len(x))
        for i, d in enumerate(self.dists):
            if isinstance(d, BaseDist):
                lp += d.logpdf(torch.as_tensor(x[:, i])).numpy()
            else:
                lp += np.asarray(d.logpdf(x[:, i]), dtype=np.float64)
        return lp

    def rvs(self, size=1, random_state=None):
        """(size, d) host float64 draws; each column from its own child
        seed, a column of no distribution of this module through
        ``seeded_rvs``."""
        rng = np.random.default_rng(random_state)
        seeds = rng.integers(0, 2**31 - 1, size=len(self.dists))
        cols = [nd.rvs(size, int(s)) if nd is not None else seeded_rvs(d, size, int(s))
                for d, nd, s in zip(self.dists, self._native, seeds)]
        return np.stack([np.asarray(c, dtype=np.float64).reshape(size) for c in cols],
                        axis=1)
