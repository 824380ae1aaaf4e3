"""The port's priors against the JAX package's and scipy's: the cases of
tests/test_prior.py on the port, the twelve distributions' log-densities
against the JAX classes on the same float32 points (inside the support, on
its boundary and outside it), the scipy.stats conversion and the draws."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import pocomc_tpu.prior as jprior
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch import prior as tprior
from pocomc_tpu_torch.prior import Prior, Normal, Uniform


class TestPrior:
    def setup_method(self):
        self.prior = Prior([Normal(0, 1), Uniform(0, 1)])

    def test_dim(self):
        assert self.prior.dim == 2

    def test_bounds(self):
        b = self.prior.bounds
        assert b.shape == (2, 2)
        np.testing.assert_allclose(b[1], [0.0, 1.0])
        assert b[0, 0] == -np.inf and b[0, 1] == np.inf

    def test_rvs_shape_and_support(self):
        s = self.prior.rvs(100, random_state=0)
        assert s.shape == (100, 2) and s.dtype == np.float64
        assert (s[:, 1] >= 0).all() and (s[:, 1] <= 1).all()

    def test_logpdf(self):
        lp = self.prior.logpdf(torch.tensor([[0.0, 0.5], [0.0, 0.5]]))
        # N(0,1) at 0 + U(0,1) at .5 = -0.5*log(2*pi)
        np.testing.assert_allclose(lp.numpy(), -0.5 * np.log(2 * np.pi) * np.ones(2),
                                   rtol=1e-5)

    def test_logpdf_outside_support(self):
        lp = self.prior.logpdf(torch.tensor([[0.0, 2.0]]))
        assert lp[0] == -np.inf

    def test_traceable(self):
        """A traceable prior maps tensors to tensors on their device, the
        shape-only ``meta`` probe the sampler routes by included."""
        assert self.prior.traceable
        lp = self.prior.logpdf(torch.zeros((4, 2)) + 0.5)
        assert torch.isfinite(lp).all() and lp.dtype == torch.float32
        meta = self.prior.logpdf(torch.empty((4, 2), device="meta"))
        assert meta.shape == (4,) and meta.device.type == "meta"


class TestScipyConversion:
    def test_common_dists_match_scipy(self):
        dists = [stats.norm(1.0, 2.0), stats.uniform(-3.0, 6.0), stats.expon(0.0, 2.0),
                 stats.beta(2.0, 3.0), stats.gamma(2.5), stats.cauchy(0.5, 1.5),
                 stats.laplace(0.0, 2.0), stats.t(4.0), stats.halfnorm(0.0, 1.5),
                 stats.lognorm(0.8), stats.truncnorm(-1.0, 2.0, loc=0.5, scale=2.0)]
        prior = Prior(dists)
        assert prior.traceable
        x = np.stack([p.rvs(size=50, random_state=i) for i, p in enumerate(dists)], axis=1)
        got = prior.logpdf(torch.tensor(x, dtype=torch.float64)).numpy()
        expect = sum(p.logpdf(x[:, i]) for i, p in enumerate(dists))
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)

    def test_unknown_scipy_dist_falls_back(self):
        prior = Prior([stats.skewnorm(3.0), stats.norm(0, 1)])
        assert not prior.traceable
        x = prior.rvs(20, random_state=1)
        assert x.shape == (20, 2)
        lp = prior.logpdf(x)
        assert isinstance(lp, np.ndarray) and np.isfinite(lp).all()
        np.testing.assert_allclose(lp, stats.skewnorm(3.0).logpdf(x[:, 0])
                                   + stats.norm(0, 1).logpdf(x[:, 1]), rtol=1e-12)

    def test_rvs_statistics(self):
        prior = Prior([stats.norm(2.0, 0.5)])
        s = prior.rvs(4000, random_state=0)
        assert abs(s.mean() - 2.0) < 0.05
        assert abs(s.std() - 0.5) < 0.05


class _SeedlessDist:
    """Duck-typed dist whose rvs signature has no random_state."""

    def rvs(self, size=1):
        return np.random.rand(size)

    def logpdf(self, x):
        return np.where((x >= 0) & (x <= 1), 0.0, -np.inf)

    def support(self):
        return (0.0, 1.0)


class TestDuckTypedSeeding:
    def test_rvs_reproducible_without_random_state_support(self):
        prior = Prior([_SeedlessDist(), Normal(0, 1)])
        assert not prior.traceable
        a = prior.rvs(50, random_state=0)
        b = prior.rvs(50, random_state=0)
        np.testing.assert_array_equal(a, b)
        c = prior.rvs(50, random_state=1)
        assert not np.array_equal(a[:, 0], c[:, 0])

    def test_rvs_restores_global_np_random_state(self):
        prior = Prior([_SeedlessDist()])
        np.random.seed(123)
        expected_next = np.random.rand()
        np.random.seed(123)
        prior.rvs(10, random_state=0)
        assert np.random.rand() == expected_next

    def test_rvs_seeded_scipy_without_typeerror_path(self):
        prior = Prior([stats.skewnorm(3.0)])
        a = prior.rvs(30, random_state=7)
        b = prior.rvs(30, random_state=7)
        np.testing.assert_array_equal(a, b)


# (name, args, points inside the support, on its boundary, outside it)
CASES = [
    ("Normal", (0.5, 2.0), [-3.0, 0.0, 0.5, 4.0, 30.0], [], []),
    ("Uniform", (-1.0, 2.0), [-0.5, 0.0, 1.5], [-1.0, 2.0], [-1.5, 2.5]),
    ("LogUniform", (1.0, 100.0), [2.0, 10.0, 50.0], [1.0, 100.0], [0.5, 150.0]),
    ("TruncatedNormal", (-1.0, 2.0, 0.5, 2.0), [0.0, 1.0, 3.0], [-1.5, 4.5], [-2.0, 5.0]),
    ("LogNormal", (0.8, 0.0, 1.5), [0.5, 1.0, 3.0, 1e-30], [0.0], [-1.0]),
    ("Beta", (2.0, 3.0), [0.2, 0.5, 0.9], [0.0, 1.0], [-0.1, 1.1]),
    ("Beta", (1.0, 3.0, 1.0, 2.0), [1.5, 2.0], [1.0, 3.0], [0.5, 3.5]),
    ("Gamma", (2.5,), [0.5, 2.0, 6.0], [0.0], [-1.0]),
    ("Gamma", (1.0, 1.0, 2.0), [2.0, 5.0], [1.0], [0.5]),
    ("Exponential", (0.0, 2.0), [0.5, 3.0], [0.0], [-0.1]),
    ("HalfNormal", (0.0, 1.5), [0.5, 3.0], [0.0], [-0.1]),
    ("Cauchy", (0.5, 1.5), [-10.0, 0.0, 0.5, 3.0, 100.0], [], []),
    ("StudentT", (4.0, 0.5, 2.0), [-10.0, 0.0, 1.0, 20.0], [], []),
    ("Laplace", (0.0, 2.0), [-5.0, 0.0, 0.5, 3.0], [], []),
]


@pytest.mark.parametrize("name,args,inside,edge,outside", CASES)
def test_logpdf_matches_jax(name, args, inside, edge, outside):
    """Each distribution's float32 logpdf against the JAX class's on the
    same points, rtol 1e-5; every -inf where JAX has one (outside the
    support, and on a boundary where the density vanishes), and the
    support itself."""
    td, jd = getattr(tprior, name)(*args), getattr(jprior, name)(*args)
    pts = np.array(inside + edge + outside, dtype=np.float32)
    got = td.logpdf(torch.from_numpy(pts))
    assert got.dtype == torch.float32 and got.shape == pts.shape
    got = got.numpy()
    want = np.asarray(jd.logpdf(jnp.asarray(pts)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    n_in = len(inside)
    assert np.isfinite(got[:n_in]).all()
    assert np.isneginf(got[n_in + len(edge):]).all()
    assert td.support() == jd.support()


def test_beta_gamma_boundary_is_finite_at_shape_one():
    """a = 1 at y = 0 (and b = 1 at y = 1) is finite, as in scipy, in
    float32 and float64."""
    for dt in (torch.float32, torch.float64):
        x = torch.tensor([0.0, 1.0], dtype=dt)
        np.testing.assert_allclose(tprior.Beta(1.0, 1.0).logpdf(x).numpy(), [0.0, 0.0])
        np.testing.assert_allclose(tprior.Beta(1.0, 2.0).logpdf(x[:1]).numpy(),
                                   stats.beta(1.0, 2.0).logpdf([0.0]), rtol=1e-6)
        np.testing.assert_allclose(tprior.Gamma(1.0).logpdf(x[:1]).numpy(),
                                   stats.gamma(1.0).logpdf([0.0]), rtol=1e-6)


SCIPY_FORMS = [
    (stats.norm(1.0, 2.0), stats.norm(loc=1.0, scale=2.0)),
    (stats.uniform(-3.0, 6.0), stats.uniform(loc=-3.0, scale=6.0)),
    (stats.truncnorm(-1.0, 2.0, 0.5, 2.0), stats.truncnorm(a=-1.0, b=2.0, loc=0.5, scale=2.0)),
    (stats.lognorm(0.8, 0.1, 1.5), stats.lognorm(s=0.8, loc=0.1, scale=1.5)),
    (stats.beta(2.0, 3.0, 1.0, 2.0), stats.beta(a=2.0, b=3.0, loc=1.0, scale=2.0)),
    (stats.gamma(2.5, 0.5, 2.0), stats.gamma(a=2.5, loc=0.5, scale=2.0)),
    (stats.expon(0.5, 2.0), stats.expon(loc=0.5, scale=2.0)),
    (stats.halfnorm(0.5, 1.5), stats.halfnorm(loc=0.5, scale=1.5)),
    (stats.cauchy(0.5, 1.5), stats.cauchy(loc=0.5, scale=1.5)),
    (stats.t(4.0, 0.5, 2.0), stats.t(df=4.0, loc=0.5, scale=2.0)),
    (stats.laplace(0.5, 2.0), stats.laplace(loc=0.5, scale=2.0)),
    (stats.loguniform(1.0, 100.0), stats.loguniform(a=1.0, b=100.0)),
]


def _params(d):
    return {k: v for k, v in vars(d).items() if not k.startswith("_")}


@pytest.mark.parametrize("forms", SCIPY_FORMS, ids=lambda f: f[0].dist.name)
def test_convert_scipy_matches_jax(forms):
    """Positional and keyword forms convert to the JAX package's class with
    the JAX package's parameters."""
    for sd in forms:
        td, jd = tprior._convert_scipy(sd), jprior._convert_scipy(sd)
        assert type(td).__name__ == type(jd).__name__
        assert _params(td) == _params(jd)


def test_convert_scipy_unknown_and_traceable_match_jax():
    assert tprior._convert_scipy(stats.skewnorm(3.0)) is None
    assert jprior._convert_scipy(stats.skewnorm(3.0)) is None
    assert tprior._convert_scipy(object()) is None
    lists = [[f[0] for f in SCIPY_FORMS],
             [stats.norm(0, 1), stats.skewnorm(3.0)],
             [stats.norm(0, 1), _SeedlessDist()],
             [tpc.Normal(0, 1), stats.expon()]]
    for dists in lists:
        jd = [d if not isinstance(d, tprior.BaseDist) else jprior.Normal(0, 1) for d in dists]
        assert Prior(dists).traceable == jprior.Prior(jd).traceable


@pytest.mark.parametrize("forms", SCIPY_FORMS, ids=lambda f: f[0].dist.name)
def test_rvs_follows_scipy_cdf(forms):
    """Draws of each converted distribution against scipy's CDF, a KS
    test at a fixed seed (the port's and scipy's streams differ): p-value
    above 1e-3."""
    sd = forms[0]
    x = Prior([sd]).rvs(4000, random_state=3)[:, 0]
    assert stats.kstest(x, sd.cdf).pvalue > 1e-3


def test_converted_draws_equal_native_draws():
    """A converted scipy column draws exactly what the native one draws
    from the same seed (the sampler's runs repeat bit for bit)."""
    a = Prior([stats.norm(0, 3)] * 4 + [stats.uniform(-1, 2)]).rvs(64, random_state=5)
    b = Prior([Normal(0, 3)] * 4 + [Uniform(-1, 1)]).rvs(64, random_state=5)
    np.testing.assert_array_equal(a, b)
