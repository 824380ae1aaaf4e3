"""The reference surface of the port: the JAX constructor keywords, the
prior's route, the ten added distributions, the unweighted geometry fit,
``profile_dir`` and the public names, each against the JAX package on the
same inputs where it has a counterpart."""

import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu.models.geometry import fit_geometry_jax
from pocomc_tpu_torch.models.geometry import Geometry, fit_geometry

D = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauss_like(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[1] * math.log(2 * math.pi)


def make_prior(d=2):
    return tpc.Prior([tpc.Normal(0, 5) for _ in range(d)])


def small(**kw):
    return dict(vectorize=True, random_state=0, n_effective=128, n_active=64,
                flow="nsf3", train_config=dict(epochs=30, patience=3), device="cpu", **kw)


class NumpyNormalPrior:
    """A whole prior in numpy (the duck-typed protocol): N(loc, scale) in
    every dimension. Its logpdf fails on a non-finite row, so a run that
    passes never handed it one."""

    def __init__(self, d, loc=0.0, scale=5.0):
        self.dim, self.loc, self.scale = d, loc, scale
        self.bounds = np.array([[-np.inf, np.inf]] * d)
        self.rows = 0

    def logpdf(self, x):
        assert isinstance(x, np.ndarray) and np.isfinite(x).all()
        self.rows += len(x)
        return stats.norm.logpdf(x, self.loc, self.scale).sum(1)

    def rvs(self, size, random_state=None):
        return np.random.default_rng(random_state).normal(self.loc, self.scale,
                                                          (size, self.dim))


def test_extra_distributions_sample_and_logpdf():
    pairs = [
        (tpc.LogUniform(1.0, 100.0), stats.loguniform(1.0, 100.0)),
        (tpc.Exponential(0.0, 2.0), stats.expon(0.0, 2.0)),
        (tpc.HalfNormal(0.0, 1.5), stats.halfnorm(0.0, 1.5)),
        (tpc.Laplace(0.0, 2.0), stats.laplace(0.0, 2.0)),
    ]
    for td, sd in pairs:
        xs = td.sample(np.random.default_rng(0), 2000)
        lo, hi = td.support()
        assert xs.dtype == np.float64 and xs.shape == (2000,)
        assert (xs >= lo - 1e-6).all() and (xs <= hi + 1e-6).all()
        pts = np.asarray(sd.rvs(size=20, random_state=0), dtype=np.float64)
        np.testing.assert_allclose(td.logpdf(torch.from_numpy(pts)).numpy(),
                                   sd.logpdf(pts), rtol=1e-4, atol=1e-4)


def test_n_ess_deprecation():
    with pytest.warns(DeprecationWarning):
        s = tpc.Sampler(make_prior(), gauss_like, vectorize=True, n_ess=256, n_active=128,
                        device="cpu")
    assert s.n_effective == 256


def test_pipeline_option():
    """pipeline is validated as in the JAX package, then ignored (the port
    syncs every iteration): depths 0 and 2 both recover the analytic
    evidence, with the same run; invalid depths raise."""
    expect = 2 * stats.norm.logpdf(0, 0, np.sqrt(1 + 25.0))
    runs = []
    for pl in (0, 2):
        s = tpc.Sampler(make_prior(), gauss_like, vectorize=True, random_state=0,
                        n_effective=256, n_active=128, precondition=False, pipeline=pl,
                        device="cpu")
        s.run(n_total=512, n_evidence=0, progress=False)
        logz = float(s.particles.compute_logw_and_logz(1.0)[1])
        assert logz == pytest.approx(expect, abs=0.3), (pl, logz)
        runs.append((logz, s.calls))
    assert runs[0] == runs[1]
    for bad in (-1, 1.5):
        for mod in (tpc, jpc):
            with pytest.raises(ValueError, match="pipeline"):
                mod.Sampler(mod.Prior([mod.Normal(0, 5)] * 2), gauss_like, pipeline=bad,
                            **({"device": "cpu"} if mod is tpc else {}))


def test_profile_dir_writes_trace(tmp_path):
    s = tpc.Sampler(make_prior(), gauss_like, vectorize=True, random_state=0,
                    n_effective=128, n_active=64, precondition=False,
                    profile_dir=str(tmp_path / "trace"), device="cpu")
    s.run(n_total=128, n_evidence=0, progress=False)
    trace_files = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert trace_files, "profiler produced no trace files"
    text = open(os.path.join(tmp_path / "trace", trace_files[0])).read()
    assert "pocomc/warmup" in text and "pocomc/mutate" in text
    assert not torch.autograd.profiler._is_profiler_enabled


def test_reference_keywords():
    """Every JAX keyword is accepted: compile_cache is ignored,
    n_leapfrog is validated and kept (and reaches hmc's sweep),
    output_dir/output_label default to states/pmc; every public method
    and mcmc.set_live_sink take JAX's parameters."""
    s = tpc.Sampler(make_prior(), gauss_like, compile_cache=False, n_leapfrog=3,
                    **small())
    assert s.n_leapfrog == 3 and s.pipeline == 1 and s.profile_dir is None
    assert str(s.output_dir) == "states" and s.output_label == "pmc"
    for bad in (0, 2.0):
        with pytest.raises(ValueError, match="n_leapfrog"):
            tpc.Sampler(make_prior(), gauss_like, n_leapfrog=bad, **small())
    s = tpc.Sampler(make_prior(), gauss_like, sample="hmc", n_leapfrog=4, **small())
    assert s.sample == "hmc" and s.n_leapfrog == 4 and s._sweep.n_leapfrog == 4
    assert s._sweep.kind == "hmc"
    import inspect
    jax_keys = set(inspect.signature(jpc.Sampler.__init__).parameters)
    assert jax_keys <= set(inspect.signature(tpc.Sampler.__init__).parameters)
    # every class of both __all__s: __init__ and each public method take
    # JAX's parameters in JAX's positional order, up to ALLOWED
    classes = [k for k in jpc.__all__ if k in tpc.__all__ and inspect.isclass(getattr(jpc, k))]
    assert len(classes) == 20  # ParticleMesh among them
    for name in classes:
        jcls, tcls = getattr(jpc, name), getattr(tpc, name)
        for meth in [m for m in dir(jcls) if m == "__init__" or not m.startswith("_")]:
            if not callable(getattr(jcls, meth)):
                continue
            assert hasattr(tcls, meth), f"{name}.{meth} missing from the port"
            got = _positional(getattr(tcls, meth))
            want = [ALLOWED_RENAMES.get((name, meth, p), p)
                    for p in _positional(getattr(jcls, meth))]
            extra = ALLOWED_EXTRA.get((name, meth), ())
            assert got == want + list(extra), (name, meth, got, want)
            kw_only = [p.name for p in inspect.signature(getattr(tcls, meth)).parameters.values()
                       if p.kind is p.KEYWORD_ONLY]
            assert set(kw_only) <= {"device"}, (name, meth, kw_only)
    # the module-level function of the live sweep statistics
    from pocomc_tpu import mcmc as jmcmc
    from pocomc_tpu_torch import mcmc as tmcmc
    assert _positional(tmcmc.set_live_sink) == _positional(jmcmc.set_live_sink) == ["fn"]


def _positional(fn):
    import inspect
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD]


# The port's deliberate departures from the JAX signatures: a random
# source is a numpy Generator or a torch.Generator in place of a JAX key
# (the two streams cannot agree, ROADMAP "stochastic components"), a flow
# method takes the parameters as an optional trailing ``fp`` (the sweep
# hands in one FlowParams for many calls), and whitening_params names the
# device of the tensors it returns. ``device`` of Sampler and Flow is
# keyword-only, so it never shifts a JAX positional argument. The
# preconditioner protocol's kernel members take (u, fp=None) where the JAX
# flow's take (params, u); they are instance closures there, not methods,
# so this comparison does not reach them (models/protocol.py lists them).
_DISTRIBUTIONS = ("Beta", "Cauchy", "Exponential", "Gamma", "HalfNormal", "Laplace",
                  "LogNormal", "LogUniform", "Normal", "StudentT", "TruncatedNormal", "Uniform")
ALLOWED_RENAMES = {**{(k, "sample", "key"): "rng" for k in _DISTRIBUTIONS},
                   ("Flow", "sample", "key"): "generator",
                   ("Geometry", "fit", "key"): "generator"}
ALLOWED_EXTRA = {("Flow", "forward"): ("fp",), ("Flow", "inverse"): ("fp",),
                 ("Flow", "log_prob"): ("fp",), ("Flow", "sample"): ("fp",),
                 ("Reparameterize", "whitening_params"): ("device",)}


def test_public_names_match_jax():
    assert set(tpc.__all__) == set(jpc.__all__)
    assert all(hasattr(tpc, k) for k in tpc.__all__)
    assert tpc.__version__ == jpc.__version__ == tpc.version


@pytest.mark.parametrize("prior,route,device_loop", [
    ("scipy", "device", True),
    ("numpy_whole", "host", False),
    ("numpy_column", "host", False),
    ("torch_whole", "device", True),
])
def test_prior_route(prior, route, device_loop):
    """The prior's route is chosen at construction: converted scipy
    columns and any prior whose logpdf runs on a meta tensor take the
    device (and the device loop); a numpy prior, whole or one column of
    it, takes the host and the host loop, and device_loop=True raises."""
    priors = {
        "scipy": tpc.Prior([stats.norm(0, 5)] * D),
        "numpy_whole": NumpyNormalPrior(D),
        "numpy_column": tpc.Prior([stats.norm(0, 5)] * (D - 1) + [stats.skewnorm(0.0, 0, 5)]),
        "torch_whole": type("TorchPrior", (), dict(
            dim=D, bounds=np.array([[-np.inf, np.inf]] * D),
            logpdf=lambda self, x: -0.5 * (x * x).sum(-1) / 25.0,
            rvs=lambda self, n, random_state=None: np.zeros((n, D))))(),
    }
    s = tpc.Sampler(priors[prior], gauss_like, **small())
    assert s.prior_route == route and s.prior_traceable == (route == "device")
    assert s._use_device_loop() == device_loop
    if route == "host":
        with pytest.raises(ValueError, match="prior"):
            tpc.Sampler(priors[prior], gauss_like, device_loop=True, **small())
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, (16, D)).astype(np.float32))
    lp = s._log_prior(x)
    assert lp.dtype == torch.float32 and lp.shape == (16,)


def test_scipy_prior_repeats_native_run():
    """Prior([stats.norm(0, 5)] * 3) and Prior([Normal(0, 5)] * 3) give the
    same run, bit for bit."""
    runs = []
    for prior in (tpc.Prior([stats.norm(0, 5)] * D), tpc.Prior([tpc.Normal(0, 5)] * D)):
        s = tpc.Sampler(prior, gauss_like, **small())
        s.run(n_total=512, n_evidence=512, progress=False)
        runs.append((s.logz, s.logz_err, s.calls, s.posterior()[0]))
    assert runs[0][:3] == runs[1][:3]
    np.testing.assert_array_equal(runs[0][3], runs[1][3])


@pytest.mark.parametrize("n_evidence", [512, 0])
def test_host_prior_run_sees_finite_rows(n_evidence):
    """A numpy prior on the host loop: the known answer within 0.5, and
    the prior handed only finite float64 rows (the sweep's x_safe, the
    evidence draws, the bridge's pullbacks)."""
    prior = NumpyNormalPrior(D)
    s = tpc.Sampler(prior, gauss_like, **small())
    s.run(n_total=512, n_evidence=n_evidence, progress=False)
    truth = D * stats.norm.logpdf(0.0, 0.0, math.sqrt(26.0))
    assert abs(s.logz - truth) < 0.5, (s.logz, truth)
    assert prior.rows > s.n_prior
    if n_evidence == 0:
        assert s.bridge_diagnostics is not None


def test_unweighted_geometry_matches_jax():
    """fit_geometry without weights (plain moments, the EM on the points
    themselves) against fit_geometry_jax(theta), and Geometry.fit."""
    theta = np.random.default_rng(1).standard_t(5.0, (512, 3)) @ np.array(
        [[1.0, 0.3, 0.0], [0.0, 2.0, 0.5], [0.0, 0.0, 0.7]])
    theta = theta.astype(np.float32)
    got = fit_geometry(torch.from_numpy(theta))
    want = jax.device_get(fit_geometry_jax(jnp.asarray(theta)))
    for k in ("normal_mean", "normal_cov", "normal_chol", "t_mean", "t_cov", "t_nu",
              "t_chol", "t_inv_cov"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    g = Geometry()
    assert g.t_mean is None
    g.fit(torch.from_numpy(theta))
    for k in Geometry.KEYS:
        assert torch.equal(getattr(g, k), got[k])
    w = torch.rand(512, generator=torch.Generator().manual_seed(0))
    gw = Geometry().fit(torch.from_numpy(theta), w, torch.Generator().manual_seed(1))
    ref = fit_geometry(torch.from_numpy(theta), w, torch.Generator().manual_seed(1))
    assert torch.equal(gw.t_cov, ref["t_cov"])
