"""The PyTorch port's flow-free sweeps and the rwm/imh/mala/hmc kernels
against the JAX package on the CPU: one step of each sweep with the same draws, the
knobs ``run(n_evidence=...)`` resolves, the loop routing, and the
known-answer gates of ``tests/test_statistical.py:14-40`` and
``tests/test_imh.py`` at those tests' sizes.

JAX threefry and torch generators never give the same numbers, so the step
test rebuilds each JAX step's draws from its key (``pocomc_tpu/mcmc.py``
``propose``: the split into gamma mix, normals and acceptance uniforms,
``fold_in(k_norm, 1)`` for the independence refresh, and hmc's second
split of the normals' key for its leapfrog count) and hands the same
numbers to the port's step."""

import copy
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import multivariate_normal, norm

import pocomc_tpu as jpc
from pocomc_tpu.mcmc import make_sweep, make_loglike_device, f32_precision
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu.models.geometry import _fit_geometry_impl
from pocomc_tpu.sampler import Sampler as JSampler
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import load_flow_params, tensors_from_jax
from pocomc_tpu_torch.mcmc import Sweep, make_loglike
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops.flow_kernels import made_rqs_forward_ref
from pocomc_tpu_torch.sampler import Sampler

D, N, NU, STEPS = 3, 64, 5.0, 8
KNOBS = dict(plateau_z=0.75, corr_threshold=0.5, calib_z=3.0, bias_budget=0.1,
             bias_rate=0.4, bias_floor=0.5, plateau_floor=4.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def j_like(x):
    return -0.5 * jnp.sum((x - 0.5) ** 2 / 0.3, axis=-1)


def t_like(x):
    return -0.5 * ((x - 0.5) ** 2 / 0.3).sum(-1)


def _sweeps(kind, preconditioned, imh_every):
    """Both packages' sweep of one kind over the same flow (same random
    weights), scaler and start population, with the geometry fitted on the
    flow latent or on u (nu set to a moderate 5)."""
    rng = np.random.default_rng(0)
    bounds = np.array([[-np.inf, np.inf]] * D)
    js, ts = (m.Reparameterize(D, bounds=bounds) for m in (jpc, tpc))
    prior_x = 5.0 * rng.standard_normal((512, D))
    js.fit(prior_x)
    ts.fit(prior_x)
    scp_j = js.whitening_params()
    jprior = jpc.Prior([jpc.Normal(0.0, 5.0)] * D)
    tprior = tpc.Prior([tpc.Normal(0.0, 5.0)] * D)
    jf = JFlow(D, "nsf3", seed=1)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    params["stack"][-1]["w"] = (0.03 * rng.standard_normal(
        params["stack"][-1]["w"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    tf = load_flow_params(Flow(D, "nsf3", device="cpu"), params)
    u = (0.5 * rng.standard_normal((N, D)) + 0.1).astype(np.float32)
    x, ldj = js.inverse(jnp.asarray(u))
    start = [np.asarray(a) for a in (u, x, ldj, j_like(x), jprior.logpdf(x))]
    pts = jf.forward(jnp.asarray(u))[0] if preconditioned else jnp.asarray(u)
    geom = jax.jit(_fit_geometry_impl)(pts, jnp.ones(N, jnp.float32), jax.random.key(0))
    geom["t_nu"] = jnp.float32(NU)
    flow_kw = (dict(flow_fwd=jf.kernel_fwd, flow_inv=jf.kernel_inv) if preconditioned
               else {})
    jsweep = make_sweep(js, f32_precision(jprior.logpdf), make_loglike_device(j_like, True, True),
                        D, 2, 100, kind=kind, preconditioned=preconditioned,
                        imh_every=imh_every, **flow_kw, **KNOBS)
    tsweep = Sweep(ts, tprior.logpdf, make_loglike(t_like), tf if preconditioned else None,
                   D, 2, 100, kind=kind, preconditioned=preconditioned, imh_every=imh_every,
                   **KNOBS)
    scp_t = tensors_from_jax(scp_j, device="cpu")
    return jsweep, tsweep, jf, tf, scp_j, scp_t, geom, start


def _kink_rows(flow, u, window=1e-5):
    """(n,) bool: rows where, in the float64 forward of the flow at u, a
    hidden pre-activation of some transform's MADE lies within `window`
    of 0. The ReLU's derivative jumps there, so the target's gradient
    does, and which side a row takes turns on the last bits of a sum that
    the two packages order differently."""
    fp = copy.deepcopy(flow).double().params()
    y = (u.double() - fp.pre["mean"]) @ fp.pre["w_fwd"]
    near = torch.zeros(u.shape[0], dtype=torch.bool)
    with torch.no_grad():
        xs = made_rqs_forward_ref(y, fp.ws, fp.bs, save_inputs=True)[2][0]
        for k in range(xs.shape[0]):
            w, b = [a[k] for a in fp.ws], [a[k] for a in fp.bs]
            h = xs[k] @ w[0] + b[0]
            near |= (h.abs() < window).any(-1)
            for l in (1, 2):
                h = h + torch.relu(h) @ w[l] + b[l]
                near |= (h.abs() < window).any(-1)
    return near


def _jax_draws(sj, kind, imh_every):
    """The numbers the JAX step draws from its key, as the port's noise dict."""
    _, kg, kn, ku = jax.random.split(sj.key, 4)
    noise = {}
    if kind == "hmc":
        kn, k_len = jax.random.split(kn)
        noise["n_leap"] = int(jax.random.randint(k_len, (), 1, 6))  # n_leapfrog = 5
    noise.update(z=t(jax.random.normal(kn, (N, D))), unif=t(jax.random.uniform(ku, (N,))))
    if kind == "tpcn":
        noise["g"] = t(jax.random.gamma(kg, 0.5 * (D + NU), (N,)))
        if imh_every and int(sj.i) % imh_every == imh_every - 1:
            noise["v_imh"] = t(jax.random.normal(jax.random.fold_in(kn, 1), (N, D)))
    return noise


@pytest.mark.parametrize("kind,preconditioned,imh_every", [
    ("tpcn", False, 0), ("rwm", False, 0), ("rwm", True, 0), ("imh", True, 0),
    ("tpcn", True, 2), ("tpcn", False, 2), ("mala", False, 0), ("mala", True, 0),
    ("hmc", False, 0), ("hmc", True, 0)])
def test_sweep_steps_match_jax_with_injected_draws(kind, preconditioned, imh_every):
    """Eight steps (a drift window closes at step 6) of propose +
    accept_update with the JAX draws injected, for the flow-free t-pCN,
    rwm with and without the flow, imh, the independence refresh every
    2nd step (inert without the flow), and mala and hmc with and without
    the flow (their gradient passes through the plain inverse under
    autograd, hmc's 1..5 leapfrog steps as the JAX key draws them): the
    same proposals, the same mean Metropolis acceptance (the ratio's
    image), the same accept decisions and states, the carried gradient
    among them (1e-4; fp32 and the t-pCN correction's form), the same
    likelihood calls and the same stopping decision as the JAX host
    rule."""
    jsweep, tsweep, jf, tf, scp_j, scp_t, geom, start = _sweeps(kind, preconditioned,
                                                                imh_every)
    # hmc's step: a 5-step leapfrog at 0.5 leaves the flow's range (|u| ~ 80)
    # and amplifies fp32 rounding there by 1e4; 0.2 keeps its trajectories
    beta, sigma0, dbeta = 0.6, 0.2 if kind == "hmc" else 0.5, 0.1
    sj = jsweep.init_state(*map(jnp.asarray, start), jnp.float32(beta), jnp.float32(sigma0),
                           geom, jax.random.key(42), flow_params=jf.params,
                           scaler_params=scp_j, dbeta=dbeta)
    geom_t = tensors_from_jax(geom, device="cpu")
    loglike_j = make_loglike_device(j_like, True, True)
    decisions = []
    with torch.no_grad():
        fp = tf.params() if preconditioned else None
        st = tsweep.init_state(*map(t, start), sigma0, geom_t, fp, dbeta=dbeta, beta=beta,
                               scp=scp_t)
        for step in range(STEPS):
            noise = _jax_draws(sj, kind, tsweep.imh_every)
            prop_j = jsweep.propose(sj, jnp.float32(beta), geom, jf.params, scp_j)
            prop_t = tsweep.propose(st, geom_t, fp, scp_t, noise, beta=beta)
            for name in ("u", "x", "logdetj", "logp", "theta", "logdetj_flow"):
                np.testing.assert_allclose(prop_t[name].numpy(), np.asarray(prop_j[name]),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{name} @ {step}")
            assert np.array_equal(prop_t["finite"].numpy(), np.asarray(prop_j["finite"]))
            sj, acc_j, stats_j = jsweep.accept_update(
                sj, prop_j, loglike_j(prop_j["x_safe"], prop_j["finite"]),
                jnp.float32(beta), geom)
            st, acc_t = tsweep.accept_update(
                st, prop_t, tsweep.log_like(prop_t["x_safe"], prop_t["finite"]), beta,
                geom_t)
            assert np.array_equal(acc_t.numpy(), np.asarray(acc_j)), step
            decisions.append(acc_t.numpy())
            for name in ("accept", "u", "x", "logl", "theta", "sigma", "mu", "corr",
                         "misfit", "hot", "resid", "z_logl", "z_dim", "fresh"):
                np.testing.assert_allclose(getattr(st, name).numpy(),
                                           np.asarray(getattr(sj, name)),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{name} @ {step}")
            # the carried gradient within 1e-4 of its largest element, the
            # gradient tolerance of tests/test_torch_gradient.py, but where
            # the flow's ReLU kinks make it jump
            g_j = np.asarray(sj.grad)
            keep = ~_kink_rows(tf, st.u).numpy() if preconditioned else slice(None)
            assert np.abs(st.grad.numpy() - g_j)[keep].max() <= 1e-4 * max(np.abs(g_j).max(),
                                                                             1.0)
            if kind in ("mala", "hmc"):
                # a gradient kernel moves each walker along its gradient,
                # whose fp32 rounding through a spline stack (1e-4 of the
                # largest) grows over steps: each step starts from JAX's state
                st = dataclasses.replace(st, **{name: t(np.asarray(getattr(sj, name))) for name in (
                    "u", "x", "logdetj", "logl", "logp", "theta", "logdetj_flow", "sigma",
                    "grad")})
            assert int(st.cnt) == int(sj.cnt) and int(st.calls) == int(sj.calls)
            assert st.i == int(sj.i) and st.i_snap == int(sj.i_snap)
            s = np.asarray(stats_j)
            assert tsweep.keep_going(st) == jsweep.should_continue(
                int(s[0]), int(s[1]), float(s[2]), float(s[4]), float(s[5]),
                float(s[6]), dbeta, float(s[7]))
        assert np.isfinite(float(tsweep.final_resid(st)))
    decisions = np.concatenate(decisions)
    assert decisions.any() and not decisions.all()  # a real mix of accepts
    assert st.i_snap == 6  # the drift window closed inside the test
    assert tsweep.imh_every == (imh_every if preconditioned else 0)


def test_sweep_kinds_validate():
    ts = tpc.Reparameterize(D, bounds=np.array([[-np.inf, np.inf]] * D))
    with pytest.raises(ValueError, match="kind"):
        Sweep(ts, None, None, None, D, 2, 10, kind="hamiltonian", preconditioned=False)
    with pytest.raises(ValueError, match="precondition"):
        Sweep(ts, None, None, None, D, 2, 10, kind="imh", preconditioned=False)
    with pytest.raises(ValueError, match="flow"):
        Sweep(ts, None, None, None, D, 2, 10, kind="tpcn", preconditioned=True)


# -- knobs and routing -----------------------------------------------------------

def _stop_at_warmup(monkeypatch):
    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(JSampler, "_run_warmup", stop)
    monkeypatch.setattr(Sampler, "_run_warmup", stop)
    return Stop


@pytest.mark.parametrize("d", [2, 10, 50])
@pytest.mark.parametrize("route", ["device", "numpy_rows", "explicit_corr"])
def test_run_knobs_match_jax(d, route, monkeypatch):
    """corr_threshold and bias_floor as each package's run() resolves them
    for n_evidence = 0 and > 0 (run stopped at the warmup), on a device
    and a host likelihood and with an explicit corr_threshold; the port's
    sweep is rebuilt with them."""
    Stop = _stop_at_warmup(monkeypatch)
    kw = dict(n_effective=128, n_active=64, flow="nsf3", random_state=0)
    if route == "explicit_corr":
        kw["corr_threshold"] = 0.3
    jp, tp = jpc.Prior([jpc.Normal(0.0, 5.0)] * d), tpc.Prior([tpc.Normal(0.0, 5.0)] * d)
    if route == "numpy_rows":
        fn = lambda row: float(-0.5 * np.sum(row ** 2))  # noqa: E731
        js = JSampler(jp, fn, **kw)
        ts = Sampler(tp, fn, device="cpu", **kw)
    else:
        js = JSampler(jp, lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True, **kw)
        ts = Sampler(tp, lambda x: -0.5 * (x * x).sum(-1), vectorize=True, device="cpu", **kw)
    for n_evidence in (0, 512, 0):
        for s in (js, ts):
            with pytest.raises(Stop):
                s.run(n_total=256, n_evidence=n_evidence, progress=False)
        for name in ("corr_threshold", "bias_floor", "bias_rate"):
            assert getattr(ts, name) == getattr(js, name), (name, n_evidence)
        assert (ts._sweep.corr_threshold, ts._sweep.bias_floor) == (
            ts.corr_threshold, ts.bias_floor)
    if route == "device" and d == 10:
        assert ts.corr_threshold == ts.bias_floor == 0.15  # the quickstart at n_evidence=0


@pytest.mark.parametrize("kwargs", [
    dict(precondition=False),
    dict(precondition=False, train_config=dict(annealing=True)),
    dict(precondition=False, device_loop=False),
    dict(precondition=False, sample="rwm", imh_every=3),
    dict(sample="rwm"),
    dict(sample="imh", n_active=128),
    dict(imh_every=2, train_config=dict(noise=0.1)),
    dict(sample="imh", vectorize=False, numpy=True),
])
def test_construct_and_route_match_jax(kwargs):
    """The new options construct, and take the loop, the sweep and the
    bridge defaults the JAX package takes."""
    kwargs = dict(kwargs)
    numpy_like = kwargs.pop("numpy", False)
    vectorize = kwargs.pop("vectorize", True)
    base = dict(random_state=0, flow="nsf3", n_effective=256, vectorize=vectorize)
    base.update(kwargs)
    if numpy_like:
        jl = tl = lambda row: float(-0.5 * np.sum(row ** 2))  # noqa: E731
    else:
        jl = lambda x: -0.5 * jnp.sum(x ** 2, axis=-1)  # noqa: E731
        tl = lambda x: -0.5 * (x * x).sum(-1)  # noqa: E731
    js = JSampler(jpc.Prior([jpc.Normal(0.0, 5.0)] * D), jl, **base)
    ts = Sampler(tpc.Prior([tpc.Normal(0.0, 5.0)] * D), tl, device="cpu", **base)
    assert ts._use_device_loop() == js._use_device_loop()
    for name in ("preconditioned", "imh_every", "bridge_n", "bridge_steps",
                 "evidence_bridge", "corr_threshold", "bias_floor"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts._sweep.kind == ts.sample and ts._sweep.preconditioned == ts.preconditioned
    assert ts._sweep.imh_every == (ts.imh_every if ts.preconditioned
                                   and ts.sample == "tpcn" else 0)
    assert (ts._sweep.flow is None) == (not ts.preconditioned)


@pytest.mark.parametrize("kwargs,match", [
    (dict(sample="imh", precondition=False), "precondition"),
    (dict(imh_every=-1), "imh_every"),
    (dict(imh_every=1.5), "imh_every"),
])
def test_new_options_validate_like_jax(kwargs, match):
    jp = jpc.Prior([jpc.Normal(0.0, 1.0)] * 2)
    tp = tpc.Prior([tpc.Normal(0.0, 1.0)] * 2)
    with pytest.raises(ValueError, match=match):
        JSampler(jp, lambda x: -jnp.sum(x ** 2, axis=-1), **kwargs)
    with pytest.raises(ValueError, match=match):
        Sampler(tp, lambda x: -(x * x).sum(-1), device="cpu", **kwargs)


# -- known answers --------------------------------------------------------------------

def _correlated_gaussian():
    """tests/test_statistical.py:14-40: 6-D, condition number 100."""
    d = 6
    rng = np.random.default_rng(0)
    evals = np.logspace(0, 2, d)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (Q * evals) @ Q.T
    cov_inv = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    _, logdet = np.linalg.slogdet(cov)
    norm_const = -0.5 * (d * np.log(2 * np.pi) + logdet)

    def loglike(x):
        return norm_const - 0.5 * torch.einsum("ni,ij,nj->n", x, cov_inv, x)

    prior = tpc.Prior([tpc.Normal(0, 25.0) for _ in range(d)])
    expect = multivariate_normal.logpdf(np.zeros(d), np.zeros(d), cov + 625.0 * np.eye(d))
    return loglike, prior, expect


@pytest.mark.parametrize("sample", ["tpcn", "rwm"])
@pytest.mark.parametrize("device_loop", ["auto", False])
def test_flow_free_correlated_gaussian_logz(sample, device_loop):
    """precondition=False on the ill-conditioned Gaussian at
    test_statistical's settings, on the device loop and the host loop:
    the recorrected ladder within 0.35 of the analytic logZ, no error bar,
    no bridge, no flow training."""
    loglike, prior, expect = _correlated_gaussian()
    s = Sampler(prior, loglike, vectorize=True, random_state=0, n_effective=512,
                n_active=256, precondition=False, sample=sample, device_loop=device_loop,
                device="cpu")
    assert s._use_device_loop() == (device_loop == "auto")
    s.run(n_total=1024, n_evidence=0, progress=False)
    logz, err = s.evidence()
    assert logz == pytest.approx(expect, abs=0.35)
    assert err is None and s.bridge_diagnostics is None
    rec = float(s.particles.compute_logw_and_logz(1.0, recorrect=True)[1])
    assert logz == pytest.approx(rec)
    assert all(st["train_epochs"] is None for st in s._iter_stats)
    assert s.flow_untrained and s.phase_seconds["bridge"] == 0.0


def _mixture(d=2, sep=4.0, sig=0.5, w1=0.6):
    """tests/test_imh.py:14-30 with a torch likelihood."""
    w2 = 1.0 - w1

    def loglike(x):
        c = d * math.log(math.sqrt(2 * math.pi) * sig)
        l1 = -0.5 * ((x - sep) ** 2).sum(-1) / sig ** 2 - c
        l2 = -0.5 * ((x + sep) ** 2).sum(-1) / sig ** 2 - c
        return torch.logaddexp(math.log(w1) + l1, math.log(w2) + l2)

    ps = 10.0
    var = sig ** 2 + ps ** 2
    m = np.full(d, sep)
    z1 = w1 * np.exp(-0.5 * np.sum(m ** 2) / var) / (2 * np.pi * var) ** (d / 2)
    z2 = w2 * np.exp(-0.5 * np.sum(m ** 2) / var) / (2 * np.pi * var) ** (d / 2)
    prior = tpc.Prior([tpc.Normal(0, ps) for _ in range(d)])
    return loglike, prior, np.log(z1 + z2), z1 / (z1 + z2)


def test_imh_bimodal_mixture():
    """test_imh.py's mode mass and logZ gates on the bimodal target."""
    loglike, prior, logz_true, mass1_true = _mixture()
    s = Sampler(prior, loglike, vectorize=True, random_state=0, n_effective=512,
                n_active=256, sample="imh", flow="nsf3",
                train_config={"epochs": 60, "patience": 8}, device="cpu")
    s.run(n_total=1024, n_evidence=2048, progress=False)
    assert s.logz == pytest.approx(logz_true, abs=0.3)
    x, w, _, _ = s.posterior()
    assert float(w[x[:, 0] > 0].sum() / w.sum()) == pytest.approx(mass1_true, abs=0.1)


def test_imh_blackbox_likelihood():
    """imh needs no gradients: a plain-numpy likelihood takes the host
    route (test_imh.py's gate, 0.4)."""
    def loglike(x):
        x = np.asarray(x)
        return -0.5 * np.sum(x ** 2, axis=-1) - x.shape[-1] / 2 * np.log(2 * np.pi)

    expect = 2 * norm.logpdf(0, 0, np.sqrt(26.0))
    prior = tpc.Prior([tpc.Normal(0, 5), tpc.Normal(0, 5)])
    s = Sampler(prior, loglike, vectorize=True, random_state=0, n_effective=256,
                n_active=128, sample="imh", flow="nsf3",
                train_config={"epochs": 40, "patience": 5}, device="cpu")
    assert not s.likelihood_traceable and not s._use_device_loop()
    s.run(n_total=512, n_evidence=512, progress=False)
    assert s.logz == pytest.approx(expect, abs=0.4)


def test_imh_refresh_preserves_target_without_call_blowup():
    """imh_every=2 (test_imh.py:71-103): the evidence stays within 0.4 of
    the analytic value and the calls below 1.5x the run without it."""
    d = 4

    def loglike(x):
        return -0.5 * (x * x).sum(-1) - d / 2 * math.log(2 * math.pi)

    expect = d * norm.logpdf(0, 0, np.sqrt(26.0))
    prior = tpc.Prior([tpc.Normal(0, 5) for _ in range(d)])
    calls = {}
    for ie in (0, 2):
        s = Sampler(prior, loglike, vectorize=True, random_state=0, n_effective=256,
                    n_active=128, imh_every=ie, corr_threshold=0.1, flow="nsf3",
                    train_config={"epochs": 40, "patience": 5}, device="cpu")
        assert s.imh_every == ie
        s.run(n_total=512, n_evidence=512, progress=False)
        assert s.logz == pytest.approx(expect, abs=0.4)
        calls[ie] = s.calls
    assert calls[2] < 1.5 * calls[0]


def test_imh_every_inert_without_the_flow():
    """precondition=False with imh_every: the cadence is inert and the run
    ends with a finite ladder (test_imh.py:106-116)."""
    s = Sampler(tpc.Prior([tpc.Normal(0, 1), tpc.Normal(0, 1)]),
                lambda x: -(x * x).sum(-1), vectorize=True, imh_every=3,
                precondition=False, device="cpu")
    assert s._sweep.imh_every == 0
    s.run(n_total=256, n_evidence=0, progress=False)
    assert np.isfinite(s.particles.compute_logw_and_logz(1.0)[1]) and np.isfinite(s.logz)
