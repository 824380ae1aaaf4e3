"""The PyTorch port's flow-anchored bridge evidence (``run(n_evidence=0)``)
against the JAX package on the CPU: the host f64 helpers, the resample,
the black-box route's pullback and first rung, one rung against the JAX
rung on the same draws, grad mode, the known-answer gates of
``tests/test_bridge.py`` at that file's sizes, and the two places where
the port deliberately departs from the JAX package (a bridge that gives up
still counts its calls, and warns)."""

import math
import warnings
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu as jpc
import pocomc_tpu.bridge as jbridge
from pocomc_tpu.mcmc import f32_precision
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu.ops.resampling import systematic_resample_jax
import pocomc_tpu_torch as tpc
import pocomc_tpu_torch.bridge as tbridge
from pocomc_tpu_torch.convert import load_flow_params, tensors_from_jax
from pocomc_tpu_torch.mcmc import make_loglike
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops.resampling import systematic_resample_torch
from pocomc_tpu_torch.sampler import Sampler

D = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- host helpers ----------------------------------------------------------------

def _lw_cases():
    rng = np.random.default_rng(5)
    a = 30.0 * rng.standard_normal(257)
    b = a.copy()
    b[::7] = -np.inf
    return {"plain": a, "with_-inf": b, "one_finite": np.r_[-np.inf, 2.0, -np.inf],
            "all_-inf": np.full(4, -np.inf), "flat": np.full(64, -3.0)}


@pytest.mark.parametrize("case", sorted(_lw_cases()))
def test_host_helpers_match_jax(case):
    """_ess_frac, _logmeanexp and _boot_var (the same numpy seed) agree to
    1e-12, -inf rows and degenerate weights included."""
    lw = _lw_cases()[case]
    assert tbridge._ess_frac(lw) == pytest.approx(jbridge._ess_frac(lw), abs=1e-12)
    a, b = tbridge._logmeanexp(lw), jbridge._logmeanexp(lw)
    assert a == b if not np.isfinite(b) else a == pytest.approx(b, abs=1e-12)
    if np.isfinite(lw).any():
        va = tbridge._boot_var(lw, np.random.default_rng(11))
        vb = jbridge._boot_var(lw, np.random.default_rng(11))
        assert va == pytest.approx(vb, abs=1e-12)


def test_systematic_resample_matches_jax():
    """The rung's resample picks the JAX indices for the same offset and
    weights (side='right', clipped to n - 1), zero weights included."""
    rng = np.random.default_rng(2)
    for n in (7, 256, 1024):
        w = np.exp(rng.standard_normal(n) * 3.0).astype(np.float32)
        w[::5] = 0.0
        key = jax.random.key(n)
        want = np.asarray(systematic_resample_jax(key, n, jnp.asarray(w)))
        u0 = torch.tensor(float(jax.random.uniform(key, ())))
        got = systematic_resample_torch(n, t(w), u0=u0).numpy()
        assert np.array_equal(got, want)


# -- the pullback and the first rung ----------------------------------------------------

def _problem(seed=1, d=D):
    """Both packages' flow (same random weights), a scaler with a bounded
    last dimension, a log prior that rejects x0 above a cut, and the
    pullbacks (``to_x``) built on them."""
    rng = np.random.default_rng(seed)
    bounds = np.array([[-np.inf, np.inf]] * (d - 1) + [[-2.0, 2.0]])
    js, ts = (m.Reparameterize(d, bounds=bounds) for m in (jpc, tpc))
    prior_x = np.c_[3.0 * rng.standard_normal((512, d - 1)), rng.uniform(-2, 2, 512)]
    js.fit(prior_x)
    ts.fit(prior_x)
    jp, tp = (m.Prior([m.Normal(0.0, 3.0)] * (d - 1) + [m.Uniform(-2.0, 2.0)])
              for m in (jpc, tpc))
    cut = 2.5

    def jlogp(x):
        return jp.logpdf(x) + jnp.where(x[:, 0] > cut, -jnp.inf, 0.0)

    def tlogp(x):
        return tp.logpdf(x) + torch.where(x[:, 0] > cut, -math.inf, 0.0)

    jf = JFlow(d, "nsf3", seed=1)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    params["stack"][-1]["w"] = (0.03 * rng.standard_normal(
        params["stack"][-1]["w"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    tf = load_flow_params(Flow(d, "nsf3", device="cpu"), params)
    scp_j = js.whitening_params()
    j_to_x = jbridge.make_bridge_host_program(js, f32_precision(jlogp), d, jf.kernel_inv)
    t_to_x = tbridge.make_bridge_host_program(ts, tlogp, d, tf.kernel_inv)
    return SimpleNamespace(j_to_x=j_to_x, t_to_x=t_to_x, jf=jf, tf=tf, scp_j=scp_j,
                           scp_t=tensors_from_jax(scp_j, device="cpu"), js=js, ts=ts,
                           jlogp=f32_precision(jlogp), tlogp=tlogp)


def like_np(x):
    return -0.5 * np.sum((x - 0.3) ** 2, axis=-1) / 0.5


def like_torch(x):
    return -0.5 * ((x - 0.3) ** 2).sum(-1) / 0.5


def test_host_pullback_matches_jax():
    """to_x on the same flow, scaler and theta, with rows the prior rejects
    and rows pushed against the bounded dimension's edge: finite exactly,
    x to 1e-5 of each row's largest |x| and f_part to 1e-5 of its largest
    term, |log N(theta)| (the scaler's whitening sums terms of the row's
    size into each coordinate, and f_part sums its terms, so a small value
    carries their rounding)."""
    pb = _problem()
    rng = np.random.default_rng(3)
    theta = 1.5 * rng.standard_normal((300, D))
    theta[::10] *= 6.0
    theta[5::10, 2] = 40.0
    theta = theta.astype(np.float32)
    xj, fj, okj = (np.asarray(a) for a in pb.j_to_x(pb.jf.params, pb.scp_j, jnp.asarray(theta)))
    with torch.no_grad():
        xt, ft, okt = (a.numpy() for a in pb.t_to_x(pb.tf.params(), pb.scp_t, t(theta)))
    assert np.array_equal(okt, okj)
    assert okj.any() and not okj.all()
    scale = np.maximum(1.0, np.abs(xj).max(1))
    assert (np.abs(xt - xj).max(1) <= 1e-5 * scale).all()
    assert np.array_equal(np.isfinite(ft), np.isfinite(fj))
    log_n = 0.5 * (theta.astype(np.float64) ** 2).sum(1) + 1.5 * math.log(2 * math.pi)
    assert (np.abs(ft[okj] - fj[okj]) <= 1e-5 * np.maximum(1.0, log_n[okj])).all()


def test_host_bridge_first_rung_matches_jax(monkeypatch):
    """The black-box route (``host_loglike`` + ``host_draws``) with the same
    numpy seed: the same first ds and first logZ increment as the JAX
    package's run_bridge_host, to 1e-6."""
    pb = _problem()
    incs = {"j": [], "t": []}
    for key, mod in (("j", jbridge), ("t", tbridge)):
        real = mod._logmeanexp

        def record(lw, real=real, out=incs[key]):
            out.append(real(lw))
            return out[-1]

        monkeypatch.setattr(mod, "_logmeanexp", record)
    rj = jbridge.run_bridge_host(pb.j_to_x, like_np, pb.jf.params, pb.scp_j, 256, D,
                                 np.random.default_rng(7), n_steps=2)
    init, rung = tbridge.make_bridge_programs(pb.ts, pb.tlogp, tbridge.host_loglike(like_np), D,
                                              pb.tf.kernel_inv, n_steps=2)
    rt = tbridge.run_bridge(init, rung, pb.tf.params(), pb.scp_t,
                            tbridge.host_draws(256, D, 2, np.random.default_rng(7), "cpu"))
    assert rj is not None and "failed" not in rt
    assert rt["s_path"][0] < 1.0  # the first rung was bisected
    assert rt["s_path"][0] == pytest.approx(rj["s_path"][0], abs=1e-6)
    assert incs["t"][0] == pytest.approx(incs["j"][0], abs=1e-6)


def _jax_rung_noise(seed, n, d, steps):
    """The draws the JAX rung makes from ``seed``: its resample offset
    (systematic_resample_jax's uniform of k_res) and each step key's
    normals (k_prop) and uniforms (k_unif), as the port's noise dict."""
    k_res, key = jax.random.split(jax.random.key(seed))
    z, unif = [], []
    for k in jax.random.split(key, steps):
        k_prop, k_unif = jax.random.split(k)
        z.append(np.asarray(jax.random.normal(k_prop, (n, d), dtype=jnp.float32)))
        unif.append(np.asarray(jax.random.uniform(k_unif, (n,), dtype=jnp.float32)))
    return dict(u0=torch.tensor(float(jax.random.uniform(k_res, ()))), z=t(np.stack(z)),
                unif=t(np.stack(unif)))


def test_device_rung_matches_jax():
    """One device rung against the JAX package's make_bridge_programs rung
    on the same flow, scaler, population and draws (the JAX rung's, injected):
    theta, f, sigma and the mean acceptance to 1e-5, the same call count.
    At d=8 and s = 0.08 the acceptance stays above its target, so sigma
    climbs until the misfit cap (between 2.38/sqrt(d) = 0.84 and 0.99)
    stops it."""
    n, d, steps, seed = 256, 8, 4, 5
    pb = _problem(d=d)

    def jlike(x, mask):
        return -0.5 * jnp.sum((x - 0.3) ** 2, axis=-1) / 0.5

    jinit, jrung = jbridge.make_bridge_programs(pb.js, pb.jlogp, jlike, d, pb.jf.kernel_inv,
                                                n_steps=steps)
    theta, f, _ = jinit(pb.jf.params, pb.scp_j, 3, n=n)
    want = [np.asarray(a) for a in jrung(theta, f, jnp.float32(0.9), jnp.float32(0.08),
                                         jnp.float32(0.05), seed, pb.jf.params, pb.scp_j)]
    init, rung = tbridge.make_bridge_programs(pb.ts, pb.tlogp, make_loglike(like_torch), d,
                                              pb.tf.kernel_inv, n_steps=steps)
    fp = pb.tf.params()
    f_t, _ = init(t(theta), fp, pb.scp_t)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f), rtol=1e-5, atol=1e-5)
    out = rung(t(theta), t(f), torch.tensor(0.9), 0.08, 0.05, _jax_rung_noise(seed, n, d, steps),
               fp, pb.scp_t)
    np.testing.assert_allclose(out[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), want[1], rtol=1e-5, atol=1e-5)
    assert float(out[2]) == pytest.approx(float(want[2]), abs=1e-5)
    assert float(out[3]) == pytest.approx(float(want[3]), abs=1e-5)
    assert int(out[4]) == int(want[4])
    assert 0.234 < float(out[3]) < 1.0  # a real mix of accepts, above the target
    assert 0.85 < float(out[2]) < 0.98  # so the cap held sigma


def test_bridge_runs_with_grad_disabled():
    """With grad on and a FlowParams inside the autograd graph (as
    ``Flow.params()`` gives it then), every bridge program runs under
    no_grad: no output requires grad and the likelihood sees grad off (on
    the card K1 would raise otherwise)."""
    pb = _problem()
    seen = []

    def like(x):
        seen.append(torch.is_grad_enabled())
        return like_torch(x)

    assert torch.is_grad_enabled()
    fp = pb.tf.params()
    assert fp.ws[0].requires_grad
    init, rung = tbridge.make_bridge_programs(pb.ts, pb.tlogp, make_loglike(like), D,
                                              pb.tf.kernel_inv, n_steps=2)
    g = torch.Generator().manual_seed(0)
    theta = torch.randn(128, D, generator=g)
    outs = list(pb.t_to_x(fp, pb.scp_t, theta)) + list(init(theta, fp, pb.scp_t))
    outs += list(rung(theta, outs[3], torch.tensor(0.9), 0.5, 0.5,
                      tbridge.draw_rung_noise(128, D, 2, g, "cpu"), fp, pb.scp_t))
    assert not any(o.requires_grad for o in outs)
    res = tbridge.run_bridge(init, rung, fp, pb.scp_t,
                             tbridge.device_draws(128, D, 2, g, np.random.default_rng(0)))
    assert "failed" not in res and np.isfinite(res["logz"])
    assert seen and not any(seen)


# -- known answers (tests/test_bridge.py) ---------------------------------------------

def _gauss(d=4, ps=5.0):
    def loglike(x):
        return -0.5 * (x * x).sum(-1) - d / 2 * math.log(2 * math.pi)
    expect = d * norm.logpdf(0, 0, np.sqrt(1 + ps ** 2))
    prior = tpc.Prior([tpc.Normal(0, ps) for _ in range(d)])
    return loglike, prior, expect


def _sampler(loglike, prior, **kw):
    base = dict(vectorize=True, random_state=0, n_effective=256, n_active=128, flow="nsf3",
                train_config={"epochs": 40, "patience": 5}, device="cpu")
    base.update(kw)
    return Sampler(prior, loglike, **base)


@pytest.fixture(scope="module")
def bridge_on():
    loglike, prior, expect = _gauss()
    s = _sampler(loglike, prior, bridge_n=1024)
    s.run(n_total=512, n_evidence=0, progress=False)
    return s, expect


def test_bridge_known_answer_default_on(bridge_on):
    """run(n_evidence=0) reports the bridge estimate by default, within
    0.35 of the analytic evidence, on a short schedule."""
    s, expect = bridge_on
    bd = s.bridge_diagnostics
    assert bd is not None and 1 <= bd["rungs"] <= 6 and bd["calls"] >= 1024
    assert s.logz == pytest.approx(bd["logz"]) and s.logz_err == bd["logz_err"]
    assert s.logz == pytest.approx(expect, abs=0.35)
    assert set(bd) == {"logz", "logz_err", "rungs", "calls", "ess_min", "accept_last",
                       "s_path"}
    assert bd["s_path"][-1] == 1.0 and s.phase_seconds["bridge"] > 0.0
    assert s.evidence_khat is None  # no flow-IS draws


def test_bridge_off_keeps_ladder():
    loglike, prior, _ = _gauss()
    s = _sampler(loglike, prior, evidence_bridge=False)
    s.run(n_total=512, n_evidence=0, progress=False)
    assert s.bridge_diagnostics is None and s.logz_err is None
    rec = float(s.particles.compute_logw_and_logz(1.0, recorrect=True)[1])
    assert s.logz == pytest.approx(rec)


@pytest.mark.parametrize("kwargs,match", [
    (dict(evidence_bridge="bogus"), "evidence_bridge"),
    (dict(bridge_n=1), "bridge_n"),
    (dict(bridge_steps=0), "bridge_steps"),
    (dict(precondition=False, evidence_bridge=True), "evidence_bridge"),
])
def test_bridge_validation(kwargs, match):
    loglike, prior, _ = _gauss()
    with pytest.raises(ValueError, match=match):
        Sampler(prior, loglike, vectorize=True, device="cpu", **kwargs)


def test_bridge_blackbox_host_path():
    """A plain-numpy likelihood takes the host route of the bridge (0.4;
    0 < logz_err < 0.5)."""
    d = 2

    def loglike(x):
        x = np.asarray(x)
        return -0.5 * np.sum(x ** 2, axis=-1) - d / 2 * np.log(2 * np.pi)

    expect = d * norm.logpdf(0, 0, np.sqrt(26.0))
    s = _sampler(loglike, tpc.Prior([tpc.Normal(0, 5) for _ in range(d)]), bridge_n=512,
                 train_config={"epochs": 30, "patience": 5})
    assert not s.likelihood_traceable
    s.run(n_total=512, n_evidence=0, progress=False)
    assert s.bridge_diagnostics is not None and s.bridge_diagnostics["rungs"] >= 1
    assert s.logz == pytest.approx(expect, abs=0.4)
    assert s.logz_err is not None and 0 < s.logz_err < 0.5


def test_bridge_counts_calls(bridge_on):
    loglike, prior, _ = _gauss()
    s0 = _sampler(loglike, prior, evidence_bridge=False)
    s0.run(n_total=512, n_evidence=0, progress=False)
    s1, _ = bridge_on
    assert s1.calls >= s0.calls + 1024
    assert s1.calls == s0.calls + s1.bridge_diagnostics["calls"]


# -- deliberate departures from the JAX package ---------------------------------------

@pytest.mark.parametrize("route", ["device", "host"])
def test_failed_bridge_counts_calls_and_warns(route, monkeypatch):
    """A bridge that gives up (here: max_rungs=0, so it stops after the
    s = 0 draws) still adds its likelihood calls to Sampler.calls (the JAX
    package drops them, sampler.py:2226-2227), and the fallback to the
    ladder warns with the reason (the JAX package is silent)."""
    real = tbridge.run_bridge
    seen = {}

    def give_up(*a, **k):
        seen["calls_before"] = s.calls
        seen["res"] = real(*a, **dict(k, max_rungs=0))
        return seen["res"]

    monkeypatch.setattr(tbridge, "run_bridge", give_up)
    d = 2
    if route == "device":
        loglike = lambda x: -0.5 * (x * x).sum(-1)  # noqa: E731
    else:
        loglike = lambda x: -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)  # noqa: E731
    s = _sampler(loglike, tpc.Prior([tpc.Normal(0, 5) for _ in range(d)]), n_effective=128,
                 n_active=64, bridge_n=256, train_config={"epochs": 10, "patience": 3})
    assert s.likelihood_traceable == (route == "device")
    with pytest.warns(RuntimeWarning, match="max_rungs"):
        s.run(n_total=256, n_evidence=0, progress=False)
    assert "max_rungs" in seen["res"]["failed"] and seen["res"]["calls"] == 256
    assert s.calls == seen["calls_before"] + 256
    assert s.bridge_diagnostics is None and s.logz_err is None
    rec = float(s.particles.compute_logw_and_logz(1.0, recorrect=True)[1])
    assert s.logz == pytest.approx(rec)


def test_flow_free_ladder_falls_back_silently():
    """precondition=False under evidence_bridge='auto' has no flow to
    bridge from: the ladder, with no warning, as in the JAX package."""
    s = Sampler(tpc.Prior([tpc.Normal(0, 5), tpc.Normal(0, 5)]), lambda x: -(x * x).sum(-1),
                vectorize=True, random_state=0, n_effective=128, n_active=64,
                precondition=False, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        s.run(n_total=256, n_evidence=0, progress=False)
    assert s.bridge_diagnostics is None and np.isfinite(s.logz)
