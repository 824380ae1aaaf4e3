"""The PyTorch port's t-pCN sweep against the JAX package on the CPU.

JAX threefry and torch generators never give the same numbers, so the
step test rebuilds each JAX step's draws from its key (the split of
``pocomc_tpu/mcmc.py:368``: gamma mix, normals, acceptance uniforms) and
hands the same numbers to the port's step."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pocomc_tpu as jpc
from pocomc_tpu.mcmc import make_sweep, make_loglike_device, f32_precision
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu.models.geometry import _fit_geometry_impl
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import load_flow_params, tensors_from_jax
from pocomc_tpu_torch.mcmc import Sweep, make_loglike, t_correction
from pocomc_tpu_torch.models.flow import Flow

D, N, NU = 3, 64, 5.0
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


def _setup():
    """Both packages' scaler, prior, flow (same random weights), sweep and
    a starting population with its geometry (nu set to a moderate 5)."""
    rng = np.random.default_rng(0)
    bounds = np.array([[-np.inf, np.inf]] * D)
    js, ts = (m.Reparameterize(D, bounds=bounds) for m in (jpc, tpc))
    prior_x = 5.0 * rng.standard_normal((512, D))
    js.fit(prior_x)
    ts.fit(prior_x)
    scp_j = js.whitening_params()
    scp_t = tensors_from_jax(scp_j, device="cpu")
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
    logp = jprior.logpdf(x)
    logl = j_like(x)
    theta, _ = jf.forward(jnp.asarray(u))
    geom = jax.jit(_fit_geometry_impl)(theta, jnp.ones(N, jnp.float32), jax.random.key(0))
    geom["t_nu"] = jnp.float32(NU)

    jsweep = make_sweep(js, f32_precision(jprior.logpdf),
                        make_loglike_device(j_like, True, True), D, 1, 100,
                        kind="tpcn", preconditioned=True, flow_fwd=jf.kernel_fwd,
                        flow_inv=jf.kernel_inv, **KNOBS)
    tsweep = Sweep(ts, tprior.logpdf, make_loglike(t_like), tf, D, 1, 100, **KNOBS)
    start = [np.asarray(a) for a in (u, x, ldj, logl, logp)]
    return jsweep, tsweep, jf, tf, scp_j, scp_t, geom, start


def test_tpcn_steps_match_jax_with_injected_draws():
    """Eight steps (one drift window closes at step 6) of propose +
    accept_update with the JAX draws injected: same accept decisions and
    states within 1e-4 (fp32; the correction forms differ by rounding at
    nu = 5), and the same stopping decision as the JAX host rule."""
    jsweep, tsweep, jf, tf, scp_j, scp_t, geom, start = _setup()
    beta, sigma0, dbeta = 0.6, 0.5, 0.1
    key = jax.random.key(42)
    sj = jsweep.init_state(*map(jnp.asarray, start), jnp.float32(beta), jnp.float32(sigma0),
                           geom, key, flow_params=jf.params, scaler_params=scp_j,
                           dbeta=dbeta)
    geom_t = tensors_from_jax(geom, device="cpu")
    with torch.no_grad():
        fp = tf.params()
        st = tsweep.init_state(*map(t, start), sigma0, geom_t, fp, dbeta=dbeta)
        loglike_j = make_loglike_device(j_like, True, True)
        decisions = []
        for step in range(8):
            _, kg, kn, ku = jax.random.split(sj.key, 4)
            noise = dict(g=t(jax.random.gamma(kg, 0.5 * (D + NU), (N,))),
                         z=t(jax.random.normal(kn, (N, D))),
                         unif=t(jax.random.uniform(ku, (N,))))
            prop_j = jsweep.propose(sj, jnp.float32(beta), geom, jf.params, scp_j)
            sj, acc_j, stats_j = jsweep.accept_update(
                sj, prop_j, loglike_j(prop_j["x_safe"], prop_j["finite"]),
                jnp.float32(beta), geom)
            prop_t = tsweep.propose(st, geom_t, fp, scp_t, noise)
            st, acc_t = tsweep.accept_update(
                st, prop_t, tsweep.log_like(prop_t["x_safe"], prop_t["finite"]), beta,
                geom_t)
            assert np.array_equal(acc_t.numpy(), np.asarray(acc_j)), step
            decisions.append(acc_t.numpy())
            for name in ("u", "x", "logl", "theta", "sigma", "mu", "corr", "misfit",
                         "hot", "resid", "z_logl", "z_dim"):
                np.testing.assert_allclose(getattr(st, name).numpy(),
                                           np.asarray(getattr(sj, name)),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{name} @ {step}")
            assert int(st.cnt) == int(sj.cnt) and int(st.calls) == int(sj.calls)
            assert st.i == int(sj.i) and st.i_snap == int(sj.i_snap)
            s = np.asarray(stats_j)
            assert tsweep.keep_going(st) == jsweep.should_continue(
                int(s[0]), int(s[1]), float(s[2]), float(s[4]), float(s[5]),
                float(s[6]), dbeta, float(s[7]))
    decisions = np.concatenate(decisions)
    assert decisions.any() and not decisions.all()  # a real mix of accepts
    assert st.i_snap == 6  # the drift window closed inside the test


def test_t_correction_at_gaussian_sentinel_matches_f64():
    """At nu = 1e6 the port's fp32 correction -half*log1p(q/nu) agrees with
    f64 math to 1e-3 nat (the JAX form log(nu+q) - log(nu) cancels there)."""
    nu, d = 1e6, 10
    q = np.concatenate([np.linspace(0.0, 50.0, 501), [1e3, 1e4]])
    exact = -0.5 * (d + nu) * np.log1p(q / nu)
    got = t_correction(t(q), torch.tensor(nu, dtype=torch.float32), d).double().numpy()
    assert np.abs(got - exact).max() < 1e-3
    # the differences the Metropolis ratio uses, too
    assert np.abs((got[1:] - got[:-1]) - (exact[1:] - exact[:-1])).max() < 1e-3


def test_sweep_runs_to_a_stop_on_cpu():
    """A whole sweep: stops inside n_max, moves the population, counts one
    likelihood call per finite proposal."""
    _, tsweep, _, tf, _, scp_t, geom, start = _setup()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        res = tsweep.run(*map(t, start), 0.6, 0.5, tensors_from_jax(geom, device="cpu"),
                         tf.params(), scp_t, g, dbeta=0.1)
    assert 1 <= res["steps"] <= 100
    assert int(res["calls"]) <= res["steps"] * N
    assert np.isfinite(res["logl"].numpy()).all()
    assert not torch.equal(res["u"], t(start[0]))
    assert math.isfinite(float(res["resid_exit"]))
