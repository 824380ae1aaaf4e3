"""Parity of the PyTorch port's scaler, prior, geometry, weights, PSIS and
phase A (reweight) with the JAX package on the CPU. Tolerances are
stated per test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pocomc_tpu as jpc
from pocomc_tpu.models.geometry import _fit_geometry_impl
from pocomc_tpu.models.student import fit_mvstud as j_fit_mvstud
from pocomc_tpu.ops import psis as jpsis, weights as jw
from pocomc_tpu.parallel import fused as jfused
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch import phases
from pocomc_tpu_torch.convert import tensors_from_jax
from pocomc_tpu_torch.models.geometry import fit_geometry
from pocomc_tpu_torch.models.student import fit_mvstud
from pocomc_tpu_torch.ops import psis as tpsis, weights as tw
from pocomc_tpu_torch.ops.resampling import (multinomial_resample_torch,
                                             systematic_resample_torch)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


# -- scaler and prior ---------------------------------------------------------

BOUNDS = {
    "none": (np.array([[-np.inf, np.inf]] * 3), None, None),
    "both": (np.array([[-2.0, 3.0], [0.0, 1.0], [-10.0, 10.0]]), None, None),
    "mixed": (np.array([[0.0, np.inf], [-np.inf, 1.0], [-1.0, 1.0]]), None, None),
    "periodic": (np.array([[0.0, 6.0], [-1.0, 1.0], [-np.inf, np.inf]]), [0], [1]),
}


@pytest.mark.parametrize("transform", ["probit", "logit"])
@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_scaler_matches_jax(case, transform):
    """forward / inverse / log-det / boundary wrap with the same fitted
    moments; tolerance 1e-4 relative + 1e-4 absolute (fp32 erf/erfinv)."""
    bounds, per, ref = BOUNDS[case]
    rng = np.random.default_rng(0)
    lo = np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -5.0)
    hi = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 5.0)
    x = lo + (hi - lo) * rng.uniform(0.02, 0.98, (200, 3))
    js = jpc.Reparameterize(3, bounds=bounds, periodic=per, reflective=ref,
                            transform=transform)
    ts = tpc.Reparameterize(3, bounds=bounds, periodic=per, reflective=ref,
                            transform=transform)
    js.fit(x)
    ts.fit(x)
    scp = tensors_from_jax(js.whitening_params(), device="cpu")
    x32 = x.astype(np.float32)
    uj = js.forward(jnp.asarray(x32))
    ut = ts.forward(t(x32), params=scp)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-4, atol=1e-4)
    xj, lj = js.inverse(uj)
    xt, lt = ts.inverse(t(np.asarray(uj)), params=scp)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    wide = (x32 - 0.5) * 3.0
    np.testing.assert_allclose(
        ts.apply_boundary_conditions_x(t(wide)).numpy(),
        np.asarray(js.apply_boundary_conditions_x(jnp.asarray(wide))), rtol=1e-5, atol=1e-5)


def test_prior_logpdf_matches_jax():
    """Normal / Uniform product priors inside and outside the support;
    tolerance 1e-5."""
    jp = jpc.Prior([jpc.Normal(1.0, 3.0), jpc.Uniform(-2.0, 4.0), jpc.Normal(0.0, 0.5)])
    tp = tpc.Prior([tpc.Normal(1.0, 3.0), tpc.Uniform(-2.0, 4.0), tpc.Normal(0.0, 0.5)])
    x = np.random.default_rng(1).uniform(-6, 6, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(tp.logpdf(t(x)).numpy(), np.asarray(jp.logpdf(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(tp.bounds, jp.bounds)
    draws = tp.rvs(1000, random_state=3)
    assert draws.shape == (1000, 3) and np.isfinite(tp.logpdf(t(draws)).numpy()).all()
    # a distribution the port does not know (here the JAX package's) is a
    # host column: the prior is not traceable and runs in numpy
    host = tpc.Prior([jpc.Normal(1.0, 3.0), tpc.Uniform(-2.0, 4.0), tpc.Normal(0.0, 0.5)])
    assert not host.traceable and tp.traceable
    np.testing.assert_allclose(host.logpdf(x.astype(np.float64)), tp.logpdf(t(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


# -- Student-t EM and geometry ------------------------------------------------

@pytest.mark.parametrize("kind", ["student", "gauss"])
def test_fit_mvstud_matches_jax(kind):
    """EM fit on the same points; tolerance 1e-3 relative on mu/Sigma and
    2% on a finite nu (fp32 EM, 60-step log-space bisection)."""
    rng = np.random.default_rng(2)
    if kind == "student":
        g = rng.chisquare(4.0, (400, 1)) / 4.0
        x = rng.standard_normal((400, 3)) / np.sqrt(g)
    else:
        x = rng.standard_normal((400, 3))
    x = (x @ np.array([[1.0, 0.3, 0.0], [0.0, 1.0, 0.5], [0.0, 0.0, 2.0]])).astype(np.float32)
    mj, sj, nj = j_fit_mvstud(jnp.asarray(x))
    mt, st, nt = fit_mvstud(t(x))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-3, atol=1e-3)
    if np.isfinite(float(nj)):
        assert abs(float(nt) / float(nj) - 1.0) < 0.02
    else:
        assert not np.isfinite(float(nt))


def test_geometry_matches_jax():
    """Weighted geometry fit with the systematic resample's offset taken
    from the JAX key; tolerance 1e-3 relative + 1e-3 absolute (fp32 EM,
    Ledoit-Wolf shrinkage, Cholesky and inverse)."""
    rng = np.random.default_rng(3)
    theta = (rng.standard_normal((512, 4)) @ rng.standard_normal((4, 4))).astype(np.float32)
    w = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    key = jax.random.key(5)
    gj = jax.jit(_fit_geometry_impl)(jnp.asarray(theta), jnp.asarray(w), key)
    u0 = t(float(jax.random.uniform(key, ())))
    gt = fit_geometry(t(theta), t(w), u0=u0)
    assert set(gt) == set(gj)
    for k in gt:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_resampling_torch_matches_searchsorted():
    """Device resampling with given uniforms = inverse-CDF lookup."""
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 1, 50)
    u = rng.uniform(0, 1, 200)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    ref = np.clip(np.searchsorted(cdf, u, side="right"), 0, 49)
    got = multinomial_resample_torch(200, t(w, np.float64), u=t(u, np.float64))
    assert np.array_equal(got.numpy(), ref)
    pos = (0.3 + np.arange(50)) / 50
    ref_s = np.clip(np.searchsorted(cdf, pos, side="right"), 0, 49)
    got_s = systematic_resample_torch(50, t(w, np.float64), u0=torch.tensor(0.3, dtype=torch.float64))
    assert np.array_equal(got_s.numpy(), ref_s)


# -- weights ------------------------------------------------------------------

def _history(seed=6, t_max=8, t_fill=5, n=64):
    rng = np.random.default_rng(seed)
    logl = (-0.5 * rng.chisquare(3, (t_max, n)) * 4.0).astype(np.float32)
    beta = np.array([0, 0, 0.05, 0.2, 0.45, 0, 0, 0], np.float32)
    logz = np.array([0, 0, -0.4, -1.3, -2.2, 0, 0, 0], np.float32)
    valid = np.arange(t_max) < t_fill
    return logl, beta, logz, valid


def test_ess_uss_trim_match_jax():
    """Device ESS/USS/trim (masked) against the JAX device versions and
    the host versions; tolerance 1e-5 relative."""
    rng = np.random.default_rng(7)
    w = rng.exponential(1.0, 400).astype(np.float32) ** 3
    valid = np.arange(400) < 350
    np.testing.assert_allclose(float(tw.ess_torch(t(w))), float(jw.ess_jax(jnp.asarray(w))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tw.uss_torch(t(w), 256)),
                               float(jw.uss_jax(jnp.asarray(w), 256)), rtol=1e-5)
    np.testing.assert_allclose(float(tw.ess_torch(t(w))),
                               tw.effective_sample_size(w), rtol=1e-5)
    wt = tw.trim_weights_torch(t(w), torch.from_numpy(valid))
    wj = jw.trim_weights_jax(jnp.asarray(w), jnp.asarray(valid))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-9)
    mask, wh = tw.trim_weights(w[valid])
    np.testing.assert_allclose(wt.numpy()[:350][mask], wh, rtol=1e-4)


def test_compute_logw_and_logz_host_and_device_match_jax():
    """MIS log-weights/logZ: host f64 port = JAX host exactly; torch
    device version against the JAX device version (1e-4, fp32) and the
    host f64 version (1e-3)."""
    logl, beta, logz, valid = _history()
    k = int(valid.sum())
    lw_h, lz_h = tw.compute_logw_and_logz(logl[:k], beta[:k], logz[:k], 0.7)
    lw_j, lz_j = jw.compute_logw_and_logz(logl[:k], beta[:k], logz[:k], 0.7)
    np.testing.assert_array_equal(lw_h, lw_j)
    assert lz_h == lz_j
    lw_t, lz_t = tw.compute_logw_and_logz_torch(t(logl), t(beta), t(logz),
                                                torch.from_numpy(valid), torch.tensor(0.7))
    lw_jd, lz_jd = jw.compute_logw_and_logz_jax(jnp.asarray(logl), jnp.asarray(beta),
                                                jnp.asarray(logz), jnp.asarray(valid),
                                                jnp.float32(0.7))
    np.testing.assert_allclose(lw_t.numpy(), np.asarray(lw_jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(lz_t), float(lz_jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lw_t.numpy()[:k * 64], lw_h, rtol=1e-3, atol=1e-3)
    assert (lw_t.numpy()[k * 64:] < -1e29).all()


def test_psis_matches_jax():
    """PSIS smoothing and k-hat: the numpy code moved over unchanged."""
    rng = np.random.default_rng(8)
    for df in (2.0, 10.0):
        logw = np.log(rng.pareto(df, 2000) + 1.0)
        a, ka = tpsis.psislw(logw)
        b, kb = jpsis.psislw(logw)
        np.testing.assert_array_equal(a, b)
        assert ka == kb


def test_reweight_phase_matches_jax():
    """Phase A on the same fixed-shape history: next beta, logZ rung (with
    the resid_prev correction), dynamic n_effective, trimmed weights and
    the top-K set; tolerance 1e-4 (fp32 bisection and MIS weights)."""
    logl, beta, logz, valid = _history(seed=9)
    t_fill, (t_max, n), d = int(valid.sum()), logl.shape, 3
    rng = np.random.default_rng(10)
    u = rng.standard_normal((t_max, n, d)).astype(np.float32)
    zeros = np.zeros((t_max, n), np.float32)
    hj = jfused.history_from_numpy(u[:t_fill], u[:t_fill], zeros[:t_fill], logl[:t_fill],
                                   zeros[:t_fill], beta[:t_fill], logz[:t_fill], t_max)
    ht = phases.history_from_numpy(u[:t_fill], u[:t_fill], zeros[:t_fill], logl[:t_fill],
                                   zeros[:t_fill], beta[:t_fill], logz[:t_fill], t_max, "cpu")
    n_select, n_active, n_eff = 256, 64, 100.0
    ratio = tw.unique_sample_size(np.ones(128), k=n_active) / n_active
    prog = jfused.make_reweight_program(n_select, n_active, dynamic_ratio=ratio,
                                        bias_budget=0.1)
    oj = prog(hj, jnp.float32(n_eff), jnp.float32(4096.0), jnp.float32(-0.8))
    ot = phases.reweight(ht, torch.tensor(n_eff), 4096.0, torch.tensor(-0.8), n_select,
                         n_active, dynamic_ratio=ratio, bias_budget=0.1)
    np.testing.assert_allclose(ot["stats"].numpy(), np.asarray(oj["stats"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ot["w_flat"].numpy(), np.asarray(oj["w_flat"]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(ot["w_sel"].numpy(), np.asarray(oj["w_sel"]), rtol=1e-4,
                               atol=1e-7)
    # the top-K rows carry the same weighted set (ties among zero weights
    # may come in another order)
    np.testing.assert_allclose((ot["w_sel"][:, None] * ot["u_sel"]).sum(0).numpy(),
                               np.asarray((oj["w_sel"][:, None] * oj["u_sel"]).sum(0)),
                               rtol=1e-4, atol=1e-5)
