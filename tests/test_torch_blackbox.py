"""The PyTorch port's black-box likelihood path and host SMC loop against
the JAX package on the CPU: the host bisection, blob extraction, knob
resolution, the plateau schedule, the flow-fit loss, the stepped sweep
with a numpy likelihood, and whole runs on a known answer."""

import inspect
import math
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu as jpc
from pocomc_tpu.mcmc import make_sweep, make_loglike_device, f32_precision
from pocomc_tpu.models.flow import Flow as JFlow, _PlateauLR as JPlateau
from pocomc_tpu.models.geometry import _fit_geometry_impl
from pocomc_tpu.ops.weights import bisect_beta as j_bisect
from pocomc_tpu.sampler import Sampler as JSampler
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import load_flow_params, tensors_from_jax
from pocomc_tpu_torch.mcmc import Sweep, make_loglike
from pocomc_tpu_torch.models.flow import Flow, _PlateauLR, mean_nn_distance
from pocomc_tpu_torch.ops.weights import bisect_beta
from pocomc_tpu_torch.sampler import Sampler
from pocomc_tpu_torch.utils.tools import FunctionWrapper

D = 3
TRUTH = D * norm.logpdf(0.0, 0.0, math.sqrt(26.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def row_like(x):
    """Black-box per-row likelihood: unit Gaussian, with sum(x^2) as blob."""
    return float(-0.5 * np.sum(x ** 2) - 0.5 * len(x) * np.log(2 * np.pi)), float(np.sum(x ** 2))


def row_like_plain(x):
    return row_like(x)[0]


def batch_like_np(x):
    return -0.5 * np.sum(x ** 2, axis=1) - 0.5 * x.shape[1] * np.log(2 * np.pi)


def batch_like_torch(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[-1] * math.log(2 * math.pi)


def prior(d=D):
    return tpc.Prior([tpc.Normal(0.0, 5.0) for _ in range(d)])


def small(**kw):
    return dict(random_state=0, n_effective=128, n_active=64, flow="nsf3",
                train_config=dict(epochs=30, patience=3), device="cpu", **kw)


# -- 1. bisect_beta ----------------------------------------------------------

@pytest.mark.parametrize("metric", ["ess", "uss"])
@pytest.mark.parametrize("with_b", [False, True])
def test_bisect_beta_matches_jax(metric, with_b):
    """Seeded histories, both metrics, with and without a precomputed
    mixture denominator, plus a degenerate interval: equal to 1e-12."""
    rng = np.random.default_rng(3)
    T, n = 5, 64
    logl = -0.5 * rng.chisquare(3, size=(T, n)) * 20.0
    beta = np.array([0.0, 0.01, 0.03, 0.08, 0.2])
    logz = np.cumsum(rng.normal(0, 0.3, T))
    parts = tpc.Particles(n, 1)
    for i in range(T):
        parts.update(dict(logl=logl[i], beta=beta[i], logz=logz[i]))
    B = parts.mis_denominator()[0].reshape(-1) if with_b else None
    for n_eff, beta_prev in ((100.0, 0.2), (250.0, 0.2), (5.0, 0.2), (100.0, 1.0 - 1e-17)):
        got = bisect_beta(logl, beta, logz, beta_prev, n_eff, metric=metric, B_flat=B)
        want = j_bisect(logl, beta, logz, beta_prev, n_eff, metric=metric, B_flat=B)
        assert got[0] == pytest.approx(want[0], abs=1e-12)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
        assert got[2] == pytest.approx(want[2], rel=1e-12)
        assert got[3] == pytest.approx(want[3], abs=1e-12)


# -- 2. _log_like blob extraction ---------------------------------------------

RETURNS = {
    "scalar": [1.5, -2.0, np.float32(0.25)],
    "pair": [(1.0, 2.0), (3.0, 4.5), (-1.0, 0.5)],
    "int_blob": [(1.0, 3), (2.0, -1), (0.5, 7)],
    "str_blob": [(1.0, "a"), (2.0, "bcd"), (0.5, "ef")],
    "shape1_blob": [(1.0, np.array([2.0])), (2.0, np.array([3.0])), (3.0, np.array([4.0]))],
    "override": [(1.0, 2), (2.0, 3), (3.0, 4)],
}


@pytest.mark.parametrize("case", sorted(RETURNS))
def test_log_like_blobs_match_jax(case):
    """One list of returns through both packages' host evaluation: equal
    logl and blob arrays, dtypes included."""
    table = RETURNS[case]
    x = np.arange(len(table), dtype=np.float64)[:, None] * np.ones((1, 2))
    fn = FunctionWrapper(lambda row: table[int(row[0])])
    dtype = np.float32 if case == "override" else None
    out = []
    for cls in (JSampler, Sampler):
        ns = types.SimpleNamespace(likelihood_traceable=False, vectorize=False, pool=None,
                                   distribute=map, log_likelihood=fn, blobs_dtype=dtype,
                                   have_blobs=dtype is not None)
        out.append(cls._log_like(ns, x) + (ns.have_blobs,))
    (lj, bj, hj), (lt, bt, ht) = out
    assert lt.dtype == lj.dtype and np.array_equal(lt, lj)
    assert ht == hj
    if bj is None:
        assert bt is None
    else:
        assert bt.dtype == bj.dtype and bt.shape == bj.shape
        assert np.array_equal(bt, bj)


# -- 3. knob resolution --------------------------------------------------------

@pytest.mark.parametrize("d", [2, 10, 50])
@pytest.mark.parametrize("kind", ["numpy_rows", "numpy_rows_rate", "device"])
def test_knob_resolution_matches_jax(d, kind):
    """likelihood_traceable, bias_rate, corr_threshold and bias_floor as the
    JAX Sampler resolves them for a black-box and a traceable likelihood."""
    kw = dict(n_effective=128, n_active=64, flow="nsf3", random_state=0)
    if kind == "device":
        js = JSampler(jpc.Prior([jpc.Normal(0.0, 5.0)] * d),
                      lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True, **kw)
        ts = Sampler(prior(d), batch_like_torch, vectorize=True, device="cpu", **kw)
    else:
        if kind == "numpy_rows_rate":
            kw["bias_rate"] = 0.4
        js = JSampler(jpc.Prior([jpc.Normal(0.0, 5.0)] * d), row_like_plain, **kw)
        ts = Sampler(prior(d), row_like_plain, device="cpu", **kw)
    for name in ("likelihood_traceable", "bias_rate", "corr_threshold", "bias_floor"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts._use_device_loop() == (kind == "device")


# -- 4. _PlateauLR ----------------------------------------------------------------

def test_plateau_schedule_matches_jax():
    rng = np.random.default_rng(0)
    losses = np.concatenate([np.linspace(5, 1, 20), 1 + 1e-5 * rng.standard_normal(60),
                             [0.5], np.full(40, 0.5)])
    a, b = JPlateau(1e-3, patience=4), _PlateauLR(1e-3, patience=4)
    sched = [(a.step(v), b.step(v)) for v in losses]
    assert all(x == y for x, y in sched)
    assert len({x for x, _ in sched}) > 3 and sched[-1][0] >= 1e-6


# -- 5. Flow.fit ---------------------------------------------------------------------

def _flows():
    rng = np.random.default_rng(1)
    jf = JFlow(D, "nsf3", seed=1)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    for layer in params["stack"]:
        layer["w"] = (layer["w"] + 0.05 * rng.standard_normal(layer["w"].shape)
                      ).astype(np.float32)
        layer["b"] = (0.05 * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    return jf, load_flow_params(Flow(D, "nsf3", device="cpu"), params), params, rng


def _fit_data(rng, n=512):
    u = rng.standard_normal((n, D)) * np.array([1.0, 2.0, 0.5]) + 1.0
    u[:, 1] += 0.5 * u[:, 0] ** 2
    w = rng.random(n)
    return u.astype(np.float32), (w / w.sum()).astype(np.float32)


def test_loss_fn_matches_jax():
    """The weighted NLL with both regularisers on converted weights: within
    1e-5 relative, and the gradient of the port's loss is finite."""
    jf, tf, params, rng = _flows()
    u, w = _fit_data(rng, 256)
    for lap, gau in ((None, None), (2.0, None), (None, 0.5), (2.0, 0.5)):
        want = float(jf._loss_fn(params["stack"], jnp.asarray(u), jnp.asarray(w), lap, gau))
        got = tf._loss_fn(t(u), t(w), lap, gau)
        assert float(got.detach()) == pytest.approx(want, rel=1e-5), (lap, gau)
    got.backward()
    assert all(torch.isfinite(p.grad).all() for p in tf.parameters())


def test_noise_scale_matches_jax_formula():
    """The chunked nearest-neighbour scale equals the JAX package's
    whole-matrix formula (exact duplicates excluded)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, D)).astype(np.float32)
    x[100:110] = x[:10]  # duplicates
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    d2[d2 <= 0.0] = np.inf
    want = float(np.mean(np.sqrt(np.min(d2, axis=1))))
    assert mean_nn_distance(x, chunk_elems=1000) == pytest.approx(want, rel=1e-5)
    assert mean_nn_distance(x) == pytest.approx(want, rel=1e-5)


def test_fit_with_annealing_and_noise_lowers_nll():
    _, tf, _, rng = _flows()
    u, w = _fit_data(rng)
    with torch.no_grad():
        nll0 = -float((tf.log_prob(t(u)) * t(w)).sum())
    hist = tf.fit(u, weights=w, validation_split=0.5, epochs=25, batch_size=128,
                  patience=4, annealing=True, noise=0.1, seed=0)
    with torch.no_grad():
        nll1 = -float((tf.log_prob(t(u)) * t(w)).sum())
    assert nll1 < nll0 - 0.1, (nll0, nll1)
    assert 1 <= len(hist["loss"]) == len(hist["val_loss"]) <= 25


def test_fit_on_nan_data_restores_input():
    _, tf, _, rng = _flows()
    u, w = _fit_data(rng)
    before = [p.detach().clone() for p in tf.parameters()]
    pre = {k: v.clone() for k, v in tf.get_pre().items()}
    u[::3] = np.nan
    hist = tf.fit(u, weights=w, validation_split=0.5, epochs=3, batch_size=128,
                  patience=3, seed=0)
    assert not np.isfinite(hist["val_loss"]).any()
    assert all(torch.equal(a, b) for a, b in zip(before, tf.parameters()))
    assert all(torch.equal(pre[k], v) for k, v in tf.get_pre().items())


# -- 6. stepped sweep with a host likelihood ----------------------------------------

N, NU, STEPS = 64, 5.0, 8
KNOBS = dict(plateau_z=0.75, corr_threshold=0.5, calib_z=3.0, bias_budget=0.1,
             bias_rate=0.4, bias_floor=0.5, plateau_floor=4.0)


def _sweep_setup():
    """Both packages' sweep over one flow and start population, with a
    prior that rejects x0 above a cut (so some proposals are masked)."""
    rng = np.random.default_rng(0)
    bounds = np.array([[-np.inf, np.inf]] * D)
    js, ts = (m.Reparameterize(D, bounds=bounds) for m in (jpc, tpc))
    prior_x = 5.0 * rng.standard_normal((512, D))
    js.fit(prior_x)
    ts.fit(prior_x)
    scp_j = js.whitening_params()
    jprior, tprior = jpc.Prior([jpc.Normal(0.0, 5.0)] * D), prior()
    u = (0.5 * rng.standard_normal((N, D)) + 0.1).astype(np.float32)
    x0 = np.asarray(js.inverse(jnp.asarray(u))[0])
    cut = float(np.quantile(x0[:, 0], 0.85))
    inside = np.nonzero(x0[:, 0] <= cut)[0]
    u = u[np.where(x0[:, 0] <= cut, np.arange(N), inside[np.arange(N) % len(inside)])]

    def jlogp(x):
        return jprior.logpdf(x) + jnp.where(x[:, 0] > cut, -jnp.inf, 0.0)

    def tlogp(x):
        return tprior.logpdf(x) + torch.where(x[:, 0] > cut, -math.inf, 0.0)

    def jlike(x):
        return -0.5 * jnp.sum((x - 0.5) ** 2 / 0.3, axis=-1)

    jf = JFlow(D, "nsf3", seed=1)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    params["stack"][-1]["w"] = (0.03 * rng.standard_normal(
        params["stack"][-1]["w"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    tf = load_flow_params(Flow(D, "nsf3", device="cpu"), params)
    x, ldj = js.inverse(jnp.asarray(u))
    start = [np.asarray(a) for a in (u, x, ldj, jlike(x), jlogp(x))]
    theta, _ = jf.forward(jnp.asarray(u))
    geom = jax.jit(_fit_geometry_impl)(theta, jnp.ones(N, jnp.float32), jax.random.key(0))
    geom["t_nu"] = jnp.float32(NU)
    jsweep = make_sweep(js, f32_precision(jlogp), make_loglike_device(jlike, True, True),
                        D, STEPS, STEPS, kind="tpcn", preconditioned=True,
                        flow_fwd=jf.kernel_fwd, flow_inv=jf.kernel_inv, **KNOBS)
    tsweep = Sweep(ts, tlogp, make_loglike(lambda xx: -0.5 * ((xx - 0.5) ** 2 / 0.3).sum(-1)),
                       tf, D, STEPS, STEPS, **KNOBS)
    return jsweep, tsweep, jf, tf, scp_j, tensors_from_jax(scp_j, device="cpu"), geom, start, cut


def test_stepped_sweep_host_route_matches_device_and_jax():
    """STEPS steps with the JAX draws injected: the host route (the
    sampler's per-row numpy likelihood with blobs) takes the same accept
    decisions and reaches the same states as the device route and as JAX;
    masked rows never reach the user's function, calls counts the finite
    rows and the blobs follow the accepts."""
    jsweep, tsweep, jf, tf, scp_j, scp_t, geom, start, cut = _sweep_setup()
    beta, sigma0, dbeta = 0.6, 0.5, 0.1
    sj = jsweep.init_state(*map(jnp.asarray, start), jnp.float32(beta), jnp.float32(sigma0),
                           geom, jax.random.key(42), flow_params=jf.params,
                           scaler_params=scp_j, dbeta=dbeta)
    loglike_j = make_loglike_device(
        lambda x: -0.5 * jnp.sum((x - 0.5) ** 2 / 0.3, axis=-1), True, True)
    noises, acc_j = [], []
    for _ in range(STEPS):
        _, kg, kn, ku = jax.random.split(sj.key, 4)
        noises.append(dict(g=t(jax.random.gamma(kg, 0.5 * (D + NU), (N,))),
                           z=t(jax.random.normal(kn, (N, D))),
                           unif=t(jax.random.uniform(ku, (N,)))))
        prop = jsweep.propose(sj, jnp.float32(beta), geom, jf.params, scp_j)
        sj, acc, stats = jsweep.accept_update(
            sj, prop, loglike_j(prop["x_safe"], prop["finite"]), jnp.float32(beta), geom)
        acc_j.append(np.asarray(acc))
    s = np.asarray(stats)
    assert not jsweep.should_continue(int(s[0]), int(s[1]), float(s[2]), float(s[4]),
                                      float(s[5]), float(s[6]), dbeta, float(s[7]))

    seen = []

    def user_like(row):
        seen.append(row.copy())
        return -0.5 * float(np.sum((row - 0.5) ** 2 / 0.3)), float(np.sum(row ** 2))

    host = Sampler(prior(), user_like, blobs_dtype=np.float64, n_active=N, flow="nsf3",
                   device="cpu")
    tsweep.draw_noise = lambda st, g, gen: noises[st.i]
    masks = []
    real_accept = tsweep.accept_update

    def recording_accept(*a):
        st, acc = real_accept(*a)
        masks.append(acc.numpy())
        return st, acc

    tsweep.accept_update = recording_accept
    geom_t, fp = tensors_from_jax(geom, device="cpu"), tf.params()
    args = (*map(t, start), beta, sigma0, geom_t, fp, scp_t, None)
    blobs0 = (start[1].astype(np.float32).astype(np.float64) ** 2).sum(1)
    with torch.no_grad():
        dev = tsweep.run(*args, dbeta=dbeta)
        masks_dev, masks[:] = list(masks), []
        hst, blobs = tsweep.run_stepped(*args, host_like=host._log_like, blobs=blobs0,
                                        dbeta=dbeta)
    assert dev["steps"] == hst["steps"] == STEPS
    for k in range(STEPS):
        assert np.array_equal(masks[k], acc_j[k]) and np.array_equal(masks_dev[k], acc_j[k]), k
    for name in ("u", "x", "logl", "logp", "logdetj"):
        np.testing.assert_allclose(hst[name].numpy(), dev[name].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hst[name].numpy(), np.asarray(getattr(sj, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("proposal_scale", "corr", "resid", "hot"):
        assert float(hst[name]) == pytest.approx(float(dev[name]), rel=1e-5, abs=1e-5)
    seen = np.array(seen)
    assert len(seen) == hst["calls"] == int(dev["calls"]) == int(sj.calls)
    assert hst["calls"] < STEPS * N  # some proposals were masked ...
    assert (seen[:, 0] <= cut).all()  # ... and never reached the function
    x_end = hst["x"].double().numpy()
    np.testing.assert_allclose(blobs, (x_end ** 2).sum(1), rtol=1e-12)
    assert (np.concatenate(masks).any() and not np.concatenate(masks).all())


# -- 7. end to end ----------------------------------------------------------------------

class MapPool:
    """A pool object: anything with ``map``."""

    def __init__(self):
        self.rows = 0

    def map(self, fn, rows):
        rows = list(rows)
        self.rows += len(rows)
        return [fn(r) for r in rows]


@pytest.fixture(scope="module")
def blob_run():
    s = Sampler(prior(), row_like, blobs_dtype=np.float64, **small())
    s.run(n_total=1024, n_evidence=1024, progress=False)
    return s


def _check_run(s):
    logz, dlogz = s.evidence()
    assert abs(logz - TRUTH) < 0.5, (logz, TRUTH)
    assert np.isfinite(dlogz) and s.results["beta"][-1] == 1.0
    x, w, _, _ = s.posterior()
    assert x.shape[1] == D and np.isfinite(x).all() and np.isclose(w.sum(), 1.0)


def test_black_box_run_with_blobs(blob_run):
    s = blob_run
    assert s.likelihood_route == "host_rows" and not s._use_device_loop()
    _check_run(s)
    x, w, logl, logp, blobs = s.posterior(return_blobs=True)
    np.testing.assert_allclose(blobs, (x ** 2).sum(1), rtol=1e-5)
    assert s.results["blobs"].shape == (s.particles.t, 64)


@pytest.mark.parametrize("case", ["pool", "numpy_vectorized", "torch_annealing",
                                  "device_loop_off"])
def test_host_loop_runs_reach_the_known_answer(case):
    if case == "pool":
        pool = MapPool()
        s = Sampler(prior(), row_like_plain, pool=pool, **small())
        route = "host_rows"
    elif case == "numpy_vectorized":
        s = Sampler(prior(), batch_like_np, vectorize=True, **small())
        route = "host_batch"
    elif case == "torch_annealing":
        kw = small()
        kw["train_config"]["annealing"] = True
        s = Sampler(prior(), batch_like_torch, vectorize=True, **kw)
        route = "device"
    else:
        s = Sampler(prior(), batch_like_torch, vectorize=True, device_loop=False, **small())
        route = "device"
    assert s.likelihood_route == route and not s._use_device_loop()
    s.run(n_total=1024, n_evidence=1024, progress=False)
    _check_run(s)
    if case == "pool":
        assert pool.rows == s.calls
    assert len(s._iter_stats) == s.t - 4  # four warmup stages


def test_pytorch_threads_caps_torch_threads():
    try:
        Sampler(prior(), row_like_plain, pytorch_threads=2, **small())
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(1)


def test_invalid_black_box_options_raise():
    with pytest.raises(ValueError, match="device_loop=True"):
        Sampler(prior(), row_like_plain, device_loop=True, **small())
    with pytest.raises(ValueError, match="blobs"):
        Sampler(prior(), batch_like_np, vectorize=True, blobs_dtype=float, **small())


# -- 8. posterior ---------------------------------------------------------------------------

def test_posterior_takes_the_jax_argument_order(blob_run):
    assert (list(inspect.signature(Sampler.posterior).parameters)
            == list(inspect.signature(JSampler.posterior).parameters))
    x, logl, logp, blobs = blob_run.posterior(True, True)
    np.testing.assert_allclose(blobs, (x ** 2).sum(1), rtol=1e-5)
    s = Sampler(prior(), batch_like_torch, vectorize=True, **small())
    with pytest.raises(ValueError, match="No blobs"):
        s.posterior(False, True)


# -- MPIPool (the port's copy) -------------------------------------------------------

def test_mpipool_maps_in_order(monkeypatch):
    """The port's MPIPool against an in-process stand-in for an MPI world
    of four: results come back in task order and close() poisons every
    worker once."""
    sent, results = [], []

    class Comm:
        size = 4

        def Get_rank(self):
            return 0

        def Get_size(self):
            return self.size

        def send(self, obj, dest=None, tag=0):
            sent.append(dest) if obj is None else results.append((dest, tag, obj[0](obj[1])))

        def recv(self, source=None, tag=None, status=None):
            status.source, status.tag, out = results.pop(0)
            return out

    mpi = types.SimpleNamespace(COMM_WORLD=Comm(), ANY_SOURCE=-1, ANY_TAG=-1,
                                Status=lambda: types.SimpleNamespace(source=None, tag=None))
    monkeypatch.setitem(sys.modules, "mpi4py", types.SimpleNamespace(MPI=mpi))
    with tpc.MPIPool() as pool:
        rows = [np.full(D, float(i)) for i in range(9)]
        assert pool.map(row_like_plain, rows) == [row_like_plain(r) for r in rows]
    assert sorted(sent) == [1, 2, 3]
