"""The PyTorch port's gradient kernels (``sample="mala"``/``"hmc"``) against
the JAX package on the CPU.

The flows' inverse gradients: the port's plain inverse under autograd and
the CUDA kernels' twins (``ar_inverse_vjp_ref``, ``coupling_inverse_vjp_ref``,
what K1-bwd and K5-inv-bwd compute) against ``jax.vjp`` of the JAX
``Flow.kernel_inv``, the same numpy weights carried across by
``convert.load_flow_params``; the sweep's v-space target gradient against
``jax.grad`` of the target assembled from the JAX package's public
pieces; and mirrors of ``tests/test_mala.py``'s gates. The CUDA kernels
are held to these plain versions on a card in ``tests/test_torch_gpu.py``
(marked ``gpu``); one sweep step of each kind against a one-step JAX
sweep is in ``tests/test_torch_plain.py``.

Tolerance on a gradient: 1e-4 of the largest element (chip_smoke.py
TOL[10]["grad"]: fp32 sums in another order). Rows where a transform's
input lies within 1e-5 of a knot of its spline in float64, with dL/dladj
nonzero, are left out: the log-det's gradient jumps at a knot, and which
side an input falls on turns on the last bit of the knot, which two
correct fp32 implementations may round differently (chip_smoke.py
``edge_rows``).

Run as a script, ``python tests/test_torch_gradient.py mala`` (or ``hmc``)
runs the JAX package's own quickstart with that kernel on the CPU
(``JAX_PLATFORMS=cpu``, seed 0) and prints its logZ, calls and wall: the
reference the port's quickstart with the same kernel is compared with.
"""

import copy
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import multivariate_normal

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu_torch.convert import load_flow_params
from pocomc_tpu_torch.mcmc import Sweep, _detached, make_loglike
from pocomc_tpu_torch.models import transforms as tr
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.models.geometry import fit_geometry
from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk

N = 64
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def random_params(d, arch, seed, scale=0.02, bins=8):
    """A JAX flow with random non-zero weights (tests/test_torch_flow_menu.py's
    recipe): the init hidden layers, N(0, scale^2) output weights and
    biases, and a random whitening pre-layer; returns (the JAX flow, its
    params as numpy)."""
    jf = JFlow(d, arch, bins=bins, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    stack = params["stack"]
    layers = [layer for tp in stack for layer in tp] if arch.startswith("nsfc") else stack
    for i, layer in enumerate(layers):
        if i % 4 == 3:
            layer["w"] = (scale * rng.standard_normal(layer["w"].shape)).astype(np.float32)
        layer["b"] = (scale * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    a = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    params["pre"] = dict(mean=rng.standard_normal(d).astype(np.float32),
                         w_fwd=a.astype(np.float32),
                         w_inv=np.linalg.inv(a).astype(np.float32),
                         ladj=np.float32(np.log(abs(np.linalg.det(a)))))
    jf.params = jax.device_put(params)
    return jf, params


def knot_rows(flow, y, g_l, window=1e-5):
    """(n,) bool: rows of the stack input y where, in the float64 forward,
    some spline input lies within `window` of a knot of its spline and
    dL/dladj is nonzero (none for the affine head)."""
    n, d = y.shape
    near = torch.zeros(n, dtype=torch.bool)
    if flow.kind == "maf":
        return near
    f64 = copy.deepcopy(flow).double()
    fp = f64.params()
    bins, n_params = flow.bins, flow.n_params
    with torch.no_grad():
        if flow.kind == "nsfc":
            acts = ck.coupling_forward_ref(y.double(), fp.ws, fp.bs, fp.masks, True, bins)[2]
            for k, m in enumerate(fp.masks):
                x = acts[0][k][:, torch.as_tensor(~m)]
                p = (acts[3][k] @ fp.ws[k][3] + fp.bs[k][3]).reshape(n, x.shape[1], n_params)
                near |= ((x[..., None] - tr._rqs_setup(p, bins)[0]).abs()
                         < window).any(-1).any(-1)
        else:
            acts = fk.made_rqs_forward_ref(y.double(), fp.ws, fp.bs, save_inputs=True,
                                           bins=bins)[2]
            for k in range(acts[0].shape[0]):
                p = (acts[3][k] @ fp.ws[3][k] + fp.bs[3][k]).reshape(n, d, n_params)
                near |= ((acts[0][k][..., None] - tr._rqs_setup(p, bins)[0]).abs()
                         < window).any(-1).any(-1)
    return near & (g_l != 0)


def assert_grad_close(got, want, keep=None, tol=GRAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    if keep is not None:
        got, want = got[keep], want[keep]
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the flows' inverse gradients ------------------------------------------

@pytest.mark.parametrize("arch,d,bins", [
    *(pytest.param(arch, d, 8, id=f"{arch}-{d}")
      for arch, d in [("nsf3", 2), ("nsf3", 4), ("nsf6", 10), ("maf3", 4), ("nsfc3", 4)]),
    pytest.param("nsf3", 4, 16, id="nsf3-4-bins16"),
    pytest.param("nsfc3", 4, 16, id="nsfc3-4-bins16")])
def test_inverse_gradient_matches_jax(arch, d, bins):
    """g_z of a loss on the flow's inverse (x and the log-det, dL/dladj
    nonzero), pre-layer included: autograd of the port's plain inverse,
    and the kernels' twin on the stack (the pre-layer's linear VJP
    around it), against jax.vjp of the JAX ``Flow.kernel_inv``, at the
    spline's ``bins``. The twin also matches autograd of the port's plain
    stack inverse."""
    jf, params = random_params(d, arch, seed=d, bins=bins)
    flow = load_flow_params(Flow(d, arch, bins=bins, device="cpu"), params)
    rng = np.random.default_rng(d)
    z, g_x = (rng.standard_normal((N, d)).astype(np.float32) for _ in range(2))
    g_l = rng.standard_normal(N).astype(np.float32)
    _, vjp = jax.vjp(lambda zz: jf.kernel_inv(jf.params, zz), jnp.asarray(z))
    want = np.asarray(vjp((jnp.asarray(g_x), jnp.asarray(g_l)))[0])

    fp = _detached(flow.params())
    zt = t(z).requires_grad_(True)
    x, ladj = flow.kernel_inv(zt, fp)
    by_autograd, = torch.autograd.grad((x, ladj), zt, (t(g_x), t(g_l)))
    with torch.no_grad():
        y, _ = flow.stack_inverse(t(z), fp)
        g_y = t(g_x) @ fp.pre["w_inv"].T
        if flow.kind == "nsfc":
            state = ck.coupling_inverse_ref(t(z), fp.ws, fp.bs, fp.masks, save_inputs=True,
                                            bins=bins)[2]
            twin = ck.coupling_inverse_vjp_ref(state, fp.ws, fp.bs, fp.masks, g_y, t(g_l), bins)
        else:
            twin = fk.ar_inverse_vjp_ref(y, fp.ws, fp.bs, fp.inv_orders, g_y, t(g_l),
                                         flow.head, bins)
        keep = ~knot_rows(flow, y, t(g_l)).numpy()
    assert keep.sum() >= N - 2
    assert_grad_close(by_autograd, want, keep)
    assert_grad_close(twin, want, keep)
    assert_grad_close(twin, by_autograd)


@pytest.mark.parametrize("head", ["rqs", "affine"])
def test_inverse_element_vjp_matches_autograd(head):
    """The inverse's element VJP (what heads.cuh ``inverse_vjp`` computes)
    against autograd of the plain element inverse, with rows in the spline
    tails (|z| >= 5, the identity there) and dL/dladj nonzero."""
    rng = np.random.default_rng(1)
    n_params = fk.HEADS[head]
    z = 2.0 * rng.standard_normal(256)
    z[::16] = 6.0 * np.sign(z[::16])
    z, p = t(z), t(0.5 * rng.standard_normal((256, n_params)))
    g_x, g_l = t(rng.standard_normal(256)), t(rng.standard_normal(256))
    zz, pp = z.clone().requires_grad_(True), p.clone().requires_grad_(True)
    x, ladj = fk._element(head)[2](zz, pp)
    g_z, g_p = torch.autograd.grad((x, ladj), (zz, pp), (g_x, g_l))
    got_z, got_p = fk.inverse_element_vjp(x.detach(), p, g_x, g_l, head)
    assert_grad_close(got_z, g_z)
    assert_grad_close(got_p, g_p)


# -- the sweep's target gradient -------------------------------------------

@pytest.mark.parametrize("preconditioned", [False, True])
def test_grad_target_matches_jax(preconditioned):
    """The port's ``Sweep._grad_target`` against jax.grad of the v-space
    target assembled from the JAX package's public pieces
    (``Flow.kernel_inv``, ``Reparameterize.inverse``, ``Prior.logpdf``, the
    likelihood) as ``pocomc_tpu/mcmc.py`` ``_target_sum`` sums it: a
    first coordinate bounded to [-2, 2] by the scaler and to [-1, 1] by the
    prior, so that rows map out of the prior's support: their target is
    not finite and their gradient is 0 (never NaN) in both packages."""
    d, beta = 3, 0.7
    bounds = np.array([[-2.0, 2.0], [-np.inf, np.inf], [-np.inf, np.inf]])
    jprior = jpc.Prior([jpc.Uniform(-1.0, 1.0), jpc.Normal(0.0, 2.0), jpc.Normal(0.0, 2.0)])
    tprior = tpc.Prior([tpc.Uniform(-1.0, 1.0), tpc.Normal(0.0, 2.0), tpc.Normal(0.0, 2.0)])
    js, ts = jpc.Reparameterize(d, bounds=bounds), tpc.Reparameterize(d, bounds=bounds)
    rng = np.random.default_rng(3)
    fit_x = np.column_stack([rng.uniform(-2, 2, 512), 2.0 * rng.standard_normal((512, 2))])
    js.fit(fit_x)
    ts.fit(fit_x)
    jf, params = random_params(d, "nsf3", seed=7)
    flow = load_flow_params(Flow(d, "nsf3", device="cpu"), params)
    v = rng.standard_normal((N, d)).astype(np.float32)
    fallback = np.zeros((N, d), np.float32)

    def like_j(x):
        return -0.5 * jnp.sum((x - 0.3) ** 2 / 0.5, axis=-1)

    def target_j(vv):
        if preconditioned:
            u, ldjf = jf.kernel_inv(jf.params, vv)
        else:
            u, ldjf = vv, 0.0
        x, ldj = js.inverse(u)
        finite = jnp.isfinite(ldj) & jnp.all(jnp.isfinite(x), axis=1)
        x_safe = jnp.where(finite[:, None], x, fallback)
        logp = jnp.where(finite, jprior.logpdf(x_safe), -jnp.inf)
        finite = finite & jnp.isfinite(logp)
        logl = jnp.where(finite, like_j(x_safe), -jnp.inf)
        logt = beta * logl + logp + ldj + ldjf
        return jnp.sum(jnp.where(finite & jnp.isfinite(logl), logt, 0.0)), (logl, finite)

    g_j, (logl_j, finite_j) = jax.grad(target_j, has_aux=True)(jnp.asarray(v))
    g_j = np.where(np.isfinite(np.asarray(g_j)), np.asarray(g_j), 0.0)

    sweep = Sweep(ts, tprior.logpdf, make_loglike(lambda x: -0.5 * ((x - 0.3) ** 2 / 0.5).sum(-1)),
                  flow if preconditioned else None, d, 2, 10, kind="mala",
                  preconditioned=preconditioned)
    scp = {k: t(a) for k, a in js.whitening_params().items()}
    g_t, aux = sweep._grad_target(t(v), beta, t(fallback), _detached(flow.params()), scp)
    assert np.array_equal(aux["finite"].numpy(), np.asarray(finite_j))
    assert 0 < int(aux["finite"].sum()) < N
    out = ~aux["finite"].numpy()
    assert np.all(g_t.numpy()[out] == 0.0) and np.all(g_j[out] == 0.0)
    assert np.isfinite(g_t.numpy()).all()
    keep = aux["finite"].numpy()
    np.testing.assert_allclose(aux["logl"].numpy()[keep], np.asarray(logl_j)[keep], rtol=1e-5,
                               atol=1e-4)
    assert_grad_close(g_t, g_j, keep)


# -- mirrors of tests/test_mala.py ------------------------------------------

def _gauss_setup(d=3, rho=0.7, n=512, seed=0):
    """tests/test_mala.py's correlated Gaussian under N(0, 5) priors, on
    the port: (loglike, prior, scaler, u, x, logdetj, cov)."""
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    cov_inv = t(np.linalg.inv(cov))
    nc = -0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1])

    def loglike(x):
        return nc - 0.5 * torch.einsum("ni,ij,nj->n", x, cov_inv, x)

    prior = tpc.Prior([tpc.Normal(0.0, 5.0) for _ in range(d)])
    scaler = tpc.Reparameterize(d, bounds=prior.bounds)
    u = 0.2 * torch.randn(n, d, generator=torch.Generator().manual_seed(seed))
    x, logdetj = scaler.inverse(u)
    return loglike, prior, scaler, u, x, logdetj, cov


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_sweep_targets_correct_distribution(kind):
    """tests/test_mala.py:37-67 on the port: a long plain gradient-kernel
    sweep samples the tempered posterior (walker moments against the
    analytic beta-posterior of a correlated Gaussian under N(0, 5))."""
    d, beta = 3, 1.0
    loglike, prior, scaler, u, x, logdetj, cov = _gauss_setup(d=d, n=1024)
    post_cov = np.linalg.inv(beta * np.linalg.inv(cov) + np.eye(d) / 25.0)
    sweep = Sweep(scaler, prior.logpdf, make_loglike(loglike), None, d, 10 ** 6, 120,
                  kind=kind, preconditioned=False, n_leapfrog=3)
    gen = torch.Generator().manual_seed(2)
    geom = fit_geometry(u, torch.full((1024,), 1.0 / 1024), gen)
    with torch.no_grad():
        res = sweep.run(u, x, logdetj, loglike(x), prior.logpdf(x), beta, 0.8, geom, None,
                        scaler.whitening_params(), gen)
    assert int(res["steps"]) == 120
    assert 0.2 < float(res["accept"]) < 0.98
    xs = res["x"].double().numpy()
    assert np.all(np.isfinite(xs))
    np.testing.assert_allclose(xs.mean(axis=0), np.zeros(d), atol=0.25)
    np.testing.assert_allclose(np.cov(xs.T), post_cov, atol=0.35)
    if kind == "hmc":
        # jittered 1..n_leapfrog inner evaluations per step are counted
        assert 120 * 1024 <= int(res["calls"]) <= (3 * 120 + 1) * 1024


def test_mala_grad_zero_outside_support():
    """tests/test_mala.py:70-94 on the port: walkers at the edge of a
    bounded prior; proposals that leave the support are rejected and never
    NaN the carried gradient."""
    d = 2
    prior = tpc.Prior([tpc.Uniform(-1.0, 1.0) for _ in range(d)])
    scaler = tpc.Reparameterize(d, bounds=prior.bounds)

    def loglike(x):
        return -0.5 * ((x / 0.3) ** 2).sum(-1)

    sweep = Sweep(scaler, prior.logpdf, make_loglike(loglike), None, d, 10 ** 6, 40,
                  kind="mala", preconditioned=False)
    u = 3.5 * torch.ones(256, d)
    x, logdetj = scaler.inverse(u)
    gen = torch.Generator().manual_seed(1)
    geom = fit_geometry(torch.randn(256, d, generator=gen), torch.full((256,), 1.0 / 256), gen)
    with torch.no_grad():
        res = sweep.run(u, x, logdetj, loglike(x), prior.logpdf(x), 1.0, 0.5, geom, None,
                        scaler.whitening_params(), gen)
    for k in ("u", "x", "logl", "logp"):
        assert bool(torch.isfinite(res[k]).all()), k


def _evidence_problem():
    d = 4
    rng = np.random.default_rng(0)
    evals = np.logspace(0, 1.5, d)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (q * evals) @ q.T
    ci = t(np.linalg.inv(cov))
    nc = -0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1])

    def loglike(x):
        return nc - 0.5 * torch.einsum("ni,ij,nj->n", x, ci.to(x.device), x)

    ps = 10.0
    expect = multivariate_normal.logpdf(np.zeros(d), np.zeros(d), cov + ps ** 2 * np.eye(d))
    return d, loglike, ps, expect


@pytest.mark.parametrize("device_loop", ["auto", False])
@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_end_to_end_evidence(kind, device_loop):
    """tests/test_mala.py:97-144 on the port, on the device loop and on the
    host loop: a full run with sample='mala' (default n_leapfrog) or 'hmc'
    (n_leapfrog=3) recovers the analytic logZ within 0.35."""
    d, loglike, ps, expect = _evidence_problem()
    s = tpc.Sampler(tpc.Prior([tpc.Normal(0, ps) for _ in range(d)]), loglike,
                    vectorize=True, random_state=0, n_effective=256, n_active=128,
                    sample=kind, n_leapfrog=3, flow="nsf3", device_loop=device_loop,
                    train_config={"epochs": 60, "patience": 8}, device="cpu")
    assert s._use_device_loop() == (device_loop == "auto")
    s.run(n_total=1024, n_evidence=1024, progress=False)
    logz, _ = s.evidence()
    assert logz == pytest.approx(expect, abs=0.35)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_kernels_require_traceable_likelihood(kind):
    """tests/test_mala.py:148-155 on the port: a likelihood on the host
    route raises the JAX package's ValueError."""
    def blackbox(x):
        return float(-0.5 * np.sum(np.asarray(x) ** 2))

    with pytest.raises(ValueError, match="traceable"):
        tpc.Sampler(tpc.Prior([tpc.Normal(0, 1) for _ in range(2)]), blackbox, sample=kind,
                    device="cpu")


def test_gradient_kernels_require_traceable_prior():
    """tests/test_mala.py:158-173 on the port: a prior on the host route
    (numpy alone) cannot give gradients and raises at construction."""
    class NumpyPrior:
        dim = 2
        bounds = np.array([[-np.inf, np.inf]] * 2)

        def logpdf(self, x):
            return -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)

        def rvs(self, size=1):
            return np.random.default_rng(0).standard_normal((size, 2))

    with pytest.raises(ValueError, match="prior"):
        tpc.Sampler(NumpyPrior(), lambda x: -(x ** 2).sum(-1), vectorize=True, sample="mala",
                    device="cpu")


@pytest.mark.parametrize("kwargs,match", [(dict(sample="hmc", n_leapfrog=0), "n_leapfrog"),
                                          (dict(sample="hamiltonian"), "tpcn")])
def test_invalid_gradient_options_raise(kwargs, match):
    """tests/test_mala.py:176-186 on the port: n_leapfrog below 1 and an
    unknown sample name raise ValueError."""
    with pytest.raises(ValueError, match=match):
        tpc.Sampler(tpc.Prior([tpc.Normal(0, 1) for _ in range(2)]),
                    lambda x: -(x ** 2).sum(-1), vectorize=True, device="cpu", **kwargs)


# -- the JAX package's own quickstart (script) ------------------------------

def jax_quickstart(sample):
    """The 10-D Rosenbrock quickstart (N(0, 3) prior, every setting at its
    default) with ``sample``, on the JAX package: (logz, dlogz, calls,
    iterations, wall seconds)."""
    def log_like(x):
        return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                        + (x[..., ::2] - 1.0) ** 2, axis=-1)

    prior = jpc.Prior([jpc.Normal(0.0, 3.0) for _ in range(10)])
    s = jpc.Sampler(prior, log_like, vectorize=True, random_state=0, sample=sample)
    t0 = time.perf_counter()
    s.run(n_total=4096, n_evidence=4096, progress=False)
    logz, dlogz = s.evidence()
    return float(logz), float(dlogz), int(s.calls), int(s.t), time.perf_counter() - t0


if __name__ == "__main__":
    kind = sys.argv[1]
    logz, dlogz, calls, iters, wall = jax_quickstart(kind)
    print(f"jax {kind} quickstart: logz {logz:.4f} +- {dlogz:.4f} calls {calls} "
          f"iterations {iters} wall {wall:.1f} s on {jax.devices()[0].platform}", flush=True)
