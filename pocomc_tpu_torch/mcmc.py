"""Adaptive MCMC sweeps over the active population: t-pCN, random-walk
Metropolis, independence MH and the gradient kernels MALA and HMC, with
and without the flow.

Counterpart of ``pocomc_tpu/mcmc.py`` ``make_sweep`` for every ``kind``:
``"tpcn"``, ``"rwm"``, ``"imh"``, ``"mala"`` and ``"hmc"``. Proposals,
Student-t quadratic forms and Metropolis corrections are batched over the
whole (n_active, d) population. ``preconditioned=True`` proposes in the flow's latent space and
the flow's inverse (K1) maps every proposal back to the sampling space;
``preconditioned=False`` proposes in the scaler's u space and never calls a
flow. ``imh_every`` (preconditioned t-pCN only; inert elsewhere, as in the
JAX package) makes every ``imh_every``-th step propose an independent draw
from the flow's N(0, I) base, and masks the walkers such a refresh moved
out of the drift windows. Every stopping rule the defaults turn on is
here: the plateau rule with its significance threshold ``plateau_z`` and
floor ``plateau_floor``, the decorrelation target ``corr_threshold``, the
equilibrium-drift test ``calib_z`` with its residual-hotness
extrapolation, the bias-budget and bias-rate rules (``bias_budget``,
``bias_rate``/``bias_floor``), and t-pCN's misfit-adaptive sigma cap.

The gradient kinds differentiate the v-space log-target (``_grad_target``:
one ``torch.enable_grad()`` pass through the flow's inverse, the scaler,
the prior and the likelihood, then ``torch.autograd.grad`` in v only).
With the flow, that pass runs the inverse's kernel and its backward (K1
and K1-bwd, or K5's inverse and K5-inv-bwd on CUDA), with the flow's
weights detached: the sweep never differentiates in them. MALA proposes
with the geometry's normal covariance as the mass matrix; HMC leapfrogs
in the whitened coordinates with a trajectory of 1..``n_leapfrog`` steps
drawn each step (one host read of that count), its inner likelihood
passes counted as calls.

The JAX ``lax.while_loop`` becomes a host loop: each step evaluates the
stopping rule on the device and reads it with one scalar sync. The step
counters ``i``/``i_snap`` are host integers (they depend on nothing but the
step count), so the ``imh_every`` cadence is a host branch. ``run_stepped``
is the same sweep with a host likelihood (the black-box path): the rule's
flag rides in the transfer that brings each proposal to the host.
``set_live_sink`` registers a function that every step of either reports
its statistics to, in the host read that step already makes.

Spans (``utils/trace.py``): a sweep, each step with its proposal (noise
included), likelihood, accept step and the read of the stopping rule
that ends it.

The t-pCN correction is written ``-half * log1p(q / nu)``: the JAX form
``log(nu + q) - log(nu)`` cancels in f32 at the nu = 1e6 Gaussian-limit
sentinel (up to 0.49 nat). nu >= 1 is clamped by the geometry fit, so the
division cannot overflow into the case that form was written against.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .parallel.mesh import block, psum, tree_map
from .utils import trace

# Drift-test window length (steps) and minimum calibration rows
# (pocomc_tpu/mcmc.py CALIB_W / MIN_CALIB_N).
CALIB_W = 6
MIN_CALIB_N = 16
_ACCEPT_TARGET = 0.234
_SIGMA_CAP = 0.99
KINDS = ("tpcn", "rwm", "imh", "mala", "hmc")
GRADIENT_KINDS = ("mala", "hmc")
# acceptance optima of the gradient kernels (pocomc_tpu/mcmc.py:305): MALA
# (Roberts & Rosenthal 1998) and HMC (Beskos et al. 2013)
_GRADIENT_TARGET = {"mala": 0.574, "hmc": 0.651}


@dataclasses.dataclass
class SweepState:
    u: torch.Tensor
    x: torch.Tensor
    logdetj: torch.Tensor
    logl: torch.Tensor
    logp: torch.Tensor
    theta: torch.Tensor          # flow-latent state (zeros without the flow)
    logdetj_flow: torch.Tensor   # log|det du/dtheta| at the current state
    sigma: torch.Tensor
    mu: torch.Tensor
    grad: torch.Tensor           # v-space target gradient (mala/hmc; else zeros)
    i: int                       # step counter (host)
    cnt: torch.Tensor            # plateau counter
    logp2: torch.Tensor          # best plateau metric so far
    calls: torch.Tensor          # likelihood call counter
    accept: torch.Tensor         # mean acceptance of the last step
    v0: torch.Tensor             # sweep-start u (decorrelation probe)
    corr: torch.Tensor           # max |per-dim corr(v0, u)|
    u_snap: torch.Tensor         # u at the last drift-window refresh
    logl_snap: torch.Tensor
    i_snap: int                  # step index of that refresh (host)
    hot: torch.Tensor            # 1 while the last closed window drifted
    resid: torch.Tensor          # residual-hotness extrapolation
    z_logl: torch.Tensor
    z_dim: torch.Tensor
    misfit: torch.Tensor         # std of log pi_v - log t_geom (nats; tpcn)
    fresh: torch.Tensor          # (n,) 1 once an independence refresh moved
                                 # the walker in the current drift window
    dbeta: torch.Tensor          # current rung size (constant per sweep)
    logl_var: torch.Tensor       # variance of the finite logl (bias-rate rule)


# --- live per-step sweep statistics (pocomc_tpu/mcmc.py:105-125) ---------
# A process-global sink that every sweep step reports to while it is set
# (one sweep runs at a time per process). It is looked up at each step, so
# with no sink a sweep runs and reads the device exactly as without the
# tap; with one, the step's statistics ride in the host read the stopping
# rule already makes.
_LIVE_SINK = None


def set_live_sink(fn):
    """Register ``fn(step, plateau_cnt, sigma, accept, calls)`` to receive
    every sweep step's statistics; ``None`` unregisters."""
    global _LIVE_SINK
    _LIVE_SINK = fn


def _live_emit(i, cnt, sigma, accept, calls):
    if _LIVE_SINK is not None:
        _LIVE_SINK(int(i), int(cnt), float(sigma), float(accept), int(calls))


def make_loglike(fn):
    """``loglike(x, mask)``: the user's vectorised likelihood on the rows,
    -inf where ``mask`` is False (those rows are sanitized, not skipped)."""
    def loglike(x, mask):
        out = fn(x).to(x.dtype)
        return torch.where(mask, out, torch.full_like(out, -math.inf))
    return loglike


def t_correction(q, nu, d):
    """log t_geom up to a constant: -0.5 (d + nu) log1p(q / nu), the
    t-pCN reversibility term at quadratic form q."""
    return -0.5 * (d + nu) * torch.log1p(q / nu)


def _quadform(diff, inv_cov):
    return torch.einsum("nd,de,ne->n", diff, inv_cov, diff)


def _masked_sums(ok, vals):
    """(count, sum) of ``vals`` over the rows ``ok``: the first round of a
    masked mean."""
    return ok.sum(), torch.where(ok, vals, torch.zeros_like(vals)).sum()


def _masked_sq(ok, vals, mean):
    """Sum of squared deviations from ``mean`` over the rows ``ok``."""
    return torch.where(ok, (vals - mean) ** 2, torch.zeros_like(vals)).sum()


def _resid_sums(ok, logl, logl_snap):
    """First round of the paired-drift statistics: the sums of the drift,
    of the window-start and of the current logl over the rows ``ok``."""
    zero = torch.zeros_like(logl)
    return (torch.where(ok, logl - logl_snap, zero).sum(),
            torch.where(ok, logl_snap, zero).sum(), torch.where(ok, logl, zero).sum())


def _resid_sq(ok, logl, logl_snap, m0, m1):
    """Second round: the sums of the window-start/current cross product and
    squares about their means m0, m1."""
    zero = torch.zeros_like(logl)
    l0c = torch.where(ok, logl_snap, zero)
    l1c = torch.where(ok, logl, zero)
    return (torch.where(ok, (l0c - m0) * (l1c - m1), zero).sum(),
            torch.where(ok, (l0c - m0) ** 2, zero).sum(),
            torch.where(ok, (l1c - m1) ** 2, zero).sum())


def _resid(D, cov01, v0v, v1v):
    """resid = D * rho / (1 - rho) from the paired drift D and the window
    correlation clipped to [0, 0.9]."""
    rho = torch.clamp(cov01 / torch.clamp(torch.sqrt(v0v * v1v), min=1e-30), 0.0, 0.9)
    return D * rho / (1.0 - rho)


def _detached(fp):
    """A flow's parameters (FlowParams, CouplingParams or a custom flow's)
    with every tensor detached (None stays None)."""
    return tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, fp)


def _half_sq_diff(v_prime, cur):
    """log q(cur) - log q(v') of the N(0, I) independence proposal."""
    return 0.5 * ((v_prime * v_prime).sum(-1) - (cur * cur).sum(-1))


class Sweep:
    """Adaptive sweep of ``kind`` ("tpcn", "rwm", "imh", "mala" or "hmc")
    over the active population.

    With ``preconditioned`` the sweep moves in the latent space of
    ``flow``, which supplies ``kernel_fwd(u, fp)`` / ``kernel_inv(theta,
    fp)`` (both report log|det du/dtheta|); ``fp`` is the flow's FlowParams
    snapshot. Without it ``flow`` may be None and ``fp`` is ignored.
    ``log_like`` is ``make_loglike(fn)``; ``log_prior`` maps (n, d) ->
    (n,). The geometry dict ``geom`` (``models.geometry.fit_geometry``)
    gives t-pCN its Student-t fit and rwm, mala and hmc their Cholesky
    ``normal_chol``. The gradient kinds need ``log_like`` on the device and
    a differentiable ``log_prior``; ``n_leapfrog`` is hmc's longest
    trajectory.

    With a ``mesh`` (``parallel.mesh.ParticleMesh``) every state tensor
    holds this rank's rows; the random numbers are drawn for the whole
    population and each rank takes its rows, and every statistic over the
    particles is summed over the ranks, the sums of a step packed into two
    ``all_reduce`` calls (first moments, then the spreads about them), so
    every value that steers the sweep is the same on every rank."""

    def __init__(self, scaler, log_prior, log_like, flow, n_dim, n_steps, n_max,
                 kind="tpcn", preconditioned=True, imh_every=0,
                 plateau_z=0.0, corr_threshold=0.0, calib_z=0.0,
                 bias_budget=0.0, bias_rate=0.0, bias_floor=0.0,
                 plateau_floor=4.0, n_leapfrog=5, mesh=None):
        if kind not in KINDS:
            raise ValueError(f"Invalid kernel kind {kind!r}")
        if preconditioned and flow is None:
            raise ValueError("a preconditioned sweep needs a flow")
        if kind == "imh" and not preconditioned:
            raise ValueError("kind='imh' proposes from the flow's latent base and "
                             "requires preconditioning (precondition=True).")
        self.scaler, self.log_prior, self.log_like = scaler, log_prior, log_like
        self.flow = flow
        self.kind, self.preconditioned = kind, bool(preconditioned)
        # the refresh needs the flow latent: inert in plain space and for
        # the other kinds (pocomc_tpu/mcmc.py:247-250)
        self.imh_every = int(imh_every) if kind == "tpcn" and preconditioned else 0
        self.n_dim, self.n_steps, self.n_max = int(n_dim), n_steps, int(n_max)
        self.plateau_z, self.corr_threshold = plateau_z, corr_threshold
        self.calib_z, self.bias_budget = calib_z, bias_budget
        self.bias_rate, self.bias_floor = bias_rate, bias_floor
        self.plateau_floor = plateau_floor
        self.n_leapfrog = n_leapfrog
        self.sqrt_d_scale = 2.38 / math.sqrt(self.n_dim)
        self.mesh = mesh
        self.ranks = 1 if mesh is None else mesh.size
        # all_reduce calls of the last sweep (0 without a mesh)
        self.collectives = 0

    def _psum(self, *tensors):
        """``parallel.mesh.psum``, counted in ``collectives``."""
        if self.mesh is not None:
            self.collectives += 1
        return psum(self.mesh, *tensors)

    def _track_logl_var(self):
        return self.corr_threshold > 0.0 and self.bias_rate > 0.0

    # -- pieces ------------------------------------------------------------

    def _to_x(self, v_prime, fp, scp):
        """Proposal -> (u', x', logdetj', theta', logdetj_flow')."""
        if self.preconditioned:
            theta_p = v_prime
            u_p, ldjf_p = self.flow.kernel_inv(v_prime, fp)
        else:
            theta_p = torch.zeros_like(v_prime)
            u_p = v_prime
            ldjf_p = torch.zeros(v_prime.shape[0], dtype=v_prime.dtype,
                                 device=v_prime.device)
        sc = self.scaler
        x_p, ldj_p = sc.inverse(u_p, params=scp)
        if sc.has_boundary:
            x_p = sc.apply_boundary_conditions_x(x_p)
            u_p = sc.forward(x_p, params=scp)
            x_p, ldj_p = sc.inverse(u_p, params=scp)
        return u_p, x_p, ldj_p, theta_p, ldjf_p

    def _grad_target(self, v, beta, fallback_x, fp, scp):
        """(gradient, proposal dict) of the v-space log-target beta logl +
        logp + logdetj + logdetj_flow at v (``_target_sum``/``_grad_target``
        of the JAX package): one pass with the gradient on, every
        sub-evaluation on sanitised rows (a non-finite row takes
        ``fallback_x``), the sum over the rows where every term is finite,
        and the gradient in v only, set to 0 where it is not finite, so a
        row out of the support gets 0 and never NaN. The dict holds the
        pass's u, x, x_safe, logdetj, theta, logdetj_flow, logp, logl and
        the pre-likelihood ``finite`` mask, detached."""
        with torch.enable_grad():
            vv = v.detach().requires_grad_(True)
            u_p, x_p, ldj_p, theta_p, ldjf_p = self._to_x(vv, fp, scp)
            finite = torch.isfinite(ldj_p) & torch.isfinite(x_p).all(1)
            x_safe = torch.where(finite[:, None], x_p, fallback_x)
            logp = torch.where(finite, self.log_prior(x_safe),
                               torch.full_like(ldj_p, -math.inf))
            finite = finite & torch.isfinite(logp)
            logl = self.log_like(x_safe, finite)
            logt = beta * logl + logp + ldj_p + ldjf_p
            ok = finite & torch.isfinite(logl)
            total = torch.where(ok, logt, torch.zeros_like(logt)).sum()
            g, = torch.autograd.grad(total, vv)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        aux = dict(u=u_p, x=x_p, x_safe=x_safe, logdetj=ldj_p, theta=theta_p,
                   logdetj_flow=ldjf_p, logp=logp, logl=logl)
        aux = {k: a.detach() for k, a in aux.items()}
        aux["finite"] = finite
        return g, aux

    def _use_imh(self, st):
        """True on the independence-refresh steps of the cadence."""
        return self.imh_every > 0 and st.i % self.imh_every == self.imh_every - 1

    def init_state(self, u, x, logdetj, logl, logp, sigma0, geom, fp, dbeta=0.0, beta=None,
                   scp=None):
        """The sweep's start. The gradient kinds also take the start's
        gradient there, at ``beta`` with the scaler parameters ``scp``, a
        likelihood pass counted in ``calls``."""
        dt, dev = u.dtype, u.device
        if self.preconditioned:
            theta0, ldjf0 = self.flow.kernel_fwd(u, fp)
        else:
            theta0 = torch.zeros_like(u)
            ldjf0 = torch.zeros(u.shape[0], dtype=dt, device=dev)
        sigma = torch.as_tensor(sigma0, dtype=dt, device=dev)
        if self.kind == "tpcn":
            sigma, mu = torch.clamp(sigma, max=_SIGMA_CAP), geom["t_mean"].to(dt)
        else:
            mu = torch.zeros(u.shape[1], dtype=dt, device=dev)
        metric0 = logl + logp + (logdetj if self.kind == "rwm" else 0.0)
        zero = torch.zeros((), dtype=dt, device=dev)
        calls = torch.zeros((), dtype=torch.int64, device=dev)
        if self.kind in GRADIENT_KINDS:
            grad, aux = self._grad_target(theta0 if self.preconditioned else u, beta, x, fp,
                                          scp)
            calls = calls + aux["finite"].sum()
        else:
            grad = torch.zeros_like(u)
        terms = dict(calls=calls, logp2=metric0.mean())
        ok_l = torch.isfinite(logl)
        if self._track_logl_var():
            terms["ll_n"], terms["ll_s"] = _masked_sums(ok_l, logl)
        r1 = self._reduce(terms, means=("logp2",))
        return SweepState(
            u=u, x=x, logdetj=logdetj, logl=logl, logp=logp,
            theta=theta0, logdetj_flow=ldjf0, sigma=sigma, mu=mu, grad=grad, i=0,
            cnt=torch.zeros((), dtype=torch.int64, device=dev),
            logp2=r1["logp2"], calls=r1["calls"],
            accept=zero, v0=u, corr=torch.ones((), dtype=dt, device=dev),
            u_snap=u, logl_snap=logl, i_snap=0, hot=zero, resid=zero,
            z_logl=zero, z_dim=zero, misfit=zero,
            fresh=torch.zeros(u.shape[0], dtype=dt, device=dev),
            dbeta=torch.as_tensor(dbeta, dtype=dt, device=dev),
            logl_var=self._logl_var(ok_l, logl, r1) if self._track_logl_var() else zero)

    def _reduce(self, terms, means=()):
        """The dict of particle sums ``terms`` summed over the ranks in one
        ``all_reduce``; the entries named in ``means`` are block means, so
        their sums are divided by the rank count. Without a mesh, ``terms``
        as they are."""
        if not terms:
            return {}
        keys = list(terms)
        vals = self._psum(*[torch.as_tensor(terms[k]) for k in keys])
        out = dict(zip(keys, vals if len(keys) > 1 else (vals,)))
        if self.mesh is not None:
            out.update({k: out[k] / self.ranks for k in means})
        return out

    def _logl_var(self, ok_l, logl, r1):
        """Variance of the finite logl over the population, from round 1's
        ``ll_n``/``ll_s`` and one more ``all_reduce``."""
        nn = torch.clamp(r1["ll_n"], min=1).to(logl.dtype)
        return self._reduce(dict(q=_masked_sq(ok_l, logl, r1["ll_s"] / nn)))["q"] / nn

    def draw_noise(self, st, geom, generator):
        """The step's random numbers: normals z (n, d) and acceptance
        uniforms (n,); for t-pCN also the gamma mix g (n,), and on a
        refresh step the base draw v_imh (n, d) (the local move is drawn
        too, as in the JAX package); for hmc first the trajectory's
        leapfrog count ``n_leap`` in 1..n_leapfrog, a host int."""
        n, d = st.u.shape
        n = n * self.ranks  # drawn for the whole population, then this rank's rows
        dev = st.u.device
        noise = {}
        if self.kind == "hmc":
            n_leap = torch.randint(1, self.n_leapfrog + 1, (), generator=generator, device=dev)
            sp = trace.begin("read")
            noise["n_leap"] = int(n_leap)
            if sp is not None:
                trace.end(sp)
        if self.kind == "tpcn":
            alpha = (0.5 * (d + geom["t_nu"])).expand(n).contiguous()
            noise["g"] = torch._standard_gamma(alpha, generator=generator)
        noise["z"] = torch.randn(n, d, generator=generator, device=dev)
        if self._use_imh(st):
            noise["v_imh"] = torch.randn(n, d, generator=generator, device=dev)
        noise["unif"] = torch.rand(n, generator=generator, device=dev)
        return {k: v if k == "n_leap" else block(self.mesh, v) for k, v in noise.items()}

    def propose(self, st, geom, fp, scp, noise, beta=None):
        """Proposals and everything that needs no likelihood; the gradient
        kinds evaluate the likelihood in their gradient pass at ``beta``
        (its logl in the dict)."""
        cur = st.theta if self.preconditioned else st.u
        if self.kind == "mala":
            return self._propose_mala(st, cur, geom, fp, scp, noise, beta)
        if self.kind == "hmc":
            return self._propose_hmc(st, cur, geom, fp, scp, noise, beta)
        prop = {}
        if self.kind == "tpcn":
            inv_cov, t_chol, nu = geom["t_inv_cov"], geom["t_chol"], geom["t_nu"]
            diff = cur - st.mu
            prop["q"] = _quadform(diff, inv_cov)
            s = (nu + prop["q"]) / (2.0 * noise["g"])
            step = torch.sqrt(s)[:, None] * (noise["z"] @ t_chol.T)
            v_prime = st.mu + torch.sqrt(1.0 - st.sigma ** 2) * diff + st.sigma * step
            if self._use_imh(st):
                v_prime = noise["v_imh"]
                prop["corr"] = _half_sq_diff(v_prime, cur)
            prop["qp"] = _quadform(v_prime - st.mu, inv_cov)
        elif self.kind == "imh":
            v_prime = noise["z"]
            prop["corr"] = _half_sq_diff(v_prime, cur)
        else:
            v_prime = cur + st.sigma * (noise["z"] @ geom["normal_chol"].T)
        u_p, x_p, ldj_p, theta_p, ldjf_p = self._to_x(v_prime, fp, scp)
        finite = torch.isfinite(ldj_p) & torch.isfinite(x_p).all(1)
        x_safe = torch.where(finite[:, None], x_p, st.x)
        logp_p = torch.where(finite, self.log_prior(x_safe),
                             torch.full_like(ldj_p, -math.inf))
        finite = finite & torch.isfinite(logp_p)
        prop.update(u=u_p, x=x_p, x_safe=x_safe, logdetj=ldj_p, theta=theta_p,
                    logdetj_flow=ldjf_p, logp=logp_p, finite=finite,
                    unif=noise["unif"])
        return prop

    def _propose_mala(self, st, cur, geom, fp, scp, noise, beta):
        """Preconditioned Langevin (``pocomc_tpu/mcmc.py:372-399``): mass
        matrix M = L L^T, L the geometry's ``normal_chol``; drift (sigma^2 /
        2) M grad, noise sigma L z; ``corr`` is log q(v | v') - log q(v' |
        v)."""
        L, z = geom["normal_chol"], noise["z"]
        drift = 0.5 * st.sigma ** 2 * ((st.grad @ L) @ L.T)
        v_prime = cur + drift + st.sigma * (z @ L.T)
        grad_p, prop = self._grad_target(v_prime, beta, st.x, fp, scp)
        drift_p = 0.5 * st.sigma ** 2 * ((grad_p @ L) @ L.T)
        r = cur - v_prime - drift_p
        w = torch.linalg.solve_triangular(L, r.T, upper=False).T
        prop.update(corr=-0.5 * (w * w).sum(-1) / st.sigma ** 2 + 0.5 * (z * z).sum(-1),
                    grad=grad_p, unif=noise["unif"])
        return prop

    def _propose_hmc(self, st, cur, geom, fp, scp, noise, beta):
        """Leapfrog with unit mass in the whitened coordinates y = L^-1 v,
        step sigma, ``noise["n_leap"]`` steps (``pocomc_tpu/mcmc.py:
        401-454``); ``corr`` is the kinetic-energy difference, and the
        inner passes' finite rows beyond the endpoint's are
        ``extra_calls``."""
        L, z, eps = geom["normal_chol"], noise["z"], st.sigma
        y = torch.linalg.solve_triangular(L, cur.T, upper=False).T
        g_y = st.grad @ L
        p = z + 0.5 * eps * g_y
        calls = torch.zeros((), dtype=st.calls.dtype, device=cur.device)
        for _ in range(noise["n_leap"]):
            y = y + eps * p
            g_v, prop = self._grad_target(y @ L.T, beta, st.x, fp, scp)
            calls = calls + prop["finite"].sum()
            g_y = g_v @ L
            p = p + eps * g_y
        p = p - 0.5 * eps * g_y
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        prop.update(corr=0.5 * (z * z).sum(-1) - 0.5 * (p * p).sum(-1),
                    grad=g_y @ torch.linalg.solve_triangular(L, eye, upper=False),
                    extra_calls=calls - prop["finite"].sum(), unif=noise["unif"])
        return prop

    def accept_update(self, st, prop, logl_p, beta, geom):
        """Metropolis accept + diminishing adaptation + stopping statistics.
        Returns (new_state, accept_mask). The statistics over the particles
        take two rounds of sums (``_reduce``): the counts, sums and means,
        then the spreads about those means."""
        n, d = st.u.shape
        n_all = n * self.ranks
        i1 = float(st.i + 1)
        use_imh = self._use_imh(st)
        log_ratio = (beta * (logl_p - st.logl) + (prop["logp"] - st.logp)
                     + (prop["logdetj"] - st.logdetj))
        if self.preconditioned:
            log_ratio = log_ratio + (prop["logdetj_flow"] - st.logdetj_flow)
        if self.kind == "tpcn":
            nu = geom["t_nu"]
            B = t_correction(prop["q"], nu, d)
            # a refresh step carries the N(0, I) proposal's correction in
            # place of the t-pCN reversibility terms
            if use_imh:
                log_ratio = log_ratio + prop["corr"]
            else:
                log_ratio = log_ratio - t_correction(prop["qp"], nu, d) + B
            # geometry-fit statistic for the adaptive sigma cap: std over
            # the live population of log pi_v - log t_geom at the current
            # positions
            logpi_v = beta * st.logl + st.logp + st.logdetj
            if self.preconditioned:
                logpi_v = logpi_v + st.logdetj_flow
            mis_vals = logpi_v - B
            mis_ok = torch.isfinite(mis_vals)
        elif self.kind in ("imh", *GRADIENT_KINDS):
            log_ratio = log_ratio + prop["corr"]

        alpha = torch.clamp(torch.exp(log_ratio), max=1.0)
        alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
        accept = prop["unif"] < alpha

        def sel(a, b):
            return torch.where(accept[:, None] if a.dim() == 2 else accept, a, b)

        u = sel(prop["u"], st.u)
        x = sel(prop["x"], st.x)
        logdetj = sel(prop["logdetj"], st.logdetj)
        logl = sel(logl_p, st.logl)
        logp = sel(prop["logp"], st.logp)
        theta = sel(prop["theta"], st.theta)
        ldjf = sel(prop["logdetj_flow"], st.logdetj_flow)
        grad = sel(prop["grad"], st.grad) if self.kind in GRADIENT_KINDS else st.grad
        # plateau metric: rwm includes logdetj (pocomc_tpu/mcmc.py:642-645)
        vals = logl + logp + (logdetj if self.kind == "rwm" else 0.0)
        # an accepted refresh moved the walker by a fresh draw, not by local
        # relaxation: it leaves the drift windows until the next close
        fresh = (torch.maximum(st.fresh, accept.to(st.fresh.dtype)) if use_imh
                 else st.fresh)
        window = self.calib_z > 0.0 and (st.i + 1) - st.i_snap >= CALIB_W
        ok_l = torch.isfinite(logl)

        # round 1: counts, sums and block means
        t1 = dict(calls=prop["finite"].sum() + prop.get("extra_calls", 0),
                  alpha=alpha.mean(), metric=vals.mean())
        means1 = ["alpha", "metric"]
        if self.kind == "tpcn":
            t1["mis_n"], t1["mis_s"] = _masked_sums(mis_ok, mis_vals)
            if self.preconditioned:
                t1["theta"] = theta.mean(0)
                means1.append("theta")
        if self.plateau_z > 0.0:
            t1["var"] = vals.std(unbiased=False) ** 2  # sqrt(fl(s * s)) = s
            means1.append("var")
        if self.corr_threshold > 0.0:
            t1["m_v0"], t1["m_u"] = st.v0.mean(0), u.mean(0)
            means1 += ["m_v0", "m_u"]
        if window:
            # a drift window closed: paired per-walker drift tests of mean
            # logl and of per-dim first/second u moments
            ok = torch.isfinite(logl) & torch.isfinite(st.logl_snap) & (fresh < 0.5)
            w_ok = ok.to(st.sigma.dtype)[:, None]
            t1["ok_n"] = ok.sum()
            t1["dl"], t1["l0"], t1["l1"] = _resid_sums(ok, logl, st.logl_snap)
            t1["du"] = ((u - st.u_snap) * w_ok).sum(0)
            t1["ds"] = ((u ** 2 - st.u_snap ** 2) * w_ok).sum(0)
        if self._track_logl_var():
            t1["ll_n"], t1["ll_s"] = _masked_sums(ok_l, logl)
        r1 = self._reduce(t1, means1)

        # round 2: spreads about round 1's means
        t2, means2 = {}, []
        if self.kind == "tpcn":
            mis_n = torch.clamp(r1["mis_n"], min=1)
            t2["mis_q"] = _masked_sq(mis_ok, mis_vals, r1["mis_s"] / mis_n)
        if self.plateau_z > 0.0:
            # the population variance from the blocks' (equal sizes)
            t2["spread"] = (vals.mean() - r1["metric"]) ** 2
            means2.append("spread")
        if self.corr_threshold > 0.0:
            v0c, vc = st.v0 - r1["m_v0"], u - r1["m_u"]
            t2["c_num"], t2["c_a"], t2["c_b"] = ((v0c * vc).mean(0), (v0c * v0c).mean(0),
                                                 (vc * vc).mean(0))
            means2 += ["c_num", "c_a", "c_b"]
        if window:
            nn = torch.clamp(r1["ok_n"], min=2).to(st.sigma.dtype)
            zero = torch.zeros_like(logl)
            D, Dm, Dv = r1["dl"] / nn, r1["du"] / nn, r1["ds"] / nn
            dl = torch.where(ok, logl - st.logl_snap, zero)
            t2["var_dl"] = torch.where(ok, (dl - D) ** 2, zero).sum()
            t2["var_m"] = (w_ok * (u - st.u_snap - Dm) ** 2).sum(0)
            t2["var_v"] = (w_ok * (u ** 2 - st.u_snap ** 2 - Dv) ** 2).sum(0)
            t2["cov01"], t2["v0v"], t2["v1v"] = _resid_sq(ok, logl, st.logl_snap,
                                                          r1["l0"] / nn, r1["l1"] / nn)
        if self._track_logl_var():
            ll_n = torch.clamp(r1["ll_n"], min=1).to(logl.dtype)
            t2["ll_q"] = _masked_sq(ok_l, logl, r1["ll_s"] / ll_n)
        r2 = self._reduce(t2, means2)

        alpha_mean = r1["alpha"]
        misfit = st.misfit
        if self.kind == "tpcn":
            misfit = torch.sqrt(r2["mis_q"] / mis_n).to(st.sigma.dtype)
        mu = st.mu
        if self.kind == "tpcn":
            loc = min(self.sqrt_d_scale, _SIGMA_CAP)
            cap = loc + (_SIGMA_CAP - loc) * torch.exp(-0.5 * misfit ** 2)
            # a refresh step's acceptance measures the flow, not the local
            # scale, so it leaves sigma alone
            sigma = (st.sigma if use_imh else torch.abs(torch.minimum(
                st.sigma + (alpha_mean - _ACCEPT_TARGET) / i1 ** 0.75, cap)))
            if self.preconditioned:
                mu = st.mu + (r1["theta"] - st.mu) / i1
        elif self.kind == "imh":
            sigma = st.sigma  # no proposal scale to adapt
        elif self.kind in GRADIENT_KINDS:
            # uncapped: the Langevin/leapfrog step scale is problem-dependent
            sigma = torch.abs(st.sigma + (alpha_mean - _GRADIENT_TARGET[self.kind]) / i1 ** 0.75)
        else:
            sigma = st.sigma + (alpha_mean - _ACCEPT_TARGET) / i1
            if not self.preconditioned:
                sigma = torch.abs(sigma)

        metric = r1["metric"]
        if self.plateau_z > 0.0:
            sem = torch.sqrt(r1["var"] + r2["spread"]) / math.sqrt(n_all)
            improved = metric > st.logp2 + self.plateau_z * sem
        else:
            improved = metric > st.logp2
        cnt = torch.where(improved, torch.zeros_like(st.cnt), st.cnt + 1)
        logp2 = torch.maximum(st.logp2, metric)
        corr = st.corr
        if self.corr_threshold > 0.0:
            # max over dims of |Pearson corr(sweep-start u, current u)|
            den = torch.sqrt(r2["c_a"] * r2["c_b"])
            corr = (r2["c_num"].abs() / torch.clamp(den, min=1e-12)).max()

        new = dict(hot=st.hot, resid=st.resid, u_snap=st.u_snap,
                   logl_snap=st.logl_snap, i_snap=st.i_snap,
                   z_logl=st.z_logl, z_dim=st.z_dim, fresh=fresh)
        if window:
            enough = r1["ok_n"] >= min(MIN_CALIB_N, max(2, n_all // 8))
            z_logl = D.abs() / torch.clamp(torch.sqrt(r2["var_dl"] / nn / nn), min=1e-30)
            z_m = Dm.abs() / torch.clamp(torch.sqrt(r2["var_m"] / nn / nn), min=1e-30)
            z_v = Dv.abs() / torch.clamp(torch.sqrt(r2["var_v"] / nn / nn), min=1e-30)
            z_dim = torch.maximum(z_m.max(), z_v.max())
            z_logl = torch.where(enough, z_logl, torch.zeros_like(z_logl))
            z_dim = torch.where(enough, z_dim, torch.zeros_like(z_dim))
            hot = ((z_logl > self.calib_z)
                   | (z_dim > self.calib_z + 1.0)).to(sigma.dtype)
            resid = _resid(D, r2["cov01"] / nn, r2["v0v"] / nn, r2["v1v"] / nn)
            resid = torch.where(enough, resid, torch.zeros_like(resid))
            new = dict(hot=hot, resid=resid, u_snap=u, logl_snap=logl,
                       i_snap=st.i + 1, z_logl=z_logl, z_dim=z_dim,
                       fresh=torch.zeros_like(fresh))

        new_st = SweepState(
            u=u, x=x, logdetj=logdetj, logl=logl, logp=logp, theta=theta,
            logdetj_flow=ldjf, sigma=sigma, mu=mu, grad=grad, i=st.i + 1, cnt=cnt,
            logp2=logp2, calls=st.calls + r1["calls"], accept=alpha_mean, v0=st.v0,
            corr=corr, misfit=misfit, dbeta=st.dbeta,
            logl_var=(r2["ll_q"] / ll_n if self._track_logl_var() else st.logl_var), **new)
        return new_st, accept

    def keep_going(self, st) -> bool:
        """The stopping rule (``cond`` of the JAX sweep); one scalar sync.
        While a live sink is set, the sync reads the step's statistics
        with the flag and hands them to the sink (a step that reaches
        ``n_max`` reads them alone)."""
        if st.i == 0:
            return True
        if _LIVE_SINK is None:
            if st.i >= self.n_max:
                return False
            flag = self.keep_flag(st)
            sp = trace.begin("read")
            keep = bool(flag)
            if sp is not None:
                trace.end(sp)
            return keep
        stats = self.live_stats(st)
        if st.i >= self.n_max:
            sp = trace.begin("read")
            vals = stats.tolist()
            if sp is not None:
                trace.end(sp)
            _live_emit(st.i, *vals)
            return False
        packed = torch.cat([self.keep_flag(st).to(stats.dtype).reshape(1), stats])
        sp = trace.begin("read")
        keep, *vals = packed.tolist()
        if sp is not None:
            trace.end(sp)
        _live_emit(st.i, *vals)
        return keep > 0.5

    @staticmethod
    def live_stats(st):
        """(plateau count, sigma, accept, calls) of the state, packed in
        float64 (exact for the float32 values and the int64 counts)."""
        return torch.stack([t.to(torch.float64).reshape(()) for t in
                            (st.cnt, st.sigma, st.accept, st.calls)])

    def keep_flag(self, st):
        """The device part of the stopping rule, a 0-d bool tensor (the
        step-count bounds are the host's, in ``keep_going``)."""
        ratio = self.sqrt_d_scale / st.sigma
        if self.kind in ("imh", *GRADIENT_KINDS):
            # sigma is not a random-walk scale here (imh has none, mala/hmc
            # a Langevin step): no window stretch
            thresh = torch.full_like(st.sigma, float(self.n_steps))
        else:
            if self.kind == "rwm" and self.preconditioned:
                ratio = torch.clamp(ratio, max=1.0)
            thresh = torch.clamp(self.n_steps * ratio ** 2,
                                 min=min(float(self.n_steps), float(self.plateau_floor)))
        keep = st.cnt < thresh
        # t-pCN tightens its targets as sigma frees past the local scale
        scale = torch.clamp(ratio, max=1.0) if self.kind == "tpcn" else 1.0
        if self.corr_threshold > 0.0:
            keep = keep | (st.corr > self.corr_threshold * scale)
            if self.bias_rate > 0.0:
                rate_keep = st.corr * st.dbeta * st.logl_var > self.bias_rate
                if self.bias_floor > 0.0:
                    rate_keep = rate_keep & (st.corr > self.bias_floor * scale)
                keep = keep | rate_keep
        if self.calib_z > 0.0:
            keep = keep | (st.hot > 0.5)
            if self.bias_budget > 0.0:
                keep = keep | (st.resid.abs() * st.dbeta > self.bias_budget)
        return keep

    def final_resid(self, st):
        """Residual hotness at exit, refreshed from the last partial drift
        window when it holds >= 2 steps (``resid_exit``)."""
        if self.calib_z <= 0.0 or st.i - st.i_snap < 2:
            return st.resid
        ok = torch.isfinite(st.logl) & torch.isfinite(st.logl_snap) & (st.fresh < 0.5)
        r1 = self._reduce(dict(zip(("n", "dl", "l0", "l1"),
                                   (ok.sum(), *_resid_sums(ok, st.logl, st.logl_snap)))))
        nn = torch.clamp(r1["n"], min=2).to(st.sigma.dtype)
        r2 = self._reduce(dict(zip(("c", "a", "b"), _resid_sq(ok, st.logl, st.logl_snap,
                                                              r1["l0"] / nn, r1["l1"] / nn))))
        return _resid(r1["dl"] / nn, r2["c"] / nn, r2["a"] / nn, r2["b"] / nn)

    # -- the sweep ---------------------------------------------------------

    def run(self, u, x, logdetj, logl, logp, beta, sigma0, geom, fp, scp,
            generator, dbeta=0.0):
        """Run the adaptive sweep; returns the results dict."""
        gradient = self.kind in GRADIENT_KINDS
        if gradient:
            fp = _detached(fp)
        self.collectives = 0
        sp_sweep = trace.begin("sweep")
        st = self.init_state(u, x, logdetj, logl, logp, sigma0, geom, fp, dbeta, beta, scp)
        # a step: the proposal, its likelihood, the accept step, then the
        # stopping rule's read of the state it leaves
        keep = self.keep_going(st)
        while keep:
            sp_step = trace.begin("sweep_step")
            sp = trace.begin("propose")
            prop = self.propose(st, geom, fp, scp, self.draw_noise(st, geom, generator), beta)
            if sp is not None:
                trace.end(sp)
            if gradient:
                logl_p = prop["logl"]
            else:
                sp = trace.begin("likelihood")
                logl_p = self.log_like(prop["x_safe"], prop["finite"])
                if sp is not None:
                    trace.end(sp)
            sp = trace.begin("accept")
            st, _ = self.accept_update(st, prop, logl_p, beta, geom)
            if sp is not None:
                trace.end(sp)
            keep = self.keep_going(st)
            if sp_step is not None:
                trace.end(sp_step)
        out = self._results(st)
        trace.end(sp_sweep)
        return out

    def run_stepped(self, u, x, logdetj, logl, logp, beta, sigma0, geom, fp, scp,
                    generator, host_like, blobs=None, dbeta=0.0):
        """The sweep with the likelihood on the host (the JAX package's
        ``_run_stepped_sweep``): the device proposes, ``host_like`` maps the
        finite proposals, float64 numpy rows (m, d), to (logl (m,), blobs
        (m,) or None), and the device accepts. ``blobs`` (n,) numpy follow
        the accept mask. Each step makes one device->host transfer (the
        proposal, its finite mask, the stopping-rule flag of the state it
        starts from, with blobs the previous step's accept mask and with a
        live sink that state's statistics, in one tensor) and
        one host->device transfer (the proposal's logl); the stopping rule
        is read before the likelihood runs, so a stop discards only the
        proposal. With a mesh, ``host_like`` sees this rank's rows. Returns
        (results, blobs); ``results["calls"]`` counts the rows handed to
        ``host_like`` on every rank. Each pass of the loop is a step span,
        the last one too: it proposes, and its read stops the sweep."""
        self.collectives = 0
        sp_sweep = trace.begin("sweep")
        st = self.init_state(u, x, logdetj, logl, logp, sigma0, geom, fp, dbeta)
        n, d = u.shape
        if blobs is not None:
            blobs = blobs.copy()
        pending = None  # (accept mask, proposal blobs) of the last step
        while True:
            sp_step = trace.begin("sweep_step")
            prop = None
            # with a live sink, the state's statistics lead the transfer, in
            # float64 (float32 would round the call count)
            live = _LIVE_SINK is not None and st.i > 0
            dt = torch.float64 if live else u.dtype
            parts = [self.live_stats(st)] if live else []
            if pending is not None:
                parts.append(pending[0].to(dt))
            if st.i < self.n_max:
                sp = trace.begin("propose")
                prop = self.propose(st, geom, fp, scp, self.draw_noise(st, geom, generator))
                if sp is not None:
                    trace.end(sp)
                parts += [prop["finite"].to(dt), self.keep_flag(st).to(dt).reshape(1),
                          prop["x_safe"].reshape(-1).to(dt)]
            sp = trace.begin("read")
            host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0)
            if sp is not None:
                trace.end(sp)
            if live:
                _live_emit(st.i, *host[:4])
                host = host[4:]
            if pending is not None:
                take = host[:n] > 0.5
                blobs[take] = pending[1][take]
                host = host[n:]
            if prop is None or (st.i > 0 and host[n] < 0.5):
                if sp_step is not None:
                    trace.end(sp_step)
                break
            finite = host[:n] > 0.5
            x_safe = host[n + 1:].reshape(n, d).astype(np.float64)
            logl_p = np.full(n, -np.inf)
            blobs_p = None
            if finite.any():
                sp = trace.begin("likelihood")
                ll, bl = host_like(x_safe[finite])
                if sp is not None:
                    trace.end(sp)
                logl_p[finite] = ll
                if bl is not None:
                    if blobs is None:
                        blobs = np.empty(n, dtype=bl.dtype)
                        blobs[:] = bl[0]
                    blobs_p = blobs.copy()
                    blobs_p[finite] = bl
            sp = trace.begin("accept")
            st, acc = self.accept_update(
                st, prop, torch.as_tensor(logl_p, dtype=u.dtype).to(u.device), beta, geom)
            if sp is not None:
                trace.end(sp)
            pending = None if blobs_p is None else (acc, blobs_p)
            if sp_step is not None:
                trace.end(sp_step)
        out = self._results(st)
        trace.end(sp_sweep)
        return out, blobs

    def _results(self, st):
        return dict(u=st.u, x=st.x, logdetj=st.logdetj, logl=st.logl,
                    logp=st.logp, efficiency=st.sigma, accept=st.accept,
                    steps=st.i, calls=st.calls, proposal_scale=st.sigma,
                    corr=st.corr, resid=st.resid, resid_exit=self.final_resid(st),
                    hot=st.hot, z_logl=st.z_logl, z_dim=st.z_dim,
                    misfit=st.misfit)
