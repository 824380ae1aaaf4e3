"""Flow-anchored bridge evidence: the warped temperature path (torch).

Counterpart of ``pocomc_tpu/bridge.py``. ``run(n_evidence=0)`` reads logZ
off a fresh population annealed from the trained flow to the posterior
along the geometric bridge in the flow's latent space,

    pi_s(theta) ∝ N(theta; 0, I) * exp(s * f(theta)),   s: 0 -> 1
    f(theta) = log p(x(theta)) + log L(x(theta)) + log|J(theta)|
               - log N(theta; 0, I)

where x(theta) is the flow and scaler pullback and |J| its Jacobian. s = 0
is sampled exactly (theta ~ N(0, I)); each rung adds log E_{pi_s}[exp(ds
f)], then resamples systematically by exp(ds f) and runs ``n_steps``
latent pCN steps (theta' = sqrt(1 - sig^2) theta + sig z is N(0, I)
reversible, so the Metropolis ratio is exp(s (f' - f))) with the
misfit-adaptive sigma cap.

``init`` and ``rung`` (``make_bridge_programs``) are torch functions on
the device, and ``run_bridge`` keeps the ladder on the host in float64.
Both likelihood routes of the JAX package run through them and differ
only in the ``log_like(x, mask)`` they give and where their draws come
from:

- the device route: the port's ``make_loglike(fn)``, on the finite rows;
  the s = 0 draws and each rung's ``draw_rung_noise`` from the sampler's
  ``torch.Generator`` (``device_draws``);
- the black-box route: ``host_loglike``, the user's numpy likelihood on
  the finite rows between the device pullbacks; every draw from the
  sampler's numpy ``Generator`` in the JAX host loop's order
  (``host_draws``), and f kept in float64.

The noise is ``rung``'s argument, so a test can inject it.

Every pullback runs K1 (``Flow.kernel_inv``) on ``n`` rows. All of it runs
under ``torch.no_grad()``: the flow's parameters sit in the autograd graph
while grad is on, and K1 has no gradient.

A bridge that gives up (no finite f at s = 0, a population that loses
every finite f mid-ladder, ``max_rungs`` spent) returns ``dict(failed=
reason, calls=calls)``, so the caller still counts the calls it made (the
JAX package returns None and drops them). The JAX package's TPU-only
guards have no counterpart: ``callbacks_supported()`` (a likelihood here
never needs host callbacks inside a device program), the multi-process
mesh (the port runs on one device) and the program cache (nothing is
compiled).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.resampling import systematic_resample_torch


def _log_normal(theta, n_dim):
    return -0.5 * (theta * theta).sum(-1) - 0.5 * n_dim * math.log(2.0 * math.pi)


def make_bridge_host_program(scaler, log_prior, n_dim, flow_inv):
    """``to_x(fp, scp, theta) -> (x_safe, f_part, finite)``: the pullback of
    latent rows theta (n, d) through the flow (``flow_inv(theta, fp)``,
    reporting log|det du/dtheta|) and the scaler, with f_part = logp +
    ldj_scaler + ldj_flow - log N(theta) and -inf where the pullback or the
    prior is not finite (those rows' x_safe are 0). Everything of f but the
    likelihood."""

    @torch.no_grad()
    def to_x(fp, scp, theta):
        u, ldjf = flow_inv(theta, fp)
        x, ldj = scaler.inverse(u, params=scp)
        if scaler.has_boundary:
            x = scaler.apply_boundary_conditions_x(x)
            x, ldj = scaler.inverse(scaler.forward(x, params=scp), params=scp)
        finite = torch.isfinite(ldjf) & torch.isfinite(ldj) & torch.isfinite(x).all(1)
        x_safe = torch.where(finite[:, None], x, torch.zeros_like(x))
        logp = torch.where(finite, log_prior(x_safe), torch.full_like(ldj, -math.inf))
        finite = finite & torch.isfinite(logp)
        f_part = torch.where(finite, logp + ldj + ldjf - _log_normal(theta, n_dim),
                             torch.full_like(ldj, -math.inf))
        return x_safe, f_part, finite

    return to_x


def make_bridge_programs(scaler, log_prior, log_like, n_dim, flow_inv,
                         n_steps: int = 10, accept_target: float = 0.234):
    """(init, rung) of both routes. ``log_like(x, mask)`` is the port's
    ``make_loglike(fn)`` or ``host_loglike(fn)``; ``flow_inv`` as in
    ``make_bridge_host_program``.

    ``init(theta, fp, scp) -> (f, calls)`` evaluates f at the s = 0 draws.
    ``rung(theta, f, sigma, s_new, ds, noise, fp, scp) -> (theta, f,
    sigma, mean_accept, calls)``: the systematic resample by exp(ds f) at
    offset ``noise["u0"]``, then ``n_steps`` pCN steps at temperature
    s_new with the normals ``noise["z"][i]`` and uniforms
    ``noise["unif"][i]`` (``draw_rung_noise``)."""
    to_x = make_bridge_host_program(scaler, log_prior, n_dim, flow_inv)
    sig_loc = min(2.38 / math.sqrt(n_dim), 0.99)

    def f_eval(theta, fp, scp):
        x_safe, f_part, finite = to_x(fp, scp, theta)
        logl = log_like(x_safe, finite)
        f = torch.where(finite & torch.isfinite(logl), f_part + logl,
                        torch.full_like(f_part, -math.inf))
        return f, finite.sum()

    @torch.no_grad()
    def init(theta, fp, scp):
        return f_eval(theta, fp, scp)

    @torch.no_grad()
    def rung(theta, f, sigma, s_new, ds, noise, fp, scp):
        n = theta.shape[0]
        lw = ds * f
        idx = systematic_resample_torch(n, torch.exp(lw - lw.max()), u0=noise["u0"])
        th, fv, sig = theta[idx], f[idx], sigma
        accs, calls = [], torch.zeros((), dtype=torch.int64, device=theta.device)
        for i in range(n_steps):
            th_p = torch.sqrt(1.0 - sig ** 2) * th + sig * noise["z"][i]
            f_p, n_ev = f_eval(th_p, fp, scp)
            calls = calls + n_ev
            # N(0, I)-reversible proposal: the ratio for N exp(s f) is
            # exp(s (f' - f))
            alpha = torch.clamp(torch.exp(s_new * (f_p - fv)), max=1.0)
            alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
            acc = noise["unif"][i] < alpha
            th = torch.where(acc[:, None], th_p, th)
            fv = torch.where(acc, f_p, fv)
            a_mean = alpha.mean()
            accs.append(a_mean)
            # misfit-adaptive cap, as the t-pCN sweep's: std(s f) over the
            # live population measures the mismatch to the N(0, I) base
            ok = torch.isfinite(fv)
            nn = torch.clamp(ok.sum(), min=1).to(fv.dtype)
            zero = torch.zeros_like(fv)
            fm = torch.where(ok, fv, zero).sum() / nn
            fvar = torch.where(ok, (fv - fm) ** 2, zero).sum() / nn
            misfit = s_new * torch.sqrt(fvar)
            cap = sig_loc + (0.99 - sig_loc) * torch.exp(-0.5 * misfit ** 2)
            sig = torch.minimum(torch.clamp(
                sig + (a_mean - accept_target) / (i + 1) ** 0.75, min=1e-3), cap)
        return th, fv, sig, torch.stack(accs).mean(), calls

    return init, rung


def draw_rung_noise(n, n_dim, n_steps, generator, device):
    """One rung's random numbers: the resample offset u0 (), the pCN
    normals z (n_steps, n, n_dim) and the acceptance uniforms unif
    (n_steps, n)."""
    return dict(u0=torch.rand((), generator=generator, device=device),
                z=torch.randn(n_steps, n, n_dim, generator=generator, device=device),
                unif=torch.rand(n_steps, n, generator=generator, device=device))


def device_draws(n, n_dim, n_steps, generator, rng):
    """The device route's randomness for ``run_bridge``: the s = 0 draws
    and each rung's ``draw_rung_noise`` from the torch ``generator``, the
    bootstrap from a numpy generator seeded from ``rng``."""
    theta = torch.randn(n, n_dim, generator=generator, device=generator.device)
    return (theta, lambda: draw_rung_noise(n, n_dim, n_steps, generator, generator.device),
            np.random.default_rng(int(rng.integers(2**31 - 1))))


def host_draws(n, n_dim, n_steps, rng, device):
    """The black-box route's randomness for ``run_bridge``: every draw from
    the numpy ``rng``, in the order of the JAX package's host loop: the
    s = 0 draws, then per rung the bootstrap, the resample offset and each
    step's normals and uniforms (the uniforms kept in float64)."""
    theta = torch.as_tensor(rng.standard_normal((n, n_dim)), dtype=torch.float32,
                            device=device)

    def draw_noise():
        u0 = rng.random()
        steps = [(rng.standard_normal((n, n_dim)), rng.random(n)) for _ in range(n_steps)]
        return dict(u0=torch.tensor(u0, dtype=torch.float64, device=device),
                    z=torch.as_tensor(np.stack([z for z, _ in steps]), dtype=torch.float32,
                                      device=device),
                    unif=torch.as_tensor(np.stack([u for _, u in steps]), device=device))

    return theta, draw_noise, rng


def host_loglike(log_like_host):
    """``log_like(x, mask)`` for ``make_bridge_programs`` from a likelihood
    of float64 numpy rows: one transfer brings x and the mask to the host,
    ``log_like_host`` runs on the masked rows, and logl (float64, -inf on
    the other rows) goes back to x's device, so f is kept in float64 as
    the JAX package's host loop keeps it."""

    def log_like(x, mask):
        n, d = x.shape
        host = torch.cat([x.reshape(-1), mask.to(x.dtype)]).double().cpu().numpy()
        xh, ok = host[:n * d].reshape(n, d), host[n * d:] > 0.5
        logl = np.full(n, -np.inf)
        if ok.any():
            logl[ok] = np.asarray(log_like_host(xh[ok]), dtype=np.float64)
        return torch.from_numpy(logl).to(x.device)

    return log_like


def _ess_frac(lw: np.ndarray) -> float:
    """ESS/n of weights exp(lw) over ALL n rows (-inf rows count in n)."""
    ok = np.isfinite(lw)
    if not ok.any():
        return 0.0
    m = lw[ok].max()
    w = np.exp(lw[ok] - m)
    return float(w.sum() ** 2 / (len(lw) * (w * w).sum()))


def _logmeanexp(lw: np.ndarray) -> float:
    ok = np.isfinite(lw)
    if not ok.any():
        return -np.inf
    m = lw[ok].max()
    return float(m + np.log(np.exp(lw[ok] - m).sum()) - np.log(len(lw)))


def _boot_var(lw: np.ndarray, rng: np.random.Generator,
              n_boot: int = 200) -> float:
    """Bootstrap variance of _logmeanexp over particles (host f64)."""
    n = len(lw)
    w = np.exp(np.where(np.isfinite(lw), lw - np.nanmax(
        np.where(np.isfinite(lw), lw, -np.inf)), -np.inf))
    w = np.where(np.isfinite(w), w, 0.0)
    idx = rng.integers(0, n, size=(n_boot, n))
    means = w[idx].mean(axis=1)
    vals = np.log(np.maximum(means, 1e-300))
    return float(np.var(vals))


def _next_ds(f, s, ess_target):
    """The rung size: all of 1 - s if the ESS fraction of exp((1 - s) f)
    stays at ess_target, else the bisection's 40 halvings (floored at
    1e-6 (1 - s))."""
    hi = 1.0 - s
    if _ess_frac(hi * f) >= ess_target:
        return hi
    lo = 0.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if _ess_frac(mid * f) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, 1e-6 * (1.0 - s))


class _Ladder:
    """The host f64 ladder both routes share: per rung the bisected ds,
    the ESS minimum, logZ += log mean exp(ds f) and its bootstrap
    variance, and the s path."""

    def __init__(self, ess_target, boot_rng):
        self.ess_target, self.boot_rng = ess_target, boot_rng
        self.s, self.logz, self.var, self.ess_min = 0.0, 0.0, 0.0, 1.0
        self.s_path = []

    def step(self, f):
        """Add one rung; returns its ds."""
        ds = _next_ds(f, self.s, self.ess_target)
        self.ess_min = min(self.ess_min, _ess_frac(ds * f))
        self.logz += _logmeanexp(ds * f)
        self.var += _boot_var(ds * f, self.boot_rng)
        self.s = min(self.s + ds, 1.0)
        self.s_path.append(self.s)
        return ds

    def result(self, calls, accept_last):
        return dict(logz=float(self.logz), logz_err=float(np.sqrt(self.var)),
                    rungs=len(self.s_path), calls=calls, ess_min=float(self.ess_min),
                    accept_last=accept_last, s_path=np.asarray(self.s_path))


def run_bridge(init, rung, fp, scp, draws, ess_target=0.5, max_rungs=64, sigma0=0.9):
    """The host orchestration of both routes: ``draws`` is
    ``device_draws(...)`` or ``host_draws(...)``, (theta at s = 0, a
    function that draws one rung's noise, the bootstrap's numpy
    generator). One transfer per rung brings f, the mean acceptance and
    the call count to the host. Returns dict(logz, logz_err, rungs, calls,
    ess_min, accept_last, s_path), or dict(failed=reason, calls=calls)."""
    theta, draw_noise, boot_rng = draws
    n = theta.shape[0]
    f, n_ev = init(theta, fp, scp)
    host = torch.cat([f, n_ev.to(f.dtype).reshape(1)]).double().cpu().numpy()
    f_host, calls = host[:n], int(host[n])
    if not np.isfinite(f_host).any():
        return dict(failed="no finite f at s=0", calls=calls)
    ladder = _Ladder(ess_target, boot_rng)
    sigma = torch.tensor(sigma0, dtype=f.dtype, device=f.device)
    acc = float("nan")
    for _ in range(max_rungs):
        if not np.isfinite(f_host).any():
            return dict(failed="every f non-finite mid-ladder", calls=calls)
        ds = ladder.step(f_host)
        if ladder.s >= 1.0:
            return ladder.result(calls, acc)
        theta, f, sigma, a_mean, n_ev = rung(theta, f, sigma, ladder.s, ds, draw_noise(),
                                             fp, scp)
        host = torch.cat([f, a_mean.reshape(1), n_ev.to(f.dtype).reshape(1)])
        host = host.double().cpu().numpy()
        f_host, acc, calls = host[:n], float(host[n]), calls + int(host[n + 1])
    return dict(failed=f"s={ladder.s:.4g} < 1 after max_rungs={max_rungs}", calls=calls)
