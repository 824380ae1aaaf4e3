"""Multivariate Student-t EM fit (torch).

Counterpart of ``pocomc_tpu/models/student.py``: init mu = median, Sigma =
cov*(n-1)/n + diag(var)/n, nu = 20; E-step weights w_i = (nu + d)/(nu +
delta_i); nu from the EM fixed-point equation, solved by a fixed-count
bisection in log(nu) with the cancellation-free form of the equation;
nu -> +inf (Gaussian limit) when the equation has no root, in which case
mu/Sigma keep their current values. The EM loop runs on the host, one
scalar sync per iteration; the bisection stays on the device. Each
scalar the host hands the card is a copy that waits for it, as the sync
does: both are ``read`` spans (``utils/trace.py``).
"""

from __future__ import annotations

import math

import torch

from ..utils import trace

_NU_LOG_LO = -6.9   # log(1e-3)
_NU_LOG_HI = 10.3   # log(~3e4); above this f32 cannot resolve the equation
_BISECT_ITERS = 60


def _log_minus_digamma(x):
    """h(x) = log(x) - digamma(x) > 0: direct below 32, asymptotic series
    1/(2x) + 1/(12x^2) - 1/(120x^4) above, where the direct form cancels."""
    direct = torch.log(x) - torch.digamma(x)
    inv = 1.0 / torch.clamp(x, min=1e-30)
    series = 0.5 * inv + inv * inv / 12.0 - inv ** 4 / 120.0
    return torch.where(x < 32.0, direct, series)


def _nu_equation(log_nu, d, delta, n):
    """f(nu) = h(nu/2) - h((nu+d)/2) + mean(log1p(e) - e), with
    e_i = (d - delta_i) / (nu + delta_i)."""
    nu = torch.exp(log_nu)
    e = (d - delta) / (nu + delta)
    tail = (torch.log1p(e) - e).sum() / n
    return _log_minus_digamma(nu / 2.0) - _log_minus_digamma((nu + d) / 2.0) + tail


def _solve_nu(d, delta, n):
    """Fixed-count bisection for nu in log space; +inf if no root."""
    sp = trace.begin("read")
    lo = torch.tensor(_NU_LOG_LO, dtype=delta.dtype, device=delta.device)
    hi = torch.tensor(_NU_LOG_HI, dtype=delta.dtype, device=delta.device)
    if sp is not None:
        trace.end(sp)
    f_hi = _nu_equation(hi, d, delta, n)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        pos = _nu_equation(mid, d, delta, n) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    nu = torch.exp(0.5 * (lo + hi))
    return torch.where(f_hi >= 0, torch.full_like(nu, math.inf), nu)


def _median(data):
    """Column median, averaging the two middle values (jnp.median)."""
    s, _ = torch.sort(data, dim=0)
    n = data.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _mahalanobis(data, mu, sigma):
    chol, info = torch.linalg.cholesky_ex(sigma)
    chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))
    y = torch.linalg.solve_triangular(chol, (data - mu).T, upper=False)
    return (y * y).sum(0)


def fit_mvstud(data, tolerance=1e-6, max_iter=100):
    """EM fit of a multivariate Student-t to (n, d) samples.

    Returns mu (d,), Sigma (d, d), nu (0-d tensor, possibly +inf)."""
    n, d = data.shape
    mu = _median(data)
    diffs0 = data - data.mean(0)
    sigma = diffs0.T @ diffs0 / n + torch.diag(data.var(0, unbiased=False)) / n
    sp = trace.begin("read")
    nu = torch.tensor(20.0, dtype=data.dtype, device=data.device)
    if sp is not None:
        trace.end(sp)
    last_nu = torch.zeros_like(nu)
    done = torch.zeros((), dtype=torch.bool, device=data.device)
    for _ in range(max_iter):
        go = (~done) & ((last_nu - nu).abs() > tolerance)
        sp = trace.begin("read")
        go = bool(go)
        if sp is not None:
            trace.end(sp)
        if not go:
            break
        delta = _mahalanobis(data, mu, sigma)
        nu_new = _solve_nu(float(d), delta, float(n))
        is_inf = ~torch.isfinite(nu_new)
        w = (nu_new + d) / (nu_new + delta)
        sigma_new = (w[:, None] * (data - mu)).T @ (data - mu) / n
        mu_new = (w[:, None] * data).sum(0) / w.sum()
        last_nu = nu
        mu = torch.where(is_inf, mu, mu_new)
        sigma = torch.where(is_inf, sigma, sigma_new)
        nu = torch.where(is_inf, torch.full_like(nu, math.inf), nu_new)
        done = done | is_inf
    return mu, sigma, nu
