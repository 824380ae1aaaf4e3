"""Plain copies of the sequential Monte Carlo arithmetic the sampler's
device loop runs: phase A's next temperature and its importance weights
over the persistent history (Karamanis et al. 2022, "persistent
sampling"), and the t-pCN Metropolis accept step.

Inputs are the program's history as it stood when it ran the step (the
temperatures it reached are program state that the reference follows step
by step); everything is recomputed here at ``prec``.
"""

from __future__ import annotations

import math

import torch

from .precision import cast

NEG_BIG = -1e30


def _flat_weights(logl, B, valid, beta):
    """Normalised flat weights (T*n,) at ``beta`` and logZ."""
    T, n = logl.shape
    logw = torch.where(valid[:, None], logl * beta - B,
                       torch.full_like(B, NEG_BIG)).reshape(-1)
    norm = torch.logsumexp(logw, 0)
    total = valid.sum() * n
    logz = norm - torch.log(total.to(logl.dtype))
    w = torch.exp(logw - norm - (logw - norm).max())
    w = torch.where(valid.repeat_interleave(n), w, torch.zeros_like(w))
    return w / w.sum(), logz


def next_beta(logl, beta_hist, logz_hist, t, n_effective, resid_prev, bias_budget,
              n_bisect=26, prec="float64"):
    """Phase A's temperature for a history whose first ``t`` slots are
    filled: the balance-heuristic mixture weights of every filled slot,
    the temperature at which their Kish ESS falls to ``n_effective`` by
    ``n_bisect`` halvings of [beta_prev, 1], the advance capped at
    ``bias_budget / |resid_prev|`` (at least 2^-8). Returns (beta, logZ
    rung with the residual correction)."""
    logl, beta_hist, logz_hist = (cast(a, prec) for a in (logl, beta_hist, logz_hist))
    dt, dev = logl.dtype, logl.device
    T, n = logl.shape
    valid = torch.arange(T, device=dev) < t
    n_eff = torch.as_tensor(float(n_effective), dtype=dt, device=dev)
    resid = torch.as_tensor(float(resid_prev), dtype=dt, device=dev)
    b = logl[None] * beta_hist[:, None, None] - logz_hist[:, None, None]
    b = torch.where(valid[:, None, None], b, torch.full_like(b, NEG_BIG))
    B = torch.logsumexp(b, 0) - torch.log(valid.sum().to(dt))
    ess = lambda w: 1.0 / (w * w).sum()
    beta_prev, logz_prev = beta_hist[max(t - 1, 0)], logz_hist[max(t - 1, 0)]
    one = torch.ones((), dtype=dt, device=dev)
    lo, hi = beta_prev, one
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess(_flat_weights(logl, B, valid, mid)[0]) >= n_eff
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    m_prev = ess(_flat_weights(logl, B, valid, beta_prev)[0])
    m_one = ess(_flat_weights(logl, B, valid, one)[0])
    beta = torch.where(m_prev <= n_eff, beta_prev,
                       torch.where(m_one >= n_eff, one, 0.5 * (lo + hi)))
    if bias_budget > 0.0:
        adv = torch.clamp(bias_budget / torch.clamp(resid.abs(), min=1e-12), min=2.0 ** -8)
        beta = torch.where(beta > beta_prev, torch.minimum(beta, beta_prev + adv), beta)
    _, logz_new = _flat_weights(logl, B, valid, beta)
    logz = torch.where(beta == beta_prev, logz_prev, logz_new + (beta - beta_prev) * resid)
    return beta, logz


def weights_at(logl, beta_hist, logz_hist, t, beta, prec="float64"):
    """The normalised flat weights (T*n,) of the first ``t`` slots at the
    temperature ``beta``."""
    logl, beta_hist, logz_hist = (cast(a, prec) for a in (logl, beta_hist, logz_hist))
    dt, dev = logl.dtype, logl.device
    T, n = logl.shape
    valid = torch.arange(T, device=dev) < t
    b = logl[None] * beta_hist[:, None, None] - logz_hist[:, None, None]
    b = torch.where(valid[:, None, None], b, torch.full_like(b, NEG_BIG))
    B = torch.logsumexp(b, 0) - torch.log(valid.sum().to(dt))
    return _flat_weights(logl, B, valid, torch.as_tensor(float(beta), dtype=dt, device=dev))[0]


def t_correction(q, nu, d):
    """The t-pCN reversibility term at quadratic form q: -(d + nu)/2
    log1p(q / nu)."""
    return -0.5 * (d + nu) * torch.log1p(q / nu)


def tpcn_log_ratio(old, prop, logl_p, beta, nu, d, preconditioned=True, prec="float64"):
    """The t-pCN Metropolis log ratio of each row: beta (logl' - logl) +
    (logp' - logp) + (logdetj' - logdetj) [+ the flow's log-det change] -
    t(q') + t(q). ``old`` and ``prop`` map names to row tensors. Also
    returns the rounding scale of the sum (the sum of the magnitudes of its
    terms)."""
    c = lambda a: cast(a, prec)
    beta, nu = c(torch.as_tensor(beta)), c(torch.as_tensor(nu))
    terms = [beta * (c(logl_p) - c(old["logl"])), c(prop["logp"]) - c(old["logp"]),
             c(prop["logdetj"]) - c(old["logdetj"])]
    if preconditioned:
        terms.append(c(prop["logdetj_flow"]) - c(old["logdetj_flow"]))
    terms += [-t_correction(c(prop["qp"]), nu, d), t_correction(c(prop["q"]), nu, d)]
    total = sum(terms)
    scale = sum(t.abs() for t in terms) + sum(c(a).abs() for a in
                                              (logl_p, old["logl"], prop["logp"], old["logp"]))
    return total, scale


def accept_mask(log_ratio, unif):
    """Metropolis: accept where unif < min(1, exp(log_ratio)), a NaN ratio
    rejected."""
    alpha = torch.clamp(torch.exp(log_ratio), max=1.0)
    alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
    return unif.to(alpha.dtype) < alpha


def log_uniform_margin(log_ratio, unif):
    """How far each row's decision lies from its threshold: |log unif -
    log_ratio| where the ratio is below 1 (rows above it accept for any
    unif < 1)."""
    lu = torch.log(unif.to(log_ratio.dtype))
    return torch.where(log_ratio >= 0, torch.full_like(log_ratio, math.inf),
                       (lu - log_ratio).abs())
