"""Pareto-smoothed importance sampling (PSIS) for the flow-IS evidence.

Host-side float64 numpy, moved over unchanged from ``pocomc_tpu/ops/psis.py``
(PSIS: Vehtari, Simpson, Gelman, Yao & Gabry, JMLR 25(72), 2024). The
generalized Pareto fit to the largest importance ratios gives the tail
diagnostic k-hat:

    k-hat <= 0.5   ratios have finite variance; plain IS is fine
    0.5 < k < 0.7  finite mean, infinite variance; PSIS still converges
    k-hat >  0.7   estimate unreliable regardless of smoothing

It runs once per ``Sampler.run`` on a few thousand ratios, so it stays on
the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gpdfit", "gpd_quantile", "psislw"]

# k-hat is regularized toward 0.5 with a weakly-informative prior worth
# this many pseudo-observations (Vehtari et al. 2024, appendix C).
_PRIOR_K_OBS = 10.0


def gpdfit(x: np.ndarray) -> tuple[float, float]:
    """Fit a generalized Pareto to exceedances ``x > 0``.

    Zhang & Stephens (Technometrics 51(3), 2009): a quadrature posterior
    mean over a data-driven grid of ``theta = xi/sigma`` values -- no
    iterative optimization, robust for the tiny tail sizes PSIS uses.

    Returns ``(k, sigma)`` with the Vehtari sign convention: ``k > 0`` is
    a heavy (polynomial) tail, CDF ``1 - (1 + k x / sigma)^(-1/k)``.
    """
    x = np.asarray(x, dtype=np.float64)
    x = np.sort(x[x > 0])
    n = x.size
    if n < 5 or not np.isfinite(x[-1]):
        return np.inf, np.nan

    # grid of theta values concentrated near the likelihood mode
    m = 30 + int(np.sqrt(n))
    j = np.arange(1, m + 1, dtype=np.float64)
    x_quart = x[int(n / 4.0 + 0.5) - 1]
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * x_quart)

    # profile log-likelihood of theta (k profiled out analytically)
    k_prof = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    logL = n * (np.log(-theta / k_prof) - k_prof - 1.0)
    # posterior-mean theta under the implied flat prior (differences are
    # clipped: an overflowing term only drives that theta's weight to 0)
    w = 1.0 / np.sum(np.exp(np.minimum(logL[None, :] - logL[:, None],
                                       700.0)), axis=1)
    theta_hat = np.sum(theta * w)

    k = float(np.mean(np.log1p(-theta_hat * x)))
    sigma = float(-k / theta_hat)
    # regularize k-hat toward 0.5 (stabilizes the n ~ few-hundred tails)
    k = (n * k + _PRIOR_K_OBS * 0.5) / (n + _PRIOR_K_OBS)
    return float(k), sigma


def gpd_quantile(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    """Inverse CDF of the GPD at probabilities ``p`` (same convention as
    :func:`gpdfit`; ``k -> 0`` reduces to the exponential)."""
    p = np.asarray(p, dtype=np.float64)
    if not np.isfinite(k) or sigma <= 0 or not np.isfinite(sigma):
        return np.full_like(p, np.nan)
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psislw(logw: np.ndarray) -> tuple[np.ndarray, float]:
    """Pareto-smooth a vector of log importance ratios.

    Returns ``(logw_smoothed, k_hat)``.  The smoothed vector differs from
    the input only in its upper tail: the ``M = min(n/5, 3*sqrt(n))``
    largest ratios are replaced by the order statistics of the fitted
    GPD, capped at the observed maximum.  Smoothing preserves the input's
    normalization scale (ratios are shifted by max(logw) internally and
    shifted back), so ``logsumexp(logw_smoothed) - log(n)`` is directly
    the PSIS evidence estimate.

    ``k_hat`` is returned even when smoothing is skipped (tail too small
    or degenerate); in that case it is ``inf`` and the input is returned
    unchanged.
    """
    logw = np.asarray(logw, dtype=np.float64)
    n = logw.size
    out = logw.copy()
    if n < 5:
        return out, np.inf

    shift = np.max(logw)
    lw = logw - shift

    # tail = the M largest ratios strictly above the cutoff order statistic
    m_tail = int(np.ceil(min(n / 5.0, 3.0 * np.sqrt(n))))
    order = np.argsort(lw, kind="stable")
    cutoff = max(lw[order[-m_tail - 1]], np.log(np.finfo(np.float64).tiny))
    tail_ids = order[lw[order] > cutoff]
    if tail_ids.size < 5:
        return out, np.inf

    exc = np.exp(lw[tail_ids]) - np.exp(cutoff)
    k_hat, sigma = gpdfit(exc)
    if not np.isfinite(k_hat):
        return out, k_hat

    # expected order statistics of the fitted GPD, assigned rank-for-rank
    # (tail_ids is ascending in lw already, argsort order)
    p = (np.arange(1, tail_ids.size + 1) - 0.5) / tail_ids.size
    smoothed = np.log(gpd_quantile(p, k_hat, sigma) + np.exp(cutoff))
    out[tail_ids] = np.minimum(smoothed, 0.0) + shift
    return out, k_hat
