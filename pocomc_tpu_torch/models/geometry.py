"""Proposal geometry: weighted Gaussian moments + Student-t EM fit (torch).

Counterpart of ``pocomc_tpu/models/geometry.py``: weighted normal moments
(np.cov(aweights=w, ddof=1) normalization), a Student-t EM fit on a
systematic resample of the weighted points, nu clamped to 1e6 when the EM
returns a non-finite value and to >= 1 below, Ledoit-Wolf shrinkage of
both covariances (the t intensity on the EM-weighted residuals), and the
Cholesky factors and inverse the t-pCN kernel consumes. Without weights
the moments are the plain (n - 1) ones and the EM runs on the points
themselves. ``Geometry`` holds a fit's tensors as attributes.
"""

from __future__ import annotations

import torch

from .student import fit_mvstud
from ..ops.resampling import systematic_resample_torch


def _weighted_moments(theta, weights):
    w = weights / weights.sum()
    mean = (w[:, None] * theta).sum(0)
    diffs = theta - mean
    v2 = (w * w).sum()
    cov = (w[:, None] * diffs).T @ diffs / (1.0 - v2)
    return mean, cov


def _unweighted_moments(theta):
    mean = theta.mean(0)
    diffs = theta - mean
    return mean, diffs.T @ diffs / (theta.shape[0] - 1)


def _lw_lambda(x, mean, cov):
    """Ledoit-Wolf (2004) shrinkage intensity toward the scaled identity,
    from the points the covariance was estimated from."""
    d = cov.shape[0]
    n = x.shape[0]
    mu = torch.trace(cov) / d
    xc = x - mean
    d2 = ((cov * cov).sum() - d * mu ** 2) / d
    q = (xc * xc).sum(1)
    xsx = torch.einsum("ki,ij,kj->k", xc, cov, xc)
    b2 = ((q ** 2).sum() - 2.0 * xsx.sum() + n * (cov * cov).sum()) / (float(n) ** 2 * d)
    b2 = torch.minimum(b2, d2)
    return torch.where(d2 > 0, b2 / torch.clamp(d2, min=1e-30), torch.zeros_like(d2))


def _lw_shrink(cov, lam):
    d = cov.shape[0]
    mu = torch.trace(cov) / d
    return (1.0 - lam) * cov + lam * mu * torch.eye(d, dtype=cov.dtype, device=cov.device)


def _reg(cov):
    d = cov.shape[0]
    eps = 1e-12 * torch.trace(cov) / d
    return cov + eps * torch.eye(d, dtype=cov.dtype, device=cov.device)


def _chol(a):
    """Cholesky factor, NaN (as in JAX) instead of an error if not PD."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def fit_geometry(theta, weights=None, generator=None, u0=None):
    """Full geometry fit. With ``weights``, the systematic resample's offset
    comes from ``generator``, or is given as ``u0``; without, the points
    are used as they are. Returns the dict of normal_mean/cov/chol and
    t_mean/cov/nu/chol/inv_cov."""
    if weights is None:
        normal_mean, normal_cov = _unweighted_moments(theta)
        pts = theta
    else:
        normal_mean, normal_cov = _weighted_moments(theta, weights)
        idx = systematic_resample_torch(theta.shape[0], weights, generator, u0=u0)
        pts = theta[idx]
    t_mean, t_cov, t_nu = fit_mvstud(pts)
    t_nu = torch.where(torch.isfinite(t_nu), t_nu, torch.full_like(t_nu, 1e6))
    # lower clamp at the Cauchy: a sub-Cauchy proposal makes the t-pCN
    # correction terms near-singular
    t_nu = torch.clamp(t_nu, min=1.0)
    d = pts.shape[1]
    xc_t = pts - t_mean
    chol_t = _chol(_reg(t_cov))
    yt = torch.linalg.solve_triangular(chol_t, xc_t.T, upper=False)
    delta_t = (yt * yt).sum(0)
    w_em = (t_nu + d) / (t_nu + delta_t)
    t_cov = _lw_shrink(t_cov, _lw_lambda(torch.sqrt(w_em)[:, None] * xc_t, 0.0, t_cov))
    normal_cov = _lw_shrink(normal_cov, _lw_lambda(pts, normal_mean, normal_cov))
    t_cov_reg = _reg(t_cov)
    return dict(
        normal_mean=normal_mean,
        normal_cov=normal_cov,
        normal_chol=_chol(_reg(normal_cov)),
        t_mean=t_mean,
        t_cov=t_cov,
        t_nu=t_nu,
        t_chol=_chol(t_cov_reg),
        t_inv_cov=torch.linalg.inv_ex(t_cov_reg)[0],
    )


class Geometry:
    """A geometry fit's tensors as attributes (None before ``fit``)."""

    KEYS = ("normal_mean", "normal_cov", "normal_chol", "t_mean", "t_cov",
            "t_nu", "t_chol", "t_inv_cov")

    def __init__(self):
        for k in self.KEYS:
            setattr(self, k, None)

    def fit(self, theta, weights=None, generator=None):
        for k, v in fit_geometry(theta, weights, generator).items():
            setattr(self, k, v)
        return self
