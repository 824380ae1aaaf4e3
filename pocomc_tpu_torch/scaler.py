"""Change-of-variables reparameterization x <-> u (torch).

Counterpart of ``pocomc_tpu/scaler.py``. Every parameter maps to an
unbounded, standardized space: per-dimension bound bijections (none / left
/ right / both, probit or logit) computed branchlessly and selected by
static masks, an affine whitening on top (diagonal or full Cholesky), and
closed-form periodic / reflective boundary wrapping. ``forward(x) -> u``;
``inverse(u) -> (x, log|det dx/du|)`` summed over dimensions.

The fit runs once on host f64 numpy; the maps run on tensors of any device
and take the whitening moments as an argument (``params``, see
``whitening_params``) or read them from the fitted instance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .utils.validation import (assert_array_2d, assert_array_float,
                               assert_array_finite,
                               assert_array_within_interval)

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class Reparameterize:
    """Vectorized reparameterizer for bounded parameters (see module doc)."""

    def __init__(self, n_dim, bounds=None, periodic=None, reflective=None,
                 transform="probit", scale=True, diagonal=True):
        self.n_dim = int(n_dim)
        if bounds is None:
            bounds = np.full((self.n_dim, 2), np.inf)
            bounds[:, 0] = -np.inf
        bounds = np.asarray(bounds, dtype=np.float64)
        if bounds.shape == (2,):
            bounds = np.tile(bounds.reshape(1, 2), (self.n_dim, 1))
        if bounds.shape != (self.n_dim, 2):
            raise ValueError(f"bounds must have shape ({self.n_dim}, 2), got {bounds.shape}")
        if transform not in ("probit", "logit"):
            raise ValueError("transform must be 'probit' or 'logit'")
        self.transform = transform
        self.scale = bool(scale)
        self.diagonal = bool(diagonal)

        low, high = bounds[:, 0], bounds[:, 1]
        finite_low, finite_high = np.isfinite(low), np.isfinite(high)
        self.mask_none = ~finite_low & ~finite_high
        self.mask_left = finite_low & ~finite_high
        self.mask_right = ~finite_low & finite_high
        self.mask_both = finite_low & finite_high
        self.low, self.high = low, high
        self._low_s = np.where(finite_low, low, 0.0).astype(np.float32)
        self._high_s = np.where(finite_high, high, 1.0).astype(np.float32)
        rng = np.where(finite_low & finite_high, high - low, 1.0)
        self._range_s = rng.astype(np.float32)
        self._log_range = np.log(rng).astype(np.float32)

        self.periodic, self.reflective = periodic, reflective
        per = np.zeros(self.n_dim, dtype=bool)
        ref = np.zeros(self.n_dim, dtype=bool)
        if periodic is not None:
            per[np.asarray(periodic, dtype=int)] = True
        if reflective is not None:
            ref[np.asarray(reflective, dtype=int)] = True
        self.mask_periodic, self.mask_reflective = per, ref
        self.has_boundary = bool(per.any() or ref.any())

        self.mu = np.zeros(self.n_dim, np.float32)
        self.sigma = np.ones(self.n_dim, np.float32)
        self.L = None
        self.L_inv = None
        self.log_det_L = np.float32(0.0)
        self._fitted = False

    def _c(self, name, like):
        """The numpy constant ``self.<name>`` as a tensor on ``like``'s
        device (and dtype, for float constants), cached per device."""
        key = (name, like.device, like.dtype)
        cache = self.__dict__.setdefault("_consts", {})
        if key not in cache:
            a = getattr(self, name)
            t = torch.as_tensor(a, device=like.device)
            cache[key] = t if a.dtype == np.bool_ else t.to(like.dtype)
        return cache[key]

    # -- boundary conditions -----------------------------------------------

    def apply_boundary_conditions_x(self, x):
        """Closed-form periodic wrap and reflective fold in x-space."""
        if not self.has_boundary:
            return x
        rng, low = self._c("_range_s", x), self._c("_low_s", x)
        xp = low + torch.remainder(x - low, rng)
        y = torch.remainder(x - low, 2.0 * rng)
        xr = low + torch.minimum(y, 2.0 * rng - y)
        x = torch.where(self._c("mask_periodic", x), xp, x)
        return torch.where(self._c("mask_reflective", x), xr, x)

    # -- bound bijections --------------------------------------------------

    def _forward_bounds(self, x):
        eps = 1e-13
        low, high, rng = (self._c(a, x) for a in ("_low_s", "_high_s", "_range_s"))
        u_left = torch.log(torch.clamp(x - low, min=eps))
        u_right = torch.log(torch.clamp(high - x, min=eps))
        p = torch.clamp((x - low) / rng, eps, 1.0 - eps)
        if self.transform == "logit":
            u_both = torch.log(p) - torch.log1p(-p)
        else:
            u_both = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
        u = torch.where(self._c("mask_left", x), u_left, x)
        u = torch.where(self._c("mask_right", x), u_right, u)
        return torch.where(self._c("mask_both", x), u_both, u)

    def _inverse_bounds(self, u):
        low, high, rng, log_rng = (self._c(a, u) for a in (
            "_low_s", "_high_s", "_range_s", "_log_range"))
        x_left = torch.exp(u) + low
        x_right = high - torch.exp(u)
        if self.transform == "logit":
            x_both = torch.sigmoid(u) * rng + low
            j_both = log_rng - _softplus(-u) - _softplus(u)
        else:
            x_both = 0.5 * (torch.erf(u / math.sqrt(2.0)) + 1.0) * rng + low
            j_both = log_rng - 0.5 * u * u - _LOG_SQRT_2PI
        m_left, m_right, m_both = (self._c(m, u) for m in (
            "mask_left", "mask_right", "mask_both"))
        x = torch.where(m_left, x_left, u)
        j = torch.where(m_left, u, torch.zeros_like(u))
        x = torch.where(m_right, x_right, x)
        j = torch.where(m_right, u, j)
        x = torch.where(m_both, x_both, x)
        j = torch.where(m_both, j_both, j)
        return x, j.sum(-1)

    # -- fit (host f64) ----------------------------------------------------

    def _forward_bounds_np(self, x):
        from scipy.special import erfinv as np_erfinv
        eps = 1e-13
        low = self._low_s.astype(np.float64)
        high = self._high_s.astype(np.float64)
        rng = self._range_s.astype(np.float64)
        u_left = np.log(np.maximum(x - low, eps))
        u_right = np.log(np.maximum(high - x, eps))
        p = np.clip((x - low) / rng, eps, 1.0 - eps)
        if self.transform == "logit":
            u_both = np.log(p) - np.log1p(-p)
        else:
            u_both = np.sqrt(2.0) * np_erfinv(2.0 * p - 1.0)
        u = np.where(self.mask_left, u_left, x)
        u = np.where(self.mask_right, u_right, u)
        return np.where(self.mask_both, u_both, u)

    def fit(self, x):
        """Learn whitening moments from samples (host-side, once)."""
        x = assert_array_finite(assert_array_float(assert_array_2d(
            np.asarray(x, dtype=np.float64))))
        self._check_bounds(x)
        u = self._forward_bounds_np(x)
        self.mu = np.mean(u, axis=0).astype(np.float32)
        if self.diagonal:
            self.sigma = np.std(u, axis=0).astype(np.float32)
        else:
            L = np.linalg.cholesky(np.atleast_2d(np.cov(u.T)))
            self.L = L.astype(np.float32)
            self.L_inv = np.linalg.inv(L).astype(np.float32)
            self.log_det_L = np.float32(np.linalg.slogdet(L)[1])
        self._fitted = True

    def _check_bounds(self, x):
        try:
            assert_array_within_interval(x, np.asarray(self.low), np.asarray(self.high))
        except ValueError:
            raise ValueError("Input values outside the prior bounds.")

    # -- public API --------------------------------------------------------

    def whitening_params(self, device=None):
        """The fitted whitening moments as a dict of fp32 tensors."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        if self.diagonal:
            return dict(mu=t(self.mu), sigma=t(self.sigma))
        return dict(mu=t(self.mu), L=t(self.L), L_inv=t(self.L_inv),
                    log_det_L=t(self.log_det_L))

    def forward(self, x, check_input=False, params=None):
        """x -> u (bound bijection then whitening)."""
        if check_input:
            self._check_bounds(x.detach().cpu().numpy())
        p = self.whitening_params(x.device) if params is None else params
        u = self._forward_bounds(x)
        if self.scale:
            if self.diagonal:
                u = (u - p["mu"]) / p["sigma"]
            else:
                u = (u - p["mu"]) @ p["L_inv"].T
        return u

    def inverse(self, u, params=None):
        """u -> (x, log|det dx/du|) summed over dimensions."""
        p = self.whitening_params(u.device) if params is None else params
        if not self.scale:
            return self._inverse_bounds(u)
        if self.diagonal:
            v = p["mu"] + p["sigma"] * u
            ladj_affine = torch.log(p["sigma"]).sum()
        else:
            v = p["mu"] + u @ p["L"].T
            ladj_affine = p["log_det_L"]
        x, ladj = self._inverse_bounds(v)
        return x, ladj + ladj_affine
