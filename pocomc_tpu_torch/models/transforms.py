"""Univariate monotone transforms for autoregressive flows (torch).

Counterpart of ``pocomc_tpu/models/transforms.py``: the monotonic affine
map and the 8-bin rational-quadratic spline (RQS) on [-B, B] with identity
tails. Raw parameters of 0 give the identity map in both families. These
are the plain versions of the spline math that the CUDA kernels in
``csrc/rqs.cuh`` carry out per element.
"""

from __future__ import annotations

import math

import torch

LOG_SCALE_BOUND = 5.0
SPLINE_BOUND = 5.0
MIN_BIN = 1e-3
MIN_DERIV = 1e-3
# shift such that MIN_DERIV + softplus(0 + shift) == 1 exactly (identity init)
_SOFTPLUS_INV_1 = math.log(math.exp(1.0 - MIN_DERIV) - 1.0)

AFFINE_N_PARAMS = 2


def softplus(x):
    """log(1 + exp(x)) with no linear cut-over (``jax.nn.softplus``;
    ``torch.nn.functional.softplus`` switches to x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def affine_forward(x, params):
    """x -> z (data -> latent). params: (..., 2) = [loc, raw_scale]."""
    loc = params[..., 0]
    log_s = LOG_SCALE_BOUND * torch.tanh(params[..., 1] / LOG_SCALE_BOUND)
    return (x - loc) * torch.exp(-log_s), -log_s


def affine_inverse(z, params):
    """z -> x. Returns (x, ladj) with ladj elementwise log|dx/dz|."""
    loc = params[..., 0]
    log_s = LOG_SCALE_BOUND * torch.tanh(params[..., 1] / LOG_SCALE_BOUND)
    return z * torch.exp(log_s) + loc, log_s


def rqs_n_params(bins: int) -> int:
    return 3 * bins - 1


def _knots(raw):
    """Softmax bin sizes -> knot positions on [-B, B], last knot exactly B."""
    B = SPLINE_BOUND
    bins = raw.shape[-1]
    sizes = (MIN_BIN + (1 - MIN_BIN * bins) * torch.softmax(raw, dim=-1)) * (2 * B)
    k = torch.cat([torch.full_like(sizes[..., :1], -B),
                   torch.cumsum(sizes, dim=-1) - B], dim=-1)
    return torch.cat([k[..., :-1], torch.full_like(k[..., :1], B)], dim=-1)


def _rqs_setup(params, bins: int):
    """Raw params (..., 3*bins-1) -> knot positions and derivatives."""
    xk = _knots(params[..., :bins])
    yk = _knots(params[..., bins:2 * bins])
    inner = MIN_DERIV + softplus(params[..., 2 * bins:] + _SOFTPLUS_INV_1)
    ones = torch.ones_like(inner[..., :1])
    return xk, yk, torch.cat([ones, inner, ones], dim=-1)


def _gather_bin(pos, knots, bins, *arrays):
    """Values at the bin index (and index+1) containing pos, for each array.
    The index is the count of interior knots <= pos, clipped to the bins."""
    idx = torch.clamp((pos[..., None] >= knots[..., 1:-1]).sum(-1), 0, bins - 1)
    i0 = idx[..., None]
    i1 = i0 + 1
    out = []
    for a in arrays:
        out.append(torch.gather(a, -1, i0)[..., 0])
        out.append(torch.gather(a, -1, i1)[..., 0])
    return out


def rqs_forward(x, params, bins: int):
    """x -> y with ladj = log|dy/dx| elementwise; identity outside [-B, B]."""
    B = SPLINE_BOUND
    xk, yk, deriv = _rqs_setup(params, bins)
    inside = (x > -B) & (x < B)
    xc = torch.clamp(x, -B + 1e-6, B - 1e-6)
    x0, x1, y0, y1, d0, d1 = _gather_bin(xc, xk, bins, xk, yk, deriv)

    w = x1 - x0
    h = y1 - y0
    s = h / w
    xi = (xc - x0) / w
    xi1m = 1 - xi
    denom = s + (d1 + d0 - 2 * s) * xi * xi1m
    y = y0 + h * (s * xi * xi + d0 * xi * xi1m) / denom
    dydx = s * s * (d1 * xi * xi + 2 * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom)

    y = torch.where(inside, y, x)
    ladj = torch.where(inside, torch.log(dydx), torch.zeros_like(dydx))
    return y, ladj


def rqs_inverse(y, params, bins: int):
    """y -> x with ladj = log|dx/dy| elementwise; identity outside [-B, B].
    The bin-local quadratic uses the stable root 2c / (-b - sqrt(disc))."""
    B = SPLINE_BOUND
    xk, yk, deriv = _rqs_setup(params, bins)
    inside = (y > -B) & (y < B)
    yc = torch.clamp(y, -B + 1e-6, B - 1e-6)
    x0, x1, y0, y1, d0, d1 = _gather_bin(yc, yk, bins, xk, yk, deriv)

    w = x1 - x0
    h = y1 - y0
    s = h / w
    dy = yc - y0
    t = d1 + d0 - 2 * s
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    xi = torch.clamp(2 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
    x = x0 + xi * w

    xi1m = 1 - xi
    denom = s + t * xi * xi1m
    dydx = s * s * (d1 * xi * xi + 2 * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom)

    x = torch.where(inside, x, y)
    ladj = torch.where(inside, -torch.log(dydx), torch.zeros_like(dydx))
    return x, ladj
