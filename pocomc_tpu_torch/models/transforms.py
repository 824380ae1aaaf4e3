"""Univariate monotone transforms for autoregressive flows (torch).

Counterpart of ``pocomc_tpu/models/transforms.py``: the monotonic affine
map and the rational-quadratic spline (RQS) of any bins on [-B, B] with identity
tails. Raw parameters of 0 give the identity map in both families. These
are the plain versions of the element math that the CUDA kernels carry
out per element (``csrc/rqs.cuh``, ``csrc/heads.cuh``).
"""

from __future__ import annotations

import math

import numpy as np
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


def affine_forward_vjp(x, params, g_z, g_l):
    """Closed-form vector-Jacobian product of ``affine_forward``: (g_x,
    g_params) given g_z = dL/dz and g_l = dL/dladj. With t = tanh(raw / B),
    s = B t: dz/dx = e^-s, dz/dloc = -e^-s, dz/ds = -z, dladj/ds = -1 and
    ds/draw = 1 - t^2 (autograd's tanh derivative). ``csrc/heads.cuh``
    ``AffineHead::forward_vjp`` is the same arithmetic for one element."""
    t = torch.tanh(params[..., 1] / LOG_SCALE_BOUND)
    e = torch.exp(-(LOG_SCALE_BOUND * t))
    z = (x - params[..., 0]) * e
    g_x = g_z * e
    g_raw = (-(g_z * z) - g_l) * (1 - t * t)
    return g_x, torch.stack([-g_x, g_raw], dim=-1)


def affine_inverse(z, params):
    """z -> x. Returns (x, ladj) with ladj elementwise log|dx/dz|."""
    loc = params[..., 0]
    log_s = LOG_SCALE_BOUND * torch.tanh(params[..., 1] / LOG_SCALE_BOUND)
    return z * torch.exp(log_s) + loc, log_s


def rqs_n_params(bins: int) -> int:
    return 3 * bins - 1


# past this many bins (``flow_kernels.FIXED_BINS``, where the CUDA kernels
# take their library of run-time bins) the knots are compensated running
# sums, the method of that library (``csrc/rqs.cuh`` ``find_bin``): each
# bin's width and height the size the sum added, each knot with what its
# fp32 sum left over. A plain fp32 sum's rounding grows with the bins, and
# a width taken as a difference of two rounded knots put a 64-bin d=10
# log-det 1.2e-4 from float64, past the parity tests' 1e-4
# (``tools/spline_parity.py``)
COMPENSATED_PAST = 16


def _sizes(raw):
    """Softmax bin sizes on [-B, B]: (..., bins), summing to 2B."""
    bins = raw.shape[-1]
    return (MIN_BIN + (1 - MIN_BIN * bins) * torch.softmax(raw, dim=-1)) * (2 * SPLINE_BOUND)


def _running_sums(sizes):
    """The running sums of the bin sizes, k ascending, as ``csrc/rqs.cuh``
    ``find_bin`` takes them: the knots k (..., bins+1), the first -B and
    the last exactly B, each interior one its running sum s less B; and
    what each sum left over, c (the sum is s - c; 0 at either end). In
    float32, s and c are the kernels' Kahan sums in their order, so that
    the plain version and the kernels agree on the method (a sum taken more
    exactly here would hold the kernels to a reference more exact than
    their method); the gradient is the running sum's, which the
    compensation does not change. In float64 (the references) a plain
    running sum, c = 0."""
    B = SPLINE_BOUND
    inner = sizes[..., :-1]
    s = torch.cumsum(inner, -1)
    c = torch.zeros_like(s)
    if sizes.dtype != torch.float64:
        # the sequential loop runs in numpy on the host, bins first: a loop
        # of small device ops is bound by their launches (at 1000 bins it
        # made the card's plain autoregressive inverse ~5x slower). Inside
        # a CUDA graph capture, which cannot copy to the host, it runs on
        # the device. The same IEEE operations either way, so the same bits.
        # The sizes are transposed where they lie, so that only contiguous
        # blocks cross to the host and back (a transposing copy on the host
        # took longer than the loop itself at 1000 bins).
        host = not (inner.is_cuda and torch.cuda.is_current_stream_capturing())
        v = inner.detach().movedim(-1, 0).contiguous()
        xp, sub = (np, np.subtract) if host else (torch, torch.sub)
        v = v.cpu().numpy() if host else v
        kahan, c = xp.empty_like(v), xp.empty_like(v)
        acc, comp, y = xp.zeros_like(v[0]), xp.zeros_like(v[0]), xp.empty_like(v[0])
        for j in range(v.shape[0]):
            sub(v[j], comp, out=y)
            xp.add(acc, y, out=kahan[j])
            sub(kahan[j], acc, out=comp)
            sub(comp, y, out=comp)
            acc = kahan[j]
            c[j] = comp
        if host:
            kahan, c = (torch.from_numpy(a).to(inner.device) for a in (kahan, c))
        kahan, c = kahan.movedim(0, -1), c.movedim(0, -1)
        # s + (kahan - s) is the Kahan sum exactly (two close positive
        # numbers differ exactly) with the running sum's gradient
        s = s + (kahan - s).detach()
    ends = torch.full_like(sizes[..., :1], B)
    zero = torch.zeros_like(ends)
    return torch.cat([-ends, s - B, ends], -1), torch.cat([zero, c, zero], -1)


def _knots(raw):
    """Softmax bin sizes -> knot positions on [-B, B], last knot exactly B
    (past ``COMPENSATED_PAST`` bins the compensated sums, each rounded once)."""
    B = SPLINE_BOUND
    sizes = _sizes(raw)
    if raw.shape[-1] > COMPENSATED_PAST:
        k, c = _running_sums(sizes)
        return k - c
    k = torch.cat([torch.full_like(sizes[..., :1], -B),
                   torch.cumsum(sizes, dim=-1) - B], dim=-1)
    return torch.cat([k[..., :-1], torch.full_like(k[..., :1], B)], dim=-1)


def _derivs(params, bins):
    """The bins + 1 knot derivatives, 1 at either end."""
    inner = MIN_DERIV + softplus(params[..., 2 * bins:] + _SOFTPLUS_INV_1)
    ones = torch.ones_like(inner[..., :1])
    return torch.cat([ones, inner, ones], dim=-1)


def _rqs_setup(params, bins: int):
    """Raw params (..., 3*bins-1) -> knot positions and derivatives."""
    return _knots(params[..., :bins]), _knots(params[..., bins:2 * bins]), _derivs(params, bins)


def _bin_index(pos, knots, bins):
    """(..., 1) index of the bin containing pos: the count of interior knots
    <= pos, clipped to the bins."""
    return torch.clamp((pos[..., None] >= knots[..., 1:-1]).sum(-1), 0, bins - 1)[..., None]


def _gather_at(i0, *arrays):
    """Values at index i0 and i0+1 of each array."""
    out = []
    for a in arrays:
        out.append(torch.gather(a, -1, i0)[..., 0])
        out.append(torch.gather(a, -1, i0 + 1)[..., 0])
    return out


def _bin(pos, params, bins, by_y):
    """The bin that holds pos among the x-knots (by_y False: the forward) or
    the y-knots (the inverse): (i0 (..., 1), its lower knots x0 and y0, pos
    less the lower knot it was found by, its width w and height h, the
    derivatives d0 and d1). Up to ``COMPENSATED_PAST`` bins w and h are
    differences of knots; past it, as ``csrc/rqs.cuh`` ``find_bin``, the
    knots are compensated running sums, w and h the sizes the sums added
    (the last bin's the rest up to B), and the lower knots and pos less the
    knot carry each sum's leftover."""
    deriv = _derivs(params, bins)
    if bins <= COMPENSATED_PAST:
        xk, yk = _knots(params[..., :bins]), _knots(params[..., bins:2 * bins])
        i0 = _bin_index(pos, yk if by_y else xk, bins)
        x0, x1, y0, y1, d0, d1 = _gather_at(i0, xk, yk, deriv)
        return i0, x0, y0, pos - (y0 if by_y else x0), x1 - x0, y1 - y0, d0, d1
    B = SPLINE_BOUND
    # both softmaxes' sizes and running sums at once
    sizes = _sizes(torch.stack([params[..., :bins], params[..., bins:2 * bins]]))
    (xk, yk), (cx, cy) = _running_sums(sizes)
    sx, sy = sizes
    i0 = _bin_index(pos, yk if by_y else xk, bins)
    at = lambda a: torch.gather(a, -1, i0)[..., 0]
    x0, y0, cx0, cy0 = at(xk), at(yk), at(cx), at(cy)
    last = i0[..., 0] == bins - 1
    w = torch.where(last, (B - x0) + cx0, at(sx))
    h = torch.where(last, (B - y0) + cy0, at(sy))
    dpos = (pos - y0) + cy0 if by_y else (pos - x0) + cx0
    d0, d1 = _gather_at(i0, deriv)
    return i0, x0 - cx0, y0 - cy0, dpos, w, h, d0, d1


def rqs_forward(x, params, bins: int):
    """x -> y with ladj = log|dy/dx| elementwise; identity outside [-B, B]."""
    B = SPLINE_BOUND
    inside = (x > -B) & (x < B)
    xc = torch.clamp(x, -B + 1e-6, B - 1e-6)
    _, _, y0, dx, w, h, d0, d1 = _bin(xc, params, bins, False)

    s = h / w
    xi = dx / w
    xi1m = 1 - xi
    denom = s + (d1 + d0 - 2 * s) * xi * xi1m
    y = y0 + h * (s * xi * xi + d0 * xi * xi1m) / denom
    dydx = s * s * (d1 * xi * xi + 2 * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom)

    y = torch.where(inside, y, x)
    ladj = torch.where(inside, torch.log(dydx), torch.zeros_like(dydx))
    return y, ladj


def rqs_forward_vjp(x, params, g_y, g_l, bins: int):
    """Closed-form vector-Jacobian product of ``rqs_forward``, with no
    autograd: the gradients (g_x, g_params) given g_y = dL/dy and g_l =
    dL/dladj, elementwise over x (...) and params (..., 3*bins-1).

    It keeps the conventions of autograd through ``rqs_forward``: the last
    knot is the constant B, so it passes nothing into the running sum;
    ``clamp`` passes the gradient for x in [-B+1e-6, B-1e-6] inclusive; the
    bin index is piecewise constant; outside (-B, B) g_x = g_y and the
    parameter gradients are 0. ``csrc/rqs.cuh`` ``rqs_forward_vjp`` is the
    same arithmetic for one element."""
    B = SPLINE_BOUND
    raw_x, raw_y, raw_d = params[..., :bins], params[..., bins:2 * bins], params[..., 2 * bins:]
    sm_x, sm_y = torch.softmax(raw_x, dim=-1), torch.softmax(raw_y, dim=-1)
    inside = (x > -B) & (x < B)
    lo, hi = -B + 1e-6, B - 1e-6
    xc = torch.clamp(x, lo, hi)
    i0, _, _, dx, w, h, d0, d1 = _bin(xc, params, bins, False)

    s = h / w
    xi = dx / w
    xi1m = 1 - xi
    c = d1 + d0 - 2 * s
    q = xi * xi1m
    denom = s + c * q
    num = s * xi * xi + d0 * q
    n2 = d1 * xi * xi + 2 * s * q + d0 * xi1m * xi1m
    g_yi = torch.where(inside, g_y, torch.zeros_like(g_y))
    g_l = torch.where(inside, g_l, torch.zeros_like(g_l))

    # ladj = 2 log s + log n2 - 2 log denom; y = y0 + h * num / denom
    g_s = 2 * g_l / s
    g_n2 = g_l / n2
    g_den = -2 * g_l / denom - g_yi * h * num / (denom * denom)
    g_y0 = g_yi
    g_h = g_yi * num / denom
    g_num = g_yi * h / denom
    g_d1 = g_n2 * xi * xi
    g_xi = g_n2 * 2 * d1 * xi + g_num * 2 * s * xi
    g_s = g_s + g_n2 * 2 * q + g_num * xi * xi + g_den
    g_q = g_n2 * 2 * s + g_num * d0 + g_den * c
    g_d0 = g_n2 * xi1m * xi1m + g_num * q
    g_xi1m = g_n2 * 2 * d0 * xi1m
    g_c = g_den * q
    g_d1 = g_d1 + g_c
    g_d0 = g_d0 + g_c
    g_s = g_s - 2 * g_c
    g_xi = g_xi + g_q * xi1m
    g_xi1m = g_xi1m + g_q * xi
    g_xi = g_xi - g_xi1m
    g_xc = g_xi / w
    g_x0 = -g_xi / w
    g_w = -g_xi * xi / w
    g_h = g_h + g_s / w
    g_w = g_w - g_s * s / w
    g_y1 = g_h
    g_y0 = g_y0 - g_h
    g_x1 = g_w
    g_x0 = g_x0 - g_w

    def knots_vjp(g_k0, g_k1, sm):
        # knot j (1..bins-1) is the running sum of bin sizes 0..j-1, minus B
        g_k = torch.zeros(sm.shape[:-1] + (bins + 1,), dtype=sm.dtype, device=sm.device)
        g_k = g_k.scatter_add(-1, i0, g_k0[..., None]).scatter_add(-1, i0 + 1, g_k1[..., None])
        g_inner = g_k[..., 1:bins]
        g_size = torch.cat([torch.flip(torch.cumsum(torch.flip(g_inner, [-1]), -1), [-1]),
                            torch.zeros_like(g_k[..., :1])], dim=-1)
        g_sm = g_size * ((1 - MIN_BIN * bins) * 2 * B)
        return sm * (g_sm - (sm * g_sm).sum(-1, keepdim=True))

    g_dv = torch.zeros(raw_d.shape[:-1] + (bins + 1,), dtype=raw_d.dtype, device=raw_d.device)
    g_dv = g_dv.scatter_add(-1, i0, g_d0[..., None]).scatter_add(-1, i0 + 1, g_d1[..., None])
    g_raw_d = g_dv[..., 1:bins] * torch.sigmoid(raw_d + _SOFTPLUS_INV_1)
    g_params = torch.cat([knots_vjp(g_x0, g_x1, sm_x), knots_vjp(g_y0, g_y1, sm_y),
                          g_raw_d], dim=-1)
    g_params = torch.where(inside[..., None], g_params, torch.zeros_like(g_params))
    in_clamp = (x >= lo) & (x <= hi)
    g_x = torch.where(inside, torch.where(in_clamp, g_xc, torch.zeros_like(g_xc)), g_y)
    return g_x, g_params


def rqs_inverse(y, params, bins: int):
    """y -> x with ladj = log|dx/dy| elementwise; identity outside [-B, B].
    The bin-local quadratic uses the stable root 2c / (-b - sqrt(disc))."""
    B = SPLINE_BOUND
    inside = (y > -B) & (y < B)
    yc = torch.clamp(y, -B + 1e-6, B - 1e-6)
    _, x0, _, dy, w, h, d0, d1 = _bin(yc, params, bins, True)

    s = h / w
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
