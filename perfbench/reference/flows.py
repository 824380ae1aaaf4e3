"""Plain copies of the flows the port runs: the rational-quadratic spline,
the MADE stack (K2's forward, K1's autoregressive inverse) and the
coupling stack (K5's forward and inverse).

Frozen from the published definitions the port follows: splines of
Durkan et al. 2019 on [-B, B] with identity tails, MADE of Germain et al.
2015 with residual hidden layers, RealNVP-style coupling over alternating
halves. They take the weights as the kernels take them (the MADE weights
already multiplied by their masks, the layers stacked over transforms) and
compute at a precision of ``reference.precision``.
"""

from __future__ import annotations

import math

import torch

from .precision import cast, mm

SPLINE_BOUND = 5.0
MIN_BIN = 1e-3
MIN_DERIV = 1e-3
# MIN_DERIV + softplus(0 + shift) == 1: raw parameters of 0 give the identity
SOFTPLUS_SHIFT = math.log(math.exp(1.0 - MIN_DERIV) - 1.0)


def n_params(bins: int) -> int:
    """Raw spline parameters a dimension: bins widths, bins heights and
    bins - 1 interior derivatives."""
    return 3 * bins - 1


def _knots(raw):
    """Softmax bin sizes on [-B, B] as knots (..., bins + 1), first -B and
    last exactly B."""
    bins = raw.shape[-1]
    sizes = (MIN_BIN + (1 - MIN_BIN * bins) * torch.softmax(raw, dim=-1)) * (2 * SPLINE_BOUND)
    inner = torch.cumsum(sizes[..., :-1], dim=-1) - SPLINE_BOUND
    ends = torch.full_like(sizes[..., :1], SPLINE_BOUND)
    return torch.cat([-ends, inner, ends], dim=-1)


def _derivs(p, bins):
    inner = MIN_DERIV + torch.logaddexp(p[..., 2 * bins:] + SOFTPLUS_SHIFT,
                                        torch.zeros_like(p[..., 2 * bins:]))
    ones = torch.ones_like(inner[..., :1])
    return torch.cat([ones, inner, ones], dim=-1)


def _bin(pos, p, bins, by_y):
    """(x0, y0, pos - lower knot, width, height, d0, d1) of the bin that
    holds pos among the x knots (forward) or the y knots (inverse)."""
    xk, yk = _knots(p[..., :bins]), _knots(p[..., bins:2 * bins])
    dv = _derivs(p, bins)
    k = yk if by_y else xk
    i0 = torch.clamp((pos[..., None] >= k[..., 1:-1]).sum(-1), 0, bins - 1)[..., None]
    at = lambda a, o: torch.gather(a, -1, i0 + o)[..., 0]
    x0, x1, y0, y1, d0, d1 = at(xk, 0), at(xk, 1), at(yk, 0), at(yk, 1), at(dv, 0), at(dv, 1)
    return x0, y0, pos - (y0 if by_y else x0), x1 - x0, y1 - y0, d0, d1


def rqs_forward(x, p, bins):
    """x -> (y, log|dy/dx|) elementwise; identity outside (-B, B)."""
    B = SPLINE_BOUND
    inside = (x > -B) & (x < B)
    xc = torch.clamp(x, -B + 1e-6, B - 1e-6)
    _, y0, dx, w, h, d0, d1 = _bin(xc, p, bins, False)
    s = h / w
    xi = dx / w
    xi1m = 1 - xi
    denom = s + (d1 + d0 - 2 * s) * xi * xi1m
    y = y0 + h * (s * xi * xi + d0 * xi * xi1m) / denom
    dydx = s * s * (d1 * xi * xi + 2 * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom)
    return (torch.where(inside, y, x),
            torch.where(inside, torch.log(dydx), torch.zeros_like(dydx)))


def rqs_inverse(y, p, bins):
    """y -> (x, log|dx/dy|) elementwise; identity outside (-B, B)."""
    B = SPLINE_BOUND
    inside = (y > -B) & (y < B)
    yc = torch.clamp(y, -B + 1e-6, B - 1e-6)
    x0, _, dy, w, h, d0, d1 = _bin(yc, p, bins, True)
    s = h / w
    t = d1 + d0 - 2 * s
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    xi = torch.clamp(2 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
    xi1m = 1 - xi
    denom = s + t * xi * xi1m
    dydx = s * s * (d1 * xi * xi + 2 * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom)
    return (torch.where(inside, x0 + xi * w, y),
            torch.where(inside, -torch.log(dydx), torch.zeros_like(dydx)))


def _hidden(ws, bs, x, prec):
    """relu of the last hidden layer of a residual MLP: h0 = x W0 + b0,
    h_l = h_{l-1} + relu(h_{l-1}) W_l + b_l for the square layers."""
    h = mm(x, ws[0], prec) + bs[0]
    for l in range(1, len(ws) - 1):
        y = mm(torch.relu(h), ws[l], prec) + bs[l]
        h = h + y if ws[l].shape[0] == ws[l].shape[1] else y
    return torch.relu(h)


def made_forward(y, ws, bs, bins=8, prec="float64"):
    """The MADE spline stack data -> latent: (z, ladj). ``ws[l]`` (T,
    fan_in, fan_out) masked weights, ``bs[l]`` (T, fan_out)."""
    ws, bs = [cast(w, prec) for w in ws], [cast(b, prec) for b in bs]
    x = cast(y, prec)
    n, d = x.shape
    ladj = torch.zeros(n, dtype=x.dtype, device=x.device)
    for t in range(ws[0].shape[0]):
        wt, bt = [w[t] for w in ws], [b[t] for b in bs]
        p = (mm(_hidden(wt, bt, x, prec), wt[-1], prec) + bt[-1]).reshape(n, d, n_params(bins))
        x, l = rqs_forward(x, p, bins)
        ladj = ladj + l.sum(-1)
    return x, ladj


def made_inverse(z, ws, bs, inv_orders, bins=8, prec="float64"):
    """The MADE spline stack latent -> data, autoregressively: transforms
    in reverse, the dimensions of transform t in the order
    ``inv_orders[t]``, each from a pass over the dimensions set so far:
    (x, ladj)."""
    ws, bs = [cast(w, prec) for w in ws], [cast(b, prec) for b in bs]
    z = cast(z, prec)
    n, d = z.shape
    npar = n_params(bins)
    orders = torch.as_tensor(inv_orders).tolist()
    ladj = torch.zeros(n, dtype=z.dtype, device=z.device)
    for t in reversed(range(ws[0].shape[0])):
        wt, bt = [w[t] for w in ws], [b[t] for b in bs]
        x = torch.zeros_like(z)
        for dim in orders[t]:
            cols = slice(dim * npar, (dim + 1) * npar)
            p = mm(_hidden(wt, bt, x, prec), wt[-1][:, cols], prec) + bt[-1][cols]
            xd, l = rqs_inverse(z[:, dim], p, bins)
            x = x.clone()
            x[:, dim] = xd
            ladj = ladj + l
        z = x
    return z, ladj


def _coupling(ws, bs, masks, x, prec, bins, inverse):
    ws = [[cast(w, prec) for w in wt] for wt in ws]
    bs = [[cast(b, prec) for b in bt] for bt in bs]
    x = cast(x, prec)
    n = x.shape[0]
    ladj = torch.zeros(n, dtype=x.dtype, device=x.device)
    order = reversed(range(len(ws))) if inverse else range(len(ws))
    element = rqs_inverse if inverse else rqs_forward
    for t in order:
        m = torch.as_tensor(masks[t], dtype=torch.bool, device=x.device)
        cond, trans = torch.nonzero(m)[:, 0], torch.nonzero(~m)[:, 0]
        h = _hidden(ws[t], bs[t], x[:, cond], prec)
        p = (mm(h, ws[t][-1], prec) + bs[t][-1]).reshape(n, trans.numel(), n_params(bins))
        xt, l = element(x[:, trans], p, bins)
        x = x.clone()
        x[:, trans] = xt
        ladj = ladj + l.sum(-1)
    return x, ladj


def coupling_forward(x, ws, bs, masks, bins=8, prec="float64"):
    """The coupling spline stack data -> latent: (z, ladj). ``ws[t]``,
    ``bs[t]`` the four weights and biases of transform t, ``masks[t]`` its
    boolean conditioning mask."""
    return _coupling(ws, bs, masks, x, prec, bins, False)


def coupling_inverse(z, ws, bs, masks, bins=8, prec="float64"):
    """The coupling spline stack latent -> data, transforms in reverse:
    (x, ladj)."""
    return _coupling(ws, bs, masks, z, prec, bins, True)

