"""Phase B's training step, plain: the MADE spline stack's weighted negative
log-likelihood, its gradient by autograd, the global-norm clip and AdamW,
at a precision of ``reference.precision``.

The masks are built here from the published MADE construction (Germain et
al. 2015) as the port's flows stack it: transform t takes the dimensions in
the order 0..d-1 when t is even and d-1..0 when odd; hidden units cycle
through the degrees 1..max(1, d-1); a hidden unit sees the units below of
degree at most its own, an output of dimension k the hidden units of degree
below k's. The loss is the flow's (``loss_scale`` x the weighted mean of
-log q over the batch, without the pre-layer's constant); the clip
scales the gradient to a global norm of at most ``clip_grad_norm``; AdamW
(Loshchilov & Hutter 2019) decays the weights, then steps by the
bias-corrected moments. The hyperparameters come from the configuration.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import flows
from .precision import cast


def made_masks(n_dim, hidden, n_params, n_transforms, device):
    """The masks of each layer, stacked over the transforms: (T, fan_in,
    fan_out) of 0 and 1."""
    layers = [[] for _ in range(len(hidden) + 1)]
    max_deg = max(1, n_dim - 1)
    for t in range(n_transforms):
        order = torch.arange(n_dim) if t % 2 == 0 else torch.arange(n_dim - 1, -1, -1)
        degs = [order + 1] + [torch.arange(h) % max_deg + 1 for h in hidden]
        for l in range(1, len(degs)):
            layers[l - 1].append(degs[l - 1][:, None] <= degs[l][None, :])
        out_deg = torch.repeat_interleave(degs[0], n_params)
        layers[-1].append(degs[-1][:, None] < out_deg[None, :])
    return [torch.stack(m).to(device=device, dtype=torch.float64) for m in layers]


def _loss(ws, bs, masks, x, w, bins, prec, scale):
    """(loss, z, ladj) of the batch x with row weights w."""
    masked = [p * m.to(p.dtype) for p, m in zip(ws, masks)]
    z, ladj = flows.made_forward(x, masked, bs, bins, prec)
    d = z.shape[1]
    logq = -0.5 * (z * z).sum(-1) - 0.5 * d * math.log(2 * math.pi) + ladj
    wc = cast(w, prec)
    return (-logq * wc * scale).sum() / torch.clamp(wc.sum(), min=1e-30), z, ladj


def replay(before, batches, tcfg, bins, prec="float64", steps=3, half=False):
    """The first ``steps`` optimizer steps of a fit from the parameters
    ``before`` (weights, then biases, as the flow holds them) on
    ``batches`` [(x, w)], at ``prec``; with ``half`` each batch's second
    half left out (the loss the mean over the rest). Returns the loss of
    each step, the first step's z and log-det, its gradient before the
    clip, and the parameters after the last step."""
    n_w = len(before) // 2
    hidden = [int(w.shape[-1]) for w in before[:n_w - 1]]
    n_dim = int(before[0].shape[-2])
    masks = made_masks(n_dim, hidden, int(before[n_w - 1].shape[-1]) // n_dim,
                       int(before[0].shape[0]), before[0].device)
    params = [cast(p.detach(), prec).clone().requires_grad_(True) for p in before]
    lr, (b1, b2) = float(tcfg["learning_rate"]), [float(b) for b in tcfg["betas"]]
    eps, decay = float(tcfg["eps"]), float(tcfg["weight_decay"])
    max_norm, scale = float(tcfg["clip_grad_norm"]), float(tcfg["loss_scale"])
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]
    out = dict(loss=[])
    for k, (x, w) in enumerate(batches[:steps], start=1):
        if half:
            x, w = x[: x.shape[0] // 2], w[: w.shape[0] // 2]
        loss, z, ladj = _loss(params[:n_w], params[n_w:], masks, x, w, bins, prec, scale)
        grads = torch.autograd.grad(loss, params)
        out["loss"].append(float(loss.detach()))
        if k == 1:
            out["z"], out["ladj"] = z.detach(), ladj.detach()
            out["grad"] = [g.detach() for g in grads]
        total = torch.sqrt(sum((g * g).sum() for g in grads))
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        with torch.no_grad():
            for p, g, a, v in zip(params, grads, m1, m2):
                g = g * coef
                p.mul_(1.0 - lr * decay)
                a.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                denom = v.sqrt() / math.sqrt(1.0 - b2 ** k) + eps
                p.sub_(lr / (1.0 - b1 ** k) * a / denom)
    out["after"] = [p.detach() for p in params]
    return out


def leaf_gap(got, ref, keep=None):
    """The worst leaf's gap between the norms of ``got`` and ``ref`` (not
    the norm of their difference), over the larger of the reference's norm
    of that leaf and of the median leaf; only the leaves ``keep`` marks."""
    ng = [float(g.detach().to(torch.float64).norm()) for g in got]
    nr = [float(r.detach().to(torch.float64).norm()) for r in ref]
    med = statistics.median(nr)
    keep = [True] * len(nr) if keep is None else keep
    gaps = [abs(a - b) / max(b, med) if max(b, med) > 0 else (0.0 if a == 0 else math.inf)
            for a, b, k in zip(ng, nr, keep) if k]
    gaps = [math.inf if math.isnan(g) else g for g in gaps]
    return max(gaps) if gaps else 0.0


def moved(grads, floor=1e-3):
    """The leaves whose gradient's norm is at least ``floor`` of the median
    leaf's: the others move under AdamW by round-off alone."""
    n = [float(g.to(torch.float64).norm()) for g in grads]
    med = statistics.median(n)
    return [v >= floor * med for v in n]
