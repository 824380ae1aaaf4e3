"""The comparisons that decide ``correct``: each reads what the timed path
produced (captured by ``hooks``), recomputes it with the plain reference
in float64, and returns the gap; ``prec`` below float64 gives the
control's reading instead (the reference at that precision in the
program's place). Each number has a limit of its own (``limits/<cell>.json``).
"""

from __future__ import annotations

import math

import torch

from . import flows, smc, train
from .precision import cast
from .problems import log_prior

F64 = "float64"


def precisions(control=False):
    """(the flow's, the rest's) precision of a reading: float64 for the
    program's reading (its outputs against the float64 reference); for the
    control's, the step below the configuration's float32 that would tempt
    a later change: TF32 products for the flows, whose work is products,
    and bfloat16 for the weights, the likelihood, the prior and the accept
    step, which have none worth the name."""
    return ("tf32", "bfloat16") if control else (F64, F64)


def gap(got, ref):
    """max |got - ref| / (1 + |ref|) over the finite entries of ref (a
    non-finite got where ref is finite, or a got of another shape, counts
    as infinite)."""
    got, ref = got.detach().to(torch.float64), ref.detach().to(torch.float64)
    if got.shape != ref.shape:
        return math.inf
    ok = torch.isfinite(ref)
    if not bool(ok.any()):
        return 0.0
    g = ((got - ref).abs() / (1.0 + ref.abs()))[ok]
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
    return float(g.max())


def _blocks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def phase_a(captures, bias_budget, n_bisect, prec=F64):
    """(beta_gap, weight_gap) over the window's iterations: phase A's
    temperature against the reference's from the same history, and its
    trimmed weights against the reference's at that temperature on the
    rows it kept."""
    beta_gap, weight_gap = 0.0, 0.0
    for c in captures:
        h, t = c["hist"], c["t"]
        ref_beta, _ = smc.next_beta(h.logl, h.beta, h.logz, t, float(c["n_eff"]),
                                    float(c["resid"]), bias_budget, n_bisect, F64)
        beta_p = float(c["beta"])
        if prec == F64:
            got_beta = beta_p
        else:
            got_beta = float(smc.next_beta(h.logl, h.beta, h.logz, t, float(c["n_eff"]),
                                           float(c["resid"]), bias_budget, n_bisect, prec)[0])
        beta_gap = max(beta_gap, abs(got_beta - float(ref_beta)))
        w_ref = smc.weights_at(h.logl, h.beta, h.logz, t, beta_p, F64)
        w_p = c["w_flat"].to(torch.float64)
        kept = w_p > 0
        w_ref = torch.where(kept, w_ref, torch.zeros_like(w_ref))
        w_ref = w_ref / w_ref.sum()
        if prec != F64:
            w_c = smc.weights_at(h.logl, h.beta, h.logz, t, beta_p, prec).to(torch.float64)
            w_c = torch.where(kept, w_c, torch.zeros_like(w_c))
            w_p = w_c / w_c.sum()
        weight_gap = max(weight_gap, float((w_p - w_ref).abs().max() / w_ref.max()))
    return beta_gap, weight_gap


def made_forward(last, prec=F64, block=16384):
    """(z gap, ladj gap) of K2's last call against the plain stack."""
    y, (z, ladj) = last["y"], last["out"]
    gz, gl = 0.0, 0.0
    for s in _blocks(y.shape[0], block):
        zr, lr = flows.made_forward(y[s], last["ws"], last["bs"], last["bins"], F64)
        if prec != F64:
            zc, lc = flows.made_forward(y[s], last["ws"], last["bs"], last["bins"], prec)
        else:
            zc, lc = z[s], ladj[s]
        gz, gl = max(gz, gap(zc, zr)), max(gl, gap(lc, lr))
    return gz, gl


def made_inverse(last, prec=F64, block=4096):
    """(x gap, ladj gap) of K1's last call against the plain inverse."""
    z, (x, ladj) = last["z"], last["out"]
    gx, gl = 0.0, 0.0
    for s in _blocks(z.shape[0], block):
        xr, lr = flows.made_inverse(z[s], last["ws"], last["bs"], last["inv_orders"],
                                    last["bins"], F64)
        if prec != F64:
            xc, lc = flows.made_inverse(z[s], last["ws"], last["bs"], last["inv_orders"],
                                        last["bins"], prec)
        else:
            xc, lc = x[s], ladj[s]
        gx, gl = max(gx, gap(xc, xr)), max(gl, gap(lc, lr))
    return gx, gl


def coupling_inverse(last, prec=F64, block=16384):
    """(x gap, ladj gap) of K5's inverse's last call against the plain
    coupling inverse."""
    z, (x, ladj) = last["z"], last["out"]
    gx, gl = 0.0, 0.0
    for s in _blocks(z.shape[0], block):
        xr, lr = flows.coupling_inverse(z[s], last["ws"], last["bs"], last["masks"],
                                        last["bins"], F64)
        if prec != F64:
            xc, lc = flows.coupling_inverse(z[s], last["ws"], last["bs"], last["masks"],
                                            last["bins"], prec)
        else:
            xc, lc = x[s], ladj[s]
        gx, gl = max(gx, gap(xc, xr)), max(gl, gap(lc, lr))
    return gx, gl


def training(fit, tcfg, bins, prec=F64, half=False):
    """(loss_gap, grad_gap, change_gap, z_gap, ladj_gap) of the last fit's
    first optimizer steps (``hooks.TRAIN_STEPS``), against the plain step
    replayed in float64 from the parameters the fit started from, on the
    same batches: the first step's loss (the later steps' differ by the
    trajectories' own drift: AdamW's first step moves every element by the
    learning rate whatever its gradient's size, so an element whose
    gradient is nought to rounding moves either way); the first gradient
    before the clip and the parameters' change after the steps, each by
    its worst leaf
    (``train.leaf_gap``; the change over the leaves ``train.moved`` keeps);
    K2's z and log-det in the first step. The reading compared is the
    program's, or with ``prec`` below float64 the control's, or with
    ``half`` that of the step on half of each batch (the first three
    numbers only)."""
    if fit is None or any(fit[k] is None for k in ("grads", "after", "k2")):
        return (math.inf,) * (3 if half else 5)
    batches = [(s["x"], s["w"]) for s in fit["steps"]]
    steps = len(batches)
    ref = train.replay(fit["before"], batches, tcfg, bins, F64, steps)
    if prec == F64 and not half:
        got = dict(loss=[float(s["loss"]) for s in fit["steps"]], grad=fit["grads"],
                   after=fit["after"], z=fit["k2"]["out"][0], ladj=fit["k2"]["out"][1])
    else:
        got = train.replay(fit["before"], batches, tcfg, bins, prec, steps, half)
    a, b = got["loss"][0], ref["loss"][0]
    loss_gap = abs(a - b) / (1.0 + abs(b)) if math.isfinite(a) else math.inf
    grad_gap = train.leaf_gap(got["grad"], ref["grad"])
    change = lambda after: [a.to(torch.float64) - b.to(torch.float64)
                            for a, b in zip(after, fit["before"])]
    change_gap = train.leaf_gap(change(got["after"]), change(ref["after"]),
                                train.moved(ref["grad"]))
    if half:
        return loss_gap, grad_gap, change_gap
    return loss_gap, grad_gap, change_gap, gap(got["z"], ref["z"]), gap(got["ladj"], ref["ladj"])


def particles(x, logl, logp, likelihood, prior_spec, prec=F64):
    """(logl gap, logp gap) of rows x against the plain likelihood and
    prior (rows whose program logl is not finite are left out)."""
    ok = torch.isfinite(logl)
    x64 = x[ok].to(torch.float64)
    ll_r, lp_r = likelihood(x64), log_prior(x64, prior_spec)
    if prec != F64:
        xc = cast(x[ok], prec)
        ll, lp = likelihood(xc), log_prior(xc, prior_spec)
    else:
        ll, lp = logl[ok], logp[ok]
    return gap(ll, ll_r), gap(lp, lp_r)


def accept(capture, prec=F64):
    """accept_flips: rows of the last accept step whose new state is not
    the one the reference's Metropolis decision picks, among the rows whose
    decision lies farther from its threshold than float32 rounding can move
    it. A row that is neither its old state nor its proposal counts too."""
    a = capture
    old, prop, new = a["old"], a["prop"], a["new"]
    fields = dict(logl=old.logl, logp=old.logp, logdetj=old.logdetj,
                  logdetj_flow=old.logdetj_flow)
    lr, scale = smc.tpcn_log_ratio(fields, prop, a["logl_p"], a["beta"], a["nu"], a["d"],
                                   a["preconditioned"], F64)
    acc = smc.accept_mask(lr, prop["unif"])
    margin = smc.log_uniform_margin(lr, prop["unif"])
    eps = 2.0 ** -18 * torch.where(torch.isfinite(scale), scale, torch.zeros_like(scale)) + 1e-9
    decided = margin > eps
    if prec == F64:
        took_prop = (new.u == prop["u"]).all(1) & (new.logl == a["logl_p"])
        took_old = (new.u == old.u).all(1) & (new.logl == old.logl)
    else:
        lr_c, _ = smc.tpcn_log_ratio(fields, prop, a["logl_p"], a["beta"], a["nu"], a["d"],
                                     a["preconditioned"], prec)
        took_prop = smc.accept_mask(lr_c, prop["unif"])
        took_old = ~took_prop
    flips = decided & ((acc & ~took_prop) | (~acc & ~took_old))
    return int(flips.sum())
