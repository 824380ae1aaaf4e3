"""The three phases of a Preconditioned Monte Carlo iteration on the device.

Counterpart of ``pocomc_tpu/parallel/fused.py``, run as plain eager torch
functions over a fixed-shape device history:

  A. ``reweight``: the next inverse temperature by a fixed 26-step
     ESS/USS bisection over the multiple-IS weights of the whole history,
     the ``resid_prev`` correction of the new logZ rung, dynamic
     n_effective, weight trimming and the top-K training set;
  B. ``train``: the flow fit (0.5 validation split, power-of-two batch with
     zero-weight wrap padding, AdamW with global-norm clipping, best-params
     snapshot, early stop after int(1.5 * patience) stale epochs, rollback
     on a non-finite fit) and the proposal-geometry refit in latent space;
  C. ``mutate``: resample, the sweep (``mcmc.Sweep``), history push and
     the beta = 1 termination metric; without the flow (``precondition=
     False``) phase B does not run and phase C fits the u-space geometry
     itself before it resamples.

The JAX package runs each phase as one compiled program and pipelines them
behind a remote link; here the host syncs once per iteration instead, so
the enqueue-ahead and its ``terminated`` no-op gating have no counterpart.
The history buffers are updated in place (``push_history``).

With a ``mesh`` (``parallel/mesh.py``) the history's u, x and logdetj hold
this rank's rows of every slot, while logl, logp, beta and logz, and so
all of phase A, stay replicated (trimming sorts the whole flat weight
vector): the rows phase A selects and phase C resamples are gathered from
their owners (``take_rows``), phase B trains on each batch's rows split
over the ranks, and phase C sweeps this rank's block of the resampled
population and gathers its logl and logp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.flow import fit_pre_torch, fit_stack
from .models.geometry import fit_geometry
from .ops.resampling import multinomial_resample_torch, systematic_resample_torch
from .ops.weights import (ess_torch, uss_torch, trim_weights_torch,
                          mis_denominator_torch, logw_from_denominator_torch)
from .parallel.mesh import block, gather_rows, map_rows, take_rows
from .utils import trace

# length of phase A's stats vector: [beta, logz, metric_at_beta, n_eff_next,
# uss_active]
STATS_A_LEN = 5


@dataclasses.dataclass
class DeviceHistory:
    """Fixed-shape persistent-sampling history: T_max slots of n particles,
    the first ``t`` of them filled (u, x and logdetj: this rank's rows on a
    mesh)."""
    u: torch.Tensor        # (T_max, n, d)
    x: torch.Tensor        # (T_max, n, d)
    logdetj: torch.Tensor  # (T_max, n)
    logl: torch.Tensor     # (T_max, n)
    logp: torch.Tensor     # (T_max, n)
    beta: torch.Tensor     # (T_max,)
    logz: torch.Tensor     # (T_max,)
    t: int

    @property
    def valid(self):
        return torch.arange(self.logl.shape[0], device=self.logl.device) < self.t


def history_from_numpy(u, x, logdetj, logl, logp, beta, logz, t_max, device, mesh=None):
    """Padded fp32 device buffers from stacked (t, n[, d]) host arrays; on a
    mesh, u, x and logdetj keep this rank's rows (``shard_history``)."""
    t = logl.shape[0]
    if t > t_max:
        raise ValueError(f"{t} stored iterations exceed t_max={t_max}")

    def pad(a):
        a = np.asarray(a, np.float32)
        out = np.zeros((t_max,) + a.shape[1:], np.float32)
        out[:t] = a
        return torch.from_numpy(out).to(device)

    rows = dict(u=pad(u), x=pad(x), logdetj=pad(logdetj))
    if mesh is not None:
        rows = mesh.shard_history(rows)
    return DeviceHistory(**rows, logl=pad(logl), logp=pad(logp),
                         beta=pad(np.reshape(beta, t)), logz=pad(np.reshape(logz, t)), t=t)


def grow_history(hist: DeviceHistory, t_max: int) -> DeviceHistory:
    """Double the slot capacity."""
    def pad(a):
        extra = torch.zeros((t_max - a.shape[0],) + a.shape[1:], dtype=a.dtype,
                            device=a.device)
        return torch.cat([a, extra])
    return DeviceHistory(u=pad(hist.u), x=pad(hist.x), logdetj=pad(hist.logdetj),
                         logl=pad(hist.logl), logp=pad(hist.logp),
                         beta=pad(hist.beta), logz=pad(hist.logz), t=hist.t)


def push_history(hist: DeviceHistory, u, x, logdetj, logl, logp, beta, logz):
    """Write one iteration into slot ``hist.t`` in place; the counter
    saturates at T_max."""
    t_max = hist.logl.shape[0]
    t = min(hist.t, t_max - 1)
    hist.u[t], hist.x[t], hist.logdetj[t] = u, x, logdetj
    hist.logl[t], hist.logp[t] = logl, logp
    hist.beta[t], hist.logz[t] = beta, logz
    hist.t = min(hist.t + 1, t_max)


def _flat_weights(hist, B, valid, valid_flat, beta):
    """Normalized flat history weights and logZ at temperature beta."""
    logw, logz = logw_from_denominator_torch(hist.logl, B, valid, beta)
    w = torch.exp(logw - logw.max())
    w = torch.where(valid_flat, w, torch.zeros_like(w))
    return w / w.sum(), logz


def _metric(w, valid_flat, metric):
    return ess_torch(w) if metric == "ess" else uss_torch(w, valid_flat.sum())


def reweight(hist, n_effective, n_total, resid_prev, n_select, n_active,
             metric="ess", dynamic=True, dynamic_ratio=1.0, trim_ess=0.99,
             trim_bins=1000, n_bisect=26, bias_budget=0.0, mesh=None):
    """Phase A. ``n_effective`` and ``resid_prev`` are 0-d device tensors
    chained from the previous iteration. Returns a dict with beta, logz,
    w_flat (S,), u_sel (K, d), w_sel (K,), stats (5,)."""
    T_max, n = hist.logl.shape
    valid = hist.valid
    valid_flat = valid.repeat_interleave(n)
    t_prev = max(hist.t - 1, 0)
    beta_prev, logz_prev = hist.beta[t_prev], hist.logz[t_prev]
    one = torch.ones((), dtype=hist.beta.dtype, device=hist.beta.device)
    # the mixture denominator does not depend on the probed temperature
    B = mis_denominator_torch(hist.logl, hist.beta, hist.logz, valid)

    def metric_at(beta):
        w, logz = _flat_weights(hist, B, valid, valid_flat, beta)
        return w, logz, _metric(w, valid_flat, metric)

    m_prev = metric_at(beta_prev)[2]
    m_one = metric_at(one)[2]
    lo, hi = beta_prev, one
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        pred = metric_at(mid)[2] >= n_effective
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    beta = torch.where(m_prev <= n_effective, beta_prev,
                       torch.where(m_one >= n_effective, one, 0.5 * (lo + hi)))
    if bias_budget > 0.0:
        # cap the advance so each rung carries at most bias_budget nats of
        # estimated hotness (2^-8 progress floor)
        adv = torch.clamp(bias_budget / torch.clamp(resid_prev.abs(), min=1e-12),
                          min=2.0 ** -8)
        beta = torch.where(beta > beta_prev, torch.minimum(beta, beta_prev + adv), beta)
    w, logz_new, m_at = metric_at(beta)
    # moving rungs get the residual-hotness correction dbeta * resid_prev;
    # a stalled beta keeps the previous rung
    logz = torch.where(beta == beta_prev, logz_prev,
                       logz_new + (beta - beta_prev) * resid_prev)

    nu_active = uss_torch(w, n_active)
    if dynamic:
        low = n_active * (0.95 * dynamic_ratio)
        high = n_active * min(1.05 * dynamic_ratio, 1.0)
        n_eff_next = torch.where(
            nu_active < low, torch.trunc(n_active / nu_active * n_effective),
            torch.where(nu_active > high,
                        torch.trunc(nu_active / n_active * n_effective),
                        n_effective))
    else:
        n_eff_next = n_effective

    w_t = trim_weights_torch(w, valid_flat, ess=trim_ess, bins=trim_bins)
    w_sel, idx = torch.topk(w_t, n_select)
    w_sel = w_sel / w_sel.sum()
    u_sel = take_rows(mesh, hist.u, idx, n)
    stats = torch.stack([beta, logz, m_at, n_eff_next.to(beta), nu_active])
    return dict(beta=beta, logz=logz, w_flat=w_t, u_sel=u_sel, w_sel=w_sel,
                stats=stats)


def train(flow, u_sel, w_sel, generator, batch_size, validation_split=0.5,
          epochs=5000, patience=10, learning_rate=1e-3, weight_decay=0.0,
          clip_grad_norm=1.0, laplace_scale=None, gaussian_scale=None, mesh=None):
    """Phase B: fit ``flow`` in place on the weighted set, then refit the
    proposal geometry in its latent space. Returns (geom, stats) with
    stats = [epochs run, best monitored loss]. On a mesh the fit is data
    parallel (``fit_stack``); the latent rows are mapped a block a rank and
    gathered, and the geometry is fitted on them replicated."""
    n_select, n_dim = u_sel.shape
    use_val = validation_split > 0
    n_train = int(validation_split * n_select) if use_val else n_select
    n_val = n_select - n_train if use_val else 1
    bs = max(1, min(int(batch_size), n_train))
    bs = 1 << (bs.bit_length() - 1)
    n_batches = -(-n_train // bs)
    n_rows = n_batches * bs  # >= n_train; wrap-padded with zero weights
    dev = u_sel.device

    pre_prev = {k: v.clone() for k, v in flow.get_pre().items()}
    pre = (fit_pre_torch(u_sel, w_sel, mode=flow.whiten_mode)
           if flow.whiten else pre_prev)
    u_in = (u_sel - pre["mean"]) @ pre["w_fwd"]
    flow.set_pre(pre)

    perm = torch.randperm(n_select, generator=generator, device=dev)
    xs, ws = u_in[perm], w_sel[perm]
    rows = torch.arange(n_rows, device=dev)
    wrap = rows % n_train
    xt = xs[:n_train][wrap]
    wt = torch.where(rows < n_train, ws[:n_train][wrap], torch.zeros_like(wrap, dtype=ws.dtype))
    xv, wv = (xs[n_train:], ws[n_train:]) if use_val else (None, None)

    _, best_loss, ei, ok = fit_stack(
        flow, xt, wt, xv, wv, n_train, n_val, bs, generator, epochs=epochs,
        patience=patience, learning_rate=learning_rate, weight_decay=weight_decay,
        clip_grad_norm=clip_grad_norm, laplace_scale=laplace_scale,
        gaussian_scale=gaussian_scale, mesh=mesh)
    if not ok:
        # a fit that never reached a finite loss keeps the INPUT params and
        # the pre-layer they were trained against
        flow.set_pre(pre_prev)

    sp = trace.begin("geometry")
    with torch.no_grad():
        theta = map_rows(mesh, lambda a: flow.forward(a)[0], u_sel)
        geom = fit_geometry(theta, w_sel, generator)
    trace.end(sp)
    # a host list copied to the card waits for it, as a read does
    sp = trace.begin("read")
    stats = torch.tensor([float(ei), best_loss], device=dev)
    trace.end(sp)
    return geom, stats


def mutate(hist, beta, logz, w_flat, u_sel, w_sel, sigma0, geom, fp, sweep, scp,
           generator, n_active, resample="mult", metric="ess", mesh=None):
    """Phase C: resample from the flat history weights, sweep, push the new
    stage and compute the termination metric. A sweep without the flow
    fits its u-space geometry here on phase A's set (u_sel, w_sel), every
    iteration (``geom`` is ignored then); a preconditioned one
    takes phase B's. Returns the stats vector [accept, steps, calls,
    proposal_scale, metric_at_beta1, mean_logl_logp, noop, corr, resid,
    hot, z_logl, z_dim, nu, misfit, resid_exit]."""
    T_max, n = hist.logl.shape
    if not sweep.preconditioned:
        geom = fit_geometry(u_sel, w_sel, generator)
    resampler = (multinomial_resample_torch if resample == "mult"
                 else systematic_resample_torch)
    sp = trace.begin("resample")
    idx = resampler(n_active, w_flat, generator)
    trace.end(sp)
    # this rank's block of the resampled population, from every rank's rows
    take = lambda a: block(mesh, take_rows(mesh, a, idx, n))
    take_replicated = lambda a: block(mesh, a.reshape(T_max * n)[idx])
    t_prev = max(hist.t - 1, 0)
    dbeta = torch.clamp(beta - hist.beta[t_prev], min=0.0)
    res = sweep.run(take(hist.u), take(hist.x), take(hist.logdetj),
                    take_replicated(hist.logl), take_replicated(hist.logp), beta, sigma0,
                    geom, fp, scp, generator, dbeta=dbeta)
    sp = trace.begin("push")
    logl, logp = gather_rows(mesh, torch.stack([res["logl"], res["logp"]], 1)).unbind(1)
    push_history(hist, res["u"], res["x"], res["logdetj"], logl, logp, beta, logz)
    trace.end(sp)

    valid = hist.valid
    valid_flat = valid.repeat_interleave(n)
    B = mis_denominator_torch(hist.logl, hist.beta, hist.logz, valid)
    w1, _ = _flat_weights(hist, B, valid, valid_flat, torch.ones_like(beta))
    f = lambda v: torch.as_tensor(v, device=beta.device).to(beta.dtype).reshape(())
    # the host's step count and the 0 copied to the card wait for it, as a
    # read does
    sp = trace.begin("read")
    steps, noop = f(res["steps"]), f(0.0)
    trace.end(sp)
    return torch.stack([
        f(res["accept"]), steps, f(res["calls"]), f(res["proposal_scale"]),
        _metric(w1, valid_flat, metric), (logl + logp).mean(),
        noop, f(res["corr"]), f(res["resid"]), f(res["hot"]), f(res["z_logl"]),
        f(res["z_dim"]), torch.clamp(geom["t_nu"], max=1e6).to(beta.dtype),
        f(res["misfit"]), f(res["resid_exit"])])
