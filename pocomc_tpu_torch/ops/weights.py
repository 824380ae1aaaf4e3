"""Importance-weight numerics for persistent-sampling SMC.

Counterpart of ``pocomc_tpu/ops/weights.py``. The host bookkeeping (tiny
O(T * n_active) arrays) stays float64 numpy, moved over unchanged: Kish
ESS, unique sample size, weight trimming, and the multiple-importance-
sampling log-weights and logZ, and the temperature bisection
``bisect_beta`` of the host loop (the device loop bisects on the device in
``phases.reweight``). The on-device
mirrors (``ess_torch``, ``uss_torch``, ``trim_weights_torch``,
``compute_logw_and_logz_torch``) are torch ops on fixed-shape padded
history buffers with a validity mask, as the device loop's phases use them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host (numpy, float64) versions — used by the Sampler's outer-loop
# bookkeeping where accuracy of logZ matters and arrays are tiny.
# ---------------------------------------------------------------------------

def effective_sample_size(weights: np.ndarray) -> float:
    """Kish effective sample size 1 / sum(w_norm^2)."""
    w = np.asarray(weights, dtype=np.float64)
    s = w.sum()
    if s <= 0 or not np.isfinite(s):
        return 0.0
    w = w / s
    return float(1.0 / np.sum(w * w))


def unique_sample_size(weights: np.ndarray, k: int | None = None) -> float:
    """Expected number of unique particles after a k-sized multinomial draw.

    sum_i (1 - (1 - w_i)^k) with normalized weights.
    """
    w = np.asarray(weights, dtype=np.float64)
    if k is None:
        k = len(w)
    s = w.sum()
    if s <= 0 or not np.isfinite(s):
        return 0.0
    w = w / s
    return float(np.sum(1.0 - (1.0 - w) ** k))


def compute_ess(logw: np.ndarray) -> float:
    """Normalized ESS fraction (between 0 and 1) from log-weights."""
    logw = np.asarray(logw, dtype=np.float64)
    logw = logw - np.max(logw)
    w = np.exp(logw)
    w = w / np.sum(w)
    return float(1.0 / np.sum(w * w) / len(w))


def increment_logz(logw: np.ndarray) -> float:
    """Stable logsumexp of log-weights."""
    logw = np.asarray(logw, dtype=np.float64)
    m = np.max(logw)
    return float(m + np.log(np.sum(np.exp(logw - m))))


def trim_weights(weights: np.ndarray, ess: float = 0.99, bins: int = 1000):
    """Find the largest percentile weight-threshold whose surviving set keeps
    trimmed ESS >= ess * total ESS.

    Returns (mask, trimmed_weights) where mask is boolean over the input and
    trimmed_weights are the renormalized surviving weights.

    Vectorized re-design of reference tools.py:10-53 (which loops a
    percentile grid from the top): we evaluate all candidate thresholds at
    once via a descending sort + prefix sums.
    """
    w = np.asarray(weights, dtype=np.float64)
    s = w.sum()
    if s <= 0 or not np.isfinite(s):
        raise ValueError(
            "trim_weights requires a positive, finite total weight "
            f"(got sum={s!r}); the sibling ESS/USS helpers return 0.0 "
            "for such inputs but a trim threshold is undefined.")
    w = w / s
    n = len(w)
    ess_total = 1.0 / np.sum(w * w)

    # Candidate thresholds: the same percentile grid as the reference.
    percentiles = np.linspace(0, 99, bins)
    thresholds = np.percentile(w, percentiles)

    # Descending sort; keeping "w >= thr" = keeping the top-k for some k.
    order = np.argsort(w)[::-1]
    w_sorted = w[order]
    csum = np.cumsum(w_sorted)
    csq = np.cumsum(w_sorted * w_sorted)
    # ESS of the top-k set, for every k in 1..n
    ess_k = (csum ** 2) / csq

    # For each threshold, k(thr) = number of weights >= thr.
    # w_sorted is descending -> use searchsorted on the reversed array.
    k_of_thr = n - np.searchsorted(w_sorted[::-1], thresholds, side="left")
    k_of_thr = np.clip(k_of_thr, 1, n)
    ok = ess_k[k_of_thr - 1] / ess_total >= ess

    # Reference scans from the highest percentile down and stops at the
    # first valid one -> pick the largest valid threshold.
    valid = np.where(ok)[0]
    if len(valid) == 0:
        thr = thresholds[0]
    else:
        thr = thresholds[valid[-1]]

    mask = w >= thr
    wt = w[mask]
    return mask, wt / wt.sum()


def compute_logw_and_logz(
    logl_hist: np.ndarray,
    beta_hist: np.ndarray,
    logz_hist: np.ndarray,
    beta_final: float,
    normalize: bool = True,
):
    """Persistent-sampling (multiple importance sampling) reweighting.

    With T stored iterations of n particles each:
      A    = beta_final * logl                      (target numerator)
      b_i  = beta_i * logl - logz_i                 (mixture component i)
      B    = logsumexp_i(b_i) - log T               (balance-heuristic denom)
      logw = A - B, flattened over all T*n particles
      logz = logsumexp(logw) - log(T*n)

    Mirrors reference particles.py:215-231 with stable logsumexp in f64.

    Parameters
    ----------
    logl_hist : (T, n) log-likelihoods per stored iteration
    beta_hist : (T,) inverse temperatures
    logz_hist : (T,) running logZ estimates per iteration
    """
    logl = np.asarray(logl_hist, dtype=np.float64)
    beta = np.asarray(beta_hist, dtype=np.float64).reshape(-1, 1)
    logz = np.asarray(logz_hist, dtype=np.float64).reshape(-1, 1)
    T = logl.shape[0]

    A = logl * float(beta_final)
    # The mixture denominator sums over component temperatures i for EVERY
    # particle: shape (T_components, T_particles, n).
    b = logl[None, :, :] * beta[:, None, :] - logz[:, None, :]
    m = np.max(b, axis=0)
    B = m + np.log(np.mean(np.exp(b - m), axis=0))
    logw = (A - B).reshape(-1)
    total = logw.size
    mx = np.max(logw)
    se = mx + np.log(np.sum(np.exp(logw - mx)))
    logz_new = se - np.log(total)
    if normalize:
        logw = logw - se
    return logw, float(logz_new)


def logw_from_mis_denominator(
    logl_flat: np.ndarray,
    B_flat: np.ndarray,
    beta_final: float,
    normalize: bool = True,
):
    """compute_logw_and_logz given a precomputed mixture denominator.

    `B_flat` is the balance-heuristic denominator per flattened history
    particle, INCLUDING the -log T mixture normalization (i.e. exactly the
    `B` of compute_logw_and_logz, flattened). Callers with an incrementally
    maintained denominator (Particles.mis_denominator) use this to skip the
    O(T^2 * n) component-tensor rebuild.
    """
    logl_flat = np.asarray(logl_flat, dtype=np.float64)
    B_flat = np.asarray(B_flat, dtype=np.float64)
    logw = float(beta_final) * logl_flat - B_flat
    total = logw.size
    mx = np.max(logw)
    se = mx + np.log(np.sum(np.exp(logw - mx)))
    logz_new = se - np.log(total)
    if normalize:
        logw = logw - se
    return logw, float(logz_new)


def bisect_beta(
    logl_hist: np.ndarray,
    beta_hist: np.ndarray,
    logz_hist: np.ndarray,
    beta_prev: float,
    n_effective: float,
    metric: str = "ess",
    tol_frac: float = 0.01,
    B_flat: np.ndarray | None = None,
):
    """Choose the next inverse temperature by ESS/USS bisection.

    Mirrors reference sampler.py:735-781: keep beta_prev if its metric is
    already <= n_effective, jump to 1.0 if that still leaves
    metric >= n_effective, otherwise bisect in (beta_prev, 1].

    Returns (beta, logw_normalized, metric_value, logz).
    """
    # The balance-heuristic mixture denominator B (see
    # compute_logw_and_logz) does not depend on the trial beta — hoist
    # it out of the bisection so each trial is a cheap O(T*n) reweight
    # instead of rebuilding the O(T^2 * n) component tensor (~20-30
    # trials per _reweight on the single host core otherwise). Callers
    # that maintain the denominator incrementally across iterations
    # (Particles.mis_denominator) pass it via `B_flat` (with the -log T
    # mixture normalization included) and skip even the one-time build.
    logl = np.asarray(logl_hist, dtype=np.float64)
    logl_flat = logl.reshape(-1)
    total = logl_flat.size
    if B_flat is None:
        beta_h = np.asarray(beta_hist, dtype=np.float64).reshape(-1, 1)
        logz_h = np.asarray(logz_hist, dtype=np.float64).reshape(-1, 1)
        b = logl[None, :, :] * beta_h[:, None, :] - logz_h[:, None, :]
        m = np.max(b, axis=0)
        B_flat = (m + np.log(np.mean(np.exp(b - m), axis=0))).reshape(-1)
    else:
        B_flat = np.asarray(B_flat, dtype=np.float64).reshape(-1)
        if B_flat.size != total:
            raise ValueError(
                f"B_flat has {B_flat.size} entries for {total} history "
                "particles")

    def metric_at(beta):
        logw = float(beta) * logl_flat - B_flat
        mx = np.max(logw)
        se = mx + np.log(np.sum(np.exp(logw - mx)))
        logz = float(se - np.log(total))
        logw = logw - se  # normalized, as compute_logw_and_logz returns
        w = np.exp(logw - np.max(logw))
        if metric == "ess":
            val = effective_sample_size(w)
        else:
            val = unique_sample_size(w)
        return logw, w, val, logz

    logw_prev, w_prev, m_prev, logz_prev = metric_at(beta_prev)
    logw_max, w_max, m_max, logz_max = metric_at(1.0)

    if m_prev <= n_effective:
        return float(beta_prev), logw_prev, m_prev, logz_prev
    if m_max >= n_effective:
        return 1.0, logw_max, m_max, logz_max

    # Bounded bisection (the reference's loop at sampler.py:764-777 is a
    # bare `while True` — under extreme weight concentration the ESS/USS
    # metric is effectively discontinuous in beta and the interval can
    # collapse in f64 while the metric still sits outside the 1%
    # tolerance, spinning forever; fixed here, not copied). 80 halvings
    # shrink any (beta_prev, 1] interval below f64 resolution, and a
    # collapsed interval exits early; either way the trial whose metric
    # came CLOSEST to n_effective is returned.
    lo, hi = float(beta_prev), 1.0
    # seed "best" with the nearer endpoint so a degenerate interval
    # (beta_prev within one ulp of 1) still returns a valid tuple
    if abs(m_prev - n_effective) <= abs(m_max - n_effective):
        best, best_gap = ((float(beta_prev), logw_prev, m_prev, logz_prev),
                          abs(m_prev - n_effective))
    else:
        best, best_gap = ((1.0, logw_max, m_max, logz_max),
                          abs(m_max - n_effective))
    for _ in range(80):
        beta = 0.5 * (lo + hi)
        if beta <= lo or beta >= hi:
            break  # interval collapsed to f64 resolution
        logw, w, val, logz = metric_at(beta)
        gap = abs(val - n_effective)
        if gap < best_gap:
            best = (float(beta), logw, val, logz)
            best_gap = gap
        if gap < tol_frac * n_effective:
            return float(beta), logw, val, logz
        if val < n_effective:
            hi = beta
        else:
            lo = beta
    return best


# ---------------------------------------------------------------------------
# Device (torch) versions -- fixed-shape, masked, as phases.py uses them.
# ---------------------------------------------------------------------------

# stands in for -inf on empty history slots: -inf - -inf would give NaN
_NEG_BIG = -1e30


def ess_torch(weights: torch.Tensor) -> torch.Tensor:
    w = weights / weights.sum()
    return 1.0 / (w * w).sum()


def uss_torch(weights: torch.Tensor, k) -> torch.Tensor:
    """Expected unique count after a k-sized multinomial draw. `k` is
    required: padded weight vectors would otherwise count their padding."""
    w = weights / weights.sum()
    return (1.0 - (1.0 - w) ** k).sum()


def trim_weights_torch(w: torch.Tensor, valid: torch.Tensor,
                       ess: float = 0.99, bins: int = 1000) -> torch.Tensor:
    """Masked fixed-shape mirror of `trim_weights`: zero every weight below
    the largest percentile threshold whose survivors keep trimmed ESS >=
    ess * total ESS, and renormalize (padding slots never survive)."""
    S = w.shape[0]
    n_valid = valid.sum()
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / w.sum()
    ess_total = 1.0 / (w * w).sum()

    # percentile grid over the valid entries (np.percentile's linear
    # interpolation); invalid entries sort first as -inf
    w_asc, _ = torch.sort(torch.where(valid, w, torch.full_like(w, -math.inf)))
    pos = (torch.linspace(0.0, 99.0, bins, device=w.device, dtype=w.dtype)
           / 100.0 * (n_valid - 1))
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo
    base = S - n_valid
    thresholds = w_asc[base + lo] * (1.0 - frac) + w_asc[base + hi] * frac

    # ESS of the top-k set for every k (descending prefix sums)
    w_desc = torch.flip(torch.sort(w)[0], (0,))
    csum = torch.cumsum(w_desc, 0)
    csq = torch.cumsum(w_desc * w_desc, 0)
    ess_k = (csum * csum) / torch.clamp(csq, min=1e-38)

    k_of_thr = S - torch.searchsorted(w_asc, thresholds, right=False)
    k_of_thr = torch.minimum(torch.clamp(k_of_thr, min=1), n_valid)
    ok = ess_k[k_of_thr - 1] / ess_total >= ess

    # largest valid threshold (the reference scans from the top percentile)
    grid = torch.arange(bins, device=w.device)
    idx = torch.where(ok, grid, torch.full_like(grid, -1)).max()
    # a 0-d index tensor is read on the host: index_select keeps it on the card
    pick = thresholds.index_select(0, torch.clamp(idx, min=0).reshape(1))[0]
    thr = torch.where(idx >= 0, pick, thresholds[0])
    w_out = torch.where((w >= thr) & valid, w, torch.zeros_like(w))
    return w_out / w_out.sum()


def mis_denominator_torch(logl_hist, beta_hist, logz_hist, valid):
    """Balance-heuristic mixture denominator B (T, n) over the valid
    history components: logsumexp_i(beta_i * logl - logz_i) - log T. It
    does not depend on the target temperature, so a bisection builds it
    once and probes many temperatures with `logw_from_denominator_torch`."""
    b = (logl_hist[None, :, :] * beta_hist[:, None, None]
         - logz_hist[:, None, None])
    b = torch.where(valid[:, None, None], b, torch.full_like(b, _NEG_BIG))
    return torch.logsumexp(b, 0) - torch.log(valid.sum().to(logl_hist.dtype))


def logw_from_denominator_torch(logl_hist, B, valid, beta_final):
    """Flat normalized log-weights and logZ at beta_final given B."""
    logw = torch.where(valid[:, None], logl_hist * beta_final - B,
                       torch.full_like(B, _NEG_BIG)).reshape(-1)
    total = valid.sum() * logl_hist.shape[1]
    norm = torch.logsumexp(logw, 0)
    return logw - norm, norm - torch.log(total.to(logl_hist.dtype))


def compute_logw_and_logz_torch(logl_hist, beta_hist, logz_hist, valid,
                                beta_final):
    """Masked fixed-shape `compute_logw_and_logz` on the device:
    logl_hist (T, n) padded, beta_hist/logz_hist (T,), valid (T,) bool."""
    B = mis_denominator_torch(logl_hist, beta_hist, logz_hist, valid)
    return logw_from_denominator_torch(logl_hist, B, valid, beta_final)
