"""Masked-autoregressive neural spline flows (NSF), torch.

Counterpart of ``pocomc_tpu/models/flow.py`` for the ``nsf*`` kinds: T
masked-autoregressive transforms with alternating variable order (identity
on even transforms, reversed on odd ones), each a 3-hidden-layer residual
MADE with n_hidden = max(next_pow2(3*d), 32) feeding an 8-bin
rational-quadratic spline, a standard-normal base, and an affine whitening
pre-layer refit in closed form at every training round.

Directions: ``forward`` data -> latent (one MADE pass per transform, the K2
kernel on CUDA); ``inverse`` latent -> data (autoregressive, T*d MADE
passes, the K1 kernel on CUDA). The pre-layer ``y = (x - mean) @ w_fwd``
and its inverse ``y @ w_inv + mean`` stay ``torch.matmul``.

``Flow`` is an ``nn.Module`` whose trainable parameters are the stacked
per-layer weights (T, fan_in, fan_out) and biases (T, fan_out); the masks,
the inverse dimension orders and the pre-layer are buffers. Compute goes
through ``FlowParams`` snapshots (masked weights, biases, pre-layer), so a
sweep masks the weights once and every call reuses them, and training
forms ``w * mask`` inside the autograd graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .made import init_made
from . import transforms as tr
from ..ops.flow_kernels import made_rqs_forward, ar_inverse

_ARCHS = {
    "maf3": ("maf", 3), "maf6": ("maf", 6), "maf12": ("maf", 12),
    "nsf3": ("nsf", 3), "nsf6": ("nsf", 6), "nsf12": ("nsf", 12),
    "nsfc3": ("nsfc", 3), "nsfc6": ("nsfc", 6), "nsfc12": ("nsfc", 12),
}
_NOT_PORTED = {
    "maf": "masked affine flows ('maf*') are not ported yet (ROADMAP.md, "
           "port queue: maf*)",
    "nsfc": "coupling spline flows ('nsfc*') are not ported yet (ROADMAP.md, "
            "port queue: nsfc* + K5)",
}


def _next_pow2(n: int) -> int:
    return 1 if n <= 0 else 2 ** ((n - 1).bit_length())


def identity_pre(n_dim: int) -> dict:
    """Identity whitening pre-layer (numpy). Conventions: forward
    ``y = (x - mean) @ w_fwd`` with ``w_fwd = inv(L).T`` for
    ``L = chol(weighted cov)``; inverse ``x = y @ w_inv + mean`` with
    ``w_inv = L.T``; ``ladj`` = forward log|det dy/dx| = -sum(log diag L)."""
    return dict(mean=np.zeros(n_dim, np.float32),
                w_fwd=np.eye(n_dim, dtype=np.float32),
                w_inv=np.eye(n_dim, dtype=np.float32),
                ladj=np.float32(0.0))


def fit_pre_numpy(x, w, prev_pre, rel_eps=1e-6, min_ess=8.0, mode="full"):
    """Closed-form weighted whitening fit in host f64 numpy; returns
    ``prev_pre`` on a degenerate set (ESS below ``min_ess``, a (near-)zero
    or non-PD covariance). Same as ``pocomc_tpu.models.flow.fit_pre_numpy``."""
    n_dim = x.shape[-1]
    wsum = float(np.sum(w))
    if not np.isfinite(wsum) or wsum <= 0 or x.shape[0] <= n_dim:
        return prev_pre
    wn = (w / wsum).astype(np.float64)
    if 1.0 / np.sum(wn * wn) < min_ess:
        return prev_pre
    xf = x.astype(np.float64)
    mean = wn @ xf
    xc = xf - mean
    if mode == "diag":
        var = wn @ (xc * xc)
        trace = float(np.sum(var))
        if not np.isfinite(trace) or trace <= n_dim * 1e-10:
            return prev_pre
        chol = np.diag(np.sqrt(var + rel_eps * trace / n_dim))
    else:
        cov = (xc * wn[:, None]).T @ xc
        trace = float(np.trace(cov))
        if not np.isfinite(trace) or trace <= n_dim * 1e-10:
            return prev_pre
        cov += (rel_eps * trace / n_dim) * np.eye(n_dim)
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            return prev_pre
    if not np.all(np.isfinite(chol)):
        return prev_pre
    chol_inv = np.linalg.solve(chol, np.eye(n_dim))
    return dict(mean=mean.astype(np.float32),
                w_fwd=chol_inv.T.astype(np.float32),
                w_inv=chol.T.astype(np.float32),
                ladj=np.float32(-np.sum(np.log(np.diag(chol)))))


def fit_pre_torch(x, w, rel_eps=1e-6, min_ess=8.0, mode="full"):
    """On-device weighted whitening fit (``fit_pre_jax``): same guards as
    ``fit_pre_numpy`` with an identity fallback, as a dict of tensors."""
    n_dim = x.shape[-1]
    eye = torch.eye(n_dim, dtype=x.dtype, device=x.device)
    wn = w / torch.clamp(w.sum(), min=1e-30)
    mean = wn @ x
    xc = x - mean
    if mode == "diag":
        var = wn @ (xc * xc)
        trace = var.sum()
        chol = torch.diag(torch.sqrt(var + rel_eps * trace / n_dim + 1e-12))
    else:
        cov = (xc * wn[:, None]).T @ xc
        trace = torch.trace(cov)
        cov = cov + (rel_eps * trace / n_dim + 1e-12) * eye
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))
    ok = (torch.isfinite(chol).all() & (1.0 / (wn * wn).sum() >= min_ess)
          & torch.isfinite(trace) & (trace > n_dim * 1e-10))
    chol = torch.where(ok, chol, eye)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return dict(mean=torch.where(ok, mean, torch.zeros_like(mean)),
                w_fwd=chol_inv.T.contiguous(), w_inv=chol.T.contiguous(),
                ladj=-torch.log(torch.diagonal(chol)).sum())


class FlowParams(NamedTuple):
    """Compute-ready flow parameters: masked weights ``ws[l]`` (T, fi, fo),
    biases ``bs[l]`` (T, fo), the (T, d) int32 inverse dimension orders and
    the whitening pre-layer dict (mean, w_fwd, w_inv, ladj)."""
    ws: list
    bs: list
    inv_orders: torch.Tensor
    pre: dict


class Flow(nn.Module):
    """Masked-autoregressive neural spline flow (``nsf3``/``nsf6``/``nsf12``)."""

    def __init__(self, n_dim: int, flow: str = "nsf6", bins: int = 8,
                 seed: int = 0, whiten=True):
        super().__init__()
        if flow not in _ARCHS:
            raise ValueError(f"Invalid flow {flow!r}. Choose from {sorted(_ARCHS)}.")
        kind, n_transforms = _ARCHS[flow]
        if kind in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[kind])
        if int(bins) != 8:
            raise NotImplementedError("the flow kernels are built for 8 spline bins")
        if whiten not in (True, False, None, "none", "full", "diag"):
            raise ValueError(f"Invalid whiten {whiten!r}. Choose True/'full', "
                             f"'diag', or False/'none'.")
        self.whiten = whiten in (True, "full", "diag")
        self.whiten_mode = ("diag" if whiten == "diag"
                            else ("full" if self.whiten else None))
        self.n_dim = int(n_dim)
        self.kind, self.n_transforms = kind, n_transforms
        self.bins = int(bins)
        self.n_hidden = max(_next_pow2(3 * self.n_dim), 32)
        self.hidden_sizes = [self.n_hidden] * 3
        self.n_params = tr.rqs_n_params(self.bins)

        rng = np.random.default_rng(seed)
        base = np.arange(self.n_dim)
        self.orders = [base if t % 2 == 0 else base[::-1].copy()
                       for t in range(n_transforms)]
        layers, masks = [], []
        for t in range(n_transforms):
            p, m = init_made(rng, self.n_dim, self.hidden_sizes, self.n_params,
                             self.orders[t])
            layers.append(p)
            masks.append(m)
        n_layers = len(layers[0])
        self.weights = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.stack([layers[t][l]["w"]
                                                    for t in range(n_transforms)])))
            for l in range(n_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.stack([layers[t][l]["b"]
                                                    for t in range(n_transforms)])))
            for l in range(n_layers))
        for l in range(n_layers):
            self.register_buffer(
                f"mask{l}", torch.from_numpy(np.stack([masks[t][l]
                                                       for t in range(n_transforms)])))
        # the inverse visits dims in increasing autoregressive degree
        self.register_buffer("inv_orders", torch.from_numpy(
            np.stack([np.argsort(o) for o in self.orders]).astype(np.int32)))
        self.set_pre(identity_pre(self.n_dim))

    # -- parameters --------------------------------------------------------

    @property
    def masks(self):
        return [getattr(self, f"mask{l}") for l in range(len(self.weights))]

    def set_pre(self, pre: dict):
        """Install a whitening pre-layer (numpy arrays or tensors)."""
        dev = self.weights[0].device
        for k in ("mean", "w_fwd", "w_inv", "ladj"):
            v = pre[k]
            v = v.detach().clone() if torch.is_tensor(v) else torch.tensor(np.asarray(v))
            self.register_buffer(f"pre_{k}", v.to(device=dev, dtype=torch.float32))

    def get_pre(self) -> dict:
        return {k: getattr(self, f"pre_{k}")
                for k in ("mean", "w_fwd", "w_inv", "ladj")}

    def params(self) -> FlowParams:
        """Masked weights and biases (inside the autograd graph when grad is
        enabled) plus the pre-layer: what every compute call consumes."""
        ws = [w * m for w, m in zip(self.weights, self.masks)]
        return FlowParams(ws, list(self.biases), self.inv_orders, self.get_pre())

    # -- compute -----------------------------------------------------------

    def _fp(self, fp):
        return self.params() if fp is None else fp

    def stack_forward(self, y, fp=None):
        fp = self._fp(fp)
        return made_rqs_forward(y.contiguous(), fp.ws, fp.bs)

    def stack_inverse(self, z, fp=None):
        fp = self._fp(fp)
        return ar_inverse(z.contiguous(), fp.ws, fp.bs, fp.inv_orders)

    def forward(self, x, fp=None):
        """data -> (latent, log|det dz/dx|)."""
        fp = self._fp(fp)
        pre = fp.pre
        z, ladj = self.stack_forward((x - pre["mean"]) @ pre["w_fwd"], fp)
        return z, ladj + pre["ladj"]

    def inverse(self, z, fp=None):
        """latent -> (data, log|det dx/dz|)."""
        fp = self._fp(fp)
        pre = fp.pre
        y, ladj = self.stack_inverse(z, fp)
        return y @ pre["w_inv"] + pre["mean"], ladj - pre["ladj"]

    def _base_logpdf(self, z):
        return -0.5 * (z * z).sum(-1) - 0.5 * self.n_dim * math.log(2 * math.pi)

    def stack_log_prob(self, y, fp=None):
        """Log density of the transform stack at pre-whitened inputs y."""
        z, ladj = self.stack_forward(y, fp)
        return self._base_logpdf(z) + ladj

    def log_prob(self, x, fp=None):
        fp = self._fp(fp)
        pre = fp.pre
        return self.stack_log_prob((x - pre["mean"]) @ pre["w_fwd"], fp) + pre["ladj"]

    def sample(self, size, generator=None, fp=None):
        """(x, log q(x)) for ``size`` draws from the flow."""
        dev = self.weights[0].device
        z = torch.randn(size, self.n_dim, generator=generator, device=dev)
        x, ladj = self.inverse(z, fp)
        return x, self._base_logpdf(z) - ladj

    def sample_t(self, size, nu, generator=None, fp=None):
        """Heavier-tailed draws through the same transform: z ~ Student-t_nu
        (0, I) in latent space, pushed through the inverse. Returns (x,
        log q(x)) with the exact proposal density."""
        dev = self.weights[0].device
        d = self.n_dim
        zn = torch.randn(size, d, generator=generator, device=dev)
        alpha = torch.full((size, 1), nu / 2.0, device=dev)
        g = 2.0 * torch._standard_gamma(alpha, generator=generator)
        z = zn * torch.sqrt(nu / g)
        x, ladj = self.inverse(z, fp)
        base = (math.lgamma((nu + d) / 2.0) - math.lgamma(nu / 2.0)
                - 0.5 * d * math.log(nu * math.pi)
                - 0.5 * (nu + d) * torch.log1p((z * z).sum(-1) / nu))
        return x, base - ladj

    # kernel-facing contract: both directions report log|det du/dtheta|
    def kernel_fwd(self, u, fp=None):
        theta, ladj = self.forward(u, fp)
        return theta, -ladj

    def kernel_inv(self, theta, fp=None):
        return self.inverse(theta, fp)
