"""Normalizing flows, torch: masked-autoregressive (``maf*``, ``nsf*``)
and coupling (``nsfc*``) stacks and their trainer.

Counterpart of ``pocomc_tpu/models/flow.py`` and its menu. The
masked-autoregressive kinds: T transforms with alternating variable order
(identity on even transforms, reversed on odd ones), each a 3-hidden-layer
residual MADE with n_hidden = max(next_pow2(3*d), 32) feeding an element
transform, the affine map for ``maf*`` and a rational-quadratic spline of
``bins`` bins (8 by default) for ``nsf*``. The coupling kind ``nsfc*``
(``models/coupling.py``): T transforms over alternating halves, each a
residual MLP of the same widths on one half feeding splines of ``bins``
bins on the other. Any ``bins`` >= 2 runs on the CPU and on CUDA (the
kernels' libraries are built per bins up to 16, one of run-time bins past
that, at the first use of one). All have a
standard-normal base and an affine whitening pre-layer refit in closed
form at every training round.

Directions: ``forward`` data -> latent (one pass per transform: the K2
kernel on CUDA, or K5 for coupling); ``inverse`` latent -> data (K1 on
CUDA: autoregressive, T*d MADE passes; K5 for coupling: one pass per
transform). The pre-layer ``y = (x - mean) @ w_fwd`` and its inverse
``y @ w_inv + mean`` stay ``torch.matmul``.

``Flow`` is an ``nn.Module``. A masked-autoregressive flow's trainable
parameters are the stacked per-layer weights (T, fan_in, fan_out) and
biases (T, fan_out), its masks and inverse dimension orders buffers; a
coupling flow's are each transform's own four weights and biases (the
shapes differ between transforms at odd d), in ``weights[4t + l]``. The
pre-layer is a buffer. Compute goes through ``FlowParams`` or
``CouplingParams`` snapshots (weights, biases, pre-layer), so a sweep masks
the weights once and every call reuses them, and training forms
``w * mask`` inside the autograd graph.

Training: ``fit_stack`` is the AdamW loop both fits share (the device
loop's phase B and ``Flow.fit``, the host fit with its ``annealing`` and
``noise`` options); its loss ``Flow._loss_fn`` runs the forward through K2
(K5) on CUDA, and its gradient through K2's (K5's) backward kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .coupling import init_coupling, make_coupling_masks
from .made import init_made
from . import transforms as tr
from ..ops.coupling_kernels import coupling_forward, coupling_inverse
from ..ops.flow_kernels import ar_inverse, check_bins, made_rqs_forward
from ..parallel.mesh import all_reduce_grads, block, broadcast_seed, psum, same_device
from ..utils import trace

_ARCHS = {
    "maf3": ("maf", 3), "maf6": ("maf", 6), "maf12": ("maf", 12),
    "nsf3": ("nsf", 3), "nsf6": ("nsf", 6), "nsf12": ("nsf", 12),
    "nsfc3": ("nsfc", 3), "nsfc6": ("nsfc", 6), "nsfc12": ("nsfc", 12),
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
    """Compute-ready parameters of a masked-autoregressive flow: masked
    weights ``ws[l]`` (T, fi, fo), biases ``bs[l]`` (T, fo), the (T, d)
    int32 inverse dimension orders, the whitening pre-layer dict (mean,
    w_fwd, w_inv, ladj) and the spline's bins (a maf flow ignores them)."""
    ws: list
    bs: list
    inv_orders: torch.Tensor
    pre: dict
    bins: int = 8


class CouplingParams(NamedTuple):
    """Compute-ready parameters of a coupling flow: ``ws[t]`` and ``bs[t]``
    the four weights and biases of transform t, ``masks[t]`` its boolean
    conditioning mask over the d dimensions (numpy; its ``True`` entries
    are the conditioning indices, the others the transformed ones), the
    whitening pre-layer dict and the spline's bins."""
    ws: list
    bs: list
    masks: list
    pre: dict
    bins: int = 8


class Flow(nn.Module):
    """A normalizing flow of the menu ``maf3|6|12`` (masked affine),
    ``nsf3|6|12`` (masked spline) or ``nsfc3|6|12`` (coupling spline), with
    its parameters and buffers on ``device`` (the card by default;
    ``device="cpu"`` runs the plain versions of the kernels). The splines
    have ``bins`` bins, any bins >= 2 on either device (fewer raise
    ValueError here, at construction); a ``maf*`` flow keeps ``bins`` and
    ignores it, as the JAX package's does."""

    def __init__(self, n_dim: int, flow: str = "nsf6", bins: int = 8,
                 seed: int = 0, use_pallas="auto", use_pallas_inverse="auto",
                 whiten=True, *, device="cuda"):
        # use_pallas / use_pallas_inverse: accepted and ignored, as in the
        # JAX package (its flags no longer select anything), so that code
        # and configs written for it keep their positional meaning.
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Flow(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to run the plain versions on the CPU.")
        if flow not in _ARCHS:
            raise ValueError(f"Invalid flow {flow!r}. Choose from {sorted(_ARCHS)}.")
        kind, n_transforms = _ARCHS[flow]
        if kind != "maf":
            check_bins(bins)
        if kind == "nsfc" and int(n_dim) < 2:
            raise ValueError("Coupling flows ('nsfc*') need n_dim >= 2 (the dimensions are "
                             "split into two halves); use 'maf*' or 'nsf*' for 1-D problems.")
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
        self.head = "affine" if kind == "maf" else "rqs"
        self.n_params = (tr.AFFINE_N_PARAMS if kind == "maf" else tr.rqs_n_params(self.bins))

        rng = np.random.default_rng(seed)
        if kind == "nsfc":
            self.coupling_masks = make_coupling_masks(self.n_dim, n_transforms)
            layers = [init_coupling(rng, self.n_dim, self.hidden_sizes, self.n_params, m)
                      for m in self.coupling_masks]
            self.weights = nn.ParameterList(
                nn.Parameter(torch.from_numpy(layer["w"])) for tp in layers for layer in tp)
            self.biases = nn.ParameterList(
                nn.Parameter(torch.from_numpy(layer["b"])) for tp in layers for layer in tp)
            self.to(device)
            self.set_pre(identity_pre(self.n_dim))
            return
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
        self.to(device)
        self.set_pre(identity_pre(self.n_dim))

    # -- parameters --------------------------------------------------------

    @property
    def masks(self):
        """The MADE masks of a masked-autoregressive flow (a coupling flow
        has none)."""
        if self.kind == "nsfc":
            return []
        return [getattr(self, f"mask{l}") for l in range(len(self.weights))]

    def stack_numpy(self) -> list:
        """The transform stack's parameters in the JAX package's layout
        (``Flow.params["stack"]``), as numpy: four {w, b} with a leading
        transform axis, or, for a coupling flow, T lists of four {w, b}."""
        layers = [dict(w=w.detach().cpu().numpy(), b=b.detach().cpu().numpy())
                  for w, b in zip(self.weights, self.biases)]
        if self.kind == "nsfc":
            return [layers[4 * t:4 * t + 4] for t in range(self.n_transforms)]
        return layers

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

    def params(self):
        """Masked weights and biases (inside the autograd graph when grad is
        enabled) plus the pre-layer, as ``FlowParams``; a coupling flow's
        weights, biases, masks and pre-layer as ``CouplingParams``: what
        every compute call consumes."""
        if self.kind == "nsfc":
            T = self.n_transforms
            return CouplingParams([list(self.weights[4 * t:4 * t + 4]) for t in range(T)],
                                  [list(self.biases[4 * t:4 * t + 4]) for t in range(T)],
                                  self.coupling_masks, self.get_pre(), self.bins)
        ws = [w * m for w, m in zip(self.weights, self.masks)]
        return FlowParams(ws, list(self.biases), self.inv_orders, self.get_pre(), self.bins)

    # -- compute -----------------------------------------------------------

    def _fp(self, fp):
        return self.params() if fp is None else fp

    def stack_forward(self, y, fp=None):
        fp = self._fp(fp)
        if self.kind == "nsfc":
            return coupling_forward(y.contiguous(), fp.ws, fp.bs, fp.masks, bins=fp.bins)
        return made_rqs_forward(y.contiguous(), fp.ws, fp.bs, head=self.head, bins=fp.bins)

    def stack_inverse(self, z, fp=None):
        fp = self._fp(fp)
        if self.kind == "nsfc":
            return coupling_inverse(z.contiguous(), fp.ws, fp.bs, fp.masks, bins=fp.bins)
        return ar_inverse(z.contiguous(), fp.ws, fp.bs, fp.inv_orders, head=self.head,
                          bins=fp.bins)

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

    def sample(self, size=1, generator=None, fp=None):
        """(x, log q(x)) for ``size`` draws from the flow."""
        z, base = self._latent_draws(size, generator)
        x, ladj = self.inverse(z, fp)
        return x, base - ladj

    def sample_t(self, size, nu, generator=None, fp=None):
        """Heavier-tailed draws through the same transform: z ~ Student-t_nu
        (0, I) in latent space, pushed through the inverse. Returns (x,
        log q(x)) with the exact proposal density."""
        z, base = self._latent_draws(size, generator, nu)
        x, ladj = self.inverse(z, fp)
        return x, base - ladj

    def _latent_draws(self, size, generator=None, nu=None):
        """``size`` latent draws z and their base log density: N(0, I), or
        Student-t_nu (0, I) with ``nu`` (what ``sample``/``sample_t`` push
        through the inverse; a mesh draws them all and inverts a block a
        rank)."""
        dev = self.weights[0].device
        d = self.n_dim
        if nu is None:
            z = torch.randn(size, d, generator=generator, device=dev)
            return z, self._base_logpdf(z)
        zn = torch.randn(size, d, generator=generator, device=dev)
        alpha = torch.full((size, 1), nu / 2.0, device=dev)
        g = 2.0 * torch._standard_gamma(alpha, generator=generator)
        z = zn * torch.sqrt(nu / g)
        base = (math.lgamma((nu + d) / 2.0) - math.lgamma(nu / 2.0)
                - 0.5 * d * math.log(nu * math.pi)
                - 0.5 * (nu + d) * torch.log1p((z * z).sum(-1) / nu))
        return z, base

    # kernel-facing contract: both directions report log|det du/dtheta|
    def kernel_fwd(self, u, fp=None):
        theta, ladj = self.forward(u, fp)
        return theta, -ladj

    def kernel_inv(self, theta, fp=None):
        return self.inverse(theta, fp)

    # -- training ----------------------------------------------------------

    def _loss_fn(self, xb, wb, laplace_scale=None, gaussian_scale=None, wsum=None,
                 penalty=True):
        """Weighted NLL * 1000 of the transform stack at pre-whitened inputs,
        plus the Laplace / Gaussian penalties on the raw weights. The
        pre-layer's constant ladj is left out: it cannot move gradients or
        the best-epoch choice. A rank's share of a batch split over a mesh
        divides by the whole batch's weight ``wsum`` and carries the
        penalties on one rank only (``penalty``)."""
        logq = self.stack_log_prob(xb)
        loss = (-logq * wb * 1000.0).sum() / torch.clamp(wb.sum() if wsum is None else wsum,
                                                         min=1e-30)
        if penalty and (laplace_scale is not None or gaussian_scale is not None):
            reg = 0.0
            for w in self.weights:
                if laplace_scale is not None:
                    reg = reg + w.abs().sum() / laplace_scale
                if gaussian_scale is not None:
                    reg = reg + (w ** 2).sum() / (2.0 * gaussian_scale ** 2)
            loss = loss + reg
        return loss

    def fit(self, x, weights=None, validation_split=0.0, epochs=1000,
            batch_size=1000, patience=20, learning_rate=1e-3, weight_decay=0.0,
            laplace_scale=None, gaussian_scale=None, annealing=True, noise=None,
            shuffle=True, clip_grad_norm=1.0, verbose=0, seed=None, mesh=None,
            epoch_chunk="auto"):
        """Weighted maximum-likelihood training on host rows ``x`` (n, d),
        as ``pocomc_tpu.models.flow.Flow.fit``: the pre-layer is refit on
        the host and the stack trains in whitened space; the row count is
        padded to a power of two with zero-weight duplicates, the batch size
        floored and the batch count raised to powers of two (zero-weight
        rows fill the last batches); ``noise`` jitters each batch by
        ``noise`` times the mean nearest-neighbour distance; ``annealing``
        decays the learning rate on plateaus. The host reads every epoch's
        loss, so the schedule and the early stop act after each epoch (the
        JAX package's ``epoch_chunk`` batching for a remote device has no
        counterpart: ``epoch_chunk`` is checked as the JAX package checks it
        and then ignored). With a ``mesh`` (``parallel.mesh.ParticleMesh``,
        its device this flow's) every rank passes the same rows and the fit
        is data parallel (``fit_stack``); an unseeded fit takes rank 0's
        seed. Returns the history {"loss", "val_loss"}."""
        if mesh is not None and not same_device(mesh.device, self.weights[0].device):
            raise ValueError(f"Flow.fit(mesh=...): the flow is on {self.weights[0].device}, "
                             f"this rank's mesh device is {mesh.device}")
        if epoch_chunk != "auto":
            int(epoch_chunk)  # JAX's check: a non-integer raises, any integer runs
        x = np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, dtype=np.float32)
        n_samples = x.shape[0]
        if weights is None:
            w_all = np.full((n_samples,), 1.0 / n_samples, dtype=np.float32)
        else:
            w_all = np.asarray(weights.detach().cpu() if torch.is_tensor(weights)
                               else weights, dtype=np.float32)

        pre_prev = {k: v.detach().cpu().numpy() for k, v in self.get_pre().items()}
        pre = (fit_pre_numpy(x, w_all, pre_prev, mode=self.whiten_mode)
               if self.whiten else pre_prev)
        x = (x - pre["mean"]) @ pre["w_fwd"]

        if mesh is not None and seed is None:
            seed = broadcast_seed(mesh, int.from_bytes(np.random.bytes(4), "little"))
        rng = np.random.default_rng(seed)
        if shuffle:
            perm = rng.permutation(n_samples)
            x, w_all = x[perm], w_all[perm]
        n_bucket = _next_pow2(n_samples)
        if n_bucket > n_samples:
            pad_idx = rng.integers(0, n_samples, size=n_bucket - n_samples)
            x = np.concatenate([x, x[pad_idx]], axis=0)
            w_all = np.concatenate([w_all, np.zeros(n_bucket - n_samples, w_all.dtype)])
            if shuffle:
                perm = rng.permutation(n_bucket)
                x, w_all = x[perm], w_all[perm]
            n_samples = n_bucket

        dev = self.weights[0].device
        noise_scale = (float(noise) * mean_nn_distance(x, dev)
                       if noise is not None else 0.0)

        validation = validation_split > 0.0
        if validation:
            n_train = int(validation_split * n_samples)
            x_train, w_train = x[:n_train], w_all[:n_train]
            x_val, w_val = x[n_train:], w_all[n_train:]
        else:
            x_train, w_train = x, w_all
        batch_size = max(1, min(int(batch_size), x_train.shape[0]))
        batch_size = 1 << (batch_size.bit_length() - 1)
        n_batches = _next_pow2(-(-x_train.shape[0] // batch_size))
        n_train_real = x_train.shape[0]
        n_pad = n_batches * batch_size - n_train_real
        if n_pad > 0:
            reps = -(-n_pad // n_train_real)
            x_train = np.concatenate([x_train, np.tile(x_train, (reps, 1))[:n_pad]])
            w_train = np.concatenate([w_train, np.zeros(n_pad, w_train.dtype)])

        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        xv = wv = None
        if validation:
            xv, wv = to_dev(x_val), to_dev(w_val)
        self.set_pre(pre)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31 - 1)))
        plateau = (_PlateauLR(learning_rate, factor=0.2, patience=patience,
                              threshold=1e-4, min_lr=1e-6) if annealing else None)
        history, best_loss, n_done, ok = fit_stack(
            self, to_dev(x_train), to_dev(w_train), xv, wv, n_train_real,
            x_val.shape[0] if validation else 1, batch_size, gen, epochs=epochs,
            patience=patience, learning_rate=learning_rate,
            weight_decay=weight_decay, clip_grad_norm=clip_grad_norm,
            laplace_scale=laplace_scale, gaussian_scale=gaussian_scale,
            shuffle=shuffle, noise_scale=noise_scale, plateau=plateau, mesh=mesh)
        if not validation:
            history["val_loss"] = []
        if verbose > 0:
            print(f"Trained {n_done} epochs; best "
                  f"{'val_loss' if validation else 'loss'} {best_loss:.3f}")
        if not ok:
            self.set_pre(pre_prev)
        return history


def mean_nn_distance(x, device=None, chunk_elems=1 << 26):
    """Mean over the rows of x (n, d) of the distance to the nearest other
    row, exact duplicates excluded: the scale of ``Flow.fit``'s ``noise``.
    Computed in fp32 in blocks of rows, so memory stays O(chunk_elems)
    where the whole (n, n, d) difference would be O(n^2 d)."""
    xt = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    n, d = xt.shape
    rows = max(1, chunk_elems // max(n * d, 1))
    mins = []
    for i in range(0, n, rows):
        d2 = ((xt[i:i + rows, None, :] - xt[None, :, :]) ** 2).sum(-1)
        d2 = torch.where(d2 <= 0.0, torch.full_like(d2, math.inf), d2)
        mins.append(d2.min(1).values)
    return float(torch.sqrt(torch.cat(mins)).mean())


def fit_stack(flow, xt, wt, xv, wv, n_train, n_val, batch_size, generator,
              epochs=5000, patience=10, learning_rate=1e-3, weight_decay=0.0,
              clip_grad_norm=1.0, laplace_scale=None, gaussian_scale=None,
              shuffle=True, noise_scale=0.0, plateau=None, mesh=None):
    """AdamW fit of ``flow``'s transform stack in place, shared by the
    device loop's phase B and ``Flow.fit``.

    ``xt``/``wt`` hold a whole number of ``batch_size`` batches of
    pre-whitened rows (zero-weight rows pad); the monitored loss is the
    summed batch losses over ``n_train``, or the loss on ``xv``/``wv`` over
    ``n_val`` when ``xv`` is given. Each batch step: optional jitter
    ``noise_scale * N(0, 1)``, loss, backward, global-norm clip, AdamW.
    The best-loss parameters are kept; the fit stops after
    ``int(1.5 * patience)`` stale epochs; ``plateau`` (a ``_PlateauLR``)
    sets the learning rate after each epoch. A fit that never reaches a
    finite loss restores the input parameters. One host read per epoch.
    Returns (history, best loss, epochs run, finite).

    Spans (``utils/trace.py``): the fit, each epoch, each optimizer step
    with its loss, backward, clip and optimizer parts, the epoch's
    validation, best-parameter snapshot and read.

    With a ``mesh`` every rank holds the same rows and draws the same
    permutations; each batch (and the validation set) is split over the
    ranks (``shard_batches``), each rank's loss divides by the whole
    batch's weight, and each step's gradient is summed over the ranks in
    one flat ``all_reduce`` before the clip, so AdamW keeps the parameters
    replicated bit for bit. A batch the mesh does not divide runs whole on
    every rank (a counted replication fallback) with no gradient sum."""
    sp_fit = trace.begin("fit")
    n_rows, n_dim = xt.shape
    n_batches = n_rows // batch_size
    stop_after = int(1.5 * patience)
    dev = xt.device
    params = list(flow.parameters())
    params_in = [p.detach().clone() for p in params]
    best, best_loss, best_idx, ei = params_in, math.inf, 0, 0
    opt = torch.optim.AdamW(params, lr=learning_rate, weight_decay=weight_decay)
    reg = dict(laplace_scale=laplace_scale, gaussian_scale=gaussian_scale)
    history = dict(loss=[], val_loss=[])
    split_v = False
    if xv is not None and mesh is not None:
        n_v = xv.shape[0]
        xv, wv = mesh.shard_particles(xv), mesh.shard_particles(wv)
        split_v = xv.shape[0] < n_v or mesh.size == 1
    wsum_v = psum(mesh, wv.sum()) if split_v else None
    while ei < epochs and ei - 1 - best_idx < stop_after:
        sp_epoch = trace.begin("epoch")
        order = (torch.randperm(n_rows, generator=generator, device=dev) if shuffle
                 else torch.arange(n_rows, device=dev))
        xb = xt[order].reshape(n_batches, batch_size, n_dim)
        wb = wt[order].reshape(n_batches, batch_size)
        split = False
        if mesh is not None:
            xb, wb = mesh.shard_batches(xb), mesh.shard_batches(wb)
            split = xb.shape[1] < batch_size or mesh.size == 1
        if split:
            # every batch's whole weight, in one all_reduce an epoch
            wsums = psum(mesh, torch.stack([wb[b].sum() for b in range(n_batches)]))
        total = torch.zeros((), device=dev)
        for b in range(n_batches):
            sp_step = trace.begin("step")
            xi = xb[b]
            if noise_scale > 0.0:
                xi = xi + noise_scale * block(mesh if split else None, torch.randn(
                    (batch_size, n_dim), generator=generator, device=dev))
            opt.zero_grad(set_to_none=True)
            sp = trace.begin("loss")
            loss = flow._loss_fn(xi, wb[b], **reg, wsum=wsums[b] if split else None,
                                 penalty=not split or mesh.rank == 0)
            if sp is not None:
                trace.end(sp)
            sp = trace.begin("backward")
            loss.backward()
            if split:
                all_reduce_grads(mesh, params)
            if sp is not None:
                trace.end(sp)
            sp = trace.begin("clip")
            torch.nn.utils.clip_grad_norm_(params, clip_grad_norm)
            if sp is not None:
                trace.end(sp)
            sp = trace.begin("optimizer")
            opt.step()
            if sp is not None:
                trace.end(sp)
            total = total + loss.detach()
            if sp_step is not None:
                trace.end(sp_step)
        if xv is not None:
            sp = trace.begin("validate")
            with torch.no_grad():
                current = flow._loss_fn(xv, wv, **reg, wsum=wsum_v,
                                        penalty=not split_v or mesh.rank == 0) / n_val
            if sp is not None:
                trace.end(sp)
        # the epoch's losses summed over the ranks, in one all_reduce
        if split and split_v:
            total, current = psum(mesh, total, current)
        elif split:
            total = psum(mesh, total)
        elif split_v:
            current = psum(mesh, current)
        train = total / n_train
        if xv is None:
            current = train
        sp = trace.begin("read")
        tl, cl = torch.stack([train, current]).tolist()  # the epoch's one sync
        if sp is not None:
            trace.end(sp)
        history["loss"].append(tl)
        history["val_loss"].append(cl)
        if cl < best_loss:
            sp = trace.begin("snapshot")
            best = [p.detach().clone() for p in params]
            best_loss, best_idx = cl, ei
            if sp is not None:
                trace.end(sp)
        ei += 1
        if plateau is not None:
            lr = plateau.step(cl)
            for group in opt.param_groups:
                group["lr"] = lr
        if sp_epoch is not None:
            trace.end(sp_epoch)
    ok = math.isfinite(best_loss)
    with torch.no_grad():
        for p, src in zip(params, best if ok else params_in):
            p.copy_(src)
    trace.end(sp_fit)
    return history, best_loss, ei, ok


class _PlateauLR:
    """ReduceLROnPlateau: factor decay after `patience` stale epochs
    (absolute threshold), floored at min_lr (``pocomc_tpu``'s, unchanged)."""

    def __init__(self, lr, factor=0.2, patience=20, threshold=1e-4, min_lr=1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = np.inf
        self.stale = 0

    def step(self, value):
        if value < self.best - self.threshold:
            self.best = value
            self.stale = 0
        else:
            self.stale += 1
            if self.stale > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.stale = 0
        return self.lr
