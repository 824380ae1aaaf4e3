"""Coupling-layer spline flows (the ``nsfc*`` kinds), torch.

Counterpart of ``pocomc_tpu/models/coupling.py``: RealNVP-style coupling
transforms (Dinh et al. 2017) with rational-quadratic splines of ``bins``
bins, 8 by default (Durkan et al. 2019). Transform t conditions a residual MLP on one half
of the dimensions and maps the other half through splines whose
parameters the MLP gives, so both directions are one pass a transform.
The halves alternate: an even transform conditions on the first
ceil(d/2) dimensions, an odd one on the last floor(d/2). Masks and the
initialisation are host numpy, the same draws in the same order as the
JAX package; the passes here are the plain versions of what the K5 kernel
(``ops/coupling_kernels.py``) computes for a whole stack.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import transforms as tr

# the spline's default bins
BINS = 8


def make_coupling_masks(n_dim: int, n_transforms: int):
    """Alternating boolean masks: transform t conditions on the ``True``
    dimensions and transforms the others."""
    masks = []
    for t in range(n_transforms):
        m = np.zeros(n_dim, dtype=bool)
        if t % 2 == 0:
            m[: (n_dim + 1) // 2] = True
        else:
            m[(n_dim + 1) // 2:] = True
        masks.append(m)
    return masks


def init_coupling(rng: np.random.Generator, n_dim: int, hidden_sizes, n_params: int,
                  cond_mask: np.ndarray):
    """One transform's MLP from the conditioning dimensions to the
    transformed dimensions' parameters, as a list of {w, b} (host numpy);
    the output layer starts at zero, so the flow starts at the identity."""
    n_cond = int(cond_mask.sum())
    n_out = int((~cond_mask).sum()) * n_params
    sizes = [max(n_cond, 1)] + list(hidden_sizes) + [n_out]
    params = []
    for l in range(len(sizes) - 1):
        fan_in, fan_out = sizes[l], sizes[l + 1]
        if l == len(sizes) - 2:
            w = np.zeros((fan_in, fan_out), np.float32)
        else:
            w = (np.sqrt(2.0 / fan_in)
                 * rng.standard_normal((fan_in, fan_out))).astype(np.float32)
        params.append({"w": w, "b": np.zeros(fan_out, np.float32)})
    return params


def layer_inputs(ws, bs, x_cond):
    """The inputs of the four products of one transform's MLP at the
    conditioning columns: x_cond, relu(h0), relu(h1), relu(h2), with
    h0 = x W0 + b0 and h_l = h_{l-1} + relu(h_{l-1}) W_l + b_l."""
    h = x_cond @ ws[0] + bs[0]
    acts = [x_cond, torch.relu(h)]
    for l in (1, 2):
        h = h + (acts[-1] @ ws[l] + bs[l])
        acts.append(torch.relu(h))
    return acts


def apply_coupling_net(ws, bs, x_cond):
    """(n, n_cond) -> (n, n_trans * n_params)."""
    return layer_inputs(ws, bs, x_cond)[3] @ ws[3] + bs[3]


@functools.lru_cache(maxsize=256)
def _index_tensors(mask_bytes, device):
    m = np.frombuffer(mask_bytes, dtype=bool)
    return (torch.as_tensor(np.flatnonzero(m), device=device),
            torch.as_tensor(np.flatnonzero(~m), device=device))


def halves(cond_mask, device):
    """(conditioning, transformed) index tensors of a mask on ``device``,
    made once per mask and device (so that a CUDA graph can capture a pass
    that uses them)."""
    return _index_tensors(np.asarray(cond_mask, dtype=bool).tobytes(), torch.device(device))


def _coupling(ws, bs, cond_mask, x, element, bins):
    cond, trans = halves(cond_mask, x.device)
    p = apply_coupling_net(ws, bs, x[:, cond]).reshape(x.shape[0], trans.numel(), -1)
    xt, ladj = element(x[:, trans], p, bins)
    out = x.clone()
    out[:, trans] = xt
    return out, ladj.sum(-1)


def coupling_forward(ws, bs, cond_mask, x, bins=BINS):
    """One coupling transform, data -> latent: (z, ladj rows). The
    conditioning columns pass through unchanged."""
    return _coupling(ws, bs, cond_mask, x, tr.rqs_forward, bins)


def coupling_inverse(ws, bs, cond_mask, z, bins=BINS):
    """One coupling transform, latent -> data, one pass: (x, ladj rows)."""
    return _coupling(ws, bs, cond_mask, z, tr.rqs_inverse, bins)
