"""MADE: masked autoregressive MLP (Germain et al. 2015), torch.

Counterpart of ``pocomc_tpu/models/made.py``. Degrees and masks are built
in numpy exactly as there; the passes take weights that are ALREADY
multiplied by their masks (``w * mask``), so that a kernel and its plain
version see the same operands and autograd goes through the product.
Residual connections apply on the square hidden layers; the last layer
starts at zero so every flow starts at the identity map.
"""

from __future__ import annotations

import numpy as np
import torch


def make_degrees(n_dim: int, order: np.ndarray, hidden_sizes: list[int]):
    """Degree vectors for input and hidden layers (input degree = rank+1;
    hidden units cycle through 1..max(1, d-1))."""
    degs = [np.asarray(order) + 1]
    max_deg = max(1, n_dim - 1)
    for h in hidden_sizes:
        degs.append((np.arange(h) % max_deg) + 1)
    return degs


def make_masks(degs, n_dim: int, n_params: int):
    """(fan_in, fan_out) connectivity masks per layer (hidden: >=,
    output: >). Output columns are laid out (d, n_params)."""
    masks = []
    for l in range(1, len(degs)):
        masks.append((degs[l][:, None] >= degs[l - 1][None, :]).astype(np.float32).T)
    out_deg = np.repeat(degs[0], n_params)
    masks.append((out_deg[:, None] > degs[-1][None, :]).astype(np.float32).T)
    return masks


def init_made(rng: np.random.Generator, n_dim: int, hidden_sizes: list[int],
              n_params: int, order: np.ndarray):
    """Host-numpy initialization; returns (layer list of {w, b}, masks)."""
    masks = make_masks(make_degrees(n_dim, order, hidden_sizes), n_dim, n_params)
    sizes = [n_dim] + list(hidden_sizes) + [n_dim * n_params]
    params = []
    for l in range(len(masks)):
        fan_in, fan_out = sizes[l], sizes[l + 1]
        if l == len(masks) - 1:
            w = np.zeros((fan_in, fan_out), np.float32)  # identity start
        else:
            w = (np.sqrt(2.0 / fan_in)
                 * rng.standard_normal((fan_in, fan_out))).astype(np.float32)
        params.append({"w": w, "b": np.zeros(fan_out, np.float32)})
    return params, masks


def hidden_stack(ws, bs, x):
    """Shared hidden layers: (n, d) -> (n, h) pre-activation. `ws`/`bs` are
    one transform's masked weights and biases, output layer last."""
    h = x @ ws[0] + bs[0]
    for l in range(1, len(ws) - 1):
        y = torch.relu(h) @ ws[l] + bs[l]
        h = h + y if ws[l].shape[0] == ws[l].shape[1] else y
    return h


def apply_made(ws, bs, x, n_dim: int, n_params: int):
    """Forward pass: (n, d) -> (n, d, n_params)."""
    out = torch.relu(hidden_stack(ws, bs, x)) @ ws[-1] + bs[-1]
    return out.reshape(x.shape[0], n_dim, n_params)


def apply_made_dim(ws, bs, x, dim: int, n_params: int):
    """Pass returning only output dim `dim`'s parameter block: (n, n_params).
    The output layer is sliced to those n_params columns."""
    cols = slice(dim * n_params, (dim + 1) * n_params)
    return torch.relu(hidden_stack(ws, bs, x)) @ ws[-1][:, cols] + bs[-1][cols]
