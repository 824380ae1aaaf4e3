"""Resampling schemes (systematic and multinomial).

Counterpart of ``pocomc_tpu/ops/resampling.py``: the host numpy versions
unchanged, and on-device torch versions (searchsorted over the weight
cumsum, against stratified or iid uniforms from a ``torch.Generator``).
"""

from __future__ import annotations

import numpy as np
import torch


def systematic_resample(size: int, weights: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    """Systematic resampling: one uniform offset, stratified positions."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    if rng is None:
        rng = np.random.default_rng()
    positions = (rng.random() + np.arange(size)) / size
    csum = np.cumsum(w)
    csum[-1] = 1.0  # guard against round-off
    return np.searchsorted(csum, positions, side="right").clip(0, len(w) - 1)


def multinomial_resample(size: int, weights: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    """Multinomial resampling: size iid draws from the weight distribution."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    if rng is None:
        rng = np.random.default_rng()
    return rng.choice(len(w), size=size, replace=True, p=w)


def _search(weights, positions):
    w = weights / weights.sum()
    csum = torch.cumsum(w, 0)
    csum[-1:].fill_(1.0)  # a scalar assigned by index is a copy that waits for the card
    idx = torch.searchsorted(csum, positions.to(csum.dtype), right=True)
    return torch.clamp(idx, 0, weights.shape[0] - 1)


def systematic_resample_torch(size: int, weights: torch.Tensor, generator=None,
                              u0=None) -> torch.Tensor:
    """Device systematic resampling; ``u0`` (a scalar in [0, 1)) may be
    given instead of drawing it from ``generator``."""
    if u0 is None:
        u0 = torch.rand((), generator=generator, device=weights.device)
    pos = (u0 + torch.arange(size, device=weights.device, dtype=weights.dtype)) / size
    return _search(weights, pos)


def multinomial_resample_torch(size: int, weights: torch.Tensor, generator=None,
                               u=None) -> torch.Tensor:
    """Device multinomial resampling by inverse CDF; ``u`` (size,) uniforms
    may be given instead of drawing them from ``generator``."""
    if u is None:
        u = torch.rand(size, generator=generator, device=weights.device,
                       dtype=weights.dtype)
    return _search(weights, u)
