"""gauss50's likelihood: a 50-D correlated Gaussian, eigenvalues
logspace(0, 3, 50), eigenvectors the Q of a QR of default_rng(0) normals
(``benchmarks/baseline_configs.py:119-135``), under N(0, 100^2) priors.
Plain torch in any dtype: the program runs it in float32, the reference in
float64 and the control in bfloat16."""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import multivariate_normal


class Likelihood:
    def __init__(self, cfg):
        d = int(cfg["n_dim"])
        spec = cfg["likelihood"]
        lo, hi = spec["log10_eigenvalues"]
        rng = np.random.default_rng(int(spec["q_seed"]))
        evals = np.logspace(lo, hi, d)
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        self.cov = (q * evals) @ q.T
        self.cov_inv = np.linalg.inv(self.cov)
        self.norm_const = -0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(self.cov)[1])
        self._cache = {}

    def __call__(self, x):
        key = (x.dtype, x.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.cov_inv, dtype=x.dtype, device=x.device)
        ci = self._cache[key]
        return self.norm_const - 0.5 * torch.einsum("ni,ij,nj->n", x, ci, x)


def truth(cfg):
    """The analytic log-evidence: N(0; 0, C + s^2 I)."""
    like = Likelihood(cfg)
    d, s = int(cfg["n_dim"]), float(cfg["prior"]["scale"])
    return float(multivariate_normal.logpdf(np.zeros(d), np.zeros(d), like.cov + s * s * np.eye(d)))
