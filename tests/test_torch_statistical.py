"""The JAX package's preconditioned known answers on the port, on the CPU:
``tests/test_statistical.py``'s bimodal mixture (mode mass and logZ) and
Neal's funnel with fixed data (E[v], SD[v] and logZ), at that test's
settings, seed and gates. The problems, their truths and the runs are
``chip_smoke.statistical``'s, which phase 17 drives on the card through
the kernels; here every wrapper runs its plain version."""

import math

import numpy as np
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu_torch as tpc
from chip_smoke import funnel, mixture, statistical


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rows, failed = statistical(tpc, "cpu")
    finally:
        torch.set_num_threads(n)
    return {row["run"]: row for row in rows}, failed


def test_truths_match_the_jax_test():
    """The problems' truths are test_statistical's: the mixture's logZ and
    mode mass in closed form, the funnel's by its quadrature; the funnel's
    likelihood is the JAX test's formula (checked at three points in
    float64)."""
    like, logz, mass = mixture()
    var = 0.25 + 100.0
    z1 = 0.6 * math.exp(-0.5 * 2 * 16.0 / var) / (2 * math.pi * var)
    assert math.isclose(logz, math.log(z1 / 0.6), rel_tol=1e-12) and mass == 0.6
    fn, (loc, scale), half, logz_f, v_mean, v_sd = funnel()
    assert (loc, scale, half) == (0.0, 2.0, 30.0)
    x = np.array([[0.3, 1.0, -0.5], [-2.0, 0.1, 0.2], [1.5, -3.0, 2.5]])
    v, y = x[:, 0], x[:, 1:]
    want = (norm.logpdf(y, 0, np.sqrt(np.exp(v))[:, None]).sum(1)
            + norm.logpdf(np.array([1.2, -0.8]), y, 0.5).sum(1))
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, rtol=1e-12)
    assert np.isfinite([logz_f, v_mean, v_sd]).all() and v_sd > 0


def test_bimodal_mixture_mode_mass(runs):
    """tests/test_statistical.py:43-75: logZ within max(4 err, 0.15), the
    mode at +4 carrying its mass 0.6 within 0.1."""
    rows, failed = runs
    row = rows["mixture"]
    assert not [f for f in failed if f.startswith("mixture")], (failed, row)
    assert abs(row["mode_mass"] - 0.6) < 0.1


def test_funnel_fixed_data(runs):
    """tests/test_statistical.py:78-140: E[v] within 0.35, SD[v] within 35 %
    and logZ within max(4 err, 0.35) of the quadrature."""
    rows, failed = runs
    row = rows["funnel"]
    assert not [f for f in failed if f.startswith("funnel")], (failed, row)
    assert abs(row["v_mean"] - row["true_v_mean"]) <= 0.35
