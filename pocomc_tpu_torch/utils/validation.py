"""Input-validation helpers (copied from ``pocomc_tpu/utils/validation.py``)."""

from __future__ import annotations

import numpy as np


def assert_array_2d(x):
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"Expected a 2-D array, got ndim={x.ndim}.")
    return x


def assert_array_float(x):
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        raise ValueError(f"Expected a float array, got dtype={x.dtype}.")
    return x


def assert_array_finite(x):
    x = np.asarray(x)
    if not np.isfinite(x).all():
        raise ValueError("Array contains non-finite values.")
    return x


def assert_array_within_interval(x, low, high):
    x = np.asarray(x)
    if np.any(x < low) or np.any(x > high):
        raise ValueError("Array values fall outside the given interval.")
    return x
