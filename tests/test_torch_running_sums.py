"""The plain spline's compensated knots past 16 bins, bit for bit.

Past ``COMPENSATED_PAST`` bins the port's plain spline takes the CUDA
kernels' knots (``csrc/rqs.cuh`` ``find_bin``): Kahan running sums of the
bin sizes, k ascending, each knot with what its float32 sum left over.
``transforms._running_sums`` computes them in float32; here the same loop
is written out in numpy, step by step, and every knot, every leftover and
the knots ``_knots`` returns must equal its bits. The inputs are seeded
batches of raw parameters, stacked as ``_bin`` stacks the two softmaxes."""

import numpy as np
import pytest
import torch

from pocomc_tpu_torch.models import transforms as tr

B = np.float32(tr.SPLINE_BOUND)


def numpy_kahan(sizes):
    """Knots (..., bins + 1) and leftovers (..., bins + 1) of float32 sizes
    (..., bins): the knot j (1..bins-1) is the Kahan sum of sizes 0..j-1
    less B, the ends -B and B; the leftover of knot j is the Kahan sum's
    compensation after that size, 0 at either end."""
    v = np.moveaxis(sizes[..., :-1], -1, 0).astype(np.float32)
    knots = np.empty(v.shape, np.float32)
    left = np.empty(v.shape, np.float32)
    acc = np.zeros(v.shape[1:], np.float32)
    comp = np.zeros(v.shape[1:], np.float32)
    for j in range(v.shape[0]):
        y = v[j] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
        knots[j] = acc - B
        left[j] = comp
    ends = np.full(sizes.shape[:-1] + (1,), B, np.float32)
    zero = np.zeros_like(ends)
    return (np.concatenate([-ends, np.moveaxis(knots, 0, -1), ends], -1),
            np.concatenate([zero, np.moveaxis(left, 0, -1), zero], -1))


def raw_batch(bins, seed, shape=(2, 64, 3)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((1.5 * rng.standard_normal(shape + (bins,))).astype(np.float32))


def bits(t):
    return np.asarray(t.detach().numpy(), np.float32).view(np.uint32)


@pytest.mark.parametrize("bins", [17, 32, 1000])
def test_running_sums_are_the_numpy_kahan_loop(bins):
    """``_running_sums`` of float32 sizes: its knots and leftovers equal
    the numpy loop's bit for bit, and ``_knots`` is the knots less their
    leftovers, each rounded once."""
    raw = raw_batch(bins, bins)
    sizes = tr._sizes(raw)
    knots, left = tr._running_sums(sizes)
    want_k, want_c = numpy_kahan(sizes.numpy())
    assert knots.dtype == torch.float32 and knots.shape == raw.shape[:-1] + (bins + 1,)
    np.testing.assert_array_equal(bits(knots), want_k.view(np.uint32))
    np.testing.assert_array_equal(bits(left), want_c.view(np.uint32))
    assert np.any(want_c != 0)  # the compensation is not idle at these bins
    np.testing.assert_array_equal(bits(tr._knots(raw)), (want_k - want_c).view(np.uint32))


@pytest.mark.parametrize("bins", [17, 1000])
def test_running_sums_keep_the_running_sums_gradient(bins):
    """The knots' gradient is the plain running sum's (the compensation is
    a constant of the backward): autograd through ``_running_sums`` equals
    autograd through ``torch.cumsum`` of the same sizes."""
    raw = raw_batch(bins, bins + 1, (16, 2))
    sizes = tr._sizes(raw).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(bins).standard_normal(
        raw.shape[:-1] + (bins + 1,)).astype(np.float32))
    knots, _ = tr._running_sums(sizes)
    got, = torch.autograd.grad(knots, sizes, g)
    plain = torch.cat([torch.zeros_like(sizes[..., :1]), torch.cumsum(sizes[..., :-1], -1),
                       torch.zeros_like(sizes[..., :1])], -1)
    want, = torch.autograd.grad(plain, sizes, g)
    assert torch.equal(got, want)


def test_float64_sums_are_plain():
    """In float64 (the references) the knots are a plain running sum and
    every leftover is 0."""
    sizes = tr._sizes(raw_batch(32, 7).double())
    knots, left = tr._running_sums(sizes)
    assert torch.equal(left, torch.zeros_like(left))
    assert torch.equal(knots[..., 1:-1], torch.cumsum(sizes[..., :-1], -1) - tr.SPLINE_BOUND)
