"""The operations and bytes of the flow kernels, from their shapes.

Frozen copies of chip_smoke.py's ``made_bounds`` and ``coupling_bounds``
(the same counting, written from the flows' published structure, so that
it needs no flow object): the flops of the dense products over the weights
the MADE masks leave (the spline's own arithmetic is left out); each input
read and each output written once, the weights and biases once. The
backward takes the saved layer inputs, g_z, g_ladj and the weights, gives
g_y and the weight and bias gradients, and runs the output layer's product
again, the products back through the four layers and the weight-gradient
products.
"""

from __future__ import annotations

import functools

ARCHS = {"nsf3": ("nsf", 3), "nsf6": ("nsf", 6), "nsf12": ("nsf", 12),
         "nsfc3": ("nsfc", 3), "nsfc6": ("nsfc", 6), "nsfc12": ("nsfc", 12)}


def n_hidden(d):
    """max(next power of two of 3d, 32)."""
    return max(1 << max(3 * d - 1, 0).bit_length(), 32)


def made_macs(d, h, T):
    """Multiply-adds a row of each of the four MADE layers, summed over the
    T transforms: the entries the masks leave (degrees: inputs 1..d in
    each transform's order, hidden units cycling through 1..max(1, d-1);
    >= into the hidden layers, > into the output, n_params columns a
    dimension, counted per parameter column by ``made_counts``)."""
    hid = [k % max(1, d - 1) + 1 for k in range(h)]
    inp = list(range(1, d + 1))
    first = sum(1 for a in hid for b in inp if a >= b)
    square = sum(1 for a in hid for b in hid if a >= b)
    out = sum(1 for a in inp for b in hid if a > b)
    return [T * first, T * square, T * square, T * out]


@functools.lru_cache(maxsize=None)
def made_counts(d, bins, flow="nsf6"):
    """(macs per layer with the output layer at n_params columns a
    dimension, h, T, n_params)."""
    _, T = ARCHS[flow]
    h = n_hidden(d)
    npar = 3 * bins - 1
    macs = made_macs(d, h, T)
    macs[3] *= npar
    return tuple(macs), h, T, npar


def made_bounds(n, d, bins=8, flow="nsf6"):
    """(flops, bytes) of K2's forward, K2's backward and K1 at n rows."""
    macs, h, T, npar = made_counts(d, bins, flow)
    total = sum(macs)
    weights = 4 * (total + T * (3 * h + npar * d))
    return {"made_rqs_forward": (2 * n * total, 4 * (2 * n * d + n) + weights),
            "made_rqs_backward": (n * (4 * total + 2 * macs[3]),
                                  4 * (T * n * (d + 3 * h) + 2 * n * d + n) + 2 * weights),
            "ar_inverse": (2 * n * total, 4 * (2 * n * d + n + T * d) + weights)}


@functools.lru_cache(maxsize=None)
def coupling_counts(d, bins, flow="nsfc12"):
    """(macs per layer summed over the transforms, the parameter count, h,
    T): transform t conditions on ceil(d/2) dimensions (t even) or
    floor(d/2) (t odd) and maps the others, n_params a dimension."""
    _, T = ARCHS[flow]
    h = n_hidden(d)
    npar = 3 * bins - 1
    macs, params = [0, 0, 0, 0], 0
    for t in range(T):
        cond = (d + 1) // 2 if t % 2 == 0 else d // 2
        outs = (d - cond) * npar
        shapes = [(max(cond, 1), h), (h, h), (h, h), (h, outs)]
        for l, (a, b) in enumerate(shapes):
            macs[l] += a * b
            params += a * b + b
    return tuple(macs), params, h, T


def coupling_bounds(n, d, bins=8, flow="nsfc12"):
    """(flops, bytes) of K5's forward, inverse and backward at n rows."""
    macs, params, h, T = coupling_counts(d, bins, flow)
    total = sum(macs)
    weights = 4 * params
    one = (2 * n * total, 4 * (2 * n * d + n) + weights)
    return {"coupling_forward": one, "coupling_inverse": one,
            "coupling_backward": (n * (4 * total + 2 * macs[3]),
                                  4 * (T * n * (d + 3 * h) + 2 * n * d + n) + 2 * weights)}
