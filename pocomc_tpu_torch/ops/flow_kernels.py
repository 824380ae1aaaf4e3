"""The two hand-written CUDA kernels of the flow and their plain versions.

K2, ``made_rqs_forward``: the whole NSF transform stack data -> latent in
one launch (every MADE pass, spline forward and log-det), with an
``autograd.Function`` whose backward recomputes through the plain version.
Source: ``csrc/made_rqs_forward.cu``; it replaces the JAX package's Pallas
MADE kernel (``pocomc_tpu/ops/pallas_kernels.py`` ``_made_kernel``, deleted
in 246a898).

K1, ``ar_inverse``: the autoregressive inverse of the whole stack latent ->
data in one launch. Source: ``csrc/ar_inverse.cu``; it replaces the JAX
package's round-2 fused whole-transform inverse (specified in RESULTS.md
"Pallas postmortem" and ``pocomc_tpu/models/flow.py:170-184``).

Both take the MADE weights ALREADY multiplied by their masks, stacked over
transforms: ``ws[l]`` of shape (T, fan_in, fan_out) and ``bs[l]`` of shape
(T, fan_out) for the four layers d -> h -> h -> h -> d*23.

Dispatch is by device and nothing else: a CPU tensor goes to the plain
version (``*_ref``), a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in a plain integer attribute ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import transforms as tr
from ..models.made import apply_made, apply_made_dim
from . import _build

BINS = 8
N_PARAMS = tr.rqs_n_params(BINS)
# largest dynamic shared memory a block may use on Hopper
_MAX_SMEM = 227 * 1024


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def made_rqs_forward_ref(y, ws, bs):
    """Plain forward of the transform stack: y (n, d) -> (z, ladj)."""
    n, d = y.shape
    x = y
    ladj = torch.zeros(n, dtype=y.dtype, device=y.device)
    for t in range(ws[0].shape[0]):
        p = apply_made([w[t] for w in ws], [b[t] for b in bs], x, d, N_PARAMS)
        x, l = tr.rqs_forward(x, p, BINS)
        ladj = ladj + l.sum(-1)
    return x, ladj


def ar_inverse_ref(z, ws, bs, inv_dim_orders):
    """Plain autoregressive inverse: z (n, d) -> (x, ladj), transforms in
    reverse, dimensions of transform t in the order inv_dim_orders[t]."""
    n, d = z.shape
    orders = torch.as_tensor(inv_dim_orders).tolist()
    cols = torch.arange(d, device=z.device)
    ladj = torch.zeros(n, dtype=z.dtype, device=z.device)
    for t in reversed(range(ws[0].shape[0])):
        wt = [w[t] for w in ws]
        bt = [b[t] for b in bs]
        x = torch.zeros_like(z)
        for dim in orders[t]:
            p = apply_made_dim(wt, bt, x, dim, N_PARAMS)
            x_dim, l = tr.rqs_inverse(z[:, dim], p, BINS)
            x = torch.where(cols == dim, x_dim[:, None], x)
            ladj = ladj + l
        z = x
    return z, ladj


# ---------------------------------------------------------------------------
# argument checks and launches
# ---------------------------------------------------------------------------

def _check(x, ws, bs, name):
    """Validate (n, d) input and the stacked masked MADE layers; returns
    (n, d, h, T)."""
    tensors = [x, *ws, *bs]
    if len(ws) != 4 or len(bs) != 4:
        raise ValueError(f"{name}: expects the four MADE layers, got "
                         f"{len(ws)} weights and {len(bs)} biases")
    for a in tensors:
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32 tensors, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name}: tensors on {a.device} and {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if x.dim() != 2:
        raise ValueError(f"{name}: expects an (n, d) input, got {tuple(x.shape)}")
    n, d = x.shape
    T, _, h = ws[0].shape
    want_w = [(T, d, h), (T, h, h), (T, h, h), (T, h, d * N_PARAMS)]
    want_b = [(T, h), (T, h), (T, h), (T, d * N_PARAMS)]
    for a, want in zip(list(ws) + list(bs), want_w + want_b):
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: layer shape {tuple(a.shape)}, expected {want}")
    return n, d, h, T


def _launch_config(n, d, h):
    """(particles per block, threads per block) for a launch."""
    tile = 16 if n >= 4096 else 8
    while tile > 1 and 4 * tile * (2 * d + 2 * h + N_PARAMS + 1) > _MAX_SMEM:
        tile //= 2
    return tile, (256 if h >= 128 else 128)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry(lib_name, fn_name, n_ptr_tail):
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = [_P] * 3 + [_I] * 4 + [_P] * (8 + n_ptr_tail) + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def _raise_if(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _launch_forward(y, ws, bs):
    n, d, h, T = _check(y, ws, bs, "made_rqs_forward")
    z = torch.empty_like(y)
    ladj = torch.empty(n, dtype=y.dtype, device=y.device)
    if n == 0:
        return z, ladj
    tile, threads = _launch_config(n, d, h)
    fn = _entry("made_rqs_forward", "made_rqs_forward_launch", 0)
    weights = [a.data_ptr() for pair in zip(ws, bs) for a in pair]
    err = fn(y.data_ptr(), z.data_ptr(), ladj.data_ptr(), n, d, h, T, *weights,
             tile, threads, y.device.index, torch.cuda.current_stream(y.device).cuda_stream)
    _raise_if(err, "made_rqs_forward")
    made_rqs_forward.launches += 1
    return z, ladj


def _launch_inverse(z, ws, bs, inv_dim_orders):
    n, d, h, T = _check(z, ws, bs, "ar_inverse")
    if (inv_dim_orders.dtype != torch.int32 or inv_dim_orders.device != z.device
            or tuple(inv_dim_orders.shape) != (T, d)
            or not inv_dim_orders.is_contiguous()):
        raise ValueError("ar_inverse: inv_dim_orders must be a contiguous (T, d) "
                         "int32 tensor on the input's device")
    x = torch.empty_like(z)
    ladj = torch.empty(n, dtype=z.dtype, device=z.device)
    if n == 0:
        return x, ladj
    tile, threads = _launch_config(n, d, h)
    fn = _entry("ar_inverse", "ar_inverse_launch", 1)
    weights = [a.data_ptr() for pair in zip(ws, bs) for a in pair]
    err = fn(z.data_ptr(), x.data_ptr(), ladj.data_ptr(), n, d, h, T, *weights,
             inv_dim_orders.data_ptr(), tile, threads, z.device.index,
             torch.cuda.current_stream(z.device).cuda_stream)
    _raise_if(err, "ar_inverse")
    ar_inverse.launches += 1
    return x, ladj


class _MadeRqsForward(torch.autograd.Function):
    """K2 forward; the backward recomputes through the plain version (as
    the Pallas ancestor's custom VJP re-ran XLA) and returns the input,
    weight and bias gradients. Mask gradients follow through w * mask,
    which the caller formed in torch."""

    @staticmethod
    def forward(ctx, y, *layers):
        ctx.save_for_backward(y, *layers)
        return _launch_forward(y, layers[:4], layers[4:])

    @staticmethod
    def backward(ctx, g_z, g_ladj):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inp = [a.detach().requires_grad_(need)
                   for a, need in zip(saved, ctx.needs_input_grad)]
            z, ladj = made_rqs_forward_ref(inp[0], inp[1:5], inp[5:9])
            wanted = [a for a in inp if a.requires_grad]
            grads = iter(torch.autograd.grad((z, ladj), wanted, (g_z, g_ladj),
                                             allow_unused=True))
        return tuple(next(grads) if a.requires_grad else None for a in inp)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def made_rqs_forward(y, ws, bs):
    """K2: (z, ladj) of the transform stack at y; ladj = log|det dz/dy|."""
    ws, bs = list(ws), list(bs)
    if y.device.type == "cpu":
        _check(y, ws, bs, "made_rqs_forward")
        return made_rqs_forward_ref(y, ws, bs)
    if y.device.type != "cuda":
        raise ValueError(f"made_rqs_forward: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in [y, *ws, *bs]):
        return _MadeRqsForward.apply(y, *ws, *bs)
    return _launch_forward(y, ws, bs)


def ar_inverse(z, ws, bs, inv_dim_orders):
    """K1: (x, ladj) of the autoregressive inverse; ladj = log|det dx/dz|."""
    ws, bs = list(ws), list(bs)
    if z.device.type == "cpu":
        _check(z, ws, bs, "ar_inverse")
        return ar_inverse_ref(z, ws, bs, inv_dim_orders)
    if z.device.type != "cuda":
        raise ValueError(f"ar_inverse: unsupported device {z.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in [z, *ws, *bs]):
        raise NotImplementedError("ar_inverse: the CUDA kernel has no gradient")
    return _launch_inverse(z, ws, bs, inv_dim_orders)


made_rqs_forward.launches = 0
ar_inverse.launches = 0
