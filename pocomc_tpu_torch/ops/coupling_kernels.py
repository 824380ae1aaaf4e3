"""K5: the hand-written CUDA kernels of the coupling spline flows (nsfc*)
and their plain versions.

``coupling_forward`` (data -> latent) and ``coupling_inverse`` (latent ->
data): a whole stack of T coupling transforms in one launch, each a
residual MLP on the conditioning half and the 8-bin spline on the other
half (``csrc/coupling_forward.cu``, templated on the direction);
``coupling_backward``: one launch back through the stack from the layer
inputs the forward saved, then the weight gradients as batched products
of those inputs and the deltas it writes (``csrc/coupling_backward.cu``).
``_CouplingForward`` joins the two as an ``autograd.Function``. They
replace no Pallas kernel: the JAX package runs coupling flows as XLA code
(``pocomc_tpu/models/coupling.py``).

The weights are the JAX package's per-transform layout: ``ws[t]`` and
``bs[t]`` the four weights (K, N) and biases (N,) of transform t, for
n_cond_t -> h -> h -> h -> n_trans_t*23, and ``masks[t]`` its boolean
conditioning mask (``models/coupling.py make_coupling_masks``; the kernels
take the alternating halves that function lays out).

Dispatch is by device and nothing else: a CPU tensor goes to the plain
version (``*_ref``), a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in a plain integer attribute ``launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import transforms as tr
from ..models.coupling import BINS, coupling_forward as _transform_forward, \
    coupling_inverse as _transform_inverse, halves, layer_inputs, make_coupling_masks
from .flow_kernels import (N_PARAMS, _check_saved, _device_type, _entry, _k2_config,
                           _raise_if, _stream)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def coupling_forward_ref(x, ws, bs, masks, save_inputs=False):
    """Plain forward of the stack: x (n, d) -> (z, ladj), transforms
    0..T-1, plus, when ``save_inputs``, the input of every layer's product
    in every transform: [x_t (T, n, d), relu(h0), relu(h1), relu(h2) (T, n,
    h)], the kernel's layout (x_t the whole row; layer 0 reads its
    conditioning columns)."""
    ladj = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    saved = [[] for _ in range(4)]
    for t in range(len(ws)):
        if save_inputs:
            cond, _ = halves(masks[t], x.device)
            acts = layer_inputs(ws[t], bs[t], x[:, cond])
            for s, a in zip(saved, [x] + acts[1:]):
                s.append(a)
        x, l = _transform_forward(ws[t], bs[t], masks[t], x)
        ladj = ladj + l
    return (x, ladj, [torch.stack(s) for s in saved]) if save_inputs else (x, ladj)


def coupling_inverse_ref(z, ws, bs, masks):
    """Plain inverse of the stack: z (n, d) -> (x, ladj), transforms
    T-1..0, one pass each; ladj = log|det dx/dz|."""
    ladj = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for t in reversed(range(len(ws))):
        z, l = _transform_inverse(ws[t], bs[t], masks[t], z)
        ladj = ladj + l
    return z, ladj


def coupling_backward_ref(x, ws, bs, masks, g_z, g_ladj, acts=None):
    """Plain backward of the stack, with no autograd: the gradients (g_x,
    g_ws, g_bs) of a loss with dL/dz = g_z (n, d) and dL/dladj = g_ladj
    (n,), for the input and every transform's weights and biases (lists of
    T lists of 4). ``acts`` are the layer inputs ``coupling_forward_ref(...,
    save_inputs=True)`` returns (computed when None). The kernel's
    closed-form derivatives (``csrc/coupling_backward.cu``): transforms in
    reverse, the spline parameters from relu(h2), the spline's VJP on the
    transformed columns, delta @ W^T back through the output, residual and
    input layers; a conditioning column's gradient is the net's plus the
    pass-through, a transformed column's the spline's own; the weight
    gradients are A^T @ delta of each layer's input and output delta."""
    n = x.shape[0]
    if acts is None:
        acts = coupling_forward_ref(x, ws, bs, masks, save_inputs=True)[2]
    g_ws, g_bs = [None] * len(ws), [None] * len(ws)
    g_x = g_z
    for t in reversed(range(len(ws))):
        w = ws[t]
        cond, trans = halves(masks[t], x.device)
        a = [acts[0][t][:, cond], acts[1][t], acts[2][t], acts[3][t]]
        p = (a[3] @ w[3] + bs[t][3]).reshape(n, trans.numel(), N_PARAMS)
        g_dir, g_p = tr.rqs_forward_vjp(acts[0][t][:, trans], p, g_x[:, trans],
                                        g_ladj[:, None].expand(n, trans.numel()), BINS)
        g3 = g_p.reshape(n, -1)
        g2 = (g3 @ w[3].T) * (a[3] > 0)
        g1 = g2 + (g2 @ w[2].T) * (a[2] > 0)
        g0 = g1 + (g1 @ w[1].T) * (a[1] > 0)
        g_prev = g_x.clone()
        g_prev[:, cond] = g0 @ w[0].T + g_x[:, cond]
        g_prev[:, trans] = g_dir
        g_x = g_prev
        deltas = (g0, g1, g2, g3)
        g_ws[t] = [a_l.T @ g for a_l, g in zip(a, deltas)]
        g_bs[t] = [g.sum(0) for g in deltas]
    return g_x, g_ws, g_bs


# ---------------------------------------------------------------------------
# argument checks and launches
# ---------------------------------------------------------------------------

def _check(x, ws, bs, masks, name):
    """Validate (n, d) input, T transforms of four layers each and their
    masks; returns (n, d, h, T)."""
    if x.dim() != 2:
        raise ValueError(f"{name}: expects an (n, d) input, got {tuple(x.shape)}")
    n, d = x.shape
    T = len(ws)
    if T < 1 or len(bs) != T or len(masks) != T:
        raise ValueError(f"{name}: {T} weight lists, {len(bs)} bias lists, {len(masks)} masks")
    for t in range(T):
        if len(ws[t]) != 4 or len(bs[t]) != 4 or np.shape(masks[t]) != (d,):
            raise ValueError(f"{name}: transform {t} needs four layers and a ({d},) mask")
    h = ws[0][1].shape[0]
    for t in range(T):
        n_cond = int(np.sum(masks[t]))
        want_w = [(max(n_cond, 1), h), (h, h), (h, h), (h, (d - n_cond) * N_PARAMS)]
        for a, want in zip([*ws[t], *bs[t]], want_w + [(k[1],) for k in want_w]):
            if tuple(a.shape) != want:
                raise ValueError(f"{name}: transform {t} layer shape {tuple(a.shape)}, "
                                 f"expected {want}")
            if a.dtype != torch.float32 or a.device != x.device or not a.is_contiguous():
                raise ValueError(f"{name}: expects contiguous float32 tensors on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous float32 input")
    return n, d, h, T


def _check_kernel_layout(masks, d, T, name):
    """The kernels derive the halves from d and t: the masks must be
    ``make_coupling_masks(d, T)``'s."""
    if d < 2 or not all(np.array_equal(m, k) for m, k in zip(masks, make_coupling_masks(d, T))):
        raise ValueError(f"{name}: the CUDA kernel takes the alternating halves of "
                         f"make_coupling_masks(d, T) at d >= 2")


@functools.lru_cache(maxsize=64)
def _table(device_index, ptrs):
    """The device table of the transforms' weight and bias pointers that
    the kernels read (w0 b0 w1 b1 w2 b2 w3 b3 of each transform); cached
    by the pointers themselves, so it is always the one they spell."""
    return torch.tensor(ptrs, dtype=torch.int64, device=torch.device("cuda", device_index))


def _pointers(ws, bs, device):
    return _table(device.index, tuple(a.data_ptr() for t in range(len(ws))
                                      for pair in zip(ws[t], bs[t]) for a in pair))


def _launch_stack(x, ws, bs, masks, inverse, save_inputs, name):
    n, d, h, T = _check(x, ws, bs, masks, name)
    _check_kernel_layout(masks, d, T, name)
    out = torch.empty_like(x)
    ladj = torch.empty(n, dtype=x.dtype, device=x.device)
    acts = ([torch.empty(T, n, k, dtype=x.dtype, device=x.device) for k in (d, h, h, h)]
            if save_inputs else None)
    if n > 0:
        P, G, SL = _k2_config(n, d, h, False, N_PARAMS, (d + 1) // 2)
        fn = _entry("coupling_forward", "coupling_forward_launch", "PPPIIIIPPPPPIIIIIP")
        saved = [a.data_ptr() for a in acts] if save_inputs else [None] * 4
        err = fn(x.data_ptr(), out.data_ptr(), ladj.data_ptr(), n, d, h, T,
                 _pointers(ws, bs, x.device).data_ptr(), *saved, int(inverse), P, G, SL,
                 x.device.index, _stream(x))
        _raise_if(err, name)
        wrapper = coupling_inverse if inverse else coupling_forward
        wrapper.launches += 1
    return (out, ladj, acts) if save_inputs else (out, ladj)


def _launch_backward(acts, ws, bs, masks, g_z, g_ladj):
    """K5's backward kernel, then the weight gradients A^T @ delta of the
    saved layer inputs and its deltas with batched fp32 products over the T
    transforms (layer 0's over the whole saved row, then each transform's
    conditioning rows; the output layer's over the widest half, then each
    transform's columns), and the bias gradients as row sums."""
    name = "coupling_backward"
    if len(acts) != 4:
        raise ValueError(f"{name}: expects the four saved layer inputs, got {len(acts)}")
    _, d, h, T = _check(acts[0][0], ws, bs, masks, name)
    _check_kernel_layout(masks, d, T, name)
    _, n = _check_saved(name, acts, g_z, g_ladj, (d, h, h, h))
    dev = acts[0].device
    g_x = torch.empty_like(g_z)
    half = (d + 1) // 2
    deltas = [torch.empty(T, n, k, dtype=g_z.dtype, device=dev)
              for k in (h, h, h, half * N_PARAMS)]
    if n > 0:
        P, G, SL = _k2_config(n, d, h, True, N_PARAMS, half)
        fn = _entry("coupling_backward", "coupling_backward_launch", "PPPPPPPIIIIPPPPPIIIIP")
        err = fn(*[a.data_ptr() for a in acts], g_z.data_ptr(), g_ladj.data_ptr(),
                 g_x.data_ptr(), n, d, h, T, _pointers(ws, bs, dev).data_ptr(),
                 *[g.data_ptr() for g in deltas], P, G, SL, dev.index, _stream(g_z))
        _raise_if(err, name)
        coupling_backward.launches += 1
    full_w = [torch.bmm(a.transpose(1, 2), g) for a, g in zip(acts, deltas)]
    full_b = [g.sum(1) for g in deltas]
    g_ws, g_bs = [], []
    for t in range(T):
        cond = np.flatnonzero(masks[t])
        rows = slice(int(cond[0]), int(cond[-1]) + 1)
        cols = slice(0, ws[t][3].shape[1])
        g_ws.append([full_w[0][t, rows], full_w[1][t], full_w[2][t], full_w[3][t][:, cols]])
        g_bs.append([full_b[0][t], full_b[1][t], full_b[2][t], full_b[3][t, cols]])
    return g_x, g_ws, g_bs


def _nest(flat, T):
    return [list(flat[4 * t:4 * t + 4]) for t in range(T)]


class _CouplingForward(torch.autograd.Function):
    """K5 forward with its gradient: the forward kernel saves every layer's
    input, the backward kernel takes them (``coupling_backward``). Inputs:
    the masks, x, then the 4T weights and the 4T biases, transform-major."""

    @staticmethod
    def forward(ctx, masks, x, *layers):
        T = len(masks)
        ws, bs = _nest(layers[:4 * T], T), _nest(layers[4 * T:], T)
        z, ladj, acts = _launch_stack(x, ws, bs, masks, False, True, "coupling_forward")
        ctx.masks = masks
        ctx.save_for_backward(*acts, *layers)
        return z, ladj

    @staticmethod
    def backward(ctx, g_z, g_ladj):
        saved = ctx.saved_tensors
        T = len(ctx.masks)
        layers = saved[4:]
        g_x, g_ws, g_bs = _launch_backward(saved[:4], _nest(layers[:4 * T], T),
                                           _nest(layers[4 * T:], T), ctx.masks,
                                           g_z.contiguous(), g_ladj.contiguous())
        grads = [g_x, *[g for gt in g_ws for g in gt], *[g for gt in g_bs for g in gt]]
        return (None, *(g if need else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])))


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _flat(ws, bs):
    return [a for t in ws for a in t] + [a for t in bs for a in t]


def coupling_forward(x, ws, bs, masks, save_inputs=False):
    """K5: (z, ladj) of the coupling stack at x; ladj = log|det dz/dx|.
    Differentiable on CUDA through the backward kernel. ``save_inputs``
    also returns the input of every layer's product in every transform,
    which ``coupling_backward`` takes (no gradient then)."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    if _device_type(x, "coupling_forward") == "cpu":
        _check(x, ws, bs, masks, "coupling_forward")
        return coupling_forward_ref(x, ws, bs, masks, save_inputs)
    if (not save_inputs and torch.is_grad_enabled()
            and any(a.requires_grad for a in [x, *_flat(ws, bs)])):
        return _CouplingForward.apply(list(masks), x, *_flat(ws, bs))
    with torch.no_grad():
        return _launch_stack(x, ws, bs, masks, False, save_inputs, "coupling_forward")


def coupling_inverse(z, ws, bs, masks):
    """K5 inverse: (x, ladj) of the coupling stack at z, one pass a
    transform; ladj = log|det dx/dz|. The conditioning columns of each
    transform pass through bit for bit."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    if _device_type(z, "coupling_inverse") == "cpu":
        _check(z, ws, bs, masks, "coupling_inverse")
        return coupling_inverse_ref(z, ws, bs, masks)
    if torch.is_grad_enabled() and any(a.requires_grad for a in [z, *_flat(ws, bs)]):
        raise NotImplementedError("coupling_inverse: the CUDA kernel has no gradient")
    return _launch_stack(z, ws, bs, masks, True, False, "coupling_inverse")


def coupling_backward(x, ws, bs, masks, g_z, g_ladj, acts=None):
    """K5's backward: (g_x, g_ws, g_bs), the gradients of a loss with dL/dz
    = g_z and dL/dladj = g_ladj with respect to x and every transform's
    weights and biases. ``acts`` are the layer inputs that
    ``coupling_forward(..., save_inputs=True)`` returns; the plain version
    computes them when None, the CUDA route needs them."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    if _device_type(x, "coupling_backward") == "cpu":
        _check(x, ws, bs, masks, "coupling_backward")
        return coupling_backward_ref(x, ws, bs, masks, g_z, g_ladj, acts)
    if acts is None:
        raise ValueError("coupling_backward: on CUDA it takes acts, the layer inputs "
                         "that coupling_forward(..., save_inputs=True) returns")
    with torch.no_grad():
        return _launch_backward(list(acts), ws, bs, masks, g_z, g_ladj)


coupling_forward.launches = 0
coupling_inverse.launches = 0
coupling_backward.launches = 0
