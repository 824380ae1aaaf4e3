"""The hand-written CUDA kernels of the masked autoregressive flows and
their plain versions.

K2, ``made_rqs_forward``: the whole transform stack data -> latent in
one launch (every MADE pass, element transform and log-det), and its gradient
``made_rqs_backward``: one launch back through the stack from the layer
inputs the forward saved (K5's backward kernel on the MADE network, after
a kernel that packs the masked weights for its bulk copies), then the
weight gradients as batched products of those inputs and the deltas it
writes. ``_MadeRqsForward`` joins the two as an ``autograd.Function``.
Sources: ``csrc/made_rqs_forward.cu`` (with ``made_tile.cuh``),
``csrc/made_rqs_backward.cu`` (with ``stack_backward.cuh`` and
``coupling_tile.cuh``, K5's); they replace the JAX package's Pallas MADE kernel
(``pocomc_tpu/ops/pallas_kernels.py`` ``_made_kernel``, deleted in 246a898)
and the XLA gradient of its training loss.

K1, ``ar_inverse``: the autoregressive inverse of the whole stack latent ->
data in one launch, each hidden unit computed once, at the step where its
degree makes it final. Source: ``csrc/ar_inverse.cu``; it replaces the JAX
package's round-2 fused whole-transform inverse (specified in RESULTS.md
"Pallas postmortem" and ``pocomc_tpu/models/flow.py:170-184``).
``ar_inverse_backward`` (K1-bwd): its gradient in z, K1's degree walk in
reverse over the state a save instance of K1 wrote (each step's head
parameters and x, each transform's hidden signs); source
``csrc/ar_inverse_backward.cu`` (with ``ar_walk.cuh``, which K1 shares).
``_ArInverse`` joins the two as an ``autograd.Function``; neither gives a
gradient in the weights (the JAX package takes one in the state only,
``pocomc_tpu/mcmc.py:347-354``).

All take the MADE weights ALREADY multiplied by their masks, stacked over
transforms: ``ws[l]`` of shape (T, fan_in, fan_out) and ``bs[l]`` of shape
(T, fan_out) for the four layers d -> h -> h -> h -> d*NP, and the head:
``"rqs"``, the spline of the nsf* flows with ``bins`` bins (NP = 3 bins -
1: 23 at the default 8), or ``"affine"``, the affine map of the maf* flows
(NP = 2; it ignores ``bins``). The kernels take the head as a template
parameter (``csrc/heads.cuh``); the spline's bins are a compile-time
constant up to ``FIXED_BINS`` (16; one library a source and bins, the
default one with the affine head too) and a run-time value past it (one
library a source for every bins > 16, whose spline streams over a
dimension's parameters where the kernel keeps them: ``csrc/rqs.cuh``),
each built at its first use (``_build``). Both routes take any bins >= 2
(``check_bins``).

Dispatch is by device and nothing else: a CPU tensor goes to the plain
version (``*_ref``), a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in plain integer attributes: ``launches``
with the 8-bin spline head, ``launches_b<bins>`` with the spline of other
bins (``launches_b16``, ``launches_b32``; ``zero_counts`` resets every
one a wrapper has), ``launches_affine`` with the affine one. Each call is
also a span (``utils/trace.py``): ``k2`` and ``k1`` at the public
wrappers (both routes), ``k2bwd`` and ``k1bwd`` at the backward launches
(which the autograd Functions call directly).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import transforms as tr
from ..models.made import apply_made_dim
from ..utils import trace
from . import _build

# the spline's default bins, and the most a library of compile-time bins
# takes (past it, the library of run-time bins)
BINS = 8
FIXED_BINS = 16
N_PARAMS = tr.rqs_n_params(BINS)
# raw parameters a dimension of each head at the default bins
HEADS = {"rqs": N_PARAMS, "affine": tr.AFFINE_N_PARAMS}
# largest dynamic shared memory a block may use on Hopper
_MAX_SMEM = 227 * 1024


def check_bins(bins):
    """Refuse spline bins fewer than 2 (ValueError; the plain spline has
    no interior knot to move). Every route takes every other bins: the
    CUDA kernels those of the plain version (2-16 compiled, more at run
    time: ``lib_bins``), and past 1000, where 1 - MIN_BIN * bins < 0, both
    do what the JAX package does."""
    if int(bins) != bins or bins < 2:
        raise ValueError(f"a spline needs an integer bins >= 2, got {bins!r}")
    return int(bins)


def _element(head, bins=BINS):
    """The plain element maps of a head: forward (x, p) -> (z, ladj), its
    VJP (x, p, g_z, g_ladj) -> (g_x, g_p) and inverse (z, p) -> (x, ladj)."""
    if head == "affine":
        return tr.affine_forward, tr.affine_forward_vjp, tr.affine_inverse
    return (lambda x, p: tr.rqs_forward(x, p, bins),
            lambda x, p, g_z, g_l: tr.rqs_forward_vjp(x, p, g_z, g_l, bins),
            lambda z, p: tr.rqs_inverse(z, p, bins))


def _head(head, bins=BINS):
    """Raw parameters a dimension of ``head`` with ``bins`` spline bins."""
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}; the kernels have {sorted(HEADS)}")
    return tr.rqs_n_params(bins) if head == "rqs" else HEADS[head]


def lib_bins(bins):
    """The library of a spline of ``bins`` bins: its bins up to
    ``FIXED_BINS``, else 0, the library of run-time bins."""
    return bins if bins <= FIXED_BINS else 0


def _lib_bins(head, bins):
    """The bins of the library a head's launch loads: the affine head's
    instances are the same in every library, so it takes the default one."""
    return lib_bins(bins) if head == "rqs" else BINS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _layer_inputs(w, b, x):
    """The inputs of the four products of one MADE pass at x: x, relu(h0),
    relu(h1) and relu(h2), the states of ``made.hidden_stack``."""
    h = x @ w[0] + b[0]
    acts = [x, torch.relu(h)]
    for l in (1, 2):
        h = h + (acts[-1] @ w[l] + b[l])
        acts.append(torch.relu(h))
    return acts


def made_rqs_forward_ref(y, ws, bs, save_inputs=False, head="rqs", bins=BINS):
    """Plain forward of the transform stack: y (n, d) -> (z, ladj), plus,
    when ``save_inputs``, the input of every layer's product in every
    transform: [x_t (T, n, d), relu(h0), relu(h1), relu(h2) (T, n, h)]."""
    n, d = y.shape
    n_params, element = _head(head, bins), _element(head, bins)[0]
    x = y
    saved = [[] for _ in range(4)]
    ladj = torch.zeros(n, dtype=y.dtype, device=y.device)
    for t in range(ws[0].shape[0]):
        acts = _layer_inputs([w[t] for w in ws], [b[t] for b in bs], x)
        for s, a in zip(saved, acts):
            s.append(a)
        p = (acts[3] @ ws[3][t] + bs[3][t]).reshape(n, d, n_params)
        x, l = element(x, p)
        ladj = ladj + l.sum(-1)
    return (x, ladj, [torch.stack(s) for s in saved]) if save_inputs else (x, ladj)


def made_rqs_backward_ref(y, ws, bs, g_z, g_ladj, acts=None, head="rqs", bins=BINS):
    """Plain backward of the transform stack, with no autograd: the
    gradients (g_y, g_ws, g_bs) of a loss L with dL/dz = g_z (n, d) and
    dL/dladj = g_ladj (n,), for the input, the masked weights (T, fi, fo)
    and the biases (T, fo). ``acts`` are the layer inputs that
    ``made_rqs_forward_ref(..., save_inputs=True)`` returns (computed when
    None). The same closed-form derivatives as the kernel
    (``csrc/made_rqs_backward.cu``): transforms in reverse, each's head
    parameters from relu(h2), the head's VJP, then delta @ W^T back
    through the output layer, the residual layers (skip path plus ReLU
    path, the ReLU's mask from the saved activations) and the input layer;
    the weight gradients are A^T @ delta of each layer's input and output
    delta, the bias gradients delta's row sums."""
    n, d = y.shape
    T = ws[0].shape[0]
    n_params, vjp = _head(head, bins), _element(head, bins)[1]
    if acts is None:
        acts = made_rqs_forward_ref(y, ws, bs, save_inputs=True, head=head, bins=bins)[2]
    g_ws = [torch.empty_like(w) for w in ws]
    g_bs = [torch.empty_like(b) for b in bs]
    g_l = g_ladj[:, None].expand(n, d)
    g_x = g_z
    for t in reversed(range(T)):
        w = [a[t] for a in ws]
        a = [s[t] for s in acts]
        p = (a[3] @ w[3] + bs[3][t]).reshape(n, d, n_params)
        g_dir, g_p = vjp(a[0], p, g_x, g_l)
        g3 = g_p.reshape(n, d * n_params)
        g2 = (g3 @ w[3].T) * (a[3] > 0)
        g1 = g2 + (g2 @ w[2].T) * (a[2] > 0)
        g0 = g1 + (g1 @ w[1].T) * (a[1] > 0)
        g_x = g0 @ w[0].T + g_dir
        for l, g in enumerate((g0, g1, g2, g3)):
            g_ws[l][t] = a[l].T @ g
            g_bs[l][t] = g.sum(0)
    return g_x, g_ws, g_bs


def inverse_element_vjp(x, p, g_x, g_l, head="rqs", bins=BINS):
    """VJP of one element of the inverse, x = tau^-1(z; p) with log-det
    -log tau'(x; p) (tau the head's forward map), at the element's data
    value x: (g_z, g_p) given g_x = dL/dx, every path to x included, and
    g_l = dL/dladj. With the forward's element VJP, tau'(x) = exp(its
    log-det), dlog tau'/dx its x-gradient for (0, 1), and g_z = (g_x -
    g_l dlog tau'/dx) / tau'; g_p is minus the forward VJP's parameter
    gradient for (g_z, g_l). ``csrc/heads.cuh`` ``inverse_vjp`` is the
    same arithmetic for one element."""
    forward, vjp = _element(head, bins)[:2]
    _, log_slope = forward(x, p)
    g_xl, _ = vjp(x, p, torch.zeros_like(g_x), g_l)
    g_z = (g_x - g_xl) * torch.exp(-log_slope)
    _, g_p = vjp(x, p, g_z, g_l)
    return g_z, -g_p


def _made_vjp_input(w, a, g3):
    """dL/dx of one MADE pass, with layer inputs a (x, relu(h0), relu(h1),
    relu(h2)), for the cotangent g3 (n, d*NP) of its outputs."""
    g2 = (g3 @ w[3].T) * (a[3] > 0)
    g1 = g2 + (g2 @ w[2].T) * (a[2] > 0)
    g0 = g1 + (g1 @ w[1].T) * (a[1] > 0)
    return g0 @ w[0].T


def ar_inverse_vjp_ref(x, ws, bs, inv_dim_orders, g_x, g_ladj, head="rqs", bins=BINS):
    """Plain VJP of the autoregressive inverse, with no autograd: g_z (n,
    d) of a loss with dL/dx = g_x (n, d) and dL/dladj = g_ladj (n,), where
    (x, ladj) = ar_inverse(z). Every transform's input and activations come
    from the forward at x (``made_rqs_forward_ref(x, save_inputs=True)``).
    Transforms in forward order 0..T-1 (the inverse ran T-1..0); in each,
    the dimensions by decreasing degree: dimension j's x-cotangent is g_x
    plus c_j, the MADE's VJP of the parameter cotangents of the dimensions
    already done (those of higher degree, the only ones that read x_j),
    and ``inverse_element_vjp`` turns it into g_z,j and dimension j's
    parameter cotangent. The kernel (``csrc/ar_inverse_backward.cu``) walks
    the same order one degree at a time."""
    n, d = x.shape
    n_params = _head(head, bins)
    orders = torch.as_tensor(inv_dim_orders).tolist()
    acts = made_rqs_forward_ref(x, ws, bs, save_inputs=True, head=head, bins=bins)[2]
    g = g_x
    for t in range(ws[0].shape[0]):
        w = [a[t] for a in ws]
        a = [s[t] for s in acts]
        p = (a[3] @ w[3] + bs[3][t]).reshape(n, d, n_params)
        g_p = torch.zeros_like(p)
        g_z = torch.empty_like(g)
        for dim in reversed(orders[t]):
            c = _made_vjp_input(w, a, g_p.reshape(n, -1))[:, dim]
            g_z[:, dim], g_p[:, dim] = inverse_element_vjp(a[0][:, dim], p[:, dim],
                                                           g[:, dim] + c, g_ladj, head, bins)
        g = g_z
    return g


def ar_inverse_ref(z, ws, bs, inv_dim_orders, head="rqs", bins=BINS):
    """Plain autoregressive inverse: z (n, d) -> (x, ladj), transforms in
    reverse, dimensions of transform t in the order inv_dim_orders[t]."""
    n, d = z.shape
    n_params, element = _head(head, bins), _element(head, bins)[2]
    orders = torch.as_tensor(inv_dim_orders).tolist()
    cols = torch.arange(d, device=z.device)
    ladj = torch.zeros(n, dtype=z.dtype, device=z.device)
    for t in reversed(range(ws[0].shape[0])):
        wt = [w[t] for w in ws]
        bt = [b[t] for b in bs]
        x = torch.zeros_like(z)
        for dim in orders[t]:
            p = apply_made_dim(wt, bt, x, dim, n_params)
            x_dim, l = element(z[:, dim], p)
            x = torch.where(cols == dim, x_dim[:, None], x)
            ladj = ladj + l
        z = x
    return z, ladj


# ---------------------------------------------------------------------------
# argument checks and launches
# ---------------------------------------------------------------------------

def _check(x, ws, bs, name, head="rqs", bins=BINS):
    """Validate (n, d) input and the stacked masked MADE layers of the
    head's output width; returns (n, d, h, T)."""
    n_params = _head(head, bins)
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
    want_w = [(T, d, h), (T, h, h), (T, h, h), (T, h, d * n_params)]
    want_b = [(T, h), (T, h), (T, h), (T, d * n_params)]
    for a, want in zip(list(ws) + list(bs), want_w + want_b):
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: layer shape {tuple(a.shape)}, expected {want}")
    return n, d, h, T


# K1's widest hidden column group (csrc/ar_walk.cuh GROUP)
_K1_GROUP = 24
# SMs of the H100
_SMS = 132


def _sign_words(h):
    """32-bit words of one hidden layer's sign mask (csrc/ar_walk.cuh
    sign_words)."""
    return -(-h // 32)


def _out_group(head, bins=BINS):
    """Floats of a K1 (and K1-bwd) row's head parameters (csrc/heads.cuh
    OG, head_floats): the spline's NP + 1 rounded up to a multiple of 8 (24
    at 8 bins, 48 at 16, 96 at 32), 4 for the affine head."""
    return -(-(_head(head, bins) + 1) // 8) * 8 if head == "rqs" else 4


def _widest_group(head, bins=BINS):
    """K1's widest column group: a hidden group (``_K1_GROUP``) or the
    output group of a compiled head (its ``_out_group``); the spline of
    run-time bins runs its NP output columns in groups of ``_K1_GROUP``
    (csrc/ar_walk.cuh out_cols)."""
    if head == "rqs" and lib_bins(bins) == 0:
        return _K1_GROUP
    return max(_K1_GROUP, _out_group(head, bins))


def _launch_config(n, d, h, head="rqs", bins=BINS):
    """K1's launch: (R, W, S, SL, blocks, smem bytes). A consumer warp owns
    R rows (1, 2 or 4) for the whole chain, a block has W consumer warps
    (1-8) and one producer warp, and the weight ring S stages (2-8) of SL
    floats. R grows only once every SM has 4 warps of one row (n >= 1,056
    for 2, 2,112 for 4), and W is the warp count over the 132 SMs, so the
    sweep's n=256 runs 128 blocks of 2 warps and n=4096 128 blocks of 8
    warps of 4 rows. A warp's state is R * (3h + 3d + OG) floats (OG,
    ``_out_group``: 24 with the 8-bin spline head, 48 with 16 bins, 4 with
    the affine one); the ring takes the rest of the 227 KB, a stage up to
    one group of the widest (24 columns, or OG where wider) with all h
    fan-in rows (padded to 4), and at least 4,096 floats, so that at small
    d a stage holds the groups of several steps. W, then R, halve until a
    stage holds at least 33 rows of such a group; raises where one row
    alone leaves less: from h = 16384 (d > 2730), as K2's launch does.
    Past 16 bins the output layer runs in groups of 24 columns, so the
    widest group is 24 at every bins and only the row's NP + 1 grows."""
    return _plan(n, d, h, 3 * h + 3 * d + _out_group(head, bins), "ar_inverse",
                 _widest_group(head, bins))


def _plan(n, d, h, row, name, widest=_K1_GROUP):
    """``_launch_config``'s rule for a warp's state of R * row floats and a
    widest column group of ``widest`` columns."""
    limit = _MAX_SMEM // 4 - 4 * 8  # floats, less the 2 x 8 mbarriers
    least = 33 * widest
    R = 4 if n >= 16 * _SMS else (2 if n >= 8 * _SMS else 1)
    W = min(8, max(1, round(-(-n // R) / _SMS)))
    while limit - R * W * row < 2 * least:
        if W > 1:
            W //= 2
        elif R > 1:
            R //= 2
        else:
            raise ValueError(f"{name}: d={d}, h={h} needs more shared memory than a "
                             f"Hopper block has")
    free = limit - R * W * row
    SL = min(max(widest * (-(-h // 4) * 4 + 1), 4096), free // 2 // 4 * 4)
    S = min(8, free // SL)
    smem = 16 * S + 4 * (S * SL + R * W * row)
    return R, W, S, SL, -(-n // (R * W)), smem


@functools.lru_cache(maxsize=None)
def _k2_config(n, d, h, n_params=N_PARAMS):
    """(P, G, SL) of a K2 forward launch with a head of ``n_params``
    parameters: P particle rows a block, the largest of 16, 8, 4, 2 that
    still gives ~128 blocks (one per SM of the H100) and leaves half of the
    shared memory to the weight ring; G whole dimensions in a group of the
    output layer (made_tile.cuh), as many as half the shared memory holds
    (all of them at d <= 50), so the output layer streams in chunks as
    wide as a stage allows; SL floats a ring stage (a multiple of 4),
    enough for a whole layer where it fits. The floats per block are those
    of ``made_rqs_forward_smem_floats`` in the source. Raises where a stage
    cannot hold one column of a square layer: from h = 16384 (d > 2730),
    where the flow's weights, gradients and AdamW moments alone pass the
    H100's 80 GB."""
    limit = _MAX_SMEM // 4 - 4
    state = d + 2 * h + 1
    P = 16
    while P > 2 and -(-n // P) < 128:
        P //= 2
    while P > 1 and P * (state + n_params) > limit // 2:
        P //= 2
    G = max(1, min(d, (limit // 2 // P - state) // n_params))
    need = max(h * (d + 1), h * (h + 1), G * n_params * (h + 1))
    SL = min(-(-need // 4) * 4, (limit - P * (state + G * n_params)) // 8 * 4)
    if SL < h + 1:
        raise ValueError(f"made_rqs_forward: d={d}, h={h} needs more shared memory than a "
                         f"Hopper block has")
    return P, G, SL


@functools.lru_cache(maxsize=None)
def _k2_backward_plan(n, d, h, T, n_params=N_PARAMS):
    """K2's backward launch: (K5Config, pack floats). The tile is K5's
    (``coupling_kernels._k5_config`` with ``made``: BM rows a block, RM x
    RNH and RM x RNO register tiles, output groups of G whole dimensions of
    d, slabs of BK rows in an S-stage ring); the pack is the weights laid
    out for it (``made_rqs_backward_pack_floats`` of the source: the output
    layers by group, (T, ceil(d/G), h, ldo), then every layer's W^T in
    passes of PW columns). It reads what K2's forward saved, so it refuses
    wherever the forward's launch does (``_k2_config``: from h = 16384)."""
    from .coupling_kernels import _k5_config
    _k2_config(n, d, h, n_params)
    cfg = _k5_config(n, d, h, True, made=True, n_params=n_params)
    PW, n3 = cfg.PW, d * n_params
    p0, ph = -(-d // PW), -(-h // PW)
    subs = -(-cfg.G * n_params // cfg.ldo)
    pack = T * (-(-d // cfg.G) * subs * h * cfg.ldo + (p0 * h + 2 * ph * h + ph * n3) * PW)
    return cfg, pack


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry(lib_name, fn_name, sig, bins=BINS):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu`` built for
    ``bins`` spline bins; ``sig`` has one letter an argument, P for a
    pointer and I for an int."""
    fn = getattr(_build.load(lib_name, bins), fn_name)
    fn.argtypes = [_P if c == "P" else _I for c in sig]
    fn.restype = _I
    return fn


def _raise_if(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(wrapper, head, bins=BINS):
    """One launch of ``wrapper``'s kernel with ``head`` (and ``bins``)."""
    attr = launch_attr(head, bins)
    setattr(wrapper, attr, getattr(wrapper, attr, 0) + 1)


def launch_attr(head="rqs", bins=BINS):
    """The attribute a wrapper counts its launches with ``head`` in:
    ``launches`` (the 8-bin spline), ``launches_b<bins>`` (the spline of
    other bins) or ``launches_affine``."""
    if head != "rqs":
        return f"launches_{head}"
    return "launches" if bins == BINS else f"launches_b{bins}"


def _launch_forward(y, ws, bs, save_inputs=False, head="rqs", bins=BINS):
    n, d, h, T = _check(y, ws, bs, "made_rqs_forward", head, bins)
    n_params = _head(head, bins)
    z = torch.empty_like(y)
    ladj = torch.empty(n, dtype=y.dtype, device=y.device)
    acts = ([torch.empty(T, n, k, dtype=y.dtype, device=y.device) for k in (d, h, h, h)]
            if save_inputs else None)
    if n > 0:
        P, G, SL = _k2_config(n, d, h, n_params)
        fn = _entry("made_rqs_forward", "made_rqs_forward_launch",
                    "PPPIIII" + "P" * 12 + "IIIIIP", _lib_bins(head, bins))
        weights = [a.data_ptr() for pair in zip(ws, bs) for a in pair]
        saved = [a.data_ptr() for a in acts] if save_inputs else [None] * 4
        err = fn(y.data_ptr(), z.data_ptr(), ladj.data_ptr(), n, d, h, T, *weights, *saved,
                 n_params, P, G, SL, y.device.index, _stream(y))
        _raise_if(err, "made_rqs_forward")
        _count(made_rqs_forward, head, bins)
    return (z, ladj, acts) if save_inputs else (z, ladj)


def _check_saved(name, acts, g_z, g_ladj, widths):
    """Validate the four saved layer inputs (T, n, widths[l]) and the
    upstream gradients g_z (n, d), g_ladj (n,) of a backward launch;
    returns (T, n)."""
    T, n, d = acts[0].shape
    dev = acts[0].device
    for what, a, shape in (("g_z", g_z, (n, d)), ("g_ladj", g_ladj, (n,)),
                           *[(f"acts[{l}]", a, (T, n, k))
                             for l, (a, k) in enumerate(zip(acts, widths))]):
        if (a.dtype != torch.float32 or a.device != dev or tuple(a.shape) != shape
                or not a.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"{shape} tensor on {dev}")
    return T, n


def _launch_backward(acts, ws, bs, g_z, g_ladj, head="rqs", bins=BINS):
    """K2's backward launch (its pack kernel into a scratch tensor, then
    the backward kernel, which writes the four layers' deltas), then the
    weight gradients A^T @ delta of the saved layer inputs and its
    deltas with batched fp32 products over the T transforms, and the bias
    gradients as row sums (TF32 is off, see the package's __init__)."""
    if len(acts) != 4:
        raise ValueError(f"made_rqs_backward: expects the four saved layer inputs, "
                         f"got {len(acts)}")
    sp = trace.begin("k2bwd")
    _, _, h, _ = _check(acts[0][0], ws, bs, "made_rqs_backward", head, bins)
    d = acts[0].shape[2]
    T, n = _check_saved("made_rqs_backward", acts, g_z, g_ladj, (d, h, h, h))
    dev = acts[0].device
    g_y = torch.empty_like(g_z)
    n_params = _head(head, bins)
    widths = [w.shape[2] for w in ws]
    cfg, n_pack = _k2_backward_plan(n, d, h, T, n_params) if n > 0 else (None, 0)
    pack = torch.empty(n_pack, dtype=g_z.dtype, device=dev)
    deltas = [torch.empty(T, n, k, dtype=g_z.dtype, device=dev) for k in widths]
    if n > 0:
        fn = _entry("made_rqs_backward", "made_rqs_backward_launch",
                    "PPPPPPPIIII" + "P" * 10 + "IIIIIIIIIP", _lib_bins(head, bins))
        err = fn(*[a.data_ptr() for a in acts], g_z.data_ptr(), g_ladj.data_ptr(),
                 g_y.data_ptr(), n, d, h, T, *[w.data_ptr() for w in ws], bs[3].data_ptr(),
                 *[g.data_ptr() for g in deltas], pack.data_ptr(), n_params, cfg.RL,
                 cfg.BM, cfg.RNH, cfg.RNO, cfg.G, cfg.BK, cfg.S, dev.index, _stream(g_z))
        _raise_if(err, "made_rqs_backward")
        _count(made_rqs_backward, head, bins)
    g_ws = [torch.bmm(a.transpose(1, 2), g) for a, g in zip(acts, deltas)]
    g_bs = [g.sum(1) for g in deltas]
    if sp is not None:
        trace.end(sp)
    return g_y, g_ws, g_bs


def _inverse_pack(ws, bs, inv_dim_orders, d, h, T, head, bins=BINS):
    """K1's weights in the order its steps read them (``pack_kernel`` in
    ``csrc/ar_inverse.cu``), written on the device without a host sync and
    kept on ``ws[0]``, the first masked weight of the caller's
    ``FlowParams``: once per FlowParams, again only when one of its tensors
    is replaced or changed in place (its version moves)."""
    key = (head, bins, *((id(a), a._version) for a in (*ws, *bs, inv_dim_orders)))
    kept = getattr(ws[0], "_k1_pack", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    lib_bins, n_params = _lib_bins(head, bins), _head(head, bins)
    size = _build.load("ar_inverse", lib_bins).ar_inverse_pack_floats
    size.argtypes, size.restype = [_I, _I, _I, _I], ctypes.c_longlong
    pack = torch.empty(size(d, h, T, n_params), dtype=torch.float32, device=ws[0].device)
    fn = _entry("ar_inverse", "ar_inverse_pack_launch", "P" * 10 + "IIIIIP", lib_bins)
    weights = [a.data_ptr() for pair in zip(ws, bs) for a in pair]
    err = fn(*weights, inv_dim_orders.data_ptr(), pack.data_ptr(), d, h, T, n_params,
             ws[0].device.index, _stream(ws[0]))
    _raise_if(err, "ar_inverse (pack)")
    ws[0]._k1_pack = (key, pack)
    return pack


def _launch_inverse(z, ws, bs, inv_dim_orders, head="rqs", save=False, bins=BINS):
    """K1: (x, ladj), and with ``save`` the state K1-bwd reads (K1's save
    instance): (px (T, n, d, NP + 1) float32, each step's head parameters
    and x in visit order; signs (T, n, 3, ceil(h/32)) int32, each
    transform's hidden signs as bit masks in degree-sorted order)."""
    n, d, h, T = _check(z, ws, bs, "ar_inverse", head, bins)
    n_params = _head(head, bins)
    if (inv_dim_orders.dtype != torch.int32 or inv_dim_orders.device != z.device
            or tuple(inv_dim_orders.shape) != (T, d)
            or not inv_dim_orders.is_contiguous()):
        raise ValueError("ar_inverse: inv_dim_orders must be a contiguous (T, d) "
                         "int32 tensor on the input's device")
    x = torch.empty_like(z)
    ladj = torch.empty(n, dtype=z.dtype, device=z.device)
    state = ((torch.empty(T, n, d, n_params + 1, dtype=z.dtype, device=z.device),
              torch.empty(T, n, 3, _sign_words(h), dtype=torch.int32, device=z.device))
             if save else None)
    if n > 0:
        R, W, S, SL, _, _ = _launch_config(n, d, h, head, bins)
        pack = _inverse_pack(ws, bs, inv_dim_orders, d, h, T, head, bins)
        fn = _entry("ar_inverse", "ar_inverse_launch", "PPPPPIIIIPPIIIIIIP",
                    _lib_bins(head, bins))
        saved = [a.data_ptr() for a in state] if save else [None, None]
        err = fn(z.data_ptr(), x.data_ptr(), ladj.data_ptr(), *saved, n, d, h, T,
                 pack.data_ptr(), inv_dim_orders.data_ptr(), n_params, R, W, S, SL,
                 z.device.index, _stream(z))
        _raise_if(err, "ar_inverse")
        _count(ar_inverse, head, bins)
    return (x, ladj, state) if save else (x, ladj)


def _backward_config(n, d, h, head="rqs", bins=BINS):
    """K1-bwd's launch: (R, W, S, SL, blocks, smem bytes) by K1's rule
    (``_plan``) for a warp's state of R * (3h + 3 ceil(h/32) + 2d + OG)
    floats: the three layers' cotangents, their sign masks, x's cotangent
    in visit order and by dimension, the head parameters' cotangent. A
    group too large for a stage goes in fan-in chunks. It reads K1's
    state, so it refuses wherever K1's launch does (``_launch_config``):
    from h = 16384 (d > 2730). Its row is no wider than K1's where 3
    ceil(h/32) <= d, as at every flow's (d, h), so there its own plan holds
    wherever K1's does."""
    _launch_config(n, d, h, head, bins)
    return _plan(n, d, h, 3 * h + 3 * _sign_words(h) + 2 * d + _out_group(head, bins),
                 "ar_inverse_backward", _widest_group(head, bins))


def _check_state(state, T, n, d, h, head, device, bins=BINS):
    """Validate K1's saved state (``_launch_inverse(..., save=True)``)."""
    name = "ar_inverse_backward"
    if not isinstance(state, (tuple, list)) or len(state) != 2:
        raise ValueError(f"{name}: on CUDA it takes, in place of x, the state that K1's "
                         f"save instance writes at z (_launch_inverse(z, ..., save=True))")
    for what, a, shape, dtype in (
            ("state[0]", state[0], (T, n, d, _head(head, bins) + 1), torch.float32),
            ("state[1]", state[1], (T, n, 3, _sign_words(h)), torch.int32)):
        if (a.dtype != dtype or a.device != device or tuple(a.shape) != shape
                or not a.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} {shape} tensor "
                             f"on {device}")


def _launch_inverse_backward(state, ws, bs, inv_dim_orders, g_x, g_ladj, head="rqs",
                             bins=BINS):
    """K1-bwd on the state K1's save instance wrote: the kernel walks K1's
    pack in reverse; g_z."""
    n, d, h, T = _check(g_x, ws, bs, "ar_inverse_backward", head, bins)
    if (g_ladj.dtype != torch.float32 or g_ladj.device != g_x.device
            or tuple(g_ladj.shape) != (n,) or not g_ladj.is_contiguous()):
        raise ValueError(f"ar_inverse_backward: g_ladj must be a contiguous float32 ({n},) "
                         f"tensor on {g_x.device}")
    _check_state(state, T, n, d, h, head, g_x.device, bins)
    g_z = torch.empty_like(g_x)
    if n == 0:
        return g_z
    sp = trace.begin("k1bwd")
    R, W, S, SL, _, _ = _backward_config(n, d, h, head, bins)
    pack = _inverse_pack(ws, bs, inv_dim_orders, d, h, T, head, bins)
    fn = _entry("ar_inverse_backward", "ar_inverse_backward_launch", "PPPPPIIIIPPIIIIIIP",
                _lib_bins(head, bins))
    err = fn(state[0].data_ptr(), state[1].data_ptr(), g_x.data_ptr(), g_ladj.data_ptr(),
             g_z.data_ptr(), n, d, h, T, pack.data_ptr(), inv_dim_orders.data_ptr(),
             _head(head, bins), R, W, S, SL, g_x.device.index, _stream(g_x))
    _raise_if(err, "ar_inverse_backward")
    _count(ar_inverse_backward, head, bins)
    if sp is not None:
        trace.end(sp)
    return g_z


def _element_vjp(x, p, g_x, g_l, head="rqs", lanes=32, bins=BINS):
    """K1-bwd's element VJP on the card, for the tests: (g_z (n,), g_p (n,
    NP)) of ``inverse_element_vjp`` at x (n,), p (n, NP), g_x, g_l (n,), on
    ``lanes`` lanes a row: the kernel's versions (32: a warp, up to 10
    bins; 8: a group of 8 lanes, up to 16 bins) or the one-lane one (1;
    past 16 bins, the kernel's own)."""
    n = x.shape[0]
    px = torch.cat([p, x[:, None]], 1).contiguous()
    g_z, g_p = torch.empty_like(x), torch.empty_like(p)
    fn = _entry("ar_inverse_backward", "ar_inverse_element_vjp_launch", "PPPPPIIIIP",
                _lib_bins(head, bins))
    err = fn(px.data_ptr(), g_x.data_ptr(), g_l.data_ptr(), g_z.data_ptr(), g_p.data_ptr(), n,
             _head(head, bins), lanes, x.device.index, _stream(x))
    _raise_if(err, "ar_inverse_backward (element VJP)")
    return g_z, g_p


class _MadeRqsForward(torch.autograd.Function):
    """K2 with its gradient: the forward kernel saves every layer's input,
    the backward kernel takes them (``made_rqs_backward``). Mask gradients
    follow through w * mask, which the caller formed in torch."""

    @staticmethod
    def forward(ctx, head, bins, y, *layers):
        z, ladj, acts = _launch_forward(y, layers[:4], layers[4:], True, head, bins)
        ctx.head, ctx.bins = head, bins
        ctx.save_for_backward(*acts, *layers)
        return z, ladj

    @staticmethod
    def backward(ctx, g_z, g_ladj):
        saved = ctx.saved_tensors
        layers = saved[4:]
        g_y, g_ws, g_bs = _launch_backward(saved[:4], layers[:4], layers[4:], g_z.contiguous(),
                                           g_ladj.contiguous(), ctx.head, ctx.bins)
        grads = [g_y, *g_ws, *g_bs]
        return (None, None, *(g if need else None
                              for g, need in zip(grads, ctx.needs_input_grad[2:])))


class _ArInverse(torch.autograd.Function):
    """K1 with its gradient in z: the forward is K1's save instance, the
    backward K1-bwd (``ar_inverse_backward``) on the state it wrote. The
    weights take no gradient (the wrapper refuses weights that require
    one)."""

    @staticmethod
    def forward(ctx, head, bins, z, inv_dim_orders, *layers):
        x, ladj, state = _launch_inverse(z, layers[:4], layers[4:], inv_dim_orders, head, True,
                                         bins)
        ctx.head, ctx.bins = head, bins
        ctx.save_for_backward(inv_dim_orders, *state, *layers)
        return x, ladj

    @staticmethod
    def backward(ctx, g_x, g_ladj):
        orders, px, signs, *layers = ctx.saved_tensors
        g_z = _launch_inverse_backward((px, signs), layers[:4], layers[4:], orders,
                                       g_x.contiguous(), g_ladj.contiguous(), ctx.head, ctx.bins)
        return (None, None, g_z, None, *[None] * len(layers))


def _refuse_weight_grad(name, layers):
    if torch.is_grad_enabled() and any(a.requires_grad for a in layers):
        raise NotImplementedError(
            f"{name}: the CUDA kernels give the gradient in the input only, not in the "
            f"weights and biases; pass weights that do not require a gradient (detached)")


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _device_type(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _route(x, name, bins, head="rqs"):
    """The device type a wrapper dispatches on, with the spline's bins
    checked (the affine head ignores them)."""
    device = _device_type(x, name)
    if head == "rqs":
        check_bins(bins)
    return device


def made_rqs_forward(y, ws, bs, save_inputs=False, head="rqs", bins=BINS):
    """K2: (z, ladj) of the transform stack at y; ladj = log|det dz/dy|.
    Differentiable on CUDA through the backward kernel. ``save_inputs``
    also returns the input of every layer's product in every transform,
    [x_t (T, n, d), relu(h0), relu(h1), relu(h2) (T, n, h)], which
    ``made_rqs_backward`` takes (no gradient then). ``head``: "rqs" (with
    ``bins`` spline bins) or "affine"."""
    ws, bs = list(ws), list(bs)
    sp = trace.begin("k2")
    if _route(y, "made_rqs_forward", bins, head) == "cpu":
        _check(y, ws, bs, "made_rqs_forward", head, bins)
        out = made_rqs_forward_ref(y, ws, bs, save_inputs, head, bins)
    elif (not save_inputs and torch.is_grad_enabled()
            and any(a.requires_grad for a in [y, *ws, *bs])):
        out = _MadeRqsForward.apply(head, bins, y, *ws, *bs)
    else:
        with torch.no_grad():
            out = _launch_forward(y, ws, bs, save_inputs, head, bins)
    if sp is not None:
        trace.end(sp)
    return out


def made_rqs_backward(y, ws, bs, g_z, g_ladj, acts=None, head="rqs", bins=BINS):
    """K2's backward: (g_y, g_ws, g_bs), the gradients of a loss with dL/dz
    = g_z and dL/dladj = g_ladj with respect to y, the masked weights and
    the biases. ``acts`` are the layer inputs that ``made_rqs_forward(...,
    save_inputs=True)`` returns; the plain version computes them when None,
    the CUDA route needs them."""
    ws, bs = list(ws), list(bs)
    if _route(y, "made_rqs_backward", bins, head) == "cpu":
        _check(y, ws, bs, "made_rqs_backward", head, bins)
        return made_rqs_backward_ref(y, ws, bs, g_z, g_ladj, acts, head, bins)
    if acts is None:
        raise ValueError("made_rqs_backward: on CUDA it takes acts, the layer inputs "
                         "that made_rqs_forward(..., save_inputs=True) returns")
    with torch.no_grad():
        return _launch_backward(list(acts), ws, bs, g_z, g_ladj, head, bins)


def ar_inverse(z, ws, bs, inv_dim_orders, head="rqs", bins=BINS):
    """K1: (x, ladj) of the autoregressive inverse; ladj = log|det dx/dz|.
    ``inv_dim_orders[t]`` lists the dimensions of transform t by increasing
    degree. Precondition: ``ws`` are the weights already multiplied by
    ``made.make_masks``' masks for (d, h) and those degrees, as every
    ``Flow``'s are. The kernel skips the terms those masks zero, so with
    unmasked weights its result is not the plain version's. Differentiable
    in z on CUDA through K1-bwd; weights that require a gradient raise
    there."""
    ws, bs = list(ws), list(bs)
    sp = trace.begin("k1")
    if _route(z, "ar_inverse", bins, head) == "cpu":
        _check(z, ws, bs, "ar_inverse", head, bins)
        out = ar_inverse_ref(z, ws, bs, inv_dim_orders, head, bins)
    else:
        _refuse_weight_grad("ar_inverse", [*ws, *bs])
        if torch.is_grad_enabled() and z.requires_grad:
            out = _ArInverse.apply(head, bins, z, inv_dim_orders, *ws, *bs)
        else:
            out = _launch_inverse(z, ws, bs, inv_dim_orders, head, bins=bins)
    if sp is not None:
        trace.end(sp)
    return out


def ar_inverse_backward(x, ws, bs, inv_dim_orders, g_x, g_ladj, head="rqs", bins=BINS):
    """K1-bwd: g_z, the gradient of a loss with dL/dx = g_x and dL/dladj =
    g_ladj with respect to z, where (x, ladj) = ar_inverse(z, ...) (the
    weights' precondition is K1's). On the CPU x is the inverse's output,
    from which the plain version recomputes what it needs. On CUDA x is the
    state that K1's save instance writes at z (``_launch_inverse(z, ...,
    save=True)``'s third item, as ``ar_inverse``'s autograd route keeps
    it), which holds each step's x and all the kernel reads; x alone
    raises there."""
    ws, bs = list(ws), list(bs)
    if _route(g_x, "ar_inverse_backward", bins, head) == "cpu":
        _check(x, ws, bs, "ar_inverse_backward", head, bins)
        return ar_inverse_vjp_ref(x, ws, bs, inv_dim_orders, g_x, g_ladj, head, bins)
    with torch.no_grad():
        return _launch_inverse_backward(x, ws, bs, inv_dim_orders, g_x, g_ladj, head, bins)


def zero_counts(wrappers):
    """Every launch count of ``wrappers`` set to 0: each head at 2-16 bins,
    and every other bins a wrapper has counted."""
    for wrapper in wrappers:
        attrs = {launch_attr(h, b) for h in HEADS for b in range(2, FIXED_BINS + 1)}
        attrs |= {a for a in vars(wrapper) if a.startswith("launches")}
        for attr in attrs:
            setattr(wrapper, attr, 0)


zero_counts((made_rqs_forward, made_rqs_backward, ar_inverse, ar_inverse_backward))
