"""K5: the hand-written CUDA kernels of the coupling spline flows (nsfc*)
and their plain versions.

``coupling_forward`` (data -> latent) and ``coupling_inverse`` (latent ->
data): a whole stack of T coupling transforms in one launch, each a
residual MLP on the conditioning half and the spline on the other half
(``csrc/coupling_forward.cu``, templated on the direction);
``coupling_backward``: one launch back through the stack from the layer
inputs the forward saved, then the weight gradients as batched products
of those inputs and the deltas it writes (``csrc/coupling_backward.cu``).
``_CouplingForward`` joins the two as an ``autograd.Function``.
``coupling_inverse_backward`` (K5-inv-bwd): the inverse's gradient in z,
by the backward kernel's inverse instances, from the state a save instance
of the inverse wrote (each transform's x_t as the inverse computed it, its
layer inputs and its output layer's spline parameters);
``_CouplingInverse`` joins it to the inverse. They replace no Pallas
kernel: the JAX package runs coupling flows as XLA code
(``pocomc_tpu/models/coupling.py``). ``_k5_config`` also plans K2's
backward (``ops/flow_kernels.py``), which runs on the same tiles.

The weights are the JAX package's per-transform layout: ``ws[t]`` and
``bs[t]`` the four weights (K, N) and biases (N,) of transform t, for
n_cond_t -> h -> h -> h -> n_trans_t*NP, and ``masks[t]`` its boolean
conditioning mask (``models/coupling.py make_coupling_masks``; the kernels
take the alternating halves that function lays out). NP = 3 bins - 1 raw
parameters a transformed dimension: every function takes the spline's
``bins`` (8 by default; any bins >= 2 on both routes: on CUDA one library a
source and bins up to 16, one of run-time bins past that, as
``flow_kernels``).

Dispatch is by device and nothing else: a CPU tensor goes to the plain
version (``*_ref``), a CUDA tensor launches the kernel or raises. Each
wrapper counts its launches in plain integer attributes, ``launches`` at
8 bins and ``launches_b<bins>`` at other bins (``flow_kernels.launch_attr``).
Each call is also a span (``utils/trace.py``): ``k5`` and
``k5inv`` at the public wrappers (both routes), ``k5invbwd`` at the
inverse's backward launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import transforms as tr
from ..models.coupling import BINS, coupling_forward as _transform_forward, \
    coupling_inverse as _transform_inverse, halves, layer_inputs, make_coupling_masks
from .flow_kernels import (_MAX_SMEM, N_PARAMS, _check_saved, _count, _entry, _made_vjp_input,
                           _raise_if, _refuse_weight_grad, _route, _stream, inverse_element_vjp,
                           lib_bins, zero_counts)
from ..utils import trace


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def coupling_forward_ref(x, ws, bs, masks, save_inputs=False, bins=BINS):
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
        x, l = _transform_forward(ws[t], bs[t], masks[t], x, bins)
        ladj = ladj + l
    return (x, ladj, [torch.stack(s) for s in saved]) if save_inputs else (x, ladj)


def coupling_inverse_ref(z, ws, bs, masks, save_inputs=False, bins=BINS):
    """Plain inverse of the stack: z (n, d) -> (x, ladj), transforms
    T-1..0, one pass each; ladj = log|det dx/dz|. With ``save_inputs``
    also the state K5-inv-bwd reads, the kernel's save instance's layout:
    [x_t (T, n, d), relu(h0), relu(h1), relu(h2) (T, n, h), params (T, n,
    ceil(d/2)*NP)], by transform t: x_t the inverse's value after transform
    t (the input of the forward's transform t), the layer inputs of its
    network and its output layer's spline parameters (columns past the
    transform's half 0)."""
    n = z.shape[0]
    ladj = torch.zeros(n, dtype=z.dtype, device=z.device)
    saved = [[None] * len(ws) for _ in range(5)]
    half = (z.shape[1] + 1) // 2
    for t in reversed(range(len(ws))):
        if save_inputs:
            cond, trans = halves(masks[t], z.device)
            acts = layer_inputs(ws[t], bs[t], z[:, cond])
            p = acts[3] @ ws[t][3] + bs[t][3]
            for l in (1, 2, 3):
                saved[l][t] = acts[l]
            saved[4][t] = F.pad(p, (0, half * tr.rqs_n_params(bins) - p.shape[1]))
        z, l = _transform_inverse(ws[t], bs[t], masks[t], z, bins)
        ladj = ladj + l
        saved[0][t] = z
    if save_inputs:
        return z, ladj, [torch.stack(s) for s in saved]
    return z, ladj


def coupling_backward_ref(x, ws, bs, masks, g_z, g_ladj, acts=None, bins=BINS):
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
    n, n_params = x.shape[0], tr.rqs_n_params(bins)
    if acts is None:
        acts = coupling_forward_ref(x, ws, bs, masks, save_inputs=True, bins=bins)[2]
    g_ws, g_bs = [None] * len(ws), [None] * len(ws)
    g_x = g_z
    for t in reversed(range(len(ws))):
        w = ws[t]
        cond, trans = halves(masks[t], x.device)
        a = [acts[0][t][:, cond], acts[1][t], acts[2][t], acts[3][t]]
        p = (a[3] @ w[3] + bs[t][3]).reshape(n, trans.numel(), n_params)
        g_dir, g_p = tr.rqs_forward_vjp(acts[0][t][:, trans], p, g_x[:, trans],
                                        g_ladj[:, None].expand(n, trans.numel()), bins)
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


def coupling_inverse_vjp_ref(state, ws, bs, masks, g_x, g_ladj, bins=BINS):
    """Plain VJP of the coupling inverse, with no autograd: g_z (n, d) of
    a loss with dL/dx = g_x (n, d) and dL/dladj = g_ladj (n,), where (x,
    ladj) = coupling_inverse(z), on the state that
    ``coupling_inverse_ref(z, ..., save_inputs=True)`` returns (x_t, the
    layer inputs and the spline parameters of every transform: the
    inverse's own intermediates, where jax.vjp differentiates).
    Transforms in forward order 0..T-1: the transformed half takes
    ``inverse_element_vjp`` (g_z and the spline parameters' cotangent),
    the conditioning half passes its g_x through plus the MLP's VJP of
    that cotangent. The kernel (``csrc/coupling_backward.cu``, its
    inverse instances) takes the same steps."""
    n, n_params = g_x.shape[0], tr.rqs_n_params(bins)
    g = g_x
    for t in range(len(ws)):
        w = ws[t]
        cond, trans = halves(masks[t], g_x.device)
        a = [state[0][t][:, cond], state[1][t], state[2][t], state[3][t]]
        p = state[4][t][:, :trans.numel() * n_params].reshape(n, trans.numel(), n_params)
        g_z, g_p = inverse_element_vjp(state[0][t][:, trans], p, g[:, trans],
                                       g_ladj[:, None].expand(n, trans.numel()), "rqs", bins)
        g_prev = g.clone()
        g_prev[:, cond] = g[:, cond] + _made_vjp_input(w, a, g_p.reshape(n, -1))
        g_prev[:, trans] = g_z
        g = g_prev
    return g


# ---------------------------------------------------------------------------
# argument checks and launches
# ---------------------------------------------------------------------------

def _check(x, ws, bs, masks, name, bins=BINS):
    """Validate (n, d) input, T transforms of four layers each and their
    masks (a spline of ``bins`` bins); returns (n, d, h, T)."""
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
        n_out = (d - n_cond) * tr.rqs_n_params(bins)
        want_w = [(max(n_cond, 1), h), (h, h), (h, h), (h, n_out)]
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


class K5Config(NamedTuple):
    """A K5 launch's tile: the lane grid (RL = 4 a Tile of BM = 8*RM rows a
    block and passes of 32*RN columns, RL = 1 a Row of BM = RM rows and
    passes of 256*RN columns; csrc/coupling_tile.cuh), RM rows and RNH (a
    hidden layer) or RNO (an output group) columns a thread, G whole
    transformed dimensions an output group, slabs of BK weight rows in an
    S-stage ring, and the block's shared memory in bytes."""
    RL: int
    BM: int
    RM: int
    RNH: int
    RNO: int
    G: int
    BK: int
    S: int
    smem: int

    @property
    def PW(self):
        """Columns of a hidden layer's pass (and rows a pass of W^T)."""
        return _lanes(self.RL) * self.RNH

    @property
    def ldo(self):
        """Columns of an output group's pass."""
        return _lanes(self.RL) * self.RNO


def _lanes(RL):
    """Consumer threads across the columns of a pass: 32 on a Tile (4 x 8
    lanes of 2 x 4 warps), 256 on a Row."""
    return 32 if RL == 4 else 256


# (RNH, RNO) pairs the Tile instances are compiled for, and their bound on
# RM: RM * max(RNH, RNO) <= 64 accumulators a thread in the forward, RM *
# (RNH + RNO) <= 64 in the backward, whose output layer holds both tiles
# (``by_tile`` and ``by_rows`` in csrc/coupling_forward.cu,
# coupling_backward.cu); the Row instances: RM 1, 2 or 4, passes of 512
# hidden and 256 output columns
K5_TILES = ((1, 4), (2, 8), (4, 8), (8, 8), (16, 8))
K5_ACCUMULATORS = 64
K5_ROW = (2, 1)
# blocks a launch aims for: about one per SM of the H100
K5_BLOCKS = 128
# K5-inv-bwd takes a Row of 4 rows where h >= 256 and 8-row Tiles would
# give fewer than 64 blocks (n <= 504): at nsfc12, d=50, n=256 it ran in
# 0.508 ms against 0.612 on the Tile (tools/k5invbwd_breakdown.py, NVIDIA
# H100 80GB HBM3, 700 W); at h=32 the Row's 512-column passes lose
K5_INV_ROW = (256, 64)


def k5_instances(backward):
    """The (RL, RM, RNH, RNO) tiles a K5 kernel has an instance of."""
    tiles = {(4, rm, rnh, rno) for rnh, rno in K5_TILES for rm in (1, 2, 4, 8)
             if rm * ((rnh + rno) if backward else max(rnh, rno)) <= K5_ACCUMULATORS}
    return tiles | {(1, rm, *K5_ROW) for rm in (1, 2, 4)}


def _k5_smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, backward, n_params=N_PARAMS):
    """``coupling_forward_smem_floats`` and ``stack_backward.cuh
    smem_floats`` of the sources (a head of ``n_params``): the
    k-major buffers [.][BMP] (BMP = BM + 4 on a Tile, BM on a Row: the
    rows, the hidden state, twice where a hidden layer takes several
    passes, one output group's parameters, and the per-dimension log-dets
    in the forward or the input gradient in the backward), BM floats of
    per-row state and the ring (``ring_floats`` of csrc/coupling_tile.cuh:
    up to 4 floats of padding, S stages, 2*S mbarriers)."""
    bmp, lanes = (BM + 4 if RL == 4 else BM), _lanes(RL)
    hidden = 2 * h if h > lanes * RNH else h
    rows = (2 * d + hidden + G * n_params) if backward else \
        (d + hidden + G * n_params + (d + 1) // 2)
    return bmp * rows + BM + 4 + S * BK * lanes * max(RNH, RNO) + 4 * S


def _k5_fit(RL, BMs, RNH, RNO, G, d, h, backward, n_params=N_PARAMS):
    """The first tile of rows BMs (largest first) that fits a Hopper block,
    with slabs of BK = 32 weight rows (128 in the backward at RNH = 1,
    where its transposed output layer, NP*ceil(d/2) rows, is then one
    slab), or 16 or 8 where two stages do not fit, and as many stages as
    fit, up to 8 (fewer, larger slabs measured faster:
    tools/k5_breakdown.py); None where none fits."""
    for BM in BMs:
        for BK in (128, 32, 16, 8) if RNH == 1 and backward else (32, 16, 8):
            for S in range(8, 1, -1):
                smem = 4 * _k5_smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, backward,
                                           n_params)
                if smem <= _MAX_SMEM:
                    RM = BM // 8 if RL == 4 else BM
                    return K5Config(RL, BM, RM, RNH, RNO, G, BK, S, smem)
    return None


@functools.lru_cache(maxsize=None)
def _k5_config(n, d, h, backward, made=False, n_params=N_PARAMS, inverse=False):
    """K5's launch plan at n rows, d dimensions and hidden width h; with
    ``made``, the plan of K2's backward on the same tiles (every one of the
    d dimensions transformed, a head of ``n_params``: its output groups
    hold whole dimensions of all d, not of the half); with ``inverse``,
    K5-inv-bwd's (``K5_INV_ROW``).
    On a Tile, RNH is the least power of two with 32 * RNH >= h, up to 16
    (a hidden layer is one pass, the whole layer in registers, up to h =
    512; wider ones run in passes of 512 columns); RNO 4 at h <= 32, else 8
    (an output group of up to 5 or 11 dimensions a pass; past 16 bins, where
    one dimension may pass an output pass, a group of one dimension in as
    many passes as it takes: coupling_tile.cuh Plan::subs). BM is the largest
    of 64, 32, 16, 8 that still gives 128 blocks (one per SM of the H100; 8
    below n = 1024), within the accumulator bound of ``k5_instances``, and
    shrinks where the shared memory does not fit. Where even 8 rows do not
    fit (h >= 2048, where 8 rows of two hidden buffers pass 227 KB), a Row
    of 4, 2 or 1 rows. Raises where h is not a multiple of 4 (a hidden
    layer's rows are whole 16-byte copies) and where no tile fits (from h
    = 32768, d > 5461, where 1 row of two hidden buffers passes the
    block's shared memory)."""
    if h % 4:
        raise ValueError(f"coupling kernels: the hidden width h={h} must be a multiple of 4")
    wide = d if made else (d + 1) // 2
    rnh = 1
    while 32 * rnh < h and rnh < 16:
        rnh *= 2
    rno = 4 if rnh == 1 else 8
    BM = 64
    while BM > 8 and -(-n // BM) < K5_BLOCKS:
        BM //= 2
    instances = k5_instances(backward)
    while BM > 8 and (4, BM // 8, rnh, rno) not in instances:
        BM //= 2
    row_g = max(1, min(wide, 256 * K5_ROW[1] // n_params))
    plan = None
    if inverse and h >= K5_INV_ROW[0] and -(-n // 8) < K5_INV_ROW[1]:
        plan = _k5_fit(1, (4,), *K5_ROW, row_g, d, h, backward, n_params)
    plan = plan or _k5_fit(4, [b for b in (64, 32, 16, 8) if b <= BM], rnh, rno,
                           max(1, min(wide, 32 * rno // n_params)), d, h, backward, n_params)
    plan = plan or _k5_fit(1, (4, 2, 1), *K5_ROW, row_g, d, h, backward, n_params)
    if plan is None:
        raise ValueError(f"coupling kernels: d={d}, h={h} needs more shared memory than "
                         f"a Hopper block has")
    return plan


@functools.lru_cache(maxsize=64)
def _table(device_index, ptrs):
    """The device table of the transforms' weight and bias pointers that
    the kernels read (w0 b0 w1 b1 w2 b2 w3 b3 of each transform); cached
    by the pointers themselves, so it is always the one they spell."""
    return torch.tensor(ptrs, dtype=torch.int64, device=torch.device("cuda", device_index))


def _layers(ws, bs):
    """Every transform's weights and biases, w0 b0 w1 b1 w2 b2 w3 b3 of
    transform 0, then of 1, and so on: the table's order."""
    return [a for t in range(len(ws)) for pair in zip(ws[t], bs[t]) for a in pair]


def _key(layers, others, masks, n):
    """The cache key of a launch's checks: every weight and bias tensor's
    pointer, shape, dtype, device and contiguity, the same but the pointer
    of the per-call tensors ``others`` (whose memory is new every call),
    the masks and n. A tensor that reuses an address with another shape,
    dtype or layout gives another key."""
    return (n, tuple((a.data_ptr(), a.shape, a.dtype, a.get_device(), a.is_contiguous())
                     for a in layers),
            tuple((a.shape, a.dtype, a.get_device(), a.is_contiguous()) for a in others),
            tuple(np.asarray(m, dtype=bool).tobytes() for m in masks))


_PLANS = {}
_PLANS_MAX = 256


def _plan(key, check, backward, inverse=False, bins=BINS):
    """(n, d, h, T, K5Config, weight pointers) of a launch: ``check()``
    validates the arguments and returns (n, d, h, T, layers) the first time
    a key is seen; later calls with the same key skip it. Kept in
    ``_PLANS`` under (backward, key); ``inverse`` plans K5-inv-bwd, whose
    key holds the five tensors of the inverse's state. The spline's
    ``bins`` need no place in the key: the output layers' shapes in it
    differ between bins."""
    key = (backward, key)
    plan = _PLANS.get(key)
    if plan is None:
        n, d, h, T, layers = check()
        if any(a.data_ptr() % 16 for a in layers):
            raise ValueError("coupling kernels: every weight and bias must start on a "
                             "16-byte boundary")
        plan = (n, d, h, T, _k5_config(n, d, h, backward, n_params=tr.rqs_n_params(bins),
                                       inverse=inverse) if n > 0 else None,
                tuple(a.data_ptr() for a in layers))
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.clear()
        _PLANS[key] = plan
    return plan


def _in_passes(a, PW):
    """(T, rows, K) -> (T, P*rows, PW): K zero-padded to P = ceil(K / PW)
    passes of PW columns, the passes one after another."""
    T, rows, K = a.shape
    P = -(-K // PW)
    a = F.pad(a, (0, P * PW - K)).view(T, rows, P, PW)
    return a.transpose(1, 2).reshape(T, P * rows, PW)


def _packed(layers, ws, cfg, d, h, transposed, n_params=N_PARAMS):
    """The weights repacked as csrc/coupling_tile.cuh ``Packed`` lays them
    out, for whole-slab bulk copies (an output layer's rows, n_params *
    n_trans floats, sit off 16-byte boundaries, and W^T gathers columns): the
    output layers by group, (T, NG * subs, h, ldo) (a group's subs = ceil(G *
    n_params / ldo) blocks of ldo columns: one but past 16 bins), or
    (``transposed``) every layer's W^T in passes of PW columns, (T, rows,
    PW); zero padding. Kept on ``ws[0][0]``, the first
    transform's first weight, so it lives as long as the flow's tensors:
    rebuilt when any of them is replaced or changed in place (its version
    moves, as an optimizer step moves it), so a sweep packs once per
    flow."""
    key = (n_params, cfg.RL, cfg.G, cfg.RNH, cfg.RNO,
           *((a.data_ptr(), a._version) for a in layers))
    kept = getattr(ws[0][0], "_k5_packs", {}).get(transposed)
    if kept is not None and kept[0] == key:
        return kept[1]
    T, half = len(ws), (d + 1) // 2
    with torch.no_grad():
        if not transposed:
            ng, gw = -(-half // cfg.G), cfg.G * n_params
            subs = -(-gw // cfg.ldo)
            w3 = torch.stack([F.pad(w[3], (0, ng * gw - w[3].shape[1])) for w in ws])
            w3 = F.pad(w3.view(T, h, ng, gw), (0, subs * cfg.ldo - gw))
            pack = w3.view(T, h, ng, subs, cfg.ldo).permute(0, 2, 3, 1, 4).contiguous()
            pack = pack.view(T, ng * subs, h, cfg.ldo)
        else:
            rows = [torch.stack([F.pad(w[0], (0, 0, 0, half - w[0].shape[0])) for w in ws]),
                    torch.stack([w[1] for w in ws]), torch.stack([w[2] for w in ws]),
                    torch.stack([F.pad(w[3], (0, half * n_params - w[3].shape[1]))
                                 for w in ws])]
            pack = torch.cat([_in_passes(r.transpose(1, 2), cfg.PW) for r in rows], dim=1)
    ws[0][0]._k5_packs = {**getattr(ws[0][0], "_k5_packs", {}), transposed: (key, pack)}
    return pack


def _launch_stack(x, ws, bs, masks, inverse, save_inputs, name, bins=BINS):
    layers = _layers(ws, bs)
    n_params = tr.rqs_n_params(bins)

    def check():
        n, d, h, T = _check(x, ws, bs, masks, name, bins)
        _check_kernel_layout(masks, d, T, name)
        return n, d, h, T, layers

    n, d, h, T, cfg, ptrs = _plan(_key(layers, (x,), masks, x.shape[0]), check, False,
                                  bins=bins)
    out = torch.empty_like(x)
    ladj = torch.empty(n, dtype=x.dtype, device=x.device)
    widths = (d, h, h, h, (d + 1) // 2 * n_params) if inverse else (d, h, h, h)
    acts = ([torch.empty(T, n, k, dtype=x.dtype, device=x.device) for k in widths]
            if save_inputs else None)
    if n > 0:
        fn = _entry("coupling_forward", "coupling_forward_launch", "PPPIIIIPPPPPPPIIIIIIIIIIP",
                    lib_bins(bins))
        saved = [a.data_ptr() for a in acts] if save_inputs else []
        saved += [None] * (5 - len(saved))
        table = _table(x.device.index, ptrs)
        w3 = _packed(layers, ws, cfg, d, h, False, n_params).data_ptr()
        err = fn(x.data_ptr(), out.data_ptr(), ladj.data_ptr(), n, d, h, T, table.data_ptr(),
                 w3, *saved, int(inverse), cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G, cfg.BK,
                 cfg.S, n_params, x.device.index, _stream(x))
        _raise_if(err, name)
        _count(coupling_inverse if inverse else coupling_forward, "rqs", bins)
    return (out, ladj, acts) if save_inputs else (out, ladj)


def _launch_backward(acts, ws, bs, masks, g_z, g_ladj, inverse=False, bins=BINS):
    """K5's backward kernel, then the weight gradients A^T @ delta of the
    saved layer inputs and its deltas with batched fp32 products over the T
    transforms (layer 0's over the whole saved row, then each transform's
    conditioning rows; the output layer's over the widest half, then each
    transform's columns), and the bias gradients as row sums. With
    ``inverse``, the gradient of the inverse (K5-inv-bwd) on the five
    tensors of the state the inverse's save instance wrote: the kernel's
    inverse instances walk the transforms forward with the inverse's
    element VJP, read the saved spline parameters and write no deltas;
    returns the input gradient only."""
    name = "coupling_inverse_backward" if inverse else "coupling_backward"
    want = 5 if inverse else 4
    if len(acts) != want:
        raise ValueError(f"{name}: takes {want} saved tensors, got {len(acts)}")
    sp = trace.begin("k5invbwd") if inverse else None
    layers = _layers(ws, bs)
    n_params = tr.rqs_n_params(bins)

    def check():
        _, d, h, T = _check(acts[0][0], ws, bs, masks, name, bins)
        _check_kernel_layout(masks, d, T, name)
        widths = (d, h, h, h, (d + 1) // 2 * n_params)[:want]
        _, n = _check_saved(name, acts, g_z, g_ladj, widths)
        return n, d, h, T, layers

    n, d, h, T, cfg, ptrs = _plan(_key(layers, (*acts, g_z, g_ladj), masks, g_z.shape[0]),
                                  check, True, inverse, bins)
    dev = acts[0].device
    g_x = torch.empty_like(g_z)
    half = (d + 1) // 2
    deltas = [] if inverse else [torch.empty(T, n, k, dtype=g_z.dtype, device=dev)
                                 for k in (h, h, h, half * n_params)]
    if n > 0:
        fn = _entry("coupling_backward", "coupling_backward_launch",
                    "PPPPPPPPIIIIPPPPPPPIIIIIIIIIIP", lib_bins(bins))
        packs = [_packed(layers, ws, cfg, d, h, t, n_params).data_ptr() for t in (False, True)]
        err = fn(*[a.data_ptr() for a in acts[:4]],
                 acts[4].data_ptr() if inverse else None, g_z.data_ptr(), g_ladj.data_ptr(),
                 g_x.data_ptr(), n, d, h, T, _table(dev.index, ptrs).data_ptr(), *packs,
                 *([g.data_ptr() for g in deltas] if deltas else [None] * 4), cfg.RL, cfg.BM,
                 cfg.RNH, cfg.RNO, cfg.G, cfg.BK, cfg.S, int(inverse), n_params, dev.index,
                 _stream(g_z))
        _raise_if(err, name)
        _count(coupling_inverse_backward if inverse else coupling_backward, "rqs", bins)
    if inverse:
        if sp is not None:
            trace.end(sp)
        return g_x
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
    def forward(ctx, masks, bins, x, *layers):
        T = len(masks)
        ws, bs = _nest(layers[:4 * T], T), _nest(layers[4 * T:], T)
        z, ladj, acts = _launch_stack(x, ws, bs, masks, False, True, "coupling_forward", bins)
        ctx.masks, ctx.bins = masks, bins
        ctx.save_for_backward(*acts, *layers)
        return z, ladj

    @staticmethod
    def backward(ctx, g_z, g_ladj):
        saved = ctx.saved_tensors
        T = len(ctx.masks)
        layers = saved[4:]
        g_x, g_ws, g_bs = _launch_backward(saved[:4], _nest(layers[:4 * T], T),
                                           _nest(layers[4 * T:], T), ctx.masks,
                                           g_z.contiguous(), g_ladj.contiguous(), bins=ctx.bins)
        grads = [g_x, *[g for gt in g_ws for g in gt], *[g for gt in g_bs for g in gt]]
        return (None, None, *(g if need else None
                              for g, need in zip(grads, ctx.needs_input_grad[2:])))


class _CouplingInverse(torch.autograd.Function):
    """K5's inverse with its gradient in z: the forward is the inverse's
    save instance, the backward K5-inv-bwd (``coupling_inverse_backward``)
    on the state it wrote. Inputs as ``_CouplingForward``'s; the weights
    take no gradient."""

    @staticmethod
    def forward(ctx, masks, bins, z, *layers):
        T = len(masks)
        ws, bs = _nest(layers[:4 * T], T), _nest(layers[4 * T:], T)
        x, ladj, state = _launch_stack(z, ws, bs, masks, True, True, "coupling_inverse", bins)
        ctx.masks, ctx.bins = masks, bins
        ctx.save_for_backward(*state, *layers)
        return x, ladj

    @staticmethod
    def backward(ctx, g_x, g_ladj):
        saved = ctx.saved_tensors
        T = len(ctx.masks)
        layers = saved[5:]
        g_z = _launch_backward(saved[:5], _nest(layers[:4 * T], T), _nest(layers[4 * T:], T),
                               ctx.masks, g_x.contiguous(), g_ladj.contiguous(), inverse=True,
                               bins=ctx.bins)
        return (None, None, g_z, *[None] * len(layers))


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _flat(ws, bs):
    return [a for t in ws for a in t] + [a for t in bs for a in t]


def coupling_forward(x, ws, bs, masks, save_inputs=False, bins=BINS):
    """K5: (z, ladj) of the coupling stack at x; ladj = log|det dz/dx|.
    Differentiable on CUDA through the backward kernel. ``save_inputs``
    also returns the input of every layer's product in every transform,
    which ``coupling_backward`` takes (no gradient then)."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    sp = trace.begin("k5")
    if _route(x, "coupling_forward", bins) == "cpu":
        _check(x, ws, bs, masks, "coupling_forward", bins)
        out = coupling_forward_ref(x, ws, bs, masks, save_inputs, bins)
    elif (not save_inputs and torch.is_grad_enabled()
            and any(a.requires_grad for a in [x, *_flat(ws, bs)])):
        out = _CouplingForward.apply(list(masks), bins, x, *_flat(ws, bs))
    else:
        with torch.no_grad():
            out = _launch_stack(x, ws, bs, masks, False, save_inputs, "coupling_forward", bins)
    if sp is not None:
        trace.end(sp)
    return out


def coupling_inverse(z, ws, bs, masks, bins=BINS):
    """K5 inverse: (x, ladj) of the coupling stack at z, one pass a
    transform; ladj = log|det dx/dz|. The conditioning columns of each
    transform pass through bit for bit. Differentiable in z on CUDA
    through the inverse's save instance (the same x and ladj bits) and
    K5-inv-bwd; weights that require a gradient raise there."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    sp = trace.begin("k5inv")
    if _route(z, "coupling_inverse", bins) == "cpu":
        _check(z, ws, bs, masks, "coupling_inverse", bins)
        out = coupling_inverse_ref(z, ws, bs, masks, bins=bins)
    else:
        _refuse_weight_grad("coupling_inverse", _flat(ws, bs))
        if torch.is_grad_enabled() and z.requires_grad:
            out = _CouplingInverse.apply(list(masks), bins, z, *_flat(ws, bs))
        else:
            out = _launch_stack(z, ws, bs, masks, True, False, "coupling_inverse", bins)
    if sp is not None:
        trace.end(sp)
    return out


def coupling_inverse_backward(state, ws, bs, masks, g_x, g_ladj, bins=BINS):
    """K5-inv-bwd: g_z, the gradient of a loss with dL/dx = g_x and
    dL/dladj = g_ladj with respect to z, where (x, ladj) =
    coupling_inverse(z, ...), on the inverse's state at z: each
    transform's x_t as the inverse computed it, its layer inputs and its
    spline parameters (``coupling_inverse_ref(z, ..., save_inputs=True)``'s
    third item; on CUDA the inverse's save instance writes it, and
    ``coupling_inverse``'s autograd route keeps it)."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    if not isinstance(state, (list, tuple)) or len(state) != 5:
        raise ValueError("coupling_inverse_backward: takes the inverse's state at z, five "
                         "tensors (coupling_inverse_ref(z, ..., save_inputs=True)'s third item)")
    if _route(g_x, "coupling_inverse_backward", bins) == "cpu":
        _check(g_x, ws, bs, masks, "coupling_inverse_backward", bins)
        return coupling_inverse_vjp_ref(state, ws, bs, masks, g_x, g_ladj, bins)
    with torch.no_grad():
        return _launch_backward(list(state), ws, bs, masks, g_x, g_ladj, inverse=True,
                                bins=bins)


def coupling_backward(x, ws, bs, masks, g_z, g_ladj, acts=None, bins=BINS):
    """K5's backward: (g_x, g_ws, g_bs), the gradients of a loss with dL/dz
    = g_z and dL/dladj = g_ladj with respect to x and every transform's
    weights and biases. ``acts`` are the layer inputs that
    ``coupling_forward(..., save_inputs=True)`` returns; the plain version
    computes them when None, the CUDA route needs them."""
    ws, bs = [list(w) for w in ws], [list(b) for b in bs]
    if _route(x, "coupling_backward", bins) == "cpu":
        _check(x, ws, bs, masks, "coupling_backward", bins)
        return coupling_backward_ref(x, ws, bs, masks, g_z, g_ladj, acts, bins)
    if acts is None:
        raise ValueError("coupling_backward: on CUDA it takes acts, the layer inputs "
                         "that coupling_forward(..., save_inputs=True) returns")
    with torch.no_grad():
        return _launch_backward(list(acts), ws, bs, masks, g_z, g_ladj, bins=bins)


zero_counts((coupling_forward, coupling_inverse, coupling_backward, coupling_inverse_backward))
