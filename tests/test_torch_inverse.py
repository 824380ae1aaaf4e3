"""K1's degree schedule on the CPU.

The CUDA kernel (``csrc/ar_inverse.cu``) computes each hidden unit once, at
the step where its MADE degree makes it final, and skips the terms the
masks zero. Here a plain torch loop over that schedule, with the kernel's
closed forms for the degree-sorted unit order, is held to the plain
version ``ar_inverse_ref`` (the same sums less exact zeros, in another
order: 1e-10 in float64) on random masked weights, and to the JAX
package's ``Flow.inverse`` (1e-5 on x, 1e-4 on the log-det).
Also: ``convert.tensors_from_jax``'s device rule, K1's and K1-bwd's launch
configurations, and a plain mirror of the order in which K1-bwd's
producer warp lands the pack in its ring and its consumers take it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu_torch.convert import load_flow_params, tensors_from_jax
from pocomc_tpu_torch.models import made, transforms as ttr
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import flow_kernels as fk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sorted_units(d, h):
    """The kernel's ``Degrees``: with D = max(1, d-1) and h = q*D + r, unit
    u has degree u mod D + 1; place s of the degree-sorted order holds unit
    j + m*D (j = degree - 1, m its rank within the degree), and count(k)
    units have degree <= k."""
    D = max(1, d - 1)
    q, r = divmod(h, D)
    big = r * (q + 1)
    units = []
    for s in range(h):
        if s < big:
            j, m = divmod(s, q + 1)
        else:
            jr, m = divmod(s - big, q)
            j = r + jr
        units.append(j + m * D)
    count = [h if k >= D else q * k + min(k, r) for k in range(d)]
    return np.array(units), count


def degree_schedule_inverse(z, ws, bs, inv_orders):
    """The kernel's schedule in plain torch: transforms in reverse; at
    step k the layer-0, 1 and 2 units of degree k (fan-in: the dimensions
    visited before, or the units of degree <= k below), then the spline
    parameters of dimension inv_orders[t, k] from the layer-2 units of
    degree <= k, then its spline inverse. Hidden states in sorted order."""
    n, d = z.shape
    h = ws[0].shape[2]
    units, count = sorted_units(d, h)
    np_ = fk.N_PARAMS
    ladj = torch.zeros(n, dtype=z.dtype)
    for t in reversed(range(ws[0].shape[0])):
        w = [a[t] for a in ws]
        b = [a[t] for a in bs]
        order = [int(i) for i in inv_orders[t]]
        x = torch.zeros_like(z)
        hs = [torch.zeros(n, h, dtype=z.dtype) for _ in range(3)]
        for k, dim in enumerate(order):
            if k >= 1:
                new = units[count[k - 1]:count[k]]
                live = units[:count[k]]
                place = slice(count[k - 1], count[k])
                seen = order[:k]
                hs[0][:, place] = x[:, seen] @ w[0][seen][:, new] + b[0][new]
                for l in (1, 2):
                    prod = torch.relu(hs[l - 1][:, :count[k]]) @ w[l][live][:, new] + b[l][new]
                    hs[l][:, place] = hs[l - 1][:, place] + prod
            cols = slice(dim * np_, (dim + 1) * np_)
            p = torch.relu(hs[2][:, :count[k]]) @ w[3][units[:count[k]]][:, cols] + b[3][cols]
            xd, l = ttr.rqs_inverse(z[:, dim], p, 8)
            x[:, dim] = xd
            ladj = ladj + l
        z = x
    return z, ladj


@pytest.mark.parametrize("d,h", [(1, 32), (2, 32), (3, 32), (10, 32), (17, 64), (50, 256),
                                 (820, 4096), (4, 2)])
def test_sorted_unit_order_is_the_degree_order(d, h):
    """The closed forms list every unit once, by non-decreasing degree
    (made.make_degrees), and count(k) is the number of degree <= k."""
    units, count = sorted_units(d, h)
    deg = made.make_degrees(d, np.arange(d), [h])[1]
    assert sorted(units) == list(range(h))
    assert np.all(np.diff(deg[units]) >= 0)
    assert count == [int((deg <= k).sum()) for k in range(d)]


def _masked_flow(d, arch, seed):
    """A CPU flow with random hidden weights (the init), random output
    weights and biases, so every mask matters."""
    rng = np.random.default_rng(seed)
    f = Flow(d, arch, device="cpu")
    with torch.no_grad():
        f.weights[-1].copy_(torch.from_numpy(0.05 * rng.standard_normal(f.weights[-1].shape)))
        for b in f.biases:
            b.copy_(torch.from_numpy(0.05 * rng.standard_normal(b.shape)))
    return f, rng


@pytest.mark.parametrize("d,arch", [(2, "nsf6"), (3, "nsf6"), (10, "nsf6"), (17, "nsf3")])
def test_degree_schedule_matches_plain_inverse(d, arch):
    """Each hidden unit computed once, masked-out terms skipped: the same x
    and log-det as ``ar_inverse_ref``, which recomputes the whole stack at
    every step with the zeros. In float64, to 1e-10: the two sum the same
    terms in another order (in float32 the inverse's conditioning turns
    that into up to 1e-5 at d=3, nsf6)."""
    f, rng = _masked_flow(d, arch, d)
    f = f.double()
    z = torch.from_numpy(1.5 * rng.standard_normal((64, d)))
    with torch.no_grad():
        fp = f.params()
        x, l = degree_schedule_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        x_r, l_r = fk.ar_inverse_ref(z, fp.ws, fp.bs, fp.inv_orders)
    torch.testing.assert_close(x, x_r, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(l, l_r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d,arch", [(3, "nsf3"), (10, "nsf6")])
def test_degree_schedule_matches_jax_inverse(d, arch):
    """The schedule through the whole flow (pre-layer included) against the
    JAX package's ``Flow.inverse`` on the same numpy weights in float32: x
    to 1e-5; the log-det, a sum of 3d-6d spline log-dets of up to a few
    nats each, to 1e-4 (one row of 128 at d=3 differs by 3e-5)."""
    jf = JFlow(d, arch, seed=d)
    rng = np.random.default_rng(d + 200)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    stack = params["stack"]
    stack[-1]["w"] = (0.03 * rng.standard_normal(stack[-1]["w"].shape)).astype(np.float32)
    for layer in stack:
        layer["b"] = (0.03 * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    a = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    params["pre"] = dict(mean=rng.standard_normal(d).astype(np.float32),
                         w_fwd=a.astype(np.float32), w_inv=np.linalg.inv(a).astype(np.float32),
                         ladj=np.float32(np.log(abs(np.linalg.det(a)))))
    jf.params = jax.device_put(params)
    tf = load_flow_params(Flow(d, arch, device="cpu"), params)
    z = rng.standard_normal((128, d)).astype(np.float32)
    xj, lj = jf.inverse(jnp.asarray(z))
    with torch.no_grad():
        fp = tf.params()
        y, l = degree_schedule_inverse(torch.from_numpy(z), fp.ws, fp.bs, fp.inv_orders)
        x = y @ fp.pre["w_inv"] + fp.pre["mean"]
        l = l - fp.pre["ladj"]
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), rtol=0, atol=1e-4)


def test_tensors_from_jax_defaults_to_the_card(monkeypatch):
    """As ``Flow`` and ``Sampler``: the card by default, raising without
    one unless given device='cpu'."""
    arrays = {"mu": np.zeros(3, np.float32), "sigma": np.ones(3, np.float64)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensors_from_jax(arrays)
    out = tensors_from_jax(arrays, device="cpu")
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in out.values())
    assert torch.equal(out["sigma"], torch.ones(3))


@pytest.mark.parametrize("n", [1, 256, 4096])
@pytest.mark.parametrize("d", [10, 50])
def test_k1_launch_config_fits_a_hopper_block(n, d):
    """Every row has a warp, the block's shared memory (mbarriers, ring,
    the warps' row states) fits the 227 KB a block may use, a stage holds
    one 24-column group of all h fan-in rows, and the sweep's n=256 puts
    work on at least 128 of the 132 SMs."""
    h = max(1 << (3 * d - 1).bit_length(), 32)
    R, W, S, SL, blocks, smem = fk._launch_config(n, d, h)
    assert R in (1, 2, 4) and 1 <= W <= 8 and 2 <= S <= 8 and SL % 4 == 0
    assert blocks == -(-n // (R * W)) and (blocks - 1) * R * W < n
    assert smem == 16 * S + 4 * (S * SL + R * W * (3 * h + 3 * d + 24))
    assert smem <= 227 * 1024
    assert SL >= 24 * (-(-h // 4) * 4 + 1)
    if n >= 256:
        assert blocks >= 128


def test_k1_launch_config_refuses_what_no_block_holds():
    """K1 launches where K2 does, up to d = 2730 (h = 8192), and refuses
    from h = 16384 (d > 2730), where one row's state leaves no room for
    the ring."""
    R, W, S, SL, blocks, smem = fk._launch_config(1, 2730, 8192)
    assert (R, W, blocks) == (1, 1, 1) and smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        fk._launch_config(1, 2731, 16384)


@pytest.mark.parametrize("head", ["rqs", "affine"])
@pytest.mark.parametrize("n", [1, 256, 4096])
@pytest.mark.parametrize("d", [2, 4, 10, 50, 171, 342, 683, 1366, 2730])
def test_k1_backward_config_fits_a_hopper_block(d, n, head):
    """K1-bwd launches at every width K1 launches, up to d = 2730 (h =
    8192): every row has a warp, the block's shared memory (mbarriers,
    ring, the warps' row states of 3h + 3 ceil(h/32) + 2d + OG floats) fits
    the 227 KB a block may use, a stage holds at least 33 rows of a
    24-column group (a larger group goes in fan-in chunks), and the
    sweep's n=256 puts work on at least 128 of the 132 SMs."""
    h = max(1 << (3 * d - 1).bit_length(), 32)
    og = 24 if head == "rqs" else 4
    fk._launch_config(n, d, h, head)
    R, W, S, SL, blocks, smem = fk._backward_config(n, d, h, head)
    assert R in (1, 2, 4) and 1 <= W <= 8 and 2 <= S <= 8 and SL % 4 == 0
    assert blocks == -(-n // (R * W)) and (blocks - 1) * R * W < n
    assert smem == 16 * S + 4 * (S * SL + R * W * (3 * h + 3 * -(-h // 32) + 2 * d + og))
    assert smem <= 227 * 1024
    assert ((SL - 24) // 24) & ~3 >= 32
    if n >= 256:
        assert blocks >= 128


def test_k1_backward_config_refuses_where_k1_does():
    """K1-bwd reads the state K1 writes, so its planner refuses exactly
    where K1's does: from h = 16384 (d > 2730), though its own row state
    there would leave room for a ring."""
    fk._backward_config(1, 2730, 8192)
    for config in (fk._launch_config, fk._backward_config):
        with pytest.raises(ValueError, match="shared memory"):
            config(1, 2731, 16384)


@pytest.mark.parametrize("bins", [2, 5, 11, 16, 17, 32, 128, 1000])
@pytest.mark.parametrize("n", [1, 256, 4096])
@pytest.mark.parametrize("d", [10, 50, 2730])
def test_k1_configs_at_bins(d, n, bins):
    """K1's and K1-bwd's plans with the spline of ``bins`` bins: a row's
    head parameters OG are NP + 1 rounded up to 8 (csrc/heads.cuh
    head_floats; 8 at 2 bins, 48 at 16, 3,000 at 1000), the widest group
    max(24, OG) up to 16 bins and 24 past them (the output layer of the
    spline of run-time bins runs in groups of 24 columns); the block's
    shared memory with rows of 3h + 3d + OG (K1) and 3h + 3 ceil(h/32) +
    2d + OG (K1-bwd) floats fits 227 KB, a stage holds at least 5 widest
    groups' worth (the C entries' check) and 33 rows of one, up to h =
    8192 (d = 2730); from h = 16384 both refuse, as at 8 bins."""
    h = max(1 << (3 * d - 1).bit_length(), 32)
    og = -(-(3 * bins) // 8) * 8
    widest = max(24, og) if bins <= fk.FIXED_BINS else 24
    assert fk._out_group("rqs", bins) == og
    for config, row in ((fk._launch_config, 3 * h + 3 * d + og),
                        (fk._backward_config, 3 * h + 3 * -(-h // 32) + 2 * d + og)):
        R, W, S, SL, blocks, smem = config(n, d, h, "rqs", bins)
        assert smem == 16 * S + 4 * (S * SL + R * W * row) and smem <= 227 * 1024
        assert SL >= 5 * widest and ((SL - widest) // widest) & ~3 >= 32
        assert blocks == -(-n // (R * W))
        with pytest.raises(ValueError, match="shared memory"):
            config(1, 2731, 16384, "rqs", bins)


def _round4(v):
    return (v + 3) // 4 * 4


def pack_groups(d, h, T, n_params):
    """The groups of K1's pack in the order of its walk (``walk`` in
    csrc/ar_walk.cuh): (ncg, fan, offset, floats) each, laid out as
    ``group_floats`` says (ncg columns of round4(fan) floats, the biases
    padded to 4); a step's output layer one group of n_params columns, or,
    past 16 bins (n_params > 47: the spline of run-time bins, ``out_cols``),
    groups of 24; returns them and the pack's size."""
    _, count = sorted_units(d, h)
    groups, off = [], 0

    def add(ncg, fan):
        nonlocal off
        floats = ncg * _round4(fan) + _round4(ncg)
        groups.append((ncg, fan, off, floats))
        off += floats

    for _ in range(T):
        for k in range(d):
            if k >= 1:
                nc = count[k] - count[k - 1]
                gw = 4 if nc <= 4 else (8 if nc <= 8 else 24)
                for l in range(3):
                    for g0 in range(0, nc, gw):
                        add(min(gw, nc - g0), k if l == 0 else count[k])
            out = 24 if n_params > 47 else n_params
            for c0 in range(0, n_params, out):
                add(min(out, n_params - c0), count[k])
    return groups, off


def back_schedule(groups, size, SL, R):
    """K1-bwd's ring in plain numpy, on a pack whose floats are their own
    offsets: the stages its producer warp fills (``BackProducer``: walk_back
    order, i.e. the groups reversed; whole groups at a stage's end, batched
    for one-row warps; larger groups in chunks of ``chunk_rows`` rows at a
    stage's start, column by column, then the biases), and for each group
    what its consumers read (``BackConsumer::push``: ``take_back`` or one
    stage a group, then a stage a chunk): a list of (group, [(chunk's first
    row, its column values (ncg, nf), its biases)]) and the count of stages
    filled."""
    pack = np.arange(size, dtype=np.float64)
    stages = []
    gathered, off = 0, size

    def flush():
        nonlocal gathered
        if gathered:
            st = np.full(SL, np.nan)
            st[SL - gathered:] = pack[off:off + gathered]
            stages.append(st)
            gathered = 0

    def chunk(ncg):
        return ((SL - _round4(ncg)) // ncg) & ~3

    for ncg, fan, _, floats in reversed(groups):
        fanp, ch = _round4(fan), chunk(ncg)
        if fanp <= ch:
            if gathered + floats > SL:
                flush()
            off -= floats
            gathered += floats
            if R != 1:
                flush()
            continue
        flush()
        off -= floats
        for i0 in range(0, fan, ch):
            nf = min(ch, fan - i0)
            nfp = _round4(nf)
            st = np.full(SL, np.nan)
            for jj in range(ncg):
                st[jj * nfp:(jj + 1) * nfp] = pack[off + jj * fanp + i0:off + jj * fanp + i0 + nfp]
            st[ncg * nfp:ncg * nfp + _round4(ncg)] = pack[off + ncg * fanp:
                                                          off + ncg * fanp + _round4(ncg)]
            stages.append(st)
    flush()
    reads, nxt, held, used = [], 0, False, 0
    for grp in reversed(groups):
        ncg, fan, _, floats = grp
        fanp, ch = _round4(fan), chunk(ncg)
        if fanp <= ch:
            if R == 1 and held and used + floats <= SL:
                used += floats
                st, at = stages[nxt - 1], SL - used
            else:
                st, at = stages[nxt], SL - floats
                nxt += 1
                held, used = R == 1, floats
            pieces = [(0, st[at:at + ncg * fanp].reshape(ncg, fanp)[:, :fan],
                       st[at + ncg * fanp:at + ncg * fanp + ncg])]
        else:
            held, pieces = False, []
            for i0 in range(0, fan, ch):
                nf = min(ch, fan - i0)
                st = stages[nxt]
                nxt += 1
                nfp = _round4(nf)
                pieces.append((i0, st[:ncg * nfp].reshape(ncg, nfp)[:, :nf],
                               st[ncg * nfp:ncg * nfp + ncg]))
        reads.append((grp, pieces))
    return reads, nxt, len(stages)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("d,h,T,n_params,SL", [
    (2, 32, 2, 23, 4096), (4, 32, 2, 23, 4096), (10, 32, 3, 23, 4096), (10, 32, 2, 2, 4096),
    (50, 256, 2, 23, 6168), (17, 64, 2, 23, 240), (10, 32, 2, 23, 120),
    (10, 32, 2, 5, 4096), (10, 32, 2, 47, 4096), (17, 64, 2, 47, 240),
    (10, 32, 2, 95, 4096), (17, 64, 2, 95, 120), (10, 32, 2, 2999, 4096)])
def test_k1_backward_stages_hold_the_groups_in_reverse(d, h, T, n_params, SL, R):
    """What K1-bwd's consumers read from its ring, in the plain mirror
    ``back_schedule``, is the pack's groups in walk_back order: each whole
    group's columns and biases, each chunk's rows of every column, every
    stage taken once. Stages of 4,096 floats hold several steps' groups at
    d <= 10; 240 and 120 floats cut the wide groups into chunks (120: 4
    rows of a 24-column group; 240: 4 rows of the 47-column output group
    of a 16-bin spline); 95 and 2,999 parameters (32 and 1000 bins) are
    output layers in groups of 24 columns, the last one narrower."""
    groups, size = pack_groups(d, h, T, n_params)
    reads, taken, filled = back_schedule(groups, size, SL, R)
    assert taken == filled
    assert [g for g, _ in reads] == list(reversed(groups))
    for (ncg, fan, off, _), pieces in reads:
        fanp = _round4(fan)
        cols = off + np.arange(ncg)[:, None] * fanp + np.arange(fan)[None, :]
        np.testing.assert_array_equal(np.concatenate([c for _, c, _ in pieces], axis=1), cols)
        for _, _, bias in pieces:
            np.testing.assert_array_equal(bias, off + ncg * fanp + np.arange(ncg))
    if R == 1 and SL == 4096:
        assert filled < len(groups)
    if R == 2:
        assert filled == sum(len(p) for _, p in reads)
