"""K1's degree schedule on the CPU.

The CUDA kernel (``csrc/ar_inverse.cu``) computes each hidden unit once, at
the step where its MADE degree makes it final, and skips the terms the
masks zero. Here a plain torch loop over that schedule, with the kernel's
closed forms for the degree-sorted unit order, is held to the plain
version ``ar_inverse_ref`` (the same sums less exact zeros, in another
order: 1e-10 in float64) on random masked weights, and to the JAX
package's ``Flow.inverse`` (1e-5 on x, 1e-4 on the log-det).
Also: ``convert.tensors_from_jax``'s device rule and K1's launch
configuration."""

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
