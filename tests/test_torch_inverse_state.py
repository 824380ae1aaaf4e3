"""The coupling inverse's save mode in the plain versions, held on the CPU
against the JAX coupling stack: ``coupling_inverse_ref(...,
save_inputs=True)`` against the JAX per-transform intermediates, and the
plain VJP from that state (what K5-inv-bwd computes on the card) against
``jax.vjp`` of the JAX stack's inverse."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocomc_tpu.models.coupling import apply_coupling_net, coupling_inverse as j_inverse
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu_torch.convert import load_flow_params
from pocomc_tpu_torch.models import transforms as tr
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import coupling_kernels as ck

N = 64
CASES = [("nsfc3", 4), ("nsfc3", 10), ("nsfc6", 4), ("nsfc6", 10)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flows(arch, d, seed):
    """A JAX coupling flow with random non-zero output weights and biases
    (tests/test_torch_gradient.py's recipe, identity pre-layer) and the
    port's flow with the same parameters."""
    jf = JFlow(d, arch, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    for tp in params["stack"]:
        for i, layer in enumerate(tp):
            if i == 3:
                layer["w"] = (0.02 * rng.standard_normal(layer["w"].shape)).astype(np.float32)
            layer["b"] = (0.02 * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    flow = load_flow_params(Flow(d, arch, device="cpu"), params)
    return jf, params, flow


def _jax_inverse(params, masks, z):
    """The JAX stack's inverse, transforms T-1..0 (models/flow.py)."""
    ladj = jnp.zeros(z.shape[0])
    for t in reversed(range(len(params))):
        z, l = j_inverse(params[t], masks[t], z, 8)
        ladj = ladj + l
    return z, ladj


@pytest.mark.parametrize("arch,d", CASES)
def test_inverse_save_mode_matches_jax_intermediates(arch, d):
    """x_t (the inverse's value after transform t), relu(h0..h2) and the
    spline parameters of every transform against the JAX stack's own
    intermediates on the same z: within 1e-5 of each array's largest
    magnitude (fp32, sums in another order, through up to six
    transforms); x and ladj equal the plain inverse without the save, bit
    for bit."""
    jf, params, flow = _flows(arch, d, seed=d)
    masks = jf.coupling_masks
    z = np.random.default_rng(d).standard_normal((N, d)).astype(np.float32)
    fp = flow.params()
    with torch.no_grad():
        x, ladj, state = ck.coupling_inverse_ref(torch.from_numpy(z), fp.ws, fp.bs, fp.masks,
                                                 save_inputs=True)
        x0, ladj0 = ck.coupling_inverse_ref(torch.from_numpy(z), fp.ws, fp.bs, fp.masks)
    assert torch.equal(x, x0) and torch.equal(ladj, ladj0)
    T, half = len(masks), (d + 1) // 2
    assert [tuple(s.shape) for s in state] == [(T, N, d)] + [(T, N, flow.n_hidden)] * 3 + \
        [(T, N, half * 23)]
    zj = jnp.asarray(z)
    for t in reversed(range(T)):
        stack = params["stack"][t]
        zc = zj[:, np.nonzero(masks[t])[0]]
        h = zc @ stack[0]["w"] + stack[0]["b"]
        hidden = [jax.nn.relu(h)]
        for l in (1, 2):
            h = h + jax.nn.relu(h) @ stack[l]["w"] + stack[l]["b"]
            hidden.append(jax.nn.relu(h))
        p = np.asarray(apply_coupling_net(stack, zc))
        zj, _ = j_inverse(stack, masks[t], zj, 8)
        _close(state[0][t], zj)
        for l in (1, 2, 3):
            _close(state[l][t], hidden[l - 1])
        n_p = p.shape[1]
        _close(state[4][t][:, :n_p], p)
        assert torch.all(state[4][t][:, n_p:] == 0)
    _close(x, zj)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("arch,d", CASES)
def test_vjp_from_saved_state_matches_jax(arch, d):
    """g_z from the saved state (``coupling_inverse_vjp_ref`` on it, the
    plain version of K5-inv-bwd's route) against jax.vjp of the JAX
    stack's inverse, dL/dladj nonzero: within 1e-3 of the largest |g_z|
    on rows whose spline inputs lie 1e-5 or more from a knot (the
    gradient jumps there); and within 1e-5 of the largest |g_z| of
    autograd through the plain inverse at z, which differentiates at the
    same intermediates and differs only by fp32 summation order."""
    jf, params, flow = _flows(arch, d, seed=d + 1)
    masks = jf.coupling_masks
    rng = np.random.default_rng(d + 1)
    z, g_x = (rng.standard_normal((N, d)).astype(np.float32) for _ in range(2))
    g_l = rng.standard_normal(N).astype(np.float32)
    _, vjp = jax.vjp(lambda zz: _jax_inverse(params["stack"], masks, zz), jnp.asarray(z))
    want = np.asarray(vjp((jnp.asarray(g_x), jnp.asarray(g_l)))[0])
    fp = flow.params()
    gx, gl = torch.from_numpy(g_x), torch.from_numpy(g_l)
    zz = torch.from_numpy(z).requires_grad_(True)
    by_autograd, = torch.autograd.grad(ck.coupling_inverse_ref(zz, fp.ws, fp.bs, fp.masks),
                                       zz, (gx, gl))
    with torch.no_grad():
        _, _, state = ck.coupling_inverse_ref(torch.from_numpy(z), fp.ws, fp.bs, fp.masks,
                                              save_inputs=True)
        got = ck.coupling_inverse_vjp_ref(state, fp.ws, fp.bs, fp.masks, gx, gl).numpy()
        near = torch.zeros(N, dtype=torch.bool)
        for t, m in enumerate(fp.masks):
            xt = state[0][t][:, torch.as_tensor(~m)]
            p = state[4][t][:, :xt.shape[1] * 23].reshape(N, xt.shape[1], 23)
            near |= ((xt[..., None] - tr._rqs_setup(p, 8)[0]).abs() < 1e-5).any(-1).any(-1)
    keep = ~near.numpy()
    assert keep.sum() >= N - 2
    scale = np.abs(want).max()
    assert np.abs(got - want)[keep].max() <= 1e-3 * scale
    assert np.abs(got - by_autograd.numpy()).max() <= 1e-5 * scale
