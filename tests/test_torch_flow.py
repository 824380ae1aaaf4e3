"""Parity of the PyTorch port's flow with the JAX package on the CPU.

The same numpy inputs and weights go through ``pocomc_tpu`` (its XLA code)
and ``pocomc_tpu_torch`` (the plain versions of its kernels, which is what
a CPU tensor runs). Tolerances are stated per test: fp32 sums taken in
another order, so agreement is to a few ulps of the values involved.
"""

import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocomc_tpu.models import made as jmade, transforms as jtr
from pocomc_tpu.models.flow import Flow as JFlow, fit_pre_jax, \
    fit_pre_numpy as j_fit_pre_numpy
import pocomc_tpu_torch  # noqa: F401  (sets the TF32 flags)
from pocomc_tpu_torch.convert import load_flow_params
from pocomc_tpu_torch.models import made as tmade, transforms as ttr
from pocomc_tpu_torch.models.flow import Flow, fit_pre_numpy, fit_pre_torch
from pocomc_tpu_torch.ops import flow_kernels as fk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def random_flow_params(d, arch, seed, scale=0.03):
    """A JAX flow's params with 'trained-like' random weights: the init
    hidden layers, N(0, scale^2) output weights and biases (much larger
    scales make the autoregressive inverse ill-conditioned in fp32 for
    both packages), and a random whitening pre-layer."""
    jf = JFlow(d, arch, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    stack = params["stack"]
    stack[-1]["w"] = (scale * rng.standard_normal(stack[-1]["w"].shape)).astype(np.float32)
    for layer in stack:
        layer["b"] = (scale * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    a = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    params["pre"] = dict(mean=rng.standard_normal(d).astype(np.float32),
                         w_fwd=a.astype(np.float32),
                         w_inv=np.linalg.inv(a).astype(np.float32),
                         ladj=np.float32(np.log(abs(np.linalg.det(a)))))
    jf.params = jax.device_put(params)
    return jf, params


# -- transforms -------------------------------------------------------------

@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_rqs_matches_jax_including_tails(direction):
    """RQS forward/inverse at points inside (-5, 5), at the knots' edges
    and in the identity tails; tolerance 2e-5 absolute + 1e-5 relative on
    values and log-dets (fp32, one spline; steep bins carry log-dets of
    several nats)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-7, 7, 300), [-5.0, 5.0, -4.999999, 4.999999, 0.0]])
    x = x.astype(np.float32)
    params = (1.5 * rng.standard_normal((x.size, 23))).astype(np.float32)
    jf = jtr.rqs_forward if direction == "forward" else jtr.rqs_inverse
    tf = ttr.rqs_forward if direction == "forward" else ttr.rqs_inverse
    yj, lj = jf(jnp.asarray(x), jnp.asarray(params), 8)
    yt, lt = tf(t(x), t(params), 8)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=2e-5)
    tails = np.abs(x) >= 5.0
    assert np.array_equal(yt.numpy()[tails], x[tails])
    assert np.all(lt.numpy()[tails] == 0.0)


def test_rqs_zero_params_is_identity():
    x = torch.linspace(-6, 6, 101)
    y, l = ttr.rqs_forward(x, torch.zeros(101, 23), 8)
    torch.testing.assert_close(y, x, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, torch.zeros(101), rtol=0, atol=1e-5)


def test_affine_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(50).astype(np.float32)
    p = rng.standard_normal((50, 2)).astype(np.float32)
    for jf, tf in ((jtr.affine_forward, ttr.affine_forward),
                   (jtr.affine_inverse, ttr.affine_inverse)):
        yj, lj = jf(jnp.asarray(x), jnp.asarray(p))
        yt, lt = tf(t(x), t(p))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6, atol=1e-6)


# -- MADE -------------------------------------------------------------------

def _made_pair(d, seed):
    rng = np.random.default_rng(seed)
    order = np.arange(d)[::-1].copy()
    hidden = [32, 32, 32]
    params, masks = jmade.init_made(rng, d, hidden, 23, order)
    params[-1]["w"] = (0.1 * rng.standard_normal(params[-1]["w"].shape)).astype(np.float32)
    for p in params:
        p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(np.float32)
    ws = [t(p["w"] * m) for p, m in zip(params, masks)]
    bs = [t(p["b"]) for p in params]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return jp, masks, ws, bs, rng


def test_made_masks_match_jax():
    order = np.array([2, 0, 1, 3])
    dj = jmade.make_degrees(4, order, [32, 32])
    dt = tmade.make_degrees(4, order, [32, 32])
    for a, b in zip(jmade.make_masks(dj, 4, 23), tmade.make_masks(dt, 4, 23)):
        assert np.array_equal(a, b)


def test_apply_made_matches_jax():
    """Full MADE pass; tolerance 1e-5 (fp32 matmuls, h=32)."""
    d = 4
    jp, masks, ws, bs, rng = _made_pair(d, 2)
    x = rng.standard_normal((64, d)).astype(np.float32)
    oj = jmade.apply_made(jp, [jnp.asarray(m) for m in masks], jnp.asarray(x), d, 23)
    ot = tmade.apply_made(ws, bs, t(x), d, 23)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [0, 2, 3])
def test_apply_made_dim_matches_jax(dim):
    """One output dimension's 23 parameters; tolerance 1e-5."""
    d = 4
    jp, masks, ws, bs, rng = _made_pair(d, 3)
    x = rng.standard_normal((64, d)).astype(np.float32)
    oj = jmade.apply_made_dim(jp, [jnp.asarray(m) for m in masks], jnp.asarray(x),
                              dim, 23)
    ot = tmade.apply_made_dim(ws, bs, t(x), dim, 23)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)


# -- flow -------------------------------------------------------------------

@pytest.mark.parametrize("d,arch,weights", [(3, "nsf3", "random"), (5, "nsf6", "random"),
                                            (5, "nsf6", "zero")])
def test_flow_matches_jax(d, arch, weights):
    """forward / inverse / log_prob of the whole flow with the same
    weights; tolerance 1e-4 on values and 5e-4 on log-densities (fp32
    through 3-6 transforms)."""
    if weights == "zero":
        jf = JFlow(d, arch, seed=0)
        params = jax.tree_util.tree_map(np.asarray, jax.device_get(jf.params))
    else:
        jf, params = random_flow_params(d, arch, seed=d)
    tf = load_flow_params(Flow(d, arch, device="cpu"), params)
    rng = np.random.default_rng(7)
    x = (1.5 * rng.standard_normal((128, d))).astype(np.float32)
    with torch.no_grad():
        zj, lj = jf.forward(jnp.asarray(x))
        zt, lt = tf.forward(t(x))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=5e-4)
        xj, lij = jf.inverse(zj)
        xt, lit = tf.inverse(t(np.asarray(zj)))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(lit.numpy(), np.asarray(lij), rtol=0, atol=5e-4)
        np.testing.assert_allclose(tf.log_prob(t(x)).numpy(),
                                   np.asarray(jf.log_prob(jnp.asarray(x))),
                                   rtol=0, atol=5e-4)
        # kernel contract: kernel_fwd reports -ladj, kernel_inv +ladj
        th, lk = tf.kernel_fwd(t(x))
        thj, lkj = jf.kernel_fwd(jf.params, jnp.asarray(x))
        np.testing.assert_allclose(lk.numpy(), np.asarray(lkj), rtol=0, atol=5e-4)
        _, lk2 = tf.kernel_inv(th)
        _, lk2j = jf.kernel_inv(jf.params, thj)
        np.testing.assert_allclose(lk2.numpy(), np.asarray(lk2j), rtol=0, atol=5e-4)
    if weights == "zero":
        np.testing.assert_allclose(zt.numpy(), x, atol=1e-5)


def test_sample_logq_matches_log_prob():
    """log q returned with the flow's draws is its density at the draws
    (Gaussian latent) and a Student-t density at the t draws; tolerance
    1e-3 (fp32 inverse then forward)."""
    d = 3
    _, params = random_flow_params(d, "nsf3", seed=11)
    tf = load_flow_params(Flow(d, "nsf3", device="cpu"), params)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        x, logq = tf.sample(256, generator=g)
        torch.testing.assert_close(logq, tf.log_prob(x), rtol=0, atol=1e-3)
        xt, logq_t = tf.sample_t(256, 5.0, generator=g)
        z, ladj = tf.forward(xt)
        from scipy.stats import multivariate_t
        ref = multivariate_t(np.zeros(d), np.eye(d), df=5.0).logpdf(z.double().numpy()) \
            + ladj.double().numpy()
        np.testing.assert_allclose(logq_t.numpy(), ref, rtol=0, atol=1e-3)


def test_fit_pre_matches_jax():
    """Whitening pre-layer fits: host f64 numpy (exact port) and the
    on-device torch fit against fit_pre_jax; tolerance 1e-4 (fp32)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 4))
    x = (rng.standard_normal((512, 4)) @ a + 3.0).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 512).astype(np.float32)
    prev = dict(mean=np.zeros(4, np.float32), w_fwd=np.eye(4, dtype=np.float32),
                w_inv=np.eye(4, dtype=np.float32), ladj=np.float32(0.0))
    for mode in ("full", "diag"):
        pn = fit_pre_numpy(x, w, prev, mode=mode)
        pj = j_fit_pre_numpy(x, w, prev, mode=mode)
        for k in pn:
            np.testing.assert_array_equal(pn[k], pj[k])
        pt_ = fit_pre_torch(t(x), t(w), mode=mode)
        pjx = fit_pre_jax(jnp.asarray(x), jnp.asarray(w), mode=mode)
        for k in pt_:
            np.testing.assert_allclose(pt_[k].numpy(), np.asarray(pjx[k]),
                                       rtol=1e-4, atol=1e-4)
    # degenerate set (ESS below min_ess): identity fallback
    w1 = np.zeros(512, np.float32)
    w1[0] = 1.0
    pd = fit_pre_torch(t(x), t(w1))
    assert torch.equal(pd["w_fwd"], torch.eye(4)) and float(pd["ladj"]) == 0.0


# -- kernel wrappers on the CPU --------------------------------------------

@pytest.mark.parametrize("which", ["forward", "inverse"])
def test_kernel_wrappers_on_cpu_equal_plain_and_launch_nothing(which):
    """A CPU tensor goes to the plain version: identical results, and the
    launch counters do not move."""
    d = 4
    _, params = random_flow_params(d, "nsf3", seed=4)
    tf = load_flow_params(Flow(d, "nsf3", device="cpu"), params)
    fp = tf.params()
    y = torch.randn(32, d, generator=torch.Generator().manual_seed(1))
    before = (fk.made_rqs_forward.launches, fk.ar_inverse.launches)
    with torch.no_grad():
        if which == "forward":
            a = fk.made_rqs_forward(y, fp.ws, fp.bs)
            b = fk.made_rqs_forward_ref(y, fp.ws, fp.bs)
        else:
            a = fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders)
            b = fk.ar_inverse_ref(y, fp.ws, fp.bs, fp.inv_orders)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert (fk.made_rqs_forward.launches, fk.ar_inverse.launches) == before


def test_kernel_wrappers_reject_bad_inputs():
    tf = Flow(3, "nsf3", device="cpu")
    fp = tf.params()
    with torch.no_grad():
        with pytest.raises(TypeError):
            fk.made_rqs_forward(torch.zeros(4, 3, dtype=torch.float64), fp.ws, fp.bs)
        with pytest.raises(ValueError):
            fk.made_rqs_forward(torch.zeros(4, 2), fp.ws, fp.bs)
        with pytest.raises(ValueError):
            fk.ar_inverse(torch.zeros(3, 4).T, fp.ws, fp.bs, fp.inv_orders)
        with pytest.raises(ValueError):
            fk.made_rqs_forward(torch.zeros(4, 3), fp.ws[:3], fp.bs[:3])


def test_unported_flow_kinds_raise():
    """Every kind of the menu is ported at every bins the JAX package runs,
    on the CPU and on CUDA: the check the wrappers and Flow(device="cuda")
    call (held without a card) takes 2-16 bins (compiled libraries) and
    17-1000 (the library of run-time bins; no ceiling stands below 1000,
    the most a spline holds, since every planner holds 1000 bins wherever
    it holds 16: tests/test_torch_bins_wide.py), and past 1000 does as the
    JAX package does, with no refusal of its own. Fewer than 2 bins raise
    ValueError for the spline kinds on every device."""
    from pocomc_tpu_torch.ops.flow_kernels import check_bins
    for arch in ("maf6", "nsf6", "nsfc6"):
        assert Flow(4, arch, device="cpu").bins == 8
        assert Flow(4, arch, bins=12, device="cpu").bins == 12
        assert Flow(4, arch, bins=17, device="cpu").bins == 17
    for bins in range(2, 1002):
        assert check_bins(bins) == bins
    for arch in ("nsf6", "nsfc6"):
        for bins in (0, 1):
            with pytest.raises(ValueError, match="bins >= 2"):
                Flow(4, arch, bins=bins, device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, pocomc_tpu_torch, pocomc_tpu_torch.sampler, "
            "pocomc_tpu_torch.convert, pocomc_tpu_torch.phases; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('pocomc_tpu.') or m == 'pocomc_tpu' "
            "for m in sys.modules); "
            "import torch; assert not torch.backends.cuda.matmul.allow_tf32")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
