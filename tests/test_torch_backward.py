"""K2's backward on the CPU: the plain version ``made_rqs_backward_ref``
(closed-form spline and layer derivatives, no autograd) against autograd of
the plain forward and against ``jax.grad`` of the JAX package's training
loss, plus the ``Flow`` device rule.

Tolerances: in float64 the closed form and autograd compute the same
derivatives in another order, so they agree to 1e-10 of the largest
gradient; in float32 both round differently through 3-6 transforms, and
agree to 1e-4 of the largest gradient (each is within ~1e-5 of the float64
gradient at these weights)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocomc_tpu.models.flow import Flow as JFlow
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import load_flow_params
from pocomc_tpu_torch.models import transforms as ttr
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk

CASES = ["random", "tails", "knots", "zero_rows", "identity"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(d, arch, case, dtype, n=96):
    """A flow's masked weights, inputs y and upstream gradients (g_z,
    g_ladj) for one case, from a numpy seed:

    * random: output weights and biases ~ N(0, 0.05^2) over the init;
    * tails: a third of the rows with |y| >= 5 (exactly +-5 among them);
    * knots: rows whose first dimension sits exactly on a knot of the
      first transform's spline (its parameters do not depend on y[:, 0]);
    * zero_rows: half the rows with zero upstream gradient, as rows of
      zero weight give in the training loss;
    * identity: the initial flow (zero output layer, the identity map)."""
    rng = np.random.default_rng(d + 10 * len(arch) + CASES.index(case))
    flow = Flow(d, arch, device="cpu")
    if case != "identity":
        with torch.no_grad():
            flow.weights[-1].copy_(torch.from_numpy(0.05 * rng.standard_normal(
                flow.weights[-1].shape)))
            for b in flow.biases:
                b.copy_(torch.from_numpy(0.05 * rng.standard_normal(b.shape)))
    flow = flow.to(dtype)
    fp = flow.params()
    ws = [w.detach() for w in fp.ws]
    bs = [b.detach() for b in fp.bs]
    y = torch.from_numpy(1.5 * rng.standard_normal((n, d))).to(dtype)
    g_z = torch.from_numpy(rng.standard_normal((n, d))).to(dtype)
    g_l = torch.from_numpy(rng.standard_normal(n)).to(dtype)
    if case == "tails":
        k = n // 3
        y[:k] = torch.from_numpy(rng.choice([-1.0, 1.0], (k, d))
                                 * rng.uniform(5.0, 8.0, (k, d))).to(dtype)
        y[0, 0], y[1, 0], y[2, :] = 5.0, -5.0, -5.0
    elif case == "knots":
        from pocomc_tpu_torch.models.made import apply_made
        p = apply_made([w[0] for w in ws], [b[0] for b in bs], y, d, fk.N_PARAMS)
        xk = ttr._rqs_setup(p[:, 0], fk.BINS)[0]
        j = torch.from_numpy(rng.integers(0, fk.BINS + 1, n))
        y[:, 0] = xk[torch.arange(n), j]
    elif case == "zero_rows":
        g_z[::2] = 0.0
        g_l[::2] = 0.0
    return ws, bs, y, g_z, g_l


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,arch", [(3, "nsf3"), (5, "nsf6")])
def test_backward_ref_matches_autograd(d, arch, case, dtype):
    ws, bs, y, g_z, g_l = _problem(d, arch, case, dtype)
    inp = [a.clone().requires_grad_(True) for a in [y, *ws, *bs]]
    z, ladj = fk.made_rqs_forward_ref(inp[0], inp[1:5], inp[5:9])
    want = torch.autograd.grad((z, ladj), inp, (g_z, g_l))
    g_y, g_ws, g_bs = fk.made_rqs_backward_ref(y, ws, bs, g_z, g_l)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for name, got, ref in zip(["y"] + [f"w{l}" for l in range(4)] + [f"b{l}" for l in range(4)],
                              [g_y, *g_ws, *g_bs], want):
        scale = float(ref.abs().max()) + 1e-30
        assert float((got - ref).abs().max()) <= tol * scale, (name, case)
    if case == "zero_rows":
        assert torch.all(g_y[::2] == 0.0)
    if case == "tails":
        outside = (y.abs() >= 5.0)
        # the first transform is the identity there: the gradient passes
        # into y unchanged whatever the later transforms do with it
        assert torch.isfinite(g_y).all() and outside.any()


@pytest.mark.parametrize("d,arch,seed", [(3, "nsf3", 1), (5, "nsf6", 2)])
def test_loss_gradient_matches_jax_grad(d, arch, seed):
    """The port's loss gradient through ``made_rqs_backward_ref`` (times the
    masks) against ``jax.grad`` of the JAX package's ``Flow._loss_fn`` with
    the same weights and batch (a quarter of the rows of weight zero); to
    1e-4 of the largest gradient of each leaf."""
    rng = np.random.default_rng(seed)
    jf = JFlow(d, arch, seed=seed)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    for layer in params["stack"]:
        layer["w"] = (layer["w"] + 0.05 * rng.standard_normal(layer["w"].shape)
                      ).astype(np.float32)
        layer["b"] = (0.05 * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    jf.params = jax.device_put(params)
    xb = (1.5 * rng.standard_normal((128, d))).astype(np.float32)
    wb = rng.random(128).astype(np.float32)
    wb[::4] = 0.0
    jg = jax.grad(lambda st: jf._loss_fn(st, jnp.asarray(xb), jnp.asarray(wb), None, None))(
        jax.device_put(params["stack"]))

    tf = load_flow_params(Flow(d, arch, device="cpu"), params)
    fp = tf.params()
    ws, bs = [w.detach() for w in fp.ws], [b.detach() for b in fp.bs]
    y, w = torch.from_numpy(xb), torch.from_numpy(wb)
    z, _ = fk.made_rqs_forward_ref(y, ws, bs)
    # loss = sum(-(log N(z) + ladj) * w * 1000) / sum(w)
    scale = 1000.0 * w / w.sum()
    _, g_ws, g_bs = fk.made_rqs_backward_ref(y, ws, bs, scale[:, None] * z, -scale)
    for l, layer in enumerate(jg):
        for got, key in ((g_ws[l] * tf.masks[l], "w"), (g_bs[l], "b")):
            ref = np.asarray(layer[key])
            err = float(np.abs(got.numpy() - ref).max())
            assert err <= 1e-4 * (float(np.abs(ref).max()) + 1e-30), (l, key, err)


def test_spline_vjp_matches_autograd_in_float64():
    """``rqs_forward_vjp`` alone, at points inside, on knots, at the clamp
    edges and in the tails: to 1e-12 of the largest gradient."""
    rng = np.random.default_rng(3)
    n = 400
    p = torch.from_numpy(1.5 * rng.standard_normal((n, 23)))
    x = torch.from_numpy(rng.uniform(-7, 7, n))
    xk = ttr._rqs_setup(p, 8)[0]
    x[:40] = xk[:40, torch.from_numpy(rng.integers(0, 9, 40))].diagonal()
    x[40:46] = torch.tensor([-5.0, 5.0, -4.999999, 4.999999, -4.9999995, 0.0],
                            dtype=torch.float64)
    g_y = torch.from_numpy(rng.standard_normal(n))
    g_l = torch.from_numpy(rng.standard_normal(n))
    xa, pa = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    y, l = ttr.rqs_forward(xa, pa, 8)
    want = torch.autograd.grad((y, l), (xa, pa), (g_y, g_l))
    got = ttr.rqs_forward_vjp(x, p, g_y, g_l, 8)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    tails = x.abs() >= 5.0
    assert torch.equal(got[0][tails], g_y[tails]) and torch.all(got[1][tails] == 0.0)


def test_backward_wrapper_on_cpu_is_plain_and_launches_nothing():
    ws, bs, y, g_z, g_l = _problem(4, "nsf3", "random", torch.float32, n=33)
    before = (fk.made_rqs_forward.launches, fk.made_rqs_backward.launches)
    z, ladj, acts = fk.made_rqs_forward(y, ws, bs, save_inputs=True)
    h = ws[1].shape[1]
    assert [tuple(a.shape) for a in acts] == [(3, 33, 4)] + [(3, 33, h)] * 3
    assert torch.equal(acts[0][0], y)
    a = fk.made_rqs_backward(y, ws, bs, g_z, g_l, acts)
    b = fk.made_rqs_backward_ref(y, ws, bs, g_z, g_l)
    for u, v in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        assert torch.equal(u, v)
    assert (fk.made_rqs_forward.launches, fk.made_rqs_backward.launches) == before
    with pytest.raises(ValueError):
        fk.made_rqs_backward(y[:, :3].contiguous(), ws, bs, g_z, g_l)


@pytest.mark.parametrize("d,arch", [(3, "nsf3"), (5, "nsf6")])
def test_saved_layer_inputs_are_the_made_states(d, arch):
    """``save_inputs`` changes nothing of (z, ladj) and returns, for every
    transform, its input (the last transform's output for the next) and
    relu of the three hidden states of its MADE pass, as ``made.py``
    computes them; the backward given them equals the backward without."""
    from pocomc_tpu_torch.models import made
    ws, bs, y, g_z, g_l = _problem(d, arch, "random", torch.float32)
    z, ladj = fk.made_rqs_forward_ref(y, ws, bs)
    z2, ladj2, acts = fk.made_rqs_forward_ref(y, ws, bs, save_inputs=True)
    assert torch.equal(z, z2) and torch.equal(ladj, ladj2)
    x = y
    for t in range(ws[0].shape[0]):
        w, b = [a[t] for a in ws], [a[t] for a in bs]
        assert torch.equal(acts[0][t], x)
        for l in (1, 2, 3):
            h = made.hidden_stack(w[:l] + [w[3]], b[:l] + [b[3]], x)
            assert torch.equal(acts[l][t], torch.relu(h))
        x, _ = ttr.rqs_forward(x, made.apply_made(w, b, x, d, fk.N_PARAMS), fk.BINS)
    assert torch.equal(x, z)
    a = fk.made_rqs_backward_ref(y, ws, bs, g_z, g_l, acts)
    b = fk.made_rqs_backward_ref(y, ws, bs, g_z, g_l)
    for u, v in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        assert torch.equal(u, v)


@pytest.mark.parametrize("d", [1, 2, 10, 50, 200, 817, 1341, 2730])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_k2_launch_config_fits_a_hopper_block(d, backward):
    """The tile of a K2 launch fits the 227 KB of shared memory a block may
    have (the sources' smem formulas) at every d up to 2730 (h = 8192).
    Forward: P rows, a group and a ring stage of at least one column of
    every layer, ~128 blocks where n allows; the state grows with d + h, so
    d = 817 and 1341, where a state of d*23 floats a row no longer fit,
    still launch. Backward (K5's tiles, ``_k2_backward_plan``): an instance
    the source compiles, output groups of whole dimensions within an output
    pass, ~128 blocks where n allows, and a pack of the weights' size or
    more (every weight once, padded)."""
    h = max(1 << (3 * d - 1).bit_length(), 32)
    for n in (1, 37, 256, 1024, 4096, 16384):
        if not backward:
            state = d + 2 * h + 1
            P, G, SL = fk._k2_config(n, d, h)
            assert P in (1, 2, 4, 8, 16) and 1 <= G <= d
            assert SL >= h + 1 and SL % 4 == 0
            assert 4 * (P * (state + G * fk.N_PARAMS) + 4 + 2 * SL) <= 227 * 1024
            # the forward's groups take up to half the block, all of d <= 50
            assert 4 * P * (state + G * fk.N_PARAMS) <= 227 * 1024 // 2
            assert G == d or d > 50
            if n >= 256 and d <= 10:
                assert -(-n // P) >= 128 and G == d
            continue
        for np_ in (fk.N_PARAMS, 2):
            cfg, pack = fk._k2_backward_plan(n, d, h, 6, np_)
            assert (cfg.RL, cfg.RM, cfg.RNH, cfg.RNO) in ck.k5_instances(True)
            assert cfg.smem == 4 * ck._k5_smem_floats(cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G,
                                                      cfg.BK, cfg.S, d, h, True, np_)
            assert cfg.smem <= 227 * 1024
            assert 1 <= cfg.G <= d and cfg.G * np_ <= cfg.ldo
            assert cfg.G == min(d, cfg.ldo // np_)
            assert pack >= 6 * (d * h + 2 * h * h + h * d * np_) and pack % 4 == 0
            if n >= 1024 and h <= 512:
                assert -(-n // cfg.BM) >= 128


def test_k2_launch_config_refuses_what_no_block_holds():
    """From h = 16384 (d > 2730) a ring stage cannot hold a column of a
    square layer beside the tile; the forward refuses, and the backward,
    which reads what the forward saved, refuses with it."""
    with pytest.raises(ValueError, match="shared memory"):
        fk._k2_config(1024, 2731, 16384)
    with pytest.raises(ValueError, match="shared memory"):
        fk._k2_backward_plan(1024, 2731, 16384, 6)


def test_flow_defaults_to_the_card(monkeypatch):
    """``Flow`` builds on CUDA unless asked for the CPU: without a card it
    raises and names device='cpu'; on the CPU every parameter and buffer
    lies there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Flow(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpc.Flow(3, "nsf3")
    f = Flow(3, "nsf3", device="cpu")
    assert all(t.device.type == "cpu" for t in [*f.parameters(), *f.buffers()])


def test_sampler_on_cpu_builds_its_flow_on_the_cpu():
    prior = tpc.Prior([tpc.Normal(0.0, 1.0) for _ in range(3)])
    s = tpc.Sampler(prior, lambda x: -(x * x).sum(-1), vectorize=True, flow="nsf3",
                    device="cpu", random_state=0)
    assert all(t.device.type == "cpu" for t in [*s.flow.parameters(), *s.flow.buffers()])
