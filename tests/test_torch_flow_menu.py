"""The rest of the flow menu on the port: masked affine flows (maf*, K2 and
K1 with the affine head) and coupling spline flows (nsfc*, K5), held to
the JAX package on the CPU.

The same numpy weights go through ``pocomc_tpu`` (its XLA code) and
``pocomc_tpu_torch`` (the plain versions of its kernels, which is what a
CPU tensor runs), loaded through ``convert.load_flow_params``. Tolerances:
rtol 1e-5 and atol 1e-5 on values of one pass (atol 5e-5 through a whole
stack of spline transforms: XLA and torch round a spline's terms
differently, and one ulp of a steep bin's knot moves its output by up to
3.1e-5 on this grid), rtol 1e-5 and atol 1e-4 on log-dets and
log-densities (fp32 sums in another order; 5e-4 through 12 spline
transforms, as tests/test_torch_flow.py holds nsf stacks), and 1e-4 of the largest
gradient of each tensor on gradients. Past 16 bins the values and
log-dets are held to the port's plain route in float64 at the same
tolerances (``FLOAT64_PAST``), which the JAX package's float64 route
repeats to 1e-12.
The CUDA kernels are held to these plain versions on a card in
``tests/test_torch_gpu.py`` (marked ``gpu``).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocomc_tpu.models.flow import Flow as JFlow
import pocomc_tpu_torch  # noqa: F401  (sets the TF32 flags)
from pocomc_tpu_torch.convert import load_flow_params
from pocomc_tpu_torch.models import coupling as tcoup, transforms as ttr
from pocomc_tpu_torch.models.flow import CouplingParams, Flow, FlowParams
from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import spline_parity  # noqa: E402  (the float64 routes of both packages)

TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-5, atol=5e-5)
LADJ = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(stack, arch):
    """The {w, b} layers of a JAX stack, transform-major for coupling."""
    return [layer for tp in stack for layer in tp] if arch.startswith("nsfc") else stack


def random_params(d, arch, seed, scale=0.02, bins=8):
    """A JAX flow with random non-zero weights: the init hidden layers,
    N(0, scale^2) output weights and biases, and a random whitening
    pre-layer; returns (the JAX flow, its params as numpy). Larger scales
    make the inverse ill-conditioned in fp32 for both packages (a round
    trip of a JAX nsfc6 at d=6 misses x by 8e-3 at 0.03)."""
    jf = JFlow(d, arch, bins=bins, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    layers = _layers(params["stack"], arch)
    for i, layer in enumerate(layers):
        if i % 4 == 3:
            layer["w"] = (scale * rng.standard_normal(layer["w"].shape)).astype(np.float32)
        layer["b"] = (scale * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    a = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    params["pre"] = dict(mean=rng.standard_normal(d).astype(np.float32),
                         w_fwd=a.astype(np.float32),
                         w_inv=np.linalg.inv(a).astype(np.float32),
                         ladj=np.float32(np.log(abs(np.linalg.det(a)))))
    jf.params = jax.device_put(params)
    return jf, params


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


MENU = [(arch, d) for arch in ("maf3", "maf6", "nsfc3", "nsfc6") for d in (2, 3, 4, 10)]
MENU += [("maf12", 3), ("nsfc12", 3)]
# the spline kinds at other bins: 2 (the fewest), 3, 5 (neither a power of
# two), 12 and 16 (past the 10 whose parameters fit a warp's lanes in the
# kernels), 17, 32 and 64 (the kernels' library of run-time bins); the
# menu's cases keep their ids at 8 bins
BINS_MENU = [(arch, d, b) for arch in ("nsf3", "nsfc3") for d in (3, 10)
             for b in (2, 3, 5, 12, 16, 17, 32, 64)]
# past ``COMPENSATED_PAST`` bins the port's plain route takes the kernels'
# compensated knots, and a case is held to float64 (the port's plain route
# in float64, which the JAX package's float64 route repeats to 1e-12,
# ``test_float64_routes_agree``) in place of the JAX package's fp32 route:
# that one's log-dets lie up to 2.2e-4 from float64 at 64 bins and d=10,
# past LADJ (its knots are triangular products of the sizes, each width a
# difference of two of them), and 0.97 LADJ at nsfc3, 32 bins, where the
# port's lie within 0.47 LADJ (``tools/spline_parity.py``)
FLOAT64_PAST = ttr.COMPENSATED_PAST
MENU_BINS = ([pytest.param(arch, d, 8, id=f"{arch}-{d}") for arch, d in MENU]
             + [pytest.param(*case, id="{}-{}-bins{}".format(*case)) for case in BINS_MENU])


@pytest.mark.parametrize("arch,d,bins", MENU_BINS)
def test_forward_inverse_log_prob_match_jax(arch, d, bins):
    """forward (z, ladj), inverse (x, ladj) and log_prob of the port's
    ``Flow(device="cpu")`` against the JAX ``Flow`` on the same weights, at
    the spline's ``bins``; d=3 gives the coupling flows unequal halves."""
    ladj_tol = 5e-4 if arch == "nsfc12" else LADJ
    jf, params = random_params(d, arch, seed=d, bins=bins)
    tf = load_flow_params(Flow(d, arch, bins=bins, device="cpu"), params)
    rng = np.random.default_rng(d + 7)
    x = (1.5 * rng.standard_normal((64, d))).astype(np.float32)
    with torch.no_grad():
        z, l = tf.forward(torch.from_numpy(x))
        xi, li = tf.inverse(torch.from_numpy(x))
        lp = tf.log_prob(torch.from_numpy(x))
    if bins > FLOAT64_PAST:
        zj, lj, xj, lij, lpj, _ = spline_parity.torch_outputs(arch, d, bins, params, x, True)
    else:
        (zj, lj), (xj, lij), lpj = jf.forward(x), jf.inverse(x), jf.log_prob(x)
    close(z, zj, **STACK_TOL)
    close(l, lj, rtol=1e-5, atol=ladj_tol)
    close(xi, xj, **STACK_TOL)
    close(li, lij, rtol=1e-5, atol=ladj_tol)
    close(lp, lpj, rtol=1e-5, atol=ladj_tol)


@pytest.mark.parametrize("arch", ["nsf3", "nsfc3"])
def test_float64_routes_agree(arch):
    """The float64 reference of the cases past ``FLOAT64_PAST`` bins is the
    function of both packages: the JAX ``Flow`` with ``jax_enable_x64`` (in
    a subprocess) and the port's plain route in float64 agree to 1e-12 on
    the forward, the log-dets and log_prob, and the JAX float64 forward
    undoes the port's float64 inverse to 1e-12."""
    todo = []
    for a, d, bins in BINS_MENU:
        if a == arch and bins > FLOAT64_PAST:
            x = (1.5 * np.random.default_rng(d + 7).standard_normal((64, d))).astype(np.float32)
            todo.append((f"{a}-{d}-{bins}", a, d, bins, random_params(d, a, d, bins=bins)[1], x))
    refs = [spline_parity.torch_outputs(*case[1:], True) for case in todo]
    for name, diffs in spline_parity.jax_float64(todo, refs).items():
        assert max(diffs.values()) < 1e-12, (name, diffs)


@pytest.mark.parametrize("arch,d", [("maf3", 3), ("maf6", 5), ("nsfc3", 3), ("nsfc6", 6)])
def test_identity_at_init_round_trip_and_antisymmetry(arch, d):
    """A fresh flow is the identity (zero output layers); with random
    weights inverse(forward(x)) = x to 5e-4 and the two log-dets cancel to
    1e-3 (a round trip sums the rounding of 2T passes)."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32))
    fresh = Flow(d, arch, device="cpu")
    with torch.no_grad():
        z, l = fresh.forward(x)
    torch.testing.assert_close(z, x, rtol=0, atol=1e-6)
    assert float(l.abs().max()) < 1e-5
    _, params = random_params(d, arch, seed=3 * d)
    tf = load_flow_params(Flow(d, arch, device="cpu"), params)
    with torch.no_grad():
        z, l = tf.forward(x)
        xr, li = tf.inverse(z)
    torch.testing.assert_close(xr, x, rtol=0, atol=5e-4)
    torch.testing.assert_close(l + li, torch.zeros_like(l), rtol=0, atol=1e-3)


GRAD_MENU = [("maf3", 3, 1), ("maf6", 4, 2), ("nsfc3", 3, 3), ("nsfc6", 4, 4)]
# the loss gradient at the bins where the kernels' layouts change (3 and 5,
# neither a power of two; 16, past the 10 whose parameters fit a warp's
# lanes; 17 and 32, the library of run-time bins), at d=3: JAX compiles
# each case anew (~2.5 s each on the CPU)
GRAD_BINS = ([pytest.param(*case, 8, id="{}-{}-{}".format(*case)) for case in GRAD_MENU]
             + [pytest.param(arch, 3, 8, b, id=f"{arch}-3-bins{b}")
                for arch in ("nsf3", "nsfc3") for b in (3, 5, 16, 17, 32)])


def on_kink_or_knot(flow, x, window=1e-5):
    """Rows of x (n, d) at which a transform of ``flow``'s stack has a
    hidden pre-activation (a ReLU's kink) or its spline's input (a knot,
    where the bin changes) within ``window``: there the loss is not
    differentiable, and two correct fp32 routes may take either side (at
    nsf3, d=3, 12 bins a row's pre-activation of 5.8e-8 moved a weight's
    gradient by 1.3e-3 of its size, the JAX route on float64's side)."""
    fp = flow.params()
    x = torch.from_numpy(x)
    near = torch.zeros(x.shape[0], dtype=torch.bool)
    with torch.no_grad():
        for t in range(flow.n_transforms):
            if flow.kind == "nsfc":
                ws, bs = fp.ws[t], fp.bs[t]
                cond, trans = tcoup.halves(fp.masks[t], "cpu")
                inp, xs = x[:, cond], x[:, trans]
            else:
                ws, bs = [w[t] for w in fp.ws], [b[t] for b in fp.bs]
                inp, xs = x, x
            h = inp @ ws[0] + bs[0]
            hs = [h]
            for l in (1, 2):
                h = h + (torch.relu(h) @ ws[l] + bs[l])
                hs.append(h)
            near |= torch.cat(hs, 1).abs().amin(1) < window
            p = (torch.relu(h) @ ws[3] + bs[3]).reshape(x.shape[0], xs.shape[1], -1)
            if flow.kind != "maf":
                knots = ttr._rqs_setup(p, flow.bins)[0][..., 1:-1]
                near |= (xs[..., None] - knots).abs().flatten(1).amin(1) < window
            x = (tcoup.coupling_forward(ws, bs, fp.masks[t], x, flow.bins)[0]
                 if flow.kind == "nsfc" else fk._element(flow.head, flow.bins)[0](x, p)[0])
    return near.numpy()


@pytest.mark.parametrize("arch,d,seed,bins", GRAD_BINS)
def test_loss_gradient_matches_jax_grad(arch, d, seed, bins):
    """The gradient of the port's ``Flow._loss_fn`` (plain autograd on the
    CPU) against ``jax.grad`` of the JAX package's (jitted), with the
    Laplace and Gaussian penalties on every weight, a quarter of the rows
    of weight zero, at the spline's ``bins``: max |diff| / max |grad| <=
    1e-4 for every weight and bias. At other bins than 8 the rows on a
    kink or a knot take weight zero too (``on_kink_or_knot``)."""
    jf, params = random_params(d, arch, seed, bins=bins)
    rng = np.random.default_rng(seed)
    xb = (1.5 * rng.standard_normal((128, d))).astype(np.float32)
    wb = rng.random(128).astype(np.float32)
    wb[::4] = 0.0
    tf = load_flow_params(Flow(d, arch, bins=bins, device="cpu"), params)
    if bins != 8:
        wb[on_kink_or_knot(tf, xb)] = 0.0
    jg = jax.jit(jax.grad(lambda st: jf._loss_fn(st, jnp.asarray(xb), jnp.asarray(wb), 7.0,
                                                 3.0)))(jax.device_put(params["stack"]))
    loss = tf._loss_fn(torch.from_numpy(xb), torch.from_numpy(wb), laplace_scale=7.0,
                       gaussian_scale=3.0)
    loss.backward()
    for l, layer in enumerate(_layers(jg, arch)):
        for got, key in ((tf.weights[l].grad, "w"), (tf.biases[l].grad, "b")):
            ref = np.asarray(layer[key])
            err = float(np.abs(got.numpy() - ref).max())
            assert err <= 1e-4 * (float(np.abs(ref).max()) + 1e-30), (l, key, err)


def test_affine_vjp_matches_autograd_in_float64():
    rng = np.random.default_rng(5)
    n = 300
    x = torch.from_numpy(rng.uniform(-6, 6, n))
    p = torch.from_numpy(4.0 * rng.standard_normal((n, 2)))
    g_z, g_l = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    xa, pa = x.clone().requires_grad_(True), p.clone().requires_grad_(True)
    z, l = ttr.affine_forward(xa, pa)
    want = torch.autograd.grad((z, l), (xa, pa), (g_z, g_l))
    for a, b in zip(ttr.affine_forward_vjp(x, p, g_z, g_l), want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def _stack(d, arch, seed, dtype=torch.float64):
    """The compute-ready parameters of a random flow, in ``dtype``."""
    _, params = random_params(d, arch, seed)
    tf = load_flow_params(Flow(d, arch, device="cpu"), params).to(dtype)
    with torch.no_grad():
        return tf.params()


@pytest.mark.parametrize("d", [3, 4])
def test_affine_backward_ref_matches_autograd(d):
    """``made_rqs_backward_ref`` with the affine head against autograd of
    ``made_rqs_forward_ref`` with it, in float64 (to 1e-10 of the largest
    gradient of each tensor); rows of zero upstream gradient stay 0."""
    fp = _stack(d, "maf6", d)
    rng = np.random.default_rng(d)
    y = torch.from_numpy(2.0 * rng.standard_normal((40, d)))
    g_z = torch.from_numpy(rng.standard_normal((40, d)))
    g_l = torch.from_numpy(rng.standard_normal(40))
    g_z[::3], g_l[::3] = 0.0, 0.0
    inp = [a.clone().requires_grad_(True) for a in [y, *fp.ws, *fp.bs]]
    z, ladj = fk.made_rqs_forward_ref(inp[0], inp[1:5], inp[5:9], head="affine")
    want = torch.autograd.grad((z, ladj), inp, (g_z, g_l))
    g_y, g_ws, g_bs = fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l, head="affine")
    for got, ref in zip([g_y, *g_ws, *g_bs], want):
        assert float((got - ref).abs().max()) <= 1e-10 * (float(ref.abs().max()) + 1e-30)
    assert torch.all(g_y[::3] == 0.0)


@pytest.mark.parametrize("d,arch", [(2, "nsfc3"), (3, "nsfc6"), (4, "nsfc3")])
def test_coupling_backward_ref_matches_autograd(d, arch):
    """``coupling_backward_ref`` against autograd of
    ``coupling_forward_ref`` in float64, with a third of the rows in the
    spline tails: to 1e-10 of the largest gradient of each tensor."""
    fp = _stack(d, arch, d + 10)
    rng = np.random.default_rng(d)
    n = 48
    y = torch.from_numpy(2.0 * rng.standard_normal((n, d)))
    y[: n // 3] = torch.from_numpy(rng.choice([-1.0, 1.0], (n // 3, d))
                                   * rng.uniform(5.0, 8.0, (n // 3, d)))
    g_z = torch.from_numpy(rng.standard_normal((n, d)))
    g_l = torch.from_numpy(rng.standard_normal(n))
    flat = [a for t in fp.ws for a in t] + [a for t in fp.bs for a in t]
    inp = [a.clone().requires_grad_(True) for a in [y, *flat]]
    T = len(fp.ws)
    ws = [inp[1 + 4 * t:5 + 4 * t] for t in range(T)]
    bs = [inp[1 + 4 * T + 4 * t:5 + 4 * T + 4 * t] for t in range(T)]
    z, ladj = ck.coupling_forward_ref(inp[0], ws, bs, fp.masks)
    want = torch.autograd.grad((z, ladj), inp, (g_z, g_l))
    g_x, g_ws, g_bs = ck.coupling_backward_ref(y, fp.ws, fp.bs, fp.masks, g_z, g_l)
    got = [g_x, *[g for t in g_ws for g in t], *[g for t in g_bs for g in t]]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-10 * (float(b.abs().max()) + 1e-30)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_coupling_saved_inputs_and_pass_through(d):
    """``save_inputs`` changes nothing of (z, ladj) and returns each
    transform's whole input row and relu of its three hidden states; one
    coupling transform leaves its conditioning columns bit for bit, in
    both directions."""
    fp = _stack(d, "nsfc6", d, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((30, d)).astype(np.float32))
    z, l = ck.coupling_forward(x, fp.ws, fp.bs, fp.masks)
    z2, l2, acts = ck.coupling_forward(x, fp.ws, fp.bs, fp.masks, save_inputs=True)
    assert torch.equal(z, z2) and torch.equal(l, l2)
    h = fp.ws[0][1].shape[0]
    assert [tuple(a.shape) for a in acts] == [(6, 30, d)] + [(6, 30, h)] * 3
    assert torch.equal(acts[0][0], x)
    for t in range(6):
        cond = fp.masks[t]
        for fn in (ck.coupling_forward, ck.coupling_inverse):
            out, _ = fn(x, fp.ws[t:t + 1], fp.bs[t:t + 1], fp.masks[t:t + 1])
            assert torch.equal(out[:, cond], x[:, cond])
            assert not torch.equal(out[:, ~cond], x[:, ~cond])


def test_coupling_masks_and_init_match_jax():
    from pocomc_tpu.models import coupling as jcoup
    for d in (2, 3, 7):
        for a, b in zip(tcoup.make_coupling_masks(d, 6), jcoup.make_coupling_masks(d, 6)):
            assert np.array_equal(a, b)
        m = tcoup.make_coupling_masks(d, 2)[1]
        pa = tcoup.init_coupling(np.random.default_rng(1), d, [32] * 3, 23, m)
        pb = jcoup.init_coupling(np.random.default_rng(1), d, [32] * 3, 23, m)
        for a, b in zip(pa, pb):
            assert np.array_equal(a["w"], b["w"]) and np.array_equal(a["b"], b["b"])


def test_params_kinds_and_cpu_wrappers_launch_nothing():
    """maf* gives FlowParams with the affine head's width, nsfc*
    CouplingParams with the JAX halves; the wrappers run the plain
    versions on a CPU tensor and count no launch."""
    fm, fc = Flow(3, "maf3", device="cpu"), Flow(3, "nsfc3", device="cpu")
    pm, pc = fm.params(), fc.params()
    assert isinstance(pm, FlowParams) and tuple(pm.ws[3].shape) == (3, 32, 3 * 2)
    assert isinstance(pc, CouplingParams) and len(pc.ws) == 3
    assert [int(m.sum()) for m in pc.masks] == [2, 1, 2]
    assert tuple(pc.ws[1][0].shape) == (1, 32) and tuple(pc.ws[1][3].shape) == (32, 2 * 23)
    names = ("launches", "launches_affine")
    before = ([getattr(w, a) for w in (fk.made_rqs_forward, fk.ar_inverse) for a in names],
              [w.launches for w in (ck.coupling_forward, ck.coupling_inverse,
                                    ck.coupling_backward)])
    x = torch.randn(5, 3)
    fm.inverse(fm.forward(x)[0])
    fc.inverse(fc.forward(x)[0])
    fc._loss_fn(x, torch.ones(5)).backward()
    after = ([getattr(w, a) for w in (fk.made_rqs_forward, fk.ar_inverse) for a in names],
             [w.launches for w in (ck.coupling_forward, ck.coupling_inverse,
                                   ck.coupling_backward)])
    assert after == before


def test_menu_errors():
    """nsfc* needs two dimensions (the JAX ValueError; maf* takes one);
    the kernels refuse masks they were not built for and a head they do
    not have. (A spline of other than 8 bins: tests/test_torch_flow.py
    test_unported_flow_kinds_raise.)"""
    with pytest.raises(ValueError, match="n_dim >= 2"):
        Flow(1, "nsfc3", device="cpu")
    Flow(1, "maf3", device="cpu")
    fp = Flow(4, "nsfc3", device="cpu").params()
    with pytest.raises(ValueError, match="alternating halves"):
        ck._check_kernel_layout([~m for m in fp.masks], 4, 3, "coupling_forward")
    with pytest.raises(ValueError):
        ck.coupling_forward(torch.zeros(2, 5), fp.ws, fp.bs, fp.masks)
    with pytest.raises(ValueError, match="head"):
        fk.made_rqs_forward(torch.zeros(2, 4), *Flow(4, "maf3", device="cpu").params()[:2],
                            head="spline")
