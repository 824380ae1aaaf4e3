"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device every test here skips. On a machine
with one, run ``python3 -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest``.
The tolerances and the checking rules are chip_smoke.py's, imported from
it (at d <= 10: 1e-5 on values, 1e-4 on log-dets; the kernel sums in
another order than torch)."""

import numpy as np
import pytest
import torch

import pocomc_tpu_torch  # noqa: F401
from pocomc_tpu_torch.mcmc import _detached
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
import chip_smoke as smoke

pytestmark = pytest.mark.gpu
# chip_smoke's tolerances (TOL) up to d=10 and past it; at d <= 10 the
# values' (rtol, atol) and the log-dets'; a coupling stack's (values,
# log-dets) atol (COUPLING_TOL)
T10, T50 = smoke.TOL[10], smoke.TOL[50]
TOL = {k: T10[k] for k in ("rtol", "atol")}
LADJ = T10["ladj"]
T50_VALUES = {k: T50[k] for k in ("rtol", "atol")}


@pytest.fixture
def flow():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    f = Flow(6, "nsf6", device="cuda")
    with torch.no_grad():
        f.weights[-1].copy_(torch.from_numpy(0.03 * rng.standard_normal(f.weights[-1].shape)))
        for b in f.biases:
            b.copy_(torch.from_numpy(0.03 * rng.standard_normal(b.shape)))
    return f


@pytest.mark.parametrize("n", [1, 37, 512])
def test_kernels_match_plain(flow, n):
    y = torch.randn(n, 6, device="cuda", generator=torch.Generator("cuda").manual_seed(n))
    with torch.no_grad():
        fp = flow.params()
        launches = (fk.made_rqs_forward.launches, fk.ar_inverse.launches)
        z, l = fk.made_rqs_forward(y, fp.ws, fp.bs)
        x, li = fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders)
        assert (fk.made_rqs_forward.launches, fk.ar_inverse.launches) == \
            (launches[0] + 1, launches[1] + 1)
        z_r, l_r = fk.made_rqs_forward_ref(y, fp.ws, fp.bs)
        x_r, li_r = fk.ar_inverse_ref(y, fp.ws, fp.bs, fp.inv_orders)
    torch.testing.assert_close(z, z_r, **TOL)
    torch.testing.assert_close(l, l_r, rtol=0, atol=LADJ)
    torch.testing.assert_close(x, x_r, **TOL)
    torch.testing.assert_close(li, li_r, rtol=0, atol=LADJ)


def test_forward_gradients_match_plain_autograd(flow):
    """K2's autograd.Function (the forward kernel, then the backward kernel
    on the inputs it saved) against plain autograd of
    ``made_rqs_forward_ref`` on the same y: the gradients of y and of every
    parameter, elementwise within rtol 1e-4 and 1e-5 of the largest
    gradient of the tensor (the two sum the rows and the chain in other
    orders, so an element that is a small difference of large terms moves
    by more than 1e-5 alone)."""
    y = torch.randn(64, 6, device="cuda", generator=torch.Generator("cuda").manual_seed(64))
    grads = []
    for f in (fk.made_rqs_forward, fk.made_rqs_forward_ref):
        flow.zero_grad(set_to_none=True)
        yy = y.clone().requires_grad_(True)
        fp = flow.params()
        z, l = f(yy, fp.ws, fp.bs)
        (z.sum() + l.sum()).backward()
        grads.append([yy.grad] + [p.grad.clone() for p in flow.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("n", [1, 37, 512])
def test_backward_kernel_matches_plain(flow, n):
    """K2's backward kernel (with the weight-gradient products) against
    ``made_rqs_backward_ref`` on the same saved layer inputs, rows in the
    tails and rows of zero upstream gradient included: to 1e-4 of the
    largest gradient, as chip_smoke.py's TOL at d=10. The saved inputs
    themselves match the plain forward's within 10x its value tolerance
    (1e-4), as chip_smoke.py holds them: each sums the rounding of the
    transforms before it (one reading: 2.2e-5 at the sixth transform's
    input), where a wrong offset would be off by O(1)."""
    g = torch.Generator("cuda").manual_seed(100 + n)
    y = 1.5 * torch.randn(n, 6, device="cuda", generator=g)
    y[::5, 0] = 6.0
    g_z = torch.randn(n, 6, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    g_z[1::3] = 0.0
    g_l[1::3] = 0.0
    with torch.no_grad():
        fp = flow.params()
        _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True)
        for a, b in zip(acts, fk.made_rqs_forward_ref(y, fp.ws, fp.bs, save_inputs=True)[2]):
            torch.testing.assert_close(a, b, rtol=10 * TOL["rtol"], atol=10 * TOL["atol"])
        before = fk.made_rqs_backward.launches
        got = fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts)
        assert fk.made_rqs_backward.launches == before + 1
        want = fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l, acts)
    _assert_grads([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]], T10["grad"])
    with pytest.raises(ValueError, match="acts"):
        fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l)


def test_k2_kernels_match_plain_at_h_4096():
    """K2 at d=820, h=4096, where a tile state of d*23 spline parameters a
    row no longer fit a block: the output layer runs one dimension at a
    time in chunks of a few columns, and the backward streams each group
    twice. Two transforms of random (unmasked) weights, 5 rows (a ragged
    tile): z, ladj and the saved layer inputs within chip_smoke.py's d=50
    tolerances, the backward on the saved inputs within 1e-3 of the largest
    gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, h, T, n = 820, 4096, 2, 5
    g = torch.Generator("cuda").manual_seed(820)
    sizes = [(d, h), (h, h), (h, h), (h, d * fk.N_PARAMS)]
    ws = [torch.randn(T, k, m, device="cuda", generator=g) / k ** 0.5 for k, m in sizes]
    ws[3].mul_(0.3)
    bs = [0.1 * torch.randn(T, m, device="cuda", generator=g) for _, m in sizes]
    y = torch.randn(n, d, device="cuda", generator=g)
    g_z = torch.randn(n, d, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    with torch.no_grad():
        z, l, acts = fk.made_rqs_forward(y, ws, bs, save_inputs=True)
        z_r, l_r, acts_r = fk.made_rqs_forward_ref(y, ws, bs, save_inputs=True)
        torch.testing.assert_close(z, z_r, **T50_VALUES)
        torch.testing.assert_close(l, l_r, rtol=0, atol=T50["ladj"])
        for a, b in zip(acts, acts_r):
            torch.testing.assert_close(a, b, **T50_VALUES)
        got = fk.made_rqs_backward(y, ws, bs, g_z, g_l, acts)
        want = fk.made_rqs_backward_ref(y, ws, bs, g_z, g_l, acts)
    _assert_grads([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]], T50["grad"])


def test_cuda_inputs_are_checked(flow):
    """K1 refuses a transposed input, and a gradient in the weights (its
    backward gives the input's alone): the masked weights of
    ``Flow.params()`` with the gradient on require one."""
    fp = flow.params()
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        fk.ar_inverse(torch.zeros(6, 8, device="cuda").T, fp.ws, fp.bs, fp.inv_orders)
    with pytest.raises(NotImplementedError, match="weights"):
        fk.ar_inverse(torch.zeros(8, 6, device="cuda", requires_grad=True), fp.ws, fp.bs,
                      fp.inv_orders)


def test_flow_fit_launches_k2_and_matches_plain(flow, monkeypatch):
    """The host fit's loss goes through K2 on CUDA: its value and gradients
    (the backward kernel) match plain autograd's (rtol 1e-5 on the loss,
    1e-4 of the largest gradient), and ``Flow.fit`` raises the launch
    counts of K2's forward and backward."""
    import pocomc_tpu_torch.models.flow as flow_mod
    rng = np.random.default_rng(1)
    u = rng.standard_normal((512, 6)).astype(np.float32)
    w = rng.random(512).astype(np.float32)
    xb, wb = torch.from_numpy(u).cuda(), torch.from_numpy(w / w.sum()).cuda()
    out = []
    for forward in (fk.made_rqs_forward, fk.made_rqs_forward_ref):
        monkeypatch.setattr(flow_mod, "made_rqs_forward", forward)
        flow.zero_grad(set_to_none=True)
        loss = flow._loss_fn(xb, wb, 2.0, 0.5)
        loss.backward()
        out.append((float(loss.detach()), [p.grad.clone() for p in flow.parameters()]))
    monkeypatch.undo()
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    _assert_grads(out[0][1], out[1][1], T10["grad"])
    before = (fk.made_rqs_forward.launches, fk.made_rqs_backward.launches)
    hist = flow.fit(u, weights=w, validation_split=0.5, epochs=3, batch_size=128,
                    patience=2, annealing=True, noise=0.05, seed=0)
    assert fk.made_rqs_forward.launches > before[0]
    assert fk.made_rqs_backward.launches > before[1]
    assert np.isfinite(hist["loss"]).all()


def test_host_route_sweep_launches_k1_and_matches_plain(flow):
    """A stepped sweep with a numpy likelihood on the host: on CUDA it
    launches K1 in every step and takes the same accept decisions, to the
    same states (1e-4), as the plain versions on the CPU given the same
    draws."""
    import copy
    import pocomc_tpu_torch as tpc
    from pocomc_tpu_torch.mcmc import Sweep
    from pocomc_tpu_torch.models.geometry import fit_geometry
    d, n = 6, 256
    rng = np.random.default_rng(2)
    scaler = tpc.Reparameterize(d, bounds=np.array([[-np.inf, np.inf]] * d))
    scaler.fit(3.0 * rng.standard_normal((1024, d)))
    prior = tpc.Prior([tpc.Normal(0.0, 3.0)] * d)
    u = torch.from_numpy((0.5 * rng.standard_normal((n, d))).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    noise = [dict(g=torch._standard_gamma(torch.full((n,), 0.5 * (d + 5.0)), generator=g),
                  z=torch.randn(n, d, generator=g), unif=torch.rand(n, generator=g))
             for _ in range(12)]

    def host_like(x):
        return -0.5 * np.sum((x - 0.5) ** 2, axis=1) / 0.3, None

    runs = []
    for dev, f in (("cuda", flow), ("cpu", copy.deepcopy(flow).cpu())):
        sweep = Sweep(scaler, prior.logpdf, None, f, d, 6, 12)
        sweep.draw_noise = lambda st, geom, gen: {k: v.to(dev) for k, v in noise[st.i].items()}
        masks = []
        accept = sweep.accept_update

        def recording(*a, accept=accept, masks=masks):
            st, acc = accept(*a)
            masks.append(acc.cpu())
            return st, acc

        sweep.accept_update = recording
        with torch.no_grad():
            ud = u.to(dev)
            scp = scaler.whitening_params(dev)
            x, ldj = scaler.inverse(ud, params=scp)
            logl = torch.from_numpy(host_like(x.double().cpu().numpy())[0]).float().to(dev)
            fp = f.params()
            theta, _ = f.forward(ud, fp)
            geom = fit_geometry(theta, torch.ones(n, device=dev) / n, u0=torch.tensor(0.3, device=dev))
            launches = fk.ar_inverse.launches
            res, _ = sweep.run_stepped(ud, x, ldj, logl, prior.logpdf(x), 0.7, 0.5, geom, fp,
                                       scp, None, host_like, dbeta=0.1)
        runs.append((res, masks, fk.ar_inverse.launches - launches))
    (rc, mc, kc), (rp, mp, kp) = runs
    assert rc["steps"] == rp["steps"] and kc >= rc["steps"] and kp == 0
    assert all(torch.equal(a, b) for a, b in zip(mc, mp))
    for name in ("u", "x", "logl", "logdetj"):
        torch.testing.assert_close(rc[name].cpu(), rp[name], rtol=1e-4, atol=1e-4)


def _random_flow(d, seed):
    """nsf6 on the card: the init's masked hidden layers, N(0, 0.02^2)
    output weights and biases (chip_smoke.py's random_flow)."""
    rng = np.random.default_rng(seed)
    f = Flow(d, "nsf6", device="cuda")
    with torch.no_grad():
        f.weights[-1].copy_(torch.from_numpy(0.02 * rng.standard_normal(f.weights[-1].shape)))
        for b in f.biases:
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    return f, rng


@pytest.mark.parametrize("d,n,tol", [(2, 37, T10), (3, 37, T10), (10, 2048, T10),
                                     (50, 256, T50)])
def test_k1_matches_plain(d, n, tol):
    """K1 on the degree schedule against ``ar_inverse_ref`` where the
    hidden units of a degree are many (d=2: all 32 of degree 1, two column
    groups; d=3: 16 a degree), at the bridge's rows for n_active up to
    1024 (d=10, n=2048: K1's two-row launch) and at the sweep's population
    at d=50; tolerances (rtol, atol on x, atol on the log-det) as chip_smoke.py's
    TOL. The same inputs give the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f, rng = _random_flow(d, d)
    z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        fp = f.params()
        before = fk.ar_inverse.launches
        x, l = fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        x2, l2 = fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        assert fk.ar_inverse.launches == before + 2
        x_r, l_r = fk.ar_inverse_ref(z, fp.ws, fp.bs, fp.inv_orders)
    assert torch.equal(x, x2) and torch.equal(l, l2)
    torch.testing.assert_close(x, x_r, rtol=tol["rtol"], atol=tol["atol"])
    torch.testing.assert_close(l, l_r, rtol=0, atol=tol["ladj"])


def test_k1_pack_follows_the_weights():
    """K1 keeps its weight pack with the FlowParams: a second call reuses
    it, and an in-place change of a weight is seen (the result is the
    plain version's on the changed weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f, rng = _random_flow(10, 1)
    z = torch.from_numpy(rng.standard_normal((64, 10)).astype(np.float32)).cuda()
    with torch.no_grad():
        fp = f.params()
        fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        pack = fp.ws[0]._k1_pack[1]
        fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        assert fp.ws[0]._k1_pack[1] is pack
        fp.ws[3].mul_(2.0)
        x, l = fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders)
        assert fp.ws[0]._k1_pack[1] is not pack
        x_r, l_r = fk.ar_inverse_ref(z, fp.ws, fp.bs, fp.inv_orders)
    torch.testing.assert_close(x, x_r, **TOL)
    torch.testing.assert_close(l, l_r, rtol=0, atol=LADJ)


def test_k1_matches_plain_at_h_4096():
    """K1 at d=820, h=4096 on two transforms of random weights times the
    masks of ``made.make_masks`` (orders 0..d-1 and reversed, as a Flow's):
    a piece of a group is a chunk of its fan-in there, and one warp's row
    state takes most of the block. 5 rows (a ragged block); tolerances as
    chip_smoke.py's TOL at d=50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pocomc_tpu_torch.models import made
    d, h, T, n = 820, 4096, 2, 5
    rng = np.random.default_rng(820)
    orders = [np.arange(d), np.arange(d)[::-1].copy()]
    masks = [made.make_masks(made.make_degrees(d, o, [h] * 3), d, fk.N_PARAMS) for o in orders]
    sizes = [(d, h), (h, h), (h, h), (h, d * fk.N_PARAMS)]
    ws, bs = [], []
    for l, (k, m) in enumerate(sizes):
        scale = 0.02 if l == 3 else 1.0 / np.sqrt(k)
        w = np.stack([scale * rng.standard_normal((k, m)) * masks[t][l] for t in range(T)])
        ws.append(torch.from_numpy(w.astype(np.float32)).cuda())
        bs.append(torch.from_numpy((0.02 * rng.standard_normal((T, m))).astype(np.float32)).cuda())
    inv = torch.from_numpy(np.stack([np.argsort(o) for o in orders]).astype(np.int32)).cuda()
    z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        x, l = fk.ar_inverse(z, ws, bs, inv)
        x_r, l_r = fk.ar_inverse_ref(z, ws, bs, inv)
    torch.testing.assert_close(x, x_r, **T50_VALUES)
    torch.testing.assert_close(l, l_r, rtol=0, atol=T50["ladj"])


def test_bridge_rung_launches_k1_with_grad_off(flow):
    """One bridge rung on the card, called with grad on and a FlowParams
    inside the autograd graph: K1 launches in every step, no output
    requires grad (K1 raises where a gradient is asked of it), and the
    rung takes the same accept decisions as the plain versions on the CPU
    given the same draws (states within 1e-4)."""
    import copy
    import pocomc_tpu_torch as tpc
    from pocomc_tpu_torch import bridge
    from pocomc_tpu_torch.mcmc import make_loglike
    d, n, steps = 6, 1024, 3
    rng = np.random.default_rng(4)
    scaler = tpc.Reparameterize(d, bounds=np.array([[-np.inf, np.inf]] * d))
    scaler.fit(3.0 * rng.standard_normal((1024, d)))
    prior = tpc.Prior([tpc.Normal(0.0, 3.0)] * d)
    g = torch.Generator().manual_seed(0)
    theta = torch.randn(n, d, generator=g)
    noise = bridge.draw_rung_noise(n, d, steps, g, "cpu")
    outs = []
    for dev, f in (("cuda", flow), ("cpu", copy.deepcopy(flow).cpu())):
        init, rung = bridge.make_bridge_programs(
            scaler, prior.logpdf, make_loglike(lambda x: -0.5 * ((x - 0.5) ** 2).sum(-1)), d,
            f.kernel_inv, n_steps=steps)
        fp = f.params()
        assert fp.ws[0].requires_grad
        scp = scaler.whitening_params(dev)
        before = fk.ar_inverse.launches
        fv, _ = init(theta.to(dev), fp, scp)
        out = rung(theta.to(dev), fv, torch.tensor(0.9, device=dev), 0.4, 0.4,
                   {k: v.to(dev) for k, v in noise.items()}, fp, scp)
        assert not any(o.requires_grad for o in (fv, *out))
        outs.append((out, fk.ar_inverse.launches - before))
    (oc, kc), (op, kp) = outs
    assert kc == steps + 1 and kp == 0
    torch.testing.assert_close(oc[0].cpu(), op[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(oc[1].cpu(), op[1], rtol=1e-4, atol=1e-4)
    assert int(oc[4]) == int(op[4])


def test_cuda_generator_state_survives_save_and_load(tmp_path):
    """A run on the card saved and loaded into a sampler of another seed:
    the CUDA generator (Philox) is restored, so both draw the same next
    numbers, in the pickle and in the directory format."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pocomc_tpu_torch as tpc

    def make(seed):
        return tpc.Sampler(tpc.Prior([tpc.Normal(0.0, 5.0)] * 2),
                           lambda x: -0.5 * (x * x).sum(-1), vectorize=True,
                           random_state=seed, n_effective=128, n_active=64,
                           precondition=False, device="cuda")

    s = make(0)
    s.run(n_total=256, n_evidence=0, progress=False)
    assert s._gen.device.type == "cuda"
    for path in (tmp_path / "s.state", tmp_path / "s.orbax"):
        s.save_state(path)
        s2 = make(1)
        s2.load_state(path)
        assert s2._gen.device.type == "cuda"
        assert torch.equal(s2._gen.get_state(), s._gen.get_state())
        a = torch.randn(8, device="cuda", generator=copy_gen(s._gen))
        b = torch.randn(8, device="cuda", generator=s2._gen)
        assert torch.equal(a, b)
        assert s2.evidence() == s.evidence()


def copy_gen(gen):
    """A CUDA generator in the state of ``gen`` (drawing from it leaves
    ``gen`` where it was)."""
    g = torch.Generator(device="cuda")
    g.set_state(gen.get_state())
    return g


# -- the rest of the flow menu: maf* (the affine head) and nsfc* (K5) -------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_card_flow(d, arch, seed=0, bins=8):
    """A flow of the menu on the card with N(0, 0.02^2) output weights and
    biases (every transform's), from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = Flow(d, arch, bins=bins, device="cuda")
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(f.weights, f.biases)):
            if l % 4 == 3:
                w.copy_(torch.from_numpy(0.02 * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    return f


@pytest.mark.parametrize("arch,d", [("maf6", 3), ("maf6", 10), ("nsfc6", 3), ("nsfc6", 10),
                                    ("nsfc3", 2)])
@pytest.mark.parametrize("n", [1, 37, 512])
def test_kernels_match_plain_on_card(cuda, arch, d, n):
    """K2 and K1 with the affine head, or K5 forward and inverse, against
    their plain versions on the same card inputs, each launched once. A
    coupling stack's values at atol 5e-5 and log-dets at 5e-4 (the spline
    turns the MLP's rounding, summed in another order, into up to 3.1e-5
    and 1.2e-4: chip_smoke.COUPLING_TOL), the rest at 1e-5 and 1e-4."""
    flow = _random_card_flow(d, arch)
    y = torch.randn(n, d, device=cuda, generator=torch.Generator("cuda").manual_seed(n))
    with torch.no_grad():
        fp = flow.params()
        if arch.startswith("maf"):
            before = (fk.made_rqs_forward.launches_affine, fk.ar_inverse.launches_affine)
            got = (fk.made_rqs_forward(y, fp.ws, fp.bs, head="affine"),
                   fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders, head="affine"))
            after = (fk.made_rqs_forward.launches_affine, fk.ar_inverse.launches_affine)
            want = (fk.made_rqs_forward_ref(y, fp.ws, fp.bs, head="affine"),
                    fk.ar_inverse_ref(y, fp.ws, fp.bs, fp.inv_orders, head="affine"))
        else:
            before = (ck.coupling_forward.launches, ck.coupling_inverse.launches)
            got = (ck.coupling_forward(y, fp.ws, fp.bs, fp.masks),
                   ck.coupling_inverse(y, fp.ws, fp.bs, fp.masks))
            after = (ck.coupling_forward.launches, ck.coupling_inverse.launches)
            want = (ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks),
                    ck.coupling_inverse_ref(y, fp.ws, fp.bs, fp.masks))
            one, _ = ck.coupling_inverse(y, fp.ws[:1], fp.bs[:1], fp.masks[:1])
            assert torch.equal(one[:, fp.masks[0]], y[:, fp.masks[0]])
    assert after == (before[0] + 1, before[1] + 1)
    maf = arch.startswith("maf")
    tol = TOL if maf else dict(rtol=TOL["rtol"], atol=smoke.COUPLING_TOL[10][0])
    for (a, la), (b, lb) in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
        torch.testing.assert_close(la, lb, rtol=TOL["rtol"],
                                   atol=LADJ if maf else smoke.COUPLING_TOL[10][1])


@pytest.mark.parametrize("arch,d", [("maf6", 3), ("maf6", 10), ("nsfc6", 3), ("nsfc6", 10)])
def test_kernel_gradients_match_plain_autograd_on_card(cuda, arch, d):
    """The training loss's gradient through the kernels (K2 with the affine
    head and its backward, or K5 and its backward) against plain autograd
    of the plain forward, on the card: max |diff| / max |grad| <= 1e-4."""
    flow = _random_card_flow(d, arch, seed=1)
    g = torch.Generator("cuda").manual_seed(d)
    xb = torch.randn(256, d, device=cuda, generator=g)
    wb = torch.rand(256, device=cuda, generator=g)
    grads = []
    for plain in (False, True):
        flow.zero_grad(set_to_none=True)
        if plain:
            fp = flow.params()
            y = xb
            if arch.startswith("maf"):
                z, l = fk.made_rqs_forward_ref(y, fp.ws, fp.bs, head="affine")
            else:
                z, l = ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks)
            loss = (-(flow._base_logpdf(z) + l) * wb * 1000.0).sum() / wb.sum()
        else:
            loss = flow._loss_fn(xb, wb)
        loss.backward()
        grads.append([p.grad.clone() for p in flow.parameters()])
    _assert_grads(*grads, T10["grad"])


def test_coupling_inverse_refuses_a_gradient_on_card(cuda):
    """K5's inverse refuses a gradient in the weights (the flow's own
    parameters require one); with them detached it gives z's through
    K5-inv-bwd, equal to the plain VJP on the plain save mode's state at
    the same z (``coupling_inverse_ref(..., save_inputs=True)``)."""
    flow = _random_card_flow(4, "nsfc3")
    z = torch.randn(8, 4, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="weights"):
        flow.inverse(z)
    fp = _detached(flow.params())
    before = ck.coupling_inverse_backward.launches
    x, l = flow.inverse(z, fp)
    g_x = torch.randn_like(x)
    g_z, = torch.autograd.grad((x, l), z, (g_x, torch.ones_like(l)))
    assert ck.coupling_inverse_backward.launches == before + 1
    with torch.no_grad():
        state = ck.coupling_inverse_ref(z.detach(), fp.ws, fp.bs, fp.masks, save_inputs=True)[2]
        want = ck.coupling_inverse_vjp_ref(state, fp.ws, fp.bs, fp.masks,
                                           g_x @ fp.pre["w_inv"].T, torch.ones_like(l))
    assert float((g_z - want).abs().max()) <= 1e-4 * float(want.abs().max())


# -- K5 at the edges of its tiles: odd halves, every hidden width class --

def _menu_card_flow(d, arch, seed=0, bins=8):
    """A coupling flow on the card with the menu's random output layers
    (std 0.02 * sqrt(32 / h): chip_smoke.MENU_SCALE) and N(0, 0.02^2)
    biases, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = Flow(d, arch, bins=bins, device="cuda")
    scale = 0.02 * (32 / f.n_hidden) ** 0.5
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(f.weights, f.biases)):
            if l % 4 == 3:
                w.copy_(torch.from_numpy(scale * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    return f


def _coupling_edge_rows(flow, y, g_l, window=1e-5):
    """Rows whose gradient two correct fp32 routes may give differently
    (chip_smoke.knot_rows for a coupling stack): in the float64 forward some
    transformed input lies within `window` of a knot of its spline (the
    clamp edges +-B among them), where the log-det's gradient jumps and a
    rounding of ~1e-6 picks the side, and the row's dL/dladj is nonzero.
    (n,) bool."""
    import copy
    from pocomc_tpu_torch.models import transforms as tr
    n = y.shape[0]
    fp = copy.deepcopy(flow).double().params()
    near = torch.zeros(n, dtype=torch.bool, device=y.device)
    with torch.no_grad():
        acts = ck.coupling_forward_ref(y.double(), fp.ws, fp.bs, fp.masks, save_inputs=True,
                                       bins=flow.bins)[2]
        for t, m in enumerate(fp.masks):
            x = acts[0][t][:, torch.as_tensor(~m, device=y.device)]
            p = (acts[3][t] @ fp.ws[t][3] + fp.bs[t][3]).reshape(n, x.shape[1], flow.n_params)
            near |= ((x[..., None] - tr._rqs_setup(p, flow.bins)[0]).abs()
                     < window).any(-1).any(-1)
    return near & (g_l != 0)


def _check_coupling_kernels(d, n, arch="nsfc6"):
    """K5 forward, inverse and backward of a menu coupling flow at d
    against their plain versions on the same card inputs, at chip_smoke's
    tolerances for h > 32: values and log-dets within max(5e-4 / 1e-2, 4x
    the plain fp32 version's distance) of the plain version in float64
    (chip_smoke.COUPLING_TOL[50], check_vs_float64), the gradients within
    1e-3 of the largest (chip_smoke.TOL[50]), rows on a float64 knot with
    dL/dladj != 0 left out as chip_smoke leaves them out of K2's gradient;
    conditioning columns bit for bit."""
    import copy
    flow = _menu_card_flow(d, arch)
    g = torch.Generator("cuda").manual_seed(n)
    y = torch.randn(n, d, device="cuda", generator=g)
    with torch.no_grad():
        fp = flow.params()
        fp64 = copy.deepcopy(flow).double().params()
        for fn, ref in ((ck.coupling_forward, ck.coupling_forward_ref),
                        (ck.coupling_inverse, ck.coupling_inverse_ref)):
            got = fn(y, fp.ws, fp.bs, fp.masks)
            plain = ref(y, fp.ws, fp.bs, fp.masks)
            exact = ref(y.double(), fp64.ws, fp64.bs, fp64.masks)
            for a, b, e, atol in zip(got, plain, exact, smoke.COUPLING_TOL[50]):
                ok, out = smoke.float64_verdict(a, b, e, atol)
                assert ok, out
        one, _ = ck.coupling_forward(y, fp.ws[:1], fp.bs[:1], fp.masks[:1])
        assert torch.equal(one[:, fp.masks[0]], y[:, fp.masks[0]])
        g_z = torch.randn(n, d, device="cuda", generator=g)
        g_l = torch.randn(n, device="cuda", generator=g)
        edge = _coupling_edge_rows(flow, y, g_l)
        g_z, g_l = g_z.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        _, _, acts = ck.coupling_forward(y, fp.ws, fp.bs, fp.masks, save_inputs=True)
        got = ck.coupling_backward(y, fp.ws, fp.bs, fp.masks, g_z, g_l, acts)
        want = ck.coupling_backward_ref(y, fp.ws, fp.bs, fp.masks, g_z, g_l, acts)
    flat = lambda g: [g[0], *[a for t in g[1] for a in t], *[a for t in g[2] for a in t]]
    _assert_grads(flat(got), flat(want), T50["grad"])


@pytest.mark.parametrize("d", [20, 30, 51, 171, 200])
@pytest.mark.parametrize("n", [1, 7, 9, 31, 33, 4097])
def test_coupling_kernels_match_plain_at_tile_edges(cuda, d, n):
    """K5 at odd halves (d=51: 26/25, h=256), h=64 and 128 (d=20, 30), h =
    1024 (d=171, 200: hidden layers in two passes of 512 columns, 8-row
    blocks), and n at the edges of 8- and 32-row blocks, held as
    ``_check_coupling_kernels`` holds it (at d=30, n=4097 one row lies on a
    knot: the kernel, whose spline parameters sum in the forward's order,
    and the plain version, which takes them from torch.matmul, put its
    input on the two sides of it)."""
    _check_coupling_kernels(d, n)


@pytest.mark.parametrize("n", [1, 3, 5, 9, 257])
def test_coupling_kernels_match_plain_on_row_tiles(cuda, n):
    """K5 where 8 rows of hidden state do not fit a block: d=342 (h=2048),
    Row tiles of 4 rows and hidden layers in four passes of 512 columns;
    n at the edges of a 4-row block."""
    for backward in (False, True):
        assert ck._k5_config(n, 342, 2048, backward)[:2] == (1, 4)
    _check_coupling_kernels(342, n, "nsfc3")


def test_coupling_kernels_follow_adamw_steps(cuda):
    """The packed weights follow the weights through foreach
    AdamW steps as ``models.flow.fit_stack`` takes them, at ``Flow.fit``'s
    default learning rate: after each step the forward and inverse match
    their plain versions on the new weights (against float64, as
    ``_check_coupling_kernels`` holds them), the step moved the plain
    forward by over 100x the kernel's distance to it (a pack of the old
    weights would not follow), and the loss gradient through K5 matches
    the plain autograd one (rows on a float64 knot carry no weight)."""
    import copy
    d, n = 50, 1024
    flow = _menu_card_flow(d, "nsfc3")
    g = torch.Generator("cuda").manual_seed(0)
    y = torch.randn(n, d, device=cuda, generator=g)
    params = list(flow.parameters())
    opt = torch.optim.AdamW(params, lr=1e-3, foreach=True)
    for _ in range(3):
        w = torch.full((n,), 1.0 / n, device=cuda)
        w = w.masked_fill(_coupling_edge_rows(flow, y, w), 0.0)
        opt.zero_grad(set_to_none=True)
        flow._loss_fn(y, w).backward()
        got = [p.grad.clone() for p in params]
        fp = flow.params()
        z, ladj = ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks)
        loss = (-(flow._base_logpdf(z) + ladj) * w * 1000.0).sum() / w.sum()
        want = torch.autograd.grad(loss, params)
        _assert_grads(got, want, T50["grad"])
        before = z.detach()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()
        with torch.no_grad():
            fp = flow.params()
            fp64 = copy.deepcopy(flow).double().params()
            for fn, ref in ((ck.coupling_forward, ck.coupling_forward_ref),
                            (ck.coupling_inverse, ck.coupling_inverse_ref)):
                got = fn(y, fp.ws, fp.bs, fp.masks)
                plain = ref(y, fp.ws, fp.bs, fp.masks)
                exact = ref(y.double(), fp64.ws, fp64.bs, fp64.masks)
                for a, b, e, atol in zip(got, plain, exact, smoke.COUPLING_TOL[50]):
                    ok, out = smoke.float64_verdict(a, b, e, atol)
                    assert ok, out
                if fn is ck.coupling_forward:
                    moved = float((plain[0] - before).abs().max())
                    assert moved > 100 * float((got[0] - plain[0]).abs().max())


# -- the gradient kernels: K1-bwd and K5-inv-bwd --------------------------

def _made_edge_rows(flow, x, g_l, window=1e-5):
    """Rows of an nsf* stack at its data value x whose gradient two correct
    fp32 routes may give differently (chip_smoke.knot_rows): in the float64
    forward some transform input lies within `window` of a knot of its
    spline and the row's dL/dladj is nonzero. None for the affine head."""
    import copy
    from pocomc_tpu_torch.models import transforms as tr
    n, d = x.shape
    near = torch.zeros(n, dtype=torch.bool, device=x.device)
    if flow.head != "rqs":
        return near
    fp = copy.deepcopy(flow).double().params()
    with torch.no_grad():
        acts = fk.made_rqs_forward_ref(x.double(), fp.ws, fp.bs, save_inputs=True,
                                       bins=flow.bins)[2]
        for t in range(acts[0].shape[0]):
            p = (acts[3][t] @ fp.ws[3][t] + fp.bs[3][t]).reshape(n, d, flow.n_params)
            knots = tr._rqs_setup(p, flow.bins)[0]
            near |= ((acts[0][t][..., None] - knots).abs() < window).any(-1).any(-1)
    return near & (g_l != 0)


def _kink_rows(flow, x, window=1e-5):
    """Rows of a flow's stack at its data value x where, in the float64
    forward, some hidden pre-activation of some transform's network lies
    within `window` of 0: the ReLU's derivative jumps there, so the
    inverse's gradient does, and which side a row takes turns on the
    last bits of a sum that two correct fp32 routes order differently
    (found on the CPU: plain fp32 autograd and the plain VJP, in
    agreement, 0.11 from float64 in one row of 4096 at nsf6, d=10). (n,)
    bool."""
    import copy
    fp = copy.deepcopy(flow).double().params()
    n = x.shape[0]
    near = torch.zeros(n, dtype=torch.bool, device=x.device)
    with torch.no_grad():
        if flow.kind == "nsfc":
            xs = ck.coupling_forward_ref(x.double(), fp.ws, fp.bs, fp.masks, True,
                                         flow.bins)[2][0]
            nets = [(xs[t][:, torch.as_tensor(m, device=x.device)], fp.ws[t], fp.bs[t])
                    for t, m in enumerate(fp.masks)]
        else:
            xs = fk.made_rqs_forward_ref(x.double(), fp.ws, fp.bs, save_inputs=True,
                                         head=flow.head, bins=flow.bins)[2][0]
            nets = [(xs[t], [w[t] for w in fp.ws], [b[t] for b in fp.bs])
                    for t in range(xs.shape[0])]
        for inp, w, b in nets:
            h = inp @ w[0] + b[0]
            near |= (h.abs() < window).any(-1)
            for l in (1, 2):
                h = h + torch.relu(h) @ w[l] + b[l]
                near |= (h.abs() < window).any(-1)
    return near


def _assert_grads(got, want, tol):
    """chip_smoke's gradient rule (``grad_verdict``): each tensor of got
    within tol of its largest value of want's."""
    ok, errs = smoke.grad_verdict(list(got), list(want), tol)
    assert ok, errs


def _grads_vs_float64(got, exact, bins):
    """Past 16 bins, chip_smoke phase 14's gradient rule (``grad_verdict``
    at ``narrow_tol``'s gradient tolerance of TOL[10] at the bins): each
    tensor within 1e-4 of its largest value (6e-4 at 1000 bins) of the plain
    version in float64, rows on a jump left out by the caller."""
    _assert_grads(got, exact, smoke.narrow_tol(T10, bins)["grad"])


def _assert_float64(got, plain, exact, tol):
    """K5's rule, chip_smoke's ``float64_verdict`` with its atol tol * max
    |exact|: |got - exact| within max(tol * max|exact|, 4x the plain fp32
    version's own distance to exact)."""
    ok, out = smoke.float64_verdict(got, plain, exact, tol * float(exact.abs().max()))
    assert ok, out


def _grad_card_flow(d, arch, seed, bins=8):
    """A flow for K1-bwd's checks: ``_random_card_flow``, or past d = 50
    ``_menu_card_flow``'s output layers scaled with the fan-in (std 0.02 *
    sqrt(32 / h)), which keep the head parameters spread as at h = 32 and
    the stack well conditioned in fp32."""
    if d <= 50:
        return _random_card_flow(d, arch, seed=seed, bins=bins)
    return _menu_card_flow(d, arch, seed=seed, bins=bins)


def _k1_backward_case(arch, d, n, bins=8):
    """K1-bwd at (arch, d, n) on K1's saved state: (got, again, plain,
    exact) with rows on a float64 knot with dL/dladj != 0 or on a ReLU kink
    left out; ``again`` the same call repeated."""
    import copy
    f = _grad_card_flow(d, arch, seed=d, bins=bins)
    b = f.bins
    g = torch.Generator("cuda").manual_seed(n)
    z = torch.randn(n, d, device="cuda", generator=g)
    g_x = torch.randn(n, d, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    with torch.no_grad():
        fp = f.params()
        x, _, state = fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, f.head, True, b)
        edge = _made_edge_rows(f, x, g_l) | _kink_rows(f, x)
        g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        counter = fk.launch_attr(f.head, b)
        before = getattr(fk.ar_inverse_backward, counter, 0)
        got = fk.ar_inverse_backward(state, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, f.head, b)
        again = fk.ar_inverse_backward(state, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, f.head, b)
        assert getattr(fk.ar_inverse_backward, counter) == before + 2
        plain = fk.ar_inverse_vjp_ref(x, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, f.head, b)
        fp64 = copy.deepcopy(f).double().params()
        exact = fk.ar_inverse_vjp_ref(x.double(), fp64.ws, fp64.bs, fp64.inv_orders,
                                      g_x.double(), g_l.double(), f.head, b)
    return got, again, plain, exact


@pytest.mark.parametrize("arch,d,n", [
    ("nsf6", 2, 37), ("nsf3", 4, 128), ("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1100),
    ("nsf6", 10, 2200), ("nsf6", 10, 4096), ("nsf6", 50, 256), ("nsf6", 50, 4096),
    ("maf6", 2, 37), ("maf6", 4, 128), ("maf6", 10, 256), ("maf6", 10, 2200),
    ("maf6", 50, 4096), ("nsf3", 342, 64), ("maf3", 342, 64), ("nsf3", 683, 64),
    ("maf3", 683, 64)])
def test_k1_backward_matches_plain(cuda, arch, d, n):
    """K1-bwd on the state K1's save instance wrote, against
    ``ar_inverse_vjp_ref`` at the same x (K1's output), both heads, at a
    ragged n (37), at n taking K1's one-, two- and four-row launches (256,
    1100, 2200 and up) and at d = 2, 4, 10, 50, 342 (h = 2048: groups in
    fan-in chunks) and 683 (h = 4096; wider in
    ``test_k1_backward_inverts_the_forward_at_every_width``), n <= 64 past
    d = 50: within 1e-4 (d <= 10) or 1e-3 (d >= 50) of the largest g_z of
    the plain version in
    float64, chip_smoke's TOL, or within 4x the plain fp32 version's own
    distance to it where that is larger (K5's rule), rows on a float64
    knot with dL/dladj != 0 or on a ReLU kink left out (the gradient jumps
    there). The same inputs give the same bits twice."""
    got, again, plain, exact = _k1_backward_case(arch, d, n)
    assert torch.equal(got, again)
    _assert_float64(got, plain, exact, T50["grad"] if d >= 50 else T10["grad"])


@pytest.mark.parametrize("arch", ["nsf6", "maf6"])
@pytest.mark.parametrize("d", [2, 4, 10])
@pytest.mark.parametrize("n", [1, 37])
def test_k1_backward_batched_stages_at_their_edges(cuda, arch, d, n):
    """One-row warps take whole groups of the reverse walk from shared
    stages (``Ring::take_back``): at d = 2, 4 and 10 a stage holds the
    groups of several steps, the last stage of a transform ends inside a
    step, and step 0's output group has no fan-in. Held as
    ``test_k1_backward_matches_plain`` holds it."""
    got, again, plain, exact = _k1_backward_case(arch, d, n)
    assert torch.equal(got, again)
    _assert_float64(got, plain, exact, T10["grad"])


@pytest.mark.parametrize("n,rows", [(256, 1), (1100, 2), (2200, 4)])
def test_k1_backward_launches_one_two_and_four_rows_a_warp(cuda, n, rows):
    """The planner gives K1-bwd warps of 1, 2 and 4 rows at these n (the
    element VJP warp-wide for one row, on 8 lanes a row for two and four),
    each held to the plain version as ``test_k1_backward_matches_plain``
    holds it."""
    assert fk._backward_config(n, 10, 32)[0] == rows
    got, again, plain, exact = _k1_backward_case("nsf6", 10, n)
    assert torch.equal(got, again)
    _assert_float64(got, plain, exact, T10["grad"])


@pytest.mark.parametrize("head", ["rqs", "affine"])
@pytest.mark.parametrize("lanes", [32, 8])
def test_kernel_element_vjp_matches_the_one_lane_one(cuda, head, lanes):
    """K1-bwd's element VJP, warp-wide (``inverse_vjp_warp``, one-row warps)
    or on 8 lanes a row (``inverse_vjp_group``, warps of 2 or 4 rows),
    against the one-lane one (``inverse_vjp``) and the plain
    ``inverse_element_vjp`` in float64, on rows inside the spline's range,
    on its edges and beyond, n = 4093 (the last warp part empty): the
    spline's sums run in another order (butterflies and a scan), so within
    1e-5 of each tensor's largest value, rows within 1e-5 of a knot in
    float64 left out (a rounding picks the bin there); the affine map bit
    for bit."""
    from pocomc_tpu_torch.models import transforms as tr
    n, npar = 4093, fk.HEADS[head]
    rng = np.random.default_rng(7)
    x = rng.uniform(-6.0, 6.0, n).astype(np.float32)
    x[:4] = [5.0, -5.0, 4.999999, -4.999999]
    p = torch.from_numpy((0.5 * rng.standard_normal((n, npar))).astype(np.float32)).cuda()
    x = torch.from_numpy(x).cuda()
    g_x, g_l = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
                for _ in range(2))
    kernel = fk._element_vjp(x, p, g_x, g_l, head, lanes)
    lane = fk._element_vjp(x, p, g_x, g_l, head, 1)
    exact = fk.inverse_element_vjp(x.double(), p.double(), g_x.double(), g_l.double(), head)
    if head == "affine":
        assert all(torch.equal(a, b) for a, b in zip(kernel, lane))
        return
    knots = tr._rqs_setup(p.double(), 8)[0]
    keep = ~((x.double()[:, None] - knots).abs() < 1e-5).any(-1)
    for a, b, e in zip(kernel, lane, exact):
        a, b, e = a[keep].double(), b[keep].double(), e[keep]
        assert float((a - b).abs().max()) <= 1e-5 * float(e.abs().max())
        assert float((a - e).abs().max()) <= 1e-4 * float(e.abs().max())


@pytest.mark.parametrize("arch", ["nsf6", "maf6"])
def test_k1_saved_state_route_matches_the_direct_call(cuda, arch):
    """The gradient through the autograd route (K1's save instance in the
    forward, K1-bwd on its state in the backward) has the bits of the
    direct call on the state ``_launch_inverse(..., save=True)`` gives,
    and K1's save instance gives the bits of K1 without it; the autograd
    route launches no K2."""
    f = _random_card_flow(10, arch, seed=3)
    g = torch.Generator("cuda").manual_seed(9)
    z = torch.randn(256, 10, device=cuda, generator=g)
    g_x = torch.randn(256, 10, device=cuda, generator=g)
    g_l = torch.randn(256, device=cuda, generator=g)
    fp = _detached(f.params())
    counter = "launches" if f.head == "rqs" else "launches_affine"
    k2 = getattr(fk.made_rqs_forward, counter)
    zz = z.clone().requires_grad_(True)
    xx, ll = fk.ar_inverse(zz, fp.ws, fp.bs, fp.inv_orders, head=f.head)
    via_autograd = torch.autograd.grad((xx, ll), zz, (g_x, g_l))[0]
    assert getattr(fk.made_rqs_forward, counter) == k2
    with torch.no_grad():
        x, ladj, state = fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, f.head, True)
        x0, ladj0 = fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders, head=f.head)
        direct = fk.ar_inverse_backward(state, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, f.head)
    assert torch.equal(x, x0) and torch.equal(ladj, ladj0) and torch.equal(xx.detach(), x)
    assert torch.equal(direct, via_autograd)
    with pytest.raises(ValueError, match="state"):
        fk.ar_inverse_backward(x, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, head=f.head)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_sweep_runs_at_d_342_on_card(cuda, kind):
    """A preconditioned mala or hmc sweep of a few steps at d = 342 (nsf3,
    h = 2048) on the card, where K1-bwd refused to launch before its
    groups went in fan-in chunks: every step's gradient goes through K1's
    save instance and K1-bwd, and the state stays finite."""
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.mcmc import Sweep, make_loglike
    from pocomc_tpu_torch.models.geometry import fit_geometry
    d, n = 342, 64
    prior = pt.Prior([pt.Normal(0.0, 3.0)] * d)
    scaler = pt.Reparameterize(d, bounds=prior.bounds)
    flow = _menu_card_flow(d, "nsf3", seed=2)

    def like(x):
        return -0.5 * (x * x).sum(-1)

    sweep = Sweep(scaler, prior.logpdf, make_loglike(like), flow, d, 3, 3, kind=kind)
    g = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        scp = scaler.whitening_params("cuda")
        fp = _detached(flow.params())
        u = 0.5 * torch.randn(n, d, device=cuda, generator=g)
        x, ldj = scaler.inverse(u, params=scp)
        theta, _ = flow.forward(u, fp)
        geom = fit_geometry(theta, torch.full((n,), 1.0 / n, device=cuda), g)
        before = fk.ar_inverse_backward.launches
        st = sweep.init_state(u, x, ldj, like(x), prior.logpdf(x), 2.38 / d ** 0.5, geom, fp,
                              beta=1.0, scp=scp)
        for _ in range(3):
            prop = sweep.propose(st, geom, fp, scp, sweep.draw_noise(st, geom, g), beta=1.0)
            st, _ = sweep.accept_update(st, prop, prop["logl"], 1.0, geom)
        torch.cuda.synchronize()
    assert fk.ar_inverse_backward.launches >= before + 4
    assert all(bool(torch.isfinite(a).all()) for a in (st.u, st.x, st.logl, st.grad))


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_sampler_runs_at_d_342_on_card(cuda, kind):
    """``Sampler.run`` with sample="mala" or "hmc" and an nsf3 flow at d =
    342 (h = 2048) on the card, on a broad Gaussian likelihood that takes
    beta to 1 in a few iterations: the run ends with a finite evidence and
    finite posterior, and its gradients went through K1-bwd."""
    import pocomc_tpu_torch as pt
    d = 342
    prior = pt.Prior([pt.Normal(0.0, 3.0)] * d)

    def like(x):
        return -0.5 * ((x - 0.1) ** 2).sum(-1) / 100.0

    s = pt.Sampler(prior, like, vectorize=True, random_state=0, n_effective=128, n_active=64,
                   flow="nsf3", sample=kind, n_steps=2, n_max_steps=4,
                   train_config=dict(epochs=2, patience=2), device="cuda")
    before = fk.ar_inverse_backward.launches
    s.run(n_total=128, n_evidence=128, progress=False)
    torch.cuda.synchronize()
    assert fk.ar_inverse_backward.launches > before
    logz, _ = s.evidence()
    x, w, ll, _ = s.posterior()
    assert np.isfinite(logz)
    assert all(np.isfinite(np.asarray(a)).all() for a in (x, w, ll))


def _forward_f64(fp, x, g_l, head, window=1e-5):
    """The stack's forward (``made_rqs_forward_ref``) at x in float64, one
    transform's weights in float64 at a time: (each transform's input, the
    output, and the rows whose gradient two correct fp32 routes may give
    differently: in the float64 forward some hidden pre-activation lies
    within `window` of 0, or, with dL/dladj != 0, some transform input
    within `window` of a knot of its spline), as ``_kink_rows`` and
    ``_made_edge_rows`` find them without a float64 copy of the flow."""
    from pocomc_tpu_torch.models import transforms as tr
    n, d = x.shape
    near = torch.zeros(n, dtype=torch.bool, device=x.device)
    xs = [x.double()]
    for t in range(fp.ws[0].shape[0]):
        w = [a[t].double() for a in fp.ws]
        b = [a[t].double() for a in fp.bs]
        h = xs[-1] @ w[0] + b[0]
        near |= (h.abs() < window).any(-1)
        for l in (1, 2):
            h = h + torch.relu(h) @ w[l] + b[l]
            near |= (h.abs() < window).any(-1)
        p = (torch.relu(h) @ w[3] + b[3]).reshape(n, d, fk.HEADS[head])
        if head == "rqs":
            knots = tr._rqs_setup(p, 8)[0]
            near |= ((xs[-1][..., None] - knots).abs() < window).any(-1).any(-1) & (g_l != 0)
        xs.append(fk._element(head)[0](xs[-1], p)[0])
    return xs[:-1], xs[-1], near


@pytest.mark.parametrize("arch,d,n", [("nsf3", 342, 8), ("maf3", 342, 8), ("nsf3", 683, 8),
                                      ("maf3", 683, 8), ("nsf3", 1366, 8), ("maf3", 1366, 8),
                                      ("nsf3", 2730, 4), ("maf3", 2730, 4)])
def test_k1_backward_inverts_the_forward_at_every_width(cuda, arch, d, n):
    """K1 and K1-bwd up to d = 2730 (h = 8192, the widest K1 runs), where
    the plain VJP's d network VJPs a transform would read terabytes: held
    to float64 through the forward's Jacobian J instead. x = K1(z) goes
    back to z through the float64 forward within 1e-3 of max |z|; and
    since g_z = J^-T (g_x - g_ladj grad log|det J|), the float64 forward's
    VJP at x (``made_rqs_backward_ref``) of K1-bwd's g_z, with the same
    g_ladj, gives back g_x within 1e-3 of max |g_x| (chip_smoke's gradient
    tolerance past d = 10), rows on a ReLU kink or a float64 knot left out
    (the gradient jumps there)."""
    f = _grad_card_flow(d, arch, seed=d)
    g = torch.Generator("cuda").manual_seed(n)
    z = torch.randn(n, d, device="cuda", generator=g)
    g_x = torch.randn(n, d, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    with torch.no_grad():
        fp = f.params()
        x, _, state = fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, f.head, True)
        xs, back, edge = _forward_f64(fp, x, g_l, f.head)
        assert float((back - z.double()).abs().max()) <= 1e-3 * float(z.abs().max())
        g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        before = fk.ar_inverse_backward.launches + fk.ar_inverse_backward.launches_affine
        g_z = fk.ar_inverse_backward(state, fp.ws, fp.bs, fp.inv_orders, g_x, g_l, f.head)
        after = fk.ar_inverse_backward.launches + fk.ar_inverse_backward.launches_affine
        assert after == before + 1 and bool(torch.isfinite(g_z).all())
        g = g_z.double()
        for t in reversed(range(len(xs))):
            w = [a[t:t + 1].double() for a in fp.ws]
            b = [a[t:t + 1].double() for a in fp.bs]
            g = fk.made_rqs_backward_ref(xs[t], w, b, g, g_l.double(), head=f.head)[0]
    assert float((g - g_x.double()).abs().max()) <= 1e-3 * float(g_x.abs().max())


@pytest.mark.parametrize("arch", ["nsf6", "maf6"])
def test_k1_gradient_through_the_flow_matches_plain_autograd(cuda, arch):
    """The flow's inverse with detached weights is differentiable in z on
    the card (K1, then K1-bwd on the way back): z's gradient of a loss on
    x and the log-det, pre-layer included, against plain autograd of the
    plain inverse on the same z, rows on a float64 knot left out."""
    f = _random_card_flow(10, arch, seed=3)
    g = torch.Generator("cuda").manual_seed(5)
    z = torch.randn(256, 10, device=cuda, generator=g)
    g_x = torch.randn(256, 10, device=cuda, generator=g)
    g_l = torch.randn(256, device=cuda, generator=g)
    fp = _detached(f.params())
    with torch.no_grad():
        x, _ = f.inverse(z, fp)
        y = ((x - fp.pre["mean"]) @ fp.pre["w_fwd"]).contiguous()
        edge = _made_edge_rows(f, y, g_l) | _kink_rows(f, y)
    g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
    grads = []
    for inverse in (fk.ar_inverse, fk.ar_inverse_ref):
        zz = z.clone().requires_grad_(True)
        yy, l = inverse(zz, fp.ws, fp.bs, fp.inv_orders, head=f.head)
        xx = yy @ fp.pre["w_inv"] + fp.pre["mean"]
        grads.append(torch.autograd.grad((xx, l), zz, (g_x, g_l))[0])
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * float(grads[1].abs().max())


@pytest.mark.parametrize("d,arch", [(20, "nsfc6"), (51, "nsfc6"), (171, "nsfc6"), (342, "nsfc3")])
@pytest.mark.parametrize("n", [1, 9, 33, 257])
def test_k5_inverse_backward_matches_plain_at_tile_edges(cuda, d, arch, n):
    """K5-inv-bwd at K5's tile edges (d=20: h=64; 51: odd halves, h=256;
    171: two passes of 512 columns on 8-row Tiles; 342: Row tiles), on the
    state the inverse's save instance writes, against the plain save mode
    at the same z (``coupling_inverse_ref(..., save_inputs=True)``) and
    ``coupling_inverse_vjp_ref`` on its state, in fp32 and in float64. The
    saved state (x_t, relu(h0..h2), the spline parameters, zero past a
    transform's own at odd d) within max(5e-4 of its largest, at least 1,
    4x the plain fp32 state's distance to float64) of the float64 state;
    g_z within max(1e-3 of the largest g_z, 4x the plain fp32 version's
    distance to the plain version in float64) of that float64 value, rows
    on a float64 knot with dL/dladj != 0 (``_coupling_edge_rows``) or on a
    ReLU kink (``_kink_rows``) left out."""
    import copy
    flow = _menu_card_flow(d, arch)
    g = torch.Generator("cuda").manual_seed(n)
    z = torch.randn(n, d, device=cuda, generator=g)
    g_x = torch.randn(n, d, device=cuda, generator=g)
    g_l = torch.randn(n, device=cuda, generator=g)
    with torch.no_grad():
        fp = flow.params()
        fp64 = copy.deepcopy(flow).double().params()
        x, _, state = ck._launch_stack(z, fp.ws, fp.bs, fp.masks, True, True, "coupling_inverse")
        x_p, _, plain_state = ck.coupling_inverse_ref(z, fp.ws, fp.bs, fp.masks, save_inputs=True)
        state64 = ck.coupling_inverse_ref(z.double(), fp64.ws, fp64.bs, fp64.masks,
                                          save_inputs=True)[2]
        for a, b, e in zip(state, plain_state, state64):
            assert a.shape == e.shape
            limit = max(5e-4 * max(float(e.abs().max()), 1.0),
                        4 * float((b.double() - e).abs().max()))
            assert float((a.double() - e).abs().max()) <= limit
        edge = _coupling_edge_rows(flow, x_p, g_l) | _kink_rows(flow, x_p)
        g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        before = ck.coupling_inverse_backward.launches
        got = ck.coupling_inverse_backward(state, fp.ws, fp.bs, fp.masks, g_x, g_l)
        assert ck.coupling_inverse_backward.launches == before + 1
        with pytest.raises(ValueError, match="state"):
            ck.coupling_inverse_backward(x, fp.ws, fp.bs, fp.masks, g_x, g_l)
        plain = ck.coupling_inverse_vjp_ref(plain_state, fp.ws, fp.bs, fp.masks, g_x, g_l)
        exact = ck.coupling_inverse_vjp_ref(state64, fp64.ws, fp64.bs, fp64.masks,
                                            g_x.double(), g_l.double())
    _assert_float64(got, plain, exact, T50["grad"])


@pytest.mark.parametrize("arch", ["nsf3", "maf3", "nsfc3"])
def test_mala_step_on_card_matches_cpu(cuda, arch):
    """One preconditioned mala step with injected noise on the card (K1 or
    K5's inverse and its backward in the gradient pass) against the same
    step on the CPU (the plain versions): the start's gradient, the
    proposal, its gradient and Metropolis correction within 1e-4 of the
    largest element of each (the gradient tolerance: the two sum in
    other orders, and the proposal moves along the gradient), and the
    same accept decisions."""
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.mcmc import Sweep, make_loglike
    from pocomc_tpu_torch.models.geometry import fit_geometry
    d, n = 4, 128
    prior = pt.Prior([pt.Normal(0.0, 5.0)] * d)
    scaler = pt.Reparameterize(d, bounds=prior.bounds)
    rng = np.random.default_rng(0)
    scaler.fit(5.0 * rng.standard_normal((512, d)))
    flow = _random_card_flow(d, arch, seed=1)
    u = (0.5 * rng.standard_normal((n, d)) + 0.1).astype(np.float32)
    noise_np = dict(z=rng.standard_normal((n, d)).astype(np.float32),
                    unif=rng.uniform(size=n).astype(np.float32))

    def like(x):
        return -0.5 * ((x - 0.5) ** 2 / 0.3).sum(-1)

    out = []
    for dev in ("cuda", "cpu"):
        f = flow if dev == "cuda" else flow.to("cpu")
        sweep = Sweep(scaler, prior.logpdf, make_loglike(like), f, d, 2, 10, kind="mala")
        scp = scaler.whitening_params(dev)
        ut = torch.from_numpy(u).to(dev)
        with torch.no_grad():
            fp = _detached(f.params())
            x, ldj = scaler.inverse(ut, params=scp)
            theta, _ = f.forward(ut, fp)
            geom = fit_geometry(theta)
            st = sweep.init_state(ut, x, ldj, like(x), prior.logpdf(x), 0.5, geom, fp,
                                  beta=0.6, scp=scp)
            noise = {k: torch.from_numpy(v).to(dev) for k, v in noise_np.items()}
            prop = sweep.propose(st, geom, fp, scp, noise, beta=0.6)
            st2, acc = sweep.accept_update(st, prop, prop["logl"], 0.6, geom)
        out.append(dict(grad0=st.grad, u=prop["u"], grad=prop["grad"], corr=prop["corr"],
                        acc=acc))
    card, cpu = out
    for k in ("grad0", "u", "grad", "corr"):
        assert float((card[k].cpu() - cpu[k]).abs().max()) <= 1e-4 * float(cpu[k].abs().max())
    assert torch.equal(card["acc"].cpu(), cpu["acc"])


# -- K2's backward on K5's tiles, and K5-inv-bwd through the save instance --

@pytest.mark.parametrize("head", ["rqs", "affine"])
@pytest.mark.parametrize("d", [2, 10, 50, 820])
@pytest.mark.parametrize("n", [1, 37, 1024, 4096])
def test_k2_backward_at_tile_edges(cuda, head, d, n):
    """K2's backward (the pack kernel, then the backward on K5's tiles:
    a ragged 8-row tile at n = 1 and 37, 8-row Tiles at 1024, 32-row ones
    at 4096 from d = 10, Row tiles at d = 820, h = 4096) with the
    weight-gradient products against ``made_rqs_backward_ref`` on the same
    saved layer inputs, masked weights of a flow (nsf/maf6, nsf/maf3 at
    d = 820) with random output layers, rows in the tails and rows of zero
    upstream gradient included: every gradient within chip_smoke.py's
    gradient tolerance of its largest (1e-4 at d <= 10, 1e-3 past). As
    chip_smoke.py's checks do, a row whose spline input lies within 1e-5
    of a knot in the float64 forward takes dL/dladj = 0 (``_made_edge_rows``:
    the log-det's gradient jumps there, and the two routes' fp32 head
    parameters pick its side; one such row of 4096 at d = 50 moved g_y by
    1.3e-3 of its largest)."""
    arch = ("nsf" if head == "rqs" else "maf") + ("3" if d > 50 else "6")
    flow = _grad_card_flow(d, arch, seed=d)
    g = torch.Generator("cuda").manual_seed(n + d)
    y = 1.5 * torch.randn(n, d, device=cuda, generator=g)
    y[::5, 0] = 6.0
    g_z = torch.randn(n, d, device=cuda, generator=g)
    g_l = torch.randn(n, device=cuda, generator=g)
    g_z[1::3] = 0.0
    g_l[1::3] = 0.0
    g_l = g_l.masked_fill(_made_edge_rows(flow, y, g_l), 0.0)
    with torch.no_grad():
        fp = flow.params()
        _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head=head)
        attr = "launches" if head == "rqs" else "launches_affine"
        before = getattr(fk.made_rqs_backward, attr)
        got = fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts, head=head)
        assert getattr(fk.made_rqs_backward, attr) == before + 1
        want = fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l, acts, head=head)
    tol = T10["grad"] if d <= 10 else T50["grad"]
    for a, b in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        assert a.shape == b.shape
    _assert_grads([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]], tol)
    # the wrapper's pack size is the source's
    import ctypes
    h, T, np_ = flow.n_hidden, flow.n_transforms, fk.HEADS[head]
    cfg, n_pack = fk._k2_backward_plan(n, d, h, T, np_)
    count = fk._build.load("made_rqs_backward").made_rqs_backward_pack_floats
    count.argtypes, count.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    assert count(d, h, T, np_, cfg.G, cfg.ldo, cfg.PW) == n_pack


@pytest.mark.parametrize("d", [10, 50])
@pytest.mark.parametrize("n", [1, 37, 256, 4096])
def test_k5_inverse_backward_through_the_save_instance(cuda, d, n):
    """K5-inv-bwd through the inverse's save instance: the autograd route
    (``coupling_inverse`` with z requiring a gradient) and the direct call
    on the state the save instance writes (``_launch_stack`` with the
    save) give the same bits, each with one launch of the kernel and none
    of K5's forward; the save instance's x and log-det are the inverse's without
    the save, bit for bit, and its state is the plain save mode's on the
    same z within the coupling tolerance (chip_smoke.COUPLING_TOL's atol
    on values)."""
    arch = "nsfc6" if d == 10 else "nsfc12"
    flow = _menu_card_flow(d, arch, seed=n)
    fp = _detached(flow.params())
    g = torch.Generator("cuda").manual_seed(d + n)
    z = torch.randn(n, d, device=cuda, generator=g)
    g_x = torch.randn(n, d, device=cuda, generator=g)
    g_l = torch.randn(n, device=cuda, generator=g)
    with torch.no_grad():
        x0, l0 = ck.coupling_inverse(z, fp.ws, fp.bs, fp.masks)
        x1, l1, state = ck._launch_stack(z, fp.ws, fp.bs, fp.masks, True, True,
                                         "coupling_inverse")
        assert torch.equal(x0, x1) and torch.equal(l0, l1)
        want = ck.coupling_inverse_ref(z, fp.ws, fp.bs, fp.masks, save_inputs=True)[2]
        atol = smoke.COUPLING_TOL[d][0]
        for a, b in zip(state, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= atol * max(float(b.abs().max()), 1.0)
    forwards, inv_bwd = ck.coupling_forward.launches, ck.coupling_inverse_backward.launches
    zz = z.clone().requires_grad_(True)
    x, l = ck.coupling_inverse(zz, fp.ws, fp.bs, fp.masks)
    by_autograd, = torch.autograd.grad((x, l), zz, (g_x, g_l))
    assert ck.coupling_forward.launches == forwards
    assert ck.coupling_inverse_backward.launches == inv_bwd + 1
    with torch.no_grad():
        direct = ck.coupling_inverse_backward(state, fp.ws, fp.bs, fp.masks, g_x, g_l)
    assert torch.equal(by_autograd, direct)


# -- the spline of any bins: one library a source and bins up to 16, one
# -- library a source of run-time bins past that ---------------------------

# the bins where the kernels' layouts change: 2 (the fewest), 3 and 5 (not
# powers of two: the warp-wide spline gathers its segments), 10 (the last
# whose NP + 1 = 30 values fit a warp a value a lane), 11 (the first that
# does not: K1's one-row warps run the serial spline, K1-bwd's take 8 lanes
# a row, two bins a lane) and 16 (the most of a compiled library); past 16
# the library of run-time bins: 17 (its fewest), 32, 64, 128 (K5's output
# group of one dimension passes an output pass from 86 bins), 512 (half
# the interval's width and height left to the parameters' softmax) and
# 1000 (the most a spline holds: 1 - MIN_BIN * bins = 0)
BINS = (2, 3, 5, 10, 11, 16, 17, 32, 64, 128, 512, 1000)


@pytest.fixture(scope="module")
def bins_libraries():
    """Every (source, bins) library these tests load, built at once, one
    nvcc each, all started together (the run-time library once for every
    bins past 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from concurrent.futures import ThreadPoolExecutor
    from pocomc_tpu_torch.ops import _build
    names = ("made_rqs_forward", "made_rqs_backward", "ar_inverse", "ar_inverse_backward",
             "coupling_forward", "coupling_backward")
    jobs = sorted({(a, fk.lib_bins(b)) for a in names for b in BINS})
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(*job), jobs))


@pytest.mark.parametrize("bins", BINS)
@pytest.mark.parametrize("n", [37, 256])
def test_k2_and_k1_match_plain_at_bins(bins_libraries, bins, n):
    """nsf6 at d=10 with the spline of ``bins`` bins: K2's forward and K1
    against their plain versions (values 1e-5, log-dets 1e-4, as
    chip_smoke's TOL[10]), the round trip forward(inverse(z)) = z within
    1e-4, the gradient through K2 and K2-bwd by autograd against plain
    autograd of the plain forward, and K2-bwd on the saved inputs against
    ``made_rqs_backward_ref``, to 1e-4 of the largest gradient, rows on a
    float64 knot left out; past 16 bins every reference also in float64
    (chip_smoke's ``values_verdict``, ``_grads_vs_float64``: phase 14's
    rule), rows on a ReLU kink left out too; each wrapper counts its
    launches under ``launch_attr("rqs", bins)``."""
    flow = _random_card_flow(10, "nsf6", seed=bins, bins=bins)
    attr = fk.launch_attr("rqs", bins)
    g = torch.Generator("cuda").manual_seed(n)
    y = torch.randn(n, 10, device="cuda", generator=g)
    counts = lambda: [getattr(w, attr, 0) for w in (fk.made_rqs_forward, fk.made_rqs_backward,
                                                     fk.ar_inverse)]
    before = counts()
    with torch.no_grad():
        fp = flow.params()
        z, l = fk.made_rqs_forward(y, fp.ws, fp.bs, bins=bins)
        x, li = fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders, bins=bins)
        z_r, l_r = fk.made_rqs_forward_ref(y, fp.ws, fp.bs, bins=bins)
        x_r, li_r = fk.ar_inverse_ref(y, fp.ws, fp.bs, fp.inv_orders, bins=bins)
        back, _ = fk.made_rqs_forward(x, fp.ws, fp.bs, bins=bins)
    if bins <= fk.FIXED_BINS:
        torch.testing.assert_close(z, z_r, **TOL)
        torch.testing.assert_close(l, l_r, rtol=0, atol=LADJ)
        torch.testing.assert_close(x, x_r, **TOL)
        torch.testing.assert_close(li, li_r, rtol=0, atol=LADJ)
    else:
        import copy
        with torch.no_grad():
            fp64 = copy.deepcopy(flow).double().params()
            z_e, l_e = fk.made_rqs_forward_ref(y.double(), fp64.ws, fp64.bs, bins=bins)
            x_e, li_e = fk.ar_inverse_ref(y.double(), fp64.ws, fp64.bs, fp64.inv_orders,
                                          bins=bins)
        ladj = smoke.narrow_tol(dict(ladj=LADJ), bins)["ladj"]
        for got, plain, exact, rtol, atol in ((z, z_r, z_e, TOL["rtol"], TOL["atol"]),
                                              (l, l_r, l_e, 0, ladj),
                                              (x, x_r, x_e, TOL["rtol"], TOL["atol"]),
                                              (li, li_r, li_e, 0, ladj)):
            ok, out = smoke.values_verdict(got, plain, exact, rtol, atol)
            assert ok, out
    torch.testing.assert_close(back, y, rtol=0, atol=10 * TOL["atol"])
    g_z = torch.randn(n, 10, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    edge = _made_edge_rows(flow, y, g_l)
    if bins > fk.FIXED_BINS:  # against float64: the rows on a ReLU kink too
        edge |= _kink_rows(flow, y)
    g_z, g_l = g_z.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
    grads = []
    for f in (fk.made_rqs_forward, fk.made_rqs_forward_ref):
        flow.zero_grad(set_to_none=True)
        yy = y.clone().requires_grad_(True)
        fp = flow.params()
        out = f(yy, fp.ws, fp.bs, bins=bins)
        torch.autograd.backward(out, (g_z, g_l))
        grads.append([yy.grad] + [p.grad.clone() for p in flow.parameters()])
    if bins <= fk.FIXED_BINS:
        _assert_grads(*grads, T10["grad"])
    else:
        # past 16 bins against float64 autograd of the plain forward
        flow64 = copy.deepcopy(flow).double()
        flow64.zero_grad(set_to_none=True)
        yy = y.double().requires_grad_(True)
        fp = flow64.params()
        torch.autograd.backward(fk.made_rqs_forward_ref(yy, fp.ws, fp.bs, bins=bins),
                                (g_z.double(), g_l.double()))
        _grads_vs_float64(grads[0], [yy.grad] + [p.grad for p in flow64.parameters()], bins)
    with torch.no_grad():
        fp = flow.params()
        _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, bins=bins)
        got = fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts, bins=bins)
        want = fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l, acts, bins=bins)
        if bins > fk.FIXED_BINS:  # on the same saved inputs, against float64
            want = fk.made_rqs_backward_ref(y.double(), fp64.ws, fp64.bs, g_z.double(),
                                            g_l.double(), [a.double() for a in acts],
                                            bins=bins)
    flat = lambda g: [g[0], *g[1], *g[2]]
    if bins <= fk.FIXED_BINS:
        _assert_grads(flat(got), flat(want), T10["grad"])
    else:
        _grads_vs_float64(flat(got), flat(want), bins)
    assert counts() == [before[0] + 4, before[1] + 2, before[2] + 1]


@pytest.mark.parametrize("bins", BINS)
@pytest.mark.parametrize("n", [37, 256])
def test_k5_matches_plain_at_bins(bins_libraries, bins, n):
    """nsfc6 at d=10 with the spline of ``bins`` bins: K5's forward and
    inverse against their plain versions (values 5e-5, log-dets 5e-4:
    chip_smoke.COUPLING_TOL[10]), the conditioning columns of a transform
    bit for bit, and K5's backward on the saved inputs against
    ``coupling_backward_ref``, to 1e-4 of the largest gradient, rows on a
    float64 knot left out; past 16 bins as
    ``test_k2_and_k1_match_plain_at_bins``."""
    flow = _random_card_flow(10, "nsfc6", seed=bins, bins=bins)
    attr = fk.launch_attr("rqs", bins)
    c_val, c_ladj = smoke.COUPLING_TOL[10]
    g = torch.Generator("cuda").manual_seed(n)
    y = torch.randn(n, 10, device="cuda", generator=g)
    before = [getattr(w, attr, 0) for w in (ck.coupling_forward, ck.coupling_inverse,
                                            ck.coupling_backward)]
    with torch.no_grad():
        fp = flow.params()
        if bins > fk.FIXED_BINS:
            import copy
            fp64 = copy.deepcopy(flow).double().params()
        for fn, ref in ((ck.coupling_forward, ck.coupling_forward_ref),
                        (ck.coupling_inverse, ck.coupling_inverse_ref)):
            (a, la), (b, lb) = fn(y, fp.ws, fp.bs, fp.masks, bins=bins), \
                ref(y, fp.ws, fp.bs, fp.masks, bins=bins)
            if bins <= fk.FIXED_BINS:
                torch.testing.assert_close(a, b, rtol=TOL["rtol"], atol=c_val)
                torch.testing.assert_close(la, lb, rtol=TOL["rtol"], atol=c_ladj)
            else:
                e, le = ref(y.double(), fp64.ws, fp64.bs, fp64.masks, bins=bins)
                ladj = smoke.narrow_tol(dict(ladj=c_ladj), bins)["ladj"]
                for v in (smoke.values_verdict(a, b, e, TOL["rtol"], c_val),
                          smoke.values_verdict(la, lb, le, TOL["rtol"], ladj)):
                    assert v[0], v[1]
        one, _ = ck.coupling_inverse(y, fp.ws[:1], fp.bs[:1], fp.masks[:1], bins=bins)
        assert torch.equal(one[:, fp.masks[0]], y[:, fp.masks[0]])
        g_z = torch.randn(n, 10, device="cuda", generator=g)
        g_l = torch.randn(n, device="cuda", generator=g)
        edge = _coupling_edge_rows(flow, y, g_l)
        if bins > fk.FIXED_BINS:  # against float64: the rows on a ReLU kink too
            edge |= _kink_rows(flow, y)
        g_z, g_l = g_z.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        _, _, acts = ck.coupling_forward(y, fp.ws, fp.bs, fp.masks, save_inputs=True, bins=bins)
        got = ck.coupling_backward(y, fp.ws, fp.bs, fp.masks, g_z, g_l, acts, bins=bins)
        want = ck.coupling_backward_ref(y, fp.ws, fp.bs, fp.masks, g_z, g_l, acts, bins=bins)
        if bins > fk.FIXED_BINS:  # on the same saved inputs, against float64
            want = ck.coupling_backward_ref(y.double(), fp64.ws, fp64.bs, fp64.masks,
                                            g_z.double(), g_l.double(),
                                            [a.double() for a in acts], bins=bins)
    flat = lambda g: [g[0], *[a for t in g[1] for a in t], *[a for t in g[2] for a in t]]
    if bins <= fk.FIXED_BINS:
        _assert_grads(flat(got), flat(want), T10["grad"])
    else:
        _grads_vs_float64(flat(got), flat(want), bins)
    after = [getattr(w, attr) for w in (ck.coupling_forward, ck.coupling_inverse,
                                        ck.coupling_backward)]
    assert after == [before[0] + 2, before[1] + 2, before[2] + 1]


@pytest.mark.parametrize("bins", BINS)
@pytest.mark.parametrize("n", [37, 256])
def test_gradient_kernels_match_plain_at_bins(bins_libraries, bins, n):
    """K1-bwd on K1's saved state (nsf6, d=10) and K5-inv-bwd on the
    inverse's save instance's state (nsfc6, d=10), with the spline of
    ``bins`` bins, against ``ar_inverse_vjp_ref`` and
    ``coupling_inverse_vjp_ref`` in float64: within 1e-4 of the largest
    g_z, or 4x the plain fp32 version's distance where that is larger
    (``_assert_float64``), rows on a knot or a ReLU kink left out; K1-bwd
    gives the same bits twice."""
    import copy
    got, again, plain, exact = _k1_backward_case("nsf6", 10, n, bins)
    assert torch.equal(got, again)
    _assert_float64(got, plain, exact, T10["grad"])
    flow = _random_card_flow(10, "nsfc6", seed=bins, bins=bins)
    g = torch.Generator("cuda").manual_seed(n)
    z = torch.randn(n, 10, device="cuda", generator=g)
    g_x = torch.randn(n, 10, device="cuda", generator=g)
    g_l = torch.randn(n, device="cuda", generator=g)
    with torch.no_grad():
        fp = flow.params()
        fp64 = copy.deepcopy(flow).double().params()
        _, _, state = ck._launch_stack(z, fp.ws, fp.bs, fp.masks, True, True, "coupling_inverse",
                                       bins)
        x_p, _, plain_state = ck.coupling_inverse_ref(z, fp.ws, fp.bs, fp.masks, True, bins)
        state64 = ck.coupling_inverse_ref(z.double(), fp64.ws, fp64.bs, fp64.masks, True,
                                          bins)[2]
        edge = _coupling_edge_rows(flow, x_p, g_l) | _kink_rows(flow, x_p)
        g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        attr = fk.launch_attr("rqs", bins)
        before = getattr(ck.coupling_inverse_backward, attr, 0)
        got = ck.coupling_inverse_backward(state, fp.ws, fp.bs, fp.masks, g_x, g_l, bins=bins)
        assert getattr(ck.coupling_inverse_backward, attr) == before + 1
        plain = ck.coupling_inverse_vjp_ref(plain_state, fp.ws, fp.bs, fp.masks, g_x, g_l, bins)
        exact = ck.coupling_inverse_vjp_ref(state64, fp64.ws, fp64.bs, fp64.masks,
                                            g_x.double(), g_l.double(), bins)
    _assert_float64(got, plain, exact, T10["grad"])


@pytest.mark.parametrize("bins", BINS)
@pytest.mark.parametrize("lanes", [32, 8])
def test_kernel_element_vjp_at_bins(bins_libraries, bins, lanes):
    """K1-bwd's element VJP with the spline of ``bins`` bins, warp-wide
    (up to 10 bins; past that the entry refuses it) or on 8 lanes a row
    (up to 16; past that the entry refuses it, and the kernel's own is the
    one-lane streaming one, held to float64 with the plain fp32 version as
    the second reading), against the plain ``inverse_element_vjp`` in
    float64 by K5's rule
    (``_assert_float64``): within 1e-4 of each tensor's largest value, or
    4x the one-lane version's own distance where that is larger, rows
    within 1e-5 of a knot in float64 left out. The one-lane version sums in
    the serial order and the kernel's in another (a lane's bins, then the
    lanes' totals), so where the largest gradients pass 100 (slopes near
    0) both lie ~1e-4 of it from float64 (one reading: 1.13e-4 warp-wide at
    10 bins, where the 8-bin test holds kernel to one-lane at 1e-5)."""
    from pocomc_tpu_torch.models import transforms as tr
    n, npar = 4093, 3 * bins - 1
    rng = np.random.default_rng(bins)
    x = rng.uniform(-6.0, 6.0, n).astype(np.float32)
    x[:4] = [5.0, -5.0, 4.999999, -4.999999]
    p = torch.from_numpy((0.5 * rng.standard_normal((n, npar))).astype(np.float32)).cuda()
    x = torch.from_numpy(x).cuda()
    g_x, g_l = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
                for _ in range(2))
    if (lanes == 32 and bins > 10) or bins > fk.FIXED_BINS:
        with pytest.raises(RuntimeError, match="cudaError"):
            fk._element_vjp(x, p, g_x, g_l, "rqs", lanes, bins)
        if bins <= fk.FIXED_BINS:
            return
    if bins > fk.FIXED_BINS:
        kernel = fk._element_vjp(x, p, g_x, g_l, "rqs", 1, bins)
        lane = fk.inverse_element_vjp(x, p, g_x, g_l, "rqs", bins)
    else:
        kernel = fk._element_vjp(x, p, g_x, g_l, "rqs", lanes, bins)
        lane = fk._element_vjp(x, p, g_x, g_l, "rqs", 1, bins)
    exact = fk.inverse_element_vjp(x.double(), p.double(), g_x.double(), g_l.double(), "rqs",
                                   bins)
    knots = tr._rqs_setup(p.double(), bins)[0]
    keep = ~((x.double()[:, None] - knots).abs() < 1e-5).any(-1)
    for a, b, e in zip(kernel, lane, exact):
        _assert_float64(a[keep], b[keep], e[keep], T10["grad"])


@pytest.mark.parametrize("bins", [11, 16, 32])
def test_k1_and_k1_backward_chunk_a_wide_output_group(bins_libraries, bins):
    """nsf3 at d=342 (h=2048) with the spline of ``bins`` bins, whose
    output group (3 bins - 1 columns, 32 or more; past 16 bins groups of 24
    of them) is too large for a ring stage at this width and goes in
    fan-in chunks, a column a lane and more columns than lanes: K1 against
    the plain inverse (d=50's
    tolerances, chip_smoke's TOL[50]) and K1-bwd on its saved state against
    the plain VJP in float64 by K5's rule (1e-3 of the largest g_z, or 4x
    the plain fp32 version's distance), rows on a knot or a kink left
    out."""
    f = _grad_card_flow(342, "nsf3", seed=342, bins=bins)
    z = torch.randn(8, 342, device="cuda", generator=torch.Generator("cuda").manual_seed(bins))
    with torch.no_grad():
        fp = f.params()
        x, l = fk.ar_inverse(z, fp.ws, fp.bs, fp.inv_orders, bins=bins)
        x_r, l_r = fk.ar_inverse_ref(z, fp.ws, fp.bs, fp.inv_orders, bins=bins)
    torch.testing.assert_close(x, x_r, **T50_VALUES)
    torch.testing.assert_close(l, l_r, rtol=0, atol=T50["ladj"])
    got, again, plain, exact = _k1_backward_case("nsf3", 342, 8, bins)
    assert torch.equal(got, again)
    _assert_float64(got, plain, exact, T50["grad"])


def test_bins_past_16_raise_at_construction_on_card(cuda):
    """Flow(device="cuda") takes a spline of 17 bins and of 1000, the most
    a spline holds (no ceiling stands below it: every planner holds 1000
    bins wherever it holds 16, tests/test_torch_bins_wide.py), and its
    log_prob runs the kernels of the run-time library, counted under
    launches_b<bins>; a maf flow keeps any bins."""
    for arch, wrapper in (("nsf6", fk.made_rqs_forward), ("nsfc6", ck.coupling_forward)):
        for bins in (17, 1000):
            f = Flow(4, arch, bins=bins, device="cuda")
            before = getattr(wrapper, fk.launch_attr("rqs", bins), 0)
            with torch.no_grad():
                assert torch.isfinite(f.log_prob(torch.randn(8, 4, device="cuda"))).all()
            assert getattr(wrapper, fk.launch_attr("rqs", bins)) == before + 1
    assert Flow(4, "maf6", bins=17, device="cuda").bins == 17
