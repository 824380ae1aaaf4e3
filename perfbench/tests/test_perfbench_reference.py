"""The plain references against float64 at tiny sizes: the spline's and
the stacks' round trips and log-determinants by autograd, the stacks
against the program's own plain versions in float64, phase A's bisection
meeting its ESS target in float64."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import flows, smc
from perfbench.reference.precision import to_tf32
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk

F64 = torch.float64


def _random_flow(d, kind, seed=0):
    f = Flow(d, kind, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for w in f.weights:
            w.copy_(0.3 * torch.randn(w.shape, generator=g) / math.sqrt(w.shape[-2]))
        for b in f.biases:
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return f


@pytest.mark.parametrize("bins", [4, 8])
def test_spline_round_trip_and_log_det(bins):
    g = torch.Generator().manual_seed(bins)
    x = 6 * torch.rand(64, 3, generator=g, dtype=F64) - 3
    p = torch.randn(64, 3, 3 * bins - 1, generator=g, dtype=F64)
    xx = x.clone().requires_grad_(True)
    y, ladj = flows.rqs_forward(xx, p, bins)
    dydx, = torch.autograd.grad(y.sum(), xx)
    assert torch.allclose(ladj, dydx.log(), atol=1e-10)
    xb, lb = flows.rqs_inverse(y.detach(), p, bins)
    assert torch.allclose(xb, x, atol=1e-9) and torch.allclose(lb, -ladj.detach(), atol=1e-9)


def test_made_stack_against_the_program_in_float64():
    f = _random_flow(5, "nsf6")
    fp = f.params()
    ws, bs = [w.detach().double() for w in fp.ws], [b.detach().double() for b in fp.bs]
    y = torch.randn(32, 5, generator=torch.Generator().manual_seed(1), dtype=F64)
    z, l = flows.made_forward(y, ws, bs)
    zp, lp = fk.made_rqs_forward_ref(y, ws, bs)
    assert torch.allclose(z, zp, atol=1e-12) and torch.allclose(l, lp, atol=1e-12)
    x, lx = flows.made_inverse(z, ws, bs, fp.inv_orders)
    assert torch.allclose(x, y, atol=1e-9) and torch.allclose(lx, -l, atol=1e-9)


def test_coupling_stack_against_the_program_in_float64():
    f = _random_flow(6, "nsfc6")
    fp = f.params()
    ws = [[w.detach().double() for w in t] for t in fp.ws]
    bs = [[b.detach().double() for b in t] for t in fp.bs]
    y = torch.randn(32, 6, generator=torch.Generator().manual_seed(2), dtype=F64)
    z, l = flows.coupling_forward(y, ws, bs, fp.masks)
    zp, lp = ck.coupling_forward_ref(y, ws, bs, fp.masks)
    assert torch.allclose(z, zp, atol=1e-12) and torch.allclose(l, lp, atol=1e-12)
    x, lx = flows.coupling_inverse(z, ws, bs, fp.masks)
    assert torch.allclose(x, y, atol=1e-9) and torch.allclose(lx, -l, atol=1e-9)


def test_next_beta_meets_its_target_in_float64():
    rng = np.random.default_rng(3)
    T, n = 4, 200
    logl = -np.abs(rng.normal(0, 30, size=(T, n)))
    beta = np.array([0.0, 0.001, 0.004, 0.01])
    logz = np.array([0.0, -0.05, -0.2, -0.4])
    pad = lambda a: torch.as_tensor(np.concatenate([a, np.zeros((2,) + a.shape[1:])]))
    got, _ = smc.next_beta(pad(logl), pad(beta), pad(logz), T, 300.0, 0.0, 0.0, n_bisect=52)
    w = smc.weights_at(pad(logl), pad(beta), pad(logz), T, float(got))
    assert float(1.0 / (w * w).sum()) == pytest.approx(300.0, rel=1e-6)
    assert float(got) > beta[-1]


def test_tf32_rounding_keeps_ten_bits():
    a = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    assert to_tf32(a).tolist() == [1.0 + 2 ** -10, 1.0, 3.0]


def test_made_masks_are_the_programs():
    from perfbench.reference import train
    for d in (2, 5):
        f = Flow(d, "nsf6", device="cpu")
        hidden = [int(w.shape[-1]) for w in f.weights[:-1]]
        mine = train.made_masks(d, hidden, f.n_params, f.n_transforms, "cpu")
        assert len(mine) == len(f.masks)
        for a, b in zip(mine, f.masks):
            assert torch.equal(a, b.to(F64))


def test_training_replay_is_torchs_clip_and_adamw_in_float64():
    """Three steps of the plain replay against torch's own clip and AdamW
    on the same loss, all in float64."""
    from perfbench.reference import train
    f = _random_flow(4, "nsf6", seed=3)
    before = [p.detach().double() for p in list(f.weights) + list(f.biases)]
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(32, 4, generator=g, dtype=F64), torch.rand(32, generator=g, dtype=F64))
               for _ in range(3)]
    tcfg = dict(learning_rate=1e-2, betas=[0.9, 0.999], eps=1e-8, weight_decay=0.01,
                clip_grad_norm=1.0, loss_scale=1000.0)
    got = train.replay(before, batches, tcfg, 8)
    params = [p.clone().requires_grad_(True) for p in before]
    masks = train.made_masks(4, [32, 32, 32], f.n_params, 6, "cpu")
    opt = torch.optim.AdamW(params, lr=1e-2, weight_decay=0.01)
    for x, w in batches:
        opt.zero_grad()
        loss = train._loss(params[:4], params[4:], masks, x, w, 8, "float64", 1000.0)[0]
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()
    for a, b in zip(got["after"], params):
        assert torch.allclose(a, b.detach(), rtol=0, atol=1e-12)
