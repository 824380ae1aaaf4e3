"""The two CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device every test here skips. On a machine
with one, run ``python3 -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest``.
Tolerances as in chip_smoke.py at d <= 10: 1e-5 on values, 1e-4 on
log-dets (the kernel sums in another order than torch)."""

import numpy as np
import pytest
import torch

import pocomc_tpu_torch  # noqa: F401
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.ops import flow_kernels as fk

pytestmark = pytest.mark.gpu


@pytest.fixture
def flow():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    f = Flow(6, "nsf6").cuda()
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
    torch.testing.assert_close(z, z_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=0, atol=1e-4)
    torch.testing.assert_close(x, x_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(li, li_r, rtol=0, atol=1e-4)


def test_forward_gradients_match_plain_autograd(flow):
    y = torch.randn(64, 6, device="cuda")
    grads = []
    for f in (fk.made_rqs_forward, fk.made_rqs_forward_ref):
        flow.zero_grad(set_to_none=True)
        fp = flow.params()
        z, l = f(y, fp.ws, fp.bs)
        (z.sum() + l.sum()).backward()
        grads.append([p.grad.clone() for p in flow.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_cuda_inputs_are_checked(flow):
    fp = flow.params()
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        fk.ar_inverse(torch.zeros(6, 8, device="cuda").T, fp.ws, fp.bs, fp.inv_orders)
    with pytest.raises(NotImplementedError):
        fk.ar_inverse(torch.zeros(8, 6, device="cuda", requires_grad=True), fp.ws, fp.bs,
                      fp.inv_orders)
