"""The rest of the flow menu through the port's Sampler on the CPU: maf*
and nsfc* runs against the analytic evidence (tests/test_sampler.py's
gate), the maf3 knob checks of tests/test_adaptive_budget.py, state and
pickle round trips of both kinds, and JAX nsfc3 and maf3 runs' states
carried into the port (``convert.state_from_jax``)."""

import math
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gaussian_loglike(x):
    return -0.5 * (x * x).sum(-1) - x.shape[-1] / 2 * math.log(2 * math.pi)


def analytic_logz(d=2, scale=5.0):
    return d * norm.logpdf(0, 0, np.sqrt(1 + scale ** 2))


def small(flow, seed=0, **kw):
    return tpc.Sampler(tpc.Prior([tpc.Normal(0, 5), tpc.Normal(0, 5)]), gaussian_loglike,
                       vectorize=True, random_state=seed, n_effective=256, n_active=128,
                       precondition=True, flow=flow, train_config={"epochs": 30, "patience": 5},
                       device="cpu", **kw)


@pytest.mark.parametrize("flow", ["nsfc6", "maf3"])
def test_menu_flow_sampler(flow):
    """tests/test_sampler.py::test_coupling_flow_sampler on the port, and
    the same run with maf3: the flow of that kind preconditions the sweep
    and the evidence lands within max(4 err, 0.2) of the exact logZ."""
    s = small(flow)
    s.run(n_total=512, n_evidence=1024, progress=False)
    assert f"{s.flow.kind}{s.flow.n_transforms}" == flow
    logz, err = s.evidence()
    assert abs(logz - analytic_logz()) < max(4 * err, 0.2)


def test_corr_threshold_and_bias_rate_auto_with_maf3():
    """The maf3 knob checks of tests/test_adaptive_budget.py:343-407 on the
    port: the auto corr_threshold, bias_rate and bias_floor resolve cost
    aware (a host likelihood floors the target at 0.15 and turns the rate
    rule off), and explicit values win."""
    d = 25
    prior = tpc.Prior([tpc.Normal(0, 5) for _ in range(d)])

    def like_np(x):
        x = np.asarray(x)  # host-only: cannot trace
        return -0.5 * float(np.sum(x * x))

    def like_t(x):
        return -0.5 * (x * x).sum(-1)

    kw = dict(flow="maf3", device="cpu")
    s = tpc.Sampler(prior, like_np, **kw)
    assert s._corr_auto and not s.likelihood_traceable
    assert s.corr_threshold == 0.15
    assert s.bias_rate == 0.0 and s.bias_floor == 0.0
    s2 = tpc.Sampler(prior, like_t, vectorize=True, **kw)
    assert s2.likelihood_traceable
    assert s2.bias_rate == pytest.approx(0.4) and s2.corr_threshold == 0.15
    assert s2.bias_floor == pytest.approx(0.10)
    s2b = tpc.Sampler(prior, like_t, vectorize=True, bias_rate=0.0, **kw)
    assert s2b.corr_threshold == pytest.approx(0.5 * (10.0 / d) ** 2)
    s3 = tpc.Sampler(prior, like_np, corr_threshold=0.02, **kw)
    assert not s3._corr_auto and s3.corr_threshold == 0.02
    assert tpc.Sampler(prior, like_t, vectorize=True, bias_rate=1.5, **kw).bias_rate == 1.5
    assert tpc.Sampler(prior, like_t, vectorize=True, calib_z=0.0, **kw).bias_rate == 0.0
    s5 = tpc.Sampler(prior, like_t, vectorize=True, bias_floor=0.06, **kw)
    assert not s5._bias_floor_auto and s5.bias_floor == 0.06
    with pytest.raises(ValueError, match="bias_rate"):
        tpc.Sampler(prior, like_t, vectorize=True, bias_rate=-0.1, **kw)
    with pytest.raises(ValueError, match="bias_floor"):
        tpc.Sampler(prior, like_t, vectorize=True, bias_floor=1.5, **kw)


@pytest.mark.parametrize("flow", ["maf3", "nsfc3"])
def test_state_and_pickle_round_trip(flow):
    """A finished maf3 / nsfc3 run through ``state_dict`` ->
    ``load_state_dict`` into a sampler of another seed, and through
    ``pickle`` of the Sampler itself: the same posterior, evidence, flow
    parameters (the JAX layout in the state: nsfc's T lists of four
    layers) and log_prob, bit for bit."""
    s = tpc.Sampler(tpc.Prior([tpc.Normal(0, 5)] * 3), gaussian_loglike, vectorize=True,
                    random_state=0, n_effective=128, n_active=64, flow=flow,
                    train_config={"epochs": 10, "patience": 3}, device="cpu")
    s.run(n_total=256, n_evidence=256, progress=False)
    st = s.state_dict()
    stack = st["flow_params"]["stack"]
    if flow == "nsfc3":
        assert len(stack) == 3 and all(len(tp) == 4 for tp in stack)
        assert stack[1][0]["w"].shape == (1, 32)
    else:
        assert len(stack) == 4 and stack[3]["w"].shape == (3, 32, 3 * 2)
    pts = torch.from_numpy(np.random.default_rng(0).normal(0.0, 2.0, (32, 3)).astype(np.float32))
    back = tpc.Sampler(tpc.Prior([tpc.Normal(0, 5)] * 3), gaussian_loglike, vectorize=True,
                       random_state=5, n_effective=128, n_active=64, flow=flow, device="cpu")
    back.load_state_dict(pickle.loads(pickle.dumps(st)))
    again = pickle.loads(pickle.dumps(s))
    with torch.no_grad():
        lp = s.flow.log_prob(pts)
        for other in (back, again):
            assert other.evidence() == s.evidence()
            for a, b in zip(other.posterior(), s.posterior()):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(other.flow.parameters(), s.flow.parameters()):
                assert torch.equal(a, b)
            assert torch.equal(other.flow.log_prob(pts), lp)


@pytest.mark.parametrize("flow", ["nsfc3", "maf3"])
def test_state_from_jax(flow):
    """A JAX nsfc3 / maf3 run's state_dict carried into the port: the same
    posterior, the flow's log_prob on fixed points (1e-5), and the port
    extends the run."""
    prior_j = jpc.Prior([jpc.Normal(0, 3), jpc.Normal(0, 3)])
    sj = jpc.Sampler(prior_j, lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True,
                     random_state=0, n_effective=128, n_active=64, flow=flow,
                     train_config={"epochs": 20, "patience": 3})
    sj.run(n_total=256, n_evidence=256, progress=False)
    s = tpc.Sampler(tpc.Prior([tpc.Normal(0, 3), tpc.Normal(0, 3)]),
                    lambda x: -0.5 * (x * x).sum(-1), vectorize=True, random_state=1,
                    n_effective=128, n_active=64, flow=flow,
                    train_config={"epochs": 20, "patience": 3}, device="cpu")
    s.load_state_dict(state_from_jax(sj.state_dict()))
    assert (s.t, s.calls, s.logz) == (sj.t, sj.calls, sj.logz)
    for a, b in zip(s.posterior(), sj.posterior()):
        np.testing.assert_array_equal(a, np.asarray(b))
    pts = np.random.default_rng(0).normal(0.0, 1.0, (64, 2)).astype(np.float32)
    with torch.no_grad():
        lp = s.flow.log_prob(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(lp, np.asarray(sj.flow.log_prob(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    s.run(n_total=512, n_evidence=256, progress=False)
    assert s.t > sj.t and np.isfinite(s.logz)
