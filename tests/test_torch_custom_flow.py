"""The preconditioner protocol of the port (``pocomc_tpu_torch.models.
protocol``; the JAX package's ``docs/flows.md`` "Custom flows") on the CPU:
``Sampler(flow=<any protocol object>)`` on both loops.

The custom flows are chip_smoke.py's (phase 16 drives them on the card).

- a protocol-minimal flow (``AffineFlow``, the torch translation of
  ``tests/test_observability.py``'s) takes the host loop, and
  ``device_loop=True`` raises; it meets the analytic logZ gate of
  ``test_custom_flow_protocol`` (within max(4 logz_err, 0.3)) as the JAX
  package's own ``AffineFlow`` does on the same problem; it round-trips
  pickling and ``save_every``/resume (bit for bit on the host loop);
- ``evidence_proposal`` resolves and raises as the JAX package's does;
- a plain object that forwards every member to a stock ``Flow``, device
  surface included, takes the device loop and repeats the stock flow's
  logZ and calls bit for bit; without the device surface it takes the host
  loop and meets the gate;
- mala runs through a custom ``kernel_inv`` and meets the gate;
- two gloo ranks run the custom flows with equal results.
"""

import math
import pickle
import types
import warnings

import numpy as np
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.models.protocol import DEVICE_SURFACE, device_ready
from chip_smoke import AffineFlow, DelegatingFlow, HostDelegatingFlow
from torch_mesh_ranks import custom_flow_run, run_ranks

# test_custom_flow_protocol's problem: 2-D unit Gaussian likelihood, N(0, 5)
# priors, n_effective 256, n_active 128, run(n_total=512, n_evidence=1024)
D = 2
TRUTH = D * norm.logpdf(0.0, 0.0, math.sqrt(26.0))
AFFINE = dict(vectorize=True, random_state=0, n_effective=256, n_active=128, device="cpu")
AFFINE_RUN = dict(n_total=512, n_evidence=1024, progress=False)
# the delegating flows' problem: the same Gaussian at d=4 with nsf3 at the
# tests' cut training
D4 = 4
TRUTH4 = D4 * norm.logpdf(0.0, 0.0, math.sqrt(26.0))
NSF3 = dict(vectorize=True, random_state=0, n_effective=128, n_active=64,
            train_config=dict(epochs=30, patience=3), device="cpu")
NSF3_RUN = dict(n_total=512, n_evidence=512, progress=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauss_like(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[1] * math.log(2 * math.pi)


def prior(d=D):
    return tpc.Prior([tpc.Normal(0.0, 5.0)] * d)


def gate(s, truth=TRUTH):
    """test_custom_flow_protocol's gate: logZ within max(4 logz_err, 0.3)."""
    assert s.logz == pytest.approx(truth, abs=max(4 * s.logz_err, 0.3)), (s.logz, s.logz_err)


def test_affine_flow_takes_the_host_loop():
    s = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), **AFFINE)
    assert not device_ready(s.flow) and not s._use_device_loop()
    with pytest.raises(ValueError, match="device_loop=True requires a flow"):
        tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), device_loop=True, **AFFINE)
    # the stock flow and the delegating one have the whole device surface
    assert device_ready(Flow(D, "nsf3", device="cpu"))
    assert device_ready(DelegatingFlow(Flow(D, "nsf3", device="cpu")))
    assert not any(hasattr(HostDelegatingFlow, a) for a in DEVICE_SURFACE)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_affine_flow_meets_the_gate_in_both_packages(package):
    """The same problem through each package's AffineFlow: the port's
    torch translation and the JAX test's own class."""
    if package == "jax":
        import pocomc_tpu as jpc
        from test_observability import AffineFlow as JaxAffineFlow, _gauss2_loglike
        s = jpc.Sampler(jpc.Prior([jpc.Normal(0, 5) for _ in range(D)]), _gauss2_loglike,
                        flow=JaxAffineFlow(D), precondition=True,
                        **{k: v for k, v in AFFINE.items() if k != "device"})
        assert not s._device_loop_ok
    else:
        s = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), **AFFINE)
        assert not s._use_device_loop()
    s.run(**AFFINE_RUN)
    gate(s)
    assert s.evidence_proposal_used == "flow"


def test_affine_flow_pickles_and_resumes(tmp_path):
    """Pickling keeps the object and its parameters; a sampler of another
    seed resumed from a state saved mid-run ends where the uninterrupted
    run ends (the host loop's checkpoints carry everything); the
    parameters go through the directory format too."""
    s = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), output_dir=tmp_path,
                    **AFFINE)
    s.run(save_every=3, **AFFINE_RUN)
    gate(s)
    s2 = pickle.loads(pickle.dumps(s))
    assert isinstance(s2.flow, AffineFlow)
    for k in ("mu", "log_sigma"):
        assert torch.equal(s2.flow.params[k], s.flow.params[k])
    x, w, _, _ = s2.posterior()
    assert np.isfinite(x).all() and np.isfinite(w).all()
    assert s2.evidence() == s.evidence()

    saved = sorted(tmp_path.glob("pmc_*.state"), key=lambda p: p.stat().st_mtime)
    mid = next(p for p in saved if p.stem not in ("pmc_final",) and int(p.stem[4:]) > 6)
    r = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"),
                    **{**AFFINE, "random_state": 7})
    r.run(resume_state_path=mid, **AFFINE_RUN)
    assert (r.logz, r.logz_err, r.calls, r.t) == (s.logz, s.logz_err, s.calls, s.t)
    for k in ("mu", "log_sigma"):
        assert torch.equal(r.flow.params[k], s.flow.params[k])

    s.save_state(tmp_path / "done.orbax")
    back = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), **AFFINE)
    back.load_state(tmp_path / "done.orbax")
    for k in ("mu", "log_sigma"):
        assert torch.equal(back.flow.params[k], s.flow.params[k])
    assert back.evidence() == s.evidence()


def _jax_resolution(flow_kind, proposal):
    """What the JAX sampler's ``_resolve_evidence_proposal`` gives for the
    JAX test's AffineFlow ("affine") or the stock flow ("stock")."""
    import pocomc_tpu as jpc
    from test_observability import AffineFlow as JaxAffineFlow, _gauss2_loglike
    s = jpc.Sampler(jpc.Prior([jpc.Normal(0, 5) for _ in range(D)]), _gauss2_loglike,
                    vectorize=True, n_effective=256, n_active=128, evidence_proposal=proposal,
                    flow=JaxAffineFlow(D) if flow_kind == "affine" else "nsf3")
    try:
        return s._resolve_evidence_proposal()
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("flow_kind,proposal,used", [
    ("affine", "auto", "flow"), ("affine", "flow", "flow"), ("affine", "t", ValueError),
    ("stock", "auto", "t"), ("stock", "flow", "flow"), ("stock", "t", "t"),
    # the t member without the latent draws: what ran was the flow proposal
    ("host_delegating", "auto", "flow"), ("host_delegating", "t", "flow"),
])
def test_evidence_proposal_resolves_as_jax(flow_kind, proposal, used):
    """'auto' takes the t proposal only with the flow's t member; an explicit
    't' without it raises at run time, with the JAX message; a flow with
    the t member and no latent draws records 'flow'. The first six against
    the JAX sampler's resolution of the same flows."""
    d = D
    flow = dict(affine=lambda: AffineFlow(d, "cpu"), stock=lambda: "nsf3",
                host_delegating=lambda: HostDelegatingFlow(Flow(d, "nsf3", device="cpu")))
    s = tpc.Sampler(prior(d), gauss_like, flow=flow[flow_kind](), evidence_proposal=proposal,
                    vectorize=True, random_state=0, n_effective=128, n_active=64,
                    train_config=dict(epochs=5, patience=2), device="cpu")
    if flow_kind != "host_delegating":
        assert _jax_resolution(flow_kind, proposal) == (
            used if used is ValueError else s._resolve_evidence_proposal())
    run = dict(n_total=128, n_evidence=256, progress=False)
    if used is ValueError:
        with pytest.raises(ValueError, match="evidence_proposal='t' requires the flow"):
            s.run(**run)
        return
    s.run(**run)
    assert s.evidence_proposal_used == used
    assert np.isfinite(s.logz)


def test_delegating_flow_repeats_the_stock_flow():
    """A plain object forwarding every member (device surface included) to
    a stock Flow built as the sampler builds one: the device loop, and the
    stock run's logZ, error, calls and posterior bit for bit."""
    stock = tpc.Sampler(prior(D4), gauss_like, flow="nsf3", **NSF3)
    stock.run(**NSF3_RUN)
    wrapped = DelegatingFlow(Flow(D4, "nsf3", device="cpu"))
    s = tpc.Sampler(prior(D4), gauss_like, flow=wrapped, **NSF3)
    assert s._use_device_loop() and not isinstance(s.flow, Flow)
    s.run(**NSF3_RUN)
    assert (s.logz, s.logz_err, s.calls, s.t) == (stock.logz, stock.logz_err, stock.calls,
                                                  stock.t)
    assert s.evidence_proposal_used == stock.evidence_proposal_used == "t"
    for a, b in zip(s.posterior(), stock.posterior()):
        np.testing.assert_array_equal(a, b)
    gate(s, TRUTH4)
    # the state_dict route of the checkpoint, and the whole object in a pickle
    back = pickle.loads(pickle.dumps(s))
    assert isinstance(back.flow, DelegatingFlow)
    for p, q in zip(back.flow.parameters(), s.flow.parameters()):
        assert torch.equal(p, q)
    other = tpc.Sampler(prior(D4), gauss_like,
                        flow=DelegatingFlow(Flow(D4, "nsf3", seed=3, device="cpu")), **NSF3)
    other.load_state_dict(s.state_dict())
    for p, q in zip(other.flow.parameters(), s.flow.parameters()):
        assert torch.equal(p, q)
    for k, v in s.flow.get_pre().items():
        assert torch.equal(other.flow.get_pre()[k], v)


def test_delegating_flow_without_device_surface_takes_the_host_loop():
    s = tpc.Sampler(prior(D4), gauss_like,
                    flow=HostDelegatingFlow(Flow(D4, "nsf3", device="cpu")), **NSF3)
    assert not s._use_device_loop()
    s.run(**NSF3_RUN)
    gate(s, TRUTH4)
    # the host fit ran through the held flow: it left its pre-layer
    assert not torch.equal(s.flow.inner.get_pre()["w_fwd"], torch.eye(D4))


class CountingAffineFlow(AffineFlow):
    """AffineFlow that counts the kernel_inv calls made with the gradient
    on (the gradient kinds' passes)."""

    grad_calls = 0

    def kernel_inv(self, theta, fp=None):
        if torch.is_grad_enabled() and theta.requires_grad:
            CountingAffineFlow.grad_calls += 1
        return super().kernel_inv(theta, fp)


def test_mala_runs_through_a_custom_kernel_inv():
    """sample='mala' differentiates the custom kernel_inv by autograd in
    theta (the sweep detaches the parameters) and meets the gate."""
    CountingAffineFlow.grad_calls = 0
    s = tpc.Sampler(prior(), gauss_like, flow=CountingAffineFlow(D, "cpu"), sample="mala",
                    **AFFINE)
    s.run(**AFFINE_RUN)
    gate(s)
    steps = sum(st["steps"] for st in s._iter_stats)
    # one gradient pass at each sweep's start and one a step
    assert CountingAffineFlow.grad_calls == steps + len(s._iter_stats)


class RaisingFit(AffineFlow):
    def fit(self, x, weights=None, **kwargs):
        raise RuntimeError("the custom fit failed")


def test_custom_flow_errors_surface():
    """A member that raises stops the run with its error (no other loop or
    route is tried), and a plain flow's tensors off the sampler's device
    raise at construction."""
    s = tpc.Sampler(prior(), gauss_like, flow=RaisingFit(D, "cpu"), **AFFINE)
    with pytest.raises(RuntimeError, match="the custom fit failed"):
        s.run(**AFFINE_RUN)
    with pytest.raises(ValueError, match="not on the sampler's device"):
        tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, device="meta"), **AFFINE)


def test_bridge_keeps_the_ladder_without_kernel_inv():
    """JAX's guard (sampler.py:2195): the bridge needs kernel_inv, and a flow
    without it keeps the ladder, with the port's RuntimeWarning."""
    s = tpc.Sampler(prior(), gauss_like, flow=AffineFlow(D, "cpu"), **AFFINE)
    s.flow = types.SimpleNamespace(params={})  # a flow without kernel_inv
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert s._compute_bridge_evidence() is None
    assert any("kernel_inv" in str(w.message) for w in caught
               if issubclass(w.category, RuntimeWarning))


def test_custom_flows_on_two_ranks():
    """Two gloo ranks: the protocol-minimal flow on the host loop (its
    parameters replicated from rank 0) and the delegating flow on the
    device loop; every rank holds the same results, each in the gate."""
    outs = run_ranks(2, custom_flow_run, timeout=150)
    for key in outs[0]:
        a, b = outs[0][key], outs[1][key]
        assert a["device_loop"] == b["device_loop"] and a["calls"] == b["calls"]
        assert a["logz"] == b["logz"], key
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["params"], b["params"])
    assert not outs[0]["affine"]["device_loop"] and outs[0]["delegating"]["device_loop"]
    assert abs(outs[0]["affine"]["logz"] - TRUTH) < max(4 * outs[0]["affine"]["logz_err"], 0.3)
    assert abs(outs[0]["delegating"]["logz"] - TRUTH) < 0.35
