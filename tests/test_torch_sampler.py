"""The PyTorch port's Sampler end to end on the CPU, its phase B training
rules, the checkpoint run options, and the paths it does not port yet."""

import math

import numpy as np
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch import phases
from pocomc_tpu_torch.models.flow import Flow

D = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauss_like(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[1] * math.log(2 * math.pi)


def prior():
    return tpc.Prior([tpc.Normal(0.0, 5.0) for _ in range(D)])


def small(**kw):
    return dict(vectorize=True, random_state=0, n_effective=128, n_active=64,
                flow="nsf3", train_config=dict(epochs=30, patience=3), device="cpu", **kw)


def test_known_answer_gaussian():
    """3-D unit Gaussian likelihood under an N(0, 5) prior: analytic logZ
    = 3 * log N(0; 0, 26), gated at +-0.5; a finite weighted posterior
    with the right moments."""
    s = tpc.Sampler(prior(), gauss_like, **small())
    s.run(n_total=1024, n_evidence=1024, progress=False)
    logz, dlogz = s.evidence()
    truth = D * norm.logpdf(0.0, 0.0, math.sqrt(26.0))
    assert abs(logz - truth) < 0.5, (logz, truth)
    assert np.isfinite(dlogz) and s.evidence_khat is not None
    assert s.evidence_proposal_used == "t"
    x, w, logl, logp = s.posterior()
    assert x.shape[1] == D and np.isfinite(x).all() and np.isclose(w.sum(), 1.0)
    mean = (w[:, None] * x).sum(0)
    var = (w[:, None] * (x - mean) ** 2).sum(0)
    assert np.all(np.abs(mean) < 0.3) and np.all(np.abs(var - 25 / 26) < 0.35)
    res = s.results
    assert res["beta"][-1] == 1.0 and len(res["logl"]) == s.particles.t
    # phase accounting covers the run
    assert all(v >= 0.0 for v in s.phase_seconds.values())
    assert s.phase_seconds["train"] > 0.0 and s.phase_seconds["mutate"] > 0.0


def test_khat_refinement_doubles_n_total(monkeypatch):
    """k-hat > 0.7 extends the run: n_total doubles, more beta = 1 stages
    are added, and the evidence is drawn again (here the tail diagnostic
    is forced high once)."""
    import pocomc_tpu_torch.sampler as smod
    khats = iter([0.9])
    stages = []
    real = smod.psislw

    def fake_psislw(logw):
        stages.append(s.particles.t)
        out, k = real(logw)
        return out, next(khats, k)

    monkeypatch.setattr(smod, "psislw", fake_psislw)
    s = tpc.Sampler(prior(), gauss_like, **small())
    s.run(n_total=512, n_evidence=512, progress=False)
    assert s.n_total == 1024 and s.evidence_khat < 0.7
    assert len(stages) == 2 and stages[1] > stages[0]
    assert s._iter_stats[-1]["beta"] == 1.0 and np.isfinite(s.logz)


def test_train_phase_fits_and_keeps_input_on_nonfinite_loss():
    """Phase B: a finite fit moves the flow, improves the weighted NLL and
    refits the geometry; a fit whose loss is never finite keeps the input
    parameters and pre-layer (the JAX package's rollback rule)."""
    g = torch.Generator().manual_seed(0)
    u = torch.randn(512, D, generator=g) * torch.tensor([1.0, 2.0, 0.5]) + 1.0
    u[:, 1] = u[:, 1] + 0.5 * u[:, 0] ** 2
    w = torch.rand(512, generator=g)
    w = w / w.sum()
    flow = Flow(D, "nsf3", device="cpu")
    with torch.no_grad():
        lp0 = (flow.log_prob(u) * w).sum()
    geom, stats = phases.train(flow, u, w, g, batch_size=128, epochs=20, patience=3)
    with torch.no_grad():
        lp1 = (flow.log_prob(u) * w).sum()
    assert float(lp1) > float(lp0) and math.isfinite(float(stats[1]))
    assert 1 <= int(stats[0]) <= 20
    assert set(geom) == {"normal_mean", "normal_cov", "normal_chol", "t_mean", "t_cov",
                         "t_nu", "t_chol", "t_inv_cov"}
    assert float(geom["t_nu"]) >= 1.0

    before = [p.detach().clone() for p in flow.parameters()]
    pre_before = {k: v.clone() for k, v in flow.get_pre().items()}
    bad = u.clone()
    bad[::2] = float("nan")
    _, stats = phases.train(flow, bad, w, g, batch_size=128, epochs=3, patience=3)
    assert not math.isfinite(float(stats[1]))
    assert all(torch.equal(a, b) for a, b in zip(before, flow.parameters()))
    assert all(torch.equal(pre_before[k], v) for k, v in flow.get_pre().items())


@pytest.mark.parametrize("kwargs,match", [
    (dict(bins=17), "bins > 16 on CUDA"),
    (dict(mesh="data"), "has no attribute"),
    (dict(mesh=object()), "has no attribute"),
])
def test_unported_paths_raise(kwargs, match):
    """The port lacks nothing of the JAX package's paths: spline bins past
    16 on CUDA (the case labelled "bins > 16 on CUDA", which raised until
    the library of run-time bins) pass the check that Flow(device="cuda")
    and the kernel wrappers call, held without a card, from 17 to 1000. A
    mesh that is not a ParticleMesh fails as in the JAX package, with an
    AttributeError at construction (JAX reads its ``multihost``, the port
    its ``device``)."""
    from pocomc_tpu_torch.ops.flow_kernels import check_bins
    if "bins" in kwargs:
        for bins in (kwargs["bins"], 32, 128, 1000):
            assert check_bins(bins) == bins
        return
    with pytest.raises(AttributeError, match=match):
        tpc.Sampler(prior(), gauss_like, **small(), **kwargs)
    with pytest.raises(AttributeError, match=match):
        jpc.Sampler(jpc.Prior([jpc.Normal(0.0, 5.0)] * D), gauss_like, vectorize=True,
                    n_active=64, n_effective=128, **kwargs)


def gauss_row(x):
    """Unit Gaussian on one row or a batch, numpy or torch."""
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[-1] * math.log(2 * math.pi)


@pytest.mark.parametrize("kwargs,route,device_loop", [
    (dict(vectorize=False), "device_vmap", True),
    (dict(vectorize=False, pool=2), "host_rows", False),
    (dict(train_config=dict(annealing=True)), "device", False),
])
def test_black_box_options_construct_and_route(kwargs, route, device_loop):
    """The options the black-box slice ported: a row-wise torch likelihood
    runs on the device through vmap; a process pool forces per-row host
    calls (here through two spawned workers); the host fit's annealing
    keeps the device likelihood but takes the host loop."""
    base = small()
    base.update(kwargs)
    s = tpc.Sampler(prior(), gauss_row, **base)
    try:
        assert s.likelihood_route == route
        assert s.likelihood_traceable == route.startswith("device")
        assert s._use_device_loop() == device_loop
        if "pool" in kwargs:
            assert s.pool._ctx.get_start_method() == "spawn"
            x = np.random.default_rng(0).standard_normal((5, D))
            logl, blobs = s._log_like(x)
            np.testing.assert_allclose(logl, gauss_row(x), rtol=1e-12)
            assert blobs is None
    finally:
        s.close()
    assert s.pool is None


def test_unported_run_options_raise():
    """run()'s own options are validated before a run, here on a mesh of
    one rank without a process group (every collective the identity),
    which then runs to the analytic gate."""
    s = tpc.Sampler(prior(), gauss_like, mesh=tpc.ParticleMesh(), **small())
    with pytest.raises(ValueError, match="save_every"):
        s.run(n_total=256, save_every=0, progress=False)
    assert s.t == 0 and s.calls == 0
    s.run(n_total=256, n_evidence=256, progress=False)
    assert abs(s.logz - D * norm.logpdf(0.0, 0.0, math.sqrt(26.0))) < 0.5


def test_checkpoint_run_options_construct_and_run(tmp_path):
    """The ported run options: save_every writes output_dir/{label}_{t}.state
    and the final state; a new sampler resumes from one and extends it."""
    s = tpc.Sampler(prior(), gauss_like, output_dir=str(tmp_path), output_label="q",
                    **small())
    s.run(n_total=256, n_evidence=256, save_every=3, progress=False)
    assert (tmp_path / "q_final.state").exists() and (tmp_path / "q_3.state").exists()
    s2 = tpc.Sampler(prior(), gauss_like, **{**small(), "random_state": 1})
    s2.run(n_total=512, n_evidence=256, resume_state_path=tmp_path / "q_final.state",
           progress=False)
    assert s2.t > s.t and np.isfinite(s2.logz)


def test_cuda_device_needs_a_card():
    """The default device is "cuda"; without one the constructor raises
    instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    kw = small()
    del kw["device"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpc.Sampler(prior(), gauss_like, **kw)
