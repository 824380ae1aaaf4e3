"""The port's live per-step sweep statistics (``pocomc_tpu_torch.mcmc.
set_live_sink``; the JAX package's ``pocomc_tpu/mcmc.py:105-125``) on the
CPU.

- the sweep-level tap of ``tests/test_observability.py``: a sweep of
  ``steps`` steps emits exactly ``steps`` times with a monotone counter, and
  its last emission is the result's accept, sigma and calls; on ``Sweep.run``
  (tpcn and mala) and on ``Sweep.run_stepped``, whether the stopping rule or
  ``n_max`` ends it; the sink changes no bit of the sweep, and without one
  the sweep reads the device as often as it did before the tap existed;
- the sampler's black-box path: per-step progress-bar updates arrive from
  the stepped sweeps;
- ``progress=True`` against ``False``: the same logZ and calls on the device
  loop and on the host loop, one update a sweep step, none on a mesh, and
  the sink unregistered however the run ends.
"""

import numpy as np
import pytest
import torch

import pocomc_tpu_torch as tpc
from pocomc_tpu_torch import mcmc
from pocomc_tpu_torch.mcmc import Sweep, make_loglike, set_live_sink
from pocomc_tpu_torch.models.geometry import fit_geometry
from pocomc_tpu_torch.parallel import mesh as mesh_mod
from pocomc_tpu_torch.scaler import Reparameterize
from pocomc_tpu_torch.utils.tools import ProgressBar
from chip_smoke import AffineFlow

N_DIM, N = 2, 64
LIVE_KEYS = {"steps", "acc", "calls"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_like(x):
    return -0.5 * (x * x).sum(-1)


def np_like(x):
    return -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)


class HostReads:
    """Counts the tensor -> host reads a sweep makes (bool, int, float,
    item, tolist, numpy) while it is entered."""

    NAMES = ("__bool__", "__int__", "__float__", "item", "tolist", "numpy")

    def __enter__(self):
        self.n, self.orig = 0, {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def counted(fn):
            def wrapper(t, *a, **kw):
                self.n += 1
                return fn(t, *a, **kw)
            return wrapper

        for k, fn in self.orig.items():
            setattr(torch.Tensor, k, counted(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(torch.Tensor, k, fn)


def _sweep_problem(kind, n_max):
    """test_live_stats_tap_sweep_level's problem: d=2, n=64, N(0, 3)
    priors, the plain-space sweep with n_steps 2."""
    prior = tpc.Prior([tpc.Normal(0.0, 3.0) for _ in range(N_DIM)])
    scaler = Reparameterize(N_DIM, bounds=prior.bounds)
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(N, N_DIM)).astype(np.float32))
    scaler.fit(u.numpy().astype(np.float64))
    scp = scaler.whitening_params("cpu")
    x, ldj = scaler.inverse(u, params=scp)
    sweep = Sweep(scaler, lambda a: prior.logpdf(a).float(), make_loglike(t_like), None,
                  N_DIM, n_steps=2, n_max=n_max, kind=kind, preconditioned=False)
    args = (u, x, ldj, t_like(x), prior.logpdf(x).float(), 0.5, 1.68, fit_geometry(u), None,
            scp)
    return sweep, args


def _run(sweep, args, stepped, sink):
    """The sweep from its fixed start and generator seed 0, with ``sink``
    set (or none): (results, host reads, emissions)."""
    emitted = []
    set_live_sink((lambda *a: emitted.append(a)) if sink else None)
    gen = torch.Generator().manual_seed(0)
    try:
        with torch.no_grad(), HostReads() as reads:
            if stepped:
                res, _ = sweep.run_stepped(*args, gen,
                                           host_like=lambda xs: (np_like(xs), None))
            else:
                res = sweep.run(*args, gen)
    finally:
        set_live_sink(None)
    return res, reads.n, emitted


@pytest.mark.parametrize("kind,n_max,stepped", [
    ("tpcn", 6, False), ("tpcn", 20, False), ("tpcn", 2, False), ("mala", 6, False),
    ("mala", 2, False), ("tpcn", 6, True), ("tpcn", 20, True), ("tpcn", 2, True)])
def test_live_stats_tap_sweep_level(kind, n_max, stepped):
    """Exactly ``steps`` emissions with a monotone counter, the last one the
    result's accept, sigma and calls (exact: the float32 values and the
    counts ride in float64); the sweep's bits with and without the sink are
    the same; without a sink the sweep reads the device once a step but at
    ``n_max`` (and the stepped one at its start), and the sink adds a read
    only at ``n_max``. n_max=2 ends every sweep on the bound; tpcn runs to
    6 and mala to 2 when n_max allows (the stopping rule ends them)."""
    sweep, args = _sweep_problem(kind, n_max)
    bare, reads_bare, none = _run(sweep, args, stepped, sink=False)
    res, reads, emitted = _run(sweep, args, stepped, sink=True)
    steps = int(res["steps"])
    assert none == [] and steps >= 1
    assert len(emitted) == steps
    assert [e[0] for e in emitted] == list(range(1, steps + 1))
    assert emitted[-1][3] == float(res["accept"])
    assert emitted[-1][2] == float(res["proposal_scale"])
    assert emitted[-1][4] == int(res["calls"])
    assert all(isinstance(e[1], int) and isinstance(e[4], int) for e in emitted)
    assert [e[4] for e in emitted] == sorted(e[4] for e in emitted)
    for k, v in bare.items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(res[k])), k
    at_bound = steps == n_max
    if n_max == 2:
        assert at_bound
    if n_max == 20:
        assert not at_bound
    # the stepped sweep also reads its first proposal, at step 0
    assert reads_bare == steps + stepped - at_bound
    assert reads == reads_bare + at_bound


def test_sampler_live_stats_blackbox_path(monkeypatch):
    """test_sampler_live_stats_blackbox_path's run: a numpy likelihood
    (the host route, stepped sweeps), precondition=False, progress=True:
    one live update a sweep step."""
    live = []
    orig = ProgressBar.update_stats

    def spy(self, info):
        if set(info) == LIVE_KEYS:
            live.append(dict(info))
        return orig(self, info)

    monkeypatch.setattr(ProgressBar, "update_stats", spy)
    prior = tpc.Prior([tpc.Normal(0, 3), tpc.Normal(0, 3)])
    s = tpc.Sampler(prior, np_like, vectorize=True, random_state=0, n_effective=128,
                    n_active=64, precondition=False, device="cpu")
    assert not s.likelihood_traceable and s.likelihood_route == "host_batch"
    s.run(n_total=128, n_evidence=0, progress=True)
    steps_per_iter = s.particles.get("steps")
    mutate_steps = int(sum(st for st in steps_per_iter if st > 1))
    assert len(live) >= max(mutate_steps - 2, 2)
    assert max(u["steps"] for u in live) >= 2
    assert len(live) == sum(st["steps"] for st in s._iter_stats)
    assert mcmc._LIVE_SINK is None


def _count_live(monkeypatch):
    live = []
    orig = ProgressBar.update_stats

    def spy(self, info):
        if set(info) == LIVE_KEYS:
            live.append(dict(info))
        return orig(self, info)

    monkeypatch.setattr(ProgressBar, "update_stats", spy)
    return live


@pytest.mark.parametrize("device_loop", ["auto", False])
def test_progress_changes_no_bit(device_loop, monkeypatch):
    """progress=True against False on each loop (nsf3, d=2): the same logZ,
    error and calls; with progress one update a sweep step, each after the
    run's calls so far, and none without."""
    live = _count_live(monkeypatch)
    prior = tpc.Prior([tpc.Normal(0.0, 5.0)] * N_DIM)
    out = {}
    for progress in (False, True):
        live.clear()
        s = tpc.Sampler(prior, t_like, vectorize=True, random_state=0, n_effective=128,
                        n_active=64, flow="nsf3", train_config=dict(epochs=10, patience=3),
                        device_loop=device_loop, device="cpu")
        s.run(n_total=256, n_evidence=256, progress=progress)
        assert s._use_device_loop() == (device_loop == "auto")
        out[progress] = (s.logz, s.logz_err, s.calls)
        steps = sum(st["steps"] for st in s._iter_stats)
        assert len(live) == (steps if progress else 0)
        assert mcmc._LIVE_SINK is None
    assert out[True] == out[False]
    assert live[0]["steps"] == 1
    assert all(a["calls"] <= b["calls"] for a, b in zip(live, live[1:]))


def test_no_live_stats_on_a_mesh_and_the_sink_is_always_unregistered(monkeypatch):
    """On a one-rank mesh the tap stays off (as in the JAX package); a run
    that fails inside a loop leaves no sink behind."""
    live = _count_live(monkeypatch)
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tpc.initialize_distributed(f"localhost:{port}", 1, 0, platform="cpu")
    try:
        s = tpc.Sampler(tpc.Prior([tpc.Normal(0.0, 5.0)] * N_DIM), t_like, vectorize=True,
                        random_state=0, n_effective=128, n_active=64, precondition=False,
                        mesh=tpc.ParticleMesh(), device="cpu")
        s.run(n_total=128, n_evidence=0, progress=True)
    finally:
        torch.distributed.destroy_process_group()
        mesh_mod._LOCAL_DEVICE = None
    assert live == [] and sum(st["steps"] for st in s._iter_stats) > 0

    class FailingFit(AffineFlow):
        def fit(self, x, weights=None, **kwargs):
            assert mcmc._LIVE_SINK is not None  # registered around the loop
            raise RuntimeError("fit failed")

    s = tpc.Sampler(tpc.Prior([tpc.Normal(0.0, 5.0)] * N_DIM), t_like, vectorize=True,
                    random_state=0, n_effective=128, n_active=64, flow=FailingFit(N_DIM, "cpu"),
                    device="cpu")
    with pytest.raises(RuntimeError, match="fit failed"):
        s.run(n_total=128, n_evidence=128, progress=True)
    assert mcmc._LIVE_SINK is None
