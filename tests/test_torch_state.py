"""Checkpoints of the port's Sampler: the cases of tests/test_state.py on
the port (its directory format in place of orbax), a host-loop resume that
repeats the uninterrupted run bit for bit, a state that ``pickle`` loads
without torch, the torch generator's state, and a JAX state carried into
the port (``convert.state_from_jax``)."""

import math
import pickle
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.convert import state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loglike(x):
    return -0.5 * (x * x).sum(-1) - math.log(2 * math.pi)


def make_sampler(tmp_path, seed=0, **kw):
    prior = tpc.Prior([tpc.Normal(0, 5), tpc.Normal(0, 5)])
    return tpc.Sampler(prior, loglike, vectorize=True, random_state=seed,
                       n_effective=256, n_active=128, precondition=False,
                       output_dir=str(tmp_path), device="cpu", **kw)


def test_save_creates_file(tmp_path):
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    path = tmp_path / "pmc_test.state"
    s.save_state(path)
    assert path.exists()
    assert not list(tmp_path.glob("*.temp-*"))


def test_save_every_and_resume(tmp_path):
    s = make_sampler(tmp_path)
    s.run(n_total=512, n_evidence=0, progress=False, save_every=2)
    states = sorted(tmp_path.glob("pmc_*.state"))
    assert len(states) >= 2
    assert (tmp_path / "pmc_final.state").exists()
    t_done = s.t
    logz_done, _ = s.evidence()

    # resume from an intermediate state and finish the run
    intermediate = [p for p in states if "final" not in p.name][0]
    s2 = make_sampler(tmp_path, seed=1)
    s2.run(n_total=512, n_evidence=0, progress=False, resume_state_path=intermediate)
    assert s2.t >= t_done - 2
    logz2, _ = s2.evidence()
    assert abs(logz2 - logz_done) < 0.5


def test_state_roundtrip_preserves_history(tmp_path):
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    path = tmp_path / "pmc_rt.state"
    s.save_state(path)

    s2 = make_sampler(tmp_path, seed=2)
    s2.load_state(path)
    assert s2.t == s.t
    assert s2.calls == s.calls
    np.testing.assert_allclose(s2.particles.get("logl", flat=True),
                               s.particles.get("logl", flat=True))
    lz1 = s.particles.compute_logw_and_logz(1.0)[1]
    lz2 = s2.particles.compute_logw_and_logz(1.0)[1]
    assert lz1 == pytest.approx(lz2)


def test_extend_finished_run(tmp_path):
    """Resume a finished run with a larger n_total."""
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    path = tmp_path / "pmc_ext.state"
    s.save_state(path)
    t1 = s.t

    s2 = make_sampler(tmp_path, seed=3)
    s2.run(n_total=1024, n_evidence=0, progress=False, resume_state_path=path)
    assert s2.t >= t1
    logw, _ = s2.particles.compute_logw_and_logz(1.0)
    w = np.exp(logw - logw.max())
    assert tpc.effective_sample_size(w) >= 1024 * 0.9


def test_sampler_pickle_roundtrip(tmp_path):
    """Pickling the Sampler itself and continuing the run after
    unpickling: the generators, the flow, the scaler and the sweep are
    rebuilt on the sampler's device."""
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.t == s.t and s2.calls == s.calls
    assert torch.equal(s2._gen.get_state(), s._gen.get_state())
    lz1 = s.particles.compute_logw_and_logz(1.0)[1]
    lz2 = s2.particles.compute_logw_and_logz(1.0)[1]
    assert lz1 == pytest.approx(lz2)
    # a termination ESS the resumed history cannot reach: at least one
    # more iteration must run
    n_more = s.t * s.n_active + s.n_active
    s2.run(n_total=n_more, n_evidence=0, progress=False)
    assert s2.t > s.t


def _flow_sampler(seed):
    prior = tpc.Prior([tpc.Normal(0, 3), tpc.Normal(0, 3)])
    return tpc.Sampler(prior, lambda x: -0.5 * (x * x).sum(-1), vectorize=True,
                       random_state=seed, n_effective=128, n_active=64, flow="nsf3",
                       train_config={"epochs": 20, "patience": 3}, device="cpu")


def test_orbax_checkpoint_roundtrip(tmp_path):
    """'.orbax' paths select the port's directory format (``arrays/`` of
    .npy files and a JSON ``meta``); the state round-trips exactly,
    the 128-bit PCG64 state and the torch generator's included."""
    s = _flow_sampler(0)
    s.run(n_total=256, n_evidence=256, progress=False)
    p = tmp_path / "run.orbax"
    s.save_state(p)
    assert (p / "arrays").exists() and (p / "meta").exists()

    s2 = _flow_sampler(1)
    s2.load_state(p)
    assert s2.t == s.t and s2.calls == s.calls
    assert s2._rng.bit_generator.state == s._rng.bit_generator.state
    assert torch.equal(s2._gen.get_state(), s._gen.get_state())
    np.testing.assert_allclose(s2.particles.get("x"), s.particles.get("x"))
    x1, _, _, _ = s.posterior()
    x2, _, _, _ = s2.posterior()
    np.testing.assert_allclose(x1, x2)
    assert s2.evidence() == s.evidence()
    for k, v in s._geom.items():
        assert torch.equal(s2._geom[k], v)


def test_mid_warmup_resume_does_not_duplicate_batches(tmp_path):
    """A checkpoint taken mid-warmup resumes at the next batch, not batch
    0: replayed slots would double-count their beta=0 terms in the
    multiple-IS denominator."""
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    n_batches = s.n_prior // s.n_active
    betas = np.asarray(s.particles.get("beta"))
    assert int((betas == 0).sum()) == n_batches

    state = s.state_dict()
    state["particles_past"] = {k: v[:1] for k, v in state["particles_past"].items()}
    state["warmup"] = True
    state["t"] = 0
    state["calls"] = s.n_active

    s2 = make_sampler(tmp_path)
    s2.load_state_dict(state)
    s2.run(n_total=256, n_evidence=0, progress=False)
    betas2 = np.asarray(s2.particles.get("beta"))
    assert int((betas2 == 0).sum()) == n_batches


@pytest.mark.parametrize("route", ["device_likelihood", "host_prior"])
def test_host_loop_resume_repeats_run_bit_for_bit(tmp_path, route):
    """The host loop carries nothing outside the state: a run resumed
    from an intermediate save (mid-warmup and mid-loop, by a sampler of
    another seed) ends with the uninterrupted run's logZ, calls, posterior
    and generator states, bit for bit; saving does not move the run."""
    prior = tpc.Prior([tpc.Normal(0, 5)] * 3)
    if route == "host_prior":
        prior = tpc.Prior([tpc.Normal(0, 5)] * 2 + [_NumpyNormal(0.0, 5.0)])

    def make(seed):
        return tpc.Sampler(prior, loglike, vectorize=True, random_state=seed,
                           n_effective=128, n_active=64, flow="nsf3",
                           train_config=dict(epochs=30, patience=3), device="cpu",
                           device_loop=False, output_dir=str(tmp_path))

    a = make(0)
    a.run(n_total=512, n_evidence=512, progress=False, save_every=3)
    b = make(0)
    b.run(n_total=512, n_evidence=512, progress=False)
    assert (a.logz, a.logz_err, a.calls) == (b.logz, b.logz_err, b.calls)
    saves = sorted(tmp_path.glob("pmc_[0-9]*.state"), key=lambda p: int(p.stem[4:]))
    assert len(saves) >= 3
    for path in (saves[0], saves[len(saves) // 2]):
        c = make(7)
        c.run(n_total=512, n_evidence=512, progress=False, resume_state_path=path)
        assert (c.logz, c.logz_err, c.calls, c.t) == (a.logz, a.logz_err, a.calls, a.t)
        for u, v in zip(c.posterior(), a.posterior()):
            np.testing.assert_array_equal(u, v)
        assert torch.equal(c._gen.get_state(), a._gen.get_state())
        assert c._rng.bit_generator.state == a._rng.bit_generator.state


class _NumpyNormal:
    """A column scipy does not know: a host prior."""

    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        assert np.isfinite(x).all(), "the prior saw a non-finite row"
        return -0.5 * ((x - self.loc) / self.scale) ** 2 - np.log(
            self.scale * np.sqrt(2 * np.pi))

    def rvs(self, size=1, random_state=None):
        return self.loc + self.scale * np.random.default_rng(random_state).standard_normal(size)

    def support(self):
        return (-np.inf, np.inf)


def test_saved_state_loads_without_torch(tmp_path):
    """A saved state is plain Python and numpy: pickle loads it in a
    process where torch cannot be imported."""
    s = _flow_sampler(0)
    s.run(n_total=256, n_evidence=256, progress=False)
    path = tmp_path / "s.state"
    s.save_state(path)
    code = ("import pickle, sys; sys.modules['torch'] = None; "
            f"st = pickle.load(open({str(path)!r}, 'rb')); "
            "assert 'torch' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]; "
            "print(st['t'], st['torch_generator']['device'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(s.t), "cpu"]


def test_generator_of_another_device_reseeds_from_numpy(tmp_path):
    """A torch generator state of another device type cannot be loaded:
    the generator is reseeded from the restored numpy generator, which
    does not advance, with a warning; no saved state reseeds silently."""
    s = make_sampler(tmp_path)
    s.run(n_total=256, n_evidence=0, progress=False)
    state = s.state_dict()
    state["torch_generator"] = dict(device="cuda", state=np.zeros(16, np.uint8))
    s2 = make_sampler(tmp_path, seed=4)
    with pytest.warns(RuntimeWarning, match="reseeded"):
        s2.load_state_dict(state)
    assert s2._rng.bit_generator.state == s._rng.bit_generator.state
    first = s2._gen.get_state()
    state["torch_generator"] = None
    s3 = make_sampler(tmp_path, seed=5)
    s3.load_state_dict(state)
    assert torch.equal(s3._gen.get_state(), first)
    assert s3._rng.bit_generator.state == s._rng.bit_generator.state


def test_state_from_jax(tmp_path):
    """A JAX run's state_dict carried into the port: the same posterior,
    the same ladder logZ (1e-12) and, with the flow, the flow's log_prob
    on fixed points (1e-5); the port then extends the run."""
    prior_j = jpc.Prior([jpc.Normal(0, 3), jpc.Normal(0, 3)])
    sj = jpc.Sampler(prior_j, lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True,
                     random_state=0, n_effective=128, n_active=64, flow="nsf3",
                     train_config={"epochs": 20, "patience": 3})
    sj.run(n_total=256, n_evidence=256, progress=False)
    st = state_from_jax(sj.state_dict())
    s = _flow_sampler(1)
    s.load_state_dict(st)
    assert (s.t, s.calls, s.logz, s.logz_err) == (sj.t, sj.calls, sj.logz, sj.logz_err)
    for a, b in zip(s.posterior(), sj.posterior()):
        np.testing.assert_array_equal(a, np.asarray(b))
    lz = float(s.particles.compute_logw_and_logz(1.0)[1])
    lz_j = float(sj.particles.compute_logw_and_logz(1.0)[1])
    assert abs(lz - lz_j) < 1e-12
    pts = np.random.default_rng(0).normal(0.0, 1.0, (64, 2)).astype(np.float32)
    with torch.no_grad():
        lp = s.flow.log_prob(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(lp, np.asarray(sj.flow.log_prob(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    for k in ("t_mean", "t_chol", "t_nu"):
        np.testing.assert_allclose(s._geom[k].numpy(),
                                   np.asarray(getattr(sj.theta_geometry, k)), rtol=1e-6)
    s.run(n_total=512, n_evidence=256, progress=False)
    assert s.t > sj.t and np.isfinite(s.logz)
