"""``Flow(bins=)`` on the port, on the CPU: a maf flow keeps bins and
ignores them, a sampler's state with a 16-bin spline flow round-trips
through ``save_state``/``load_state`` and ``pickle``, and a JAX run whose
flow has 16 or 32 bins carries into the port (``convert.state_from_jax``;
past 16 bins its flow's log_prob is held to float64).
The flows' values and gradients at 2-64 bins against the JAX package are
in ``tests/test_torch_flow_menu.py`` and ``tests/test_torch_gradient.py``;
the launch plans past 16 bins in ``tests/test_torch_bins_wide.py``; the
kernels at 2-1000 bins in ``tests/test_torch_gpu.py`` (marked ``gpu``).

Run as a script, ``python tests/test_torch_bins.py 16 [seed]`` (or 32)
runs the JAX package's quickstart with ``flow=Flow(10, "nsf6", bins=16)``
on the CPU (``JAX_PLATFORMS=cpu``, seed 0 unless given) and prints its
logZ, calls and wall: the reference for the port's quickstart with such a
flow.
"""

import math
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu.models.flow import Flow as JFlow
from pocomc_tpu_torch.convert import state_from_jax
from pocomc_tpu_torch.models import transforms as ttr
from pocomc_tpu_torch.models.flow import Flow

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import spline_parity  # noqa: E402  (the float64 routes of both packages)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gaussian_loglike(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[-1] * math.log(2 * math.pi)


def test_maf_ignores_bins():
    """maf6 at 12 bins is maf6 at 8: the same parameters and buffers, and
    the same forward and inverse bit for bit; the flow keeps its bins."""
    a, b = Flow(5, "maf6", bins=8, seed=3, device="cpu"), Flow(5, "maf6", bins=12, seed=3,
                                                               device="cpu")
    assert (a.bins, b.bins, a.n_params, b.n_params) == (8, 12, 2, 2)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in b.weights[3:]:
            p.copy_(torch.from_numpy(0.05 * rng.standard_normal(tuple(p.shape))))
        a.weights[3].copy_(b.weights[3])
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    z = torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32))
    with torch.no_grad():
        for fa, fb in ((a.forward(z), b.forward(z)), (a.inverse(z), b.inverse(z))):
            assert all(torch.equal(u, v) for u, v in zip(fa, fb))


def small_sampler(flow, seed=0):
    return tpc.Sampler(tpc.Prior([tpc.Normal(0, 3)] * 2), gaussian_loglike, vectorize=True,
                       random_state=seed, n_effective=128, n_active=64, flow=flow,
                       train_config=dict(epochs=10, patience=3), device="cpu")


def test_state_round_trip_with_16_bins(tmp_path):
    """A run with ``Flow(2, "nsf3", bins=16)`` through ``save_state`` ->
    ``load_state`` into a sampler of another seed with such a flow, and
    through ``pickle`` of the Sampler (which rebuilds the flow from the
    state's ``_flow_config``, bins included): the same posterior,
    evidence, flow parameters and log_prob, bit for bit."""
    s = small_sampler(Flow(2, "nsf3", bins=16, device="cpu"))
    s.run(n_total=256, n_evidence=256, progress=False)
    assert s.flow.weights[3].shape[-1] == 2 * 47
    path = tmp_path / "bins16.state"
    s.save_state(path)
    back = small_sampler(Flow(2, "nsf3", bins=16, device="cpu"), seed=5)
    back.load_state(path)
    again = pickle.loads(pickle.dumps(s))
    pts = torch.from_numpy(np.random.default_rng(0).normal(0.0, 2.0, (32, 2)).astype(np.float32))
    with torch.no_grad():
        lp = s.flow.log_prob(pts)
        for other in (back, again):
            assert other.flow.bins == 16
            assert other.evidence() == s.evidence()
            for a, b in zip(other.posterior(), s.posterior()):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(other.flow.parameters(), s.flow.parameters()):
                assert torch.equal(a, b)
            assert torch.equal(other.flow.log_prob(pts), lp)


def _state_from_jax(arch, bins):
    """A JAX run whose flow has ``bins`` bins carried into the port's
    sampler with such a flow: the same posterior, the flow's log_prob on
    fixed points (1e-5), and the port extends the run. Past
    ``COMPENSATED_PAST`` bins the log_prob is held to float64 (the port's
    plain route in float64, which the JAX package's float64 route repeats
    to 1e-12 on these weights) in place of the JAX package's fp32 route:
    on the trained nsfc3 of 32 bins that one lies 3.05e-5 from float64,
    1.14 times the tolerance, the port's 1.37e-5, 0.11 times it
    (``tools/spline_parity.py``)."""
    sj = jpc.Sampler(jpc.Prior([jpc.Normal(0, 3), jpc.Normal(0, 3)]),
                     lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True,
                     random_state=0, n_effective=128, n_active=64,
                     flow=JFlow(2, arch, bins=bins), train_config={"epochs": 20, "patience": 3})
    sj.run(n_total=256, n_evidence=256, progress=False)
    s = small_sampler(Flow(2, arch, bins=bins, device="cpu"), seed=1)
    assert s.flow.weights[3].shape[-1] % (3 * bins - 1) == 0
    s.load_state_dict(state_from_jax(sj.state_dict()))
    assert (s.t, s.calls, s.logz) == (sj.t, sj.calls, sj.logz)
    for a, b in zip(s.posterior(), sj.posterior()):
        np.testing.assert_array_equal(a, np.asarray(b))
    pts = np.random.default_rng(0).normal(0.0, 1.0, (64, 2)).astype(np.float32)
    with torch.no_grad():
        lp = s.flow.log_prob(torch.from_numpy(pts)).numpy()
    if bins > ttr.COMPENSATED_PAST:
        params = jax.tree_util.tree_map(np.array, jax.device_get(sj.flow.params))
        case = [("trained", arch, 2, bins, params, pts)]
        ref = [spline_parity.torch_outputs(arch, 2, bins, params, pts, True)]
        diffs = spline_parity.jax_float64(case, ref)["trained"]
        assert max(diffs.values()) < 1e-12, diffs
        want = ref[0][4]
    else:
        want = np.asarray(sj.flow.log_prob(jnp.asarray(pts)))
    np.testing.assert_allclose(lp, want, rtol=1e-5, atol=1e-5)
    s.run(n_total=512, n_evidence=256, progress=False)
    assert s.t > sj.t and np.isfinite(s.logz)


@pytest.mark.parametrize("arch", ["nsf3", "nsfc3"])
def test_state_from_jax_with_16_bins(arch):
    """``_state_from_jax`` with 16 bins, the most of a compiled library."""
    _state_from_jax(arch, 16)


def test_state_from_jax_with_32_bins():
    """``_state_from_jax`` with 32 bins, which the card runs on the library
    of run-time bins, on nsf3 and nsfc3."""
    for arch in ("nsf3", "nsfc3"):
        _state_from_jax(arch, 32)


def jax_quickstart(bins, seed=0):
    """The 10-D Rosenbrock quickstart (N(0, 3) prior, every setting at its
    default) with an nsf6 flow of ``bins`` bins, on the JAX package at
    ``random_state=seed``: (logz, dlogz, calls, iterations, wall seconds).
    ``tools/parity_runs.py --runs quickstart32`` runs it on both packages
    and records k-hat, refinement rounds and epochs as well."""
    def log_like(x):
        return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                        + (x[..., ::2] - 1.0) ** 2, axis=-1)

    prior = jpc.Prior([jpc.Normal(0.0, 3.0) for _ in range(10)])
    s = jpc.Sampler(prior, log_like, vectorize=True, random_state=seed,
                    flow=JFlow(10, "nsf6", bins=bins))
    t0 = time.perf_counter()
    s.run(n_total=4096, n_evidence=4096, progress=False)
    logz, dlogz = s.evidence()
    return float(logz), float(dlogz), int(s.calls), int(s.t), time.perf_counter() - t0


if __name__ == "__main__":
    import jax
    b, seed = int(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) > 2 else 0
    logz, dlogz, calls, iters, wall = jax_quickstart(b, seed)
    print(f"jax quickstart, nsf6 with {b} bins, seed {seed}: logz {logz:.4f} +- {dlogz:.4f} "
          f"calls {calls} iterations {iters} wall {wall:.1f} s on {jax.devices()[0].platform}",
          flush=True)
