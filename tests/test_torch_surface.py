"""The reference surface of Particles and Flow against the JAX package:
``Particles.pop`` with the MIS cache's rebuild, and ``Flow``'s positional
order, ``fit``'s ``epoch_chunk`` and ``mesh`` and ``sample``'s default
size, each on the same numpy inputs in both packages."""

import numpy as np
import pytest
import torch

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu.ops.weights import compute_logw_and_logz


def _direct(p, beta_final=1.0):
    logl = np.stack([np.asarray(v, dtype=np.float64) for v in p.past["logl"]])
    return compute_logw_and_logz(logl, np.asarray(p.past["beta"], np.float64),
                                 np.asarray(p.past["logz"], np.float64), beta_final)


@pytest.mark.parametrize("edit", ["rollback", "rollback_then_append", "logz_edit"])
def test_particles_pop_rebuilds_the_mis_cache(edit):
    """tests/test_ops.py's rollback and retroactive logz edit, in both
    packages on the same history: after each, compute_logw_and_logz equals
    the direct sum (1e-12) and the JAX class's result (1e-12)."""
    rng = np.random.default_rng(8)
    n = 32
    rows = [(rng.normal(-30, 5, n), 0.15 * (t + 1), -0.4 * t) for t in range(6)]
    extra = (rng.normal(-28, 5, n), 0.8, -2.0)
    results = []
    for mod in (tpc, jpc):
        p = mod.Particles(n, 3)
        for logl, beta, logz in rows:
            p.update({"logl": logl.copy(), "beta": beta, "logz": logz})
        p.compute_logw_and_logz(1.0)  # fill the cache at T=6
        if edit.startswith("rollback"):
            for k in ("logl", "beta", "logz"):
                p.pop(k)
            assert p.t == 5 and len(p.past["logl"]) == 5
            if edit == "rollback_then_append":
                p.update({"logl": extra[0].copy(), "beta": extra[1], "logz": extra[2]})
        else:
            p.past["logz"][0] = -3.0
        lw, lz = p.compute_logw_and_logz(1.0)
        lw_d, lz_d = _direct(p)
        np.testing.assert_allclose(lw, lw_d, atol=1e-12)
        assert abs(lz - lz_d) < 1e-12
        results.append((lw, lz))
    np.testing.assert_allclose(results[0][0], results[1][0], atol=1e-12)
    assert abs(results[0][1] - results[1][1]) < 1e-12


def test_flow_positional_order_keeps_whitening():
    """Flow(d, "nsf6", 8, 0, False): the fifth positional is use_pallas in
    both packages, so whitening stays on; the two use_pallas flags are
    accepted and ignored, and whiten is the seventh positional."""
    for flow in (jpc.Flow(3, "nsf6", 8, 0, False),
                 tpc.Flow(3, "nsf6", 8, 0, False, device="cpu")):
        assert flow.whiten and flow.whiten_mode == "full"
    for flow in (jpc.Flow(3, "nsf3", 8, 0, True, False, "diag"),
                 tpc.Flow(3, "nsf3", 8, 0, True, False, "diag", device="cpu")):
        assert flow.whiten and flow.whiten_mode == "diag"
    f = tpc.Flow(3, "nsf3", use_pallas=True, use_pallas_inverse=False, whiten=False,
                 device="cpu")
    assert not f.whiten
    with pytest.raises(TypeError):
        tpc.Flow(3, "nsf3", 8, 0, "auto", "auto", True, "cpu")


def _fit_rows(d=2, n=64):
    return np.random.default_rng(3).normal(0.0, 1.0, (n, d)).astype(np.float32)


@pytest.mark.parametrize("chunk", [0, 3, "auto"])
def test_fit_epoch_chunk_is_checked_and_runs(chunk):
    """fit(epoch_chunk=0 / 3 / "auto") trains in both packages (JAX takes
    max(1, int(chunk)); the port checks the same way and ignores it); the
    history holds one finite loss an epoch in the port."""
    x = _fit_rows()
    kw = dict(epochs=2, batch_size=32, patience=5, epoch_chunk=chunk, seed=0)
    hj = jpc.Flow(2, "nsf3").fit(x, **kw)
    ht = tpc.Flow(2, "nsf3", device="cpu").fit(x, **kw)
    assert len(hj["loss"]) >= 1 and len(ht["loss"]) == 2
    assert np.isfinite(ht["loss"]).all()


def test_fit_rejects_what_jax_rejects_and_a_mesh():
    """A non-integer epoch_chunk raises ValueError in both packages before
    training; a mesh whose device is not the flow's raises ValueError, and
    a one-rank mesh (no process group) fits as the meshless fit does, bit
    for bit."""
    x = _fit_rows()
    for flow in (jpc.Flow(2, "nsf3"), tpc.Flow(2, "nsf3", device="cpu")):
        with pytest.raises(ValueError):
            flow.fit(x, epochs=1, epoch_chunk="many")
    with pytest.raises(ValueError, match="mesh device"):
        tpc.Flow(2, "nsf3", device="cpu").fit(x, epochs=1,
                                              mesh=tpc.ParticleMesh(devices=["meta"]))
    kw = dict(epochs=2, batch_size=32, patience=5, seed=0)
    a, b = tpc.Flow(2, "nsf3", device="cpu"), tpc.Flow(2, "nsf3", device="cpu")
    assert a.fit(x, **kw) == b.fit(x, mesh=tpc.ParticleMesh(), **kw)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_sample_defaults_to_one_draw():
    """sample() with no size gives one draw, (1, d) and (1,), as JAX's."""
    xj, lj = jpc.Flow(3, "nsf3").sample()
    xt, lt = tpc.Flow(3, "nsf3", device="cpu").sample()
    assert tuple(xj.shape) == tuple(xt.shape) == (1, 3)
    assert tuple(lj.shape) == tuple(lt.shape) == (1,)
    assert torch.isfinite(xt).all() and torch.isfinite(lt).all()
