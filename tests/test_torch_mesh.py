"""The port's particle mesh (``pocomc_tpu_torch.parallel.mesh``) on the CPU
over gloo: ``ParticleMesh``'s surface at 2 and 3 ranks; a one-rank mesh in
this process repeats the meshless runs bit for bit; the sweep and
``Flow.fit`` on 2 ranks match 1 rank within a stated float32 tolerance,
and the ranks agree bit for bit; the JAX mesh tests' analytic gates
(``tests/test_parallel.py``) on 4 and 2 ranks; and the JAX package's own
sharded run on its 8 CPU devices beside the port's 2-rank run at seeds
0-2 (threefry against Philox: held by the same gate, not by bits).

Multi-rank bodies run in spawned processes (``torch_mesh_ranks.run_ranks``),
each call with its own time limit.
"""

import math

import numpy as np
import pytest
import torch
from scipy.stats import norm

import pocomc_tpu as jpc
import pocomc_tpu_torch as tpc
from pocomc_tpu_torch.parallel import mesh as mesh_mod
from torch_mesh_ranks import (bridge_off, fit_run, gauss_like, mesh_surface, run_ranks,
                              sampler_run, sweep_run)

ANALYTIC_2D = 2 * norm.logpdf(0.0, 0.0, math.sqrt(26.0))
# 1 rank against 2: every sum over the particles is two block sums added
# in float32, so the sweep's adaptation (sigma, the t mean) and the fit's
# gradients move in their last bits, and so do the states after them
SWEEP_TOL = dict(rtol=1e-5, atol=5e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank():
    """A one-rank gloo process group in this process, and its mesh."""
    rank, world = tpc.initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                                             platform="cpu")
    assert (rank, world) == (0, 1)
    try:
        yield tpc.ParticleMesh()
    finally:
        torch.distributed.destroy_process_group()
        mesh_mod._LOCAL_DEVICE = None


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_surface(k):
    """size, pad_to_multiple, row blocks, the gather that undoes them, the
    history and batch splits, the fallback on 13 rows, replicate from rank
    0, and JAX's test_n_active_divisibility (n_active 100 on 3 ranks)."""
    outs = run_ranks(k, mesh_surface, timeout=60)
    a = np.arange(4 * k * 3, dtype=np.float32).reshape(4 * k, 3)
    for r, o in enumerate(outs):
        assert o["size"] == k and o["multihost"] and o["rank"] == r
        assert o["pad13"] == (14 if k == 2 else 15)
        np.testing.assert_array_equal(o["block"], a[4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["gathered"], a)
        assert o["hist_u"] == (5, 4, 3) and o["hist_beta"] == (5,)
        assert o["batches"] == (2, 4)
        assert o["odd_rows"] == 13 and o["fallbacks"] == 1
        np.testing.assert_array_equal(o["replicated"], [0.0, 0.0])
        if k == 3:
            assert "divisible by the mesh size (3)" in o["n_active_100"]
        else:
            assert o["n_active_100"] is None


def test_replicate_broadcasts_contiguous_tensors(one_rank, monkeypatch):
    """Every tensor ``replicate`` hands to ``broadcast`` is contiguous (NCCL
    sends no other; gloo takes any), as for the stock flow's MADE masks,
    which are transposed views: the flow's tensors come back unchanged."""
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.models.protocol import replicate_flow
    sent = []
    broadcast = torch.distributed.broadcast

    def checked(t, *a, **kw):
        sent.append(t.is_contiguous())
        return broadcast(t, *a, **kw)

    monkeypatch.setattr(torch.distributed, "broadcast", checked)
    flow = Flow(4, "nsf3", device="cpu")
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    assert not all(v.is_contiguous() for v in before.values())
    replicate_flow(flow, one_rank)
    assert sent and all(sent)
    for k, v in flow.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mesh_without_a_group_is_one_rank():
    """Without a process group a ParticleMesh is one rank on this process's
    device and every collective is the identity; initialize_distributed
    refuses more than one device a process, and a mesh device that is not
    the sampler's or the flow's raises."""
    import inspect
    assert (inspect.signature(tpc.initialize_distributed).parameters.keys()
            == inspect.signature(jpc.initialize_distributed).parameters.keys())
    m = tpc.ParticleMesh()
    assert m.size == 1 and not m.multihost and m.device.type == "cpu"
    a = np.arange(6.0)
    assert np.array_equal(m.gather(m.shard_particles(a)), a)
    with pytest.raises(ValueError, match="local_device_count"):
        tpc.initialize_distributed("localhost:1", 1, 0, local_device_count=2, platform="cpu")
    with pytest.raises(ValueError, match="one device a rank"):
        tpc.ParticleMesh(devices=["cpu", "cpu"])
    meta = tpc.ParticleMesh(devices=["meta"])
    with pytest.raises(ValueError, match="mesh device"):
        tpc.Sampler(tpc.Prior([tpc.Normal(0, 5)] * 2), gauss_like, vectorize=True,
                    mesh=meta, device="cpu")
    with pytest.raises(ValueError, match="mesh device"):
        tpc.Flow(2, "nsf3", device="cpu").fit(np.zeros((8, 2), np.float32), epochs=1,
                                              mesh=meta)


ONE_RANK_CASES = {
    "device_loop": (dict(vectorize=True, flow="nsf3"), dict(n_total=256, n_evidence=256)),
    "host_loop_blobs": (dict(flow="nsf3", blobs_dtype=np.float64),
                        dict(n_total=256, n_evidence=256)),
    "mala": (dict(vectorize=True, flow="nsf3", sample="mala"),
             dict(n_total=256, n_evidence=256)),
    "bridge": (dict(vectorize=True, flow="nsf3"), dict(n_total=256, n_evidence=0)),
    "flow_free": (dict(vectorize=True, precondition=False), dict(n_total=256, n_evidence=0)),
}


@pytest.mark.parametrize("case", list(ONE_RANK_CASES))
def test_one_rank_mesh_repeats_the_meshless_run(case, one_rank):
    """A one-rank mesh (every collective an all_reduce over one rank)
    repeats the meshless run's logZ, calls and posterior bit for bit: the
    device loop, the host loop with blobs, mala, the bridge and no flow."""
    kw, run_kw = ONE_RANK_CASES[case]
    base = dict(random_state=0, n_effective=128, n_active=64,
                train_config=dict(epochs=20, patience=3), **kw)
    like = "row" if "blobs_dtype" in kw else "gauss"
    a = sampler_run(None, dict(base), run_kw, like)
    b = sampler_run(one_rank, dict(base), run_kw, like)
    assert (a["logz"], a["logz_err"], a["calls"], a["t"]) == (
        b["logz"], b["logz_err"], b["calls"], b["t"])
    for key in ("x", "w") + (("blobs",) if like == "row" else ()):
        np.testing.assert_array_equal(a[key], b[key])
    assert abs(a["logz"] - ANALYTIC_2D) < 0.5


def test_mesh_sampler_pickles_and_checkpoints(one_rank, tmp_path):
    """A sampler on a mesh pickles without it (JAX drops the mesh too) and
    save_state on rank 0 writes a state a meshless sampler loads."""
    import pickle
    s = tpc.Sampler(tpc.Prior([tpc.Normal(0, 5)] * 2), gauss_like, vectorize=True,
                    random_state=0, n_effective=128, n_active=64, precondition=False,
                    mesh=one_rank, device="cpu")
    s.run(n_total=128, n_evidence=0, progress=False)
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.mesh is None and s2.logz == s.logz
    s.save_state(tmp_path / "m.state")
    s3 = tpc.Sampler(tpc.Prior([tpc.Normal(0, 5)] * 2), gauss_like, vectorize=True,
                     random_state=1, n_effective=128, n_active=64, precondition=False,
                     device="cpu")
    s3.load_state(tmp_path / "m.state")
    np.testing.assert_array_equal(s3.posterior()[0], s.posterior()[0])


def test_sweep_on_two_ranks_matches_one():
    """The preconditioned t-pCN sweep (nsf3, d=4, n=128, 8 steps, one state
    and one generator seed) on 2 ranks against the meshless sweep: u, x and
    logl within SWEEP_TOL, every step's accept mask equal, the mean
    acceptance within 1e-6, and both ranks' gathered results bit-equal."""
    ref = sweep_run(None)
    outs = run_ranks(2, sweep_run, timeout=90)
    for key in ("u", "x", "logl", "masks", "accepts"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    got = outs[0]
    assert got["steps"] == ref["steps"] == 8 and got["calls"] == ref["calls"]
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_allclose(got["accepts"], ref["accepts"], rtol=0, atol=1e-6)
    for key in ("u", "x", "logl"):
        np.testing.assert_allclose(got[key], ref[key], **SWEEP_TOL)
    # two all_reduce rounds a step, and those of the start and the exit
    assert got["collectives"] <= 2 * got["steps"] + 4 and ref["collectives"] == 0


def test_fit_on_two_ranks_matches_one():
    """Flow.fit(mesh=) on 2 ranks (every batch split, the gradient summed
    before the clip) against the meshless fit of the same rows, seed and 3
    epochs: parameters within FIT_TOL and bit-equal across the ranks; the
    loss histories agree to float32."""
    ref = fit_run(None)
    outs = run_ranks(2, fit_run, timeout=90)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[0]["params"], ref["params"]):
        np.testing.assert_allclose(a, b, **FIT_TOL)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(outs[0][key], ref[key], rtol=1e-5)
    for k, v in ref["pre"].items():
        np.testing.assert_array_equal(outs[0]["pre"][k], v)


def test_sharded_run_matches_analytic_on_four_ranks():
    """tests/test_parallel.py's analytic run (precondition=False, n_active
    128, |dlogZ| < 0.3) on 4 ranks, every rank the same bits."""
    kw = dict(vectorize=True, random_state=0, n_effective=256, n_active=128,
              precondition=False)
    outs = run_ranks(4, sampler_run, kw, dict(n_total=512, n_evidence=0), timeout=150)
    assert len({(o["logz"], o["calls"]) for o in outs}) == 1
    assert abs(outs[0]["logz"] - ANALYTIC_2D) < 0.3


def test_host_loop_with_blobs_on_two_ranks():
    """The black-box path on 2 ranks: a per-row numpy likelihood with a blob,
    the stepped sweep on each rank's rows and the blobs gathered in rank
    order (broadcast_object_list): both ranks hold the same results, each
    blob is its row's sum, and logZ meets the analytic gate."""
    kw = dict(random_state=0, n_effective=128, n_active=64, flow="nsf3",
              blobs_dtype=np.float64, train_config=dict(epochs=20, patience=3))
    outs = run_ranks(2, sampler_run, kw, dict(n_total=256, n_evidence=256), "row",
                     timeout=120)
    for key in ("x", "w", "blobs"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    np.testing.assert_allclose(outs[0]["blobs"], outs[0]["x"].sum(1), rtol=1e-12)
    assert outs[0]["logz"] == outs[1]["logz"]
    assert abs(outs[0]["logz"] - ANALYTIC_2D) < 0.5


def test_bridge_is_off_on_two_ranks():
    """run(n_evidence=0) with the flow on 2 ranks keeps the recorrected
    ladder (no error bar) and warns that the bridge does not run there, as
    the JAX package's multi-process mesh skips it."""
    outs = run_ranks(2, bridge_off, timeout=90)
    assert outs[0][:2] == outs[1][:2] and outs[0][1] is None
    assert any("does not run on a mesh" in w for w in outs[0][2])
    assert abs(outs[0][0] - ANALYTIC_2D) < 0.5


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_sharded_gradient_kernels_on_two_ranks(kind):
    """tests/test_parallel.py's mala/hmc runs (nsf3, n_leapfrog 2, 40 epochs,
    |dlogZ| < 0.4) on 2 ranks."""
    kw = dict(vectorize=True, random_state=0, n_effective=256, n_active=128, sample=kind,
              flow="nsf3", n_leapfrog=2, train_config={"epochs": 40, "patience": 5})
    outs = run_ranks(2, sampler_run, kw, dict(n_total=512, n_evidence=512), timeout=150)
    assert outs[0]["logz"] == outs[1]["logz"] and outs[0]["calls"] == outs[1]["calls"]
    assert abs(outs[0]["logz"] - ANALYTIC_2D) < 0.4


def test_two_ranks_and_the_jax_mesh_meet_the_same_gate():
    """The JAX package's sharded analytic run on its 8 CPU devices and the
    port's on 2 ranks, seeds 0-2, both within tests/test_parallel.py's
    0.3 of the analytic logZ."""
    import jax
    jmesh = jpc.ParticleMesh(jax.devices()[:8])

    def jlike(x):
        import jax.numpy as jnp
        return -0.5 * jnp.sum(x ** 2, axis=-1) - jnp.log(2 * jnp.pi)

    kw = dict(vectorize=True, n_effective=256, n_active=128, precondition=False)
    for seed in range(3):
        s = jpc.Sampler(jpc.Prior([jpc.Normal(0, 5), jpc.Normal(0, 5)]), jlike,
                        random_state=seed, mesh=jmesh, **kw)
        s.run(n_total=512, n_evidence=0, progress=False)
        outs = run_ranks(2, sampler_run, dict(random_state=seed, **kw),
                         dict(n_total=512, n_evidence=0), timeout=90)
        assert abs(s.evidence()[0] - ANALYTIC_2D) < 0.3, ("jax", seed)
        assert abs(outs[0]["logz"] - ANALYTIC_2D) < 0.3, ("port", seed)
