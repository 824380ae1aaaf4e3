"""Rank bodies of the port's mesh tests, and the spawner that runs one in k
processes over gloo on the CPU (imports no JAX: every rank imports only
this module, torch and pocomc_tpu_torch).

``run_ranks(k, fn, *args)`` starts k spawned processes, each joining one
gloo process group of k ranks on a free local port and calling
``fn(mesh, *args)``; it returns every rank's result in rank order and
raises (after stopping the others) if a rank fails or the time runs out.
"""

from __future__ import annotations

import math
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, k, port, args, out):
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        from pocomc_tpu_torch import ParticleMesh, initialize_distributed
        initialize_distributed(f"localhost:{port}", k, rank, platform="cpu")
        out.put((rank, True, fn(ParticleMesh(), *args)))
    except BaseException:  # reported to the parent, which stops every rank
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(k, fn, *args, timeout=240.0):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, k, port, args, out)) for r in range(k)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < k:
            try:
                rank, ok, value = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"{k - len(results)} of {k} ranks did not finish "
                                   f"in {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {k} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(k)]


# -- the problems (also run without a mesh, in the test process) ------------

def gauss_like(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[1] * math.log(2 * math.pi)


def gauss_row(x):
    """Per-row numpy likelihood with a blob: (logl, sum(x))."""
    x = np.asarray(x, dtype=np.float64)
    return float(-0.5 * np.dot(x, x) - 0.5 * len(x) * math.log(2 * math.pi)), float(x.sum())


def sampler_run(mesh, kwargs, run_kwargs, likelihood="gauss"):
    """A Sampler on the 2-D Gaussian of the JAX mesh tests (N(0, 5) prior;
    ``likelihood`` "gauss" vectorised, "row" per row with a blob): a dict of
    logz, logz_err, calls, the posterior's samples, weights and blobs, and t."""
    from pocomc_tpu_torch import Normal, Prior, Sampler
    like = gauss_like if likelihood == "gauss" else gauss_row
    s = Sampler(Prior([Normal(0.0, 5.0)] * 2), like, mesh=mesh, device="cpu", **kwargs)
    s.run(progress=False, **run_kwargs)
    post = s.posterior(return_blobs=s.have_blobs)
    return dict(logz=s.logz, logz_err=s.logz_err, calls=s.calls, x=post[0], w=post[1],
                blobs=post[4] if s.have_blobs else None, t=s.t)


def bridge_off(mesh):
    """``run(n_evidence=0)`` with the flow on this mesh: (logz, logz_err,
    the RuntimeWarnings' texts)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = sampler_run(mesh, dict(vectorize=True, random_state=0, n_effective=128,
                                     n_active=64, flow="nsf3",
                                     train_config=dict(epochs=10, patience=3)),
                          dict(n_total=256, n_evidence=0))
    return out["logz"], out["logz_err"], [str(w.message) for w in caught
                                          if issubclass(w.category, RuntimeWarning)]


SWEEP_D, SWEEP_N, SWEEP_STEPS = 4, 128, 8


def sweep_run(mesh):
    """The preconditioned t-pCN sweep at nsf3, d=4, n=128 from one state and
    one generator seed, held to exactly 8 steps: the whole population's u,
    x and logl after it (gathered on a mesh), every step's accept mask and
    mean acceptance, and the calls."""
    from pocomc_tpu_torch import Normal, Prior
    from pocomc_tpu_torch.mcmc import Sweep, make_loglike
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.models.geometry import fit_geometry
    from pocomc_tpu_torch.parallel.mesh import block, gather_rows
    from pocomc_tpu_torch.scaler import Reparameterize

    d, n = SWEEP_D, SWEEP_N
    prior = Prior([Normal(0.0, 3.0)] * d)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(n, d)) * 1.5
    scaler = Reparameterize(d, bounds=prior.bounds)
    scaler.fit(x0)
    scp = scaler.whitening_params("cpu")
    flow = Flow(d, "nsf3", device="cpu")
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.05 * torch.from_numpy(rng.normal(size=tuple(p.shape))).float())
    xt = torch.from_numpy(x0).float()
    with torch.no_grad():
        u = scaler.forward(xt, params=scp)
        x, ldj = scaler.inverse(u, params=scp)
        geom = fit_geometry(flow.forward(u)[0])
    sweep = Sweep(scaler, lambda a: prior.logpdf(a).float(), make_loglike(gauss_like), flow,
                  d, n_steps=2, n_max=SWEEP_STEPS, kind="tpcn", plateau_z=0.75,
                  corr_threshold=0.15, calib_z=3.0, bias_budget=0.1, bias_rate=0.4,
                  bias_floor=0.1, mesh=mesh)
    sweep.keep_flag = lambda st: torch.ones((), dtype=torch.bool)  # run to n_max
    masks, accepts = [], []
    update = sweep.accept_update

    def recorded(*a):
        st, acc = update(*a)
        masks.append(gather_rows(mesh, acc).numpy())
        accepts.append(float(st.accept))
        return st, acc

    sweep.accept_update = recorded
    rows = [block(mesh, t) for t in (u, x, ldj, gauss_like(x), prior.logpdf(x).float())]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        res = sweep.run(*rows, 0.7, 2.38 / math.sqrt(d), geom, flow.params(), scp, gen,
                        dbeta=0.2)
    full = {k: gather_rows(mesh, res[k]).numpy() for k in ("u", "x", "logl")}
    return dict(**full, masks=np.array(masks), accepts=np.array(accepts),
                steps=int(res["steps"]), calls=int(res["calls"]),
                sigma=float(res["proposal_scale"]), collectives=sweep.collectives)


def fit_run(mesh):
    """``Flow.fit`` of nsf3 at d=3 on 512 fixed weighted rows, seed 0, three
    epochs, batch 64 (so the mesh splits every batch): the parameters and
    the loss history."""
    from pocomc_tpu_torch.models.flow import Flow
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 3)).astype(np.float32) * np.array([1.0, 2.0, 0.5], np.float32)
    w = rng.random(512).astype(np.float32)
    flow = Flow(3, "nsf3", device="cpu")
    hist = flow.fit(x, weights=w, validation_split=0.25, epochs=3, batch_size=64,
                    patience=10, seed=0, mesh=mesh)
    return dict(params=[p.detach().numpy().copy() for p in flow.parameters()],
                pre={k: v.numpy().copy() for k, v in flow.get_pre().items()}, **hist)


def mesh_surface(mesh):
    """ParticleMesh's surface on this rank: the size, pad_to_multiple(13),
    this rank's block of 4 * size rows, the gather of it, the fallback on 13
    rows, and the error of n_active 100 on a mesh of 3."""
    from pocomc_tpu_torch import Normal, Prior, Sampler
    k = mesh.size
    a = np.arange(4 * k * 3, dtype=np.float32).reshape(4 * k, 3)
    part = mesh.shard_particles(a)
    hist = mesh.shard_history(dict(u=np.zeros((5, 4 * k, 3)), beta=np.zeros(5)))
    batches = mesh.shard_batches(np.zeros((2, 4 * k)))
    gathered = mesh.gather(part)
    fb0 = mesh.replication_fallbacks
    odd = mesh.shard_particles(np.arange(13.0))
    out = dict(size=k, multihost=mesh.multihost, pad13=mesh.pad_to_multiple(13),
               rank=mesh.rank, block=part.numpy(), gathered=gathered,
               hist_u=tuple(hist["u"].shape), hist_beta=tuple(hist["beta"].shape),
               batches=tuple(batches.shape), odd_rows=int(odd.shape[0]),
               fallbacks=mesh.replication_fallbacks - fb0,
               replicated=mesh.replicate(torch.full((2,), float(mesh.rank))).numpy())
    try:
        Sampler(Prior([Normal(0, 5)] * 2), gauss_like, vectorize=True, n_active=100,
                n_effective=200, mesh=mesh, device="cpu")
        out["n_active_100"] = None
    except ValueError as e:
        out["n_active_100"] = str(e)
    return out


def custom_flow_run(mesh):
    """Custom flows of the preconditioner protocol on this mesh, on the 2-D
    Gaussian: ``AffineFlow`` (host loop, parameters replicated from rank
    0, which starts from other ones) and ``DelegatingFlow`` around nsf3
    (device loop). For each: the loop taken, logz, logz_err, calls, the
    posterior samples and the flow's parameters, flattened."""
    from pocomc_tpu_torch import Normal, Prior, Sampler
    from pocomc_tpu_torch.models.flow import Flow
    from chip_smoke import AffineFlow, DelegatingFlow
    out = {}
    affine = AffineFlow(2, "cpu")
    affine.params["mu"] += float(mesh.rank)
    runs = dict(affine=(affine, dict(n_effective=256, n_active=128),
                        dict(n_total=512, n_evidence=1024)),
                delegating=(DelegatingFlow(Flow(2, "nsf3", seed=mesh.rank, device="cpu")),
                            dict(n_effective=128, n_active=64,
                                 train_config=dict(epochs=10, patience=3)),
                            dict(n_total=256, n_evidence=256)))
    for key, (flow, kw, run_kw) in runs.items():
        s = Sampler(Prior([Normal(0.0, 5.0)] * 2), gauss_like, vectorize=True, random_state=0,
                    flow=flow, mesh=mesh, device="cpu", **kw)
        s.run(progress=False, **run_kw)
        params = (s.flow.params.values() if key == "affine" else s.flow.parameters())
        out[key] = dict(device_loop=s._use_device_loop(), logz=s.logz, logz_err=s.logz_err,
                        calls=s.calls, x=s.posterior()[0],
                        params=np.concatenate([p.detach().numpy().ravel() for p in params]))
    return out
