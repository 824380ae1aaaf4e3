"""Multi-process smoke harness of the particle mesh.

Counterpart of ``pocomc_tpu/parallel/smoke.py``: N OS processes join one
``torch.distributed`` process group (one rank a process, one device a
rank) and run the port's real code over the mesh. Runnable anywhere, on
the CPU over gloo by default:

    python -m pocomc_tpu_torch.parallel.smoke              # 2 ranks, every case
    python -m pocomc_tpu_torch.parallel.smoke 4 1 dev,host # 4 ranks, a subset
    python -m pocomc_tpu_torch.parallel.smoke 2 1 all,quickstart --device cuda

Each worker runs, over the mesh:
  1. (``core``) a sharded reduction and ``gather(shard_particles(a)) == a``;
     a black-box host likelihood through ``ParticleMesh.shard_callback``,
     which must see only this rank's rows; the adaptive t-pCN sweep
     (``mcmc.Sweep``) on this rank's rows, gathered and checksummed;
  2. (``dev``) a full ``Sampler.run()`` with a torch likelihood (the device
     loop, its history's rows split over the ranks);
  3. (``host``) a full ``Sampler.run()`` with a black-box numpy likelihood
     (the host loop, ``Flow.fit(mesh=)``, the stepped sweep on this rank's
     rows, which must see at most n_active / ranks rows a call); on a mesh
     whose size is not a power of two the power-of-two training batches
     must fall back to replication, and on one that is they must not;
  4. (``resume``) a ``save_every`` checkpoint under the mesh (rank 0
     writes, the others wait), resumed by a fresh ``Sampler``;
  5. (``quickstart``, not in ``all``) the 10-D Rosenbrock quickstart at
     full width (nsf6, n_active 256, n_total 4096, n_evidence 4096): logZ,
     calls, wall, the kernels' launches, the most rows a sweep step's
     inverse saw, and the all_reduce calls a sweep step.
Every worker prints one ``MULTIHOST-OK`` line with its statistics (JSON
after ``stats=``) and a checksum of every result; ``launch`` raises on a
failed worker and on checksums that disagree (every rank holds the same
replicated results).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

QUICKSTART_LOGZ = -21.4021


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_worker(process_id: int, num_processes: int, port: int, n_local: int = 1,
               cases: str = "all", device: str = "cpu") -> None:
    """Body of one rank. ``cases``: comma-separated, or "all" (core, dev,
    host, resume); ``quickstart`` is asked for by name. ``device``: "cpu"
    (gloo) or "cuda" (the rank's card; gloo when ranks share one)."""
    want = set(cases.split(","))
    if "all" in want:
        want |= {"core", "dev", "host", "resume"}
    import numpy as np
    import torch

    from pocomc_tpu_torch.parallel.mesh import (ParticleMesh, barrier, block,
                                                initialize_distributed, psum)
    if device == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    rank, count = initialize_distributed(f"localhost:{port}", num_processes, process_id,
                                         local_device_count=n_local,
                                         platform="cpu" if device == "cpu" else None)
    assert count == num_processes and rank == process_id
    from pocomc_tpu_torch import Normal, Prior, Sampler
    from pocomc_tpu_torch.mcmc import Sweep, make_loglike
    from pocomc_tpu_torch.models.geometry import fit_geometry
    from pocomc_tpu_torch.scaler import Reparameterize

    mesh = ParticleMesh()
    dev = mesh.device
    assert mesh.multihost == (num_processes > 1) and mesh.size == num_processes
    stats = dict(backend=torch.distributed.get_backend(), device=str(dev))
    checksum = 0.0

    if "core" in want:
        n, d = 16 * mesh.size, 3
        # 1. a sharded reduction, and the gather that undoes the shard
        a = np.arange(n, dtype=np.float64)
        part = mesh.shard_particles(a)
        assert part.shape[0] == n // mesh.size
        assert float(psum(mesh, part.sum())) == n * (n - 1) / 2
        assert np.array_equal(mesh.gather(part), a)
        # 2. the black-box fan-out: this rank's rows only
        seen = []

        def host_like(x, mask):
            seen.append(x.shape[0])
            xs = x.double().cpu().numpy()
            out = torch.from_numpy(-0.5 * np.sum(xs ** 2, axis=-1)).to(x)
            return torch.where(mask, out, torch.full_like(out, -math.inf))

        x_all = torch.from_numpy(np.random.default_rng(0).normal(size=(n, d))).float().to(dev)
        logl = mesh.shard_callback(host_like)(x_all, torch.ones(n, dtype=torch.bool,
                                                                device=dev))
        np.testing.assert_allclose(logl.cpu().numpy(),
                                   -0.5 * np.sum(x_all.double().cpu().numpy() ** 2, 1),
                                   atol=1e-5)
        assert max(seen) <= n // mesh.size, seen
        stats["local_batch_max"] = max(seen)
        # 3. the adaptive sweep on this rank's rows
        prior = Prior([Normal(0.0, 3.0) for _ in range(d)])
        scaler = Reparameterize(d, bounds=prior.bounds)
        scaler.fit(x_all.double().cpu().numpy())
        scp = scaler.whitening_params(dev)
        like = lambda x: -0.5 * (x * x).sum(-1)
        sweep = Sweep(scaler, lambda x: prior.logpdf(x).float(), make_loglike(like), None, d,
                      n_steps=2, n_max=4, kind="tpcn", preconditioned=False, plateau_z=0.75,
                      corr_threshold=0.15, calib_z=3.0, bias_budget=0.1, bias_rate=0.4,
                      bias_floor=0.1, mesh=mesh)
        u0 = scaler.forward(x_all, params=scp)
        x0, ldj0 = scaler.inverse(u0, params=scp)
        gen = torch.Generator(device=dev).manual_seed(7)
        geom = fit_geometry(u0)
        rows = [block(mesh, t) for t in (u0, x0, ldj0, like(x0), prior.logpdf(x0).float())]
        res = sweep.run(*rows, 0.5, 2.38 / math.sqrt(d), geom, None, scp, gen, dbeta=0.5)
        u_new = mesh.gather(res["u"])
        assert np.isfinite(u_new).all() and res["steps"] >= 2
        stats.update(sweep_steps=int(res["steps"]),
                     collectives_per_step=sweep.collectives / int(res["steps"]))
        checksum += float(np.sum(u_new.astype(np.float64)))

    d2 = 2
    pr = Prior([Normal(0.0, 2.0) for _ in range(d2)])
    n_active = 16 * mesh.size
    tiny = dict(n_effective=2 * n_active, n_active=n_active, flow="nsf3",
                train_config={"epochs": 5, "patience": 2}, random_state=11, mesh=mesh,
                vectorize=True, device=dev)

    def run_case(like, expect_device_loop, prepare=None, **run_kw):
        s = Sampler(pr, like, **tiny)
        assert s._use_device_loop() == expect_device_loop
        if prepare is not None:
            prepare(s)
        s.run(n_total=2 * n_active, n_evidence=n_active, progress=False, **run_kw)
        xs, w, _, _ = s.posterior()
        return float(s.logz) + float(np.sum(xs * w[:, None])), s

    def like_traced(x):
        return -0.5 * (x * x).sum(-1) - d2 * 0.919

    sweep_rows, in_sweep = [], [False]

    def like_blackbox(x):
        x = np.asarray(x)  # a numpy body: the host route
        if in_sweep[0]:
            sweep_rows.append(x.shape[0])
        return -0.5 * np.sum(x ** 2, axis=-1) - d2 * 0.919

    def watch_sweep(s):
        # the rows the likelihood sees inside the host loop's sweeps (the
        # warmup runs it on every row on every rank)
        mutate = s._mutate

        def watched(cp):
            in_sweep[0] = True
            try:
                return mutate(cp)
            finally:
                in_sweep[0] = False
        s._mutate = watched

    # the power-of-two training batches divide a power-of-two mesh, so
    # there the fallback must never engage; the host fit on a mesh of 3
    # ranks must hit it
    pow2_mesh = (mesh.size & (mesh.size - 1)) == 0
    fb0 = mesh.replication_fallbacks
    if "dev" in want:
        cs, _ = run_case(like_traced, True)
        stats["run_logz_dev"] = cs
        checksum += cs
    if "host" in want:
        fb_host = mesh.replication_fallbacks
        cs, _ = run_case(like_blackbox, False, prepare=watch_sweep)
        assert sweep_rows and max(sweep_rows) <= n_active // mesh.size, sweep_rows
        stats.update(run_logz_host=cs, host_sweep_rows_max=max(sweep_rows),
                     host_fallbacks=mesh.replication_fallbacks - fb_host)
        checksum += cs
    fired = mesh.replication_fallbacks - fb0
    if pow2_mesh and ("dev" in want or "host" in want):
        assert fired == 0, f"unexpected replication fallback x{fired}"
    elif not pow2_mesh and "host" in want:
        assert stats["host_fallbacks"] > 0, "replication fallback never engaged"
    if "resume" in want:
        ckdir = os.path.join(tempfile.gettempdir(), f"pocomc_torch_smoke_ck_{port}")
        if rank == 0:
            shutil.rmtree(ckdir, ignore_errors=True)
        barrier(mesh)
        s1 = Sampler(pr, like_traced, output_dir=ckdir, **tiny)
        s1.run(n_total=2 * n_active, n_evidence=0, progress=False, save_every=2)
        states = sorted((p for p in os.listdir(ckdir)
                         if p.startswith("pmc_") and p[4:-6].isdigit()),
                        key=lambda p: int(p[4:-6]))
        assert states, f"no mid-run checkpoints written in {ckdir}"
        mid = os.path.join(ckdir, states[0])
        s2 = Sampler(pr, like_traced, output_dir=ckdir, **tiny)
        s2.run(n_total=2 * n_active, n_evidence=n_active, progress=False,
               resume_state_path=mid)
        assert s2.t > int(states[0][4:-6])
        xs, w, _, _ = s2.posterior()
        cs = float(s2.logz) + float(np.sum(xs * w[:, None]))
        assert np.isfinite(cs), cs
        stats["run_logz_resume"] = cs
        checksum += cs
        barrier(mesh)
        if rank == 0:
            shutil.rmtree(ckdir, ignore_errors=True)
    if "quickstart" in want:
        stats["quickstart"] = quickstart(mesh, dev)
        checksum += stats["quickstart"]["logz"] + stats["quickstart"]["calls"]

    print(f"MULTIHOST-OK rank={rank}/{count} devices={mesh.size} "
          f"stats={json.dumps(stats, separators=(',', ':'))} checksum={checksum:.6f}",
          flush=True)
    torch.distributed.destroy_process_group()


def rosenbrock(x):
    """The quickstart's 10-D Rosenbrock likelihood on (n, 10) tensors."""
    return -(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2 + (x[:, ::2] - 1.0) ** 2).sum(-1)


def quickstart(mesh, device, seed=0):
    """The 10-D Rosenbrock quickstart (N(0, 3) prior, every default) on the
    mesh: logZ, calls, wall seconds, the launches of K1, K2 and K2's
    backward, the most rows any sweep step's inverse (K1) took, and the
    sweep's all_reduce calls a step."""
    import numpy as np
    import torch

    from pocomc_tpu_torch import Normal, Prior, Sampler
    from pocomc_tpu_torch.ops import flow_kernels as fk

    prior = Prior([Normal(0.0, 3.0) for _ in range(10)])
    s = Sampler(prior, rosenbrock, vectorize=True, random_state=seed, mesh=mesh,
                device=device)
    inverse, k1_rows = s.flow.kernel_inv, [0]
    sweeps = [0, 0, False]  # all_reduce calls and steps of every sweep, inside one

    def counted_inverse(theta, fp=None):
        if sweeps[2]:
            k1_rows[0] = max(k1_rows[0], theta.shape[0])
        return inverse(theta, fp)

    s.flow.kernel_inv = counted_inverse
    run_sweep = s._sweep.run

    def counted_sweep(*args, **kw):
        sweeps[2] = True
        try:
            res = run_sweep(*args, **kw)
        finally:
            sweeps[2] = False
        sweeps[0] += s._sweep.collectives
        sweeps[1] += int(res["steps"])
        return res

    s._sweep.run = counted_sweep
    fk.zero_counts([fk.made_rqs_forward, fk.made_rqs_backward, fk.ar_inverse])
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=4096, n_evidence=4096, progress=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x, w, _, _ = s.posterior()
    assert np.isfinite(x).all() and x.shape[1] == 10
    return dict(logz=float(s.logz), calls=int(s.calls), wall_s=wall,
                iterations=int(s.t), sweep_steps=sweeps[1],
                collectives_per_sweep_step=sweeps[0] / max(sweeps[1], 1),
                sweep_k1_rows_max=k1_rows[0],
                launches=dict(ar_inverse=fk.ar_inverse.launches,
                              made_rqs_forward=fk.made_rqs_forward.launches,
                              made_rqs_backward=fk.made_rqs_backward.launches))


def launch(num_processes: int = 2, n_local: int = 1, timeout: float = 420.0,
           cases: str = "all", device: str = "cpu") -> list[str]:
    """Spawn the ranks; return their MULTIHOST-OK lines. Raises on any
    failed worker or on checksums that disagree between ranks."""
    port = _free_port()
    env = dict(os.environ)
    # the repository root on the path, whatever the caller's cwd
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pocomc_tpu_torch.parallel.smoke", "--worker", str(pid),
         str(num_processes), str(port), str(n_local), cases, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(num_processes)]
    outputs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            outputs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"multihost smoke worker failed (rc={p.returncode}):\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok_lines = [ln for out in outputs for ln in out.splitlines()
                if ln.startswith("MULTIHOST-OK")]
    if len(ok_lines) != num_processes:
        raise RuntimeError(f"expected {num_processes} MULTIHOST-OK lines, got "
                           f"{len(ok_lines)}:\n" + "\n".join(outputs))
    checksums = {ln.rsplit("checksum=", 1)[1] for ln in ok_lines}
    if len(checksums) != 1:
        raise RuntimeError(f"ranks disagree on the global result: {sorted(checksums)}")
    return ok_lines


def line_stats(line: str) -> dict:
    """The statistics of a MULTIHOST-OK line."""
    return json.loads(line.split(" stats=", 1)[1].rsplit(" checksum=", 1)[0])


def main(argv):
    if argv and argv[0] == "--worker":
        pid, nproc, port, n_local = map(int, argv[1:5])
        run_worker(pid, nproc, port, n_local, argv[5], argv[6])
        return
    device = "cpu"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    nproc = int(argv[0]) if argv else 2
    n_local = int(argv[1]) if len(argv) > 1 else 1
    cases = argv[2] if len(argv) > 2 else "all"
    for line in launch(nproc, n_local, cases=cases, device=device):
        print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
