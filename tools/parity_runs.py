"""Seed runs of the quickstart on both packages, side by side: the cost of
each sampler route in likelihood calls, and where a run spends them.

Usage (from the repository root)::

    python tools/parity_runs.py [--packages jax torch] [--runs ...]
        [--seeds 0 1 2] [--device cpu|cuda] [--jobs N] [--threads N]
        [--out runs.jsonl]
    python tools/parity_runs.py --table runs.jsonl

Every run is a process of its own: the JAX package's pinned to the CPU
(``jax_platforms`` set to "cpu" before any array is made), the port's on
``--device`` (the card by default). Each prints one JSON line: the
package, device, run and seed, logZ and its error, calls, iterations,
sweep steps (the sum of every iteration's), the k-hat of every flow-IS
evidence round (more than one means refinement rounds ran, each doubling
``n_total``) with the n_total, iterations and calls it was drawn at, the
final ``n_total``, the training epochs of each iteration of the device
loop (the host loop's too on the port), the bridge's calls where it ran,
and the wall seconds.

The problem is the quickstart: the 10-D Rosenbrock of
``tests/test_torch_bins.py`` with an N(0, 3) prior, exact logZ -21.4021.
The runs:

- ``quickstart32``: every setting at its default (nsf6, n_effective 512,
  n_active 256, ``run(n_total=4096, n_evidence=4096)``) with the flow
  ``Flow(10, "nsf6", bins=32)``;
- at the cut setting ``CUT`` (n_effective 256, n_active 128,
  ``n_total=1024, n_evidence=1024``, the default nsf6 flow):
  ``flowis`` (the defaults), ``nevid0`` (``n_evidence=0``: the ladder
  and the bridge), ``mala``, ``hmc`` (``n_leapfrog`` 5; its inner
  leapfrog passes count as calls in both packages) and ``host``
  (``vectorize=False`` with a per-row numpy likelihood: the host loop).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from itertools import product
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CUT = dict(n_effective=256, n_active=128)
CUT_RUN = dict(n_total=1024, n_evidence=1024)
RUNS = ("quickstart32", "flowis", "nevid0", "mala", "hmc", "host")
EXACT_LOGZ = -21.4021


def settings(run):
    """(Sampler keywords, run keywords, flow bins or None) of a run."""
    if run == "quickstart32":
        return {}, dict(n_total=4096, n_evidence=4096), 32
    kw, rk = dict(CUT), dict(CUT_RUN)
    if run == "nevid0":
        rk["n_evidence"] = 0
    elif run in ("mala", "hmc"):
        kw["sample"] = run
    elif run != "flowis" and run != "host":
        raise ValueError(f"unknown run {run!r}; the runs are {RUNS}")
    return kw, rk, None


def rosenbrock_row(x):
    """The quickstart's likelihood at one float64 row (the host loop)."""
    x = np.asarray(x, dtype=np.float64)
    return -float(np.sum(10.0 * (x[::2] ** 2 - x[1::2]) ** 2 + (x[::2] - 1.0) ** 2))


def make_sampler(package, run, seed, device):
    """(sampler, run keywords) of one run on ``package``."""
    kw, rk, bins = settings(run)
    host = run == "host"
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import pocomc_tpu as pc
        from pocomc_tpu.models.flow import Flow

        def log_like(x):
            return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                            + (x[..., ::2] - 1.0) ** 2, axis=-1)
        extra = {}
    else:
        import torch
        import pocomc_tpu_torch as pc
        from pocomc_tpu_torch.models.flow import Flow

        def log_like(x):
            return -(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                     + (x[..., ::2] - 1.0) ** 2).sum(-1)
        extra = dict(device=device)
        if device == "cuda" and not torch.cuda.is_available():
            sys.exit("parity_runs: --device cuda needs a CUDA device")
    if bins is not None:
        kw["flow"] = Flow(10, "nsf6", bins=bins, **extra)
    prior = pc.Prior([pc.Normal(0.0, 3.0) for _ in range(10)])
    s = pc.Sampler(prior, rosenbrock_row if host else log_like, vectorize=not host,
                   random_state=seed, **kw, **extra)
    return s, rk


def one_run(package, run, seed, device):
    """Run one and return its record."""
    s, rk = make_sampler(package, run, seed, device)
    rounds, stats = [], []
    evidence, device_loop = s._compute_evidence, s._run_device_loop

    def logged(*a, **k):
        out = evidence(*a, **k)
        rounds.append(dict(khat=float(s.evidence_khat), n_total=int(s.n_total),
                           iterations=int(s.t), calls=int(s.calls)))
        return out

    def loop(*a, **k):
        # the JAX device loop starts its iteration records anew each call
        out = device_loop(*a, **k)
        if package == "jax":
            stats.extend(s._dev_iter_stats)
        return out
    s._compute_evidence, s._run_device_loop = logged, loop
    t0 = time.perf_counter()
    s.run(progress=False, **rk)
    wall = time.perf_counter() - t0
    logz, dlogz = s.evidence()
    if package == "torch":
        stats = s._iter_stats
    epochs = [st["train_epochs"] for st in stats if st.get("train_epochs") is not None]
    khats = [r["khat"] for r in rounds]
    bridge = getattr(s, "bridge_diagnostics", None)
    return dict(package=package, device="cpu" if package == "jax" else device, run=run,
                seed=seed, logz=float(logz), dlogz=None if dlogz is None else float(dlogz),
                err=float(logz) - EXACT_LOGZ, calls=int(s.calls), iterations=int(s.t),
                sweep_steps=int(np.sum(s.particles.get("steps"))), khats=khats,
                refinements=max(len(khats) - 1, 0), n_total=int(s.n_total),
                evidence_rounds=rounds,
                train_epochs=epochs,
                bridge_calls=None if not bridge else int(bridge.get("calls", 0)),
                wall_s=wall)


def table(path):
    """Markdown rows of the records in ``path``: for each package, device
    and seed, each run's calls (with, where refinement rounds ran, the
    calls at the first evidence round, the k-hat there and the rounds),
    and each cut run's calls over the flow-IS run's, both taken at their
    first evidence round (a refinement is a second run of the loop at
    doubled n_total, which the k-hat of the first round decides)."""
    recs = [json.loads(l) for l in Path(path).read_text().splitlines() if l.startswith("{")]
    by = {}
    for r in recs:
        by.setdefault((r["package"], r["device"], r["seed"]), {})[r["run"]] = r

    def first(r):
        return r["evidence_rounds"][0]["calls"] if r["evidence_rounds"] else r["calls"]

    def cell(r):
        if r is None:
            return "—"
        if not r["refinements"]:
            return f"{r['calls']:,}"
        f = r["evidence_rounds"][0]
        return f"{r['calls']:,} ({f['calls']:,} at k-hat {f['khat']:.2f}; {r['refinements']} more)"

    print("| package, device, seed | " + " | ".join(RUNS) + " | "
          + " | ".join(f"{r} / flowis" for r in RUNS[2:]) + " |")
    print("|---" * (1 + len(RUNS) + len(RUNS) - 2) + "|")
    for key in sorted(by):
        runs = by[key]
        base = runs.get("flowis")
        ratios = [f"{first(runs[r]) / first(base):.2f}" if base and r in runs else "—"
                  for r in RUNS[2:]]
        print(f"| {', '.join(map(str, key))} | " + " | ".join(cell(runs.get(r)) for r in RUNS)
              + " | " + " | ".join(ratios) + " |")


def worker(args):
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    rec = one_run(args.packages[0], args.runs[0], args.seeds[0], args.device)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"], choices=["jax", "torch"])
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--jobs", type=int, default=1, help="runs at once")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch threads a run (0: torch's default)")
    ap.add_argument("--out", help="also append the lines to this file")
    ap.add_argument("--table", metavar="RUNS", help="print the records of this file (the "
                    "lines --out wrote) as a markdown table, and run nothing")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.table:
        return table(args.table)
    if args.worker:
        return worker(args)
    todo = list(product(args.runs, args.seeds, args.packages))
    running, failed = [], []

    def reap():
        for p, job in list(running):
            if p.poll() is not None:
                out, _ = p.communicate()
                running.remove((p, job))
                lines = [l for l in out.splitlines() if l.startswith("{")]
                if p.returncode or not lines:
                    failed.append(job)
                    print(json.dumps(dict(zip(("run", "seed", "package"), job),
                                          failed=p.returncode)), flush=True)
                    continue
                print(lines[-1], flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(lines[-1] + "\n")

    for job in todo:
        while len(running) >= args.jobs:
            reap()
            time.sleep(0.5)
        run, seed, package = job
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        if package == "jax":
            env["JAX_PLATFORMS"] = "cpu"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", "--packages",
               package, "--runs", run, "--seeds", str(seed), "--device", args.device,
               "--threads", str(args.threads)]
        running.append((subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True), job))
    while running:
        reap()
        time.sleep(0.5)
    if failed:
        sys.exit(f"parity_runs: {len(failed)} run(s) failed: {failed}")


if __name__ == "__main__":
    main()
