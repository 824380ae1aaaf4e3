"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

  1. environment: card name and power limit (nvidia-smi), torch/CUDA
     versions, the TF32 flags (both must be off);
  2. build: compiles the two CUDA kernels from ``pocomc_tpu_torch/csrc``;
  3. K2 (fused MADE + spline forward) against its plain version at nsf6,
     d=10 (n=256, 1024, 4096) and d=50/h=256 (n=4096): z, ladj, log_prob
     and the autograd gradients;
  4. K1 (autoregressive inverse) against its plain version at the same
     shapes, plus the round trip forward(inverse(z)) = z;
  5. times of both kernels and their plain versions (CUDA events, median
     after warmup) and the cost of the sweep's one scalar sync per step;
  6. the main path: ``Sampler`` on the 10-D Rosenbrock quickstart with an
     N(0, 3) prior and default settings, ``run(n_total=4096,
     n_evidence=4096)``, checked against the exact logZ -21.4021 (+-0.35)
     and for launches of both kernels;
  7. the black-box path: the same problem with a numpy likelihood called
     once per float64 row (``vectorize=False``) that returns a blob,
     ``blobs_dtype=np.float64`` and every other setting at its default:
     the host SMC loop, ``Flow.fit`` and the stepped sweep. Checked against
     the same logZ gate, for launches of both kernels, for a host route and
     for blobs equal to the function of the returned x.

Then the kernels line and, last, the contract line. Any failed check exits
non-zero before those two lines. Without a CUDA device it exits 1.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TRUE_LOGZ = -21.4021
LOGZ_GATE = 0.35
SEED = 0
# (n_dim, n_particles) for the checks; nsf6 everywhere, h = max(next_pow2(3d), 32)
SHAPES = [(10, 256), (10, 1024), (10, 4096), (50, 4096)]
# stated tolerances: rtol/atol on z and x, atol on ladj. At d=10 the
# kernel and torch sum the same ~1.5k terms per output in another order;
# at d=50 (h=256) each output sums ~10x more terms and the inverse feeds
# each dimension's rounding into the next 49 steps of 6 transforms.
TOL = {10: dict(rtol=1e-5, atol=1e-5, ladj=1e-4, grad=1e-4),
       50: dict(rtol=1e-4, atol=1e-4, ladj=2e-3, grad=1e-3)}


def rosenbrock_row(x):
    """Phase 7's black-box likelihood: the quickstart Rosenbrock on one
    float64 numpy row, with sum(x^2) as its blob."""
    logl = -np.sum(10.0 * (x[::2] ** 2 - x[1::2]) ** 2 + (x[::2] - 1.0) ** 2)
    return float(logl), float(np.dot(x, x))


class TimedLikelihood:
    """Counts the rows and host seconds spent inside a per-row likelihood."""

    def __init__(self, fn):
        self.fn, self.rows, self.seconds = fn, 0, 0.0

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.fn(x)
        self.seconds += time.perf_counter() - t0
        self.rows += 1
        return out


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def random_flow(d):
    """nsf6 flow on the card with random non-zero weights from a numpy seed:
    init hidden layers, output layer and biases ~ N(0, 0.02^2), and a
    random whitening pre-layer."""
    from pocomc_tpu_torch.models.flow import Flow
    rng = np.random.default_rng(SEED + d)
    flow = Flow(d, "nsf6").cuda()
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(flow.weights, flow.biases)):
            if l == len(flow.weights) - 1:
                w.copy_(torch.from_numpy(0.02 * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    a = np.eye(d) + 0.1 * rng.standard_normal((d, d))
    flow.set_pre(dict(mean=0.1 * rng.standard_normal(d), w_fwd=a,
                      w_inv=np.linalg.inv(a), ladj=np.log(abs(np.linalg.det(a)))))
    return flow, rng


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(name, a, b, rtol, atol):
    err = max_err(a, b)
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        fail(f"{name}: max |diff| {err:.3e} exceeds atol {atol} + rtol {rtol} * |ref|")
    return err


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of fn() over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.ops import _build
    from pocomc_tpu_torch.ops import flow_kernels as fk
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    except OSError:
        card = "unknown (nvidia-smi not found)"
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on after importing pocomc_tpu_torch")
    if "jax" in sys.modules:
        fail("jax was imported")
    emit("environment", card=card, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- 2. build ----------------------------------------------------------
    # One nvcc per source, started together, so the script's build cost is
    # the slowest kernel's, not the sum; each kernel's seconds overlap the
    # other's, and wall_s is the build's own.
    def build_one(name):
        t0 = time.perf_counter()
        path, report = _build.build(name)
        return name, dict(seconds=round(time.perf_counter() - t0, 3), library=path.name,
                          ptxas=[l.strip() for l in report.splitlines()
                                 if "registers" in l or "spill" in l])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        build = dict(ex.map(build_one, ("made_rqs_forward", "ar_inverse")))
    emit("build", wall_s=round(time.perf_counter() - t0, 3), **build)

    # -- 3./4. kernels against their plain versions ------------------------
    errs = {"made_rqs_forward": 0.0, "ar_inverse": 0.0}
    checks = []
    flows = {d: random_flow(d) for d in sorted({d for d, _ in SHAPES})}
    for d, n in SHAPES:
        flow, rng = flows[d]
        tol = TOL[d]
        y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        with torch.no_grad():
            fp = flow.params()
            z_k, l_k = fk.made_rqs_forward(y, fp.ws, fp.bs)
            z_r, l_r = fk.made_rqs_forward_ref(y, fp.ws, fp.bs)
            torch.cuda.synchronize()
            e_z = check_close(f"K2 z d={d} n={n}", z_k, z_r, tol["rtol"], tol["atol"])
            e_l = check_close(f"K2 ladj d={d} n={n}", l_k, l_r, 0.0, tol["ladj"])
            lp_k = flow.log_prob(y, fp)
            pre = fp.pre
            z_p, l_p = fk.made_rqs_forward_ref((y - pre["mean"]) @ pre["w_fwd"], fp.ws, fp.bs)
            lp_r = flow._base_logpdf(z_p) + l_p + pre["ladj"]
            e_lp = check_close(f"K2 log_prob d={d} n={n}", lp_k, lp_r, 0.0, tol["ladj"])
        # gradients of the autograd.Function against plain autograd
        c_z = torch.randn(n, d, device="cuda", generator=torch.Generator("cuda").manual_seed(d))
        grads = []
        for route in ("kernel", "plain"):
            flow.zero_grad(set_to_none=True)
            yy = y.clone().requires_grad_(True)
            fpg = flow.params()
            f = fk.made_rqs_forward if route == "kernel" else fk.made_rqs_forward_ref
            zz, ll = f(yy, fpg.ws, fpg.bs)
            ((zz * c_z).sum() + ll.sum()).backward()
            grads.append([yy.grad] + [p.grad for p in flow.parameters()])
        e_g = 0.0
        for gk, gr in zip(*grads):
            scale = float(gr.abs().max()) + 1e-30
            e = max_err(gk, gr) / scale
            if e > tol["grad"]:
                fail(f"K2 gradient d={d} n={n}: max |diff| / max |grad| = {e:.3e} "
                     f"> {tol['grad']}")
            e_g = max(e_g, e)
        with torch.no_grad():
            zi = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
            x_k, li_k = fk.ar_inverse(zi, fp.ws, fp.bs, fp.inv_orders)
            x_r, li_r = fk.ar_inverse_ref(zi, fp.ws, fp.bs, fp.inv_orders)
            torch.cuda.synchronize()
            e_x = check_close(f"K1 x d={d} n={n}", x_k, x_r, tol["rtol"], tol["atol"])
            e_li = check_close(f"K1 ladj d={d} n={n}", li_k, li_r, 0.0, tol["ladj"])
            z_rt, l_rt = fk.made_rqs_forward(x_k, fp.ws, fp.bs)
            e_rt = check_close(f"K1 round trip d={d} n={n}", z_rt, zi, tol["rtol"],
                               10 * tol["atol"])
            e_rtl = check_close(f"K1 round-trip ladj d={d} n={n}", l_rt + li_k,
                                torch.zeros_like(l_rt), 0.0, 10 * tol["ladj"])
        errs["made_rqs_forward"] = max(errs["made_rqs_forward"], e_z, e_l)
        errs["ar_inverse"] = max(errs["ar_inverse"], e_x, e_li)
        checks.append(dict(d=d, n=n, tol=tol, k2_z=e_z, k2_ladj=e_l, k2_logprob=e_lp,
                           k2_grad_rel=e_g, k1_x=e_x, k1_ladj=e_li,
                           roundtrip_z=e_rt, roundtrip_ladj=e_rtl))
    emit("kernels_vs_plain", checks=checks)

    # -- 5. times ------------------------------------------------------------
    times = []
    for d, n in SHAPES:
        flow, rng = flows[d]
        y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        with torch.no_grad():
            fp = flow.params()
            reps_plain = 5 if d == 50 else 10
            row = dict(d=d, n=n,
                       k2_ms=cuda_ms(lambda: fk.made_rqs_forward(y, fp.ws, fp.bs), 20),
                       k2_plain_ms=cuda_ms(lambda: fk.made_rqs_forward_ref(y, fp.ws, fp.bs),
                                           reps_plain),
                       k1_ms=cuda_ms(lambda: fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders), 20),
                       k1_plain_ms=cuda_ms(lambda: fk.ar_inverse_ref(y, fp.ws, fp.bs,
                                                                     fp.inv_orders),
                                           reps_plain, warmup=1))
        times.append(row)
    # the sweep's per-step stopping-rule read: one device scalar to the host
    flag = torch.zeros((), device="cuda")
    syncs = []
    for _ in range(200):
        t0 = time.perf_counter()
        bool((flag + 1.0) > 0.0)
        syncs.append((time.perf_counter() - t0) * 1e6)
    emit("times", card=card, shapes=times, scalar_sync_us=statistics.median(syncs))

    # -- 6. main path --------------------------------------------------------
    def log_like(x):
        return -(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2
                 + (x[:, ::2] - 1.0) ** 2).sum(-1)

    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    sampler = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fk.made_rqs_forward.launches = 0
    fk.ar_inverse.launches = 0
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"made_rqs_forward": fk.made_rqs_forward.launches,
                "ar_inverse": fk.ar_inverse.launches}
    logz, dlogz = sampler.evidence()
    x, w, _, _ = sampler.posterior()
    steps = [s["steps"] for s in sampler._iter_stats]
    epochs = [s["train_epochs"] for s in sampler._iter_stats if s["train_epochs"]]
    emit("main_path", card=card, logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ,
         khat=sampler.evidence_khat, calls=sampler.calls, iterations=sampler.t,
         sweep_steps=sum(steps), train_epochs=sum(epochs), wall_s=wall,
         phase_s=sampler.phase_seconds,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         posterior_shape=list(x.shape), posterior_finite=bool(np.isfinite(x).all()))
    if not (launches["made_rqs_forward"] > 0 and launches["ar_inverse"] > 0):
        fail(f"a kernel of the main path was never launched: {launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"quickstart logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("posterior samples are not finite (n, 10) arrays")

    # -- 7. black-box path -------------------------------------------------
    like = TimedLikelihood(rosenbrock_row)
    sampler = pt.Sampler(prior, like, blobs_dtype=np.float64, random_state=0, device="cuda")
    fk.made_rqs_forward.launches = 0
    fk.ar_inverse.launches = 0
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bb_launches = {"made_rqs_forward": fk.made_rqs_forward.launches,
                   "ar_inverse": fk.ar_inverse.launches}
    logz, dlogz = sampler.evidence()
    x, w, _, _, blobs = sampler.posterior(return_blobs=True)
    steps = [s["steps"] for s in sampler._iter_stats]
    epochs = [s["train_epochs"] for s in sampler._iter_stats if s["train_epochs"]]
    emit("black_box", card=card, logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ,
         khat=sampler.evidence_khat, route=sampler.likelihood_route,
         traceable=sampler.likelihood_traceable, calls=sampler.calls,
         likelihood_rows=like.rows, likelihood_s=like.seconds, iterations=sampler.t,
         sweep_steps=sum(steps), train_epochs=sum(epochs), wall_s=wall,
         phase_s=sampler.phase_seconds, launches=bb_launches,
         posterior_shape=list(x.shape), blobs_shape=list(blobs.shape))
    if sampler.likelihood_traceable:
        fail("the per-row numpy likelihood was routed to the device")
    if not (bb_launches["made_rqs_forward"] > 0 and bb_launches["ar_inverse"] > 0):
        fail(f"a kernel of the black-box path was never launched: {bb_launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"black-box logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("black-box posterior samples are not finite (n, 10) arrays")
    if not np.allclose(blobs, np.sum(x * x, axis=1), rtol=1e-5, atol=0.0):
        fail("black-box blobs differ from sum(x^2) of the returned samples")

    # -- kernels line and contract line ------------------------------------
    main_k1 = next(r for r in times if r["d"] == 10 and r["n"] == 256)
    main_k2 = next(r for r in times if r["d"] == 10 and r["n"] == 1024)
    by_path = {name: {"main_path": launches[name], "black_box": bb_launches[name]}
               for name in launches}
    print(json.dumps({"kernels": [
        {"name": "made_rqs_forward", "route": "cuda",
         "source": "pocomc_tpu_torch/csrc/made_rqs_forward.cu",
         "replaces": "pocomc_tpu/ops/pallas_kernels.py:34",
         "launches": sum(by_path["made_rqs_forward"].values()),
         "launches_by_path": by_path["made_rqs_forward"],
         "max_abs_err": errs["made_rqs_forward"],
         "ms": main_k2["k2_ms"], "plain_ms": main_k2["k2_plain_ms"]},
        {"name": "ar_inverse", "route": "cuda",
         "source": "pocomc_tpu_torch/csrc/ar_inverse.cu",
         "replaces": "RESULTS.md:76",
         "launches": sum(by_path["ar_inverse"].values()),
         "launches_by_path": by_path["ar_inverse"],
         "max_abs_err": errs["ar_inverse"],
         "ms": main_k1["k1_ms"], "plain_ms": main_k1["k1_plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
