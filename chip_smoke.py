"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

  1. environment: card name and power limit (nvidia-smi), torch/CUDA
     versions, the TF32 flags (both must be off);
  2. build: compiles the three CUDA libraries from ``pocomc_tpu_torch/csrc``
     (K2's forward and backward, K1), one nvcc each, all started together;
  3. K2 against its plain versions at nsf6, d=10 (n=37, 256, 1024, 2048,
     4096) and d=50/h=256 (n=256, the sweep's population at any d, and
     4096), and at nsf3 on phase 10's shapes: d=2 (n=256, the imh
     mixture's population, and 2048, its flow-IS draws) and d=4 (n=128
     and 512, the imh_every Gaussian's):
     z, ladj and log_prob of the forward, and the
     layer inputs it saves for the backward; the gradients of the
     autograd.Function (forward kernel, then backward kernel), g_y
     included, against plain autograd of the plain forward on the same y,
     at the stated tolerance or twice the spread of plain autograd on the
     CPU against plain autograd on the card where that is larger; the
     backward kernel's g_y and weight and bias gradients
     against ``made_rqs_backward_ref`` and against plain autograd,
     transform by transform, on the layer inputs the forward kernel saved;
     rows in the spline tails (|y| >= 5), rows on a knot and rows of zero
     weight among the inputs;
  4. K1 (autoregressive inverse) against its plain version at the same
     shapes (n=1024 and 2048: the bridge's ``bridge_n`` for n_active up to
     512 and up to 1024; 2048 takes K1's two-row launch), plus the round
     trip forward(inverse(z)) = z;
  5. times of the three kernels and their plain versions: device time of
     one call (a CUDA graph of the call, replayed) and the time of an
     eager call (CUDA events around it), medians after warmup; K1's chain
     (the device time of one call at n=1) and the eager time of building
     its weight pack at d=10 and 50; one
     ``fit_stack`` batch step at d=10, batch 1024, on the kernel route
     and on plain autograd; the cost of the sweep's one scalar sync per
     step;
  6. the main path: ``Sampler`` on the 10-D Rosenbrock quickstart with an
     N(0, 3) prior and default settings, ``run(n_total=4096,
     n_evidence=4096)``, checked against the exact logZ -21.4021 (+-0.35)
     and for launches of all three kernels;
  7. the black-box path: the same problem with a numpy likelihood called
     once per float64 row (``vectorize=False``) that returns a blob,
     ``blobs_dtype=np.float64`` and every other setting at its default:
     the host SMC loop, ``Flow.fit`` and the stepped sweep. Checked against
     the same logZ gate, for launches of all three kernels, for a host
     route and for blobs equal to the function of the returned x;
  8. ``evidence_ladder_bridge``: phase 6's quickstart with
     ``run(n_total=4096, n_evidence=0)``: the ladder-grade knobs
     (corr_threshold = bias_floor = 0.15) in the sweep, then the
     flow-anchored bridge on the device route, checked against the same
     logZ gate, for its diagnostics and for K1 launches inside the bridge;
  9. ``evidence_bridge_black_box``: phase 7's per-row numpy likelihood with
     ``run(n_evidence=0)``: the bridge's host route, same checks
     (corr_threshold 0.15; the bias-rate rule is off for a host
     likelihood, so its floor is 0);
 10. ``flow_free_and_kernels``: ``precondition=False`` with ``tpcn`` and
     ``rwm`` on the 6-D correlated Gaussian of tests/test_statistical.py
     (its settings, ``n_evidence=0``, +-0.35), on the device loop and with
     ``device_loop=False``; ``sample="imh"`` on tests/test_imh.py's bimodal
     mixture (logZ +-0.3, mode mass +-0.1); ``imh_every=2`` on its 4-D
     Gaussian (+-0.4, calls below 1.5x the run with ``imh_every=0``);
 11. ``reference_surface``: a script written against the reference, on
     phase 6's problem: (a) ``Prior([scipy.stats.norm(0, 3)] * 10)``, which
     must repeat phase 6's logZ and calls bit for bit; (b) a prior in numpy
     alone (``logpdf``/``rvs``/``bounds``/``dim``), which takes the host
     route and the host loop, stays in the logZ gate, sees only finite
     rows and launches all three kernels; (c) phase 6's run with
     ``save_every=10``, which must repeat phase 6 bit for bit, then a
     sampler of another ``random_state`` that resumes from the state saved
     at t=20 (logZ in the gate, t >= the finished run's t - 2), and the
     finished run through ``save_state``/``load_state`` (posterior,
     evidence and the CUDA generator's state bit for bit). The states are
     written under ``build/`` and removed.

Every path (phases 6-11) runs with the launch counts set to 0 just before
it and read just after. Then the kernels line and, last, the contract
line. Any failed check exits non-zero before those two lines. Without a
CUDA device it exits 1.
"""

import copy
import json
import math
import shutil
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
# (flow, n_dim, n_particles) for the checks, h = max(next_pow2(3d), 32): nsf6
# at the quickstart's d and a wide one, nsf3 at phase 10's
SHAPES = [("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1024), ("nsf6", 10, 2048),
          ("nsf6", 10, 4096), ("nsf6", 50, 256), ("nsf6", 50, 4096),
          ("nsf3", 2, 256), ("nsf3", 2, 2048), ("nsf3", 4, 128), ("nsf3", 4, 512)]
# the shapes phase 5 times
TIMED = [(d, n) for flow, d, n in SHAPES if flow == "nsf6" and n != 37]
# stated tolerances: rtol/atol on z and x, atol on ladj, and on gradients
# max |diff| over max |grad| of each tensor. At d=10 the kernel and torch
# sum the same ~1.5k terms per output in another order; at d=50 (h=256)
# each output sums ~10x more terms and the inverse feeds each dimension's
# rounding into the next 49 steps of 6 transforms. d=2 and 4 take d=10's.
TOL = {10: dict(rtol=1e-5, atol=1e-5, ladj=1e-4, grad=1e-4),
       50: dict(rtol=1e-4, atol=1e-4, ladj=2e-3, grad=1e-3)}
# the H100 SXM's published peaks:
# fp32 outside the tensor cores and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
KERNELS = ("made_rqs_forward", "made_rqs_backward", "ar_inverse")


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


def reset_launches(fk):
    for name in KERNELS:
        getattr(fk, name).launches = 0


def read_launches(fk):
    return {name: getattr(fk, name).launches for name in KERNELS}


def watch_bridge(sampler, fk):
    """Wrap the sampler's bridge so that it records K1's launches inside
    it and the sweep's decorrelation knobs the run used."""
    real, seen = sampler._compute_bridge_evidence, {}

    def counted():
        before = fk.ar_inverse.launches
        seen.update(corr_threshold=sampler._sweep.corr_threshold,
                    bias_floor=sampler._sweep.bias_floor)
        res = real()
        seen["k1_launches"] = fk.ar_inverse.launches - before
        return res

    sampler._compute_bridge_evidence = counted
    return seen


def check_bridge(name, sampler, seen, bias_floor):
    """Phase 8/9 gates: logZ, the bridge's diagnostics and calls, the
    ladder-grade knobs (corr_threshold 0.15 and the given bias_floor: 0.15
    with the bias-rate rule on, 0 for a host likelihood, where it is off)
    and K1 inside the bridge. Returns the numbers to report."""
    logz, dlogz = sampler.evidence()
    bd = sampler.bridge_diagnostics
    if bd is None:
        fail(f"{name}: no bridge diagnostics")
    ladder = float(sampler.particles.compute_logw_and_logz(1.0, recorrect=True)[1])
    out = dict(logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ, ladder_logz=ladder,
               rungs=bd["rungs"], bridge_calls=bd["calls"], ess_min=bd["ess_min"],
               accept_last=bd["accept_last"], s_path=[float(v) for v in bd["s_path"]],
               bridge_n=sampler.bridge_n, k1_launches_in_bridge=seen.get("k1_launches"),
               corr_threshold=seen.get("corr_threshold"), bias_floor=seen.get("bias_floor"))
    if not (bd["rungs"] >= 1 and bd["calls"] >= sampler.bridge_n):
        fail(f"{name}: {bd['rungs']} rungs, {bd['calls']} bridge calls for bridge_n="
             f"{sampler.bridge_n}")
    if not seen.get("k1_launches"):
        fail(f"{name}: K1 was not launched inside the bridge")
    if not (seen.get("corr_threshold") == 0.15 and seen.get("bias_floor") == bias_floor):
        fail(f"{name}: the sweep ran with corr_threshold {seen.get('corr_threshold')} and "
             f"bias_floor {seen.get('bias_floor')}, not 0.15 and {bias_floor}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"{name}: logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if not (dlogz is not None and np.isfinite(dlogz)):
        fail(f"{name}: no finite bridge error bar ({dlogz})")
    return out


def correlated_gaussian():
    """tests/test_statistical.py:14-40: a 6-D Gaussian of condition number
    100 under N(0, 25^2) priors, as a torch likelihood, and its logZ."""
    from scipy.stats import multivariate_normal
    d = 6
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (q * np.logspace(0, 2, d)) @ q.T
    cov_inv = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    norm_const = float(-0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1]))

    def log_like(x):
        return norm_const - 0.5 * torch.einsum("ni,ij,nj->n", x, cov_inv.to(x), x)

    truth = multivariate_normal.logpdf(np.zeros(d), np.zeros(d), cov + 625.0 * np.eye(d))
    return log_like, d, truth


def mixture(d=2, sep=4.0, sig=0.5, w1=0.6):
    """tests/test_imh.py:14-30: a two-mode Gaussian mixture under N(0, 10^2)
    priors, as a torch likelihood; its logZ and the mass of the mode at
    +sep."""
    c = d * math.log(math.sqrt(2 * math.pi) * sig)

    def log_like(x):
        l1 = -0.5 * ((x - sep) ** 2).sum(-1) / sig ** 2 - c
        l2 = -0.5 * ((x + sep) ** 2).sum(-1) / sig ** 2 - c
        return torch.logaddexp(l1 + math.log(w1), l2 + math.log(1.0 - w1))

    var = sig ** 2 + 100.0
    z = np.exp(-0.5 * d * sep ** 2 / var) / (2 * np.pi * var) ** (d / 2)
    return log_like, np.log(z), w1


class NumpyNormalPrior:
    """Phase 11 (b)'s prior, N(0, sd) in every dimension in numpy alone (the
    reference's duck-typed protocol); it fails on a non-finite row and
    counts the rows and host seconds it spends."""

    def __init__(self, dim, sd):
        self.dim, self.sd = dim, sd
        self.bounds = np.array([[-np.inf, np.inf]] * dim)
        self.rows, self.seconds = 0, 0.0

    def logpdf(self, x):
        t0 = time.perf_counter()
        if not (isinstance(x, np.ndarray) and np.isfinite(x).all()):
            raise ValueError("the host prior was handed a non-finite row")
        out = (-0.5 * np.sum((x / self.sd) ** 2, axis=1)
               - self.dim * math.log(self.sd * math.sqrt(2 * math.pi)))
        self.seconds += time.perf_counter() - t0
        self.rows += len(x)
        return out

    def rvs(self, size, random_state=None):
        return np.random.default_rng(random_state).normal(0.0, self.sd, (size, self.dim))


def reference_surface(pt, fk, log_like, main, states, device="cuda", **kw):
    """Phase 11 on phase 6's problem (see the module docstring): ``main``
    holds phase 6's logz, calls and iterations, ``states`` is the
    directory the states go to, ``kw`` the Sampler's settings beyond the
    defaults. Returns (the numbers to report, launches by path); exits
    through ``fail`` on a failed check."""
    from scipy import stats

    def drive(label, prior, run_kw, **skw):
        s = pt.Sampler(prior, log_like, vectorize=True, device=device, **{**kw, **skw})
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = read_launches(fk)
        rows[label] = dict(logz=s.logz, dlogz=s.logz_err, calls=s.calls, iterations=s.t,
                           wall_s=wall, prior_route=s.prior_route,
                           device_loop=s._use_device_loop(), phase_s=dict(s.phase_seconds),
                           launches=launches[label])
        return s

    launches, rows = {}, {}
    run_kw = dict(n_total=4096, n_evidence=4096)
    d = 10
    # (a) scipy.stats columns, converted: phase 6's run bit for bit
    s = drive("scipy_prior", pt.Prior([stats.norm(0, 3)] * d), run_kw, random_state=0)
    if not (s.prior_route == "device" and s._use_device_loop()):
        fail("reference_surface (a): the scipy prior did not take the device loop")
    if (s.logz, s.calls) != (main["logz"], main["calls"]):
        fail(f"reference_surface (a): logZ {s.logz} and {s.calls} calls differ from "
             f"phase 6's {main['logz']} and {main['calls']}")
    # (b) a prior in numpy alone: the host route and the host loop
    host_prior = NumpyNormalPrior(d, 3.0)
    s = drive("host_prior", host_prior, run_kw, random_state=0)
    rows["host_prior"].update(prior_rows=host_prior.rows, prior_s=host_prior.seconds)
    if s.prior_route != "host" or s._use_device_loop():
        fail("reference_surface (b): the numpy prior did not take the host route and loop")
    if not (np.isfinite(s.logz) and abs(s.logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"reference_surface (b): logZ {s.logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    # (c) save_every, a resume by a sampler of another seed, a round trip
    shutil.rmtree(states, ignore_errors=True)
    s = drive("save_every", pt.Prior([pt.Normal(0.0, 3.0)] * d), dict(run_kw, save_every=10),
              random_state=0, output_dir=states)
    if (s.logz, s.calls) != (main["logz"], main["calls"]):
        fail(f"reference_surface (c): with save_every, logZ {s.logz} and {s.calls} calls "
             f"differ from phase 6's {main['logz']} and {main['calls']}")
    saved = sorted(p.name for p in states.glob("pmc_*.state"))
    r = drive("resume", pt.Prior([pt.Normal(0.0, 3.0)] * d),
              dict(run_kw, resume_state_path=states / "pmc_20.state"), random_state=1)
    rows["resume"]["t_done"] = s.t
    if not (np.isfinite(r.logz) and abs(r.logz - TRUE_LOGZ) < LOGZ_GATE and r.t >= s.t - 2):
        fail(f"reference_surface (c): the resumed run ended at logZ {r.logz}, t={r.t} "
             f"(gate {TRUE_LOGZ} +- {LOGZ_GATE}, t >= {s.t - 2})")
    s.save_state(states / "done.state")
    back = pt.Sampler(pt.Prior([pt.Normal(0.0, 3.0)] * d), log_like, vectorize=True,
                      device=device, **{**kw, "random_state": 2})
    back.load_state(states / "done.state")
    same = (back.evidence() == s.evidence()
            and all(np.array_equal(a, b) for a, b in zip(back.posterior(), s.posterior()))
            and back._gen.device.type == s._gen.device.type
            and torch.equal(back._gen.get_state(), s._gen.get_state()))
    if not same:
        fail("reference_surface (c): a finished run did not round-trip through "
             "save_state/load_state bit for bit")
    shutil.rmtree(states, ignore_errors=True)
    return dict(runs=rows, states_saved=saved, roundtrip_bit_for_bit=same,
                generator=s._gen.device.type), launches


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def random_flow(name, d):
    """A flow on the card with random non-zero weights from a numpy seed:
    init hidden layers, output layer and biases ~ N(0, 0.02^2), and a
    random whitening pre-layer."""
    from pocomc_tpu_torch.models.flow import Flow
    rng = np.random.default_rng(SEED + d)
    flow = Flow(d, name, device="cuda")
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


def graph_ms(fn, reps, warmup=2):
    """Median milliseconds of the device work of one fn() call: the call is
    captured once in a CUDA graph and the graph replayed between CUDA
    events, so the host's enqueue time is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps, warmup=1)


def grad_problem(flow, d, n, rng):
    """Inputs of a K2 gradient check from the numpy seed: y ~ N(0, 1) with
    every 8th row in the spline tails (|y| >= 5, +-5 exactly among them),
    every 8th row (offset 1) with its first dimension exactly on a knot of
    the first transform's spline (whose parameters do not depend on
    y[:, 0]), and upstream gradients g_z, g_ladj ~ N(0, 1) with every 4th
    row (offset 2) zero, as rows of zero weight give in the training loss.
    A knot row carries g_ladj = 0: the spline is C1, so the gradient of z
    is continuous there, but its log-slope's is not, and which side of the
    knot a row falls depends on the last bit of the knot position, which
    two correct implementations may round differently."""
    from pocomc_tpu_torch.models import transforms as tr
    from pocomc_tpu_torch.models.made import apply_made
    y = rng.standard_normal((n, d)).astype(np.float32)
    tails = np.arange(0, n, 8)
    y[tails] = rng.choice([-1.0, 1.0], (tails.size, d)) * rng.uniform(5.0, 7.0, (tails.size, d))
    y[tails[:2], 0] = [5.0, -5.0]
    y = torch.from_numpy(y).cuda()
    knots = torch.arange(1, n, 8, device="cuda")
    with torch.no_grad():
        fp = flow.params()
        p = apply_made([w[0] for w in fp.ws], [b[0] for b in fp.bs], y, d, 23)
        xk = tr._rqs_setup(p[:, 0], 8)[0]
        pick = torch.from_numpy(rng.integers(1, 8, knots.numel())).cuda()
        y[knots, 0] = xk[knots, pick]
    g_z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    g_z[2::4] = 0.0
    g_l[2::4] = 0.0
    g_l[knots] = 0.0
    return y, g_z, g_l


def edge_rows(flow, y, g_l, window=1e-5):
    """Rows whose gradient two correct fp32 routes may give differently:
    in the float64 forward some transform input lies within `window` of a
    knot of its spline (the clamp edges +-B among them), where the
    log-det's gradient jumps and a rounding of ~1e-6 picks the side, and
    the row's dL/dladj is nonzero. (n,) bool."""
    from pocomc_tpu_torch.models import transforms as tr
    from pocomc_tpu_torch.ops import flow_kernels as fk
    n, d = y.shape
    f64 = copy.deepcopy(flow).double()
    near = torch.zeros(n, dtype=torch.bool, device=y.device)
    with torch.no_grad():
        fp = f64.params()
        acts = fk.made_rqs_forward_ref(y.double(), fp.ws, fp.bs, save_inputs=True)[2]
        for t in range(acts[0].shape[0]):
            p = (acts[3][t] @ fp.ws[3][t] + fp.bs[3][t]).reshape(n, d, 23)
            xk = tr._rqs_setup(p, 8)[0]
            near |= ((acts[0][t][..., None] - xk).abs() < window).any(-1).any(-1)
    return near & (g_l != 0)


def autograd_by_transform(xs, ws, bs, g_z, g_l):
    """Plain autograd of the stack's forward, one transform at a time at
    the given transform inputs xs (T, n, d): (g_y, g_ws, g_bs) for the
    masked weights. Independent of the closed-form derivatives."""
    from pocomc_tpu_torch.models import transforms as tr
    from pocomc_tpu_torch.models.made import apply_made
    T, n, d = xs.shape
    g_ws = [torch.empty_like(w) for w in ws]
    g_bs = [torch.empty_like(b) for b in bs]
    g = g_z
    for t in reversed(range(T)):
        x = xs[t].clone().requires_grad_(True)
        wt = [w[t].clone().requires_grad_(True) for w in ws]
        bt = [b[t].clone().requires_grad_(True) for b in bs]
        z, l = tr.rqs_forward(x, apply_made(wt, bt, x, d, 23), 8)
        g, *gp = torch.autograd.grad((z, l.sum(-1)), [x, *wt, *bt], (g, g_l))
        for l_, gw in enumerate(gp[:4]):
            g_ws[l_][t] = gw
        for l_, gb in enumerate(gp[4:]):
            g_bs[l_][t] = gb
    return g, g_ws, g_bs


def rel_errs(got, want):
    """max |diff| / max |want| of each tensor"""
    return [max_err(a.to(b.device), b) / (float(b.abs().max()) + 1e-30)
            for a, b in zip(got, want)]


def grad_rel_err(name, got, want, tol):
    """max over tensors of max |diff| / max |want|; fails above tol."""
    errs = rel_errs(got, want)
    for i, e in enumerate(errs):
        if not e <= tol:
            fail(f"{name} (tensor {i}): max |diff| / max |grad| = {e:.3e} > {tol}")
    return max(errs)


def grad_route(flow, forward, y, g_z, g_l):
    """[g_y, masked weight gradients, bias gradients] of the flow's stack
    through `forward` by autograd, for dL/dz = g_z and dL/dladj = g_l."""
    flow.zero_grad(set_to_none=True)
    yy = y.clone().requires_grad_(True)
    fp = flow.params()
    z, ladj = forward(yy, fp.ws, fp.bs)
    torch.autograd.backward((z, ladj), (g_z, g_l))
    return [yy.grad, *[w.grad * m for w, m in zip(flow.weights, flow.masks)],
            *[b.grad for b in flow.biases]]


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of flops at the fp32 peak and bytes
    at the HBM rate."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def made_bounds(n, flow):
    """Bounds of K2's forward, K2's backward and K1 at n rows of the flow:
    the flops of the products over the weights its MADE masks leave (the
    mask sums of all transforms; the spline's arithmetic is left out), and
    each input read and each output written once, the weights as those the
    masks leave and the biases. K1 multiplies each of those weights once a
    row, as the forward does. The backward takes the saved layer inputs,
    g_z, g_ladj and the weights, gives g_y and the weight and bias
    gradients, and runs the output layer's product again, the products
    back through the four layers and the weight-gradient products."""
    d, h, T = flow.n_dim, flow.n_hidden, flow.n_transforms
    macs = [int(m.sum()) for m in flow.masks]
    total = sum(macs)
    weights = 4 * (total + T * (3 * h + 23 * d))
    return {"made_rqs_forward": bound(2 * n * total, 4 * (2 * n * d + n) + weights),
            "made_rqs_backward": bound(n * (4 * total + 2 * macs[3]),
                                       4 * (T * n * (d + 3 * h) + 2 * n * d + n) + 2 * weights),
            "ar_inverse": bound(2 * n * total, 4 * (2 * n * d + n + T * d) + weights)}


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
    # others', and wall_s is the build's own.
    def build_one(name):
        t0 = time.perf_counter()
        path, report = _build.build(name)
        return name, dict(seconds=round(time.perf_counter() - t0, 3), library=path.name,
                          ptxas=[l.strip() for l in report.splitlines()
                                 if "registers" in l or "spill" in l])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        build = dict(ex.map(build_one, KERNELS))
    emit("build", wall_s=round(time.perf_counter() - t0, 3), **build)

    # -- 3./4. kernels against their plain versions ------------------------
    errs = dict.fromkeys(KERNELS, 0.0)
    checks = []
    flows = {(f, d): random_flow(f, d) for f, d in sorted({(f, d) for f, d, _ in SHAPES})}
    for name, d, n in SHAPES:
        flow, rng = flows[name, d]
        tol = TOL[max(d, 10)]
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
        # K2 backward end to end: the kernel, through the autograd.Function
        # as training calls it, against plain autograd of the plain forward
        # on the same y. Rows on a knot in float64 with dL/dladj != 0 are
        # left out (edge_rows). Elsewhere two correct fp32 routes still
        # differ where a row's gradient is ill-conditioned (plain autograd
        # on the CPU against the card: up to 1e-2 of the largest gradient at
        # n=1024), so the stated tolerance rises to twice that spread,
        # measured here, where it is larger.
        yg, g_z, g_l = grad_problem(flow, d, n, rng)
        edge = edge_rows(flow, yg, g_l)
        g_ze, g_le = g_z.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
        plain = grad_route(flow, fk.made_rqs_forward_ref, yg, g_ze, g_le)
        e_cpu = max(rel_errs(grad_route(copy.deepcopy(flow).cpu(), fk.made_rqs_forward_ref,
                                        yg.cpu(), g_ze.cpu(), g_le.cpu()), plain))
        e2e_tol = max(tol["grad"], 2 * e_cpu)
        e_ge = grad_rel_err(f"K2 gradient end to end d={d} n={n}",
                            grad_route(flow, fk.made_rqs_forward, yg, g_ze, g_le), plain, e2e_tol)
        # then, with every row, against the plain backward and per-transform
        # autograd on the layer inputs the forward kernel saved, which are
        # themselves held to the plain forward's
        got = grad_route(flow, fk.made_rqs_forward, yg, g_z, g_l)
        with torch.no_grad():
            _, _, acts = fk.made_rqs_forward(yg, fp.ws, fp.bs, save_inputs=True)
            acts_r = fk.made_rqs_forward_ref(yg, fp.ws, fp.bs, save_inputs=True)[2]
            g_ref = fk.made_rqs_backward_ref(yg, fp.ws, fp.bs, g_z, g_l, acts)
        g_ag = autograd_by_transform(acts[0], fp.ws, fp.bs, g_z, g_l)
        torch.cuda.synchronize()
        # the saved inputs within 10x the value tolerance: each sums the
        # rounding of the transforms before it, where a wrong offset is O(1)
        e_acts = max(check_close(f"K2 saved input {l} d={d} n={n}", a, b, 10 * tol["rtol"],
                                 10 * tol["atol"]) for l, (a, b) in enumerate(zip(acts, acts_r)))
        flat = lambda g: [g[0], *[w * m for w, m in zip(g[1], flow.masks)], *g[2]]
        e_gr = grad_rel_err(f"K2 backward vs plain d={d} n={n}", got, flat(g_ref), tol["grad"])
        e_ga = grad_rel_err(f"K2 backward vs autograd d={d} n={n}", got, flat(g_ag),
                            tol["grad"])
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
        errs["made_rqs_backward"] = max(errs["made_rqs_backward"],
                                        *[max_err(a, b) for a, b in zip(got, flat(g_ref))])
        errs["ar_inverse"] = max(errs["ar_inverse"], e_x, e_li)
        checks.append(dict(flow=name, d=d, n=n, tol=tol, k2_z=e_z, k2_ladj=e_l, k2_logprob=e_lp,
                           k2_saved_inputs=e_acts, k2_grad_rel_end_to_end=e_ge,
                           k2_grad_end_to_end_tol=e2e_tol, k2_grad_rel_cpu_vs_card=e_cpu,
                           k2_edge_rows=int(edge.sum()),
                           k2_grad_rel_plain=e_gr, k2_grad_rel_autograd=e_ga, k1_x=e_x,
                           k1_ladj=e_li, roundtrip_z=e_rt, roundtrip_ladj=e_rtl))
    emit("kernels_vs_plain", checks=checks)

    # -- 5. times ------------------------------------------------------------
    # ms: device time of one call (graph replay); call_ms: one eager call
    times = []
    for d, n in TIMED:
        flow, rng = flows["nsf6", d]
        y, g_z, g_l = grad_problem(flow, d, n, rng)
        with torch.no_grad():
            fp = flow.params()
            _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True)
            orders_cpu = fp.inv_orders.cpu()
            reps_plain = 3 if d == 50 else 10
            calls = {
                "k2": (lambda: fk.made_rqs_forward(y, fp.ws, fp.bs), 20),
                "k2_plain": (lambda: fk.made_rqs_forward_ref(y, fp.ws, fp.bs), reps_plain),
                "k2_bwd": (lambda: fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts), 20),
                "k2_bwd_plain": (lambda: fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l,
                                                                  acts), reps_plain),
                "k1": (lambda: fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders), 20),
                "k1_plain": (lambda: fk.ar_inverse_ref(y, fp.ws, fp.bs, orders_cpu),
                             reps_plain)}
            row = dict(d=d, n=n)
            for key, (fn, reps) in calls.items():
                row[f"{key}_ms"] = graph_ms(fn, reps)
                row[f"{key}_call_ms"] = cuda_ms(fn, reps, warmup=1)
        times.append(row)
    # K1's chain: one call at n=1, where nothing but the T*d dependent
    # steps is left; and the weight pack it builds once per FlowParams
    chain = {}
    for d in sorted({d for d, _ in TIMED}):
        fp = flows["nsf6", d][0].params()
        with torch.no_grad():
            z1 = torch.zeros(1, d, device="cuda")
            key = f"d{d}"
            chain[f"k1_chain_ms_{key}"] = graph_ms(
                lambda: fk.ar_inverse(z1, fp.ws, fp.bs, fp.inv_orders), 20)

            def repack():
                fp.ws[0]._k1_pack = None
                fk.ar_inverse(z1, fp.ws, fp.bs, fp.inv_orders)

            chain[f"k1_with_pack_call_ms_{key}"] = cuda_ms(repack, 20)
    # one fit_stack batch step (zero_grad, loss, backward, clip, AdamW) at
    # d=10, batch 1024, on the kernel route and on plain autograd
    import pocomc_tpu_torch.models.flow as flow_mod
    step_ms = {}
    for route, forward in (("kernel", fk.made_rqs_forward), ("plain", fk.made_rqs_forward_ref)):
        flow = copy.deepcopy(flows["nsf6", 10][0])
        params = list(flow.parameters())
        opt = torch.optim.AdamW(params, lr=1e-3)
        g = torch.Generator("cuda").manual_seed(SEED)
        xb = torch.randn(1024, 10, device="cuda", generator=g)
        wb = torch.rand(1024, device="cuda", generator=g)
        flow_mod.made_rqs_forward = forward

        def step():
            opt.zero_grad(set_to_none=True)
            loss = flow._loss_fn(xb, wb)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(params, 1.0)
            opt.step()

        step_ms[route] = cuda_ms(step, 50 if route == "kernel" else 10)
    flow_mod.made_rqs_forward = fk.made_rqs_forward
    # the sweep's per-step stopping-rule read: one device scalar to the host
    flag = torch.zeros((), device="cuda")
    syncs = []
    for _ in range(200):
        t0 = time.perf_counter()
        bool((flag + 1.0) > 0.0)
        syncs.append((time.perf_counter() - t0) * 1e6)
    emit("times", card=card, shapes=times, fit_step_ms=step_ms,
         scalar_sync_us=statistics.median(syncs), **chain)

    # -- 6. main path --------------------------------------------------------
    def log_like(x):
        return -(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2
                 + (x[:, ::2] - 1.0) ** 2).sum(-1)

    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    sampler = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(fk)
    logz, dlogz = sampler.evidence()
    main = dict(logz=logz, calls=sampler.calls, iterations=sampler.t)
    x, w, _, _ = sampler.posterior()
    steps = [s["steps"] for s in sampler._iter_stats]
    epochs = [s["train_epochs"] for s in sampler._iter_stats if s["train_epochs"]]
    emit("main_path", card=card, logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ,
         khat=sampler.evidence_khat, calls=sampler.calls, iterations=sampler.t,
         sweep_steps=sum(steps), train_epochs=sum(epochs), wall_s=wall,
         phase_s=sampler.phase_seconds,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         posterior_shape=list(x.shape), posterior_finite=bool(np.isfinite(x).all()))
    if not all(launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"quickstart logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("posterior samples are not finite (n, 10) arrays")

    # -- 7. black-box path -------------------------------------------------
    like = TimedLikelihood(rosenbrock_row)
    sampler = pt.Sampler(prior, like, blobs_dtype=np.float64, random_state=0, device="cuda")
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bb_launches = read_launches(fk)
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
    if not all(bb_launches.values()):
        fail(f"a kernel of the black-box path was never launched: {bb_launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"black-box logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("black-box posterior samples are not finite (n, 10) arrays")
    if not np.allclose(blobs, np.sum(x * x, axis=1), rtol=1e-5, atol=0.0):
        fail("black-box blobs differ from sum(x^2) of the returned samples")
    by_path = {"main_path": launches, "black_box": bb_launches}
    k1_in_bridge = {}

    # -- 8. run(n_evidence=0): the ladder-grade sweep, then the bridge -----
    sampler = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda")
    seen = watch_bridge(sampler, fk)
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["evidence_ladder_bridge"] = read_launches(fk)
    out = check_bridge("evidence_ladder_bridge", sampler, seen, bias_floor=0.15)
    k1_in_bridge["evidence_ladder_bridge"] = out["k1_launches_in_bridge"]
    emit("evidence_ladder_bridge", card=card, **out, calls=sampler.calls,
         iterations=sampler.t, wall_s=wall, phase_s=sampler.phase_seconds,
         launches=by_path["evidence_ladder_bridge"])

    # -- 9. the bridge's host route ------------------------------------------
    like = TimedLikelihood(rosenbrock_row)
    sampler = pt.Sampler(prior, like, blobs_dtype=np.float64, random_state=0, device="cuda")
    seen = watch_bridge(sampler, fk)
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["evidence_bridge_black_box"] = read_launches(fk)
    if sampler.likelihood_traceable:
        fail("evidence_bridge_black_box: the per-row numpy likelihood was routed to the device")
    out = check_bridge("evidence_bridge_black_box", sampler, seen, bias_floor=0.0)
    k1_in_bridge["evidence_bridge_black_box"] = out["k1_launches_in_bridge"]
    emit("evidence_bridge_black_box", card=card, **out, route=sampler.likelihood_route,
         calls=sampler.calls, likelihood_rows=like.rows, likelihood_s=like.seconds,
         iterations=sampler.t, wall_s=wall, phase_s=sampler.phase_seconds,
         launches=by_path["evidence_bridge_black_box"])

    # -- 10. without the flow, and the rwm/imh kernels ---------------------
    runs = []

    def drive(label, prior_, like_, run_kw, **kw):
        s = pt.Sampler(prior_, like_, vectorize=True, random_state=0, device="cuda", **kw)
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        torch.cuda.synchronize()
        row = dict(run=label, logz=s.logz, dlogz=s.logz_err, calls=s.calls,
                   iterations=s.t, device_loop=s._use_device_loop(),
                   wall_s=time.perf_counter() - t0, launches=read_launches(fk))
        runs.append(row)
        return s, row

    cg_like, cg_d, cg_truth = correlated_gaussian()
    cg_prior = pt.Prior([pt.Normal(0.0, 25.0) for _ in range(cg_d)])
    for sample in ("tpcn", "rwm"):
        for loop in ("auto", False):
            label = f"precondition_false_{sample}_{'device' if loop == 'auto' else 'host'}_loop"
            s, row = drive(label, cg_prior, cg_like, dict(n_total=1024, n_evidence=0),
                           n_effective=512, n_active=256, precondition=False,
                           sample=sample, device_loop=loop)
            row["true_logz"] = cg_truth
            if s._use_device_loop() != (loop == "auto"):
                fail(f"{label}: took the wrong loop")
            if not (np.isfinite(s.logz) and abs(s.logz - cg_truth) < 0.35):
                fail(f"{label}: logZ {s.logz} outside {cg_truth} +- 0.35")
            if any(row["launches"].values()):
                fail(f"{label}: a flow kernel ran without the flow: {row['launches']}")
    mx_like, mx_truth, mx_mass = mixture()
    s, row = drive("imh_mixture", pt.Prior([pt.Normal(0.0, 10.0) for _ in range(2)]), mx_like,
                   dict(n_total=1024, n_evidence=2048), n_effective=512, n_active=256,
                   sample="imh", flow="nsf3", train_config=dict(epochs=60, patience=8))
    xs, ws, _, _ = s.posterior()
    row.update(true_logz=mx_truth, mode_mass=float(ws[xs[:, 0] > 0].sum() / ws.sum()),
               true_mode_mass=mx_mass)
    by_path["imh_mixture"] = row["launches"]
    if not (np.isfinite(s.logz) and abs(s.logz - mx_truth) < 0.3):
        fail(f"imh_mixture: logZ {s.logz} outside {mx_truth} +- 0.3")
    if not abs(row["mode_mass"] - mx_mass) < 0.1:
        fail(f"imh_mixture: mode mass {row['mode_mass']} outside {mx_mass} +- 0.1")
    g_truth = 4 * (-0.5 * np.log(2 * np.pi * 26.0))
    g_prior = pt.Prior([pt.Normal(0.0, 5.0) for _ in range(4)])

    def g_like(x):
        return -0.5 * (x * x).sum(-1) - 2.0 * math.log(2 * math.pi)

    refresh_calls = {}
    for ie in (0, 2):
        s, row = drive(f"imh_every_{ie}", g_prior, g_like, dict(n_total=512, n_evidence=512),
                       n_effective=256, n_active=128, imh_every=ie, corr_threshold=0.1,
                       flow="nsf3", train_config=dict(epochs=40, patience=5))
        row["true_logz"] = g_truth
        refresh_calls[ie] = s.calls
        by_path[f"imh_every_{ie}"] = row["launches"]
        if not (np.isfinite(s.logz) and abs(s.logz - g_truth) < 0.4):
            fail(f"imh_every={ie}: logZ {s.logz} outside {g_truth} +- 0.4")
    if not refresh_calls[2] < 1.5 * refresh_calls[0]:
        fail(f"imh_every=2 spent {refresh_calls[2]} calls, over 1.5x {refresh_calls[0]}")
    emit("flow_free_and_kernels", card=card, runs=runs)

    # -- 11. the reference surface: scipy and numpy priors, checkpoints -----
    from pathlib import Path
    out, paths = reference_surface(pt, fk, log_like, main, Path("build/chip_smoke_states"))
    by_path.update({f"reference_{k}": v for k, v in paths.items()})
    emit("reference_surface", card=card, phase6=main, **out)
    for name, counts in by_path.items():
        if not all(counts.values()):
            fail(f"a kernel of the {name} path was never launched: {counts}")

    # -- kernels line and contract line ------------------------------------
    # each kernel at the main path's shape: K2 forward and backward at the
    # training batch (d=10, n=1024), K1 at the sweep population (n=256);
    # K1 also at the quickstart bridge's rows (bridge_n=1024)
    at = {"made_rqs_forward": (1024, "k2"), "made_rqs_backward": (1024, "k2_bwd"),
          "ar_inverse": (256, "k1")}
    sources = {"made_rqs_forward": ("pocomc_tpu_torch/csrc/made_rqs_forward.cu",
                                    "pocomc_tpu/ops/pallas_kernels.py:34"),
               "made_rqs_backward": ("pocomc_tpu_torch/csrc/made_rqs_backward.cu",
                                     "pocomc_tpu/ops/pallas_kernels.py:89"),
               "ar_inverse": ("pocomc_tpu_torch/csrc/ar_inverse.cu", "RESULTS.md:76")}
    flow10 = flows["nsf6", 10][0]
    line = []
    for name in KERNELS:
        n, key = at[name]
        row = next(r for r in times if r["d"] == 10 and r["n"] == n)
        bound_ms, bound_by = made_bounds(n, flow10)[name]
        path_counts = {path: counts[name] for path, counts in by_path.items()}
        line.append({"name": name, "route": "cuda", "source": sources[name][0],
                     "replaces": sources[name][1], "launches": sum(path_counts.values()),
                     "launches_by_path": path_counts, "max_abs_err": errs[name],
                     "ms": row[f"{key}_ms"], "plain_ms": row[f"{key}_plain_ms"],
                     "call_ms": row[f"{key}_call_ms"],
                     "plain_call_ms": row[f"{key}_plain_call_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        if name == "ar_inverse":
            bridge_row = next(r for r in times if r["d"] == 10 and r["n"] == 1024)
            line[-1].update(chain_ms=chain["k1_chain_ms_d10"],
                            launches_in_bridge=k1_in_bridge,
                            bridge_ms=bridge_row["k1_ms"],
                            bridge_plain_ms=bridge_row["k1_plain_ms"],
                            bridge_bound_ms=made_bounds(1024, flow10)[name][0])
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
