"""Measurements of the PyTorch port's two SMC loops on the 10-D quickstart
Rosenbrock (the problem of ``chip_smoke.py`` phases 6 and 7).

Run from the repository root on a CUDA card::

    python3 tools/measure_paths.py                 # seeds 1 2, full size
    python3 tools/measure_paths.py --seeds 0 --skip-steps

Prints the card's name and power limit, then one JSON line per item:

  * for each seed, the device loop (torch likelihood, ``vectorize=True``)
    and then the black-box host loop (numpy per-row likelihood with a
    blob): logZ, k-hat, calls, wall, ``phase_seconds``, sweep steps,
    training epochs and the launches of K2's forward (``made_rqs_forward``)
    and backward (``made_rqs_backward``) and of K1 (``ar_inverse``);
  * the seconds of ``mean_nn_distance`` (the ``noise`` scale of
    ``Flow.fit``) on ``--nn-rows`` x 10 rows;
  * milliseconds per sweep step at n=256, d=10, nsf6 over ``--steps``
    forced steps, in the order device, stepped, vectorised, vectorised,
    stepped, device: the device sweep (``Sweep.run``), the stepped
    sweep with the per-row likelihood, and the stepped sweep with a
    vectorised numpy likelihood (``run_stepped``);
  * a ``torch.profiler`` trace of ``--profile-steps`` training steps of
    ``fit_stack`` (zero_grad, loss, backward, clip, AdamW) at d=10, nsf6,
    batch 1024: host milliseconds a step, device kernels a step, the
    device's busy share of the window (the union of its kernels' spans)
    and the ops with the most device time.

``--device cpu`` with small ``--nn-rows``/``--steps`` and no seeds
rehearses the script without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import pocomc_tpu_torch as pt  # noqa: E402
from pocomc_tpu_torch.mcmc import Sweep, make_loglike  # noqa: E402
from pocomc_tpu_torch.models.flow import Flow, mean_nn_distance  # noqa: E402
from pocomc_tpu_torch.models.geometry import fit_geometry  # noqa: E402
from pocomc_tpu_torch.ops import flow_kernels as fk  # noqa: E402

D = 10


def torch_like(x):
    return -(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2 + (x[:, ::2] - 1.0) ** 2).sum(-1)


def numpy_like_vec(x):
    return -np.sum(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2 + (x[:, ::2] - 1.0) ** 2, 1)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_path(seed, path, device):
    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(D)])
    if path == "device_loop":
        s = pt.Sampler(prior, torch_like, vectorize=True, random_state=seed, device=device)
    else:
        s = pt.Sampler(prior, chip_smoke.rosenbrock_row, blobs_dtype=np.float64,
                       random_state=seed, device=device)
    chip_smoke.reset_launches(fk)
    t0 = time.perf_counter()
    s.run(n_total=4096, n_evidence=4096, progress=False)
    sync(device)
    wall = time.perf_counter() - t0
    logz, _ = s.evidence()
    return dict(seed=seed, path=path, route=s.likelihood_route, logz=logz,
                khat=s.evidence_khat, calls=s.calls, wall_s=wall, phase_s=s.phase_seconds,
                steps=sum(r["steps"] for r in s._iter_stats),
                epochs=sum(r["train_epochs"] or 0 for r in s._iter_stats),
                k2=fk.made_rqs_forward.launches, k2_backward=fk.made_rqs_backward.launches,
                k1=fk.ar_inverse.launches)


def noise_scale_ms(rows, device):
    x = np.random.default_rng(0).standard_normal((rows, D)).astype(np.float32)
    mean_nn_distance(x, device)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        mean_nn_distance(x, device)
    sync(device)
    return (time.perf_counter() - t0) / 3 * 1e3


def ms_per_step(n_steps, device):
    rng = np.random.default_rng(0)
    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(D)])
    flow = Flow(D, "nsf6", device=device)
    scaler = pt.Reparameterize(D, bounds=np.array([[-np.inf, np.inf]] * D))
    scaler.fit(3.0 * rng.standard_normal((1024, D)))
    scp = scaler.whitening_params(device)
    u = torch.from_numpy((0.5 * rng.standard_normal((256, D))).astype(np.float32)).to(device)

    def host_rows(xh):
        return np.array([chip_smoke.rosenbrock_row(r)[0] for r in xh]), None

    def host_vec(xh):
        return numpy_like_vec(xh), None

    out = {}
    with torch.no_grad():
        fp = flow.params()
        xs, ldj = scaler.inverse(u, params=scp)
        theta, _ = flow.forward(u, fp)
        geom = fit_geometry(theta, torch.full((256,), 1.0 / 256, device=device),
                            torch.Generator(device).manual_seed(0))
        for route in ("device", "stepped", "stepped_vec", "stepped_vec", "stepped", "device"):
            sweep = Sweep(scaler, prior.logpdf, make_loglike(torch_like), flow, D,
                              n_steps, n_steps)
            sweep.keep_flag = lambda st: torch.ones((), dtype=torch.bool, device=device)
            args = (u, xs, ldj, torch_like(xs), prior.logpdf(xs), 0.5, 0.5, geom, fp, scp,
                    torch.Generator(device).manual_seed(0))
            sync(device)
            t0 = time.perf_counter()
            if route == "device":
                res = sweep.run(*args)
            else:
                res, _ = sweep.run_stepped(
                    *args, host_like=host_rows if route == "stepped" else host_vec)
            sync(device)
            out.setdefault(route, []).append((time.perf_counter() - t0) / res["steps"] * 1e3)
    return out


def profile_fit_step(n_steps, device):
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device).manual_seed(0)
    flow = Flow(D, "nsf6", device=device)
    params = list(flow.parameters())
    opt = torch.optim.AdamW(params, lr=1e-3)
    xb = torch.randn(1024, D, device=device, generator=g)
    wb = torch.rand(1024, device=device, generator=g)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = flow._loss_fn(xb, wb)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()

    for _ in range(5):
        step()
    sync(device)
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync(device)
        wall = time.perf_counter() - t0
    out = dict(steps=n_steps, host_ms_per_step=wall / n_steps * 1e3)
    if not cuda:
        return out
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                  for e in prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:8]
    out.update(device_kernels_per_step=len(spans) / n_steps,
               device_busy_ms_per_step=busy / 1e3 / n_steps,
               device_busy_share=busy / 1e3 / (wall * 1e3),
               top_device_ms_per_step=top)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nn-rows", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--skip-steps", action="store_true")
    ap.add_argument("--profile-steps", type=int, default=20)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("measure_paths: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    for seed in args.seeds:
        for path in ("device_loop", "black_box"):
            print(json.dumps(run_path(seed, path, args.device)), flush=True)
    if not args.skip_steps:
        print(json.dumps({f"noise_scale_{args.nn_rows}x{D}_ms":
                          noise_scale_ms(args.nn_rows, args.device)}), flush=True)
        print(json.dumps(dict(ms_per_step=ms_per_step(args.steps, args.device))), flush=True)
    if args.profile_steps > 0:
        print(json.dumps(dict(fit_step_profile=profile_fit_step(args.profile_steps,
                                                                args.device))), flush=True)


if __name__ == "__main__":
    main()
