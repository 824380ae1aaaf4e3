"""How far each fp32 spline route lies from float64, on the two cases where
the JAX package and the port's plain route disagree past the parity tests'
tolerances: (a) 64-bin nsf3 / nsfc3 flows at d=10 with random weights, and
(b) an nsfc3 flow of 32 bins trained by a JAX run on a 2-D Gaussian.

Usage (from the repository root, on the CPU)::

    JAX_PLATFORMS=cpu python tools/spline_parity.py [--json out.json]
        [--save cases.npz]

and, on a card with the cases ``--save`` wrote (no JAX there)::

    python3 tools/spline_parity.py --kernels cases.npz [--json out.json]

For each case the same float32 weights (carried across with
``convert.load_flow_params``) and inputs go through four routes: the JAX
``Flow`` in float32; the JAX ``Flow`` in float64 (``jax_enable_x64``, in a
subprocess of its own, since the setting is process-wide); the port's
``Flow(device="cpu")`` (the plain versions of its kernels) in float32; and
the same in float64 (``Flow.double()``). It prints one JSON line a case
and output (forward z and log-det, inverse x and log-det, log_prob): the
two float64 routes' largest difference, and each fp32 route's largest
difference from the port's float64 route. The cases are those of
``tests/test_torch_flow_menu.py`` (``random_params``, inputs 1.5 N(0, 1)
at numpy seed d + 7) and ``tests/test_torch_bins.py`` (``_state_from_jax``:
the JAX sampler's flow, points N(0, 1) at numpy seed 0). ``--kernels``
runs the same cases through the port's CUDA kernels (the library of
run-time bins) against the port's float64 route.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUTPUTS = ("z", "ladj_fwd", "x", "ladj_inv", "log_prob")


def _layers(stack, arch):
    return [layer for tp in stack for layer in tp] if arch.startswith("nsfc") else stack


def random_params(jax, JFlow, d, arch, seed, bins, scale=0.02):
    """``tests/test_torch_flow_menu.py``'s ``random_params``: the JAX flow's
    init hidden layers, N(0, scale^2) output weights and biases, and a
    random whitening pre-layer, as a numpy tree."""
    jf = JFlow(d, arch, bins=bins, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jf.params))
    for i, layer in enumerate(_layers(params["stack"], arch)):
        if i % 4 == 3:
            layer["w"] = (scale * rng.standard_normal(layer["w"].shape)).astype(np.float32)
        layer["b"] = (scale * rng.standard_normal(layer["b"].shape)).astype(np.float32)
    a = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    params["pre"] = dict(mean=rng.standard_normal(d).astype(np.float32),
                         w_fwd=a.astype(np.float32),
                         w_inv=np.linalg.inv(a).astype(np.float32),
                         ladj=np.float32(np.log(abs(np.linalg.det(a)))))
    return params


def trained_params(jax, jpc, JFlow, arch, bins):
    """``tests/test_torch_bins.py``'s ``_state_from_jax`` run: the flow of a
    JAX sampler on the 2-D Gaussian, N(0, 3) prior, seed 0."""
    import jax.numpy as jnp
    s = jpc.Sampler(jpc.Prior([jpc.Normal(0, 3), jpc.Normal(0, 3)]),
                    lambda x: -0.5 * jnp.sum(x ** 2, axis=-1), vectorize=True,
                    random_state=0, n_effective=128, n_active=64,
                    flow=JFlow(2, arch, bins=bins), train_config={"epochs": 20, "patience": 3})
    s.run(n_total=256, n_evidence=256, progress=False)
    return jax.tree_util.tree_map(np.array, jax.device_get(s.flow.params))


def cases(jax, jpc, JFlow):
    """[(name, arch, d, bins, params, x)] in float32."""
    out = []
    for arch in ("nsf3", "nsfc3"):
        d, bins = 10, 64
        x = (1.5 * np.random.default_rng(d + 7).standard_normal((64, d))).astype(np.float32)
        out.append((f"a:{arch}-d{d}-bins{bins}", arch, d, bins,
                    random_params(jax, JFlow, d, arch, d, bins), x))
    pts = np.random.default_rng(0).normal(0.0, 1.0, (64, 2)).astype(np.float32)
    out.append(("b:trained-nsfc3-bins32", "nsfc3", 2, 32,
                trained_params(jax, jpc, JFlow, "nsfc3", 32), pts))
    return out


def jax_outputs(JFlow, arch, d, bins, params, x, x_rt=None):
    """The JAX flow's outputs at x. Given ``x_rt`` (the port's float64
    inverse at x, its pre-layer undone by the exact inverse of ``w_fwd``),
    the inverse's pair is the forward at ``x_rt`` instead: F(x_rt), which
    must give back x, and minus its log-det, which must be the port's
    inverse log-det. The JAX autoregressive inverse does not trace with
    ``jax_enable_x64`` (its ``dynamic_slice`` mixes int64 and int32
    indices)."""
    jf = JFlow(d, arch, bins=bins, seed=0)
    jf.params = params
    z, lf = jf.forward(x)
    if x_rt is None:
        xi, li = jf.inverse(x)
    else:
        xi, lb = jf.forward(x_rt)
        li = -np.asarray(lb)
    return [np.asarray(a, np.float64) for a in (z, lf, xi, li, jf.log_prob(x))]


def torch_outputs(arch, d, bins, params, x, double, device="cpu"):
    """The port's ``Flow(device=device)`` at x (on a card, its kernels); in
    float64, on the CPU, its stack goes through the plain versions directly
    (the kernels' wrappers take float32 alone), with the same pre-layer
    arithmetic as ``Flow.forward``/``inverse``."""
    import torch
    from pocomc_tpu_torch.convert import load_flow_params
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    flow = load_flow_params(Flow(d, arch, bins=bins, device=device), params)
    xt = torch.from_numpy(x).to(device)
    with torch.no_grad():
        if not double:
            z, lf = flow.forward(xt)
            xi, li = flow.inverse(xt)
            lp = flow.log_prob(xt)
            return [a.double().cpu().numpy() for a in (z, lf, xi, li, lp)]
        fp = flow.double().params()
        pre, xt = fp.pre, xt.double()
        if flow.kind == "nsfc":
            fwd = lambda y: ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks, bins=bins)
            inv = lambda z: ck.coupling_inverse_ref(z, fp.ws, fp.bs, fp.masks, bins=bins)
        else:
            fwd = lambda y: fk.made_rqs_forward_ref(y, fp.ws, fp.bs, head=flow.head, bins=bins)
            inv = lambda z: fk.ar_inverse_ref(z, fp.ws, fp.bs, fp.inv_orders, head=flow.head,
                                              bins=bins)
        z, lf = fwd((xt - pre["mean"]) @ pre["w_fwd"])
        y, li = inv(xt)
        lf = lf + pre["ladj"]
        lp = flow._base_logpdf(z) + lf
        x_rt = y @ torch.linalg.inv(pre["w_fwd"]) + pre["mean"]
        return [a.numpy() for a in (z, lf, y @ pre["w_inv"] + pre["mean"], li - pre["ladj"], lp,
                                    x_rt)]


def jax64_main(src, dst):
    """The JAX routes in float64: every case of ``src`` (an .npz of the
    float32 weights and inputs), written to ``dst``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pocomc_tpu.models.flow import Flow as JFlow
    with np.load(src, allow_pickle=True) as f:
        todo = f["cases"].tolist()
    res = {}
    for name, arch, d, bins, params, x, x_rt in todo:
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        for k, v in zip(OUTPUTS, jax_outputs(JFlow, arch, d, bins, p64, x.astype(np.float64),
                                             x_rt)):
            res[f"{name}/{k}"] = v
    np.savez(dst, **res)


def jax_float64(todo, refs):
    """The two float64 routes' largest differences, {case: {output: diff}}:
    the JAX ``Flow`` with ``jax_enable_x64`` (in a subprocess) against the
    port's float64 outputs ``refs`` (``torch_outputs(..., True)``, one a
    case of ``todo``, [(name, arch, d, bins, params, x)])."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        arr = np.empty(len(todo), dtype=object)
        arr[:] = [(*case, ref[5]) for case, ref in zip(todo, refs)]
        np.savez(src, cases=arr)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--jax64", src, dst],
                       check=True, env=env, stderr=subprocess.DEVNULL)
        with np.load(dst) as f:
            j64 = {k: f[k] for k in f.files}
    out = {}
    for (name, *_, x), ref in zip(todo, refs):
        # the inverse's x: the JAX float64 forward at the port's inverse gives back x
        out[name] = {k: float(np.abs(j64[f"{name}/{k}"] - (x if k == "x" else r)).max())
                     for k, r in zip(OUTPUTS, ref)}
    return out


def kernels_main(path, out):
    """Each case of ``path`` through the port's CUDA kernels (K2 and K1 for
    nsf3, K5 for nsfc3): one JSON line a case and output with the kernels'
    largest difference from the port's float64 route and its ratio to the
    tolerance, beside the card's name and power limit."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("spline_parity --kernels: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    with np.load(path, allow_pickle=True) as f:
        todo = f["cases"].tolist()
    lines = []
    for name, arch, d, bins, params, x in todo:
        ref = torch_outputs(arch, d, bins, params, x, True)
        got = torch_outputs(arch, d, bins, params, x, False, device="cuda")
        for k, a, r in zip(OUTPUTS, got, ref):
            lim = tolerance(name, k) + 1e-5 * np.abs(r)
            lines.append(dict(case=name, output=k, kernel_f32=float(np.abs(a - r).max()),
                              kernel_f32_over_tol=float((np.abs(a - r) / lim).max()),
                              card=card.stdout.strip()))
            print(json.dumps(lines[-1]), flush=True)
    if out:
        Path(out).write_text("".join(json.dumps(l) + "\n" for l in lines))


def tolerance(name, output):
    """The parity tests' atol of a case's output (rtol 1e-5 throughout):
    ``test_torch_flow_menu``'s STACK_TOL and LADJ for (a), the 1e-5 of
    ``test_state_from_jax_with_32_bins`` for (b)."""
    if name.startswith("b:"):
        return 1e-5
    return 5e-5 if output in ("z", "x") else 1e-4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the lines to this file")
    ap.add_argument("--save", metavar="CASES", help="also write the cases (weights and "
                    "inputs) to this .npz, for --kernels")
    ap.add_argument("--kernels", metavar="CASES", help="on a card, with no JAX: the kernels' "
                    "distances from float64 on the cases --save wrote")
    ap.add_argument("--jax64", nargs=2, metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax64:
        return jax64_main(*args.jax64)
    if args.kernels:
        return kernels_main(args.kernels, args.json)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import pocomc_tpu as jpc
    from pocomc_tpu.models.flow import Flow as JFlow
    todo = cases(jax, jpc, JFlow)
    if args.save:
        arr = np.empty(len(todo), dtype=object)
        arr[:] = todo
        np.savez(args.save, cases=arr)
    t64 = [torch_outputs(arch, d, bins, params, x, True) for _, arch, d, bins, params, x in todo]
    agree = jax_float64(todo, t64)
    lines = []
    for (name, arch, d, bins, params, x), r64 in zip(todo, t64):
        j32 = jax_outputs(JFlow, arch, d, bins, params, x)
        t32 = torch_outputs(arch, d, bins, params, x, False)
        for k, a, b, ref in zip(OUTPUTS, j32, t32, r64):
            lim = tolerance(name, k) + 1e-5 * np.abs(ref)
            err = lambda u: float(np.abs(u - ref).max())
            ratio = lambda u: float((np.abs(u - ref) / lim).max())
            lines.append(dict(case=name, output=k, f64_jax_vs_port=agree[name][k],
                              jax_f32=err(a), port_f32=err(b),
                              jax_vs_port_f32=float(np.abs(a - b).max()),
                              jax_f32_over_tol=ratio(a), port_f32_over_tol=ratio(b),
                              max_abs=float(np.abs(ref).max())))
            print(json.dumps(lines[-1]), flush=True)
    if args.json:
        Path(args.json).write_text("".join(json.dumps(l) + "\n" for l in lines))


if __name__ == "__main__":
    main()
