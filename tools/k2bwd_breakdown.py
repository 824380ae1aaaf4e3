"""Where K2-bwd's time goes, by removing its parts one at a time, on a CUDA card.

    python3 tools/k2bwd_breakdown.py [--checkout DIR] [--fit-only | --host [--against DIR]]

Builds ``pocomc_tpu_torch/csrc/made_rqs_backward.cu`` of a checkout (this
one by default; another one, such as an unpacked earlier commit, with
``--checkout``) as it is and in variants with a part taken out (their
results are wrong; only their times count), and launches each through its
C entry point on the layer inputs K2's forward saved, both heads:

  * ``no_products``: no FMAs in the products (the fragments are not loaded
    either; the weight stream, the epilogues and the head's VJP still run);
  * ``no_vjp``: no head VJP (dL/dx passes through, the parameters'
    cotangent is what the product gave);
  * ``no_copies``: no weight copies (the ring's waits and barriers stay,
    the consumers read whatever the stages hold);
  * ``no_pack`` (the design on K5's tiles only): the pack kernel is not
    launched (the pack of the call before stays).

Two designs are known, told apart by their source: the first
(``tile_product_t`` in ``made_tile.cuh``, a two-stage cp.async ring, up to
16 rows a block) and the second (K5's tiles, ``stack_backward.cuh``, with
the pack kernel in the same launch). Beside the variants stand the
wrapper's whole call (the kernel and the weight-gradient bmm products) and
one training step (``fit_step``: zero_grad, the loss through K2 forward
and backward, clip and AdamW on a batch of 1024) at d=10 and 50, the
median of 200 steps each timed by CUDA events after 20 of warmup (the
step is host bound at d=10, so this is its wall time); ``--fit-only``
times the steps alone. ``--host`` times only the host: the steps' quartiles
over 1000 steps, and the host side of one ``made_rqs_backward`` call at
(10, 1024), both heads (``time.perf_counter`` around the wrapper, the
device idle before each call, outside the timed span), quartiles in µs
over 2000 calls; run it alternately on two checkouts. ``--host --against
DIR`` runs both checkouts' backward wrappers in one process instead
(DIR's package imported under another name, everything but
``_launch_backward`` this checkout's): ten blocks of 100 steps and 200
calls a design, alternating, quartiles over each design's blocks.
Shapes: nsf6 and maf6 at (d, n) = (10, 1024), (50, 1024), (50, 4096),
random output layers of std 0.02 * sqrt(32/h).
Prints the card's name and power limit, then one JSON line a shape of
milliseconds a launch (CUDA events around 20 launches, 5 at d=50, after 3
of warmup).
"""

import argparse
import ctypes
import hashlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SHAPES = [(10, 1024), (50, 1024), (50, 4096)]
NO_FMA_TILE = ("made_tile.cuh", "        acc[r] = fmaf(v, w, acc[r]);\n", "")
FIRST = {
    "no_products": [NO_FMA_TILE,
                    ("made_tile.cuh",
                     "      for (int r = 0; r < RP; ++r) acc[r] = fmaf(g[r * ldo + j], w, acc[r]);",
                     "      for (int r = 0; r < RP; ++r) {}")],
    "no_vjp": [("made_rqs_backward.cu",
                """          gd[p * d + k] = Head::forward_vjp(xs[p * d + k], pg + p * gw + (k - k0) * Head::NP,
                                            gx[p * d + k], gl[p]);""",
                "          gd[p * d + k] = gx[p * d + k] + 0.0f * xs[p * d + k];")],
    "no_copies": [("made_tile.cuh", "    if (ld.step < nsteps) {", "    if (false) {")],
}
SECOND = {
    "no_products": [("coupling_tile.cuh",
                     "      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);",
                     "      for (int c = 0; c < RN; ++c) {}")],
    "no_vjp": [("stack_backward.cuh",
                "          *gx = Head::forward_vjp(X[col * BMP + r], p, *gx, GL[r]);",
                "          *gx = *gx + 0.0f * X[col * BMP + r];")],
    "no_copies": [
        ("coupling_tile.cuh",
         "            mbar_expect(bar, 4u * (uint32_t)(bk * ldn));\n"
         "            bulk_copy(dst, packed + (size_t)k0 * ldn, 4u * (uint32_t)(bk * ldn), bar);",
         "            mbar_expect(bar, 0u);"),
        ("coupling_tile.cuh", "          if (lane == 0) mbar_expect(bar, 4u * (uint32_t)(bk * q.no));",
         "          if (lane == 0) mbar_expect(bar, 0u);"),
        ("coupling_tile.cuh", "            if (lane == 0) bulk_copy(dst, src, 4u * (uint32_t)(bk * N), bar);",
         "            ;"),
        ("coupling_tile.cuh",
         "              bulk_copy(dst + kk * ldn, src + (size_t)kk * N, 4u * (uint32_t)q.no, bar);",
         "              ;")],
    "no_pack": [("made_rqs_backward.cu",
                 "  pack_kernel<<<blocks, 256, 0, s>>>(w0, w1, w2, w3, pack, ps);", "")],
}


def build(build_mod, name, edits, csrc):
    """The C entry point made_rqs_backward_launch of one variant."""
    out_dir = build_mod.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(repr(edits).encode())
    for f in sorted(csrc.iterdir()):
        key.update(f.read_bytes())
    lib = out_dir / f"libmade_rqs_backward_{name}-{key.hexdigest()[:12]}.so"
    if lib.exists():  # this variant of these sources is built already
        return name, lib
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for f in csrc.iterdir():
            shutil.copy(f, tmp)
        for where, old, new in edits:
            path = Path(tmp) / where
            text = path.read_text()
            if text.count(old) != 1:
                sys.exit(f"k2bwd_breakdown: {name}: the source no longer has {old.strip()[:60]!r}")
            path.write_text(text.replace(old, new))
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib),
               str(Path(tmp) / "made_rqs_backward.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"k2bwd_breakdown: nvcc failed for {name}:\n{proc.stderr}")
    return name, lib


def events_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_flow(Flow, arch, d, seed):
    """chip_smoke's random flows: N(0, (0.02 sqrt(32/h))^2) output layers,
    N(0, 0.02^2) biases."""
    rng = np.random.default_rng(seed)
    flow = Flow(d, arch, device="cuda")
    scale = 0.02 * math.sqrt(32 / flow.n_hidden)
    with torch.no_grad():
        flow.weights[-1].copy_(torch.from_numpy(scale * rng.standard_normal(
            flow.weights[-1].shape)))
        for b in flow.biases:
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    return flow


def training_step(flow, d):
    """One training step at batch 1024 (chip_smoke's ``fit_step_ms``) as
    a closure: zero_grad, the loss through K2 forward and backward, clip,
    AdamW."""
    params = list(flow.parameters())
    opt = torch.optim.AdamW(params, lr=1e-3)
    g = torch.Generator("cuda").manual_seed(0)
    xb = torch.randn(1024, d, device="cuda", generator=g)
    wb = torch.rand(1024, device="cuda", generator=g)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = flow._loss_fn(xb, wb)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()

    return step


def step_ms(step, reps, warmup=20):
    """``reps`` steps, each timed by CUDA events (ms), after ``warmup``."""
    for _ in range(warmup):
        step()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def fit_step_ms(flow, d):
    """The median of 200 training steps."""
    return statistics.median(step_ms(training_step(flow, d), 200))


def backward_call(fk, flow, d, head):
    """One ``made_rqs_backward`` call at (d, 1024) on the layer inputs
    K2's forward saved, as a closure."""
    g = torch.Generator("cuda").manual_seed(1)
    y, g_z = (torch.randn(1024, d, device="cuda", generator=g) for _ in range(2))
    g_l = torch.randn(1024, device="cuda", generator=g)
    with torch.no_grad():
        fp = flow.params()
        _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head=head)

    def call():
        with torch.no_grad():
            fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts, head=head)

    return call


def host_us(call, reps, warmup=50):
    """The host side of ``reps`` calls in µs, each timed by
    ``time.perf_counter`` from an idle device (synchronized outside the
    timed span) to the call's return, after ``warmup``."""
    times = []
    for i in range(reps + warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        if i >= warmup:
            times.append(1e6 * (t1 - t0))
    torch.cuda.synchronize()
    return times


def entry_call(fk, flow, d, head):
    """One call of the C entry point made_rqs_backward_launch of ``fk``'s
    checkout alone (either design, told apart by ``_k2_backward_plan``),
    at (d, 1024) on buffers allocated once, as a closure."""
    n, h, T, np_ = 1024, flow.n_hidden, flow.n_transforms, fk.HEADS[head]
    g = torch.Generator("cuda").manual_seed(1)
    y, g_z = (torch.randn(n, d, device="cuda", generator=g) for _ in range(2))
    g_l = torch.randn(n, device="cuda", generator=g)
    with torch.no_grad():
        fp = flow.params()
        _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head=head)
    g_y = torch.empty_like(g_z)
    deltas = [torch.empty(T, n, w.shape[2], device="cuda") for w in fp.ws]
    keep = [acts, g_y, deltas]  # the buffers behind the pointers
    if hasattr(fk, "_k2_backward_plan"):
        cfg, n_pack = fk._k2_backward_plan(n, d, h, T, np_)
        pack = torch.empty(n_pack, device="cuda")
        keep.append(pack)
        weights = [*[w.data_ptr() for w in fp.ws], fp.bs[3].data_ptr()]
        tail = [pack.data_ptr(), np_, cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G, cfg.BK, cfg.S]
        sig = "PPPPPPPIIII" + "P" * 10 + "IIIIIIIIIP"
    else:
        weights = [a.data_ptr() for pair in zip(fp.ws, fp.bs) for a in pair]
        tail = [np_, *fk._k2_config(n, d, h, True, np_)]
        sig = "PPPPPPPIIII" + "P" * 12 + "IIIIIP"
    fn = fk._entry("made_rqs_backward", "made_rqs_backward_launch", sig)
    args = [*[a.data_ptr() for a in acts], g_z.data_ptr(), g_l.data_ptr(), g_y.data_ptr(),
            n, d, h, T, *weights, *[g.data_ptr() for g in deltas], *tail, 0]

    def call(keep=keep):
        if fn(*args, torch.cuda.current_stream().cuda_stream):
            sys.exit("k2bwd_breakdown: made_rqs_backward_launch failed")

    return call


def quartiles(xs):
    return statistics.quantiles(xs, n=4)


def import_as(root, alias):
    """The flow kernels of checkout ``root``'s ``pocomc_tpu_torch``,
    imported under the package name ``alias`` (the package imports itself
    only relatively), so that two checkouts' wrappers run in one process."""
    import importlib
    import importlib.util
    pkg = Path(root).resolve() / "pocomc_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.flow_kernels")


def host_against(fk, other, Flow, blocks=10, steps=100, calls=200):
    """This checkout's K2-bwd wrapper (``_launch_backward``, which the
    training step's autograd and ``made_rqs_backward`` both call) against
    ``other``'s in one process: blocks of ``steps`` training steps and
    ``calls`` backward calls at (10, 1024), the two alternating, the order
    flipped every block; everything else is this checkout's. Beside them,
    each design's C entry point alone (``entry_call``)."""
    own = fk._launch_backward
    designs = {"this": own, "other": other._launch_backward}
    out = {}
    for arch, head in (("nsf6", "rqs"), ("maf6", "affine")):
        flow = random_flow(Flow, arch, 10, 0)
        step, call = training_step(flow, 10), backward_call(fk, flow, 10, head)
        entries = {"this": entry_call(fk, flow, 10, head),
                   "other": entry_call(other, flow, 10, head)}
        got = {name: {"step_ms": [], "backward_host_us": [], "entry_host_us": []}
               for name in designs}
        for b in range(blocks):
            for name in (list(designs) if b % 2 == 0 else list(designs)[::-1]):
                fk._launch_backward = designs[name]
                got[name]["step_ms"] += step_ms(step, steps, warmup=10)
                got[name]["backward_host_us"] += host_us(call, calls, warmup=10)
                got[name]["entry_host_us"] += host_us(entries[name], calls, warmup=10)
        fk._launch_backward = own
        out[head] = {name: {k: quartiles(v) for k, v in r.items()} for name, r in got.items()}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose K2-bwd to build (default: this one)")
    ap.add_argument("--fit-only", action="store_true", help="time the training steps alone")
    ap.add_argument("--host", action="store_true",
                    help="time the steps' and the backward wrapper's host side alone")
    ap.add_argument("--against", metavar="DIR",
                    help="with --host: alternate the backward wrapper with DIR's in one process")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2bwd_breakdown: needs a CUDA device")
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import _build, flow_kernels as fk
    csrc = _build.CSRC
    second = (csrc / "stack_backward.cuh").exists()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    design = "k5_tiles" if second else "tile_product_t"
    if args.host and args.against:
        print(json.dumps({"design": design, "against": args.against, "quartiles": host_against(
            fk, import_as(args.against, "other_pocomc_tpu_torch"), Flow)}), flush=True)
        return
    if args.host:
        out = {"design": design, "fit_step_ms_quartiles": {}, "backward_host_us_quartiles": {}}
        for arch, head in (("nsf6", "rqs"), ("maf6", "affine")):
            flow = random_flow(Flow, arch, 10, 0)
            out["backward_host_us_quartiles"][head] = quartiles(
                host_us(backward_call(fk, flow, 10, head), 2000))
            out["fit_step_ms_quartiles"][f"{arch}_d10"] = quartiles(
                step_ms(training_step(flow, 10), 1000))
        print(json.dumps(out), flush=True)
        return
    steps = {}
    for arch, d in (("nsf6", 10), ("maf6", 10), ("nsf6", 50)):
        steps[f"{arch}_d{d}"] = fit_step_ms(random_flow(Flow, arch, d, 0), d)
    print(json.dumps({"design": "k5_tiles" if second else "tile_product_t",
                      "fit_step_ms": steps}), flush=True)
    if args.fit_only:
        return
    edits = SECOND if second else FIRST
    with ThreadPoolExecutor(len(edits) + 1) as ex:
        libs = dict(ex.map(lambda kv: build(_build, kv[0], kv[1], csrc),
                           {"as_is": [], **edits}.items()))
    sig = ("PPPPPPPIIII" + "P" * 10 + "IIIIIIIIIP") if second else \
        ("PPPPPPPIIII" + "P" * 12 + "IIIIIP")
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).made_rqs_backward_launch
        fn.argtypes = [ctypes.c_void_p if c == "P" else ctypes.c_int for c in sig]
        fn.restype = ctypes.c_int
        fns[name] = fn
    for arch, head in (("nsf6", "rqs"), ("maf6", "affine")):
        np_ = fk.HEADS[head]
        for d, n in SHAPES:
            rng = np.random.default_rng(d + n)
            flow = random_flow(Flow, arch, d, d)
            h, T = flow.n_hidden, flow.n_transforms
            reps = 5 if d == 50 else 20
            with torch.no_grad():
                fp = flow.params()
                y, g_z = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
                          for _ in range(2))
                g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
                _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head=head)
                g_y = torch.empty_like(g_z)
                deltas = [torch.empty(T, n, w.shape[2], device="cuda") for w in fp.ws]
                row = {"design": "k5_tiles" if second else "tile_product_t", "head": head,
                       "d": d, "n": n}
                if second:
                    cfg, n_pack = fk._k2_backward_plan(n, d, h, T, np_)
                    pack = torch.empty(n_pack, device="cuda")
                    tile = [np_, cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G, cfg.BK, cfg.S]
                    weights = [*[w.data_ptr() for w in fp.ws], fp.bs[3].data_ptr()]
                    tail = [pack.data_ptr(), *tile]
                    row["plan"] = cfg._asdict()
                else:
                    P, G, SL = fk._k2_config(n, d, h, True, np_)
                    weights = [a.data_ptr() for pair in zip(fp.ws, fp.bs) for a in pair]
                    tail = [np_, P, G, SL]
                    row["plan"] = dict(P=P, G=G, SL=SL)
                for name, fn in fns.items():
                    def call(fn=fn, name=name):
                        err = fn(*[a.data_ptr() for a in acts], g_z.data_ptr(), g_l.data_ptr(),
                                 g_y.data_ptr(), n, d, h, T, *weights,
                                 *[g.data_ptr() for g in deltas], *tail, 0,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            sys.exit(f"k2bwd_breakdown: {name} failed with cudaError {err}")

                    row[f"{name}_ms"] = events_ms(call, reps)
                row["wrapper_ms"] = events_ms(
                    lambda: fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts, head=head),
                    reps)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
