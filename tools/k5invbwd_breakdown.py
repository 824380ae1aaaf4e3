"""Where K5-inv-bwd's time goes, by removing its parts one at a time and by
trying other tiles, on a CUDA card.

    python3 tools/k5invbwd_breakdown.py [--checkout DIR]

Builds ``pocomc_tpu_torch/csrc/coupling_backward.cu`` of a checkout (this
one by default; another one, such as an unpacked earlier commit, with
``--checkout``) as it is and in variants with a part taken out (their
results are wrong; only their times count), and launches the inverse
instances through the C entry point:

  * ``no_products``: no FMAs in the register tiles (the fragments are not
    loaded either);
  * ``no_vjp``: no element VJP (dL/dx passes through, the parameters'
    cotangent is the parameters);
  * ``no_copies``: the producer warp fills no stage.

Two designs are known, told apart by their source: the first (the
kernel reads the layer inputs of a K5 forward at x, which the gradient
launches first, and computes the output layer's spline parameters again)
and the second (it reads the state the inverse's save instance wrote,
the spline parameters included). Beside the variants stand what the
gradient launches before the kernel: K5's forward with the save (first
design), or the inverse with the save and the inverse without it
(second); the second design is also timed with the parameters computed
again (``recompute``: the parameters' pointer null), and at n <= 1024 on
Row tiles of 4 and 2 rows (``row4``, ``row2``: more blocks than the 8-row
Tile gives there). Shapes: nsfc6 at (10, 256) and (10, 1024), nsfc12 at
(50, 256) and (50, 4096), random output layers of std 0.02 * sqrt(32/h).
Prints the card's name and power limit, then one JSON line a shape of
milliseconds a launch (CUDA events around 20 launches after 3 of warmup).
"""

import argparse
import ctypes
import hashlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SHAPES = [("nsfc6", 10, 256), ("nsfc6", 10, 1024), ("nsfc12", 50, 256), ("nsfc12", 50, 4096)]
COMMON = {
    "no_products": [("coupling_tile.cuh",
                     "      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);",
                     "      for (int c = 0; c < RN; ++c) {}")],
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
}
FIRST = {**COMMON, "no_vjp": [(
    "coupling_backward.cu",
    "          *gx = RqsHead::inverse_vjp(X[col * BMP + r], p, *gx, GL[r]);",
    "          *gx = *gx + 0.0f * X[col * BMP + r];")]}
SECOND = {**COMMON, "no_vjp": [(
    "stack_backward.cuh",
    "          *gx = Head::inverse_vjp(X[col * BMP + r], p, *gx, GL[r]);",
    "          *gx = *gx + 0.0f * X[col * BMP + r];")]}


def build(build_mod, name, edits, csrc):
    """The C entry point coupling_backward_launch of one variant."""
    out_dir = build_mod.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(repr(edits).encode())
    for f in sorted(csrc.iterdir()):
        key.update(f.read_bytes())
    lib = out_dir / f"libcoupling_backward_{name}-{key.hexdigest()[:12]}.so"
    if lib.exists():  # this variant of these sources is built already
        return name, lib
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for f in csrc.iterdir():
            shutil.copy(f, tmp)
        for where, old, new in edits:
            path = Path(tmp) / where
            text = path.read_text()
            if text.count(old) != 1:
                sys.exit(f"k5invbwd_breakdown: {name}: the source no longer has "
                         f"{old.strip()[:60]!r}")
            path.write_text(text.replace(old, new))
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib),
               str(Path(tmp) / "coupling_backward.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"k5invbwd_breakdown: nvcc failed for {name}:\n{proc.stderr}")
    return name, lib


def events_ms(fn, reps=20):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose K5-inv-bwd to build (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k5invbwd_breakdown: needs a CUDA device")
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import _build, coupling_kernels as ck
    csrc = _build.CSRC
    second = (csrc / "stack_backward.cuh").exists()
    edits = SECOND if second else FIRST
    with ThreadPoolExecutor(len(edits) + 1) as ex:
        libs = dict(ex.map(lambda kv: build(_build, kv[0], kv[1], csrc),
                           {"as_is": [], **edits}.items()))
    sig = "PPPPPPPPIIIIPPPPPPPIIIIIIIIIP" if second else "PPPPPPPIIIIPPPPPPPIIIIIIIIIP"
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).coupling_backward_launch
        fn.argtypes = [ctypes.c_void_p if c == "P" else ctypes.c_int for c in sig]
        fn.restype = ctypes.c_int
        fns[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for arch, d, n in SHAPES:
        rng = np.random.default_rng(d + n)
        flow = Flow(d, arch, device="cuda")
        h, T = flow.n_hidden, flow.n_transforms
        scale = 0.02 * math.sqrt(32 / h)
        with torch.no_grad():
            for l, (w, b) in enumerate(zip(flow.weights, flow.biases)):
                if l % 4 == 3:
                    w.copy_(torch.from_numpy(scale * rng.standard_normal(w.shape)))
                b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
            fp = flow.params()
            a = (fp.ws, fp.bs, fp.masks)
            z, g_x = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
                      for _ in range(2))
            g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
            g_z = torch.empty_like(g_x)
            cfg = ck._k5_config(n, d, h, True)
            layers = ck._layers(fp.ws, fp.bs)
            table = ck._table(0, tuple(t.data_ptr() for t in layers))
            packs = [ck._packed(layers, fp.ws, cfg, d, h, t) for t in (False, True)]
            row = {"design": "inverse_state" if second else "forward_at_x", "flow": arch,
                   "d": d, "n": n, "plan": cfg._asdict()}
            x, _ = ck.coupling_inverse(z, *a)
            row["inverse_ms"] = events_ms(lambda: ck.coupling_inverse(z, *a))
            if second:
                def save():
                    return ck._launch_stack(z, *a, True, True, "coupling_inverse")

                _, _, state = save()
                row["inverse_save_ms"] = events_ms(save)
                head, ps = [t.data_ptr() for t in state[:4]], [state[4].data_ptr()]
            else:
                _, _, acts = ck.coupling_forward(x, *a, save_inputs=True)
                row["forward_save_ms"] = events_ms(
                    lambda: ck.coupling_forward(x, *a, save_inputs=True))
                head, ps = [t.data_ptr() for t in acts], []

            def call(fn, c, p, packed):
                err = fn(*head, *p, g_x.data_ptr(), g_l.data_ptr(), g_z.data_ptr(), n, d, h, T,
                         table.data_ptr(), *[t.data_ptr() for t in packed], None, None, None,
                         None, c.RL, c.BM, c.RNH, c.RNO, c.G, c.BK, c.S, 1, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k5invbwd_breakdown: {c} failed with cudaError {err}")

            for name, fn in fns.items():
                row[f"{name}_ms"] = events_ms(lambda: call(fn, cfg, ps, packs))
            if second:
                row["recompute_ms"] = events_ms(lambda: call(fns["as_is"], cfg, [None], packs))
                for bm in (4, 2) if n <= 1024 else ():
                    G = min((d + 1) // 2, 256 // 23)
                    c = ck._k5_fit(1, (bm,), 2, 1, G, d, h, True)
                    if c is None:
                        continue
                    pk = [ck._packed(layers, fp.ws, c, d, h, t) for t in (False, True)]
                    row[f"row{bm}_ms"] = events_ms(lambda: call(fns["as_is"], c, ps, pk))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
