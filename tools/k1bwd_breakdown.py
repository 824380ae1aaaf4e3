"""Where K1-bwd's time goes, by removing its parts one at a time, on a CUDA card.

    python3 tools/k1bwd_breakdown.py [--checkout DIR]

Builds ``pocomc_tpu_torch/csrc/ar_inverse_backward.cu`` of a checkout (this
one by default; another one, such as an unpacked earlier commit, with
``--checkout``) as it is and in variants with a part taken out (their
results are wrong; only their times count), all with the spline head:

  * ``no_vjp``: no element VJP (g_z is x's cotangent, the parameters'
    cotangent what the step read);
  * ``no_push``: no products or pushes (the weights still stream through
    the ring);
  * ``no_waits``: no ring waits and no copies (the producer warp stops at
    once, the consumers read whatever the stages hold);
  * ``no_state``: no loads of the saved state (constants in their place,
    or in the second design values computed from the step);
  * ``rows_in_turn`` and ``group_of_8`` (the design that reads K1's saved
    state only): the element VJP of a warp's R rows each warp-wide in turn
    (as the kernel runs it for R = 1), or on 8 lanes a row (as it runs it
    for R = 2 and 4).

Two designs are known, told apart by their source: the first (the kernel
reads the layer inputs a K2 forward saved at x, and recomputes the head
parameters) and the second (it reads the state K1's save instance wrote).
Each variant is compiled by nvcc with the package's flags into the
checkout's ``build/pocomc_tpu_torch/variants/`` and launched on the state,
pack and launch configuration the wrapper uses. Beside them stands the
forward that the design's gradient needs: the K2 forward that saves the
layer inputs (first design), or K1's save instance and K1 without it
(second). Prints the card's name and power limit, then one JSON line a
shape (d, n at nsf6) of milliseconds per launch (CUDA events around 20
launches, 5 at d=50, after 3 of warmup).
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SHAPES = [(10, 256), (10, 4096), (50, 256), (50, 4096)]
HEADER = "ar_walk.cuh"
# one edit list a design: (file, old text, new text); each old text must
# occur once
FIRST = {
    "no_vjp": [("cu", "Head::inverse_vjp(row[6 * g.h + k], p, row[6 * g.h + g.d + k], gl);",
                "row[6 * g.h + g.d + k];")],
    "no_push": [("cu", "for (int i = lane; i < fan; i += 32) {", "for (int i = lane; i < 0; ++i) {"),
                ("cu", "for (int s = lane; s < fan; s += 32) {", "for (int s = lane; s < 0; ++s) {")],
    "no_waits": [("h", "    mbar_wait(full + slot, phase);\n", ""),
                 ("cu", "    walk_back<Head>(g, T, p);\n    return;", "    return;")],
    "no_state": [("cu", "act(l)[o + s] = real ? sv.a[l + 1][base * h + u] : 0.0f;",
                  "act(l)[o + s] = 0.5f;"),
                 ("cu", "xv()[o + k] = real ? sv.a[0][base * d + j] : 0.0f;",
                  "xv()[o + k] = 0.5f;")],
}
# the second design's edits
VJP_WARP = """        gz[r] = Head::inverse_vjp_warp(x, lane < Head::NP ? pre[r] : 0.0f, cv()[r * RS + k],
                                       gl[r], lane, &gp[r]);"""
VJP_GROUP = """      const float gz = Head::inverse_vjp_group(nxt, mine ? cv()[r * RS + k] : 0.0f, glr,
                                               lane & 7, mine ? par() + r * RS : nullptr);"""
# without the VJP the saved values still go somewhere, so their loads stay
NO_VJP_GROUP = """      const float* q = reinterpret_cast<const float*>(&nxt);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < (int)(sizeof(nxt) / 4); ++i) sum += q[i];
      if (mine) par()[r * RS + (lane & 7)] = sum + 0.0f * glr;
      const float gz = mine ? cv()[r * RS + k] : 0.0f;"""
LOAD_WARP = """        pre[r] = row0 + r < n && lane <= Head::NP ? __ldg(saved(t, k, row0 + r) + lane) : 0.0f;"""
LOAD_GROUP = """      nxt = r < R && row < n ? Head::slice(saved(t, k, row), lane & 7) : typename Head::Slice{};"""
NO_LOAD_GROUP = """      typename Head::Slice q{};
      float* f = reinterpret_cast<float*>(&q);
#pragma unroll
      for (int i = 0; i < (int)(sizeof(q) / 4); ++i) f[i] = 0.1f * (float)((k + i + row) & 7) - 0.3f;
      nxt = q;"""
WARP = "static constexpr bool WARP = R == 1;"
SECOND = {
    "no_vjp": [("cu", VJP_WARP, """        gz[r] = cv()[r * RS + k] + 0.0f * x;
        gp[r] = pre[r];"""), ("cu", VJP_GROUP, NO_VJP_GROUP)],
    "no_push": [("cu", "for (int s = lane; s < nf; s += 32) {", "for (int s = lane; s < 0; ++s) {")],
    "no_waits": [("h", "    mbar_wait(full + slot, phase);\n", ""),
                 ("cu", "    walk_back<Head>(g, T, p);\n    p.flush();\n", "")],
    "no_state": [("cu", LOAD_WARP, "        pre[r] = 0.1f * (float)((k + lane) & 7) - 0.3f;"),
                 ("cu", LOAD_GROUP, NO_LOAD_GROUP),
                 ("cu", "masks[w] = row < n ? __ldg(saved + w) : 0u;",
                  "masks[w] = 0x55555555u ^ (unsigned)t;")],
    "rows_in_turn": [("cu", WARP, "static constexpr bool WARP = true;")],
    "group_of_8": [("cu", WARP, "static constexpr bool WARP = false;")],
}

def build(build_mod, name, edits, csrc):
    """The C entry point ar_inverse_backward_launch of one variant."""
    src = {"cu": (csrc / "ar_inverse_backward.cu").read_text(),
           "h": (csrc / HEADER).read_text()}
    for where, old, new in edits:
        if src[where].count(old) != 1:
            sys.exit(f"k1bwd_breakdown: {name}: the source no longer has {old.strip()[:60]!r}")
        src[where] = src[where].replace(old, new)
    out_dir = build_mod.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libar_inverse_backward_{name}.so"
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # the variant's own copy of the walk's header, found before csrc's
        for f in csrc.glob("*.cuh"):
            shutil.copy(f, tmp)
        (Path(tmp) / HEADER).write_text(src["h"])
        cu = Path(tmp) / "ar_inverse_backward.cu"
        cu.write_text(src["cu"])
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib), str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"k1bwd_breakdown: nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)).ar_inverse_backward_launch


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose K1-bwd to build (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1bwd_breakdown: needs a CUDA device")
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import _build, flow_kernels as fk
    csrc = _build.CSRC
    second = "take_back" in (csrc / "ar_inverse_backward.cu").read_text()
    edits = SECOND if second else FIRST
    fns = {name: build(_build, name, e, csrc) for name, e in {"base": [], **edits}.items()}
    sig = "PPPPPIIIIPPIIIIIIP" if second else "PPPPPPPIIIIPPIIIIIIP"
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p if c == "P" else ctypes.c_int for c in sig]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for d, n in SHAPES:
        rng = np.random.default_rng(d)
        flow = Flow(d, "nsf6", device="cuda")
        with torch.no_grad():
            w = flow.weights[-1]
            w.copy_(torch.from_numpy(0.02 * rng.standard_normal(w.shape)))
            fp = flow.params()
            h, T = flow.n_hidden, flow.n_transforms
            z, g_x = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
                      for _ in range(2))
            g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
            g_z = torch.empty_like(g_x)
            pack = fk._inverse_pack(fp.ws, fp.bs, fp.inv_orders, d, h, T, "rqs")
            R, W, S, SL = fk._backward_config(n, d, h)[:4]
            reps = 5 if d == 50 else 20
            row = {"design": "k1_state" if second else "k2_acts", "d": d, "n": n,
                   "R": R, "W": W, "S": S, "SL": SL}
            if second:
                x, _, state = fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, "rqs", True)
                head = [a.data_ptr() for a in state]
                row["k1_save_ms"] = events_ms(
                    lambda: fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, "rqs", True), reps)
                row["k1_ms"] = events_ms(
                    lambda: fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, "rqs"), reps)
            else:
                x, _ = fk._launch_inverse(z, fp.ws, fp.bs, fp.inv_orders, "rqs")
                _, _, acts = fk._launch_forward(x, fp.ws, fp.bs, True, "rqs")
                head = [a.data_ptr() for a in acts]
                row["k2_save_ms"] = events_ms(
                    lambda: fk._launch_forward(x, fp.ws, fp.bs, True, "rqs"), reps)
            for name, fn in fns.items():
                def call(fn=fn, name=name):
                    err = fn(*head, g_x.data_ptr(), g_l.data_ptr(), g_z.data_ptr(), n, d, h, T,
                             pack.data_ptr(), fp.inv_orders.data_ptr(), fk.N_PARAMS, R, W, S, SL,
                             z.device.index, torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"k1bwd_breakdown: {name} failed with cudaError {err}")

                row[f"{name}_ms"] = events_ms(call, reps)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
