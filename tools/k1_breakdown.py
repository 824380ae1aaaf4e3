"""Where K1's time goes, by removing its parts one at a time, on a CUDA card.

    python3 tools/k1_breakdown.py

Builds ``pocomc_tpu_torch/csrc/ar_inverse.cu`` as it is and in variants
with a part taken out (their results are wrong; only their times count),
all with the spline head:

  * ``no_spline``: x = z and no log-det in place of the spline inverse;
  * ``no_reduce``: no butterfly reduction of the products' sums;
  * ``no_compute``: no products at all (the weights still stream through
    the ring, the epilogues still store);
  * ``no_compute_no_spline``: both, leaving the walk, the ring and the
    weight stream.

Each variant is compiled by nvcc with the package's flags into
``build/pocomc_tpu_torch/variants/`` and launched on the pack and launch
configuration the wrapper uses. Prints the card's name and power limit,
then one JSON line a shape (d, n at nsf6) of milliseconds per launch
(CUDA events around 20 launches, 5 at d=50, after 3 of warmup).
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SPLINE_1 = "      const float x = rqs_inverse_warp(row[zo + dim], p, lane, &l);"
SPLINE_R = "      const float x = Head::inverse(row[zo + dim], row + 3 * d, &l);"
IDENTITY = "      l = 0.0f; const float x = row[zo + dim];"
REDUCE = "    reduce_level<R * G, 0>(acc, lane);"
LOOP = "      for (int i = lane; i < nf; i += 32) {"
NO_LOOP = "      for (int i = lane; i < 0; i += 32) {"
VARIANTS = {
    "base": [],
    "no_spline": [(SPLINE_1, IDENTITY), (SPLINE_R, IDENTITY)],
    "no_reduce": [(REDUCE, "")],
    "no_compute": [(REDUCE, ""), (LOOP, NO_LOOP)],
    "no_compute_no_spline": [(REDUCE, ""), (LOOP, NO_LOOP), (SPLINE_1, IDENTITY),
                             (SPLINE_R, IDENTITY)],
}
SHAPES = [(10, 1), (10, 256), (10, 4096), (50, 1), (50, 256), (50, 4096)]


def build(name, edits):
    """The C entry point ar_inverse_launch of one variant."""
    from pocomc_tpu_torch.ops import _build
    src = (_build.CSRC / "ar_inverse.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            sys.exit(f"k1_breakdown: {name}: the source no longer has {old.strip()!r}")
        src = src.replace(old, new)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libar_inverse_{name}.so"
    with tempfile.NamedTemporaryFile("w", suffix=".cu", dir=out_dir) as f:
        f.write(src)
        f.flush()
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), f.name]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"k1_breakdown: nvcc failed for {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).ar_inverse_launch
    fn.argtypes = [ctypes.c_void_p if c == "P" else ctypes.c_int for c in "PPPPPIIIIPPIIIIIIP"]
    return fn


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_breakdown: needs a CUDA device")
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import flow_kernels as fk
    fns = {name: build(name, edits) for name, edits in VARIANTS.items()}
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
            z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
            x, ladj = torch.empty_like(z), torch.empty(n, device="cuda")
            R, W, S, SL, _, _ = fk._launch_config(n, d, h)
            pack = fk._inverse_pack(fp.ws, fp.bs, fp.inv_orders, d, h, T, "rqs")
            row = {"d": d, "n": n}
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(z.data_ptr(), x.data_ptr(), ladj.data_ptr(), None, None, n, d, h, T,
                             pack.data_ptr(), fp.inv_orders.data_ptr(), fk.N_PARAMS, R, W, S, SL,
                             z.device.index, torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"k1_breakdown: {name} failed with cudaError {err}")

                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                reps = 5 if d == 50 else 20
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    call()
                end.record()
                end.synchronize()
                row[f"{name}_ms"] = start.elapsed_time(end) / reps
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
