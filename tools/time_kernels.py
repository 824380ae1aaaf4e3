"""Time the flow kernels (K2's forward and backward, K1, K5's forward,
inverse and backward) of one checkout, on a CUDA card, and digest K5's
outputs.

    python3 tools/time_kernels.py [CHECKOUT] [LABEL]

CHECKOUT (default: the repository this script is in) is put first on the
import path, so two versions of the kernels can be compared in one call to
the card: unpack the other version with ``git archive`` into a directory
that .gitignore lists and run old, new, new, old. Prints, per built
library, its registers and spills (nvcc's report when this run built it)
and each kernel instance's registers, stack and shared memory, and the
count of generic loads (``LD.E``) in its SASS (cuobjdump from the CUDA
toolkit), then one JSON line of
device milliseconds (one call captured in a CUDA graph and replayed,
median) of the forward, the forward that saves the layer inputs, and the
backward, at nsf6, d=10 (n=256, 1024, 4096) and d=50 (n=4096), and of K1
at d=10 and 50 with n=256 (the sweep), 4096 (the evidence draws) and 1
(its chain). Then one JSON line a K5 shape (chip_smoke's ``MENU_SHAPES``
of nsfc6 at d=10 and nsfc12 at d=50, and the training batch at d=50,
n=1024): the device milliseconds of the forward, the inverse and (n <=
4096) the backward, one eager call of each (CUDA events around it), and
a SHA-256 of each one's output bytes, from weights
and inputs drawn with a fixed numpy seed, so two checkouts' digests say
whether they give the same bits.
"""

import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

CHECKOUT = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1])
LABEL = sys.argv[2] if len(sys.argv) > 2 else "this"
sys.path.insert(0, CHECKOUT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def cuda_ms(fn, reps, warmup=3):
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


def graph_ms(fn, reps):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps, warmup=1)


def main():
    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a CUDA device")
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import _build
    from pocomc_tpu_torch.ops import flow_kernels as fk
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in ("made_rqs_forward", "made_rqs_backward", "ar_inverse", "coupling_forward",
                 "coupling_backward"):
        path, report = _build.build(name)
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True)
        usage = subprocess.run([cuobjdump, "-res-usage", str(path)], capture_output=True,
                               text=True)
        print(json.dumps({"label": LABEL, "library": name,
                          "ptxas": [l.strip() for l in report.splitlines()
                                    if "registers" in l or "spill" in l],
                          "resources": [l.strip() for l in usage.stdout.splitlines()
                                        if "REG:" in l] if usage.returncode == 0 else None,
                          "generic_loads": sass.stdout.count("LD.E ")
                          if sass.returncode == 0 else None}), flush=True)
    out = {"label": LABEL}
    for d, n in ((10, 1), (10, 256), (10, 1024), (10, 4096), (50, 1), (50, 256), (50, 4096)):
        rng = np.random.default_rng(d)
        flow = Flow(d, "nsf6", device="cuda")
        with torch.no_grad():
            w = flow.weights[-1]
            w.copy_(torch.from_numpy(0.02 * rng.standard_normal(w.shape)))
            fp = flow.params()
            y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
            reps = 10 if d == 50 else 50
            out[f"k1_d{d}_n{n}"] = graph_ms(
                lambda: fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders), reps)
            if n in (1, 256):
                continue
            g_z = torch.randn(n, d, device="cuda")
            g_l = torch.randn(n, device="cuda")
            saved = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True)[2]
            out[f"fwd_d{d}_n{n}"] = graph_ms(lambda: fk.made_rqs_forward(y, fp.ws, fp.bs), reps)
            out[f"fwd_save_d{d}_n{n}"] = graph_ms(
                lambda: fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True), reps)
            out[f"bwd_d{d}_n{n}"] = graph_ms(
                lambda: fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, saved), reps)
    print(json.dumps(out), flush=True)
    for arch, d, n in K5_SHAPES:
        print(json.dumps({"label": LABEL, "flow": arch, "d": d, "n": n, **time_k5(arch, d, n)}),
              flush=True)


# (flow, d, n) of K5's digests and times
K5_SHAPES = [("nsfc6", 10, 37), ("nsfc6", 10, 256), ("nsfc6", 10, 1024), ("nsfc6", 10, 4096),
             ("nsfc12", 50, 256), ("nsfc12", 50, 1024), ("nsfc12", 50, 4096),
             ("nsfc12", 50, 65536)]


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k5(arch, d, n):
    """K5 at one shape: a flow at its seed-0 init with N(0, (0.02 sqrt(32 /
    h))^2) output weights and N(0, 0.02^2) biases (chip_smoke's menu
    flows), inputs and upstream gradients from a numpy seed."""
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import coupling_kernels as ck
    rng = np.random.default_rng(1000 * d + 7)
    flow = Flow(d, arch, seed=0, device="cuda")
    scale = 0.02 * math.sqrt(32 / flow.n_hidden)
    out = {}
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(flow.weights, flow.biases)):
            if l % 4 == 3:
                w.copy_(torch.from_numpy(scale * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
        fp = flow.params()
        a = (fp.ws, fp.bs, fp.masks)
        y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        reps = 10 if d == 50 else 50
        out["forward_sha"] = digest(ck.coupling_forward(y, *a))
        out["inverse_sha"] = digest(ck.coupling_inverse(y, *a))
        out["forward_ms"] = graph_ms(lambda: ck.coupling_forward(y, *a), reps)
        out["inverse_ms"] = graph_ms(lambda: ck.coupling_inverse(y, *a), reps)
        out["forward_call_ms"] = cuda_ms(lambda: ck.coupling_forward(y, *a), reps)
        out["inverse_call_ms"] = cuda_ms(lambda: ck.coupling_inverse(y, *a), reps)
        if n <= 4096:
            g_z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
            g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
            _, _, acts = ck.coupling_forward(y, *a, save_inputs=True)
            out["saved_sha"] = digest(acts)
            g_x, g_ws, g_bs = ck.coupling_backward(y, *a, g_z, g_l, acts)
            out["backward_sha"] = digest([g_x, *[t for g in g_ws + g_bs for t in g]])
            out["backward_ms"] = graph_ms(
                lambda: ck.coupling_backward(y, *a, g_z, g_l, acts), reps)
            out["backward_call_ms"] = cuda_ms(
                lambda: ck.coupling_backward(y, *a, g_z, g_l, acts), reps)
    return out


if __name__ == "__main__":
    main()
