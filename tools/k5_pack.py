"""What K5's weight repack costs and what the kernels take, on a CUDA card.

    python3 tools/k5_pack.py

The wrapper repacks the output layers (forward) and every W^T (backward)
so that each slab the kernels' producer warp copies is one bulk copy
(``ops.coupling_kernels._packed``). The repack is redone whenever a
weight changes, so a training step pays it twice (the forward's and the
backward's pack) and a sweep once. For nsfc6 at d=10, 20 and 30 (h=32,
64, 128) and nsfc12 at d=50 (h=256) this prints:

  * the device milliseconds of the forward, inverse and backward at
    n=1024 (one call captured in a CUDA graph and replayed, median of 20);
  * the wall milliseconds of building both packs after a weight changed
    in place (median of 20, synchronised);
  * the wall milliseconds of a training step at batch 1024 (the loss,
    its backward, the gradient-norm clip and an AdamW step, as
    ``models.flow.fit_stack`` takes it; 30 steps after 5 of warmup, one
    synchronisation at the end), each step repacking.

Prints the card's name and power limit, then one JSON line a flow, twice.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from time_kernels import graph_ms  # noqa: E402

SHAPES = [("nsfc6", 10), ("nsfc6", 20), ("nsfc6", 30), ("nsfc12", 50)]
N = 1024


def measure(arch, d):
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import coupling_kernels as ck
    rng = np.random.default_rng(d)
    flow = Flow(d, arch, seed=0, device="cuda")
    x = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32)).cuda()
    w = torch.full((N,), 1.0 / N, device="cuda")
    fp = flow.params()
    g_z, g_l = torch.randn(N, d, device="cuda"), torch.randn(N, device="cuda")
    cfg = ck._k5_config(N, d, flow.n_hidden, False)
    out = {"plan": cfg._asdict()}
    with torch.no_grad():
        acts = ck.coupling_forward(x, fp.ws, fp.bs, fp.masks, save_inputs=True)[2]
        out["forward_ms"] = graph_ms(lambda: ck.coupling_forward(x, fp.ws, fp.bs, fp.masks), 20)
        out["inverse_ms"] = graph_ms(lambda: ck.coupling_inverse(x, fp.ws, fp.bs, fp.masks), 20)
        out["backward_ms"] = graph_ms(
            lambda: ck.coupling_backward(x, fp.ws, fp.bs, fp.masks, g_z, g_l, acts), 20)
        layers = ck._layers(fp.ws, fp.bs)
        plans = [cfg, ck._k5_config(N, d, flow.n_hidden, True)]
        times = []
        for _ in range(20):
            fp.ws[0][1].add_(0.0)  # a new version: the packs are stale
            torch.cuda.synchronize()
            start = time.perf_counter()
            ck._packed(layers, fp.ws, plans[0], d, flow.n_hidden, False)
            ck._packed(layers, fp.ws, plans[1], d, flow.n_hidden, False)
            ck._packed(layers, fp.ws, plans[1], d, flow.n_hidden, True)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - start))
        out["repack_wall_ms"] = statistics.median(times)
    params = list(flow.parameters())
    opt = torch.optim.AdamW(params, lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        flow._loss_fn(x, w).backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        opt.step()

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(30):
        step()
    torch.cuda.synchronize()
    out["train_step_wall_ms"] = 1e3 * (time.perf_counter() - start) / 30
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("k5_pack: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown", flush=True)
    for run in range(2):
        for arch, d in SHAPES:
            row = {"flow": arch, "d": d, "n": N, "run": run}
            row.update(measure(arch, d))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
