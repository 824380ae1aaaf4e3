"""The quickstart on a mesh of cards against one card, on one machine.

Run from the repository root on a machine with cards:

    python3 tools/measure_mesh.py --ranks 2 4

It builds the default kernel libraries, runs the 10-D Rosenbrock
quickstart (phase 6 of chip_smoke.py: nsf6, n_active 256, n_total 4096,
n_evidence 4096, seed 0) without a mesh on card 0, then, for each count
of ranks, ``parallel.smoke.launch`` with the harness's cases and the
quickstart (one process a card; NCCL when every rank has a card of its
own, gloo when ranks share one). It prints every card's name and power
limit, then one JSON line a run: logZ, calls, wall seconds, the kernels'
launches a rank, the most rows a sweep step's inverse took and the
all_reduce calls a sweep step. It exits non-zero if a run fails, a
quickstart leaves the logZ gate (-21.4021 +- 0.35) or the ranks disagree.
"""

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, ".")

import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[2])
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_mesh: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.ops import _build
    from pocomc_tpu_torch.parallel import smoke

    libs = ("made_rqs_forward", "made_rqs_backward", "ar_inverse", "ar_inverse_backward",
            "coupling_forward", "coupling_backward")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(_build.build, libs))
    print(json.dumps(dict(build_s=time.perf_counter() - t0)), flush=True)
    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    s = pt.Sampler(prior, smoke.rosenbrock, vectorize=True, random_state=0, device="cuda")
    t0 = time.perf_counter()
    s.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    print(json.dumps(dict(ranks=0, cards=torch.cuda.device_count(), logz=s.logz,
                          calls=s.calls, wall_s=time.perf_counter() - t0)), flush=True)
    ok = abs(s.logz - smoke.QUICKSTART_LOGZ) < 0.35
    for k in args.ranks:
        t0 = time.perf_counter()
        lines = smoke.launch(k, 1, timeout=args.timeout, cases="all,quickstart",
                             device="cuda")
        stats = [smoke.line_stats(ln) for ln in lines]
        q = stats[0]["quickstart"]
        print(json.dumps(dict(ranks=k, backend=stats[0]["backend"],
                              devices=[st["device"] for st in stats], launch_s=time.perf_counter() - t0,
                              **{key: q[key] for key in ("logz", "calls", "wall_s", "iterations",
                                                         "sweep_steps", "sweep_k1_rows_max",
                                                         "collectives_per_sweep_step")},
                              launches=[st["quickstart"]["launches"] for st in stats])),
              flush=True)
        ok &= abs(q["logz"] - smoke.QUICKSTART_LOGZ) < 0.35
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
