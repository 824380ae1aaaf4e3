"""Runs of one cell, one process after another, each its own seed, as the
benchmark's check runs them (``run.py``); writes each run's result line
and set-up seconds to ``--out`` (JSON lines) and prints a summary.

    python3 perfbench/sets.py --workload <cell> --seconds <s> --trace 0 --out <file> --seeds 1 2 3
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    values = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                               args.workload, "--seed", str(seed), "--seconds",
                               str(args.seconds), "--trace", str(args.trace)],
                              capture_output=True, text=True, cwd=os.path.dirname(HERE))
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        row = dict(seed=seed, rc=proc.returncode, wall_s=wall, earlier=lines[:-1],
                   stderr_tail=proc.stderr[-3000:])
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["result"] = None
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row["result"] or {}
        short = {k: v["value"] for k, v in res.get("metrics", {}).items()}
        counts = res.get("layer_counts", {})
        if not args.trace and counts.get("iterations") and "window_s" in res:
            # the window's host seconds an iteration, printed beside the metrics
            short["host_iter_s"] = res["window_s"] / counts["iterations"]
        for k, v in short.items():
            values.setdefault(k, []).append(v)
        print(json.dumps(dict(seed=seed, rc=proc.returncode, wall_s=round(wall, 1),
                              correct=res.get("correct"), metrics=short,
                              peak=res.get("device", {}).get("memory_peak_bytes"),
                              busy=res.get("device", {}).get("busy_s"),
                              win=res.get("device", {}).get("window_s"),
                              failed_checks={k: v for k, v in res.get("checks", {}).items()
                                             if not (v["limit"] is not None
                                                     and v["value"] <= v["limit"])})),
              flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
    for k, vs in values.items():
        if len(vs) >= 2:
            q = statistics.quantiles(vs, n=4)
            med = statistics.median(vs)
            print(f"{k}: median {med!r} iqr/median {(q[2] - q[0]) / med!r} n {len(vs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
