"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs): for a cell and a list of seeds, in one process,
each seed's run of the cell (``harness.run_cell``: set-up, a window of
``--seconds``, the check) with every number the check compares as the
program gives it, as the control gives it (the reference one precision
below the configuration's, in the program's place;
``reference.check.precisions``) and as each fault the generator lists
gives it (``Run.FAULTS``), each judged by the cell's limits.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

One JSON line a seed on standard output, then the largest program reading
and the smallest control and fault readings of each number. Exits 1 unless
the program is correct and the control and every fault are not, on every
seed.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    largest, smallest, ok = {}, {}, True
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False, cuda=True, spec=spec,
                             calibrate=True)
        readings = {"program": r["checks"]}
        verdicts = {"program": r["correct"]}
        for mode, c in r["calibration"].items():
            readings[mode], verdicts[mode] = c["checks"], c["correct"]
        ok = ok and verdicts["program"] and not any(
            v for m, v in verdicts.items() if m != "program")
        print(json.dumps(dict(seed=seed, window_s=r["window_s"], metrics=r["metrics"],
                              counts=r["layer_counts"], setup_parts=r["setup_parts"],
                              correct=verdicts,
                              readings={m: {k: v["value"] for k, v in rows.items()}
                                        for m, rows in readings.items()})), flush=True)
        for k, v in r["checks"].items():
            largest[k] = max(largest.get(k, v["value"]), v["value"])
        for mode, rows in readings.items():
            if mode != "program":
                low = smallest.setdefault(mode, {})
                for k, v in rows.items():
                    low[k] = min(low.get(k, v["value"]), v["value"])
        del r
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"largest_program": largest, "smallest": smallest,
                      "program_correct_and_others_not_on_every_seed": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
