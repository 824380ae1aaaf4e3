"""Candidate cuts of chip_smoke's full-width quickstart runs, on a card:
the quickstart with ``flow="nsfc6"``, ``"maf6"`` and ``sample="mala"``
(phases 12 (a) and 13 (b)) at smaller sizes, seeds 0-2, each held to the
phases' gate (-21.4021 +- 0.35).

Usage (from the repository root, on the machine with the card)::

    python3 tools/cut_seeds.py [nsfc6 maf6 mala]

Prints one JSON line a run: the cut, the run, the seed, logZ and its
error, calls, iterations, wall, whether it passes the gate, and the
launches of every kernel.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
import pocomc_tpu_torch as pt  # noqa: E402
from pocomc_tpu_torch.ops import flow_kernels as fk  # noqa: E402

# the cuts: the Sampler's sizes and run()'s
CUTS = {"A": (dict(n_effective=256, n_active=128), dict(n_total=2048, n_evidence=2048)),
        "B": (dict(n_effective=256, n_active=128), dict(n_total=1024, n_evidence=1024))}


def main(labels):
    prior = c.quickstart_prior(pt)
    for cut, (skw, rkw) in CUTS.items():
        for label in labels:
            kw = dict(sample="mala") if label == "mala" else dict(flow=label)
            for seed in (0, 1, 2):
                s = pt.Sampler(prior, c.quickstart_like, vectorize=True, random_state=seed,
                               device="cuda", **kw, **skw)
                c.reset_launches(fk)
                t0 = time.perf_counter()
                s.run(progress=False, **rkw)
                torch.cuda.synchronize()
                print(json.dumps(dict(cut=cut, run=label, seed=seed, logz=s.logz,
                                      dlogz=s.logz_err, calls=s.calls, iterations=s.t,
                                      wall_s=time.perf_counter() - t0,
                                      gate=abs(s.logz - c.TRUE_LOGZ) < c.LOGZ_GATE,
                                      launches=c.read_launches(fk, c.KERNELS))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("cut_seeds: needs a CUDA device")
    main(sys.argv[1:] or ["nsfc6", "maf6", "mala"])
