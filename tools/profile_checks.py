"""cProfile of chip_smoke's slowest kernel checks of phase 14 (b), on a
card: each check at its shape and bins on its random flow
(``chip_smoke.bins_flow``), the 28 costliest calls by cumulative time.

Usage (from the repository root, on the machine with the card)::

    python3 tools/profile_checks.py

The libraries are built at first use, one at a time; a chip_smoke run in
the same checkout builds them first, all at once.
"""

import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

# (family, flow, d, n, bins)
CASES = [("check_spline_made", "nsf3", 342, 64, 32), ("check_spline_made", "nsf6", 50, 1024, 32),
         ("check_spline_made", "nsf6", 10, 4096, 32), ("check_gradient", "nsf6", 50, 1024, 32),
         ("check_gradient", "nsfc12", 50, 1024, 32), ("check_menu", "nsfc12", 50, 1024, 32),
         ("check_gradient", "nsf6", 10, 256, 1000), ("check_spline_made", "nsf6", 10, 256, 1000),
         ("check_spline_made", "nsf3", 342, 64, 16)]


def main():
    for family, name, d, n, bins in CASES:
        flow, rng = c.bins_flow(name, d, bins)
        args = (name, d, n, flow, rng) + ((c.TOL[d],) if family == "check_menu" else ())
        kw = dict(grad_rows=1024) if family == "check_menu" else {}
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        getattr(c, family)(*args, **kw)
        torch.cuda.synchronize()
        prof.disable()
        print(f"=== {family} {name} d={d} n={n} bins={bins}: {time.perf_counter() - t0:.2f} s",
              flush=True)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(28)
        print("\n".join(out.getvalue().splitlines()[6:40]), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("profile_checks: needs a CUDA device")
    main()
