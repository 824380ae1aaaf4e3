"""Seconds of the kernel build on a card's host, and whether nvcc's
``--split-compile`` keeps the code.

Usage (from the repository root, on the machine with the card)::

    python3 tools/build_times.py [pool|split|solo]

``pool`` builds chip_smoke's 18 libraries (``LIBRARIES`` at every
``LIBRARY_BINS``) into a temporary directory with as many workers as the
host has cores, the backward sources first (``POOL_ORDER``), and prints
each library's start and seconds and the wall. ``split`` builds them twice,
all at once each time, with the flags of ``ops/_build.py`` and with
``--split-compile=0`` added, and prints both walls, each library's seconds
and ptxas summary, and whether each pair's SASS (``cuobjdump -sass``) is
the same. ``solo`` builds K2-bwd's library of run-time bins alone, plainly
and with ``--split-compile=4``, and compares their SASS. Prints one JSON
line a result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from pocomc_tpu_torch.ops import _build  # noqa: E402

# (source, bins) in the order the pool starts them: the backward sources,
# whose builds take longest, first
POOL_ORDER = [("made_rqs_backward", 0), ("coupling_backward", 0), ("made_rqs_backward", 16),
              ("coupling_backward", 16), ("made_rqs_backward", 8), ("coupling_backward", 8),
              ("ar_inverse_backward", 0), ("ar_inverse_backward", 16), ("ar_inverse_backward", 8),
              ("coupling_forward", 0), ("coupling_forward", 16), ("coupling_forward", 8),
              ("ar_inverse", 0), ("ar_inverse", 16), ("ar_inverse", 8),
              ("made_rqs_forward", 0), ("made_rqs_forward", 16), ("made_rqs_forward", 8)]


def compile_one(out_dir, name, bins, extra=()):
    """nvcc of one library into out_dir: (seconds, return code, report)."""
    out = Path(out_dir) / f"{name}_{bins}_{len(extra)}.so"
    t0 = time.perf_counter()
    p = subprocess.run([_build._nvcc(), *_build.flags(bins), *extra, "-o", str(out),
                        str(_build.CSRC / f"{name}.cu")], capture_output=True, text=True)
    return time.perf_counter() - t0, p.returncode, p.stdout + p.stderr, out


def sass(lib):
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout


def pool(out_dir):
    jobs = POOL_ORDER
    t0 = time.perf_counter()

    def one(job):
        start = time.perf_counter() - t0
        sec, rc, _, _ = compile_one(out_dir, *job)
        return f"{job[0]}_{job[1]}", dict(start=round(start, 2), seconds=round(sec, 2), rc=rc)

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        libs = dict(ex.map(one, jobs))
    print(json.dumps(dict(mode="pool", workers=os.cpu_count(),
                          wall=round(time.perf_counter() - t0, 2), libs=libs)), flush=True)


def split(out_dir):
    jobs = [(n, b) for b in chip_smoke.LIBRARY_BINS for n in chip_smoke.LIBRARIES]
    built = {}
    for extra in ((), ("--split-compile=0",)):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as ex:
            res = list(ex.map(lambda j: compile_one(out_dir, *j, extra), jobs))
        built[extra] = [r[3] for r in res]
        print(json.dumps(dict(mode="split", extra=list(extra), wall=round(time.perf_counter() - t0, 2),
                              libs={f"{n}_{b}": dict(seconds=round(r[0], 2), rc=r[1],
                                                     resources=chip_smoke.ptxas_summary(r[2]))
                                    for (n, b), r in zip(jobs, res)})), flush=True)
    print(json.dumps(dict(mode="split", sass_equal={
        f"{n}_{b}": sass(a) == sass(s) for (n, b), a, s in zip(jobs, *built.values())})),
        flush=True)


def solo(out_dir):
    runs = [compile_one(out_dir, "made_rqs_backward", 0, extra)
            for extra in ((), ("--split-compile=4",))]
    print(json.dumps(dict(mode="solo", seconds=[round(r[0], 2) for r in runs],
                          rc=[r[1] for r in runs],
                          sass_equal=sass(runs[0][3]) == sass(runs[1][3]))), flush=True)


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        {"pool": pool, "split": split, "solo": solo}[sys.argv[1] if len(sys.argv) > 1
                                                     else "pool"](d)
