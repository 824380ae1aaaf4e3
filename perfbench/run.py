"""The benchmark of pocomc_tpu_torch: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result (README.md).
"""

import os
import sys
import time

T_START = time.perf_counter()


def _process_age():
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


ORIGIN = T_START - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every cache a library may keep, at fixed paths inside the checkout (the
# program's own kernel libraries go to build/pocomc_tpu_torch/), made here:
# torch keeps no cache in a directory that is missing
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
    os.makedirs(os.environ[_var], exist_ok=True)

# load from one process with few threads: every array the program computes
# on lives on the card, so torch's and the BLAS libraries' host thread pools
# keep one thread and do not compete with the thread that paces the card
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ORIGIN))
