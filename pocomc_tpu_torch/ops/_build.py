"""Build and load the CUDA kernels of ``pocomc_tpu_torch/csrc``.

Each kernel file is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, into ``build/pocomc_tpu_torch/``
beside the package; the library's file name carries a hash of its sources
and flags, so an edited source is rebuilt and an unchanged one is reused.

The spline's bins are a compile-time constant of the sources up to 16
(``csrc/rqs.cuh`` BINS): a library is built for one (source, bins) pair,
the default 8 bins with the plain flags, any other with
``-DPOCOMC_BINS=<bins>`` and the bins in its file name, at the first use of
that bins. ``bins=0`` builds a source's library of run-time bins
(``-DPOCOMC_BINS=0``, ``_bN`` in its file name), which serves every bins
past 16. The affine head of the maf* flows, which has no bins, is compiled
into the default libraries only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pocomc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_HEADERS = ("rqs.cuh", "heads.cuh", "made_tile.cuh", "coupling_tile.cuh", "stack_backward.cuh",
            "ar_walk.cuh")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "pocomc_tpu_torch are built from source at first use.")


def flags(bins: int = 8) -> list:
    """nvcc's flags for a library of ``bins`` spline bins (0: run-time)."""
    return NVCC_FLAGS if bins == 8 else [*NVCC_FLAGS, f"-DPOCOMC_BINS={int(bins)}"]


def library_path(name: str, bins: int = 8) -> Path:
    """Path of the built library for ``csrc/<name>.cu`` at ``bins`` spline
    bins (content-hashed)."""
    h = hashlib.sha256(" ".join(flags(bins)).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    tag = name if bins == 8 else (f"{name}_bN" if bins == 0 else f"{name}_b{int(bins)}")
    return BUILD_DIR / f"lib{tag}-{h.hexdigest()[:16]}.so"


def build(name: str, bins: int = 8, nice: int = 0) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` for ``bins`` spline bins unless an
    up-to-date library exists; with ``nice``, nvcc and the compilers it
    starts run at that niceness (``nice -n``), below the caller's work.
    Returns (library path, nvcc's report; empty when nothing was built)."""
    out = library_path(name, bins)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags(bins), "-o", tmp, str(CSRC / f"{name}.cu")]
    if nice and shutil.which("nice"):
        cmd = ["nice", "-n", str(int(nice)), *cmd]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (bins={bins}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str, bins: int = 8) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` at ``bins`` spline bins
    (0: the library of run-time bins), built first if needed; raises if it
    reports other bins (a library of run-time bins reports 0)."""
    path, _ = build(name, bins)
    lib = ctypes.CDLL(str(path))
    lib.pocomc_spline_bins.restype = ctypes.c_int
    if lib.pocomc_spline_bins() != bins:
        raise RuntimeError(f"{path.name} holds the spline of {lib.pocomc_spline_bins()} bins "
                           f"(0: run-time bins), not {bins}")
    return lib
