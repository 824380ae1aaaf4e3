"""Where K5's forward time goes, by removing its parts one at a time and by
trying other tiles, on a CUDA card.

    python3 tools/k5_breakdown.py

Builds ``pocomc_tpu_torch/csrc/coupling_forward.cu`` as it is and in
variants with a part taken out (their results are wrong; only their times
count):

  * ``no_products``: no FMAs in the register tiles (the fragments are not
    loaded either; the ring, the epilogues and the splines still run);
  * ``no_spline``: x + p[1] in place of the spline, p[0] as its log-det;
  * ``no_copies``: the producer warp fills no stage (the consumers read
    whatever the ring holds);
  * ``no_products_no_copies``: both, leaving the barriers, the epilogues
    and the splines.

Each variant is compiled by nvcc with the package's flags into
``build/pocomc_tpu_torch/variants/`` and launched through its C entry
point on the nsfc12 stack at d=50 (h=256, the menu's random output
layers), the inverse at n=65,536 (the bench line) and n=4096, on the tile
``_k5_config`` plans; the build as it is also on other tiles (BM rows a
block, BK-row slabs, S stages). Prints the card's name and
power limit, then one JSON line a shape of milliseconds per launch (CUDA
events around 10 launches after 2 of warmup, median).
"""

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FMA = "      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);"
SPLINE = "        *x = INVERSE ? RqsHead::inverse(*x, p, &lg) : RqsHead::forward(*x, p, &lg);"
COPIES = [
    ("            mbar_expect(bar, 4u * (uint32_t)(bk * ldn));\n"
     "            bulk_copy(dst, packed + (size_t)k0 * ldn, 4u * (uint32_t)(bk * ldn), bar);",
     "            mbar_expect(bar, 0u);"),
    ("          if (lane == 0) mbar_expect(bar, 4u * (uint32_t)(bk * q.no));",
     "          if (lane == 0) mbar_expect(bar, 0u);"),
    ("            if (lane == 0) bulk_copy(dst, src, 4u * (uint32_t)(bk * N), bar);",
     "            ;"),
    ("              bulk_copy(dst + kk * ldn, src + (size_t)kk * N, 4u * (uint32_t)q.no, bar);",
     "              ;"),
]
NO_FMA = (FMA, "      for (int c = 0; c < RN; ++c) {}")
VARIANTS = {
    "as_is": [],
    "no_products": [NO_FMA],
    "no_spline": [(SPLINE, "        lg = p[0]; *x = *x + p[1];")],
    "no_copies": COPIES,
    "no_products_no_copies": [NO_FMA] + COPIES,
}
TILES = [(64, 32), (64, 16), (64, 8), (32, 32), (32, 16)]  # (BM, BK)


def build(name, nvcc, flags, csrc, out_dir):
    work = Path(tempfile.mkdtemp(dir=out_dir))
    for f in csrc.iterdir():
        shutil.copy(f, work / f.name)
    texts = {src: (work / src).read_text() for src in ("coupling_tile.cuh", "coupling_forward.cu")}
    for old, new in VARIANTS[name]:
        hits = [src for src, text in texts.items() if old in text]
        if not hits:
            raise SystemExit(f"k5_breakdown: {name}: no '{old.strip()[:50]}' in csrc")
        for src in hits:
            texts[src] = texts[src].replace(old, new)
    for src, text in texts.items():
        (work / src).write_text(text)
    lib = out_dir / f"libcoupling_forward_{name}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(work / "coupling_forward.cu")],
                          capture_output=True, text=True)
    shutil.rmtree(work)
    if proc.returncode != 0:
        raise SystemExit(f"k5_breakdown: nvcc failed for {name}:\n{proc.stderr}")
    return name, lib


def ms(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("k5_breakdown: needs a CUDA device")
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import _build, coupling_kernels as ck
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown", flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(ex.map(lambda v: build(v, nvcc, _build.NVCC_FLAGS, _build.CSRC, out_dir),
                           VARIANTS))
    d, T = 50, 12
    rng = np.random.default_rng(0)
    flow = Flow(d, "nsfc12", seed=0, device="cuda")
    h = flow.n_hidden
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(flow.weights, flow.biases)):
            if l % 4 == 3:
                w.copy_(torch.from_numpy(0.02 * math.sqrt(32 / h) * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    fp = flow.params()
    layers = ck._layers(fp.ws, fp.bs)
    table = ck._table(0, tuple(a.data_ptr() for a in layers))
    P, I = ctypes.c_void_p, ctypes.c_int
    for n in (65536, 4096):
        y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        out, ladj = torch.empty_like(y), torch.empty(n, device="cuda")
        plan = ck._k5_config(n, d, h, False)
        w3 = ck._packed(layers, fp.ws, plan, d, h, False)
        row = {"d": d, "n": n, "flow": "nsfc12", "plan": plan._asdict()}
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).coupling_forward_launch
            fn.argtypes = [P, P, P, I, I, I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
            fn.restype = I
            tiles = [("plan", plan, w3)]
            if name == "as_is":
                for bm, bk in TILES:
                    for S in range(8, 1, -1):
                        c = plan._replace(BM=bm, RM=bm // 8, BK=bk, S=S)
                        if 4 * ck._k5_smem_floats(4, bm, c.RNH, c.RNO, c.G, bk, S, d, h,
                                                  False) <= 227 * 1024:
                            tiles.append((f"bm{bm}_bk{bk}_s{S}", c, w3))
                            break
            for label, c, pack in tiles:
                def call(c=c, pack=pack):
                    err = fn(y.data_ptr(), out.data_ptr(), ladj.data_ptr(), n, d, h, T,
                             table.data_ptr(), pack.data_ptr(),
                             None, None, None, None, 1, c.RL, c.BM, c.RNH, c.RNO, c.G, c.BK,
                             c.S, 0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"k5_breakdown: {name} {label}: cudaError {err}")
                row[f"{name}/{label}"] = ms(call)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
