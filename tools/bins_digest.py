"""SHA-256 digests of every spline kernel's outputs at given bins, for
comparing two checkouts bit for bit on a CUDA card.

Usage (from the repository root, on a card)::

    python3 tools/bins_digest.py <checkout> <label> [bins ...]

``<checkout>`` is the tree whose ``pocomc_tpu_torch`` is imported (``.``,
or a ``git archive`` of another commit unpacked under ``build/``), bins
default to 8 and 16. For each bins it builds that checkout's libraries
and prints one JSON line: the digest of the outputs of K2's forward (z,
ladj and the saved layer inputs), K2-bwd (g_y, weight and bias gradients),
K1 at 256, 2048 and 4096 rows (one-, two- and four-row warps), K1-bwd,
K5's forward, inverse and backward and K5-inv-bwd, on nsf6 / nsfc6 flows
at d=10 with N(0, 0.02^2) weights and inputs drawn from a fixed numpy
seed. Equal digests of two checkouts mean equal bits.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

CHECKOUT = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1])
LABEL = sys.argv[2] if len(sys.argv) > 2 else "this"
BINS = [int(b) for b in sys.argv[3:]] or [8, 16]
sys.path.insert(0, CHECKOUT)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def random_flow(Flow, arch, bins, seed):
    rng = np.random.default_rng(seed)
    flow = Flow(10, arch, bins=bins, device="cuda")
    with torch.no_grad():
        for w in (*flow.weights, *flow.biases):
            w.copy_(torch.from_numpy(0.02 * rng.standard_normal(tuple(w.shape))))
    return flow, rng


def main():
    if not torch.cuda.is_available():
        sys.exit("bins_digest: needs a CUDA device")
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    for bins in BINS:
        out = {"label": LABEL, "bins": bins}
        flow, rng = random_flow(Flow, "nsf6", bins, bins)
        draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        with torch.no_grad():
            fp = flow.params()
            y, g_z, g_l = draw(1024, 10), draw(1024, 10), draw(1024)
            z, ladj, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, bins=bins)
            out["k2"] = digest([z, ladj, *acts])
            g_y, g_ws, g_bs = fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts, bins=bins)
            out["k2_bwd"] = digest([g_y, *g_ws, *g_bs])
            for n in (256, 2048, 4096):
                out[f"k1_n{n}"] = digest(fk.ar_inverse(draw(n, 10), fp.ws, fp.bs, fp.inv_orders,
                                                       bins=bins))
            zz = draw(256, 10)
            x, _, state = fk._launch_inverse(zz, fp.ws, fp.bs, fp.inv_orders, save=True,
                                             bins=bins)
            out["k1_bwd"] = digest([fk.ar_inverse_backward(state, fp.ws, fp.bs, fp.inv_orders,
                                                           draw(256, 10), draw(256), bins=bins)])
        cflow, rng = random_flow(Flow, "nsfc6", bins, bins + 1)
        with torch.no_grad():
            cp = cflow.params()
            a = (cp.ws, cp.bs, cp.masks)
            y, g_z, g_l = draw(1024, 10), draw(1024, 10), draw(1024)
            z, ladj, acts = ck.coupling_forward(y, *a, save_inputs=True, bins=bins)
            out["k5"] = digest([z, ladj, *acts])
            out["k5_inverse"] = digest(ck.coupling_inverse(y, *a, bins=bins))
            g_x, g_ws, g_bs = ck.coupling_backward(y, *a, g_z, g_l, acts, bins=bins)
            out["k5_bwd"] = digest([g_x, *[t for g in g_ws + g_bs for t in g]])
            zz = y[:256].contiguous()
            _, _, state = ck._launch_stack(zz, *a, True, True, "coupling_inverse", bins)
            out["k5_inv_bwd"] = digest([ck.coupling_inverse_backward(
                state, *a, g_z[:256].contiguous(), g_l[:256].contiguous(), bins=bins)])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
