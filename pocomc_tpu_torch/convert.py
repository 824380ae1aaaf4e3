"""Parameters of the JAX package (as numpy arrays) -> the port's.

Lets the same trained or random weights run through both packages: the
parity tests, and anyone moving a fitted flow, or a whole saved run
(``state_from_jax``), from ``pocomc_tpu`` to the port. Inputs are plain
numpy (``jax.device_get`` of the JAX pytrees), so this module imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device=None):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def load_flow_params(flow, params):
    """Copy a JAX ``Flow.params`` tree into the torch ``flow`` in place.

    ``params = {"pre": {mean, w_fwd, w_inv, ladj}, "stack": ...}``
    (``pocomc_tpu/models/flow.py:245-258``). A masked-autoregressive
    flow's (maf*, nsf*) stack is four layers {"w": (T, fi, fo), "b": (T,
    fo)}, the layout the port keeps; a coupling flow's (nsfc*) is T lists
    of four {"w": (fi, fo), "b": (fo,)}, the port's ``weights[4t + l]``.
    Returns ``flow``."""
    stack = params["stack"]
    if flow.kind == "nsfc":
        if len(stack) != flow.n_transforms or any(len(tp) != 4 for tp in stack):
            raise ValueError(f"expected {flow.n_transforms} transforms of four layers for "
                             f"a coupling flow")
        layers = [layer for tp in stack for layer in tp]
    else:
        layers = stack
    if len(layers) != len(flow.weights):
        raise ValueError(f"{len(layers)} layers for a flow with {len(flow.weights)}")
    dev = flow.weights[0].device
    with torch.no_grad():
        for l, layer in enumerate(layers):
            for dst, key in ((flow.weights[l], "w"), (flow.biases[l], "b")):
                src = _tensor(layer[key], dev)
                if src.shape != dst.shape:
                    raise ValueError(f"layer {l} {key}: {tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    flow.set_pre({k: np.asarray(v, np.float32) for k, v in params["pre"].items()})
    return flow


def tensors_from_jax(arrays, device="cuda"):
    """A flat dict of JAX arrays -> fp32 tensors on ``device``: the geometry
    dict (``pocomc_tpu/models/geometry.py:135-144``: normal_mean/cov/chol,
    t_mean/cov/nu/chol/inv_cov) or the scaler's ``whitening_params()``
    (mu/sigma, or mu/L/L_inv/log_det_L). The card by default, as ``Flow``
    and ``Sampler``: without one it raises unless given ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tensors_from_jax(device='cuda') needs a CUDA device; pass "
                           "device='cpu' for CPU tensors.")
    return {k: _tensor(v, device) for k, v in arrays.items()}


def state_from_jax(state):
    """The JAX package's ``Sampler.state_dict()`` (numpy leaves) -> the
    port's, for ``Sampler.load_state_dict``: the same scalars, history,
    prior draws, current population, scaler and flow parameters (which
    ``load_flow_params`` reads as they are); the sweep's geometry is the
    JAX ``theta_geometry`` with the flow and ``u_geometry`` without, which
    ``load_state_dict`` puts on the device through ``tensors_from_jax``.
    A JAX key cannot become a torch generator's state: the state carries
    none, so ``load_state_dict`` seeds the torch generator from the
    restored numpy generator, and a run resumed from it draws other
    random numbers than the JAX run would have."""
    out = {k: v for k, v in state.items()
           if k not in ("jax_key", "u_geometry", "theta_geometry")}
    out["geometry"] = state["theta_geometry" if state["preconditioned"] else "u_geometry"]
    out["torch_generator"] = None
    return out
