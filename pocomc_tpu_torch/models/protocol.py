"""The preconditioner protocol: what ``Sampler(flow=...)`` asks of a flow.

Counterpart of ``docs/flows.md`` "Custom flows". The stock ``Flow`` is one
implementation; any object with these members is another, and the sampler
reaches every flow through them alone:

- ``params`` (a method, or an attribute of tensors): the parameters
  ``fp`` that the kernel members take;
- ``kernel_fwd(u, fp=None)`` and ``kernel_inv(theta, fp=None)``: u ->
  theta and back, both reporting log|det du/dtheta|; for ``mala``/``hmc``
  ``kernel_inv`` must be differentiable by autograd in ``theta``;
- ``forward(u, fp=None)``: u -> (theta, log|det dtheta/du|);
- ``sample(size, generator=None, fp=None)``: (u, log q(u)) of draws;
- ``fit(x, weights=None, **train_config, seed=None, mesh=None)``: the
  weighted fit, with every ``train_config`` key.

``DEVICE_SURFACE`` names what the device loop calls beyond them (phase B's
pre-layer fit and ``fit_stack``, and the evidence's latent draws): a flow
that lacks any of it runs the host loop. ``T_LATENT`` is the optional
Student-t draw that ``evidence_proposal='t'``/``'auto'`` needs. The JAX
package's ``_config_key`` names a program-cache entry; the port compiles
nothing, so it is neither read nor required.

Checkpoints save a stock ``Flow`` in the JAX package's layout (``pre`` and
``stack``, read by ``convert.load_flow_params``); any other flow by its
``state_dict()``/``load_state_dict()`` (an ``nn.Module``, or an object that
has both), else by its ``params`` attribute, which is set back on load.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import load_flow_params
from ..parallel.mesh import same_device, tree_map
from .flow import Flow

DEVICE_SURFACE = ("parameters", "_loss_fn", "get_pre", "set_pre", "whiten", "whiten_mode",
                  "_latent_draws")
T_LATENT = "sample_t"


def device_ready(flow) -> bool:
    """True if ``flow`` has every member of ``DEVICE_SURFACE``."""
    return all(hasattr(flow, a) for a in DEVICE_SURFACE)


def flow_params(flow):
    """The parameters ``fp`` the kernel members take: ``flow.params()`` for
    a method, the attribute itself otherwise."""
    p = flow.params
    return p() if callable(p) else p


def tensors(tree) -> list:
    """Every tensor of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(lambda a: out.append(a) if torch.is_tensor(a) else None, tree)
    return out


def _state_route(flow):
    if hasattr(flow, "state_dict") and hasattr(flow, "load_state_dict"):
        return "state_dict"
    if not callable(getattr(flow, "params", None)) and hasattr(flow, "params"):
        return "params"
    raise TypeError(f"a checkpoint of the custom flow {type(flow).__name__} needs its "
                    f"state_dict()/load_state_dict() or a params attribute of tensors "
                    f"(see pocomc_tpu_torch.models.protocol)")


def flow_state(flow) -> dict:
    """The flow's parameters in plain numpy (``Sampler.state_dict``)."""
    numpy = lambda t: t.detach().cpu().numpy()
    if isinstance(flow, Flow):
        return dict(pre={k: numpy(v) for k, v in flow.get_pre().items()},
                    stack=flow.stack_numpy())
    if _state_route(flow) == "state_dict":
        return dict(state_dict={k: numpy(v) for k, v in flow.state_dict().items()})
    return dict(params=tree_map(numpy, flow.params))


def load_flow_state(flow, state, device):
    """Put ``flow_state``'s parameters back into ``flow`` (a ``params``
    attribute onto ``device``)."""
    if isinstance(flow, Flow):
        load_flow_params(flow, state)
    elif "state_dict" in state:
        flow.load_state_dict({k: torch.as_tensor(np.asarray(v))
                              for k, v in state["state_dict"].items()})
    else:
        flow.params = tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device),
                               state["params"])


def replicate_flow(flow, mesh):
    """Every rank's flow to rank 0's floating-point parameters and buffers
    (``ParticleMesh.replicate``)."""
    if _state_route(flow) == "state_dict":
        sd = dict(flow.state_dict())
        floats = {k: v for k, v in sd.items() if v.is_floating_point()}
        flow.load_state_dict({**sd, **mesh.replicate(floats)})
    else:
        flow.params = mesh.replicate(flow.params)


def to_device(flow, device):
    """An ``nn.Module`` flow moved to ``device``; any other flow as it is,
    after checking that the tensors of its parameters are there."""
    if isinstance(flow, torch.nn.Module):
        return flow.to(device)
    off = [t.device for t in tensors(flow_params(flow)) if not same_device(t.device, device)]
    if off:
        raise ValueError(f"the flow's parameters lie on {off[0]}, not on the sampler's "
                         f"device {device}: move them there, or pass an nn.Module, which "
                         f"the sampler moves itself")
    return flow
