"""The flow's weights, made on the card from the seed in a few large calls.

``hidden: he_normal``: every hidden layer's weights N(0, 2 / fan_in), the
program's own scheme; ``output_std``: the output layer's N(0, std^2), 0 for
the program's identity start. Biases are 0. The draws go into the
``Flow``'s parameters in place, grouped by shape (one call a group)."""

from __future__ import annotations

import math

import torch


def init_flow(flow, spec, generator):
    groups = {}
    for i, w in enumerate(flow.weights):
        layer = i if flow.kind != "nsfc" else i % 4
        groups.setdefault((tuple(w.shape), layer == 3), []).append(w)
    with torch.no_grad():
        for (shape, output), ws in groups.items():
            fan_in = shape[-2]
            std = float(spec["output_std"]) if output else math.sqrt(2.0 / fan_in)
            draws = torch.randn((len(ws),) + shape, generator=generator,
                                device=ws[0].device, dtype=ws[0].dtype) * std
            for w, v in zip(ws, draws):
                w.copy_(v)
        for b in flow.biases:
            b.zero_()
    return flow
