"""Spans, counters and captures around the calls into each layer of
pocomc_tpu_torch, installed from the benchmark's side (the program is not
edited). What they record, per layer:

- phases (``phases.reweight`` / ``train`` / ``mutate``): host seconds and
  calls; phase A's inputs and outputs per iteration, phase C's stats
  vector per iteration (read after the window); the window's stop, raised
  at an iteration boundary (``StopWindow``);
- phase B's fits (``fit_stack``, ``Flow._loss_fn``,
  ``torch.nn.utils.clip_grad_norm_``): of each fit, the parameters at its
  start, its first ``TRAIN_STEPS`` optimizer steps' batches and losses,
  the first step's gradient as the backward left it (before the clip),
  K2's outputs in that step (its training instance), and the parameters
  as the fourth step finds them (after three steps); the last fit's are
  kept;
- kernels (the flow's entry points ``made_rqs_forward``, ``ar_inverse``,
  ``coupling_forward``, ``coupling_inverse``; K2's backward launch): rows
  a call and a span a call in a traced stretch (``mode``); the last call's
  operands and outputs;
- the sweep (``Sweep.accept_update``): the last accept step's state,
  proposal and result.

Keeping a reference to a tensor adds no device work; the copies are of
the flow's parameters (10 MB at gauss50) at a fit's start and after its
third step, and of its first gradient: three copies a fit, on the card.
Nothing here reads a tensor inside the window.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


# optimizer steps of each fit that the training check follows
TRAIN_STEPS = 3


def _leaves(flow):
    """The flow's trained tensors: its weights, then its biases."""
    return list(flow.weights) + list(flow.biases)


class StopWindow(Exception):
    """Raised at an iteration boundary once the window's time is up."""


class Hooks:
    def __init__(self):
        # the traced stretch running: None, "device" (the card's operations
        # alone; spans kept as host clock times) or "spans" (host operations
        # too; spans as profiler ranges, which it projects onto the device)
        self.mode = None
        self.deadline = None        # perf_counter time after which the loop stops
        self.on_boundary = None     # called at each iteration boundary with its index
        self.reset()

    def reset(self):
        self.phase_s = {"reweight": 0.0, "train": 0.0, "mutate": 0.0}
        self.iterations = 0
        self.phase_a = []           # one dict an iteration
        self.stats_c = []           # phase C's stats tensors, one an iteration
        self.fit = None             # the last fit's captures
        self._fit = None            # (flow, captures) of the fit running
        self.last = {}              # kernel name -> the last call's operands and outputs
        self.accept = None          # the last accept step
        self.rows = {"device": {}, "spans": {}}   # stretch -> kernel -> rows a call
        self.host_spans = []        # (name, start ns, end ns) in the device stretch
        self.fit_steps = []         # optimizer steps of each fit

    @contextmanager
    def span(self, name):
        if self.mode == "spans":
            with torch.profiler.record_function(f"perfbench/{name}"):
                yield
        elif self.mode == "device":
            t0 = time.time_ns()
            try:
                yield
            finally:
                self.host_spans.append((name, t0, time.time_ns()))
        else:
            yield

    def _count(self, kind, n):
        if self.mode is not None:
            self.rows[self.mode].setdefault(kind, []).append(int(n))

    # -- phases -------------------------------------------------------------

    def install(self):
        from pocomc_tpu_torch import phases
        from pocomc_tpu_torch.models import flow as flow_mod
        from pocomc_tpu_torch.mcmc import Sweep
        from pocomc_tpu_torch.ops import flow_kernels as fk
        self._orig = dict(reweight=phases.reweight, train=phases.train, mutate=phases.mutate,
                          fit_stack=phases.fit_stack,
                          made_rqs_forward=flow_mod.made_rqs_forward,
                          ar_inverse=flow_mod.ar_inverse,
                          coupling_forward=flow_mod.coupling_forward,
                          coupling_inverse=flow_mod.coupling_inverse,
                          k2_backward=fk._launch_backward,
                          accept_update=Sweep.accept_update,
                          loss_fn=flow_mod.Flow._loss_fn,
                          clip=torch.nn.utils.clip_grad_norm_)
        o = self._orig

        def reweight(hist, n_effective, n_total, resid_prev, *a, **k):
            if self.on_boundary is not None:
                self.on_boundary(self.iterations)
            if self.deadline is not None and self.iterations > 0 \
                    and time.perf_counter() >= self.deadline:
                raise StopWindow
            t0 = time.perf_counter()
            with self.span("reweight"):
                out = o["reweight"](hist, n_effective, n_total, resid_prev, *a, **k)
            self.phase_s["reweight"] += time.perf_counter() - t0
            self.phase_a.append(dict(hist=hist, t=int(hist.t), n_eff=n_effective,
                                     resid=resid_prev, beta=out["beta"],
                                     w_flat=out["w_flat"]))
            return out

        def train(*a, **k):
            t0 = time.perf_counter()
            with self.span("train"):
                geom, stats = o["train"](*a, **k)
            self.phase_s["train"] += time.perf_counter() - t0
            return geom, stats

        def mutate(*a, **k):
            t0 = time.perf_counter()
            with self.span("mutate"):
                stats = o["mutate"](*a, **k)
            self.phase_s["mutate"] += time.perf_counter() - t0
            self.stats_c.append(stats)
            self.iterations += 1
            return stats

        def fit_stack(flow, xt, wt, xv, wv, n_train, n_val, batch_size, *a, **k):
            cap = dict(before=[p.detach().clone() for p in _leaves(flow)], steps=[],
                       k2=None, grads=None, after=None, clips=0)
            self._fit = (flow, cap)
            try:
                out = o["fit_stack"](flow, xt, wt, xv, wv, n_train, n_val, batch_size, *a, **k)
            finally:
                self._fit = None
            self.fit = cap
            self.fit_steps.append(int(out[2]) * (xt.shape[0] // batch_size))
            return out

        def loss_fn(flow, xb, wb, *a, **k):
            loss = o["loss_fn"](flow, xb, wb, *a, **k)
            if self._fit is not None and torch.is_grad_enabled():
                steps = self._fit[1]["steps"]
                if len(steps) < TRAIN_STEPS:
                    steps.append(dict(x=xb, w=wb, loss=loss.detach()))
            return loss

        def clip(params, max_norm, *a, **k):
            if self._fit is not None:
                flow, cap = self._fit
                cap["clips"] += 1
                if cap["clips"] == 1:
                    cap["grads"] = [torch.zeros_like(p) if p.grad is None else
                                    p.grad.detach().clone() for p in _leaves(flow)]
                elif cap["clips"] == TRAIN_STEPS + 1:
                    cap["after"] = [p.detach().clone() for p in _leaves(flow)]
            return o["clip"](params, max_norm, *a, **k)

        def made_rqs_forward(y, ws, bs, *a, **k):
            train = torch.is_grad_enabled() and any(w.requires_grad for w in ws)
            self._count("k2_train" if train else "k2", y.shape[0])
            with self.span("k2"):
                out = o["made_rqs_forward"](y, ws, bs, *a, **k)
            if train and self._fit is not None:
                cap = self._fit[1]
                if not cap["steps"] and cap["k2"] is None:
                    cap["k2"] = dict(y=y, out=tuple(t.detach() for t in out))
            if not train:
                self.last["k2"] = dict(y=y, ws=list(ws), bs=list(bs), out=out,
                                       bins=k.get("bins", 8))
            return out

        def k2_backward(acts, *a, **k):
            self._count("k2_bwd", acts[0].shape[1])
            with self.span("k2bwd"):
                return o["k2_backward"](acts, *a, **k)

        def ar_inverse(z, ws, bs, inv_orders, *a, **k):
            self._count("k1", z.shape[0])
            with self.span("k1"):
                out = o["ar_inverse"](z, ws, bs, inv_orders, *a, **k)
            self.last["k1"] = dict(z=z, ws=list(ws), bs=list(bs), inv_orders=inv_orders,
                                   out=out, bins=k.get("bins", 8))
            return out

        def coupling_forward(x, ws, bs, masks, *a, **k):
            self._count("k5", x.shape[0])
            with self.span("k5"):
                return o["coupling_forward"](x, ws, bs, masks, *a, **k)

        def coupling_inverse(z, ws, bs, masks, *a, **k):
            self._count("k5inv", z.shape[0])
            with self.span("k5inv"):
                out = o["coupling_inverse"](z, ws, bs, masks, *a, **k)
            self.last["k5inv"] = dict(z=z, ws=[list(w) for w in ws], bs=[list(b) for b in bs],
                                      masks=list(masks), out=out, bins=k.get("bins", 8))
            return out

        def accept_update(sweep, st, prop, logl_p, beta, geom):
            new_st, acc = o["accept_update"](sweep, st, prop, logl_p, beta, geom)
            self.accept = dict(old=st, prop=prop, logl_p=logl_p, beta=beta,
                               nu=geom["t_nu"], new=new_st, d=st.u.shape[1],
                               preconditioned=sweep.preconditioned)
            return new_st, acc

        phases.reweight, phases.train, phases.mutate = reweight, train, mutate
        Sweep.accept_update = accept_update
        phases.fit_stack = fit_stack
        flow_mod.Flow._loss_fn = loss_fn
        torch.nn.utils.clip_grad_norm_ = clip
        flow_mod.made_rqs_forward, flow_mod.ar_inverse = made_rqs_forward, ar_inverse
        flow_mod.coupling_forward, flow_mod.coupling_inverse = coupling_forward, coupling_inverse
        fk._launch_backward = k2_backward
        return self

    def uninstall(self):
        """Put back every function ``install`` wrapped."""
        from pocomc_tpu_torch import phases
        from pocomc_tpu_torch.mcmc import Sweep
        from pocomc_tpu_torch.models import flow as flow_mod
        from pocomc_tpu_torch.ops import flow_kernels as fk
        o = self._orig
        phases.reweight, phases.train, phases.mutate = o["reweight"], o["train"], o["mutate"]
        phases.fit_stack = o["fit_stack"]
        for name in ("made_rqs_forward", "ar_inverse", "coupling_forward", "coupling_inverse"):
            setattr(flow_mod, name, o[name])
        fk._launch_backward = o["k2_backward"]
        Sweep.accept_update = o["accept_update"]
        flow_mod.Flow._loss_fn = o["loss_fn"]
        torch.nn.utils.clip_grad_norm_ = o["clip"]
