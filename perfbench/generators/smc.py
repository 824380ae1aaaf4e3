"""Traffic ``smc``: one ``Sampler.run()`` from the seed through the device
loop (phases A, B, C an iteration, one host read each). The window opens
at the call and closes at the first iteration boundary past ``--seconds``
(``hooks.StopWindow`` raised from the benchmark's wrapper of phase A, so
the program needs no switch). A traced run profiles two whole iterations
(``trace.Tracer``'s two stretches) from the first that starts past half
of the window (a window that ends inside them runs on to their end); its
phase counts are those of the iterations before them.

The mix has no parameters: the configuration's sampler settings and
``run`` arguments are the traffic."""

from __future__ import annotations

import time

import torch

from ..flowinit import init_flow
from ..hooks import StopWindow
from ..reference import check
from ..seeds import derive

# the share of the window after which a traced run starts its stretches
TRACE_START_SHARE = 0.5

# the flow families' libraries: those a sweep's flow calls, and those
# training adds (K2's backward)
LIBRARIES = {"nsf": (["made_rqs_forward", "ar_inverse"], ["made_rqs_backward"]),
             "nsfc": (["coupling_forward"], ["coupling_backward"])}


def libraries(cfg, mix):
    sample, train = LIBRARIES["nsfc" if cfg["flow"].startswith("nsfc") else "nsf"]
    return sample + train


def _sampler(ctx, seed, **extra):
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.models.flow import Flow
    cfg = ctx.cfg
    d = int(cfg["n_dim"])
    pspec = cfg["prior"]
    prior = pt.Prior([pt.Normal(float(pspec["loc"]), float(pspec["scale"])) for _ in range(d)])
    flow = Flow(d, cfg["flow"], bins=int(cfg["bins"]), device="cuda" if ctx.cuda else "cpu")
    gen = torch.Generator(flow.weights[0].device).manual_seed(derive(seed, "flow"))
    init_flow(flow, cfg["flow_init"], gen)
    kw = dict(cfg["sampler"])
    kw.update(extra)
    return pt.Sampler(prior, ctx.likelihood, flow=flow, random_state=derive(seed, "sampler"),
                      device=flow.weights[0].device, **kw)


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.hooks = ctx.hooks
        t0 = time.perf_counter()
        self.sampler = _sampler(ctx, ctx.seed)
        self._sync()
        t1 = time.perf_counter()
        # warm-up: the first iteration of a twin of the cell's sampler, its
        # fit cut to one epoch (its steps at the cell's batch, one
        # validation forward, the refit) and its sweep to one step at the
        # cell's active rows; stopped at the next iteration boundary. The
        # cell's own sampler is not stepped: that would move its state.
        warm = _sampler(ctx, derive(ctx.seed, "warm-up"), train_config=dict(epochs=1),
                        n_steps=1, n_max_steps=1)
        self._until_boundary(warm, 0.0)
        del warm
        self._sync()
        self.setup_parts = dict(weights_s=t1 - t0, warmup_s=time.perf_counter() - t1)
        self.hooks.reset()

    def _sync(self):
        if self.ctx.cuda:
            torch.cuda.synchronize()

    def _until_boundary(self, sampler, seconds, on_boundary=None):
        h = self.hooks
        h.deadline = time.perf_counter() + seconds
        h.on_boundary = on_boundary
        try:
            sampler.run(progress=False, **self.ctx.cfg["run"])
        except StopWindow:
            pass
        finally:
            h.deadline, h.on_boundary = None, None

    def window(self, seconds, tracer=None):
        """Run the window; returns its seconds."""
        h = self.hooks
        start_after = TRACE_START_SHARE * seconds
        t0 = self.t0 = time.perf_counter()

        self.boundaries = []
        self.untraced = None

        def on_boundary(i):
            self.boundaries.append(time.perf_counter() - t0)
            if tracer is None:
                return
            tracer.stop()
            if time.perf_counter() - t0 >= start_after and not tracer.done:
                if self.untraced is None:
                    self.untraced = self._counts()
                tracer.start()
            # the window stays open until both stretches have run
            h.deadline = t0 + seconds if tracer.done else None

        self._until_boundary(self.sampler, seconds, on_boundary)
        self._sync()
        t1 = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        self.window_s = t1 - t0
        return self.window_s

    def end_to_end(self, window_s, busy_s=None):
        """The window's host seconds an iteration (``iter_s``) and, where
        the window was traced, the card's busy seconds an iteration
        (``device_s_per_iter``), each over the iterations completed in it."""
        n = max(self.hooks.iterations, 1)
        out = {"iter_s": window_s / n}
        if busy_s is not None:
            out["device_s_per_iter"] = busy_s / n
        return out

    def _counts(self):
        h = self.hooks
        return dict(iterations=h.iterations, phase_s=dict(h.phase_s),
                    stats=len(h.stats_c), fits=len(h.fit_steps),
                    seconds=time.perf_counter() - self.t0)

    def layer_counts(self):
        """Counts the per-layer readers take: iterations, sweep steps and
        optimizer steps, and the phases' host seconds, over the window or,
        in a traced run, over its iterations before the first traced one
        (tracing slows the host), with the seconds they took from the
        window's start; and every iteration's seconds."""
        h = self.hooks
        c = self.untraced or dict(self._counts(), seconds=self.window_s)
        steps = [int(round(float(s[1]))) for s in h.stats_c[:c["stats"]]]
        b = self.boundaries
        return dict(iterations=c["iterations"], seconds=c["seconds"], phase_s=c["phase_s"],
                    sweep_steps=sum(steps),
                    fit_steps=sum(h.fit_steps[:c["fits"]]),
                    iteration_s=[y - x for x, y in zip(b, b[1:])])

    def release(self):
        """Free what the reference does not read (the sampler's own state
        beyond the captures)."""
        self.sampler = None

    # the faults the check is read under beside the control (``checks``)
    FAULTS = ("half_batch",)

    def checks(self, mode="program"):
        """Each number compared: the program's reading; with ``mode``
        "control" the control's (``check.precisions``); with "half_batch"
        the training numbers of the plain step on half of each batch, in
        the program's place."""
        cfg, h = self.ctx.cfg, self.hooks
        dflt = cfg["defaults_the_reference_follows"]
        fit = lambda **k: check.training(h.fit, dflt["train"], int(cfg["bins"]), **k)
        out = {}
        if mode == "half_batch":
            out["fit_loss_gap"], out["fit_grad_gap"], out["fit_change_gap"] = fit(half=True)
            return out
        flow_p, arith_p = check.precisions(mode == "control")
        out["beta_gap"], out["weight_gap"] = check.phase_a(
            h.phase_a, float(dflt["bias_budget"]), int(dflt["n_bisect"]), arith_p)
        (out["fit_loss_gap"], out["fit_grad_gap"], out["fit_change_gap"],
         out["k2train_z_gap"], out["k2train_ladj_gap"]) = fit(prec=flow_p)
        out["k2_z_gap"], out["k2_ladj_gap"] = check.made_forward(h.last["k2"], flow_p)
        out["k1_x_gap"], out["k1_ladj_gap"] = check.made_inverse(h.last["k1"], flow_p)
        hist = h.phase_a[-1]["hist"]
        t = hist.t - 1
        out["logl_gap"], out["logp_gap"] = check.particles(
            hist.x[t], hist.logl[t], hist.logp[t], self.ctx.likelihood, cfg["prior"], arith_p)
        out["accept_flips"] = check.accept(h.accept, arith_p)
        return out
