"""Traffic ``sweep``: chained calls of the preconditioned sweep
(``mcmc.Sweep.run``) on one population, each call ``steps`` steps with the
stopping rule held off (the flag always true, so ``n_max = steps`` ends
each call). The population starts at u ~ N(0, I) from the seed; the
geometry is fitted on u. The window opens at the first call and closes at
the first call's end past ``--seconds``. A traced run profiles
two stretches of ``TRACE_CALLS`` calls each (``trace.Tracer``), from the
first call that starts past half of the window (a window that ends inside
them runs on to their end).

Mix parameters: ``particles``, ``steps``, ``beta``, ``sigma0``."""

from __future__ import annotations

import time

import torch

from ..flowinit import init_flow
from ..reference import check
from ..seeds import derive
from .smc import LIBRARIES, TRACE_START_SHARE

# sweep calls in each traced stretch
TRACE_CALLS = 5


def libraries(cfg, mix):
    return LIBRARIES["nsfc" if cfg["flow"].startswith("nsfc") else "nsf"][0]


class Run:
    def __init__(self, ctx):
        import pocomc_tpu_torch as pt
        from pocomc_tpu_torch.mcmc import Sweep, make_loglike
        from pocomc_tpu_torch.models.flow import Flow
        from pocomc_tpu_torch.models.geometry import fit_geometry
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        dev = "cuda" if ctx.cuda else "cpu"
        t0 = time.perf_counter()
        d, n, steps = int(cfg["n_dim"]), int(mix["particles"]), int(mix["steps"])
        pspec = cfg["prior"]
        prior = pt.Prior([pt.Normal(float(pspec["loc"]), float(pspec["scale"]))
                          for _ in range(d)])
        scaler = pt.Reparameterize(d, bounds=prior.bounds)
        self.flow = Flow(d, cfg["flow"], bins=int(cfg["bins"]), device=dev)
        init_flow(self.flow, cfg["flow_init"],
                  torch.Generator(dev).manual_seed(derive(ctx.seed, "flow")))
        like = make_loglike(ctx.likelihood)

        def sweep(n_max):
            s = Sweep(scaler, prior.logpdf, like, self.flow, d, n_max, n_max)
            # the stopping rule held off: each call runs n_max steps
            s.keep_flag = lambda st: torch.ones((), dtype=torch.bool, device=dev)
            return s

        self.sweep = sweep(steps)
        self.gen = torch.Generator(dev).manual_seed(derive(ctx.seed, "sweep"))
        with torch.no_grad():
            self.scp = scaler.whitening_params(dev)
            u = torch.randn(n, d, generator=self.gen, device=dev)
            x, ldj = scaler.inverse(u, params=self.scp)
            self.geom = fit_geometry(u, torch.full((n,), 1.0 / n, device=dev), self.gen)
            self.fp = self.flow.params()
            self.state = (u, x, ldj, ctx.likelihood(x), prior.logpdf(x))
            self._sync()
            t1 = time.perf_counter()
            # warm-up: one step on the population, from a generator of its own
            warm = torch.Generator(dev).manual_seed(derive(ctx.seed, "warm-up"))
            sweep(1).run(*self.state, float(mix["beta"]), float(mix["sigma0"]), self.geom,
                         self.fp, self.scp, warm)
            self._sync()
        self.setup_parts = dict(weights_s=t1 - t0, warmup_s=time.perf_counter() - t1)
        ctx.hooks.reset()
        self.calls = 0
        self.steps = 0

    def _sync(self):
        if self.ctx.cuda:
            torch.cuda.synchronize()

    def window(self, seconds, tracer=None):
        mix = self.ctx.mix
        beta, sigma0 = float(mix["beta"]), float(mix["sigma0"])
        start_after = TRACE_START_SHARE * seconds
        traced = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                if tracer is not None and not tracer.active and not tracer.done \
                        and time.perf_counter() - t0 >= start_after:
                    tracer.start()
                res = self.sweep.run(*self.state, beta, sigma0, self.geom, self.fp, self.scp,
                                     self.gen)
                self.state = (res["u"], res["x"], res["logdetj"], res["logl"], res["logp"])
                self.calls += 1
                self.steps += int(res["steps"])
                if tracer is not None and tracer.active:
                    traced += 1
                    if traced % TRACE_CALLS == 0:
                        tracer.stop()
                # the window stays open until both traced stretches have run
                pending = tracer is not None and not tracer.done
                if time.perf_counter() - t0 >= seconds and not pending:
                    break
        self._sync()
        t1 = time.perf_counter()
        if tracer is not None and tracer.active:
            tracer.stop()
        return t1 - t0

    def end_to_end(self, window_s, busy_s=None):
        n = int(self.ctx.mix["particles"])
        return {"psteps_per_s": n * self.steps / window_s}

    def layer_counts(self):
        return dict(calls=self.calls, sweep_steps=self.steps,
                    particle_steps=int(self.ctx.mix["particles"]) * self.steps)

    def release(self):
        self.state = None

    # no training here: the control is the only other reading (``checks``)
    FAULTS = ()

    def checks(self, mode="program"):
        """Each number compared: the program's reading, or with ``mode``
        "control" the control's (``check.precisions``)."""
        h, cfg = self.ctx.hooks, self.ctx.cfg
        flow_p, arith_p = check.precisions(mode == "control")
        out = {}
        out["k5inv_x_gap"], out["k5inv_ladj_gap"] = check.coupling_inverse(h.last["k5inv"], flow_p)
        a = h.accept
        ok = a["prop"]["finite"]
        x, logl, logp = a["prop"]["x_safe"], a["logl_p"], a["prop"]["logp"]
        out["logl_gap"], out["logp_gap"] = check.particles(
            x[ok], logl[ok], logp[ok], self.ctx.likelihood, cfg["prior"], arith_p)
        out["accept_flips"] = check.accept(a, arith_p)
        return out
