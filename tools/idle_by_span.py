"""Where the card idles in a gauss50 SMC iteration, by the program's spans.

Run from the repository root on a CUDA card::

    python3 tools/idle_by_span.py [--seed 1] [--cost 6]
                                  [--out build/idle_by_span.json]

It builds the benchmark cell ``gauss50.smc``'s sampler from ``--seed``
with the benchmark's own generator (``perfbench/generators/smc.py``), runs
it on the device loop with the program's tracer on
(``pocomc_tpu_torch/utils/trace.py``), and profiles iteration
``PROFILE_AT`` (counted from 0) as the benchmark's device stretch does
(``perfbench/trace.py``'s ``Tracer``: the card's operations alone, the
host untraced; it starts and stops inside phase A, at the iteration
boundaries). Then:

- each idle gap of the card is labelled by the benchmark's own rule
  (``_label_gaps``, through ``Tracer.analysis``), fed the program's spans
  cut into the stretches in which each is the innermost span open:
  ``<phase> > <parent> > <span>``, and ``<phase> > between kernel calls``
  for the phase's own code outside any finer span;
- each kernel's device seconds are put down to the phase whose span its
  launch lay in (matched by the profile's launch correlation): phase A's
  device seconds, which the host sees only in phase B's first read;
- the iteration's spans: calls, host seconds and self seconds by name;
- the clock check: three short kernels at each end of the stretch, each
  between a host stamp and a read, give how far CUPTI's device times lie
  from the host clock the spans use at each end (``clock``); a drift
  between the ends is taken out of the spans, linearly, before the gaps
  are labelled.

With ``--cost K`` it then runs 4K more iterations with the tracer off and
on in the order off, on, on, off (K times, so that a trend in the
iterations' work cancels), and prints each iteration's host seconds, its
work (phase B's epochs, phase C's sweep steps), the least-squares share of
an iteration the tracer costs with that work held fixed, and the host
nanoseconds a span site costs with the tracer off and on (a loop of
``begin``/``end`` pairs).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import Context, card_line, load_spec, resolve  # noqa: E402
from perfbench.trace import PHASES, Tracer  # noqa: E402
from pocomc_tpu_torch import phases  # noqa: E402
from pocomc_tpu_torch.utils import trace  # noqa: E402

CELL = "gauss50.smc"
PROFILE_AT = 3
BETWEEN = "between kernel calls"  # ``_label_gaps``'s label outside every call span
ABBA = (False, True, True, False)


class Done(Exception):
    """Raised at the iteration boundary that ends the run."""


def short(r):
    return r["name"][len(trace.PREFIX):]


def innermost_stretches(recs):
    """The program's spans as ``_label_gaps`` takes them, (name, start ns,
    end ns): the phases whole, every finer span cut into the stretches in
    which no child of it is open, named ``<parent> > <span>`` (its own name
    where the parent is a phase)."""
    kids = defaultdict(list)
    for i, r in enumerate(recs):
        if r["parent"] >= 0:
            kids[r["parent"]].append(i)
    out = []
    for i, r in enumerate(recs):
        name = short(r)
        if r["end_ns"] < 0 or name in ("run", "iteration"):
            continue
        if name in PHASES:
            out.append((name, r["start_ns"], r["end_ns"]))
            continue
        parent = short(recs[r["parent"]]) if r["parent"] >= 0 else None
        label = name if parent is None or parent in PHASES else f"{parent} > {name}"
        t = r["start_ns"]
        for k in kids[i]:
            c = recs[k]
            if c["start_ns"] > t:
                out.append((label, t, c["start_ns"]))
            t = max(t, c["end_ns"])
        if r["end_ns"] > t:
            out.append((label, t, r["end_ns"]))
    return out


def probe(n=3):
    """[(host ns before the launch, host ns after the read)] of n spin
    kernels of about 50 us, each launched on an idle card."""
    cycles = torch.cuda.get_device_properties(0).clock_rate // 20
    out = []
    torch.cuda.synchronize()
    for _ in range(n):
        a = time.time_ns()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        out.append((a, time.time_ns()))
    return out


def spins(prof):
    """(start ns, end ns) of each spin kernel in the profile, in order."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA and is_spin(e.name()))


def is_spin(name):
    return "spin" in name.lower()


def clock(probes, kernels):
    """Each probe's kernel start less its host stamp and its read less the
    kernel's end (us), at the stretch's start and end, and the drift of the
    device times against the host clock between them (ns), or None where
    the probes' kernels were not all found."""
    n = len(probes["start"])
    if len(kernels) != 2 * n:
        return None
    out = {}
    for end, ks in (("start", kernels[:n]), ("end", kernels[n:])):
        out[end + "_lead_us"] = [(k0 - a) * 1e-3 for (a, _), (k0, _) in zip(probes[end], ks)]
        out[end + "_lag_us"] = [(b - k1) * 1e-3 for (_, b), (_, k1) in zip(probes[end], ks)]
    out["drift_ns"] = 1e3 * (statistics.median(out["end_lead_us"])
                             - statistics.median(out["start_lead_us"]))
    out["host_start_ns"], out["host_end_ns"] = probes["start"][0][0], probes["end"][0][0]
    return out


def on_device_clock(spans, clk):
    """The spans (name, start, end) moved onto the device's times: by the
    drift between the stretch's ends, in proportion to the time past its
    start (unchanged without a clock check)."""
    if clk is None:
        return spans
    t0, t1, drift = clk["host_start_ns"], clk["host_end_ns"], clk["drift_ns"]
    move = lambda t: int(t + drift * (t - t0) / (t1 - t0))
    return [(name, move(a), move(b)) for name, a, b in spans]


def device_s_by_phase(prof, recs):
    """(device seconds by the phase whose span each operation's launch lay
    in, operations matched, device operations)."""
    spans = sorted((r["start_ns"], r["end_ns"], short(r)) for r in recs if short(r) in PHASES)
    starts = [s for s, _, _ in spans]
    launch, ops = {}, []
    dev = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == dev:
            if not is_spin(ev.name()):
                ops.append(ev)
        elif ev.correlation_id():
            launch[ev.correlation_id()] = ev.start_ns()
    by, matched = defaultdict(int), 0
    for ev in ops:
        t = launch.get(ev.correlation_id()) or launch.get(ev.linked_correlation_id())
        if t is None:
            continue
        matched += 1
        j = bisect.bisect_right(starts, t) - 1
        by[spans[j][2] if j >= 0 and t <= spans[j][1] else "no phase"] += ev.duration_ns()
    return {k: v * 1e-9 for k, v in by.items()}, matched, len(ops)


def iteration_spans(recs, t):
    """{name: calls, seconds, self seconds} of the spans of iteration t."""
    child = defaultdict(int)
    for r in recs:
        if r["parent"] >= 0:
            child[r["parent"]] += r["end_ns"] - r["start_ns"]
    out = defaultdict(lambda: dict(calls=0, seconds=0.0, self_seconds=0.0))
    for i, r in enumerate(recs):
        if r["iteration"] == t:
            row = out[short(r)]
            row["calls"] += 1
            row["seconds"] += (r["end_ns"] - r["start_ns"]) * 1e-9
            row["self_seconds"] += (r["end_ns"] - r["start_ns"] - child[i]) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["seconds"]))


def site_ns(n):
    """Host ns of one span site (begin and end) with the tracer off, then on."""
    def loop(k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            sp = trace.begin("read")
            if sp is not None:
                trace.end(sp)
        return time.perf_counter_ns() - t0

    def empty(k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            sp = None
            if sp is not None:
                pass
        return time.perf_counter_ns() - t0

    trace.stop()
    base = min(empty(n) for _ in range(3))
    off = min(loop(n) for _ in range(3))
    on = []
    for _ in range(3):
        trace.start()
        on.append(loop(min(n, trace.CAPACITY)))
    trace.stop()
    trace.clear()
    m = min(n, trace.CAPACITY)
    return dict(off_ns=(off - base) / n, on_ns=(min(on) - base * m / n) / m, loop_ns=base / n)


def cost(secs, traced, work):
    """The tracer's cost from the cost iterations: medians, and the
    least-squares fit of seconds on (1, epochs, sweep steps, traced)."""
    on = [s for s, t in zip(secs, traced) if t]
    off = [s for s, t in zip(secs, traced) if not t]
    a = np.array([[1.0, e or 0, n, float(t)] for (e, n), t in zip(work, traced)])
    coef, *_ = np.linalg.lstsq(a, np.array(secs), rcond=None)
    return dict(iteration_s=secs, traced=traced, work_epochs_steps=work,
                median_on=statistics.median(on), median_off=statistics.median(off),
                fit_s_per_epoch=coef[1], fit_s_per_sweep_step=coef[2],
                fit_traced_s=coef[3], fit_traced_share=coef[3] / statistics.mean(secs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "idle_by_span.json"))
    args = ap.parse_args(argv)
    print(f"# card: {card_line()}", flush=True)
    ctx = Context(resolve(load_spec(), CELL), args.seed, cuda=True)
    trace.start()
    s = ctx.generator._sampler(ctx, args.seed)
    hooks = SimpleNamespace(mode=None, host_spans=[])
    tracer = Tracer(hooks, cuda=True)
    k = PROFILE_AT
    order = ABBA * args.cost
    last = k + 1 + len(order)
    marks, kept, probes = [], {}, {}
    orig = phases.reweight

    def boundary(*a, **kw):
        i = len(marks)
        if i == k:
            tracer.start()
            probes["start"] = probe()
        elif i == k + 1:
            probes["end"] = probe()
            tracer.stop()
            kept["recs"] = trace.records()
            kept["dropped"] = trace.dropped()
        if k < i < last:  # the cost iterations
            (trace.start if order[i - k - 1] else trace.stop)()
        marks.append(time.perf_counter())
        if i == last:
            raise Done
        return orig(*a, **kw)

    phases.reweight = boundary
    try:
        s.run(progress=False, **ctx.cfg["run"])
    except Done:
        pass
    finally:
        phases.reweight = orig
        trace.stop()
    recs = kept["recs"]
    prof = tracer.runs["device"][0]
    clk = clock(probes, spins(prof))
    hooks.host_spans = on_device_clock(innermost_stretches(recs), clk)
    analysis = tracer.analysis(top=len(hooks.host_spans) + 1)
    gaps = dict(analysis["breakdown"]["idle_gaps"])
    dev_by_phase, matched, n_ops = device_s_by_phase(prof, recs)
    t = s._iter_stats[k]["iter"]
    idle = sum(gaps.values())
    fine = sum(v for lab, v in gaps.items() if not lab.endswith(BETWEEN))
    window_s, busy = analysis["window_s"], analysis["busy_s"]
    route = trace.summary(recs).get(trace.PREFIX + "route", {}).get("seconds")
    out = dict(card=card_line(), seed=args.seed, iteration=t, window_s=window_s, busy_s=busy,
               idle_gaps_s=idle, idle_share=1.0 - busy / window_s,
               idle_under_fine_spans=fine / idle if idle > 0 else None,
               idle_by_span=gaps, device_s_by_launching_phase=dev_by_phase,
               launches_matched=matched, device_ops=n_ops,
               spans_in_iteration=sum(1 for r in recs if r["iteration"] == t),
               spans_dropped=kept["dropped"], iteration_spans=iteration_spans(recs, t),
               run_spans_total=len(recs), route_s=route, clock=clk)
    if args.cost:
        secs = [b - a for a, b in zip(marks, marks[1:])][k + 1:]
        work = [(st["train_epochs"], st["steps"]) for st in s._iter_stats[k + 1:last]]
        out["cost"] = dict(cost(secs, list(order), work), site=site_ns(1_000_000))
    print(json.dumps(out, indent=1), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
