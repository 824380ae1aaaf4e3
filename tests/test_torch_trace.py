"""The port's spans (``pocomc_tpu_torch/utils/trace.py``).

On the CPU, at tiny sizes: a plain run keeps nothing; a traced device-loop
run keeps the span tree, each child inside its parent, with counts equal
to the run's own (optimizer steps, sweep steps, host reads, K2's rows at
the training batch); a profiler session turns the spans on by itself and
its own records of an op lie inside the span the op ran in; a run stopped
by an exception leaves no span open and keeps the stats of its completed
iterations; ``profile_dir`` still labels the phases.

Marked ``gpu`` (on a card: ``python3 -m pytest tests/test_torch_trace.py
-q -m gpu --noconftest -s``): the clock the spans share with CUPTI's
device times, and that every synchronizing call of a device-loop
iteration lies inside a ``read`` span. This file imports no JAX.
"""

import collections
import math
import os
import time
import traceback
import warnings

import pytest
import torch

import pocomc_tpu_torch as pt
from pocomc_tpu_torch import phases
from pocomc_tpu_torch.models.flow import Flow
from pocomc_tpu_torch.utils import trace

P = trace.PREFIX
BATCH = 64
# every span name and the names its parent may have (None: a root)
PARENTS = {
    "setup": {None}, "route": {"setup"}, "run": {None}, "warmup": {"run"},
    "iteration": {"run"}, "reweight": {"iteration"}, "train": {"iteration"},
    "mutate": {"iteration"}, "evidence": {"run"}, "bridge": {"run"},
    "fit": {"train"}, "epoch": {"fit"}, "step": {"epoch"},
    "loss": {"step"}, "backward": {"step"}, "clip": {"step"}, "optimizer": {"step"},
    "validate": {"epoch"}, "snapshot": {"epoch"}, "geometry": {"train"},
    "resample": {"mutate"}, "sweep": {"mutate"}, "sweep_step": {"sweep"},
    "propose": {"sweep_step"}, "likelihood": {"sweep_step"}, "accept": {"sweep_step"},
    "push": {"mutate"},
    "read": {"iteration", "epoch", "sweep_step", "sweep", "geometry", "train", "mutate",
             "run", "warmup", "evidence"},
    "k2": {"loss", "validate", "geometry", "propose", "sweep"},
    "k1": {"propose", "evidence"},
}


@pytest.fixture(autouse=True)
def _fresh_tracer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.stop()
    trace.clear()
    yield
    trace.stop()
    trace.clear()
    torch.set_num_threads(n)


def gauss_like(x):
    return -0.5 * (x * x).sum(-1) - 0.5 * x.shape[1] * math.log(2 * math.pi)


def make_sampler(device="cpu", **kw):
    return pt.Sampler(pt.Prior([pt.Normal(0, 5) for _ in range(2)]), gauss_like,
                      vectorize=True, random_state=0, n_effective=128, n_active=64,
                      flow="nsf3", device=device,
                      train_config=dict(epochs=30, patience=3, batch_size=BATCH), **kw)


def short(name):
    return name[len(P):]


@pytest.fixture(scope="module")
def traced():
    """A traced device-loop run, its records, its stats and the rows and
    batch size of each of its phase B calls."""
    torch.set_num_threads(1)
    fits = []
    orig = phases.train

    def train(flow, u_sel, *a, **k):
        fits.append((u_sel.shape[0], k["batch_size"]))
        return orig(flow, u_sel, *a, **k)

    phases.train = train
    trace.start()
    try:
        s = make_sampler()
        s.run(n_total=256, n_evidence=256, progress=False)
    finally:
        trace.stop()
        phases.train = orig
    recs = trace.records()
    trace.clear()
    return s, recs, fits


def test_plain_run_keeps_no_spans():
    s = make_sampler(precondition=False)
    s.run(n_total=128, n_evidence=0, progress=False)
    assert trace.records() == [] and trace.dropped() == 0


def test_traced_run_keeps_the_span_tree(traced):
    s, recs, _ = traced
    assert s._use_device_loop() and trace.dropped() == 0
    names = {short(r["name"]) for r in recs}
    assert names >= set(PARENTS) - {"bridge"}, set(PARENTS) - names
    assert names <= set(trace.NAMES)
    for r in recs:
        assert r["end_ns"] >= r["start_ns"], r
        parent = recs[r["parent"]] if r["parent"] >= 0 else None
        assert (short(parent["name"]) if parent else None) in PARENTS[short(r["name"])], r
        if parent is not None:
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
        # the iteration index: the enclosing iteration span's, else -1
        it = next((a for a in _chain(recs, r) if a["name"] == P + "iteration"), None)
        assert r["iteration"] == (-1 if it is None else it["iteration"]), r
    for name, row in trace.summary(recs).items():
        assert row["calls"] > 0 and row["self_seconds"] >= 0.0, (name, row)
    # the iteration spans carry the sampler's t, one each
    its = [r["iteration"] for r in recs if r["name"] == P + "iteration"]
    assert its == [st["iter"] for st in s._iter_stats]


def _chain(recs, r):
    """r and its ancestors, innermost first."""
    yield r
    while r["parent"] >= 0:
        r = recs[r["parent"]]
        yield r


def _ancestors(recs, r):
    return [short(a["name"]) for a in _chain(recs, r)][1:]


def test_counts_equal_the_runs_own(traced):
    s, recs, calls = traced
    by = lambda name: [r for r in recs if r["name"] == P + name]
    children = lambda r, name: [c for c in by(name) if recs[c["parent"]] is r]
    fits = by("fit")
    trained = [st for st in s._iter_stats if st["train_epochs"] is not None]
    epochs = [children(f, "epoch") for f in fits]
    assert [len(e) for e in epochs] == [st["train_epochs"] for st in trained]
    # each epoch's optimizer steps: the batches of half the rows phase B
    # was handed (the other half validates), at its batch size
    assert len(calls) == len(fits)
    per_epoch = [-(-(n // 2) // max(1, min(b, n // 2))) for n, b in calls]
    assert [[len(children(e, "step")) for e in fit] for fit in epochs] == \
        [[b] * st["train_epochs"] for b, st in zip(per_epoch, trained)]
    assert len(by("optimizer")) == len(by("step")) == \
        sum(st["train_epochs"] * b for st, b in zip(trained, per_epoch))
    # every step's parts, and one K2 call in its loss at the batch
    for part in ("loss", "backward", "clip"):
        assert len(by(part)) == len(by("step"))
    assert [recs[r["parent"]]["name"] for r in by("k2") if "step" in _ancestors(recs, r)] \
        == [P + "loss"] * len(by("step"))
    steps = [st["steps"] for st in s._iter_stats]
    assert len(by("sweep_step")) == sum(steps) == len(by("likelihood"))
    assert [len(children(r, "sweep_step")) for r in by("sweep")] == steps
    # the host's reads in the loop: one an epoch, one a sweep step (a step
    # that reaches n_max stops without one), one an iteration, one for
    # phase B's stats and one for phase C's copied step count; the
    # geometry fit's Student-t EM reads once an EM iteration (named apart)
    reads = [r for r in by("read") if r["iteration"] >= 0]
    em = [r for r in reads if "geometry" in _ancestors(recs, r)]
    sweep_reads = sum(n - (n >= s.n_max_steps) for n in steps)
    assert len(reads) - len(em) == (sum(st["train_epochs"] for st in trained) + sweep_reads
                                    + 2 * len(steps) + len(trained))
    assert len(em) >= 2 * len(trained)


def test_profiler_session_keeps_spans_on_its_clock():
    flow = Flow(3, "nsf3", device="cpu")
    x = torch.randn(32, 3)
    act = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[act]) as prof:
        sp = trace.begin("read")
        torch.ones(1000)
        trace.end(sp)
        with torch.no_grad():
            flow.forward(x)
    assert not trace.ON
    recs = trace.records()
    assert [r["name"] for r in recs] == [P + "read", P + "k2"]
    ones = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::ones"]
    assert ones
    e = ones[0]
    assert recs[0]["start_ns"] <= e.start_ns() <= e.start_ns() + e.duration_ns() \
        <= recs[0]["end_ns"]
    # after the session the spans are off again
    trace.end(trace.begin("read"))
    assert len(trace.records()) == 2


def _stop_after(monkeypatch, n):
    """phases.reweight raising on its (n+1)-th call: n iterations complete."""
    calls = []
    orig = phases.reweight

    def reweight(*a, **k):
        if len(calls) == n:
            raise KeyboardInterrupt
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(phases, "reweight", reweight)


def test_stopped_run_closes_every_span(monkeypatch):
    _stop_after(monkeypatch, 2)
    trace.start()
    s = make_sampler()
    with pytest.raises(KeyboardInterrupt):
        s.run(n_total=256, n_evidence=256, progress=False)
    recs = trace.records()
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    assert [r["iteration"] for r in recs if r["name"] == P + "iteration"] == \
        [st["iter"] for st in s._iter_stats] + [s.t]
    # a new span after the stop is a root again
    trace.end(trace.begin("read"))
    assert trace.records()[-1]["parent"] == -1


def test_stopped_run_keeps_its_completed_iterations(monkeypatch):
    _stop_after(monkeypatch, 3)
    s = make_sampler()
    with pytest.raises(KeyboardInterrupt):
        s.run(n_total=256, n_evidence=256, progress=False)
    assert len(s._iter_stats) == 3
    t0 = s.n_prior // s.n_active
    assert [st["iter"] for st in s._iter_stats] == [t0 + 1, t0 + 2, t0 + 3]
    assert all(st["steps"] > 0 and st["train_epochs"] for st in s._iter_stats)


def test_profile_dir_labels_the_phases(tmp_path):
    s = make_sampler(precondition=False, profile_dir=str(tmp_path / "trace"))
    s.run(n_total=128, n_evidence=0, progress=False)
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "trace") for f in fs]
    text = open(files[0]).read()
    for phase in ("warmup", "mutate", "sweep"):
        assert f'"{P}{phase}"' in text, phase
    # fine spans, and those a caller may switch sessions inside, stay in memory
    for span in ("sweep_step", "iteration", "reweight"):
        assert f'"{P}{span}"' not in text, span
    assert set(s.phase_seconds) == {"warmup", "reweight", "train", "mutate", "evidence",
                                    "bridge"}
    assert all(s.phase_seconds[k] > 0.0 for k in ("warmup", "reweight", "mutate"))
    # the spans the session kept (the run's own span began before it)
    summ = trace.summary()
    for phase in ("reweight", "mutate"):
        assert summ[P + phase]["calls"] == len(s._iter_stats)
    assert not torch.autograd.profiler._is_profiler_enabled


SESSIONS = """
import gc, math, torch
import pocomc_tpu_torch as pt
from pocomc_tpu_torch import phases
torch.set_num_threads(1)
act = [torch.profiler.ProfilerActivity.CPU]
profs, cur = [], [None]
orig = phases.reweight

class Stop(Exception):
    pass

def reweight(*a, **k):
    # a new profiler session at every iteration boundary, inside phase A
    if cur[0] is not None:
        cur[0].stop()
        profs.append(cur[0])
        cur[0] = None
    if len(profs) == 3:
        raise Stop
    cur[0] = torch.profiler.profile(activities=act)
    cur[0].start()
    with torch.profiler.record_function("caller/reweight"):
        return orig(*a, **k)

phases.reweight = reweight
s = pt.Sampler(pt.Prior([pt.Normal(0, 5)] * 2), lambda x: -0.5 * (x * x).sum(-1),
               vectorize=True, random_state=0, n_effective=128, n_active=64,
               precondition=False, device="cpu")
try:
    s.run(n_total=128, n_evidence=0, progress=False)
except Stop:
    pass
n = sum(len(list(p.profiler.kineto_results.events())) for p in profs)
del profs, cur
gc.collect()
for _ in range(100):
    torch.randn(1000).sum()
print("events", n)
"""


def test_profiler_sessions_switched_inside_phase_a():
    """A caller that starts a new profiler session at every iteration
    boundary, inside phase A (as a benchmark's stretches do), reads every
    session's events and frees them: no range of the program spans two
    sessions (one would write into the first session's freed records)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SESSIONS], capture_output=True, text=True,
                         cwd=root, timeout=300, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and "events" in out.stdout, out.stderr[-2000:]


def test_capacity_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.start()
    for _ in range(5):
        trace.end(trace.begin("read"))
    assert len(trace.records()) == 3 and trace.dropped() == 2
    trace.start()
    assert trace.records() == [] and trace.dropped() == 0


# -- on a card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


N_CLOCK = 40


@pytest.mark.gpu
def test_spans_share_cuptis_clock(cuda):
    """A kernel launched inside a host span that ends in a read runs, by
    CUPTI's device times, inside that span (to 50 us): the spans and the
    profiler's device records share one clock."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity.CUDA
    cycles = int(torch.cuda.get_device_properties(0).clock_rate) * 2  # about 2 ms
    with torch.profiler.profile(activities=[act]) as prof:
        for _ in range(N_CLOCK):
            sp = trace.begin("sweep_step")
            torch.cuda._sleep(cycles)
            rd = trace.begin("read")
            torch.cuda.synchronize()
            trace.end(rd)
            trace.end(sp)
            time.sleep(0.002)
    spans = [r for r in trace.records() if r["name"] == P + "sweep_step"]
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and "spin" in e.name().lower())
    assert len(spans) == len(kernels) == N_CLOCK
    lead, lag = [], []
    for r, (k0, k1) in zip(spans, kernels):
        lead.append(k0 - r["start_ns"])
        lag.append(r["end_ns"] - k1)
    ms = (spans[-1]["start_ns"] - spans[0]["start_ns"]) * 1e-6
    print(f"\nclock: kernel start - span start {min(lead)}..{max(lead)} ns "
          f"(first {lead[0]}, last {lead[-1]}, {ms:.1f} ms apart), "
          f"span end - kernel end {min(lag)}..{max(lag)} ns, "
          f"kernel {(kernels[0][1] - kernels[0][0]) * 1e-6:.3f} ms")
    assert min(lead) >= -50_000 and min(lag) >= -50_000


@pytest.mark.gpu
def test_every_sync_of_the_loop_is_a_read(cuda):
    """Under torch's sync debug mode, every synchronizing call inside a
    device-loop iteration lies inside a ``read`` span."""
    s = make_sampler(device="cuda")
    s.run(n_total=128, n_evidence=0, progress=False)  # builds and loads the kernels
    stamps = []

    def show(message, category, *a, **k):
        if "synchroniz" in str(message):
            # the innermost frame of the package that made the call
            where = next((f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                          for f in reversed(traceback.extract_stack())
                          if "pocomc_tpu_torch" in f.filename), "?")
            stamps.append((time.time_ns(), where))

    s = make_sampler(device="cuda")
    trace.start()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s.run(n_total=256, n_evidence=256, progress=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    trace.stop()
    recs = trace.records()
    its = [(r["start_ns"], r["end_ns"]) for r in recs if r["name"] == P + "iteration"]
    reads = [(r["start_ns"], r["end_ns"]) for r in recs if r["name"] == P + "read"]
    inside = lambda t, spans: any(a <= t <= b for a, b in spans)
    loop = [(t, m) for t, m in stamps if inside(t, its)]
    outside = [m for t, m in loop if not inside(t, reads)]
    print(f"\nsyncs: {len(stamps)} in the run, {len(loop)} in its {len(its)} iterations, "
          f"{len(outside)} of them outside a read span; reads {len(reads)}; outside at "
          f"{sorted(collections.Counter(outside).items())}")
    assert its and loop and not outside, sorted(collections.Counter(outside).items())
