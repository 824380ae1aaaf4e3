"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over two
short steady stretches of the window, one after the other, read in memory
(no trace file is written).

1. The device stretch records the card's operations alone (CUPTI's
   activity records; the host is not traced, so it runs at its own pace):
   the device's busy seconds (the union of every kernel, copy and set)
   against the stretch's host seconds, the operations that took most time,
   and the longest idle gaps, labelled by the benchmark's spans the host
   was in (host clock times, which the profiler's device times share).
   The rows of each kernel call in it give the whole step's flops.
2. The span stretch records the host's operations too, and the
   benchmark's spans as profiler ranges, which the profiler projects onto
   the device: the kernels that start inside a call's device range are
   the call's, and their durations its device seconds. Tracing the host
   slows it, not the kernels.

A generator calls ``start()`` and ``stop()`` at its boundaries (an iteration,
a sweep call); each pair runs the next stretch until both have run.

``WindowTrace`` is the other use, in a ``--trace 0`` run whose cell has an
end-to-end metric read from the device trace: the card's operations alone
over the whole window, read as its busy seconds (the union).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

SPAN = "perfbench/"
STRETCHES = ("device", "spans")
PHASES = ("reweight", "train", "mutate")


class Tracer:
    def __init__(self, hooks, cuda=True):
        self.hooks, self.cuda = hooks, cuda
        self.active = False
        self.runs = {}              # stretch -> (profiler, host seconds)
        self.prof = None

    @property
    def done(self):
        return len(self.runs) == len(STRETCHES)

    def _activities(self, stretch):
        cpu, dev = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
        if not self.cuda:
            return [cpu]
        return [dev] if stretch == "device" else [cpu, dev]

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        if self.done or self.active:
            return
        self.stretch = STRETCHES[len(self.runs)]
        self._sync()
        self.prof = torch.profiler.profile(activities=self._activities(self.stretch))
        self.prof.start()
        self.hooks.mode = self.stretch
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        if not self.active:
            return
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.hooks.mode = None
        self.prof.stop()
        self.runs[self.stretch] = (self.prof, window_s)
        self.active = False

    def analysis(self, top=10):
        """The readings of both stretches (empty ones for a stretch that
        never ran)."""
        out = dict(window_s=0.0, busy_s=0.0, spans={},
                   breakdown={"device_ops": [], "idle_gaps": []})
        if "device" in self.runs:
            prof, out["window_s"] = self.runs["device"]
            ops, _ = _events(prof)
            busy, gaps = _union(ops)
            out["busy_s"] = busy * 1e-9
            by_op = defaultdict(int)
            for s, e, name in ops:
                by_op[_short(name)] += e - s
            out["breakdown"]["device_ops"] = [[n, v * 1e-9] for n, v in
                                              sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]
            out["breakdown"]["idle_gaps"] = _label_gaps(gaps, self.hooks.host_spans, top)
        if "spans" in self.runs:
            ops, ranges = _events(self.runs["spans"][0])
            starts = [r[0] for r in ops]
            for name, calls in ranges.items():
                per_call = []
                for s, e, _ in sorted(calls):
                    i, j = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
                    per_call.append(sum(ops[k][1] - ops[k][0] for k in range(i, j)) * 1e-9)
                out["spans"][name] = per_call
        return out


class WindowTrace:
    """The card's busy seconds over a whole window: CUPTI's records of its
    operations alone (the host untraced), started before the window opens
    and stopped after its last operation ended. On the CPU route (the
    tests) the host's operations stand in for the card's."""

    def __init__(self, cuda=True):
        self.cuda = cuda
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])

    def start(self):
        self.prof.start()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()

    def busy_s(self):
        ops, _ = _events(self.prof, self.cuda)
        return _union(ops)[0] * 1e-9


def _events(prof, cuda=True):
    """(the device's operations, the benchmark's device ranges by name),
    each as (start ns, end ns, name), the operations sorted. ``cuda=False``
    takes the host's operations as the device's."""
    ops, ranges = [], defaultdict(list)
    want = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if rec[2].startswith(SPAN):
            ranges[rec[2][len(SPAN):]].append(rec)
        elif not _annotation(e):
            ops.append(rec)
    ops.sort()
    return ops, ranges


def _union(ops):
    """(busy ns: the union of the operations, the gaps between them as
    (length, start, end))."""
    busy, gaps, cur = 0, [], None
    for s, e, _ in ops:
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((s - cur[1], cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _annotation(e):
    """A range a ``record_function`` projects onto the device (PyTorch's
    own, such as the optimizer's), which is no operation of the device."""
    if getattr(e, "is_user_annotation", lambda: False)():
        return True
    return "annotation" in str(getattr(e, "activity_type", lambda: "")()).lower()


def _short(name, n=90):
    name = name.replace("(anonymous namespace)::", "")
    return name if len(name) <= n else name[:n]


def _label_gaps(gaps, host_spans, top):
    """Idle seconds grouped by what the host was doing at each gap's
    middle: the phase span around it and the innermost kernel-call span,
    or none of them."""
    phases = sorted(r for r in host_spans if r[0] in PHASES)
    calls = sorted((r for r in host_spans if r[0] not in PHASES), key=lambda r: r[1])
    starts = [r[1] for r in calls]
    by = defaultdict(int)
    for length, s, e in gaps:
        mid = (s + e) // 2
        phase = next((r[0] for r in phases if r[1] <= mid <= r[2]), None)
        i = bisect.bisect_right(starts, mid)
        call = next((calls[k][0] for k in range(i - 1, max(i - 8, -1), -1)
                     if calls[k][2] >= mid), None)
        label = " > ".join(x for x in (phase, call or "between kernel calls") if x)
        by[label] += length
    return [[n, v * 1e-9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
