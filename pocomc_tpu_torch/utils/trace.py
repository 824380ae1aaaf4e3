"""The program's spans: one in-memory tracer for the whole port.

A span is one stretch of host work at a layer boundary of the sampler:
its name (``pocomc/<name>``), its start and end in ``time.time_ns()``
(the clock of ``torch.profiler``'s host events, onto which it maps the
device's; the two can drift apart by a few hundredths of a percent over
seconds), its parent (the innermost span open when it began) and the
iteration it ran in (the sampler's ``t`` inside a loop, -1 outside one).
A layer's count is the number of its spans: a fit's optimizer steps are
its ``step`` spans, a sweep's steps its ``sweep_step`` spans.

The span tree (``NAMES``):

- ``run``; ``setup`` > ``route`` (the likelihood's and the prior's
  checks on meta tensors);
- ``warmup``; ``iteration`` > ``reweight``, ``train``, ``mutate``;
  ``evidence``; ``bridge``;
- ``train`` > ``fit`` > ``epoch`` > ``step`` > ``loss``, ``backward``,
  ``clip``, ``optimizer``; ``epoch`` > ``validate``, ``snapshot``;
  ``train`` > ``geometry``;
- ``mutate`` > ``resample``, ``sweep`` > ``sweep_step`` > ``propose``,
  ``likelihood``, ``accept``; ``mutate`` > ``push``;
- ``read``: every blocking device-to-host read of the device path;
- the kernels ``k2``, ``k2bwd``, ``k1``, ``k1bwd``, ``k5``, ``k5inv``,
  ``k5invbwd``.

Spans are kept while tracing is on: between ``start()`` and ``stop()``,
and while any ``torch.profiler`` session runs (checked as each span
begins). While a profiler runs, the coarse spans (``RANGES``) are also
``record_function`` ranges of the same name, so they label the
profiler's timeline; the fine ones, and the three inside which a caller
may switch profiler sessions, are kept in memory only. Nothing is
written anywhere: ``records()`` and ``summary()`` read the spans back.
The buffer holds ``CAPACITY`` spans (about a hundred whole device-loop
iterations at d=50); past that new spans are counted (``dropped()``) and
not kept.

A span site costs, with tracing off, a call and two flag reads
(``begin`` returns None); the site ends a span it began with ``end``.
Ending a span ends every span still open inside it, so a span whose
site an exception skipped is closed by the first enclosing span that
closes in a ``finally``. One thread traces at a time.
"""

from __future__ import annotations

import functools
import time
from array import array

from torch.autograd import profiler as _profiler

PREFIX = "pocomc/"
NAMES = ("run", "setup", "route", "warmup", "iteration", "reweight", "train", "mutate",
         "evidence", "bridge", "fit", "epoch", "step", "loss", "backward", "clip", "optimizer",
         "validate", "snapshot", "geometry", "resample", "sweep", "sweep_step", "propose",
         "likelihood", "accept", "push", "read",
         "k2", "k2bwd", "k1", "k1bwd", "k5", "k5inv", "k5invbwd")
# the spans that are also profiler ranges while a profiler runs: not
# ``run``, ``iteration`` or ``reweight``, inside which a caller may stop one
# profiler session and start the next at an iteration boundary (a range
# begun in one session and ended in the next writes into the first
# session's freed records)
RANGES = frozenset(("setup", "warmup", "train", "mutate", "fit", "geometry", "sweep",
                    "evidence", "bridge"))
CAPACITY = 1 << 19

_ID = {name: i for i, name in enumerate(NAMES)}
_LABELS = tuple(PREFIX + name for name in NAMES)
_RANGE_IDS = frozenset(_ID[name] for name in RANGES)

ON = False          # start() .. stop()
_iteration = -1     # the sampler's t inside a loop
_n = 0              # spans kept
_dropped = 0
_stack = []         # indices of the open spans, innermost last
_ranges = {}        # index -> the open record_function of a coarse span
# the columns: name id, start, end, parent, iteration
_cols = None


def start():
    """Turn tracing on, from an empty buffer."""
    global ON
    clear()
    ON = True


def stop():
    """Turn tracing off (spans open now still end at their sites)."""
    global ON
    ON = False


def clear():
    """Forget every span kept and every span open."""
    global _n, _dropped
    for rf in _ranges.values():
        rf.__exit__(None, None, None)
    _ranges.clear()
    _stack.clear()
    _n = _dropped = 0


def set_iteration(t):
    """The iteration index the spans that begin from now on carry."""
    global _iteration
    _iteration = int(t)


def begin(name):
    """Begin the span ``name`` (one of ``NAMES``); returns its handle for
    ``end``, or None while tracing is off."""
    if not (ON or _profiler._is_profiler_enabled):
        return None
    global _n, _dropped, _cols
    i = _n
    if i >= CAPACITY:
        _dropped += 1
        return None
    if _cols is None:
        _cols = [array("q", bytes(8 * CAPACITY)) for _ in range(5)]
    k = _ID[name]
    c = _cols
    c[0][i], c[2][i], c[3][i], c[4][i] = k, -1, _stack[-1] if _stack else -1, _iteration
    _n = i + 1
    _stack.append(i)
    if k in _RANGE_IDS and _profiler._is_profiler_enabled:
        rf = _ranges[i] = _profiler.record_function(_LABELS[k])
        rf.__enter__()
    c[1][i] = time.time_ns()
    return i


def end(sp):
    """End the span ``sp`` (``begin``'s handle; None is ignored) and every
    span still open inside it."""
    if sp is None:
        return
    t = time.time_ns()
    if sp not in _stack:
        return  # ended already (inside an enclosing span), or cleared
    c = _cols
    while True:
        j = _stack.pop()
        c[2][j] = t
        if _ranges:
            rf = _ranges.pop(j, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        if j == sp:
            break


def spanned(name):
    """Decorate a function so that each call is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            sp = begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                end(sp)
        return traced
    return wrap


def dropped():
    """Spans not kept because the buffer was full."""
    return _dropped


def records():
    """Every span kept, in the order they began: dicts of ``name``,
    ``start_ns``, ``end_ns`` (-1 while open), ``parent`` (an index into
    this list, -1 for none) and ``iteration``."""
    if _cols is None:
        return []
    name, t0, t1, parent, it = (col[:_n].tolist() for col in _cols)
    return [dict(name=_LABELS[k], start_ns=a, end_ns=b, parent=p, iteration=t)
            for k, a, b, p, t in zip(name, t0, t1, parent, it)]


def summary(recs=None):
    """{name: {"calls", "seconds", "self_seconds"}} over the ended spans of
    ``recs`` (default ``records()``); a span's self seconds are its
    seconds less those of its ended children."""
    recs = records() if recs is None else recs
    dur = [r["end_ns"] - r["start_ns"] if r["end_ns"] >= 0 else None for r in recs]
    child = [0] * len(recs)
    for r, d in zip(recs, dur):
        if d is not None and r["parent"] >= 0:
            child[r["parent"]] += d
    out = {}
    for r, d, c in zip(recs, dur, child):
        if d is None:
            continue
        s = out.setdefault(r["name"], dict(calls=0, seconds=0.0, self_seconds=0.0))
        s["calls"] += 1
        s["seconds"] += d * 1e-9
        s["self_seconds"] += (d - c) * 1e-9
    return out
