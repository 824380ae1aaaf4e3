"""The program's own spans (``pocomc_tpu_torch/utils/trace.py``) in a
traced run, for the per-layer readers: any profiler session turns them on,
so both stretches of a ``--trace 1`` run record them. The readers take the
device stretch alone (the host untraced there but for CUPTI's cost a
launch): in an smc run the first iteration whose ``train`` and ``mutate``
spans were both kept (the profiler starts inside phase A), in a sweep run
the first ``TRACE_CALLS`` sweep spans kept. Where the program keeps no
spans (a tree before them), every function returns None."""

from __future__ import annotations

P = "pocomc/"


def records():
    """The program's spans, or None where it has none."""
    try:
        from pocomc_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records() or None


def iteration_stretch():
    """(records, the indices of the first iteration whose train and mutate
    spans were both kept), or None."""
    recs = records()
    if recs is None:
        return None
    kept = {}
    for r in recs:
        if r["iteration"] >= 0 and r["name"] in (P + "train", P + "mutate"):
            kept.setdefault(r["iteration"], set()).add(r["name"])
    t = next((t for t, names in kept.items() if len(names) == 2), None)
    if t is None:
        return None
    return recs, [i for i, r in enumerate(recs) if r["iteration"] == t]


def sweep_stretch(calls):
    """(records, the indices of the first ``calls`` sweep spans and every
    span inside them), or None."""
    recs = records()
    if recs is None:
        return None
    inside = set([i for i, r in enumerate(recs) if r["name"] == P + "sweep"][:calls])
    if len(inside) < calls:
        return None
    for i, r in enumerate(recs):  # a parent begins before its children
        if r["parent"] in inside:
            inside.add(i)
    return recs, sorted(inside)


def seconds_less_children(stretch, name, children):
    """[the host seconds of each ended span ``name`` in the stretch, less
    those of its direct children named in ``children``]."""
    if stretch is None:
        return []
    recs, idx = stretch
    ns = lambda r: r["end_ns"] - r["start_ns"]
    own = {i: ns(recs[i]) for i in idx
           if recs[i]["name"] == P + name and recs[i]["end_ns"] >= 0}
    kids = {P + c for c in children}
    for i in idx:
        r = recs[i]
        if r["parent"] in own and r["name"] in kids and r["end_ns"] >= 0:
            own[r["parent"]] -= ns(r)
    return [v * 1e-9 for v in own.values()]


def mean_ms(values):
    return 1e3 * sum(values) / len(values) if values else None


def count(stretch, name):
    if stretch is None:
        return None
    recs, idx = stretch
    return sum(1 for i in idx if recs[i]["name"] == P + name)
