"""What a per-layer reader (``metrics/<name>.py``, ``read(view)``) sees of
a traced run. A reader that finds nothing to read returns None, and the
metric is left out of the result line."""

from __future__ import annotations

from . import peaks


class LayerView:
    def __init__(self, ctx, counts, analysis, window_s):
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.counts = counts                  # the generator's counts over the window
        self.window_s = window_s              # the whole window's host seconds
        self.trace = analysis                 # trace.Tracer.analysis()
        # kernel -> rows of each call: in the device stretch (the whole
        # step's flops) and in the span stretch (the kernels' rooflines)
        self.rows = ctx.hooks.rows["device"]
        self.span_rows = ctx.hooks.rows["spans"]
        self.peaks = peaks

    def span_calls(self, span, kind):
        """[(rows, device seconds)] of each traced call of a kernel span,
        or None where the profiler and the row counts disagree on the
        calls (nothing to read then)."""
        secs, rows = self.trace["spans"].get(span, []), self.span_rows.get(kind, [])
        if not secs or len(secs) != len(rows):
            return None
        return list(zip(rows, secs))

    def roofline(self, span, kind, bound):
        """100 x the summed least seconds over the summed device seconds of
        the span's traced calls; ``bound(rows)`` gives (flops, bytes)."""
        calls = self.span_calls(span, kind)
        if not calls:
            return None
        least = sum(peaks.bound_s(*bound(n)) for n, _ in calls)
        spent = sum(s for _, s in calls)
        return 100.0 * least / spent if spent > 0 else None

    def idle_percent(self):
        w, busy = self.trace["window_s"], self.trace["busy_s"]
        return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None

    def mfu(self, flops):
        """100 x flops over the device stretch's seconds at the fp32 peak."""
        w = self.trace["window_s"]
        return 100.0 * flops / (w * peaks.FP32_FLOPS) if w > 0 and flops > 0 else None
