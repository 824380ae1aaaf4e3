"""Small host-side utilities: progress bar and picklable function wrapper.

Counterpart of ``pocomc_tpu/utils/tools.py``. The progress bar writes one
carriage-return line to stderr itself instead of going through tqdm, so the
port needs no package beyond torch, numpy and scipy. ``enable_compile_cache``
has no counterpart: PyTorch runs eagerly and the CUDA kernels cache their
own build (``ops/_build.py``).
"""

from __future__ import annotations

import sys


class ProgressBar:
    """Iteration counter with a persistent stats postfix."""

    def __init__(self, show: bool = True, initial: int = 0):
        self.show = bool(show)
        self.n = int(initial)
        self.info = dict()

    def _render(self):
        if not self.show:
            return
        stats = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in self.info.items())
        sys.stderr.write(f"\rIter {self.n}: {stats}")
        sys.stderr.flush()

    def update_stats(self, info):
        self.info = {**self.info, **info}
        self._render()

    def update_iter(self):
        self.n += 1
        self._render()

    def close(self):
        if self.show:
            sys.stderr.write("\n")
            sys.stderr.flush()


class FunctionWrapper:
    """Bind args/kwargs to a log-probability function, picklably."""

    def __init__(self, f, args=None, kwargs=None):
        self.f = f
        self.args = [] if args is None else args
        self.kwargs = {} if kwargs is None else kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)
