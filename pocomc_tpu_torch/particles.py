"""Append-only particle history ("persistent sampling" memory).

Counterpart of ``pocomc_tpu/particles.py``, moved over unchanged: a host
float64 numpy store of T iterations x n_active particles with the
multiple-importance-sampling evidence math (incremental mixture
denominator, retroactive rung re-correction). The device loop
(``phases.py``) keeps its own fixed-shape torch history and syncs it here
at the end of a run.
"""

from __future__ import annotations

import numpy as np

from .ops.weights import (compute_logw_and_logz as _logw_logz,
                          logw_from_mis_denominator as _logw_from_denom)

_KEYS = ("u", "x", "logdetj", "logl", "logp", "logw", "blobs", "iter",
         "logz", "calls", "steps", "efficiency", "ess", "accept", "beta",
         "resid", "resid_exit", "hot", "corr")


class Particles:
    """Per-iteration history of particles and scalar diagnostics."""

    def __init__(self, n_particles, n_dim):
        self.n_particles = n_particles
        self.n_dim = n_dim
        self.past = {key: [] for key in _KEYS}
        self.results_dict = None
        self._mis_cache = None

    def update(self, data):
        for key, value in data.items():
            if key in self.past:
                self.past[key].append(value)

    def pop(self, key):
        """Drop the newest stored value of one key (reference parity:
        pocoMC ``particles.py:150-164``, which likewise discards it). The
        caller pops every per-iteration key it rolls back; the MIS cache
        sees the shorter history and rebuilds (``mis_denominator``)."""
        self.past[key].pop()

    def get(self, key, index=None, flat=False):
        if index is None:
            if flat:
                return np.concatenate(self.past[key])
            return np.asarray(self.past[key])
        return self.past[key][index]

    @property
    def t(self):
        return len(self.past["beta"])

    def mis_denominator(self):
        """Balance-heuristic mixture denominator over the stored history,
        maintained incrementally across appends.

        Returns ``(B, logl)`` where ``B`` has shape (T, n) with
        ``B[t, j] = logsumexp_i(beta_i * logl[t, j] - logz_i) - log T``
        (exactly the `B` of ops.weights.compute_logw_and_logz) and
        ``logl`` is the stacked f64 (T, n) history the denominator was
        computed from.

        The history is append-only (reference particles.py:69-146
        semantics), so each call folds only the NEW component
        temperatures / particle blocks into the cached running logsumexp:
        O(T*n) per SMC iteration instead of rebuilding the O(T^2 * n)
        component tensor and its (T, T, n) f64 intermediate. A shorter
        history or a retroactive edit of beta/logz invalidates the cached
        prefix and triggers a full rebuild, still at O(T*n) peak memory.
        Stored logl blocks are snapshotted at fold time, so later
        in-place mutation of caller arrays cannot corrupt the cache.
        """
        beta = np.asarray(self.past["beta"], dtype=np.float64)
        logz = np.asarray(self.past["logz"], dtype=np.float64)
        logl_list = self.past["logl"]
        T = beta.size
        if T == 0:
            raise ValueError("empty history: no stored iterations")
        if not (len(logl_list) == logz.size == T):
            raise ValueError(
                "inconsistent history: "
                f"{len(logl_list)} logl blocks, {T} betas, {logz.size} logz")

        c = self._mis_cache
        if c is not None:
            Tc = c["beta"].size
            if (Tc > T
                    or not np.array_equal(c["beta"], beta[:Tc])
                    or not np.array_equal(c["logz"], logz[:Tc])):
                c = None  # rollback or retroactive edit: rebuild
        if c is None:
            c = {"beta": beta[:0], "logz": logz[:0], "logl": [],
                 "denom": None}
        Tc = c["beta"].size

        if Tc < T:
            for t in range(Tc, T):
                c["logl"].append(np.array(logl_list[t], dtype=np.float64,
                                          copy=True))
            logl_stack = np.stack(c["logl"])
            # New particle blocks: denominator over the OLD components.
            # (With Tc == 0 this is just the -inf identity.)
            new_rows = np.full((T - Tc, logl_stack.shape[1]), -np.inf)
            with np.errstate(invalid="ignore"):
                for i in range(Tc):
                    new_rows = np.logaddexp(
                        new_rows, beta[i] * logl_stack[Tc:] - logz[i])
            denom = (new_rows if Tc == 0
                     else np.concatenate([c["denom"], new_rows]))
            # New components: fold into ALL blocks.
            with np.errstate(invalid="ignore"):
                for i in range(Tc, T):
                    denom = np.logaddexp(denom, beta[i] * logl_stack - logz[i])
            c["denom"] = denom
            c["beta"] = beta.copy()
            c["logz"] = logz.copy()
            self._mis_cache = c

        logl_stack = (np.stack(c["logl"]) if c["logl"]
                      else np.zeros((0, 0)))
        return c["denom"] - np.log(T), logl_stack

    def compute_logw_and_logz(self, beta_final=1.0, normalize=True,
                              recorrect=False):
        """Reweight the FULL history to temperature beta_final (see
        ops.weights.compute_logw_and_logz for the estimator; the mixture
        denominator comes from the incremental mis_denominator cache).

        recorrect=True re-lays the stored rung ladder from the per-stage
        EXIT residual-hotness before forming the mixture denominators
        (see recorrected_logz) — the retroactive correction for final
        results. In-run callers (beta bisection, termination metric)
        keep the cheap causal ladder: it is both O(T*n) incremental and
        what the run's own adaptive decisions were actually based on.
        """
        if recorrect and self.past.get("resid_exit"):
            logz_c = self.recorrected_logz()
            logl = self.get("logl")
            return _logw_logz(logl, self.get("beta"), logz_c,
                              beta_final, normalize=normalize)
        B, logl = self.mis_denominator()
        return _logw_from_denom(logl.reshape(-1), B.reshape(-1),
                                beta_final, normalize=normalize)

    def recorrected_logz(self, hot=None):
        """Retroactively re-laid rung ladder using per-stage EXIT resid.

        The live run corrects each moving rung by dbeta * resid of the
        latest stage, where resid is the drift-window extrapolation of
        that population's REMAINING mean-logl relaxation — but the live
        value only refreshes when a CALIB_W-step window closes, so
        short plateau-exit sweeps contribute rungs with NO correction,
        and feeding a fresher estimate into the live ladder changes the
        stored MIS weights and with them the whole run trajectory
        (measured; see mcmc.py _final_resid). This method instead
        replays the ladder AFTER the run: each rung's raw MIS estimate
        is recomputed over the causal prefix with the ALREADY-corrected
        earlier rungs in its mixture denominators, then corrected by
        dbeta * resid_exit of its source stage. Run dynamics are
        untouched; only the reported evidence (and final weights)
        improve. Oracle anchor: on the closed-form tempered gauss50
        ladder, correct rungs make the final MIS estimate exact
        (RESULTS.md round 3; benchmarks/smc_evidence_gauss50.py).

        O(T^2 * n) once per call — result-time only.

        `hot` (optional, (T,) nats per stage) overrides the default
        per-stage hotness estimate -resid_exit: rung t is corrected by
        -dbeta_t * hot_{t-1}.
        """
        beta = np.asarray(self.past["beta"], dtype=np.float64)
        logz_stored = np.asarray(self.past["logz"], dtype=np.float64)
        T = beta.size
        if hot is None:
            resid = np.asarray(self.past["resid_exit"], dtype=np.float64)
            if resid.size < T:  # stages stored before the key existed
                resid = np.concatenate([np.zeros(T - resid.size), resid])
            hot = -resid
        hot = np.asarray(hot, dtype=np.float64)
        logl = np.asarray(self.past["logl"], dtype=np.float64)
        n = logl.shape[1]
        logz_c = np.zeros(T)
        logz_c[0] = logz_stored[0]
        denom = None  # (t, n) logsumexp_{i<t} beta_i*logl[s] - logz_c[i]
        with np.errstate(invalid="ignore"):
            for t in range(1, T):
                comp = beta[t - 1] * logl[:t] - logz_c[t - 1]
                if denom is None:
                    denom = comp
                else:
                    new_block = beta[:t - 1, None] * logl[t - 1][None, :] \
                        - logz_c[:t - 1, None]
                    m = np.max(new_block, axis=0)
                    nb = m + np.log(np.sum(np.exp(new_block - m), axis=0))
                    denom = np.logaddexp(np.vstack([denom, nb]), comp)
                if beta[t] == beta[t - 1]:
                    logz_c[t] = logz_c[t - 1]
                    continue
                logw = beta[t] * logl[:t] - (denom - np.log(t))
                m = np.max(logw)
                logz_raw = m + np.log(np.sum(np.exp(logw - m))) \
                    - np.log(t * n)
                logz_c[t] = logz_raw - (beta[t] - beta[t - 1]) * hot[t - 1]
        return logz_c

    def compute_results(self):
        if self.results_dict is None:
            self.results_dict = {key: self.get(key) for key in self.past}
            logw, _ = self.compute_logw_and_logz(
                1.0, recorrect=bool(self.past.get("resid_exit")))
            self.results_dict["logw"] = logw
        return self.results_dict
