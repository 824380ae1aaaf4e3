"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each
printing one JSON line:

  1. environment: card name and power limit (nvidia-smi), torch/CUDA
     versions, the TF32 flags (both must be off);
  2. build: compiles the six CUDA libraries from ``pocomc_tpu_torch/csrc``
     (K2's forward and backward, K1 and its backward K1-bwd, each with both
     heads, and K5's forward/inverse and backward, the latter with the
     inverse's gradient, K5-inv-bwd) for the default 8 spline bins, one
     nvcc each, all started together, and once phase 9 ends, in the
     background at the lowest priority, for 16 and for run-time bins
     (``LIBRARY_BINS``: the library of every bins past 16), which phase 14
     (a) waits for; with each library's seconds and ptxas's count of its
     instances, their most registers and their spills;
     ``k5_plans``, after phase 4, prints the tile each K5 launch of
     phases 3-4 took, from the wrapper's own plans (the lane grid, BM rows
     a block, the register tile, G, BK-row slabs in S stages, shared
     bytes, packed weights or not);
  3. K2 against its plain versions at nsf6, d=10 (n=37, 256, 1024, 2048,
     4096) and d=50/h=256 (n=256, the sweep's population at any d, and
     4096), and at nsf3 on phase 10's shapes: d=2 (n=256, the imh
     mixture's population, and 2048, its flow-IS draws) and d=4 (n=128
     and 512, the imh_every Gaussian's):
     z, ladj and log_prob of the forward, and the
     layer inputs it saves for the backward; the gradients of the
     autograd.Function (forward kernel, then backward kernel), g_y
     included, against plain autograd of the plain forward on the same y,
     at the stated tolerance or twice the spread of plain autograd on the
     CPU against plain autograd on the card where that is larger; the
     backward kernel's g_y and weight and bias gradients
     against ``made_rqs_backward_ref`` and against plain autograd,
     transform by transform, on the layer inputs the forward kernel saved;
     rows in the spline tails (|y| >= 5), rows on a knot and rows of zero
     weight among the inputs. A value past the plain version's tolerance
     must lie within it of float64 (``check_values``), and a row whose
     input gradient is past the limit must lie within 1e-5 of a knot or a
     ReLU kink (in the float64 forward, or in the saved inputs the
     backward reads), and only such rows are left out (``grads_off_jumps``);
     phases 4 and 14 take the same rules;
  4. K1 (autoregressive inverse) against its plain version at the same
     shapes (n=1024 and 2048: the bridge's ``bridge_n`` for n_active up to
     512 and up to 1024; 2048 takes K1's two-row launch), plus the round
     trip forward(inverse(z)) = z. Then the rest of the menu
     (``MENU_SHAPES``): maf6 (K2 and K1 with the affine head) and nsfc6
     (K5) at d=10, n=37, 256, 1024 and 4096, maf6 and nsfc12 at d=50,
     n=256 and 4096, nsfc12 at d=50, n=1024 (the training batch) and
     65,536: forward, inverse, log_prob
     and the round trip against the plain versions, up to 1024 rows (256
     at d=50) the training gradient end to end and the backward kernel on
     the saved inputs, and a coupling transform's conditioning columns bit
     for bit;
  5. times of the three kernels and their plain versions: device time of
     one call (a CUDA graph of the call, replayed) and the time of an
     eager call (CUDA events around it), medians after warmup; K1's chain
     (the device time of one call at n=1) and the eager time of building
     its weight pack at d=10 and 50; one
     ``fit_stack`` batch step at d=10, batch 1024, on the kernel route
     and on plain autograd; the cost of the sweep's one scalar sync per
     step; the affine heads and K5 at the menu's shapes beside their plain
     versions, their bounds, K5's four products as torch.matmul and (n <=
     4096) its backward's products as torch.matmul/bmm; K2's backward also
     at d=50, n=1024 (the d=50 training batch), and its products, both
     heads, as torch.matmul/bmm;
  6. the main path: ``Sampler`` on the 10-D Rosenbrock quickstart with an
     N(0, 3) prior and default settings, ``run(n_total=4096,
     n_evidence=4096)``, checked against the exact logZ -21.4021 (+-0.35)
     and for launches of all three kernels; it prints each flow-IS
     evidence round's k-hat (with the n_total, iterations and calls it was
     drawn at) and the refinement rounds that ran;
  7. the black-box path: the same problem with a numpy likelihood called
     once per float64 row (``vectorize=False``) that returns a blob,
     ``blobs_dtype=np.float64`` and every other setting at its default:
     the host SMC loop, ``Flow.fit`` and the stepped sweep. Checked against
     the same logZ gate, for launches of all three kernels, for a host
     route and for blobs equal to the function of the returned x;
  8. ``evidence_ladder_bridge``: phase 6's quickstart with
     ``run(n_total=4096, n_evidence=0)``: the ladder-grade knobs
     (corr_threshold = bias_floor = 0.15) in the sweep, then the
     flow-anchored bridge on the device route, checked against the same
     logZ gate, for its diagnostics and for K1 launches inside the bridge;
  9. ``evidence_bridge_black_box``: phase 7's per-row numpy likelihood with
     ``run(n_evidence=0)``: the bridge's host route, same checks
     (corr_threshold 0.15; the bias-rate rule is off for a host
     likelihood, so its floor is 0);
 10. ``flow_free_and_kernels``: ``precondition=False`` with ``tpcn`` and
     ``rwm`` on the 6-D correlated Gaussian of tests/test_statistical.py
     (its settings, ``n_evidence=0``, +-0.35), on the device loop and with
     ``device_loop=False``; ``sample="imh"`` on tests/test_imh.py's bimodal
     mixture (logZ +-0.3, mode mass +-0.1); ``imh_every=2`` on its 4-D
     Gaussian (+-0.4, calls below 1.5x the run with ``imh_every=0``);
 11. ``reference_surface``: a script written against the reference, on
     phase 6's problem: (a) ``Prior([scipy.stats.norm(0, 3)] * 10)`` with
     ``save_every=10`` on a one-rank NCCL mesh (phase 15 (a)), which must
     repeat phase 6's logZ and calls bit for bit; (b) a prior in numpy alone (``logpdf``/``rvs``/``bounds``/``dim``),
     which takes the host route and the host loop, stays in the logZ gate,
     sees only finite rows and launches all three kernels; (c) on (a)'s
     states, a sampler of another ``random_state`` that resumes from the
     state saved at t=20 (logZ in the gate, t >= the finished run's t - 2),
     and the finished run through ``save_state``/``load_state`` (posterior,
     evidence and the CUDA generator's state bit for bit). The states are
     written under ``build/`` and removed;
 12. ``flow_menu``: (a) phase 6's quickstart with ``flow="maf6"`` and with
     ``flow="nsfc6"`` (the same logZ gate, launches of the affine heads or
     of K5 and of no other kind's kernels); (b) the JAX package's
     compute-bound bench line (``bench.py:276-286``): the d=50 Rosenbrock,
     nsfc12, 65,536 particles, the preconditioned t-pCN sweep with the
     stopping rule held off, exactly 4 steps x 2 chained sweeps, its
     particle-steps/s and peak device memory;
 13. ``gradient_kernels``, ``sample="mala"``/``"hmc"``: (a) the gradients of
     the inverses (``GRAD_SHAPES``: K1-bwd with the spline head at nsf6,
     d=10, n=37, 256, 1024, 4096, nsf3 at d=4 and nsf6 at d=50; with the
     affine head at maf6, d=10 and 50; K5-inv-bwd at nsfc6, d=10 and nsfc12,
     d=50; nsf3 and maf3 at d=342, h=2048, where K1-bwd's groups go in
     fan-in chunks) through the kernels by autograd against plain autograd
     of the plain inverses (``check_gradient``: rows on a knot or a ReLU kink
     left out; each also against float64), then their device and eager
     times beside their plain versions, the inverse's save instance each
     gradient reads (K1's, which writes K1-bwd's state, and K5's inverse's,
     which writes K5-inv-bwd's) beside the inverse without it, and their
     bounds; the save instance must give the inverse's x and log-det bit
     for bit; (b)
     phase 6's quickstart with
     ``sample="mala"`` (the same logZ gate, launches of
     K2, K1 and K1-bwd, sweep steps and ms a sweep step); (c)
     tests/test_mala.py:97-144's two runs, mala and hmc (d=4, nsf3,
     n_active 128, analytic logZ +-0.35); (d) a preconditioned mala sweep of 20 steps at
     d=10, n=256 on phase 12's random maf6 and nsfc6 flows (finite states,
     mean acceptance in (0.2, 0.98), launches of K1-bwd's affine head and
     of K5-inv-bwd, and no K5 forward launch in nsfc6's 20 steps: its
     gradient reads the inverse's saved state); (e) the same 20-step mala sweep on random nsf flows
     at d=50, nsf6, n=4096 (ms a step, acceptance) and at d=342, nsf3,
     n=256 (it must run: finite states and gradients);
 14. ``spline_bins``, ``Flow(bins=)`` at other bins than 8: (a) the wait
     for phase 2's background build of their libraries; (b) every
     spline-head kernel against its plain version (and float64 where
     phases 4 and 13 hold it so) at those phases' tolerances and exclusion
     windows, at 16 bins (the most of a compiled library) and at 17, 32,
     64, 128, 512 and 1000 (``WIDE_BINS``: the library of run-time bins, up
     to the most a spline holds): K2, its gradient end to end, K2-bwd, K1
     and its round trip, K5's forward, inverse and backward, K1-bwd and
     K5-inv-bwd at (d, n) = (10, 256), and at 16 and 32 bins also K1's two-
     and four-row launches (10, 2048), (10, 4096), (50, 1024) and nsf3 at
     (342, 64) (K2, K1), and (50, 1024) (K5 on nsfc12, K1-bwd, K5-inv-bwd);
     past 16 bins every reference in float64 (``NARROW_TOL``'s comment);
     (c) the 16- and 32-bin kernels timed at the kernels line's shapes as
     phase 5 times the 8-bin ones, beside their plain versions, bounds and
     products as torch.matmul/bmm, and the plain spline's compensated sums
     inside a CUDA graph (their device route) against their host route, bit
     for bit (the plain forward at 32 and 1000 bins, the inverse at 32); (d)
     phase 6's quickstart with
     ``flow=Flow(10, "nsf6", bins=32)`` (the same logZ gate, launches of
     the 32-bin K2, K2-bwd and K1 and of no other kernel; each evidence
     round's k-hat and the refinement rounds, as phase 6); (e) a 20-step
     mala sweep at d=10, n=256 on random nsf6 and nsfc6 flows of 16 and of
     32 bins, as phase 13 (d); (f) the 32-bin quickstart's state through
     ``save_state``/``load_state`` into a sampler of another seed, bit for
     bit;
 15. ``mesh``, the particles split over ``torch.distributed`` ranks
     (``pocomc_tpu_torch.parallel``): (a) one rank over NCCL in this
     process, phase 6's quickstart with ``mesh=``, which must repeat phase
     6's logZ and calls bit for bit (run and checked in phase 11 (a),
     reported here); (b) ``parallel.smoke.launch`` of two
     ranks sharing the card over gloo, run beside phase 14 (b)'s checks
     (processes of their own), with the JAX harness's cases (the
     sharded reduction and gather, the black-box fan-out, the sweep on each
     rank's rows, the device and host loops, a checkpoint resumed) and the
     quickstart on each rank's half of the particles: equal checksums,
     logZ in the gate, launches of K1, K2 and K2-bwd on each rank, no sweep
     K1 launch past 128 rows and no black-box sweep call past n_active/2
     rows; the backend, the walls beside phase 6's and the all_reduce
     calls a sweep step are printed;
 16. ``custom_flow``, ``Sampler(flow=<a protocol object>)`` and the live
     sweep stats (``mcmc.set_live_sink``), each run with ``progress=True``
     (the bar's text kept off the log): (a) phase 6's quickstart with
     ``flow=`` a plain object that holds a stock ``Flow(10, "nsf6")`` and
     forwards every protocol member to it, device surface included: the
     device loop, phase 6's logZ and calls bit for bit, phase 6's K1, K2
     and K2-bwd launch counts, and at least (sweep steps - 2 x sweeps)
     live progress-bar updates; (b) the protocol-minimal ``AffineFlow`` of
     tests/test_observability.py in torch on its problem (d=2,
     n_effective 256, n_active 128, n_total 512, n_evidence 1024): the
     host loop, logZ within max(4 logz_err, 0.3) of 2 * norm.logpdf(0, 0,
     sqrt(26)), no stock flow kernel, and a pickle round trip that keeps
     the object, its parameters and the evidence. Each run's wall, calls,
     logZ, loop, live updates and phase seconds are printed;
 17. ``statistical``, tests/test_statistical.py's preconditioned known
     answers at its settings, seed and gates (``statistical``; nsf3, so
     K2, K2-bwd and K1): the bimodal mixture (logZ within max(4 err,
     0.15), the mass of the mode at +4 within 0.1) and Neal's funnel with
     fixed data (E[v] within 0.35, SD[v] within 35 %, logZ within max(4
     err, 0.35) of the quadrature), each run's launches printed.

The script is bound by the host (the card is idle most of the time), so
phases run in two lanes. What is timed runs alone: first phases 1-9, 12
(b), 13 (b) and 13 (e). Then two processes share the host and the card:
this one runs phases 11, 13 (a)'s checks, 13 (c)-(d) and 14 (a)-(b), with
phase 15 (b)'s two ranks beside 14 (b), and a second process of this
script (``--side``, ``side_lane``) runs phases 10, 12 (a), 16, 17 and 14
(d)-(f), each with its own gates and launch counts; their walls include
the other processes' load. 13 (a)'s times and 14 (c) run once the second
process has ended; its lines print then, its parts on the
``second_process`` line.

Every path (phases 6-17) runs with the launch counts set to 0 just before
it and read just after, and fails unless every kernel of the path ran.
Each phase line carries ``parts_s``, the seconds of each lettered part of
the phase ("14 (b) b1000 check_gradient"; every second of the script lies
in one part), and ``elapsed_s``; the ``parts`` line before the kernels line
has them all, their sum and the host's cores. Then the kernels line and,
last, the contract
line. Any failed check exits non-zero before those two lines. Without a
CUDA device it exits 1.
"""

import copy
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TRUE_LOGZ = -21.4021
LOGZ_GATE = 0.35
SEED = 0
# (flow, n_dim, n_particles) for the checks, h = max(next_pow2(3d), 32): nsf6
# at the quickstart's d and a wide one, nsf3 at phase 10's
SHAPES = [("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1024), ("nsf6", 10, 2048),
          ("nsf6", 10, 4096), ("nsf6", 50, 256), ("nsf6", 50, 4096),
          ("nsf3", 2, 256), ("nsf3", 2, 2048), ("nsf3", 4, 128), ("nsf3", 4, 512)]
# the shapes phase 5 times: those, and d=50 at the training batch (1024)
TIMED = sorted({(d, n) for flow, d, n in SHAPES if flow == "nsf6" and n != 37} | {(50, 1024)})
# stated tolerances: rtol/atol on z and x, atol on ladj, and on gradients
# max |diff| over max |grad| of each tensor. At d=10 the kernel and torch
# sum the same ~1.5k terms per output in another order; at d=50 (h=256)
# each output sums ~10x more terms and the inverse feeds each dimension's
# rounding into the next 49 steps of 6 transforms. d=2 and 4 take d=10's.
TOL = {10: dict(rtol=1e-5, atol=1e-5, ladj=1e-4, grad=1e-4),
       50: dict(rtol=1e-4, atol=1e-4, ladj=2e-3, grad=1e-3)}
# the H100 SXM's published peaks:
# fp32 outside the tensor cores and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# the kernels by head: the nsf* flows' (K2 and K1 with the spline head),
# the maf* flows' (the same with the affine head) and the nsfc* flows' (K5)
RQS = ("made_rqs_forward", "made_rqs_backward", "ar_inverse")
AFFINE = ("made_rqs_forward_affine", "made_rqs_backward_affine", "ar_inverse_affine")
COUPLING = ("coupling_forward", "coupling_inverse", "coupling_backward")
# the gradient kernels of the inverses (phase 13): K1-bwd with each head and
# K5-inv-bwd (the inverse instances of K5's backward)
GRADIENT = ("ar_inverse_backward", "ar_inverse_backward_affine", "coupling_inverse_backward")
KERNELS = RQS + AFFINE + COUPLING + GRADIENT
# the CUDA sources, one library each and bins (both heads in each of the
# first four)
LIBRARIES = ("made_rqs_forward", "made_rqs_backward", "ar_inverse", "ar_inverse_backward",
             "coupling_forward", "coupling_backward")
# (flow, n_dim, n_particles) of the rest of the menu for phases 3-5: maf6
# and nsfc6 at the quickstart's d=10 (37 a ragged tile, 256 the sweep, 1024
# the training batch, 4096 the evidence draws), maf6 and nsfc12 at d=50
# (256 and 4096), and nsfc12 at d=50, n=65,536: the JAX package's
# compute-bound bench line (bench.py:276-286), phase 12's sweep
MENU_SHAPES = [("maf6", 10, 37), ("maf6", 10, 256), ("maf6", 10, 1024), ("maf6", 10, 4096),
               ("nsfc6", 10, 37), ("nsfc6", 10, 256), ("nsfc6", 10, 1024), ("nsfc6", 10, 4096),
               ("maf6", 50, 256), ("maf6", 50, 4096), ("nsfc12", 50, 256), ("nsfc12", 50, 1024),
               ("nsfc12", 50, 4096), ("nsfc12", 50, 65536)]
# gradients are checked up to these rows (training batches are at most 1024)
MENU_GRAD_ROWS = {10: 1024, 50: 256}
# the menu's random output layers: std MENU_SCALE * sqrt(32 / h), scaled
# with the layer's fan-in h so that the head parameters spread as at h=32
# (d <= 10). At 0.02 unscaled, nsfc12 at d=50 (h=256) is ill-conditioned
# in fp32 itself: its plain fp32 inverse lies 0.17 from float64 (CPU, n=256)
# and 0.43 on the card, where at 0.02 * sqrt(32/256) it lies 5.7e-5 away
MENU_SCALE = 0.02
# a coupling stack's (value, log-det) atol: the spline turns the MLP's
# rounding, summed in another order, into up to 3.1e-5 on values and
# 1.2e-4 on log-dets at d=10 (the plain version on the CPU against the JAX
# package, and K5 against its plain version on the card), 5x K2's
# tolerance; d=50 takes 5x TOL[50]'s. K5's values and log-dets are held to
# the plain version in float64: within this atol, or within 4x the plain
# fp32 version's own distance from float64 where that is larger (the fp32
# coupling inverse is 3.9e-5 from float64 at d=10, n=4096 on the CPU; nsf6's
# autoregressive inverse 7.8e-6)
COUPLING_TOL = {10: (5e-5, 5e-4), 50: (5e-4, 1e-2)}
# (flow, n_dim, n_particles) of phase 13 (a), the inverses' gradient
# kernels: K1-bwd with the spline head at nsf6, d=10 (37 a ragged tile, 256
# the sweep, 1024 and 4096: K1's one-, two- and four-row launches), nsf3 at
# d=4 (tests/test_mala.py's), nsf6 at d=50 (h=256); with the affine head
# maf6 at d=10 and d=50; both heads at d=342 (nsf3, maf3: h=2048, groups in
# fan-in chunks; the menu's scaled output layers); K5-inv-bwd at nsfc6, d=10
# and nsfc12, d=50. Past d=10 the gradients take TOL[50]'s tolerance.
GRAD_SHAPES = [("nsf6", 10, 37), ("nsf6", 10, 256), ("nsf6", 10, 1024), ("nsf6", 10, 4096),
               ("nsf3", 4, 128), ("nsf6", 50, 256), ("nsf6", 50, 4096), ("maf6", 10, 256),
               ("maf6", 50, 4096), ("nsf3", 342, 64), ("maf3", 342, 64), ("nsfc6", 10, 256),
               ("nsfc6", 10, 1024), ("nsfc12", 50, 256), ("nsfc12", 50, 4096)]
# arithmetic of one element's inverse VJP (heads.cuh inverse_vjp), counted
# from the source, a transcendental as one operation: for the spline 56 a
# bin (each bin's two softmax terms and running sums, its interior
# derivative's softplus and sigmoid, its bin search and edge selects, and
# the VJPs of its sizes and derivative) and 112 for the bin's local
# quantities, slope and chain, so 560 at 8 bins and 1,008 at 16; the affine
# map's 12. The bounds count it beside the products.
def element_vjp_ops(head, bins=8):
    return 112 + 56 * bins if head == "rqs" else 12


# phase 14: the spline bins past 8 that it holds against the plain
# versions: 16, the most of a library compiled for its bins (SPLINE_BINS;
# 2-11 are held by the CPU tests and the `gpu` tests' bins cases: each
# compiled bins costs six libraries of the build), and past 16 the library
# of run-time bins (0 in LIBRARY_BINS, one library a source for every bins)
# at 17 (its fewest), 32, 64, 128 (where K5's output group of one
# dimension passes an output pass), 512 (half the interval's width and
# height left to the parameters' softmax) and 1000 (the most a spline
# holds, 1 - MIN_BIN * bins = 0: every bin MIN_BIN of the interval whatever
# the parameters, and the ceiling: no plan refuses less); the bins timed,
# whose kernels are also held at the wider shapes, and those of (d)'s
# quickstart
SPLINE_BINS = (16,)
WIDE_BINS = (17, 32, 64, 128, 512, 1000)
# Past 16 bins one rule holds every spline kernel: the reference is the
# plain version in float64 (an fp32 route's knots are running sums of up
# to 999 sizes: taken by a plain torch.cumsum at nsfc12, d=50, 32 bins, the
# end-to-end gradient lay 4.3e-2 of the largest from float64, with the
# kernels' compensated sums 1.6e-4), values by
# ``check_values`` and gradients by ``grads_off_jumps`` at TOL's
# tolerances, and the weight gradients, sums over the rows, without the
# rows within 1e-5 of a knot or ReLU kink (a row whose two sides fp32 and
# float64 take differently moves every weight gradient and not always its
# own input gradient: at nsfc12, d=50, 32 bins, 44 such rows carried the
# weight gradients' 3.7e-2). Where the bins are narrow a spline's log-det
# moves ~10 a unit of its input, so the fp32 rounding of the transforms'
# inputs alone puts a d=10 row's log-det ~1e-4 from float64, whatever
# route computes it: at 1000 bins the kernels' log-dets lie 1.2-1.4e-4
# from float64 and a plain fp32 cumsum's 2.0-2.5e-4, K2-bwd's and
# K5-bwd's gradients 1.9e-4 and 2.7e-4 of the largest (nsf6 and nsfc6,
# (10, 256); PERF.md §6). At 1000 bins the log-det and gradient
# tolerances are therefore limits set from those readings (``narrow_tol``:
# the larger of TOL's and these), about 2.2x the kernels' largest; at 512
# bins the kernels hold TOL's (log-dets within 7.9e-5 of float64)
NARROW_TOL = {1000: dict(ladj=3e-4, grad=6e-4)}
LIBRARY_BINS = (8, 16, 0)
TIMED_BINS = (16, 32)
QUICK_BINS = 32
# The kernel checks of phases 3-4, 13 (a) and 14 (b), each (phase, family,
# flow, d, n, bins): the phase runs ``family`` (``check_spline_made``,
# ``check_menu`` or ``check_gradient``) at n rows on a random flow of that
# kind, width and spline bins, against its plain version or float64.
# Phases 3-4 hold SHAPES and MENU_SHAPES, 13 (a) GRAD_SHAPES, and 14 (b)
# every spline kernel at 16 bins and every WIDE_BINS at (10, 256), and at
# each TIMED_BINS also K1's two- and four-row launches, d=50 and nsf3 at
# d=342 (K2, K1) and d=50 (K5, the gradient kernels). The phases iterate
# over it; tests/test_torch_smoke_plan.py holds that no check is dropped.
CHECKED_BINS = SPLINE_BINS + WIDE_BINS
CHECK_PLAN = tuple(
    [("3-4", "check_spline_made", f, d, n, 8) for f, d, n in SHAPES]
    + [("3-4", "check_menu", f, d, n, 8) for f, d, n in MENU_SHAPES]
    + [("13 (a)", "check_gradient", f, d, n, 8) for f, d, n in GRAD_SHAPES]
    + [("14 (b)", "check_spline_made", "nsf6", 10, 256, b) for b in CHECKED_BINS]
    + [("14 (b)", "check_spline_made", f, d, n, b) for b in TIMED_BINS
       for f, d, n in (("nsf6", 10, 2048), ("nsf6", 10, 4096), ("nsf6", 50, 1024),
                       ("nsf3", 342, 64))]
    + [("14 (b)", "check_menu", "nsfc6", 10, 256, b) for b in CHECKED_BINS]
    + [("14 (b)", "check_menu", "nsfc12", 50, 1024, b) for b in TIMED_BINS]
    + [("14 (b)", "check_gradient", f, 10, 256, b) for f in ("nsf6", "nsfc6")
       for b in CHECKED_BINS]
    + [("14 (b)", "check_gradient", f, 50, 1024, b) for b in TIMED_BINS
       for f in ("nsf6", "nsfc12")])


def planned(phase, family):
    """(flow, d, n, bins) of CHECK_PLAN's checks of a phase and family, in
    the plan's order."""
    return [c[2:] for c in CHECK_PLAN if c[:2] == (phase, family)]


def quickstart_like(x):
    """The quickstart's likelihood, the 10-D Rosenbrock, on (n, 10) torch
    rows."""
    return -(10.0 * (x[:, ::2] ** 2 - x[:, 1::2]) ** 2 + (x[:, ::2] - 1.0) ** 2).sum(-1)


def quickstart_prior(pt):
    """The quickstart's prior, N(0, 3) in each of the 10 dimensions."""
    return pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])


def unit_gauss(x):
    """Phases 13 (d)-(e) and 14 (e)'s likelihood, a unit Gaussian."""
    return -0.5 * (x * x).sum(-1)


def rosenbrock_row(x):
    """Phase 7's black-box likelihood: the quickstart Rosenbrock on one
    float64 numpy row, with sum(x^2) as its blob."""
    logl = -np.sum(10.0 * (x[::2] ** 2 - x[1::2]) ** 2 + (x[::2] - 1.0) ** 2)
    return float(logl), float(np.dot(x, x))


class TimedLikelihood:
    """Counts the rows and host seconds spent inside a per-row likelihood."""

    def __init__(self, fn):
        self.fn, self.rows, self.seconds = fn, 0, 0.0

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.fn(x)
        self.seconds += time.perf_counter() - t0
        self.rows += 1
        return out


def with_bins(name, bins):
    """A kernel's name in the launch counts and the kernels line at the
    spline's bins: ``made_rqs_forward_b16``; the 8-bin one keeps its name,
    and a library of run-time bins (bins 0) is ``<source>_bN``."""
    return name if bins == 8 else (f"{name}_bN" if bins == 0 else f"{name}_b{bins}")


def _counter(name):
    """(wrapper, attribute) of a kernel's launch count; a name ending in
    _b<bins> counts the spline of those bins."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    base, bins = name, 8
    if "_b" in name and name.rsplit("_b", 1)[1].isdigit():
        base, tail = name.rsplit("_b", 1)
        bins = int(tail)
    if base.endswith("_affine"):
        return getattr(fk, base[:-len("_affine")]), "launches_affine"
    return (getattr(ck if base.startswith("coupling") else fk, base),
            fk.launch_attr("rqs", bins))


def reset_launches(fk=None):
    """Every kernel's launch count, each head and each bins, set to 0."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    fk.zero_counts([getattr(fk, k) for k in RQS] + [getattr(ck, k) for k in COUPLING]
                   + [fk.ar_inverse_backward, ck.coupling_inverse_backward])


def read_launches(fk=None, names=RQS):
    return {name: getattr(*_counter(name), 0) for name in names}


def watch_bridge(sampler, fk):
    """Wrap the sampler's bridge so that it records K1's launches inside
    it and the sweep's decorrelation knobs the run used."""
    real, seen = sampler._compute_bridge_evidence, {}

    def counted():
        before = fk.ar_inverse.launches
        seen.update(corr_threshold=sampler._sweep.corr_threshold,
                    bias_floor=sampler._sweep.bias_floor)
        res = real()
        seen["k1_launches"] = fk.ar_inverse.launches - before
        return res

    sampler._compute_bridge_evidence = counted
    return seen


def watch_evidence(sampler):
    """Wrap the sampler's flow-IS evidence so that it records each round:
    its k-hat and the n_total, iterations and calls it was drawn at (a
    round past the first is a refinement, run at doubled n_total after a
    k-hat over 0.7)."""
    real, rounds = sampler._compute_evidence, []

    def logged(*a, **k):
        out = real(*a, **k)
        rounds.append(dict(khat=float(sampler.evidence_khat), n_total=int(sampler.n_total),
                           iterations=int(sampler.t), calls=int(sampler.calls)))
        return out

    sampler._compute_evidence = logged
    return rounds


def check_bridge(name, sampler, seen, bias_floor):
    """Phase 8/9 gates: logZ, the bridge's diagnostics and calls, the
    ladder-grade knobs (corr_threshold 0.15 and the given bias_floor: 0.15
    with the bias-rate rule on, 0 for a host likelihood, where it is off)
    and K1 inside the bridge. Returns the numbers to report."""
    logz, dlogz = sampler.evidence()
    bd = sampler.bridge_diagnostics
    if bd is None:
        fail(f"{name}: no bridge diagnostics")
    ladder = float(sampler.particles.compute_logw_and_logz(1.0, recorrect=True)[1])
    out = dict(logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ, ladder_logz=ladder,
               rungs=bd["rungs"], bridge_calls=bd["calls"], ess_min=bd["ess_min"],
               accept_last=bd["accept_last"], s_path=[float(v) for v in bd["s_path"]],
               bridge_n=sampler.bridge_n, k1_launches_in_bridge=seen.get("k1_launches"),
               corr_threshold=seen.get("corr_threshold"), bias_floor=seen.get("bias_floor"))
    if not (bd["rungs"] >= 1 and bd["calls"] >= sampler.bridge_n):
        fail(f"{name}: {bd['rungs']} rungs, {bd['calls']} bridge calls for bridge_n="
             f"{sampler.bridge_n}")
    if not seen.get("k1_launches"):
        fail(f"{name}: K1 was not launched inside the bridge")
    if not (seen.get("corr_threshold") == 0.15 and seen.get("bias_floor") == bias_floor):
        fail(f"{name}: the sweep ran with corr_threshold {seen.get('corr_threshold')} and "
             f"bias_floor {seen.get('bias_floor')}, not 0.15 and {bias_floor}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"{name}: logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if not (dlogz is not None and np.isfinite(dlogz)):
        fail(f"{name}: no finite bridge error bar ({dlogz})")
    return out


def correlated_gaussian():
    """tests/test_statistical.py:14-40: a 6-D Gaussian of condition number
    100 under N(0, 25^2) priors, as a torch likelihood, and its logZ."""
    from scipy.stats import multivariate_normal
    d = 6
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (q * np.logspace(0, 2, d)) @ q.T
    cov_inv = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    norm_const = float(-0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1]))

    def log_like(x):
        return norm_const - 0.5 * torch.einsum("ni,ij,nj->n", x, cov_inv.to(x), x)

    truth = multivariate_normal.logpdf(np.zeros(d), np.zeros(d), cov + 625.0 * np.eye(d))
    return log_like, d, truth


def mixture(d=2, sep=4.0, sig=0.5, w1=0.6):
    """tests/test_imh.py:14-30: a two-mode Gaussian mixture under N(0, 10^2)
    priors, as a torch likelihood; its logZ and the mass of the mode at
    +sep."""
    c = d * math.log(math.sqrt(2 * math.pi) * sig)

    def log_like(x):
        l1 = -0.5 * ((x - sep) ** 2).sum(-1) / sig ** 2 - c
        l2 = -0.5 * ((x + sep) ** 2).sum(-1) / sig ** 2 - c
        return torch.logaddexp(l1 + math.log(w1), l2 + math.log(1.0 - w1))

    var = sig ** 2 + 100.0
    z = np.exp(-0.5 * d * sep ** 2 / var) / (2 * np.pi * var) ** (d / 2)
    return log_like, np.log(z), w1


def funnel(sv=2.0, sn=0.5, data=(1.2, -0.8), half=30.0):
    """tests/test_statistical.py:78-140: Neal's funnel with observed data,
    v ~ N(0, sv^2), y_i | v ~ N(0, e^v) inside the likelihood, d_i ~ N(y_i,
    sn^2), y_i ~ U(-half, half) in the prior. A torch likelihood; the
    prior's (loc, scale) of v and half; and, by that test's quadrature over
    v (y marginalised analytically), logZ and the posterior mean and SD of
    v."""
    from scipy.stats import norm
    data = np.asarray(data)
    c = data.size * math.log(math.sqrt(2 * math.pi) * sn)

    def log_like(x):
        v, y = x[..., 0], x[..., 1:]
        lp_y = (-0.5 * (y * y).sum(-1) / torch.exp(v)
                - (y.shape[-1] / 2) * (v + math.log(2 * math.pi)))
        dt = torch.as_tensor(data, dtype=x.dtype, device=x.device)
        return lp_y - 0.5 * ((y - dt) ** 2).sum(-1) / sn ** 2 - c

    vs = np.linspace(-12, 12, 20001)
    log_joint = norm.logpdf(vs, 0, sv) + np.sum(
        norm.logpdf(data[None, :], 0, np.sqrt(np.exp(vs)[:, None] + sn ** 2)), axis=1)
    m = log_joint.max()
    joint = np.exp(log_joint - m)
    logz = m + np.log(np.sum(joint) * (vs[1] - vs[0])) - data.size * np.log(2 * half)
    v_mean = np.sum(vs * joint) / np.sum(joint)
    v_sd = np.sqrt(np.sum((vs - v_mean) ** 2 * joint) / np.sum(joint))
    return log_like, (0.0, sv), half, logz, v_mean, v_sd


def statistical(pt, device, fk=None):
    """Phase 17: tests/test_statistical.py's two preconditioned known
    answers at its settings, seeds and gates, on ``device``: the bimodal
    mixture (nsf3, t-pCN, n_total 1024, n_evidence 2048: logZ within
    max(4 err, 0.15), the mass of the mode at +4 within 0.1) and the funnel
    with fixed data (nsf3, n_total 2048, n_evidence 2048: E[v] within 0.35,
    SD[v] within 35 %, logZ within max(4 err, 0.35)). Returns a row a run
    and the failed gates (empty when all hold); given ``fk``, each row also
    has the launches of the nsf* kernels in its run."""
    rows, failed = [], []

    def drive(label, prior, like, run_kw, **kw):
        s = pt.Sampler(prior, like, vectorize=True, random_state=0, n_effective=512,
                       n_active=256, precondition=True, flow="nsf3", device=device, **kw)
        if fk is not None:
            reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        if device == "cuda":
            torch.cuda.synchronize()
        logz, err = s.evidence()
        x, w, _, _ = s.posterior()
        row = dict(run=label, logz=logz, dlogz=err, calls=s.calls, iterations=s.t,
                   khat=s.evidence_khat, wall_s=time.perf_counter() - t0)
        if fk is not None:
            row["launches"] = read_launches(fk)
        rows.append(row)
        lap(f"17 {label}")
        return row, x, w / w.sum()

    def gate(label, name, got, want, tol):
        if not (np.isfinite(got) and abs(got - want) <= tol):
            failed.append(f"{label}: {name} {got} outside {want} +- {tol}")

    mx_like, mx_logz, mx_mass = mixture()
    row, x, w = drive("mixture", pt.Prior([pt.Normal(0.0, 10.0) for _ in range(2)]), mx_like,
                      dict(n_total=1024, n_evidence=2048),
                      train_config=dict(epochs=60, patience=8))
    row.update(true_logz=mx_logz, mode_mass=float(w[x[:, 0] > 0].sum()), true_mode_mass=mx_mass)
    gate("mixture", "logZ", row["logz"], mx_logz, max(4 * (row["dlogz"] or 0.1), 0.15))
    gate("mixture", "mode mass", row["mode_mass"], mx_mass, 0.1)

    fn_like, (v_loc, v_scale), half, fn_logz, v_mean, v_sd = funnel()
    prior = pt.Prior([pt.Normal(v_loc, v_scale), pt.Uniform(-half, half),
                      pt.Uniform(-half, half)])
    row, x, w = drive("funnel", prior, fn_like, dict(n_total=2048, n_evidence=2048),
                      train_config=dict(epochs=120, patience=8))
    got_mean = float((w * x[:, 0]).sum())
    got_sd = float(np.sqrt((w * (x[:, 0] - got_mean) ** 2).sum()))
    row.update(true_logz=fn_logz, v_mean=got_mean, true_v_mean=v_mean, v_sd=got_sd,
               true_v_sd=v_sd)
    gate("funnel", "E[v]", got_mean, v_mean, 0.35)
    gate("funnel", "SD[v]", got_sd, v_sd, 0.35 * v_sd)
    gate("funnel", "logZ", row["logz"], fn_logz, max(4 * (row["dlogz"] or 0.1), 0.35))
    return rows, failed


class NumpyNormalPrior:
    """Phase 11 (b)'s prior, N(0, sd) in every dimension in numpy alone (the
    reference's duck-typed protocol); it fails on a non-finite row and
    counts the rows and host seconds it spends."""

    def __init__(self, dim, sd):
        self.dim, self.sd = dim, sd
        self.bounds = np.array([[-np.inf, np.inf]] * dim)
        self.rows, self.seconds = 0, 0.0

    def logpdf(self, x):
        t0 = time.perf_counter()
        if not (isinstance(x, np.ndarray) and np.isfinite(x).all()):
            raise ValueError("the host prior was handed a non-finite row")
        out = (-0.5 * np.sum((x / self.sd) ** 2, axis=1)
               - self.dim * math.log(self.sd * math.sqrt(2 * math.pi)))
        self.seconds += time.perf_counter() - t0
        self.rows += len(x)
        return out

    def rvs(self, size, random_state=None):
        return np.random.default_rng(random_state).normal(0.0, self.sd, (size, self.dim))


def reference_surface(pt, fk, log_like, main, states, device="cuda", mesh=None, **kw):
    """Phase 11 on phase 6's problem (see the module docstring): ``main``
    holds phase 6's logz, calls and iterations, ``states`` is the
    directory the states go to, ``mesh`` the mesh (a) runs on, ``kw`` the
    Sampler's settings beyond the defaults. Returns (the numbers to
    report, launches by path); exits through ``fail`` on a failed check."""
    from scipy import stats

    def drive(letter, label, prior, run_kw, **skw):
        s = pt.Sampler(prior, log_like, vectorize=True, device=device, **{**kw, **skw})
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = read_launches(fk)
        rows[label] = dict(logz=s.logz, dlogz=s.logz_err, calls=s.calls, iterations=s.t,
                           wall_s=wall, prior_route=s.prior_route,
                           device_loop=s._use_device_loop(), phase_s=dict(s.phase_seconds),
                           launches=launches[label],
                           mesh_backend=s.mesh and torch.distributed.get_backend())
        lap(f"11 {letter} {label}")
        return s

    launches, rows = {}, {}
    run_kw = dict(n_total=4096, n_evidence=4096)
    d = 10
    # (a) scipy.stats columns, converted, with (c)'s save_every, on
    # ``mesh``: phase 6's run bit for bit, writing its states (one run
    # holds the three checks)
    shutil.rmtree(states, ignore_errors=True)
    s = drive("(a)", "scipy_prior_save_every", pt.Prior([stats.norm(0, 3)] * d),
              dict(run_kw, save_every=10), random_state=0, output_dir=states, mesh=mesh)
    if not (s.prior_route == "device" and s._use_device_loop()):
        fail("reference_surface (a): the scipy prior did not take the device loop")
    if (s.logz, s.calls) != (main["logz"], main["calls"]):
        fail(f"reference_surface (a): with save_every on the one-rank mesh, logZ "
             f"{s.logz} and {s.calls} calls differ from phase 6's {main['logz']} and "
             f"{main['calls']}")
    done = s
    # (b) a prior in numpy alone: the host route and the host loop
    host_prior = NumpyNormalPrior(d, 3.0)
    s = drive("(b)", "host_prior", host_prior, run_kw, random_state=0)
    rows["host_prior"].update(prior_rows=host_prior.rows, prior_s=host_prior.seconds)
    if s.prior_route != "host" or s._use_device_loop():
        fail("reference_surface (b): the numpy prior did not take the host route and loop")
    if not (np.isfinite(s.logz) and abs(s.logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"reference_surface (b): logZ {s.logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    # (c) (a)'s states: a resume by a sampler of another seed, a round trip
    s = done
    saved = sorted(p.name for p in states.glob("pmc_*.state"))
    r = drive("(c)", "resume", pt.Prior([pt.Normal(0.0, 3.0)] * d),
              dict(run_kw, resume_state_path=states / "pmc_20.state"), random_state=1)
    rows["resume"]["t_done"] = s.t
    if not (np.isfinite(r.logz) and abs(r.logz - TRUE_LOGZ) < LOGZ_GATE and r.t >= s.t - 2):
        fail(f"reference_surface (c): the resumed run ended at logZ {r.logz}, t={r.t} "
             f"(gate {TRUE_LOGZ} +- {LOGZ_GATE}, t >= {s.t - 2})")
    s.save_state(states / "done.state")
    back = pt.Sampler(pt.Prior([pt.Normal(0.0, 3.0)] * d), log_like, vectorize=True,
                      device=device, **{**kw, "random_state": 2})
    back.load_state(states / "done.state")
    same = (back.evidence() == s.evidence()
            and all(np.array_equal(a, b) for a, b in zip(back.posterior(), s.posterior()))
            and back._gen.device.type == s._gen.device.type
            and torch.equal(back._gen.get_state(), s._gen.get_state()))
    if not same:
        fail("reference_surface (c): a finished run did not round-trip through "
             "save_state/load_state bit for bit")
    shutil.rmtree(states, ignore_errors=True)
    lap("11 (c) round trip")
    return dict(runs=rows, states_saved=saved, roundtrip_bit_for_bit=same,
                generator=s._gen.device.type), launches


class HostDelegatingFlow:
    """A plain object of the preconditioner protocol
    (``pocomc_tpu_torch.models.protocol``), not a ``Flow``: it holds a stock
    ``Flow`` and forwards every member and the checkpoint pair to it, but
    not the device loop's surface (so the host loop runs)."""

    def __init__(self, flow):
        self.inner = flow

    def params(self):
        return self.inner.params()

    def kernel_fwd(self, u, fp=None):
        return self.inner.kernel_fwd(u, fp)

    def kernel_inv(self, theta, fp=None):
        return self.inner.kernel_inv(theta, fp)

    def forward(self, u, fp=None):
        return self.inner.forward(u, fp)

    def sample(self, size=1, generator=None, fp=None):
        return self.inner.sample(size, generator, fp)

    def sample_t(self, size, nu, generator=None, fp=None):
        return self.inner.sample_t(size, nu, generator, fp)

    def fit(self, x, weights=None, **kwargs):
        return self.inner.fit(x, weights=weights, **kwargs)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        return self.inner.load_state_dict(state)


class DelegatingFlow(HostDelegatingFlow):
    """Phase 16 (a)'s custom flow: ``HostDelegatingFlow`` with the device
    loop's surface (``protocol.DEVICE_SURFACE``) forwarded too."""

    def parameters(self):
        return self.inner.parameters()

    def _loss_fn(self, *args, **kwargs):
        return self.inner._loss_fn(*args, **kwargs)

    def get_pre(self):
        return self.inner.get_pre()

    def set_pre(self, pre):
        self.inner.set_pre(pre)

    @property
    def whiten(self):
        return self.inner.whiten

    @property
    def whiten_mode(self):
        return self.inner.whiten_mode

    def _latent_draws(self, size, generator=None, nu=None):
        return self.inner._latent_draws(size, generator, nu)


class AffineFlow:
    """Phase 16 (b)'s protocol-minimal flow, the torch translation of
    tests/test_observability.py's: u = theta * exp(log_sigma) + mu, its
    parameters a ``params`` attribute, fitted in closed form (weighted mean
    and variance), with no device surface (so the host loop runs). The
    port's tests drive these custom flows on the CPU too."""

    def __init__(self, n_dim, device="cuda"):
        self.n_dim = n_dim
        self.params = dict(mu=torch.zeros(n_dim, device=device),
                           log_sigma=torch.zeros(n_dim, device=device))

    def _fp(self, fp):
        return self.params if fp is None else fp

    def kernel_fwd(self, u, fp=None):
        p = self._fp(fp)
        return ((u - p["mu"]) * torch.exp(-p["log_sigma"]),
                p["log_sigma"].sum().expand(u.shape[0]).clone())

    def kernel_inv(self, theta, fp=None):
        p = self._fp(fp)
        return (theta * torch.exp(p["log_sigma"]) + p["mu"],
                p["log_sigma"].sum().expand(theta.shape[0]).clone())

    def forward(self, u, fp=None):
        theta, ladj = self.kernel_fwd(u, fp)
        return theta, -ladj

    def sample(self, size=1, generator=None, fp=None):
        p = self._fp(fp)
        z = torch.randn(size, self.n_dim, generator=generator, device=p["mu"].device)
        logq = (-0.5 * (z * z).sum(-1) - 0.5 * self.n_dim * math.log(2 * math.pi)
                - p["log_sigma"].sum())
        return z * torch.exp(p["log_sigma"]) + p["mu"], logq

    def fit(self, x, weights=None, **kwargs):
        x = np.asarray(x, dtype=np.float64)
        w = np.ones(len(x)) if weights is None else np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        mu = (w[:, None] * x).sum(0)
        var = (w[:, None] * (x - mu) ** 2).sum(0)
        dev = self.params["mu"].device
        self.params = dict(mu=torch.as_tensor(mu, dtype=torch.float32, device=dev),
                           log_sigma=torch.as_tensor(0.5 * np.log(np.maximum(var, 1e-12)),
                                                     dtype=torch.float32, device=dev))
        return self


def gauss2_like(x):
    """Phase 16 (b)'s likelihood, the 2-D unit Gaussian (module level, so a
    sampler holding it pickles)."""
    return -0.5 * (x * x).sum(-1) - math.log(2 * math.pi)


def custom_flow(pt, fk, log_like, main, main_launches):
    """Phase 16 (see the module docstring): ``main`` holds phase 6's logz,
    calls and iterations, ``main_launches`` its launches. Returns (the
    numbers to report, (a)'s launches); exits through ``fail`` on a failed
    check."""
    import contextlib
    import io
    import pickle
    from scipy.stats import norm
    from pocomc_tpu_torch.utils.tools import ProgressBar

    live = []
    update = ProgressBar.update_stats

    def spy(self, info):
        if set(info) == {"steps", "acc", "calls"}:
            live.append(info["steps"])
        return update(self, info)

    def drive(prior, like, flow, run_kw, **kw):
        """One run with progress=True (the bar's text kept off the log):
        the sampler and its row of numbers."""
        s = pt.Sampler(prior, like, vectorize=True, random_state=0, flow=flow, device="cuda",
                       **kw)
        live.clear()
        reset_launches(fk)
        ProgressBar.update_stats = spy
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                s.run(progress=True, **run_kw)
            torch.cuda.synchronize()
        finally:
            ProgressBar.update_stats = update
        steps = [st["steps"] for st in s._iter_stats]
        return s, dict(logz=s.logz, dlogz=s.logz_err, calls=s.calls, iterations=s.t,
                       wall_s=time.perf_counter() - t0, phase_s=dict(s.phase_seconds),
                       device_loop=s._use_device_loop(), sweeps=len(steps),
                       sweep_steps=sum(steps), live_updates=len(live),
                       evidence_proposal_used=s.evidence_proposal_used,
                       launches=read_launches(fk))

    # (a) phase 6's quickstart through the delegating flow, progress on
    prior = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    s, a = drive(prior, log_like, DelegatingFlow(pt.Flow(10, "nsf6", device="cuda")),
                 dict(n_total=4096, n_evidence=4096))
    a["phase_6_launches"] = main_launches
    if not a["device_loop"] or isinstance(s.flow, pt.Flow):
        fail("custom_flow (a): the delegating flow did not take the device loop")
    if (s.logz, s.calls) != (main["logz"], main["calls"]):
        fail(f"custom_flow (a): logZ {s.logz} and {s.calls} calls differ from phase 6's "
             f"{main['logz']} and {main['calls']}")
    if a["launches"] != main_launches:
        fail(f"custom_flow (a): launches {a['launches']} differ from phase 6's {main_launches}")
    if a["live_updates"] < a["sweep_steps"] - 2 * a["sweeps"]:
        fail(f"custom_flow (a): {a['live_updates']} live updates for {a['sweep_steps']} "
             f"sweep steps in {a['sweeps']} sweeps")
    lap("16 (a)")
    # (b) the protocol-minimal flow: the host loop, the JAX test's gate, a
    # pickle round trip
    d = 2
    truth = d * norm.logpdf(0.0, 0.0, math.sqrt(26.0))
    s, b = drive(pt.Prior([pt.Normal(0.0, 5.0)] * d), gauss2_like, AffineFlow(d),
                 dict(n_total=512, n_evidence=1024), n_effective=256, n_active=128)
    b["true_logz"] = truth
    if b["device_loop"]:
        fail("custom_flow (b): the protocol-minimal flow took the device loop")
    if not abs(s.logz - truth) < max(4 * s.logz_err, 0.3):
        fail(f"custom_flow (b): logZ {s.logz} +- {s.logz_err} outside {truth} +- "
             f"max(4 err, 0.3)")
    if any(b["launches"].values()):
        fail(f"custom_flow (b): a stock flow kernel ran: {b['launches']}")
    back = pickle.loads(pickle.dumps(s))
    b["pickle_round_trip"] = (isinstance(back.flow, AffineFlow)
                              and all(torch.equal(back.flow.params[k], s.flow.params[k])
                                      for k in ("mu", "log_sigma"))
                              and back.evidence() == s.evidence())
    if not b["pickle_round_trip"]:
        fail("custom_flow (b): the sampler did not round-trip through pickle")
    lap("16 (b)")
    return dict(delegating=a, affine=b), a["launches"]


def ptxas_summary(report):
    """A library's kernel instances from nvcc's -Xptxas=-v report: their
    count, the most registers a thread of any, and how many spill and the
    most bytes one spills (stores + loads); None when nothing was built."""
    import re
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    if not regs:
        return None
    return dict(instances=len(regs), max_registers=max(regs),
                spilling=sum(1 for v in spills if v), max_spill_bytes=max(spills, default=0))


T0 = time.perf_counter()
# seconds of each lettered part of a phase ("14 (b) b1000 check_gradient"),
# in the order the parts ran; each phase line carries the parts timed since
# the line before it, and the "parts" line before the kernels line all
PARTS = {}
_EMITTED = set()
_LAP = [T0]


def lap(key):
    """Ends a part: adds the host seconds since the last lap, after a device
    sync so that the work the part queued is counted in it, to PARTS[key].
    Every second of the script lies in one part."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    now = time.perf_counter()
    PARTS[key] = PARTS.get(key, 0.0) + now - _LAP[0]
    _LAP[0] = now


def emit(phase, **kw):
    """One phase's JSON line, with the seconds of the parts timed since the
    last line and the seconds since the script started."""
    new = {k: round(v, 3) for k, v in PARTS.items() if k not in _EMITTED}
    _EMITTED.update(new)
    print(json.dumps({"phase": phase, **kw, "parts_s": new,
                      "elapsed_s": round(time.perf_counter() - T0, 1)}), flush=True)


CHILDREN = []  # the processes the script starts and must stop


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(1)


def random_flow(name, d, scale=0.02, bins=8):
    """A flow on the card with random non-zero weights from a numpy seed:
    init hidden layers, output layer ~ N(0, scale^2), biases ~ N(0, 0.02^2),
    and a random whitening pre-layer; its spline of ``bins`` bins."""
    from pocomc_tpu_torch.models.flow import Flow
    rng = np.random.default_rng(SEED + d + (0 if bins == 8 else 1000 * bins))
    flow = Flow(d, name, bins=bins, device="cuda")
    with torch.no_grad():
        # every transform's output layer: the last of four stacked layers,
        # or of each coupling transform's four
        for l, (w, b) in enumerate(zip(flow.weights, flow.biases)):
            if l % 4 == 3:
                w.copy_(torch.from_numpy(scale * rng.standard_normal(w.shape)))
            b.copy_(torch.from_numpy(0.02 * rng.standard_normal(b.shape)))
    a = np.eye(d) + 0.1 * rng.standard_normal((d, d))
    flow.set_pre(dict(mean=0.1 * rng.standard_normal(d), w_fwd=a,
                      w_inv=np.linalg.inv(a), ladj=np.log(abs(np.linalg.det(a)))))
    return flow, rng


_BINS_FLOWS = {}


def bins_flow(name, d, bins):
    """Phase 14's random flow of a kind, width and spline bins
    (``random_flow``), made once a process: its output layers at the
    menu's scale with the fan-in past d=50 and for a coupling flow past
    d=10, else at 0.02. The rng it returns goes on from the draws made."""
    if (name, d, bins) not in _BINS_FLOWS:
        h = max(2 ** (3 * d - 1).bit_length(), 32)  # Flow.n_hidden
        scaled = d > 50 or (name.startswith("nsfc") and d > 10)
        _BINS_FLOWS[name, d, bins] = random_flow(
            name, d, MENU_SCALE * math.sqrt(32 / h) if scaled else 0.02, bins)
    return _BINS_FLOWS[name, d, bins]


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(name, a, b, rtol, atol):
    err = max_err(a, b)
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        fail(f"{name}: max |diff| {err:.3e} exceeds atol {atol} + rtol {rtol} * |ref|")
    return err


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of fn() over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_ms(fn, reps, eager_reps=None):
    """(device ms, eager call ms) of fn(), medians: ``eager_reps`` (default
    reps) eager calls between CUDA events after one untimed call, on a
    side stream, which also warm fn up for its capture; then the call
    captured once in a CUDA graph and the graph replayed ``reps`` times
    between CUDA events, so the host's enqueue time is left out of the
    device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call = cuda_ms(fn, eager_reps or reps, warmup=1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps, warmup=1), call


def graph_route_equal(fn):
    """True if fn()'s tensors, computed eagerly, equal bit for bit those of
    fn() captured in a CUDA graph and replayed (inside a capture the plain
    spline's compensated sums run on the device, eagerly on the host)."""
    with torch.no_grad():
        eager = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = fn()
        graph.replay()
        torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(eager, replayed))


def grad_problem(flow, d, n, rng):
    """Inputs of a K2 gradient check from the numpy seed: y ~ N(0, 1) with
    every 8th row in the spline tails (|y| >= 5, +-5 exactly among them),
    every 8th row (offset 1) with its first dimension exactly on a knot of
    the first transform's spline (whose parameters do not depend on
    y[:, 0]), and upstream gradients g_z, g_ladj ~ N(0, 1) with every 4th
    row (offset 2) zero, as rows of zero weight give in the training loss.
    A knot row carries g_ladj = 0: the spline is C1, so the gradient of z
    is continuous there, but its log-slope's is not, and which side of the
    knot a row falls depends on the last bit of the knot position, which
    two correct implementations may round differently."""
    from pocomc_tpu_torch.models import transforms as tr
    from pocomc_tpu_torch.models.made import apply_made
    y = rng.standard_normal((n, d)).astype(np.float32)
    tails = np.arange(0, n, 8)
    y[tails] = rng.choice([-1.0, 1.0], (tails.size, d)) * rng.uniform(5.0, 7.0, (tails.size, d))
    y[tails[:2], 0] = [5.0, -5.0]
    y = torch.from_numpy(y).cuda()
    knots = torch.arange(1, n, 8, device="cuda")
    with torch.no_grad():
        fp = flow.params()
        p = apply_made([w[0] for w in fp.ws], [b[0] for b in fp.bs], y, d, flow.n_params)
        xk = tr._rqs_setup(p[:, 0], flow.bins)[0]
        pick = torch.from_numpy(rng.integers(1, flow.bins, knots.numel())).cuda()
        y[knots, 0] = xk[knots, pick]
    g_z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    g_z[2::4] = 0.0
    g_l[2::4] = 0.0
    g_l[knots] = 0.0
    return y, g_z, g_l


def forward_acts64(flow, y):
    """The layer inputs that the flow's stack forward saves at the stack
    input y, computed by the plain forward in float64."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    fp = copy.deepcopy(flow).double().params()
    with torch.no_grad():
        if flow.kind == "nsfc":
            return ck.coupling_forward_ref(y.double(), fp.ws, fp.bs, fp.masks,
                                           save_inputs=True, bins=flow.bins)[2]
        return fk.made_rqs_forward_ref(y.double(), fp.ws, fp.bs, save_inputs=True,
                                       head=flow.head, bins=flow.bins)[2]


def spline_knots(flow, state, inverse=False):
    """[(x, knots)] by transform, in float64, from a saved state: each
    spline input (n, k) and its spline's knots (n, k, bins + 1, the clamp
    edges +-B among them). The state is the layer inputs a forward saves
    (``forward_acts64``'s or a kernel's; the knots from the output layer's
    input and the flow's weights), or with ``inverse`` the state the
    coupling inverse saves (the spline's outputs x_t and its saved
    parameters). None for the affine head, which has no knots."""
    from pocomc_tpu_torch.models import transforms as tr
    if flow.kind == "maf":
        return None
    fp = copy.deepcopy(flow).double().params()
    n = state[0].shape[1]
    out = []
    with torch.no_grad():
        for t in range(state[0].shape[0]):
            x = state[0][t].double()
            if flow.kind == "nsfc":
                x = x[:, torch.as_tensor(~fp.masks[t], device=x.device)]
                k = x.shape[1] * flow.n_params
                p = (state[4][t][:, :k].double() if inverse
                     else state[3][t].double() @ fp.ws[t][3] + fp.bs[t][3])
            else:
                p = state[3][t].double() @ fp.ws[3][t] + fp.bs[3][t]
            out.append((x, tr._rqs_setup(p.reshape(n, x.shape[1], flow.n_params),
                                         flow.bins)[0]))
    return out


def knot_distance(flow, state, inverse=False):
    """(n,) float64: each row's least distance from a spline input to a
    knot of its spline in a saved state (``spline_knots``); inf for the
    affine head."""
    n = state[0].shape[1]
    dist = torch.full((n,), math.inf, dtype=torch.float64, device=state[0].device)
    for x, xk in spline_knots(flow, state, inverse) or []:
        dist = torch.minimum(dist, (x[..., None] - xk).abs().flatten(1).amin(1))
    return dist


def bins_differ(flow, state, other, inverse=False):
    """(n,) bool: rows of which some spline input falls in another bin of
    its spline in one saved state than in the other (``spline_knots``)."""
    n = state[0].shape[1]
    flip = torch.zeros(n, dtype=torch.bool, device=state[0].device)
    for (x, xk), (xo, xko) in zip(spline_knots(flow, state, inverse) or [],
                                  spline_knots(flow, other, inverse) or []):
        flip |= ((x[..., None] >= xk).sum(-1) != (xo[..., None] >= xko).sum(-1)).any(1)
    return flip


def knot_rows(flow, y, g_l, window=1e-5):
    """Rows whose gradient two correct fp32 routes may give differently:
    in the float64 forward from the stack input y some spline input lies
    within `window` of a knot (``knot_distance``), where the log-det's
    gradient jumps and a rounding of ~1e-6 picks the side, and the row's
    dL/dladj is nonzero. (n,) bool."""
    return (knot_distance(flow, forward_acts64(flow, y)) < window) & (g_l != 0)


def kink_distance(flow, y):
    """(n,) float64: each row's least |pre-activation| over the hidden
    layers of every transform's network in the float64 forward from the
    stack input y: the ReLU's derivative jumps at 0, so the gradients do,
    and which side a row takes turns on the last bits of a sum two correct
    fp32 routes order differently (plain fp32 autograd and the plain VJP,
    in agreement, lie 0.11 from float64 in one such row of 4096 at nsf6,
    d=10, on the CPU)."""
    fp = copy.deepcopy(flow).double().params()
    xs = forward_acts64(flow, y)[0]
    dist = torch.full((y.shape[0],), math.inf, dtype=torch.float64, device=y.device)
    with torch.no_grad():
        if flow.kind == "nsfc":
            nets = [(xs[t][:, torch.as_tensor(m, device=y.device)], fp.ws[t], fp.bs[t])
                    for t, m in enumerate(fp.masks)]
        else:
            nets = [(xs[t], [w[t] for w in fp.ws], [b[t] for b in fp.bs])
                    for t in range(xs.shape[0])]
        for inp, w, b in nets:
            h = inp @ w[0] + b[0]
            dist = torch.minimum(dist, h.abs().amin(-1))
            for l in (1, 2):
                h = h + torch.relu(h) @ w[l] + b[l]
                dist = torch.minimum(dist, h.abs().amin(-1))
    return dist


def kink_rows(flow, y, window=1e-5):
    """Rows of the stack input y on a ReLU kink (``kink_distance`` within
    `window`). (n,) bool."""
    return kink_distance(flow, y) < window


def grads_off_jumps(label, grads, g_z, g_l, tol, near, weights_off=None):
    """``grad_rel_err`` of grads(g_z, g_l) -> (got, want), lists with the
    input gradient first, at `tol`, every row kept where it passes. Rows
    whose input gradient passes `tol` of its largest must each lie in
    `near` (on a knot or a ReLU kink, where the gradient jumps and the
    last bit of a sum picks the side); those rows alone are then left out
    (their upstream gradients set to 0) and every tensor is checked again
    on the rest. With ``weights_off`` (rows on a jump, past 16 bins, where
    the reference is float64) the tensors after the input gradient, sums
    over the rows, are checked with those rows left out too. Returns (max
    |diff| / max |grad|, the rows left out of every tensor, those left out
    of the weight gradients alone)."""
    got, want = grads(g_z, g_l)
    lim = tol * float(want[0].abs().max())
    past = (got[0].double() - want[0].double()).abs().amax(1) > lim
    rows = past.nonzero().flatten().tolist()
    if rows:
        stray = (past & ~near).nonzero().flatten().tolist()
        if stray:
            worst = float((got[0].double() - want[0].double()).abs().max())
            fail(f"{label}: input gradient {worst:.3e} past {lim:.3e} in rows {stray[:8]}, on "
                 f"no knot or ReLU kink")
        got, want = grads(g_z.masked_fill(past[:, None], 0.0), g_l.masked_fill(past, 0.0))
    if weights_off is None or not bool((weights_off & ~past).any()):
        return grad_rel_err(label, got, want, tol), rows, []
    e_in = grad_rel_err(f"{label} input", got[:1], want[:1], tol)
    off = past | weights_off
    got, want = grads(g_z.masked_fill(off[:, None], 0.0), g_l.masked_fill(off, 0.0))
    e_w = grad_rel_err(f"{label} weights", got[1:], want[1:], tol)
    return max(e_in, e_w), rows, (weights_off & ~past).nonzero().flatten().tolist()


def jump_report(flow, y, rows, acts=None):
    """For each row left out by ``grads_off_jumps``: its index, its least
    distance to a knot in the float64 forward from y and, given `acts`, in
    those saved inputs, and to a ReLU kink, and whether ``grad_problem``
    planted it on a knot (every 8th row from 1)."""
    if not rows:
        return []
    at = torch.as_tensor(rows, device=y.device)
    k64 = knot_distance(flow, forward_acts64(flow, y))[at].tolist()
    kink = kink_distance(flow, y)[at].tolist()
    ks = knot_distance(flow, acts)[at].tolist() if acts is not None else [None] * len(rows)
    return [dict(row=r, knot_f64=a, knot_saved=s, kink_f64=k, planted=r % 8 == 1)
            for r, a, s, k in zip(rows, k64, ks, kink)]


def autograd_by_transform(xs, ws, bs, g_z, g_l, bins=8):
    """Plain autograd of the stack's forward, one transform at a time at
    the given transform inputs xs (T, n, d): (g_y, g_ws, g_bs) for the
    masked weights. Independent of the closed-form derivatives."""
    from pocomc_tpu_torch.models import transforms as tr
    from pocomc_tpu_torch.models.made import apply_made
    T, n, d = xs.shape
    g_ws = [torch.empty_like(w) for w in ws]
    g_bs = [torch.empty_like(b) for b in bs]
    g = g_z
    for t in reversed(range(T)):
        x = xs[t].clone().requires_grad_(True)
        wt = [w[t].clone().requires_grad_(True) for w in ws]
        bt = [b[t].clone().requires_grad_(True) for b in bs]
        z, l = tr.rqs_forward(x, apply_made(wt, bt, x, d, tr.rqs_n_params(bins)), bins)
        g, *gp = torch.autograd.grad((z, l.sum(-1)), [x, *wt, *bt], (g, g_l))
        for l_, gw in enumerate(gp[:4]):
            g_ws[l_][t] = gw
        for l_, gb in enumerate(gp[4:]):
            g_bs[l_][t] = gb
    return g, g_ws, g_bs


def rel_errs(got, want):
    """max |diff| / max |want| of each tensor"""
    return [max_err(a.to(b.device), b) / (float(b.abs().max()) + 1e-30)
            for a, b in zip(got, want)]


def grad_verdict(got, want, tol):
    """The gradient rule: each tensor's max |diff| / max |want| within tol.
    Returns (the verdict, those ratios)."""
    errs = rel_errs(got, want)
    return all(e <= tol for e in errs), errs


def grad_rel_err(name, got, want, tol):
    """max over tensors of max |diff| / max |want|; fails above tol
    (``grad_verdict``)."""
    ok, errs = grad_verdict(got, want, tol)
    if not ok:
        i, e = next((i, e) for i, e in enumerate(errs) if not e <= tol)
        fail(f"{name} (tensor {i}): max |diff| / max |grad| = {e:.3e} > {tol}")
    return max(errs)


def grad_route(flow, forward, y, g_z, g_l):
    """[g_y, masked weight gradients, bias gradients] of the flow's stack
    through `forward` by autograd, for dL/dz = g_z and dL/dladj = g_l."""
    flow.zero_grad(set_to_none=True)
    yy = y.clone().requires_grad_(True)
    fp = flow.params()
    z, ladj = forward(yy, fp.ws, fp.bs, bins=fp.bins)
    torch.autograd.backward((z, ladj), (g_z, g_l))
    return [yy.grad, *[w.grad * m for w, m in zip(flow.weights, flow.masks)],
            *[b.grad for b in flow.biases]]


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of flops at the fp32 peak and bytes
    at the HBM rate."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def made_bounds(n, flow):
    """Bounds of K2's forward, K2's backward and K1 at n rows of the flow:
    the flops of the products over the weights its MADE masks leave (the
    mask sums of all transforms; the spline's arithmetic is left out), and
    each input read and each output written once, the weights as those the
    masks leave and the biases. K1 multiplies each of those weights once a
    row, as the forward does. The backward takes the saved layer inputs,
    g_z, g_ladj and the weights, gives g_y and the weight and bias
    gradients, and runs the output layer's product again, the products
    back through the four layers and the weight-gradient products."""
    d, h, T = flow.n_dim, flow.n_hidden, flow.n_transforms
    macs = [int(m.sum()) for m in flow.masks]
    total = sum(macs)
    weights = 4 * (total + T * (3 * h + flow.n_params * d))
    return {"made_rqs_forward": bound(2 * n * total, 4 * (2 * n * d + n) + weights),
            "made_rqs_backward": bound(n * (4 * total + 2 * macs[3]),
                                       4 * (T * n * (d + 3 * h) + 2 * n * d + n) + 2 * weights),
            "ar_inverse": bound(2 * n * total, 4 * (2 * n * d + n + T * d) + weights)}


def coupling_bounds(n, flow):
    """Bounds of K5's forward, inverse and backward at n rows of a coupling
    flow: the flops of its dense products (n_cond*h + 2*h*h + h*NP*n_trans
    multiply-adds a row and transform, NP the spline's 3 bins - 1 raw
    parameters a dimension), each input read and each output
    written once, the weights and biases once. The backward as K2's: the
    saved layer inputs, g_z, g_ladj and the weights in, g_x and the weight
    and bias gradients out, the output layer's product again, the products
    back through the four layers and the weight-gradient products."""
    d, h, T = flow.n_dim, flow.n_hidden, flow.n_transforms
    macs = [sum(flow.weights[4 * t + l].numel() for t in range(T)) for l in range(4)]
    total = sum(macs)
    weights = 4 * sum(p.numel() for p in flow.parameters())
    one = bound(2 * n * total, 4 * (2 * n * d + n) + weights)
    return {"coupling_forward": one, "coupling_inverse": one,
            "coupling_backward": bound(n * (4 * total + 2 * macs[3]),
                                       4 * (T * n * (d + 3 * h) + 2 * n * d + n) + 2 * weights)}


def plain_stack(flow, y, fp=None):
    """The flow's transform stack at y by its plain version (with ``fp``,
    those parameters: float64 ones for a float64 y)."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    fp = flow.params() if fp is None else fp
    if flow.kind == "nsfc":
        return ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks, bins=fp.bins)
    return fk.made_rqs_forward_ref(y, fp.ws, fp.bs, head=flow.head, bins=fp.bins)


def stack_grads(flow, forward, y, g_z, g_l):
    """[g_y, every parameter's gradient] of the flow's stack at y through
    ``forward(flow, y)`` by autograd, for dL/dz = g_z and dL/dladj = g_l."""
    flow.zero_grad(set_to_none=True)
    yy = y.clone().requires_grad_(True)
    z, ladj = forward(flow, yy)
    torch.autograd.backward((z, ladj), (g_z, g_l))
    return [yy.grad, *[p.grad for p in flow.parameters()]]


def float64_verdict(got, plain, exact, atol):
    """K5's accuracy rule: max |got - exact| (exact: the plain version in
    float64) within max(atol, 4 * max |plain - exact|), plain being the
    plain fp32 version on the same inputs. Returns (the verdict, the
    numbers)."""
    e_plain = max_err(plain.double(), exact)
    e_got = max_err(got.double(), exact)
    limit = max(atol, 4.0 * e_plain)
    return e_got <= limit, dict(kernel_vs_f64=e_got, plain_vs_f64=e_plain, limit=limit,
                                kernel_vs_plain=max_err(got, plain))


def check_vs_float64(name, got, plain, exact, atol):
    """``float64_verdict``, failing the run; returns the numbers."""
    ok, out = float64_verdict(got, plain, exact, atol)
    if not ok:
        fail(f"{name}: max |diff| to float64 {out['kernel_vs_f64']:.3e} over "
             f"{out['limit']:.3e} (the plain fp32 version's {out['plain_vs_f64']:.3e})")
    return out


def narrow_tol(tol, bins):
    """A tolerance dict at a spline's bins: each of TOL's limits, or the
    NARROW_TOL reading's limit at those bins where that is larger."""
    return {k: max(v, NARROW_TOL.get(bins, {}).get(k, v)) for k, v in tol.items()}


def values_verdict(got, plain, exact, rtol, atol):
    """The values rule: every element of got within atol + rtol |plain| of
    the plain fp32 version (``torch.allclose``'s rule) or, where not,
    within atol + rtol |exact| of the plain version in float64: two fp32
    routes that sum in other orders may each lie up to the tolerance from
    float64 on opposite sides (at 16 bins, nsf6 (10, 4096) K2's z and the
    plain fp32 z lie 1.02e-5 and 9.05e-6 from float64, 1.48e-5 from each
    other). Returns (the verdict, the numbers: ``past_both`` counts the
    elements past both)."""
    g, p = got.double(), plain.double()
    off_plain = (g - p).abs() > atol + rtol * p.abs()
    off_exact = (g - exact).abs() > atol + rtol * exact.abs()
    out = dict(kernel_vs_plain=max_err(g, p), kernel_vs_f64=max_err(g, exact),
               plain_vs_f64=max_err(p, exact), held_by_float64=int(off_plain.sum()),
               past_both=int((off_plain & off_exact).sum()))
    if bool(off_plain.any()):
        at = int((g - p).abs().flatten().argmax())
        out["worst"] = dict(index=at, row=at // (g.shape[1] if g.dim() > 1 else 1),
                            vs_plain=float((g - p).flatten()[at]),
                            vs_f64=float((g - exact).flatten()[at]),
                            plain_vs_f64=float((p - exact).flatten()[at]),
                            f64=float(exact.flatten()[at]))
    return out["past_both"] == 0, out


def check_values(name, got, plain, exact, rtol, atol):
    """``values_verdict``, failing the run naming the elements past both
    references; returns (max |got - plain|, the numbers)."""
    ok, out = values_verdict(got, plain, exact, rtol, atol)
    if not ok:
        fail(f"{name}: {out['past_both']} elements past atol {atol} + rtol {rtol} of both the "
             f"plain version and float64 (max |diff| to float64 {out['kernel_vs_f64']:.3e}, "
             f"the plain fp32 version's {out['plain_vs_f64']:.3e})")
    return out["kernel_vs_plain"], out


def check_spline_made(name, d, n, flow, rng):
    """Phases 3-4 and 14 for an nsf* flow (K2, K2-bwd and K1 with the
    spline head of the flow's bins) at n rows: the forward's z and log-det
    and K1's x and log-det against the plain version, or where an element
    is past it against the plain version in float64 (``check_values``);
    log_prob against the plain forward; the gradient through the
    autograd.Function (the forward kernel, then the backward kernel)
    against plain autograd of the plain forward on the same y
    (``grad_problem``'s rows), rows on a float64 knot with dL/dladj != 0
    left out (``knot_rows``), at the stated tolerance or twice the spread
    of plain autograd on the CPU against the card where that is larger;
    then, with every row, against the plain backward and per-transform
    autograd on the layer inputs the forward kernel saved, which are held
    to the plain forward's; K1's round trip. In both gradient checks a row
    whose input gradient is past the limit must lie within 1e-5 of a
    jump, and only such rows are left out (``grads_off_jumps``): of a
    ReLU kink (``kink_rows``), and for the check on the saved inputs also
    of a knot in those saved inputs, which both routes read (at 16 bins,
    (50, 1024) K2-bwd's g_y lay 2.9e-2 of its largest from the plain
    backward's on the same saved inputs with every row kept). Past 16
    bins every gradient reference is the plain version in float64 and the
    weight gradients leave out the rows on a jump too (NARROW_TOL's
    comment). TOL[10] up to d=10, TOL[50] past it (``narrow_tol`` at the
    flow's bins). Returns (the numbers to report, max |diff| by
    kernel, under the kernels' names at the flow's bins)."""
    from pocomc_tpu_torch.ops import flow_kernels as fk
    bins = flow.bins
    tol = narrow_tol(TOL[min(max(d, 10), 50)], bins)
    k2, k2b, k1 = (with_bins(k, bins) for k in RQS)
    y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    vs64 = {}
    flow64 = copy.deepcopy(flow).double()

    def close(label, got, plain, exact, rtol, atol):
        e, vs64[label] = check_values(label, got, plain, exact, rtol, atol)
        return e

    def reference(yy, gz, gl):
        """the plain version's gradient route, in float64 past 16 bins"""
        if bins > 16:
            return grad_route(flow64, fk.made_rqs_forward_ref, yy.double(), gz.double(),
                              gl.double())
        return grad_route(flow, fk.made_rqs_forward_ref, yy, gz, gl)

    with torch.no_grad():
        fp = flow.params()
        f64 = flow64.params()
        z_k, l_k = fk.made_rqs_forward(y, fp.ws, fp.bs, bins=bins)
        z_r, l_r = fk.made_rqs_forward_ref(y, fp.ws, fp.bs, bins=bins)
        z_e, l_e = fk.made_rqs_forward_ref(y.double(), f64.ws, f64.bs, bins=bins)
        torch.cuda.synchronize()
        e_z = close(f"{k2} z d={d} n={n}", z_k, z_r, z_e, tol["rtol"], tol["atol"])
        e_l = close(f"{k2} ladj d={d} n={n}", l_k, l_r, l_e, 0.0, tol["ladj"])
        lp_k = flow.log_prob(y, fp)
        lp_r, lp_e = (flow._base_logpdf(z) + l + p.pre["ladj"] for z, l, p in (
            (*fk.made_rqs_forward_ref((y - fp.pre["mean"]) @ fp.pre["w_fwd"], fp.ws, fp.bs,
                                      bins=bins), fp),
            (*fk.made_rqs_forward_ref((y.double() - f64.pre["mean"]) @ f64.pre["w_fwd"],
                                      f64.ws, f64.bs, bins=bins), f64)))
        e_lp = close(f"{k2} log_prob d={d} n={n}", lp_k, lp_r, lp_e, 0.0, tol["ladj"])
    # K2 backward end to end: the kernel, through the autograd.Function
    # as training calls it, against plain autograd of the plain forward
    # on the same y. Rows on a knot in float64 with dL/dladj != 0 are
    # left out (knot_rows). Elsewhere two correct fp32 routes still
    # differ where a row's gradient is ill-conditioned (plain autograd
    # on the CPU against the card: up to 1e-2 of the largest gradient at
    # n=1024), so the stated tolerance rises to twice that spread,
    # measured here, where it is larger.
    yg, g_z, g_l = grad_problem(flow, d, n, rng)
    edge = knot_rows(flow, yg, g_l)
    kinks = kink_rows(flow, yg)
    g_ze, g_le = g_z.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)
    plain = grad_route(flow, fk.made_rqs_forward_ref, yg, g_ze, g_le)
    e_cpu = max(rel_errs(grad_route(copy.deepcopy(flow).cpu(), fk.made_rqs_forward_ref,
                                    yg.cpu(), g_ze.cpu(), g_le.cpu()), plain))
    e2e_tol = max(tol["grad"], 2 * e_cpu)
    e_ge, e2e_out, e2e_w = grads_off_jumps(
        f"{k2b} gradient end to end d={d} n={n}",
        lambda gz, gl: (grad_route(flow, fk.made_rqs_forward, yg, gz, gl),
                        reference(yg, gz, gl)),
        g_ze, g_le, e2e_tol, kinks, kinks if bins > 16 else None)
    # then, with every row, against the plain backward and per-transform
    # autograd on the layer inputs the forward kernel saved, which are
    # themselves held to the plain forward's
    with torch.no_grad():
        _, _, acts = fk.made_rqs_forward(yg, fp.ws, fp.bs, save_inputs=True, bins=bins)
        acts_r = fk.made_rqs_forward_ref(yg, fp.ws, fp.bs, save_inputs=True, bins=bins)[2]
    torch.cuda.synchronize()
    # the saved inputs within 10x the value tolerance: each sums the
    # rounding of the transforms before it, where a wrong offset is O(1)
    e_acts = max(check_close(f"{k2} saved input {l} d={d} n={n}", a, b, 10 * tol["rtol"],
                             10 * tol["atol"]) for l, (a, b) in enumerate(zip(acts, acts_r)))
    flat = lambda g: [g[0], *[w * m for w, m in zip(g[1], flow.masks)], *g[2]]
    on_saved = ((knot_distance(flow, acts) < 1e-5) & (g_l != 0)) | kinks
    weights_off = on_saved if bins > 16 else None

    # the references on the saved inputs, in float64 past 16 bins
    ref_p, ref_acts = (f64, [a.double() for a in acts]) if bins > 16 else (fp, acts)
    cast = (lambda t: t.double()) if bins > 16 else (lambda t: t)

    def by_plain(gz, gl):
        with torch.no_grad():
            g_ref = fk.made_rqs_backward_ref(cast(yg), ref_p.ws, ref_p.bs, cast(gz), cast(gl),
                                             ref_acts, bins=bins)
        return grad_route(flow, fk.made_rqs_forward, yg, gz, gl), flat(g_ref)

    def by_autograd(gz, gl):
        return (grad_route(flow, fk.made_rqs_forward, yg, gz, gl),
                flat(autograd_by_transform(ref_acts[0], ref_p.ws, ref_p.bs, cast(gz), cast(gl),
                                           bins)))

    e_gr, plain_out, plain_w = grads_off_jumps(f"{k2b} vs plain d={d} n={n}", by_plain, g_z,
                                               g_l, tol["grad"], on_saved, weights_off)
    e_ga, ag_out, ag_w = grads_off_jumps(f"{k2b} vs autograd d={d} n={n}", by_autograd, g_z,
                                         g_l, tol["grad"], on_saved, weights_off)
    off = torch.zeros(n, dtype=torch.bool, device=yg.device)
    off[plain_out + plain_w] = True
    got, g_ref = by_plain(g_z.masked_fill(off[:, None], 0.0), g_l.masked_fill(off, 0.0))
    with torch.no_grad():
        zi = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        x_k, li_k = fk.ar_inverse(zi, fp.ws, fp.bs, fp.inv_orders, bins=bins)
        x_r, li_r = fk.ar_inverse_ref(zi, fp.ws, fp.bs, fp.inv_orders, bins=bins)
        x_e, li_e = fk.ar_inverse_ref(zi.double(), f64.ws, f64.bs, f64.inv_orders, bins=bins)
        torch.cuda.synchronize()
        e_x = close(f"{k1} x d={d} n={n}", x_k, x_r, x_e, tol["rtol"], tol["atol"])
        e_li = close(f"{k1} ladj d={d} n={n}", li_k, li_r, li_e, 0.0, tol["ladj"])
        z_rt, l_rt = fk.made_rqs_forward(x_k, fp.ws, fp.bs, bins=bins)
        e_rt = check_close(f"{k1} round trip d={d} n={n}", z_rt, zi, tol["rtol"],
                           10 * tol["atol"])
        e_rtl = check_close(f"{k1} round-trip ladj d={d} n={n}", l_rt + li_k,
                            torch.zeros_like(l_rt), 0.0, 10 * tol["ladj"])
    out = dict(flow=name, bins=bins, d=d, n=n, tol=tol, k2_z=e_z, k2_ladj=e_l, k2_logprob=e_lp,
               k2_saved_inputs=e_acts, k2_grad_rel_end_to_end=e_ge,
               k2_grad_end_to_end_tol=e2e_tol, k2_grad_rel_cpu_vs_card=e_cpu,
               k2_edge_rows=int(edge.sum()), k2_grad_rel_plain=e_gr, k2_grad_rel_autograd=e_ga,
               k1_x=e_x, k1_ladj=e_li, roundtrip_z=e_rt, roundtrip_ladj=e_rtl, vs_float64=vs64,
               rows_left_out=dict(
                   end_to_end=jump_report(flow, yg, e2e_out),
                   vs_plain=jump_report(flow, yg, plain_out, acts),
                   vs_autograd=jump_report(flow, yg, ag_out, acts)),
               rows_left_out_of_weights=dict(end_to_end=len(e2e_w), vs_plain=len(plain_w),
                                             vs_autograd=len(ag_w)))
    errs = {k2: max(e_z, e_l), k2b: max(max_err(a, b) for a, b in zip(got, g_ref)),
            k1: max(e_x, e_li)}
    return out, errs


def check_menu(name, d, n, flow, rng, tol, grad_rows=None):
    """Phases 3-4 for a maf* flow (K2 and K1 with the affine head) or an
    nsfc* flow (K5): forward, log_prob and inverse against the plain
    versions on the same card inputs (K5's to the plain version in float64,
    ``check_vs_float64``), the round trip, and, up to
    MENU_GRAD_ROWS rows, the training gradient through the kernels against
    plain autograd of the plain forward (the tolerance rising to twice the
    spread of plain autograd on the CPU against the card where that is
    larger, as for K2), the saved layer inputs, and the backward kernel
    against the plain backward on the inputs the forward kernel saved; a
    coupling transform's conditioning columns bit for bit. In both gradient
    checks a row whose input gradient is past the limit must lie within
    1e-5 of a jump, and only such rows are left out, as in
    ``check_spline_made``: of a knot (``knot_rows``: in the float64
    forward, or, for the check on the saved inputs, in those inputs) or a
    ReLU kink (``kink_rows``). Past 16 bins K5's gradient references are
    the plain version in float64, the weight gradients without the rows on
    a jump (NARROW_TOL's comment), at ``narrow_tol``'s tolerances.
    ``grad_rows`` moves the MENU_GRAD_ROWS limit. Returns (the numbers to
    report, max |diff| by kernel, under the kernels' names at the flow's
    bins)."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    coupling = flow.kind == "nsfc"
    bins = flow.bins
    to64 = coupling and bins > 16  # gradient references in float64
    flow64 = copy.deepcopy(flow).double()
    cast = (lambda t: t.double()) if to64 else (lambda t: t)
    kf, ki, kb = ((COUPLING[0], COUPLING[1], COUPLING[2]) if coupling
                  else (AFFINE[0], AFFINE[2], AFFINE[1]))
    if coupling:
        kf, ki, kb = (with_bins(k, bins) for k in (kf, ki, kb))
    if coupling:
        tol = narrow_tol(dict(tol, atol=COUPLING_TOL[d][0], ladj=COUPLING_TOL[d][1]), bins)
    vtol = dict(rtol=tol["rtol"], atol=tol["atol"])
    out = dict(flow=name, d=d, n=n, tol=tol)
    errs = {}
    y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    zi = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        fp = flow.params()
        if coupling:
            fwd = lambda v: ck.coupling_forward(v, fp.ws, fp.bs, fp.masks, bins=bins)
            got_f = fwd(y)
            want_f = ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks, bins=bins)
            got_i = ck.coupling_inverse(zi, fp.ws, fp.bs, fp.masks, bins=bins)
            want_i = ck.coupling_inverse_ref(zi, fp.ws, fp.bs, fp.masks, bins=bins)
            one = [f(zi, fp.ws[:1], fp.bs[:1], fp.masks[:1], bins=bins)[0]
                   for f in (ck.coupling_forward, ck.coupling_inverse)]
            out["conditioning_bit_for_bit"] = all(
                torch.equal(o[:, fp.masks[0]], zi[:, fp.masks[0]]) for o in one)
            if not out["conditioning_bit_for_bit"]:
                fail(f"K5 {name} d={d} n={n}: a conditioning column was changed")
        else:
            fwd = lambda v: fk.made_rqs_forward(v, fp.ws, fp.bs, head="affine")
            got_f, want_f = fwd(y), fk.made_rqs_forward_ref(y, fp.ws, fp.bs, head="affine")
            got_i = fk.ar_inverse(zi, fp.ws, fp.bs, fp.inv_orders, head="affine")
            want_i = fk.ar_inverse_ref(zi, fp.ws, fp.bs, fp.inv_orders, head="affine")
        torch.cuda.synchronize()
        label = f"{name} d={d} n={n}"
        if coupling:
            fp64 = flow64.params()
            exact_f = ck.coupling_forward_ref(y.double(), fp64.ws, fp64.bs, fp64.masks, bins=bins)
            exact_i = ck.coupling_inverse_ref(zi.double(), fp64.ws, fp64.bs, fp64.masks,
                                              bins=bins)
            acc = {f"{k}_{part}": check_vs_float64(f"{k} {part} {label}", g[j], w[j], e[j],
                                                   tol["ladj"] if j else tol["atol"])
                   for k, g, w, e in ((kf, got_f, want_f, exact_f), (ki, got_i, want_i, exact_i))
                   for j, part in enumerate(("values", "ladj"))}
            out["vs_float64"] = acc
            errs[kf] = max(acc[f"{kf}_values"]["kernel_vs_plain"],
                           acc[f"{kf}_ladj"]["kernel_vs_plain"])
            errs[ki] = max(acc[f"{ki}_values"]["kernel_vs_plain"],
                           acc[f"{ki}_ladj"]["kernel_vs_plain"])
        else:
            errs[kf] = max(check_close(f"{kf} z {label}", got_f[0], want_f[0], **vtol),
                           check_close(f"{kf} ladj {label}", got_f[1], want_f[1], tol["rtol"],
                                       tol["ladj"]))
            errs[ki] = max(check_close(f"{ki} x {label}", got_i[0], want_i[0], **vtol),
                           check_close(f"{ki} ladj {label}", got_i[1], want_i[1], tol["rtol"],
                                       tol["ladj"]))
        pre, f64 = fp.pre, flow64.params()
        zp, lp_ = plain_stack(flow, (y - pre["mean"]) @ pre["w_fwd"])
        zpe, lpe = plain_stack(flow, (y.double() - f64.pre["mean"]) @ f64.pre["w_fwd"], f64)
        lp = (flow.log_prob(y, fp), flow._base_logpdf(zp) + lp_ + pre["ladj"],
              flow._base_logpdf(zpe) + lpe + f64.pre["ladj"])
        out["log_prob"] = check_values(f"log_prob {label}", *lp, tol["rtol"], tol["ladj"])[0]
        z_rt, l_rt = fwd(got_i[0])
        out["roundtrip_z"] = check_close(f"round trip {label}", z_rt, zi, vtol["rtol"],
                                         10 * vtol["atol"])
        out["roundtrip_ladj"] = check_close(f"round-trip ladj {label}", l_rt + got_i[1],
                                            torch.zeros_like(l_rt), 0.0, 10 * tol["ladj"])
    out.update(value_err=errs[kf], inverse_err=errs[ki])
    if n > (grad_rows or MENU_GRAD_ROWS[d]):
        return out, errs
    g_z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
    g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    g_z[2::4], g_l[2::4] = 0.0, 0.0
    kinks = kink_rows(flow, y)
    near = knot_rows(flow, y, g_l) | kinks
    plain = stack_grads(flow, plain_stack, y, g_z, g_l)
    e_cpu = max(rel_errs(stack_grads(copy.deepcopy(flow).cpu(), plain_stack, y.cpu(),
                                     g_z.cpu(), g_l.cpu()), plain))
    e2e_tol = max(tol["grad"], 2 * e_cpu)
    kernel = lambda f, v: f.stack_forward(v)
    e_ge, e2e_out, e2e_w = grads_off_jumps(
        f"{kb} end to end {label}",
        lambda gz, gl: (stack_grads(flow, kernel, y, gz, gl),
                        stack_grads(flow64 if to64 else flow, plain_stack, cast(y), cast(gz),
                                    cast(gl))),
        g_z, g_l, e2e_tol, near, near if to64 else None)
    out.update(grad_rel_end_to_end=e_ge, grad_end_to_end_tol=e2e_tol,
               grad_rel_cpu_vs_card=e_cpu)
    with torch.no_grad():
        if coupling:
            _, _, acts = ck.coupling_forward(y, fp.ws, fp.bs, fp.masks, save_inputs=True,
                                             bins=bins)
            acts_r = ck.coupling_forward_ref(y, fp.ws, fp.bs, fp.masks, save_inputs=True,
                                             bins=bins)[2]
            back = lambda gz, gl: ck.coupling_backward(y, fp.ws, fp.bs, fp.masks, gz, gl, acts,
                                                       bins=bins)
            rp = flow64.params() if to64 else fp
            back_r = lambda gz, gl: ck.coupling_backward_ref(
                cast(y), rp.ws, rp.bs, rp.masks, cast(gz), cast(gl), [cast(a) for a in acts],
                bins=bins)
            flat = lambda g: [g[0], *[a for t in g[1] for a in t], *[a for t in g[2] for a in t]]
        else:
            _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head="affine")
            acts_r = fk.made_rqs_forward_ref(y, fp.ws, fp.bs, save_inputs=True, head="affine")[2]
            back = lambda gz, gl: fk.made_rqs_backward(y, fp.ws, fp.bs, gz, gl, acts,
                                                       head="affine")
            back_r = lambda gz, gl: fk.made_rqs_backward_ref(y, fp.ws, fp.bs, gz, gl, acts,
                                                             head="affine")
            flat = lambda g: [g[0], *[w * m for w, m in zip(g[1], flow.masks)], *g[2]]
        torch.cuda.synchronize()
        out["saved_inputs"] = max(
            check_close(f"{kf} saved input {l} {label}", a, b, 10 * vtol["rtol"],
                        10 * vtol["atol"]) for l, (a, b) in enumerate(zip(acts, acts_r)))
        on_saved = ((knot_distance(flow, acts) < 1e-5) & (g_l != 0)) | kinks
        pair = lambda gz, gl: (flat(back(gz, gl)), flat(back_r(gz, gl)))
        out["grad_rel_plain"], plain_out, plain_w = grads_off_jumps(
            f"{kb} vs plain {label}", pair, g_z, g_l, tol["grad"], on_saved,
            on_saved if to64 else None)
        off = torch.zeros(n, dtype=torch.bool, device=y.device)
        off[plain_out + plain_w] = True
        g_k, g_r = pair(g_z.masked_fill(off[:, None], 0.0), g_l.masked_fill(off, 0.0))
    out["rows_left_out"] = dict(end_to_end=jump_report(flow, y, e2e_out),
                                vs_plain=jump_report(flow, y, plain_out, acts))
    out["rows_left_out_of_weights"] = dict(end_to_end=len(e2e_w), vs_plain=len(plain_w))
    errs[kb] = max(max_err(a, b) for a, b in zip(g_k, g_r))
    return out, errs


def matmul_products(flow, x):
    """K5's (or K2's) four products of every transform as torch.matmul
    (addmm) on its shapes at the rows x: x_cond W0 + b0 (x W0 + b0 for a
    MADE stack, its masked weights dense), then h W1 + b1, h W2 + b2 and
    h W3 + b3 at (n, h), without the head, the residual adds or the ReLUs;
    the library's time for the work of the forward's products."""
    fp = flow.params()
    h = torch.empty(x.shape[0], flow.n_hidden, device=x.device)
    for t in range(flow.n_transforms):
        if flow.kind != "nsfc":  # a MADE stack's layers are stacked over T
            w, b = [a[t] for a in fp.ws], [a[t] for a in fp.bs]
            h = torch.addmm(b[0], x, w[0])
            h = torch.addmm(b[1], h, w[1])
            h = torch.addmm(b[2], h, w[2])
            torch.addmm(b[3], h, w[3])
            continue
        w, b = fp.ws[t], fp.bs[t]
        c = int(fp.masks[t].sum())
        lo = 0 if fp.masks[t][0] else flow.n_dim - c
        h = torch.addmm(b[0], x[:, lo:lo + c], w[0])
        h = torch.addmm(b[1], h, w[1])
        h = torch.addmm(b[2], h, w[2])
        torch.addmm(b[3], h, w[3])
    return h


def backward_matmul_products(flow, x, acts, g, weight_grads=True):
    """K5's or K2's backward's products as torch.matmul (addmm, mm, bmm) on
    its shapes at the rows x: the output layer's product again, relu(h2) W3
    + b3, then delta W^T back through the four layers (g3 W3^T, g2 W2^T, g1
    W1^T, g0 W0^T), and the weight gradients A^T delta of every layer as
    one bmm over the T transforms, without the head's VJP, the ReLU masks
    or the residual adds (a MADE stack's masked weights dense); ``acts``
    are the saved layer inputs and ``g`` the four deltas (T, n, .), the
    layout the kernel writes. The library's time for the work of the
    backward's products; without ``weight_grads``, those of K5-inv-bwd,
    which has no weight gradients."""
    fp = flow.params()
    ws, bs = fp.ws, fp.bs
    if flow.kind != "nsfc":  # a MADE stack's layers are stacked over T
        ws = [[w[t] for w in fp.ws] for t in range(flow.n_transforms)]
        bs = [[b_[t] for b_ in fp.bs] for t in range(flow.n_transforms)]
    for t in reversed(range(flow.n_transforms)):
        w, b = ws[t], bs[t]
        n3 = w[3].shape[1]
        torch.addmm(b[3], acts[3][t], w[3])
        g2 = torch.mm(g[3][t][:, :n3], w[3].T)
        g1 = torch.mm(g2, w[2].T)
        g0 = torch.mm(g1, w[1].T)
        torch.mm(g0, w[0].T)
    if not weight_grads:
        return g0
    return [torch.bmm(a.transpose(1, 2), d) for a, d in zip(acts, g)]


def gradient_kernel(flow):
    """The gradient kernel of a flow's inverse: its name in GRADIENT, at
    the flow's spline bins (``with_bins``)."""
    if flow.kind == "nsfc":
        return with_bins(GRADIENT[2], flow.bins)
    return with_bins(GRADIENT[0], flow.bins) if flow.head == "rqs" else GRADIENT[1]


def inverse_routes(flow):
    """(inverse kernel, plain inverse, the gradient kernel's call, its plain
    twin, the inverse's save instance, the twin's point) of a flow's
    stack, each on FlowParams or CouplingParams p. The gradient kernel's
    call takes (data, p, g_x, g_ladj): its data is the state that the
    inverse's save instance writes (K1's for K1-bwd, K5's inverse's for
    K5-inv-bwd), which the fifth route gives from z as (x, ladj, state).
    The plain twin takes the same arguments, its data from the last route
    at (z, x, p) in p's precision, computed by plain code alone: x, the
    inverse's output, for K1-bwd's twin (the forward's state at x); for
    K5-inv-bwd's, the plain save mode's state at z (the inverse's own
    intermediates)."""
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    b = flow.bins
    if flow.kind == "nsfc":
        return (lambda v, p: ck.coupling_inverse(v, p.ws, p.bs, p.masks, bins=b),
                lambda v, p: ck.coupling_inverse_ref(v, p.ws, p.bs, p.masks, bins=b),
                lambda state, p, gx, gl: ck.coupling_inverse_backward(state, p.ws, p.bs,
                                                                      p.masks, gx, gl, b),
                lambda state, p, gx, gl: ck.coupling_inverse_vjp_ref(state, p.ws, p.bs,
                                                                     p.masks, gx, gl, b),
                lambda z, x, p: ck._launch_stack(z, p.ws, p.bs, p.masks, True, True,
                                                 "coupling_inverse", b),
                lambda z, x, p: ck.coupling_inverse_ref(z.to(p.ws[0][0].dtype), p.ws, p.bs,
                                                        p.masks, save_inputs=True, bins=b)[2])
    head = flow.head
    return (lambda v, p: fk.ar_inverse(v, p.ws, p.bs, p.inv_orders, head, b),
            lambda v, p: fk.ar_inverse_ref(v, p.ws, p.bs, p.inv_orders, head, b),
            lambda state, p, gx, gl: fk.ar_inverse_backward(state, p.ws, p.bs, p.inv_orders,
                                                            gx, gl, head, b),
            lambda x, p, gx, gl: fk.ar_inverse_vjp_ref(x, p.ws, p.bs, p.inv_orders, gx, gl,
                                                       head, b),
            lambda z, x, p: fk._launch_inverse(z, p.ws, p.bs, p.inv_orders, head, True, b),
            lambda z, x, p: x.to(p.ws[0].dtype))


def rows_past(label, got, want, limit, near):
    """The rows where max |got - want| passes `limit`; fails unless every
    one of them lies in `near` (within 1e-3 of a knot or a ReLU kink):
    there two correct fp32 routes take the two sides of a jump of the
    gradient, since the inverse's own fp32 error reaches 1e-4 (nsfc12 at
    d=50: plain fp32 autograd lies 3.3 from float64 autograd in such a row
    of 256 on the CPU, outside the 1e-5 windows). Returns their count."""
    past = (got.double() - want.double()).abs().max(1).values > limit
    if bool((past & ~near).any()):
        worst = float((got.double() - want.double()).abs().max())
        fail(f"{label}: max |diff| {worst:.3e} over {limit:.3e} in "
             f"{int((past & ~near).sum())} rows that lie near no knot or ReLU kink")
    return int(past.sum())


def side_flips(label, flow, past, g_k, g_e, g_x, g_l, data, state64, fp64, twin, limit):
    """The rows of K5-inv-bwd's g_z past `limit` from the float64 VJP at the
    plain save mode's state at z, each held to two witnesses: the float64
    VJP at the kernel's own saved state (``data``) gives the row's g_z
    within `limit`, and the kernel's state and the float64 state take two
    sides of a jump of the gradient in that row: a spline output in
    neighbouring bins (``bins_differ``, with dL/dladj != 0: the log-det's
    gradient jumps at a knot) or a hidden unit of a transform's network on
    the two sides of its ReLU's kink (one state's relu(h) > 0, the
    other's 0). The report gives each row's distance to a knot in the
    kernel's state beside its inverse's own error (its largest |x_t - x_t
    in float64|), and the largest relu(h) of a unit that changed sides.
    Fails unless every row is such a flip; returns the report."""
    with torch.no_grad():
        at_own = twin([s.double() for s in data], fp64, g_x.double(), g_l.double())
        own_err = (g_k.double() - at_own).abs().amax(1)
        inv_err = (data[0].double() - state64[0]).abs().amax(-1).amax(0)
        dist = knot_distance(flow, data, inverse=True)
        flip = bins_differ(flow, data, state64, inverse=True)
        sides = [(data[l] > 0) != (state64[l] > 0) for l in (1, 2, 3)]
        relu_flip = torch.stack([s.any(-1).any(0) for s in sides]).any(0)
        gap = torch.stack([torch.where(s, torch.maximum(data[l].double(), state64[l]), 0.0)
                           .amax(-1).amax(0) for s, l in zip(sides, (1, 2, 3))]).amax(0)
    rows = past.nonzero().flatten().tolist()
    report = [dict(row=r, vs_f64=float((g_k[r].double() - g_e[r]).abs().max()),
                   vs_f64_at_own_state=float(own_err[r]), bins_differ=bool(flip[r]),
                   relu_sides_differ=bool(relu_flip[r]), relu_gap=float(gap[r]),
                   knot_distance=float(dist[r]), inverse_error=float(inv_err[r]),
                   g_ladj=float(g_l[r])) for r in rows]
    bad = [x for x in report if not (x["vs_f64_at_own_state"] <= limit and (
        (x["bins_differ"] and x["g_ladj"] != 0) or x["relu_sides_differ"]))]
    if bad:
        fail(f"{label}: rows past {limit:.3e} from float64 that are no flip: {bad[:4]}")
    return report


def check_gradient(name, d, n, flow, rng):
    """Phase 13 (a) and 14 at one shape: g_z of a loss on the stack's
    inverse (x and the log-det, dL/dladj ~ N(0, 1)) through the kernels as
    a sweep takes it (the inverse kernel, then its gradient kernel, by
    autograd) against plain autograd of the plain inverse in fp32 on the
    same z: within TOL's gradient tolerance of the largest, or within
    twice the plain fp32 version's own distance to float64 where that is
    larger (the spread that decides K2's gate, here measured against the
    plain VJP in float64 at the same point), a row past the limit lying
    within 1e-3 of a jump (``rows_past``: the two routes evaluate the
    gradient at points that differ by the inverse's fp32 error); and, at
    the same point, to the plain VJP in float64 within K5's rule (the
    tolerance, or 4x the plain fp32 VJP's own distance to it), every row.
    The same point is x for K1-bwd (the plain VJP takes the forward's
    state at x) and z for K5-inv-bwd: the plain save mode's state at z, in
    fp32 and in float64, which differentiates at the inverse's own
    intermediates, as ``jax.vjp`` and the kernel do (at nsfc12, d=50 a
    forward recomputed at x moved the float64 g_z 4.4 from the kernel's,
    past the 4x rule's 3.96), and reads nothing the kernels wrote. A
    K5-inv-bwd row past that rule is left out only if it is a flip
    (``side_flips``: the float64 VJP at the kernel's own state agrees, and
    the kernel's state and float64's take two sides of a knot or a ReLU
    kink in that row); the rest are held to the rule again. Rows on a float64 knot with dL/dladj != 0 and
    rows on a ReLU kink, within 1e-5, are left out (their gradient
    jumps). The kernel's direct call, on the state the inverse's save
    instance writes at the same z, gives the autograd route's bits, and
    the save instance's x and log-det are the inverse's without the save,
    bit for bit. Returns (the numbers, max |diff|)."""
    from pocomc_tpu_torch.mcmc import _detached
    inv, ref, bwd, twin, saving, point = inverse_routes(flow)
    kname = gradient_kernel(flow)
    tol = TOL[min(max(d, 10), 50)]["grad"]
    fp = _detached(flow.params())
    fp64 = _detached(copy.deepcopy(flow).double().params())
    z, g_x = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
              for _ in range(2))
    g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    with torch.no_grad():
        x, ladj = inv(z, fp)
        x_s, ladj_s, data = saving(z, x, fp)
    if not (torch.equal(x_s, x) and torch.equal(ladj_s, ladj)):
        fail(f"{name} d={d} n={n}: the inverse's save instance changed its x or log-det")
    edge = knot_rows(flow, x, g_l) | kink_rows(flow, x)
    g_x, g_l = g_x.masked_fill(edge[:, None], 0.0), g_l.masked_fill(edge, 0.0)

    def by_autograd(inverse):
        zz = z.clone().requires_grad_(True)
        xx, ll = inverse(zz, fp)
        return torch.autograd.grad((xx, ll), zz, (g_x, g_l))[0]

    before = getattr(*_counter(kname), 0)
    g_k = by_autograd(inv)
    launched = getattr(*_counter(kname), 0) - before
    g_p = by_autograd(ref)
    with torch.no_grad():
        state64 = point(z, x, fp64)
        g_e = twin(state64, fp64, g_x.double(), g_l.double())
        g_t = twin(point(z, x, fp), fp, g_x, g_l)
        direct = bwd(data, fp, g_x, g_l)
    torch.cuda.synchronize()
    label = f"{kname} {name} d={d} n={n}"
    if launched != 1:
        fail(f"{label}: the gradient went through {launched} launches of its kernel, not 1")
    if not torch.equal(direct, g_k):
        fail(f"{label}: the kernel's direct call and the autograd route differ")
    spread = max_err(g_p.double(), g_e)
    e_kp = max_err(g_k, g_p)
    limit = max(tol * float(g_p.abs().max()), 2 * spread)
    near = knot_rows(flow, x, g_l, 1e-3) | kink_rows(flow, x, 1e-3)
    out = dict(kernel=kname, flow=name, d=d, n=n, tol=tol, edge_rows=int(edge.sum()),
               max_grad=float(g_p.abs().max()), kernel_vs_plain=e_kp, limit=limit,
               plain_vs_f64=spread, kernel_vs_f64=max_err(g_k.double(), g_e),
               rows_near_a_jump=int(near.sum()),
               rows_past_limit=rows_past(f"{label} vs plain autograd", g_k, g_p, limit, near))
    label64 = f"{label} vs float64 at the same point"
    atol64 = tol * float(g_e.abs().max())
    limit64 = max(atol64, 4.0 * max_err(g_t.double(), g_e))
    past = (g_k.double() - g_e).abs().amax(1) > limit64
    keep = torch.ones(n, dtype=torch.bool, device=z.device)
    if flow.kind == "nsfc" and bool(past.any()):
        out["flips"] = side_flips(label64, flow, past, g_k, g_e, g_x, g_l, data, state64,
                                  fp64, twin, limit64)
        out["every_row_vs_float64"] = dict(kernel_vs_f64=max_err(g_k.double(), g_e),
                                           limit=limit64)
        keep = ~past
    out["vs_float64"] = check_vs_float64(label64, g_k[keep], g_t[keep], g_e[keep], atol64)
    return out, e_kp


def gradient_bounds(n, flow):
    """(bound_ms, bound_by) of an inverse's gradient kernel at n rows: one
    cotangent pass through every transform's products (the masked
    multiply-adds that ``made_bounds`` counts, or K5's dense ones) plus the
    element VJPs (``element_vjp_ops`` each, at the flow's bins), at the fp32
    peak; x, g_x, g_ladj
    and the weights read once, g_z written once, at the HBM rate: what the
    function needs. K1's saved state is an intermediate of this design, not
    an input of the function, so its size is reported beside the bound
    (``k1_state_bytes``) and moves no roofline; the inverse's save
    instance that writes the state is timed beside it."""
    d, h, T = flow.n_dim, flow.n_hidden, flow.n_transforms
    if flow.kind == "nsfc":
        total = sum(w.numel() for w in flow.weights)
        elements = T * ((d + 1) // 2 + d // 2) // 2
        weights = 4 * sum(p.numel() for p in flow.parameters())
    else:
        total = sum(int(m.sum()) for m in flow.masks)
        elements = T * d
        weights = 4 * (total + T * (3 * h + flow.n_params * d))
    ops = 2 * n * total + n * elements * element_vjp_ops(flow.head, flow.bins)
    return bound(ops, 4 * (3 * n * d + n) + weights)


def side_lane(pt, fk, main, main_launches):
    """Phases 10, 12 (a), 16, 17 and 14 (d)-(f) (see the module docstring):
    sampler runs whose walls are only reported, which ``main`` runs in a
    second process of this script (``--side``) beside phases 11, 13 (a)'s
    checks, 13 (c)-(d) and 14 (a)-(b). ``main`` holds phase 6's logz, calls and
    iterations, ``main_launches`` its launches. Returns each phase's numbers,
    the launches by path and the parts' seconds; exits through ``fail`` on
    a failed check."""
    from pathlib import Path
    from pocomc_tpu_torch.mcmc import Sweep, _detached, make_loglike
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.models.geometry import fit_geometry
    log_like, prior = quickstart_like, quickstart_prior(pt)
    prior10 = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    scaler10 = pt.Reparameterize(10, bounds=prior10.bounds)
    by_path = {}
    lap("side start")

    # -- 10. without the flow, and the rwm/imh kernels ---------------------
    runs = []

    def drive(label, prior_, like_, run_kw, **kw):
        s = pt.Sampler(prior_, like_, vectorize=True, random_state=0, device="cuda", **kw)
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        torch.cuda.synchronize()
        row = dict(run=label, logz=s.logz, dlogz=s.logz_err, calls=s.calls,
                   iterations=s.t, device_loop=s._use_device_loop(),
                   wall_s=time.perf_counter() - t0, launches=read_launches(fk))
        runs.append(row)
        lap(f"10 {label}")
        return s, row

    cg_like, cg_d, cg_truth = correlated_gaussian()
    cg_prior = pt.Prior([pt.Normal(0.0, 25.0) for _ in range(cg_d)])
    for sample in ("tpcn", "rwm"):
        for loop in ("auto", False):
            label = f"precondition_false_{sample}_{'device' if loop == 'auto' else 'host'}_loop"
            s, row = drive(label, cg_prior, cg_like, dict(n_total=1024, n_evidence=0),
                           n_effective=512, n_active=256, precondition=False,
                           sample=sample, device_loop=loop)
            row["true_logz"] = cg_truth
            if s._use_device_loop() != (loop == "auto"):
                fail(f"{label}: took the wrong loop")
            if not (np.isfinite(s.logz) and abs(s.logz - cg_truth) < 0.35):
                fail(f"{label}: logZ {s.logz} outside {cg_truth} +- 0.35")
            if any(row["launches"].values()):
                fail(f"{label}: a flow kernel ran without the flow: {row['launches']}")
    mx_like, mx_truth, mx_mass = mixture()
    s, row = drive("imh_mixture", pt.Prior([pt.Normal(0.0, 10.0) for _ in range(2)]), mx_like,
                   dict(n_total=1024, n_evidence=2048), n_effective=512, n_active=256,
                   sample="imh", flow="nsf3", train_config=dict(epochs=60, patience=8))
    xs, ws, _, _ = s.posterior()
    row.update(true_logz=mx_truth, mode_mass=float(ws[xs[:, 0] > 0].sum() / ws.sum()),
               true_mode_mass=mx_mass)
    by_path["imh_mixture"] = row["launches"]
    if not (np.isfinite(s.logz) and abs(s.logz - mx_truth) < 0.3):
        fail(f"imh_mixture: logZ {s.logz} outside {mx_truth} +- 0.3")
    if not abs(row["mode_mass"] - mx_mass) < 0.1:
        fail(f"imh_mixture: mode mass {row['mode_mass']} outside {mx_mass} +- 0.1")
    g_truth = 4 * (-0.5 * np.log(2 * np.pi * 26.0))
    g_prior = pt.Prior([pt.Normal(0.0, 5.0) for _ in range(4)])

    def g_like(x):
        return -0.5 * (x * x).sum(-1) - 2.0 * math.log(2 * math.pi)

    refresh_calls = {}
    for ie in (0, 2):
        s, row = drive(f"imh_every_{ie}", g_prior, g_like, dict(n_total=512, n_evidence=512),
                       n_effective=256, n_active=128, imh_every=ie, corr_threshold=0.1,
                       flow="nsf3", train_config=dict(epochs=40, patience=5))
        row["true_logz"] = g_truth
        refresh_calls[ie] = s.calls
        by_path[f"imh_every_{ie}"] = row["launches"]
        if not (np.isfinite(s.logz) and abs(s.logz - g_truth) < 0.4):
            fail(f"imh_every={ie}: logZ {s.logz} outside {g_truth} +- 0.4")
    if not refresh_calls[2] < 1.5 * refresh_calls[0]:
        fail(f"imh_every=2 spent {refresh_calls[2]} calls, over 1.5x {refresh_calls[0]}")


    # -- 12. the rest of the flow menu ---------------------------------------
    # (a) phase 6's quickstart with maf6 (K2 and K1 with the affine head)
    # and with nsfc6 (K5), each with the launches of its kernels
    menu_runs = []
    for flow_name, names in (("maf6", AFFINE), ("nsfc6", COUPLING)):
        s = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda",
                       flow=flow_name)
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(n_total=4096, n_evidence=4096, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches(fk, names)
        others = {k: v for k, v in read_launches(fk, KERNELS).items() if k not in names}
        by_path[f"flow_menu_{flow_name}"] = counts
        x, w, _, _ = s.posterior()
        menu_runs.append(dict(flow=flow_name, logz=s.logz, dlogz=s.logz_err, true_logz=TRUE_LOGZ,
                              khat=s.evidence_khat, calls=s.calls, iterations=s.t,
                              wall_s=wall, phase_s=dict(s.phase_seconds), launches=counts))
        if any(others.values()):
            fail(f"flow_menu {flow_name}: kernels of another flow kind ran: {others}")
        if not (np.isfinite(s.logz) and abs(s.logz - TRUE_LOGZ) < LOGZ_GATE):
            fail(f"flow_menu {flow_name}: logZ {s.logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
        if x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
            fail(f"flow_menu {flow_name}: posterior samples are not finite (n, 10) arrays")
        lap(f"12 (a) {flow_name}")
    # -- 16. custom flows and the live sweep stats ---------------------------
    t16 = time.perf_counter()
    runs16, by_path["custom_flow_delegating"] = custom_flow(pt, fk, log_like, main,
                                                            main_launches)
    wall16 = time.perf_counter() - t16
    # -- 17. the JAX package's statistical gates -----------------------------
    t17 = time.perf_counter()
    rows17, failed17 = statistical(pt, "cuda", fk)
    for row in rows17:
        by_path[f"statistical_{row['run']}"] = row["launches"]
    if failed17:
        fail("statistical: " + "; ".join(failed17))
    # -- 14. (d)-(f) ---------------------------------------------------------
    # (d) a spline flow of run-time bins on the main path at full width:
    # phase 6's quickstart with flow=Flow(10, "nsf6", bins=QUICK_BINS)
    qb = QUICK_BINS
    kq = tuple(with_bins(k, qb) for k in RQS)

    def bins_quickstart():
        s = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda",
                       flow=Flow(10, "nsf6", bins=qb, device="cuda"))
        rounds = watch_evidence(s)
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(n_total=4096, n_evidence=4096, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches(fk, kq)
        others = {k: v for k, v in read_launches(fk, KERNELS).items() if v}
        x, w, _, _ = s.posterior()
        return s, dict(bins=qb, logz=s.logz, dlogz=s.logz_err, true_logz=TRUE_LOGZ,
                       khat=s.evidence_khat, evidence_rounds=rounds,
                       refinements=len(rounds) - 1, n_total=s.n_total, calls=s.calls,
                       iterations=s.t, wall_s=wall, phase_s=dict(s.phase_seconds),
                       launches=counts,
                       posterior_finite=bool(np.isfinite(x).all() and np.isfinite(w).all()),
                       other_launches=others)

    sq, quick = bins_quickstart()
    by_path["spline_bins_quickstart"] = quick["launches"]
    if not all(quick["launches"].values()) or quick["other_launches"]:
        fail(f"spline_bins quickstart: launches {quick['launches']}, of other kernels "
             f"{quick['other_launches']}")
    if not (np.isfinite(quick["logz"]) and abs(quick["logz"] - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"spline_bins quickstart: logZ {quick['logz']} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if not quick["posterior_finite"]:
        fail("spline_bins quickstart: posterior samples are not finite")
    lap("14 (d)")
    # (e) a 20-step mala sweep at d=10, n=256 on random nsf6 and nsfc6 flows
    # of each TIMED_BINS, as phase 13 (d)
    bins_sweeps = []
    for tb in TIMED_BINS:
        for name in ("nsf6", "nsfc6"):
            flow = bins_flow(name, 10, tb)[0]
            kname = gradient_kernel(flow)
            sweep = Sweep(scaler10, prior10.logpdf, make_loglike(unit_gauss), flow, 10, 20, 20,
                          kind="mala")
            g = torch.Generator("cuda").manual_seed(SEED)
            with torch.no_grad():
                scp10 = scaler10.whitening_params("cuda")
                fp = _detached(flow.params())
                u = 0.5 * torch.randn(256, 10, device="cuda", generator=g)
                x, ldj = scaler10.inverse(u, params=scp10)
                theta, _ = flow.forward(u, fp)
                geom = fit_geometry(theta, torch.full((256,), 1.0 / 256, device="cuda"), g)
                reset_launches(fk)
                st = sweep.init_state(u, x, ldj, unit_gauss(x), prior10.logpdf(x),
                                      2.38 / 10 ** 0.5, geom, fp, beta=1.0, scp=scp10)
                accepts = []
                for _ in range(20):
                    prop = sweep.propose(st, geom, fp, scp10, sweep.draw_noise(st, geom, g),
                                         beta=1.0)
                    st, _ = sweep.accept_update(st, prop, prop["logl"], 1.0, geom)
                    accepts.append(float(st.accept))
                torch.cuda.synchronize()
            counts = read_launches(fk, (kname,))
            label = f"spline_bins_head_{name}_b{tb}"
            by_path[label] = counts
            finite = all(bool(torch.isfinite(a).all()) for a in (st.u, st.x, st.logl, st.grad))
            row = dict(flow=name, bins=tb, kernel=kname, steps=st.i,
                       mean_accept=statistics.mean(accepts), sigma=float(st.sigma),
                       finite=finite, launches=counts)
            bins_sweeps.append(row)
            if not finite:
                fail(f"{label}: the sweep's state is not finite")
            if not 0.2 < row["mean_accept"] < 0.98:
                fail(f"{label}: mean acceptance {row['mean_accept']} outside (0.2, 0.98)")
            if not counts[kname]:
                fail(f"{label}: {kname} was never launched")
            lap("14 (e)")
    # (f) the quickstart's state through save_state and load_state into a
    # sampler of another seed with such a flow: bit for bit
    state_dir = Path("build/chip_smoke_bins_state")  # phase 11 owns chip_smoke_states
    state_path = state_dir / "spline_bins.state"
    sq.save_state(state_path)
    back = pt.Sampler(prior, log_like, vectorize=True, random_state=5, device="cuda",
                      flow=Flow(10, "nsf6", bins=qb, device="cuda"))
    back.load_state(state_path)
    shutil.rmtree(state_dir, ignore_errors=True)
    pts = torch.from_numpy(np.random.default_rng(SEED).normal(0.0, 2.0, (64, 10))
                           .astype(np.float32)).cuda()
    with torch.no_grad():
        round_trip = (back.evidence() == sq.evidence() and back.flow.bins == qb
                      and all(np.array_equal(u, v) for u, v in zip(back.posterior(),
                                                                   sq.posterior()))
                      and all(torch.equal(u, v) for u, v in zip(back.flow.parameters(),
                                                                sq.flow.parameters()))
                      and torch.equal(back.flow.log_prob(pts), sq.flow.log_prob(pts)))
    if not round_trip:
        fail("spline_bins: the saved state did not load back bit for bit")
    lap("14 (f)")
    return dict(by_path=by_path, flow_free=runs, menu_runs=menu_runs,
                spline_bins=dict(quickstart=quick, head_sweeps=bins_sweeps,
                                 state_round_trip=round_trip),
                custom_flow=dict(runs16, wall_s=wall16), statistical=rows17,
                statistical_wall_s=time.perf_counter() - t17, parts=PARTS)


def side_main(args):
    """The second process (``python3 chip_smoke.py --side <json>``):
    ``side_lane`` on the arguments ``main`` passed; its numbers are the
    last line of the output."""
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.ops import flow_kernels as fk
    out = side_lane(pt, fk, args["main"], args["launches"])
    print(json.dumps({"side": out}), flush=True)


def start_side(main, launches):
    """Starts ``side_lane`` in a second process of this script, its output
    and errors into temporary files; returns (the process, the files)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side",
         json.dumps(dict(main=main, launches=launches))], stdout=out, stderr=err, text=True)
    CHILDREN.append(proc)
    return proc, out, err


def finish_side(side):
    """Waits for ``start_side``'s process and passes its errors and warnings
    on; returns ``side_lane``'s numbers, or fails."""
    proc, out, err = side
    rc = proc.wait()
    with out, err:
        out.seek(0)
        err.seek(0)
        sys.stderr.write(err.read())
        lines = [ln for ln in out.read().splitlines() if ln.startswith('{"side": ')]
    if rc != 0 or not lines:
        fail(f"the second process (phases 10, 12 (a), 14 (d)-(f), 16 and 17) ended with "
             f"exit code {rc}")
    return json.loads(lines[-1])["side"]


def main():
    # -- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import pocomc_tpu_torch as pt
    from pocomc_tpu_torch.ops import _build
    from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    except OSError:
        card = "unknown (nvidia-smi not found)"
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on after importing pocomc_tpu_torch")
    if "jax" in sys.modules:
        fail("jax was imported")
    lap("1 environment")
    emit("environment", card=card, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- 2. build ----------------------------------------------------------
    # One nvcc per source and library (the default 8 bins, 16 and the
    # run-time bins of every bins past 16: LIBRARY_BINS). The build is bound
    # by the host's cores: the 18 libraries take ~700 s of a core, so
    # starting them together or longest first ends at the same time. The
    # six 8-bin libraries, which every phase but 14 takes, build first, all
    # together; the twelve of phase 14 build meanwhile in background
    # threads, their nvcc at the lowest priority (``nice``), and phase 14
    # waits for them. Each library's seconds overlap the others', and
    # wall_s is the build's own.
    def build_one(job, nice=0):
        name, bins = job
        t0 = time.perf_counter()
        path, report = _build.build(name, bins, nice=nice)
        return with_bins(name, bins), dict(
            seconds=round(time.perf_counter() - t0, 3),
            ended_s=round(time.perf_counter() - t_build, 3), library=path.name,
            ptxas=[l.strip() for l in report.splitlines() if "registers" in l or "spill" in l],
            resources=ptxas_summary(report))

    def summary(builds):
        return {k: v if k in LIBRARIES else {key: v[key] for key in (
            "seconds", "ended_s", "library", "resources")} for k, v in builds.items()}

    later = [(name, bins) for bins in LIBRARY_BINS if bins != 8 for name in LIBRARIES]
    t_build = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        build = dict(ex.map(build_one, [(name, 8) for name in LIBRARIES]))
    lap("2 build")
    emit("build", cpu_count=os.cpu_count(), wall_s=round(time.perf_counter() - t_build, 3),
         **summary(build))
    # -- 3./4. kernels against their plain versions ------------------------
    errs = dict.fromkeys(KERNELS, 0.0)
    checks = []
    flows = {(f, d): random_flow(f, d) for f, d in sorted({(f, d) for f, d, _ in SHAPES})}
    for name, d, n, _ in planned("3-4", "check_spline_made"):
        flow, rng = flows[name, d]
        out, e = check_spline_made(name, d, n, flow, rng)
        checks.append(out)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        lap("3-4 checks")
    # the rest of the menu: maf* (the affine head) and nsfc* (K5)
    menu_checks = []
    for name, d, n, _ in planned("3-4", "check_menu"):
        if (name, d) not in flows:
            h = max(2 ** (3 * d - 1).bit_length(), 32)  # Flow.n_hidden
            flows[name, d] = random_flow(name, d, MENU_SCALE * math.sqrt(32 / h))
        flow, rng = flows[name, d]
        out, e = check_menu(name, d, n, flow, rng, TOL[max(d, 10)])
        menu_checks.append(out)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        lap("3-4 menu checks")
    emit("kernels_vs_plain", checks=checks, menu_checks=menu_checks)
    # the tile each K5 launch of phases 3-4 took, as the wrapper planned and
    # kept it: the lane grid (RL 4 a Tile, 1 a Row), BM rows a block, RM x
    # RNH (hidden) and RM x RNO (output group) accumulators a thread, G
    # dimensions an output group, BK-row slabs in an S-stage ring, the
    # block's shared memory and whether the weights were packed
    emit("k5_plans", plans=[
        dict(kernel="coupling_backward" if backward else "coupling_forward/inverse", n=n, d=d,
             h=h, T=T, **cfg._asdict())
        for (backward, n, d, h, T), cfg in sorted({
            (backward, *plan[:4]): plan[4]
            for (backward, _), plan in ck._PLANS.items() if plan[4] is not None}.items())])

    # -- 5. times ------------------------------------------------------------
    # ms: device time of one call (graph replay); call_ms: one eager call
    times = []
    for d, n in TIMED:
        flow, rng = flows["nsf6", d]
        y, g_z, g_l = grad_problem(flow, d, n, rng)
        with torch.no_grad():
            fp = flow.params()
            _, _, acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True)
            deltas = [torch.randn(w.shape[0], n, w.shape[2], device="cuda") for w in fp.ws]
            orders_cpu = fp.inv_orders.cpu()
            reps_plain = 3 if d == 50 else 10
            calls = {
                "k2": (lambda: fk.made_rqs_forward(y, fp.ws, fp.bs), 20),
                "k2_plain": (lambda: fk.made_rqs_forward_ref(y, fp.ws, fp.bs), reps_plain),
                "k2_bwd": (lambda: fk.made_rqs_backward(y, fp.ws, fp.bs, g_z, g_l, acts), 20),
                "k2_bwd_plain": (lambda: fk.made_rqs_backward_ref(y, fp.ws, fp.bs, g_z, g_l,
                                                                  acts), reps_plain),
                "k2_bwd_matmul": (lambda: backward_matmul_products(flow, y, acts, deltas), 20),
                "k1": (lambda: fk.ar_inverse(y, fp.ws, fp.bs, fp.inv_orders), 20),
                "k1_plain": (lambda: fk.ar_inverse_ref(y, fp.ws, fp.bs, orders_cpu),
                             reps_plain)}
            row = dict(d=d, n=n)
            for key, (fn, reps) in calls.items():
                row[f"{key}_ms"], row[f"{key}_call_ms"] = timed_ms(
                    fn, reps, min(reps, 3) if key.endswith("_plain") else reps)
        times.append(row)
    # K1's chain: one call at n=1, where nothing but the T*d dependent
    # steps is left; and the weight pack it builds once per FlowParams
    chain = {}
    for d in sorted({d for d, _ in TIMED}):
        fp = flows["nsf6", d][0].params()
        with torch.no_grad():
            z1 = torch.zeros(1, d, device="cuda")
            key = f"d{d}"
            chain[f"k1_chain_ms_{key}"] = timed_ms(
                lambda: fk.ar_inverse(z1, fp.ws, fp.bs, fp.inv_orders), 20)[0]

            def repack():
                fp.ws[0]._k1_pack = None
                fk.ar_inverse(z1, fp.ws, fp.bs, fp.inv_orders)

            chain[f"k1_with_pack_call_ms_{key}"] = cuda_ms(repack, 20)
    # one fit_stack batch step (zero_grad, loss, backward, clip, AdamW) at
    # d=10, batch 1024, on the kernel route and on plain autograd
    import pocomc_tpu_torch.models.flow as flow_mod
    step_ms = {}
    for route, forward in (("kernel", fk.made_rqs_forward), ("plain", fk.made_rqs_forward_ref)):
        flow = copy.deepcopy(flows["nsf6", 10][0])
        params = list(flow.parameters())
        opt = torch.optim.AdamW(params, lr=1e-3)
        g = torch.Generator("cuda").manual_seed(SEED)
        xb = torch.randn(1024, 10, device="cuda", generator=g)
        wb = torch.rand(1024, device="cuda", generator=g)
        flow_mod.made_rqs_forward = forward

        def step():
            opt.zero_grad(set_to_none=True)
            loss = flow._loss_fn(xb, wb)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(params, 1.0)
            opt.step()

        step_ms[route] = cuda_ms(step, 50 if route == "kernel" else 10)
    flow_mod.made_rqs_forward = fk.made_rqs_forward
    # the sweep's per-step stopping-rule read: one device scalar to the host
    flag = torch.zeros((), device="cuda")
    syncs = []
    for _ in range(200):
        t0 = time.perf_counter()
        bool((flag + 1.0) > 0.0)
        syncs.append((time.perf_counter() - t0) * 1e6)
    # the rest of the menu at its shapes: each kernel and head, its plain
    # version, and for K5 its four products as torch.matmul (TF32 off)
    menu_times = []
    for name, d, n in MENU_SHAPES:
        if n == 37:
            continue
        flow, rng = flows[name, d]
        y = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        g_z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        reps_plain = 3 if d == 50 else 10
        with torch.no_grad():
            fp = flow.params()
            if flow.kind == "nsfc":
                a = (fp.ws, fp.bs, fp.masks)
                calls = {"coupling_forward": (lambda: ck.coupling_forward(y, *a), 20),
                         "coupling_forward_plain": (lambda: ck.coupling_forward_ref(y, *a),
                                                    reps_plain),
                         "coupling_inverse": (lambda: ck.coupling_inverse(y, *a), 20),
                         "coupling_inverse_plain": (lambda: ck.coupling_inverse_ref(y, *a),
                                                    reps_plain),
                         "coupling_matmul": (lambda: matmul_products(flow, y), 20)}
                if n <= 4096:
                    acts = ck.coupling_forward(y, *a, save_inputs=True)[2]
                    T, h = flow.n_transforms, flow.n_hidden
                    deltas = [torch.randn(T, n, k, device="cuda")
                              for k in (h, h, h, (d + 1) // 2 * flow.n_params)]
                    calls.update({
                        "coupling_backward": (lambda: ck.coupling_backward(y, *a, g_z, g_l,
                                                                           acts), 20),
                        "coupling_backward_plain": (lambda: ck.coupling_backward_ref(
                            y, *a, g_z, g_l, acts), reps_plain),
                        "coupling_backward_matmul": (lambda: backward_matmul_products(
                            flow, y, acts, deltas), 20)})
                bounds = coupling_bounds(n, flow)
            else:
                acts = fk.made_rqs_forward(y, fp.ws, fp.bs, save_inputs=True, head="affine")[2]
                deltas = [torch.randn(w.shape[0], n, w.shape[2], device="cuda") for w in fp.ws]
                orders_cpu = fp.inv_orders.cpu()
                calls = {
                    "made_rqs_forward_affine": (lambda: fk.made_rqs_forward(
                        y, fp.ws, fp.bs, head="affine"), 20),
                    "made_rqs_forward_affine_plain": (lambda: fk.made_rqs_forward_ref(
                        y, fp.ws, fp.bs, head="affine"), reps_plain),
                    "made_rqs_backward_affine": (lambda: fk.made_rqs_backward(
                        y, fp.ws, fp.bs, g_z, g_l, acts, head="affine"), 20),
                    "made_rqs_backward_affine_plain": (lambda: fk.made_rqs_backward_ref(
                        y, fp.ws, fp.bs, g_z, g_l, acts, head="affine"), reps_plain),
                    "made_rqs_backward_affine_matmul": (lambda: backward_matmul_products(
                        flow, y, acts, deltas), 20),
                    "ar_inverse_affine": (lambda: fk.ar_inverse(
                        y, fp.ws, fp.bs, fp.inv_orders, head="affine"), 20),
                    "ar_inverse_affine_plain": (lambda: fk.ar_inverse_ref(
                        y, fp.ws, fp.bs, orders_cpu, head="affine"), reps_plain)}
                bounds = {f"{k}_affine": v for k, v in made_bounds(n, flow).items()}
            row = dict(flow=name, d=d, n=n)
            for key, (fn, reps) in calls.items():
                row[f"{key}_ms"], row[f"{key}_call_ms"] = timed_ms(
                    fn, reps, min(reps, 3) if key.endswith("_plain") else reps)
            for key, (b_ms, b_by) in bounds.items():
                if f"{key}_ms" in row:
                    row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b_ms, b_by
        menu_times.append(row)
    lap("5 times")
    emit("times", card=card, shapes=times, menu_shapes=menu_times, fit_step_ms=step_ms,
         scalar_sync_us=statistics.median(syncs), **chain)

    # -- 6. main path --------------------------------------------------------
    log_like, prior = quickstart_like, quickstart_prior(pt)
    sampler = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda")
    rounds = watch_evidence(sampler)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(fk)
    logz, dlogz = sampler.evidence()
    main = dict(logz=logz, calls=sampler.calls, iterations=sampler.t)
    main_wall = wall
    x, w, _, _ = sampler.posterior()
    steps = [s["steps"] for s in sampler._iter_stats]
    epochs = [s["train_epochs"] for s in sampler._iter_stats if s["train_epochs"]]
    lap("6")
    emit("main_path", card=card, logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ,
         khat=sampler.evidence_khat, evidence_rounds=rounds, refinements=len(rounds) - 1,
         n_total=sampler.n_total, calls=sampler.calls, iterations=sampler.t,
         sweep_steps=sum(steps), train_epochs=sum(epochs), wall_s=wall,
         phase_s=sampler.phase_seconds,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         posterior_shape=list(x.shape), posterior_finite=bool(np.isfinite(x).all()))
    if not all(launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"quickstart logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("posterior samples are not finite (n, 10) arrays")

    # -- 7. black-box path -------------------------------------------------
    like = TimedLikelihood(rosenbrock_row)
    sampler = pt.Sampler(prior, like, blobs_dtype=np.float64, random_state=0, device="cuda")
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=4096, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bb_launches = read_launches(fk)
    logz, dlogz = sampler.evidence()
    x, w, _, _, blobs = sampler.posterior(return_blobs=True)
    steps = [s["steps"] for s in sampler._iter_stats]
    epochs = [s["train_epochs"] for s in sampler._iter_stats if s["train_epochs"]]
    lap("7")
    emit("black_box", card=card, logz=logz, dlogz=dlogz, true_logz=TRUE_LOGZ,
         khat=sampler.evidence_khat, route=sampler.likelihood_route,
         traceable=sampler.likelihood_traceable, calls=sampler.calls,
         likelihood_rows=like.rows, likelihood_s=like.seconds, iterations=sampler.t,
         sweep_steps=sum(steps), train_epochs=sum(epochs), wall_s=wall,
         phase_s=sampler.phase_seconds, launches=bb_launches,
         posterior_shape=list(x.shape), blobs_shape=list(blobs.shape))
    if sampler.likelihood_traceable:
        fail("the per-row numpy likelihood was routed to the device")
    if not all(bb_launches.values()):
        fail(f"a kernel of the black-box path was never launched: {bb_launches}")
    if not (np.isfinite(logz) and abs(logz - TRUE_LOGZ) < LOGZ_GATE):
        fail(f"black-box logZ {logz} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
    if x.ndim != 2 or x.shape[1] != 10 or not np.isfinite(x).all() or not np.isfinite(w).all():
        fail("black-box posterior samples are not finite (n, 10) arrays")
    if not np.allclose(blobs, np.sum(x * x, axis=1), rtol=1e-5, atol=0.0):
        fail("black-box blobs differ from sum(x^2) of the returned samples")
    by_path = {"main_path": launches, "black_box": bb_launches}
    k1_in_bridge = {}

    # -- 8. run(n_evidence=0): the ladder-grade sweep, then the bridge -----
    sampler = pt.Sampler(prior, log_like, vectorize=True, random_state=0, device="cuda")
    seen = watch_bridge(sampler, fk)
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["evidence_ladder_bridge"] = read_launches(fk)
    out = check_bridge("evidence_ladder_bridge", sampler, seen, bias_floor=0.15)
    k1_in_bridge["evidence_ladder_bridge"] = out["k1_launches_in_bridge"]
    lap("8")
    emit("evidence_ladder_bridge", card=card, **out, calls=sampler.calls,
         iterations=sampler.t, wall_s=wall, phase_s=sampler.phase_seconds,
         launches=by_path["evidence_ladder_bridge"])

    # -- 9. the bridge's host route ------------------------------------------
    like = TimedLikelihood(rosenbrock_row)
    sampler = pt.Sampler(prior, like, blobs_dtype=np.float64, random_state=0, device="cuda")
    seen = watch_bridge(sampler, fk)
    reset_launches(fk)
    t0 = time.perf_counter()
    sampler.run(n_total=4096, n_evidence=0, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["evidence_bridge_black_box"] = read_launches(fk)
    if sampler.likelihood_traceable:
        fail("evidence_bridge_black_box: the per-row numpy likelihood was routed to the device")
    out = check_bridge("evidence_bridge_black_box", sampler, seen, bias_floor=0.0)
    k1_in_bridge["evidence_bridge_black_box"] = out["k1_launches_in_bridge"]
    lap("9")
    emit("evidence_bridge_black_box", card=card, **out, route=sampler.likelihood_route,
         calls=sampler.calls, likelihood_rows=like.rows, likelihood_s=like.seconds,
         iterations=sampler.t, wall_s=wall, phase_s=sampler.phase_seconds,
         launches=by_path["evidence_bridge_black_box"])

    # -- 12. the rest of the flow menu ---------------------------------------
    # ((a), the quickstart with maf6 and nsfc6, runs in the second process)
    from pocomc_tpu_torch.mcmc import Sweep, _detached, make_loglike
    from pocomc_tpu_torch.models.flow import Flow
    from pocomc_tpu_torch.models.geometry import fit_geometry
    # (b) the JAX package's compute-bound bench line (bench.py:180-250,
    # 276-286): d=50 Rosenbrock under N(0, 3) priors, nsfc12 at its init
    # (seed 0), 65,536 particles, the preconditioned t-pCN sweep with its
    # stopping rule held off (tools/measure_paths.py), 4 steps a sweep, two
    # sweeps chained from u ~ N(0, 1), the geometry fitted on u
    d50, n50, steps50, chains50 = 50, 65536, 4, 2

    def rosenbrock50(x):
        return -(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2).sum(-1)

    prior50 = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(d50)])
    scaler50 = pt.Reparameterize(d50, bounds=prior50.bounds)
    flow50 = Flow(d50, "nsfc12", seed=0, device="cuda")
    sweep50 = Sweep(scaler50, prior50.logpdf, make_loglike(rosenbrock50), flow50, d50,
                    steps50, steps50)
    sweep50.keep_flag = lambda st: torch.ones((), dtype=torch.bool, device="cuda")
    g50 = torch.Generator("cuda").manual_seed(SEED)
    with torch.no_grad():
        scp50 = scaler50.whitening_params("cuda")
        u = torch.randn(n50, d50, device="cuda", generator=g50)
        x, ldj = scaler50.inverse(u, params=scp50)
        geom50 = fit_geometry(u, torch.full((n50,), 1.0 / n50, device="cuda"), g50)
        fp50 = flow50.params()
        state = (u, x, ldj, rosenbrock50(x), prior50.logpdf(x))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(fk)
        t0 = time.perf_counter()
        steps, chain_s = [], []
        for _ in range(chains50):
            res = sweep50.run(*state, 0.7, 0.75, geom50, fp50, scp50, g50)
            state = (res["u"], res["x"], res["logdetj"], res["logl"], res["logp"])
            steps.append(int(res["steps"]))
            torch.cuda.synchronize()
            chain_s.append(time.perf_counter() - t0 - sum(chain_s))
        wall = time.perf_counter() - t0
        u_out = state[0]
    by_path["flow_menu_bench_sweep"] = read_launches(fk, COUPLING[:2])
    bench = dict(flow="nsfc12", n_dim=d50, n_particles=n50, steps=steps, chain_s=chain_s,
                 wall_s=wall, particle_steps_per_s=n50 * sum(steps) / wall,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 launches=by_path["flow_menu_bench_sweep"],
                 u_finite=bool(torch.isfinite(u_out).all()),
                 logl_finite_share=float(torch.isfinite(state[3]).float().mean()))
    if steps != [steps50] * chains50:
        fail(f"flow_menu bench sweep ran {steps} steps, not {steps50} x {chains50}")
    if not bench["u_finite"] or tuple(u_out.shape) != (n50, d50):
        fail("flow_menu bench sweep: the particles are not a finite (65536, 50) array")
    lap("12 (b)")

    # -- 13. the gradient kernels: mala and hmc -------------------------------
    # ((a), K1-bwd (both heads) and K5-inv-bwd against the plain versions on
    # the card, runs in the lanes, its times once they end)
    # the runs of (b) and (c): a quickstart-like run with the gradient
    # kernels on its path, its gates and its ms a sweep step
    grad_runs = []

    def drive_gradient(letter, label, prior_, like_, names, truth, run_kw, **kw):
        s = pt.Sampler(prior_, like_, vectorize=True, random_state=0, device="cuda", **kw)
        reset_launches(fk)
        t0 = time.perf_counter()
        s.run(progress=False, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches(fk, names)
        logz, dlogz = s.evidence()
        steps = sum(st["steps"] for st in s._iter_stats)
        x, w, _, _ = s.posterior()
        row = dict(run=label, logz=logz, dlogz=dlogz, true_logz=truth, calls=s.calls,
                   iterations=s.t, wall_s=wall, phase_s=dict(s.phase_seconds),
                   sweep_steps=steps, ms_per_sweep_step=1e3 * s.phase_seconds["mutate"] / steps,
                   launches=counts)
        grad_runs.append(row)
        by_path[label] = counts
        if not all(counts.values()):
            fail(f"{label}: a kernel of the path was never launched: {counts}")
        if not (np.isfinite(logz) and abs(logz - truth) < LOGZ_GATE):
            fail(f"{label}: logZ {logz} outside {truth} +- {LOGZ_GATE}")
        if not (np.isfinite(x).all() and np.isfinite(w).all()):
            fail(f"{label}: posterior samples are not finite")
        lap(f"13 {letter} {label}")

    # (b) the slice's path at full width: phase 6's quickstart with
    # sample="mala" (hmc runs end to end in (c): its full-width run was cut
    # for time)
    drive_gradient("(b)", "gradient_quickstart_mala", prior, log_like, RQS + GRADIENT[:1],
                   TRUE_LOGZ, dict(n_total=4096, n_evidence=4096), sample="mala")
    # (e) the same sweep on random nsf flows past d=10: d=50, nsf6 at n=4096
    # (ms a step and acceptance) and d=342, nsf3 at n=256 (h=2048: K1-bwd's
    # groups in fan-in chunks; it must run, with finite states and
    # gradients); launches counted from the start's gradient on, ms over the
    # 20 steps
    wide_sweeps = []
    for name, d, n in (("nsf6", 50, 4096), ("nsf3", 342, 256)):
        if (name, d) not in flows:
            h = max(2 ** (3 * d - 1).bit_length(), 32)  # Flow.n_hidden
            flows[name, d] = random_flow(name, d, MENU_SCALE * math.sqrt(32 / h))
        flow = flows[name, d][0]
        prior_d = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(d)])
        scaler_d = pt.Reparameterize(d, bounds=prior_d.bounds)
        sweep = Sweep(scaler_d, prior_d.logpdf, make_loglike(unit_gauss), flow, d, 20, 20,
                      kind="mala")
        g = torch.Generator("cuda").manual_seed(SEED)
        with torch.no_grad():
            scp = scaler_d.whitening_params("cuda")
            fp = _detached(flow.params())
            u = 0.5 * torch.randn(n, d, device="cuda", generator=g)
            x, ldj = scaler_d.inverse(u, params=scp)
            theta, _ = flow.forward(u, fp)
            geom = fit_geometry(theta, torch.full((n,), 1.0 / n, device="cuda"), g)
            reset_launches(fk)
            st = sweep.init_state(u, x, ldj, unit_gauss(x), prior_d.logpdf(x), 2.38 / d ** 0.5,
                                  geom, fp, beta=1.0, scp=scp)
            torch.cuda.synchronize()
            accepts = []
            t0 = time.perf_counter()
            for _ in range(20):
                prop = sweep.propose(st, geom, fp, scp, sweep.draw_noise(st, geom, g), beta=1.0)
                st, _ = sweep.accept_update(st, prop, prop["logl"], 1.0, geom)
                accepts.append(float(st.accept))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 20
        label = f"gradient_sweep_{name}_d{d}"
        counts = read_launches(fk, ("ar_inverse", GRADIENT[0]))
        by_path[label] = counts
        finite = all(bool(torch.isfinite(a).all()) for a in (st.u, st.x, st.logl, st.grad))
        wide_sweeps.append(dict(flow=name, d=d, n=n, steps=st.i, ms_per_step=ms,
                                mean_accept=statistics.mean(accepts), sigma=float(st.sigma),
                                finite=finite, launches=counts))
        if not finite:
            fail(f"{label}: the sweep's state or gradient is not finite")
        if not all(counts.values()):
            fail(f"{label}: a kernel of the path was never launched: {counts}")
        lap("13 (e)")
    # -- the lanes ---------------------------------------------------------
    # From here two processes share the host and the card: this one runs
    # phases 11, 13 (a)'s checks, 13 (c)-(d) and 14 (a)-(b) (with phase 15
    # (b)'s two ranks beside 14 (b)), a second one phases 10, 12 (a), 16, 17
    # and 14 (d)-(f) (``side_lane``), and the libraries of phase 14 build
    # behind both at the lowest priority; what is timed (5-9, 12 (b), 13 (b)
    # and 13 (e) above, 13 (a)'s times and 14 (c) after) runs alone
    side = start_side(main, launches)
    t_later = time.perf_counter() - t_build
    background = ThreadPoolExecutor(len(later))
    later_builds = [background.submit(build_one, job, 19) for job in later]
    lap("lanes start")

    # -- 11. the reference surface: scipy and numpy priors, checkpoints -----
    # (a) runs on a one-rank NCCL mesh in this process: phase 15 (a)
    from pathlib import Path
    from pocomc_tpu_torch.parallel import smoke
    pt.initialize_distributed(f"localhost:{smoke._free_port()}", 1, 0)
    lap("11 mesh setup")
    try:
        surface, paths = reference_surface(pt, fk, log_like, main,
                                           Path("build/chip_smoke_states"),
                                           mesh=pt.ParticleMesh())
    finally:
        torch.distributed.destroy_process_group()
    lap("11 mesh setup")
    by_path.update({f"reference_{k}": v for k, v in paths.items()})
    emit("reference_surface", card=card, phase6=main, **surface)

    # (a) K1-bwd (both heads) and K5-inv-bwd against the plain versions on
    # the card (their times once the lanes end)
    grad_checks = []
    for name, d, n, _ in planned("13 (a)", "check_gradient"):
        if (name, d) not in flows:
            h = max(2 ** (3 * d - 1).bit_length(), 32)  # Flow.n_hidden
            flows[name, d] = random_flow(name, d, MENU_SCALE * math.sqrt(32 / h))
        flow, rng = flows[name, d]
        out, e = check_gradient(name, d, n, flow, rng)
        grad_checks.append(out)
        errs[out["kernel"]] = max(errs.get(out["kernel"], 0.0), e)
        lap("13 (a) checks")
    # (c) tests/test_mala.py:97-144 on the card: d=4, nsf3, n_active 128
    from scipy.stats import multivariate_normal
    d4 = 4
    rng4 = np.random.default_rng(0)
    q4, _ = np.linalg.qr(rng4.normal(size=(d4, d4)))
    cov4 = (q4 * np.logspace(0, 1.5, d4)) @ q4.T
    ci4 = torch.tensor(np.linalg.inv(cov4), dtype=torch.float32, device="cuda")
    nc4 = -0.5 * (d4 * np.log(2 * np.pi) + np.linalg.slogdet(cov4)[1])
    truth4 = multivariate_normal.logpdf(np.zeros(d4), np.zeros(d4), cov4 + 100.0 * np.eye(d4))

    def like4(x):
        return nc4 - 0.5 * torch.einsum("ni,ij,nj->n", x, ci4, x)

    for sample, leap in (("mala", 5), ("hmc", 3)):
        drive_gradient("(c)", f"test_mala_{sample}", pt.Prior([pt.Normal(0.0, 10.0)] * d4), like4,
                       RQS + GRADIENT[:1], truth4, dict(n_total=1024, n_evidence=1024),
                       sample=sample, n_leapfrog=leap, n_effective=256, n_active=128,
                       flow="nsf3", train_config=dict(epochs=60, patience=8))
    # (d) the other heads on a path: one preconditioned mala sweep of 20
    # steps (the stopping rule held off) at d=10, n=256, on phase 12's
    # random maf6 and nsfc6 flows: a unit Gaussian likelihood under N(0, 3)
    # priors from u ~ N(0, 0.5^2), beta 1
    head_sweeps = []
    prior10 = pt.Prior([pt.Normal(0.0, 3.0) for _ in range(10)])
    scaler10 = pt.Reparameterize(10, bounds=prior10.bounds)
    for name in ("maf6", "nsfc6"):
        flow = flows[name, 10][0]
        kname = gradient_kernel(flow)
        sweep = Sweep(scaler10, prior10.logpdf, make_loglike(unit_gauss), flow, 10, 20, 20,
                      kind="mala")
        g = torch.Generator("cuda").manual_seed(SEED)
        with torch.no_grad():
            scp10 = scaler10.whitening_params("cuda")
            fp = _detached(flow.params())
            u = 0.5 * torch.randn(256, 10, device="cuda", generator=g)
            x, ldj = scaler10.inverse(u, params=scp10)
            theta, _ = flow.forward(u, fp)
            geom = fit_geometry(theta, torch.full((256,), 1.0 / 256, device="cuda"), g)
            reset_launches(fk)
            st = sweep.init_state(u, x, ldj, unit_gauss(x), prior10.logpdf(x), 2.38 / 10 ** 0.5,
                                  geom, fp, beta=1.0, scp=scp10)
            accepts = []
            forwards = ck.coupling_forward.launches
            for _ in range(20):
                prop = sweep.propose(st, geom, fp, scp10, sweep.draw_noise(st, geom, g),
                                     beta=1.0)
                st, _ = sweep.accept_update(st, prop, prop["logl"], 1.0, geom)
                accepts.append(float(st.accept))
            forwards = ck.coupling_forward.launches - forwards
            torch.cuda.synchronize()
        counts = read_launches(fk, (kname,))
        by_path[f"gradient_head_{name}"] = counts
        finite = all(bool(torch.isfinite(a).all()) for a in (st.u, st.x, st.logl, st.grad))
        row = dict(flow=name, kernel=kname, steps=st.i, mean_accept=statistics.mean(accepts),
                   sigma=float(st.sigma), finite=finite, launches=counts,
                   coupling_forward_launches_in_steps=forwards)
        head_sweeps.append(row)
        if not finite:
            fail(f"gradient_head_{name}: the sweep's state is not finite")
        if not 0.2 < row["mean_accept"] < 0.98:
            fail(f"gradient_head_{name}: mean acceptance {row['mean_accept']} outside "
                 f"(0.2, 0.98)")
        if not counts[kname]:
            fail(f"gradient_head_{name}: {kname} was never launched")
        if forwards:
            fail(f"gradient_head_{name}: {forwards} K5 forward launches in the mala steps")
        lap("13 (d)")
    # -- 14. the spline of other bins than 8 -------------------------------
    # (a) the libraries of 16 and run-time bins, built in the background
    # since phase 9 ended
    t_wait = time.perf_counter()
    later_build = dict(f.result() for f in later_builds)
    background.shutdown()
    build.update(later_build)
    lap("14 (a)")
    emit("build_background", wait_s=round(time.perf_counter() - t_wait, 3),
         wall_s=round(max(v["ended_s"] for v in later_build.values()) - t_later, 3),
         **summary(later_build))
    # (b) every spline-head kernel at other bins than 8 against its plain
    # version (and float64 where phases 4 and 13 hold it so), at phase 3-4's
    # and 13's tolerances and exclusion windows: K2, K2-bwd and K1, K5's
    # forward, inverse and backward, K1-bwd and K5-inv-bwd at 16 bins and at
    # every WIDE_BINS at (10, 256), and at each TIMED_BINS (16, the compiled
    # library's, and 32, the run-time library's) also K1's two- and
    # four-row launches, d=50 and d=342 (K2, K1) and d=50 (K5, the gradient
    # kernels)
    bins_errs = {}

    def keep_err(e):
        for k, v in e.items():
            bins_errs[k] = max(bins_errs.get(k, 0.0), v)

    # phase 15 (b)'s two ranks, processes of their own sharing the card,
    # run beside these checks, which leave most of the host's cores and of
    # the card idle; phase 15 reads their lines
    mesh_pool = ThreadPoolExecutor(1)
    t15 = time.perf_counter()
    mesh_run = mesh_pool.submit(smoke.launch, 2, 1, timeout=600.0,
                                cases="core,dev,host,resume,quickstart", device="cuda")
    t14 = time.perf_counter()
    bins_checks, bins_menu, bins_grad = [], [], []
    for name, d, n, b in planned("14 (b)", "check_spline_made"):
        out, e = check_spline_made(name, d, n, *bins_flow(name, d, b))
        bins_checks.append(out)
        keep_err(e)
        lap(f"14 (b) b{b} check_spline_made")
    for name, d, n, b in planned("14 (b)", "check_menu"):
        out, e = check_menu(name, d, n, *bins_flow(name, d, b), TOL[d], grad_rows=1024)
        bins_menu.append(dict(out, bins=b))
        keep_err(e)
        lap(f"14 (b) b{b} check_menu")
    for name, d, n, b in planned("14 (b)", "check_gradient"):
        out, e = check_gradient(name, d, n, *bins_flow(name, d, b))
        bins_grad.append(dict(out, bins=b))
        keep_err({out["kernel"]: e})
        lap(f"14 (b) b{b} check_gradient")
    check_s = time.perf_counter() - t14
    # the two ranks end before anything is timed
    lines = mesh_run.result()
    mesh_pool.shutdown()
    mesh_s = time.perf_counter() - t15
    lap("15 (b) beside 14 (b)")
    # the second process's phases end before anything more is timed
    side = finish_side(side)
    by_path.update(side["by_path"])
    lap("lanes: the second process")
    emit("flow_free_and_kernels", card=card, runs=side["flow_free"])

    emit("flow_menu", card=card, quickstart=side["menu_runs"], bench_sweep=bench)

    # -- 13. (a)'s times ---------------------------------------------------
    grad_times = []
    for name, d, n in GRAD_SHAPES:
        if n == 37:
            continue
        flow, rng = flows[name, d]
        inv, _, bwd, twin, saving, point = inverse_routes(flow)
        fp = _detached(flow.params())
        kname = gradient_kernel(flow)
        x, g_x = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
                  for _ in range(2))
        g_l = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        reps_plain = 3 if d >= 50 else 10
        # the plain twin reads the visit orders on the host, as phase 5's K1
        fp_host = fp if flow.kind == "nsfc" else fp._replace(inv_orders=fp.inv_orders.cpu())
        with torch.no_grad():
            # the kernel on the state the inverse's save instance writes at
            # z, x its output; the inverse without the save beside it
            z = x
            x, _, data = saving(z, None, fp)
            key = "k5_inv" if flow.kind == "nsfc" else "k1"
            forward = {f"{key}_save": (lambda: saving(z, None, fp), 20),
                       key: (lambda: inv(z, fp), 20)}
            plain_at = point(z, x, fp)
            calls = {kname: (lambda: bwd(data, fp, g_x, g_l), 20),
                     f"{kname}_plain": (lambda: twin(plain_at, fp_host, g_x, g_l), reps_plain),
                     **forward}
            if flow.kind == "nsfc":
                T, h = flow.n_transforms, flow.n_hidden
                deltas = [torch.randn(T, n, k, device="cuda")
                          for k in (h, h, h, (d + 1) // 2 * flow.n_params)]
                calls[f"{kname}_matmul"] = (lambda: backward_matmul_products(
                    flow, x, data[:4], deltas, weight_grads=False), 20)
            row = dict(kernel=kname, flow=name, d=d, n=n)
            for key, (fn, reps) in calls.items():
                # a plain twin's eager calls take 0.4 s at d=10 and 1.7-4.9 s
                # past it: three of them, one past d=10 (the script's time)
                eager = (1 if d >= 50 else 3) if key.endswith("_plain") else reps
                row[f"{key}_ms"], row[f"{key}_call_ms"] = timed_ms(fn, reps, eager)
            row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = gradient_bounds(n, flow)
            if flow.kind != "nsfc":
                row["k1_state_bytes"] = sum(a.numel() * a.element_size() for a in data)
        grad_times.append(row)
        lap("13 (a) times")
    emit("gradient_kernels", card=card, checks=grad_checks, times=grad_times, runs=grad_runs,
         head_sweeps=head_sweeps, wide_sweeps=wide_sweeps)

    # -- 14. (c) -------------------------------------------------------------
    # (c) the kernels of each TIMED_BINS at the kernels line's shapes
    # (phase 5's rule: device ms by graph replay, eager ms by events),
    # beside their plain versions, bounds and products as torch.matmul/bmm
    bins_times, bins_bounds = {}, {}
    for tb in TIMED_BINS:
        ft, rngt = bins_flow("nsf6", 10, tb)
        ct, crngt = bins_flow("nsfc6", 10, tb)
        bt = bins_times[tb] = {}

        def timed(key, fn, reps):
            # three eager calls of a plain version (the twins take 0.3-0.5 s)
            eager = 3 if key.endswith("_plain") else reps
            bt[f"{key}_ms"], bt[f"{key}_call_ms"] = timed_ms(fn, reps, eager)

        with torch.no_grad():
            fp = ft.params()
            orders_cpu = fp.inv_orders.cpu()
            y1k, g_z1k, g_l1k = grad_problem(ft, 10, 1024, rngt)
            y256 = torch.from_numpy(rngt.standard_normal((256, 10)).astype(np.float32)).cuda()
            acts = fk.made_rqs_forward(y1k, fp.ws, fp.bs, save_inputs=True, bins=tb)[2]
            deltas = [torch.randn(w.shape[0], 1024, w.shape[2], device="cuda") for w in fp.ws]
            for key, fn, reps in (
                    ("made_rqs_forward", lambda: fk.made_rqs_forward(y1k, fp.ws, fp.bs, bins=tb),
                     20),
                    ("made_rqs_forward_plain",
                     lambda: fk.made_rqs_forward_ref(y1k, fp.ws, fp.bs, bins=tb), 10),
                    ("made_rqs_forward_matmul", lambda: matmul_products(ft, y1k), 20),
                    ("made_rqs_backward", lambda: fk.made_rqs_backward(
                        y1k, fp.ws, fp.bs, g_z1k, g_l1k, acts, bins=tb), 20),
                    ("made_rqs_backward_plain", lambda: fk.made_rqs_backward_ref(
                        y1k, fp.ws, fp.bs, g_z1k, g_l1k, acts, bins=tb), 10),
                    ("made_rqs_backward_matmul", lambda: backward_matmul_products(
                        ft, y1k, acts, deltas), 20),
                    ("ar_inverse", lambda: fk.ar_inverse(y256, fp.ws, fp.bs, fp.inv_orders,
                                                         bins=tb), 20),
                    ("ar_inverse_plain", lambda: fk.ar_inverse_ref(y256, fp.ws, fp.bs,
                                                                   orders_cpu, bins=tb), 10)):
                timed(key, fn, reps)
            cp = ct.params()
            a = (cp.ws, cp.bs, cp.masks)
            yc1k = torch.from_numpy(crngt.standard_normal((1024, 10)).astype(np.float32)).cuda()
            yc256 = yc1k[:256].contiguous()
            g_zc = torch.from_numpy(crngt.standard_normal((1024, 10)).astype(np.float32)).cuda()
            g_lc = torch.from_numpy(crngt.standard_normal(1024).astype(np.float32)).cuda()
            cacts = ck.coupling_forward(yc1k, *a, save_inputs=True, bins=tb)[2]
            cdeltas = [torch.randn(ct.n_transforms, 1024, k, device="cuda")
                       for k in (ct.n_hidden,) * 3 + (5 * ct.n_params,)]
            for key, fn, reps in (
                    ("coupling_forward", lambda: ck.coupling_forward(yc1k, *a, bins=tb), 20),
                    ("coupling_forward_plain",
                     lambda: ck.coupling_forward_ref(yc1k, *a, bins=tb), 10),
                    ("coupling_forward_matmul", lambda: matmul_products(ct, yc1k), 20),
                    ("coupling_inverse", lambda: ck.coupling_inverse(yc256, *a, bins=tb), 20),
                    ("coupling_inverse_plain",
                     lambda: ck.coupling_inverse_ref(yc256, *a, bins=tb), 10),
                    ("coupling_inverse_matmul", lambda: matmul_products(ct, yc256), 20),
                    ("coupling_backward", lambda: ck.coupling_backward(
                        yc1k, *a, g_zc, g_lc, cacts, bins=tb), 20),
                    ("coupling_backward_plain", lambda: ck.coupling_backward_ref(
                        yc1k, *a, g_zc, g_lc, cacts, bins=tb), 10),
                    ("coupling_backward_matmul", lambda: backward_matmul_products(
                        ct, yc1k, cacts, cdeltas), 20)):
                timed(key, fn, reps)
            for flow, gname in ((ft, "ar_inverse_backward"), (ct, "coupling_inverse_backward")):
                _, _, bwd, twin, saving, point = inverse_routes(flow)
                gp = _detached(flow.params())
                gp_host = (gp if flow.kind == "nsfc"
                           else gp._replace(inv_orders=gp.inv_orders.cpu()))
                z = y256 if flow.kind == "nsf" else yc256
                g_x, g_l = g_zc[:256].contiguous(), g_lc[:256].contiguous()
                x, _, data = saving(z, None, gp)
                plain_at = point(z, x, gp)
                timed(gname, lambda: bwd(data, gp, g_x, g_l), 20)
                timed(f"{gname}_plain", lambda: twin(plain_at, gp_host, g_x, g_l), 10)
                timed(f"{gname}_save", lambda: saving(z, None, gp), 20)
                if flow.kind == "nsfc":
                    sdeltas = [torch.randn(ct.n_transforms, 256, k, device="cuda")
                               for k in (ct.n_hidden,) * 3 + (5 * ct.n_params,)]
                    timed(f"{gname}_matmul", lambda: backward_matmul_products(
                        ct, x, data[:4], sdeltas, weight_grads=False), 20)
        bins_bounds[tb] = {**made_bounds(1024, ft),
                           "ar_inverse": made_bounds(256, ft)["ar_inverse"],
                           **coupling_bounds(1024, ct),
                           "coupling_inverse": coupling_bounds(256, ct)["coupling_inverse"],
                           "ar_inverse_backward": gradient_bounds(256, ft),
                           "coupling_inverse_backward": gradient_bounds(256, ct)}
    # the plain version's compensated sums inside a CUDA graph (the device
    # route of transforms._running_sums, which (c)'s device times of the
    # plain versions past 16 bins take) against the host route, bit for bit
    # (the inverse's at 32 bins: at 1000 its graph holds ~300k kernels)
    graph_bits = {}
    for tb in (32, 1000):
        ft, rngt = bins_flow("nsf6", 10, tb)
        fp = ft.params()
        y256 = torch.from_numpy(rngt.standard_normal((256, 10)).astype(np.float32)).cuda()
        graph_bits[f"made_rqs_forward_plain_b{tb}"] = graph_route_equal(
            lambda: fk.made_rqs_forward_ref(y256, fp.ws, fp.bs, bins=tb))
        if tb == 32:  # the visit orders on the host, as (c)'s times take them
            orders_cpu = fp.inv_orders.cpu()
            graph_bits[f"ar_inverse_plain_b{tb}"] = graph_route_equal(
                lambda: fk.ar_inverse_ref(y256, fp.ws, fp.bs, orders_cpu, bins=tb))
    if not all(graph_bits.values()):
        fail(f"spline_bins: the plain version in a CUDA graph differs from its host route: "
             f"{graph_bits}")
    lap("14 (c)")
    emit("spline_bins", card=card, bins=CHECKED_BINS, checks=bins_checks, menu_checks=bins_menu,
         gradient_checks=bins_grad, check_s=check_s,
         times={str(tb): dict(bins=tb, **bins_times[tb]) for tb in TIMED_BINS},
         bounds={str(tb): {k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in b.items()}
                 for tb, b in bins_bounds.items()},
         graph_route_bit_for_bit=graph_bits, **side["spline_bins"],
         wall_s=time.perf_counter() - t14)

    # -- 15. mesh: the particles over torch.distributed ranks ----------------
    # (a) one rank over NCCL: phase 11 (a) ran phase 6's quickstart on that
    # mesh (with a scipy prior and save_every, which keep phase 6's bits)
    # and held it to phase 6's logZ and calls
    one = dict(surface["runs"]["scipy_prior_save_every"], phase_6_wall_s=main_wall)
    if one["mesh_backend"] != "nccl":
        fail(f"mesh (a): the one-rank mesh ran over {one['mesh_backend']}, not NCCL")
    # (b) two ranks sharing the card (gloo): the JAX harness's cases, then
    # the quickstart with each rank's half of the particles (run beside
    # phase 14 (b))
    ranks = [smoke.line_stats(ln) for ln in lines]
    for r, st in enumerate(ranks):
        q = st["quickstart"]
        by_path[f"mesh_rank{r}"] = {k: q["launches"][k] for k in RQS}
        if not abs(q["logz"] - TRUE_LOGZ) < LOGZ_GATE:
            fail(f"mesh (b) rank {r}: logZ {q['logz']} outside {TRUE_LOGZ} +- {LOGZ_GATE}")
        if q["sweep_k1_rows_max"] > 128 or st["host_sweep_rows_max"] > 16:
            fail(f"mesh (b) rank {r}: a sweep saw more than its rows (K1 "
                 f"{q['sweep_k1_rows_max']} of 256, the black-box likelihood "
                 f"{st['host_sweep_rows_max']} of 32)")
    lap("15 (b)")
    emit("mesh", card=card, one_rank=one, two_ranks=ranks,
         checksums=[ln.rsplit("checksum=", 1)[1] for ln in lines], wall_s=mesh_s,
         beside="14 (b)")

    # -- 16. custom flows and the live sweep stats (the second process) ----
    emit("custom_flow", card=card, phase6=dict(main, wall_s=main_wall), **side["custom_flow"])

    # -- 17. the JAX package's statistical gates (the second process) ------
    emit("statistical", card=card, runs=side["statistical"], wall_s=side["statistical_wall_s"])
    emit("second_process", card=card,
         side_parts_s={k: round(v, 3) for k, v in side["parts"].items()},
         sum_s=round(sum(side["parts"].values()), 3))

    paths = {"flow_menu_maf6": AFFINE, "flow_menu_nsfc6": COUPLING,
             "flow_menu_bench_sweep": COUPLING[:2],
             "gradient_head_maf6": GRADIENT[1:2], "gradient_head_nsfc6": GRADIENT[2:]}
    paths.update({k: RQS + GRADIENT[:1] for k in by_path if k.startswith(("gradient_quickstart",
                                                                            "test_mala"))})
    paths.update({k: ("ar_inverse",) + GRADIENT[:1] for k in by_path
                  if k.startswith("gradient_sweep")})
    paths["spline_bins_quickstart"] = tuple(with_bins(k, QUICK_BINS) for k in RQS)
    for tb in TIMED_BINS:
        paths.update({f"spline_bins_head_nsf6_b{tb}": (with_bins(GRADIENT[0], tb),),
                      f"spline_bins_head_nsfc6_b{tb}": (with_bins(GRADIENT[2], tb),)})
    for name, counts in by_path.items():
        want = paths.get(name, RQS)
        if set(counts) != set(want) or not all(counts.values()):
            fail(f"a kernel of the {name} path was never launched: {counts}")

    # -- kernels line and contract line ------------------------------------
    # each kernel at the main path's shape: K2 forward and backward at the
    # training batch (d=10, n=1024), K1 at the sweep population (n=256);
    # K1 also at the quickstart bridge's rows (bridge_n=1024); the heads of
    # maf6 and nsfc6 at the same shapes on their quickstart (phase 12);
    # K5 also at the bench line's sweep (d=50, n=65,536)
    at = {"made_rqs_forward": (1024, "k2"), "made_rqs_backward": (1024, "k2_bwd"),
          "ar_inverse": (256, "k1")}
    sources = {"made_rqs_forward": ("pocomc_tpu_torch/csrc/made_rqs_forward.cu",
                                    "pocomc_tpu/ops/pallas_kernels.py:34"),
               "made_rqs_backward": ("pocomc_tpu_torch/csrc/made_rqs_backward.cu",
                                     "pocomc_tpu/ops/pallas_kernels.py:89"),
               "ar_inverse": ("pocomc_tpu_torch/csrc/ar_inverse.cu", "RESULTS.md:76"),
               "coupling_forward": ("pocomc_tpu_torch/csrc/coupling_forward.cu",
                                    "pocomc_tpu/models/coupling.py:71"),
               "coupling_inverse": ("pocomc_tpu_torch/csrc/coupling_forward.cu",
                                    "pocomc_tpu/models/coupling.py:83"),
               "coupling_backward": ("pocomc_tpu_torch/csrc/coupling_backward.cu",
                                     "pocomc_tpu/models/coupling.py:71")}
    for name in RQS:
        sources[f"{name}_affine"] = sources[name]
    flow10 = flows["nsf6", 10][0]
    line = []

    def launches_of(name):
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        return sum(counts.values()), counts

    for name in RQS:
        n, key = at[name]
        row = next(r for r in times if r["d"] == 10 and r["n"] == n)
        bound_ms, bound_by = made_bounds(n, flow10)[name]
        total, path_counts = launches_of(name)
        line.append({"name": name, "route": "cuda", "source": sources[name][0],
                     "replaces": sources[name][1], "launches": total,
                     "launches_by_path": path_counts, "max_abs_err": errs[name],
                     "ms": row[f"{key}_ms"], "plain_ms": row[f"{key}_plain_ms"],
                     "call_ms": row[f"{key}_call_ms"],
                     "plain_call_ms": row[f"{key}_plain_call_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        if name == "made_rqs_backward":
            # its products as torch.matmul, and the shapes at d=50: the
            # training batch and the evidence draws' row count
            flow50 = flows["nsf6", 50][0]
            line[-1].update(backward_products_matmul_ms=row["k2_bwd_matmul_ms"], d50=[dict(
                n=r["n"], ms=r["k2_bwd_ms"], call_ms=r["k2_bwd_call_ms"],
                plain_ms=r["k2_bwd_plain_ms"],
                bound_ms=made_bounds(r["n"], flow50)[name][0],
                backward_products_matmul_ms=r["k2_bwd_matmul_ms"])
                for r in times if r["d"] == 50 and r["n"] in (1024, 4096)])
        if name == "ar_inverse":
            bridge_row = next(r for r in times if r["d"] == 10 and r["n"] == 1024)
            line[-1].update(chain_ms=chain["k1_chain_ms_d10"],
                            launches_in_bridge=k1_in_bridge,
                            bridge_ms=bridge_row["k1_ms"],
                            bridge_plain_ms=bridge_row["k1_plain_ms"],
                            bridge_bound_ms=made_bounds(1024, flow10)[name][0])
    menu_at = {"made_rqs_forward_affine": ("maf6", 1024),
               "made_rqs_backward_affine": ("maf6", 1024), "ar_inverse_affine": ("maf6", 256),
               "coupling_forward": ("nsfc6", 1024),
               "coupling_backward": ("nsfc6", 1024), "coupling_inverse": ("nsfc6", 256)}
    for name in AFFINE + COUPLING:
        flow_name, n = menu_at[name]
        row = next(r for r in menu_times if r["flow"] == flow_name and r["d"] == 10
                   and r["n"] == n)
        total, path_counts = launches_of(name)
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": total,
                 "launches_by_path": path_counts, "max_abs_err": errs[name],
                 "ms": row[f"{name}_ms"], "plain_ms": row[f"{name}_plain_ms"],
                 "call_ms": row[f"{name}_call_ms"], "plain_call_ms": row[f"{name}_plain_call_ms"],
                 "bound_ms": row[f"{name}_bound_ms"], "bound_by": row[f"{name}_bound_by"],
                 "library_ms": None, "flow": flow_name, "d": 10, "n": n}
        if name == "made_rqs_backward_affine":
            entry["backward_products_matmul_ms"] = row[f"{name}_matmul_ms"]
            entry["d50"] = [dict(n=r["n"], ms=r[f"{name}_ms"], plain_ms=r[f"{name}_plain_ms"],
                                 bound_ms=r[f"{name}_bound_ms"],
                                 backward_products_matmul_ms=r[f"{name}_matmul_ms"])
                            for r in menu_times if r["flow"] == "maf6" and r["d"] == 50]
        if name.startswith("coupling"):
            if name != "coupling_backward":
                entry["products_matmul_ms"] = row["coupling_matmul_ms"]
                big = next(r for r in menu_times if r["d"] == 50 and r["n"] == 65536)
                entry["bench_line"] = dict(
                    d=50, n=65536, ms=big[f"{name}_ms"], plain_ms=big[f"{name}_plain_ms"],
                    bound_ms=big[f"{name}_bound_ms"], bound_by=big[f"{name}_bound_by"],
                    products_matmul_ms=big["coupling_matmul_ms"])
            else:
                # the backward at d=50: the training batch and the evidence
                # draws' row count
                entry["backward_products_matmul_ms"] = row["coupling_backward_matmul_ms"]
                entry["bench_line"] = [dict(
                    d=50, n=r["n"], ms=r[f"{name}_ms"], call_ms=r[f"{name}_call_ms"],
                    plain_ms=r[f"{name}_plain_ms"], bound_ms=r[f"{name}_bound_ms"],
                    bound_by=r[f"{name}_bound_by"],
                    backward_products_matmul_ms=r["coupling_backward_matmul_ms"])
                    for r in menu_times if r["flow"] == "nsfc12" and r["n"] in (1024, 4096)]
        line.append(entry)
    # the gradient kernels at the sweep's population (d=10, n=256) of their
    # flows, beside the inverse's save instance each reads and the inverse
    # without the save: K1's for K1-bwd, K5's for K5-inv-bwd
    grad_sources = {
        "ar_inverse_backward": ("pocomc_tpu_torch/csrc/ar_inverse_backward.cu",
                                "pocomc_tpu/mcmc.py:350"),
        "ar_inverse_backward_affine": ("pocomc_tpu_torch/csrc/ar_inverse_backward.cu",
                                       "pocomc_tpu/mcmc.py:350"),
        "coupling_inverse_backward": ("pocomc_tpu_torch/csrc/coupling_backward.cu",
                                      "pocomc_tpu/models/coupling.py:83")}
    for name in GRADIENT:
        row = next(r for r in grad_times if r["kernel"] == name and r["d"] == 10
                   and r["n"] == 256)
        total, path_counts = launches_of(name)
        entry = {"name": name, "route": "cuda", "source": grad_sources[name][0],
                 "replaces": grad_sources[name][1], "launches": total,
                 "launches_by_path": path_counts, "max_abs_err": errs[name],
                 "ms": row[f"{name}_ms"], "plain_ms": row[f"{name}_plain_ms"],
                 "call_ms": row[f"{name}_call_ms"], "plain_call_ms": row[f"{name}_plain_call_ms"],
                 "bound_ms": row[f"{name}_bound_ms"], "bound_by": row[f"{name}_bound_by"],
                 "library_ms": None, "flow": row["flow"], "d": 10, "n": 256}
        if name == "coupling_inverse_backward":
            entry.update(k5_inv_save_ms=row["k5_inv_save_ms"], k5_inv_ms=row["k5_inv_ms"],
                         products_matmul_ms=row[f"{name}_matmul_ms"],
                         d50=[dict(n=r["n"], ms=r[f"{name}_ms"], plain_ms=r[f"{name}_plain_ms"],
                                   bound_ms=r[f"{name}_bound_ms"],
                                   k5_inv_save_ms=r["k5_inv_save_ms"],
                                   k5_inv_ms=r["k5_inv_ms"],
                                   products_matmul_ms=r[f"{name}_matmul_ms"])
                              for r in grad_times if r["kernel"] == name and r["d"] == 50])
        else:
            entry.update(k1_save_ms=row["k1_save_ms"], k1_ms=row["k1_ms"],
                         k1_state_bytes=row["k1_state_bytes"])
        line.append(entry)
    # the spline kernels at each TIMED_BINS (phase 14: 16, the most of a
    # compiled library, and 32, of the library of run-time bins), at the
    # shapes above on its nsf6 and nsfc6 flows of d=10, each with ptxas's
    # count of its library's instances, their most registers and their
    # spills; and on every spline kernel's entry the largest |diff| at each
    # bins checked
    at_bins = {"made_rqs_forward": ("made_rqs_forward", "nsf6", 1024),
            "made_rqs_backward": ("made_rqs_backward", "nsf6", 1024),
            "ar_inverse": ("ar_inverse", "nsf6", 256),
            "coupling_forward": ("coupling_forward", "nsfc6", 1024),
            "coupling_inverse": ("coupling_forward", "nsfc6", 256),
            "coupling_backward": ("coupling_backward", "nsfc6", 1024),
            "ar_inverse_backward": ("ar_inverse_backward", "nsf6", 256),
            "coupling_inverse_backward": ("coupling_backward", "nsfc6", 256)}
    every_source = {**sources, **grad_sources}
    for tb, (base, (lib, flow_name, n)) in itertools.product(TIMED_BINS, at_bins.items()):
        name, bt, (bound_ms, bound_by) = with_bins(base, tb), bins_times[tb], bins_bounds[tb][base]
        total, path_counts = launches_of(name)
        entry = {"name": name, "route": "cuda", "source": every_source[base][0],
                 "replaces": every_source[base][1], "launches": total,
                 "launches_by_path": path_counts, "max_abs_err": bins_errs.get(name, 0.0),
                 "ms": bt[f"{base}_ms"], "plain_ms": bt[f"{base}_plain_ms"],
                 "call_ms": bt[f"{base}_call_ms"], "plain_call_ms": bt[f"{base}_plain_call_ms"],
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                 "flow": flow_name, "d": 10, "n": n, "bins": tb,
                 "ptxas": build[with_bins(lib, fk.lib_bins(tb))]["resources"]}
        for extra in ("matmul", "save"):
            if f"{base}_{extra}_ms" in bt:
                entry[f"{extra}_ms"] = bt[f"{base}_{extra}_ms"]
        line.append(entry)
    for entry in line:
        if entry["name"] in at_bins:
            entry["bins_instances"] = {
                str(b): bins_errs[with_bins(entry["name"], b)] for b in CHECKED_BINS
                if with_bins(entry["name"], b) in bins_errs}
    lap("kernels line")
    emit("parts", cpu_count=os.cpu_count(), all_parts_s={k: round(v, 3) for k, v in PARTS.items()},
         sum_s=round(sum(PARTS.values()), 3))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--side"]:
            side_main(json.loads(sys.argv[2]))
        else:
            main()
    finally:
        stop_children()
