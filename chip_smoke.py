#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpinn_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: require CUDA, print the card (nvidia-smi name and power
   limit), turn TF32 off everywhere.
2. Build: compile kernels B1, B2 and B3 (tpinn_torch/kernels/csrc/
   taylor2_fwd.cu, taylor2_bwd.cu, adam.cu) with nvcc for sm_90a, one
   nvcc process each, all started together; print the build times and
   the ptxas register/spill report.
3. Kernel vs plain:
   a. B1 against its plain PyTorch version and against the generic
      torch.func.jvp engine, per stream, on the 6x80 annulus net (N =
      262,144, a ragged 1,077 and the 202,500 points of the recipe's
      L-BFGS grid), a sin-first net with pad_to=3, a 3-coordinate net, and
      the poisson_3d recipe's 5x64 net with its S = 7 plan at its batch
      (7,200) and its L-BFGS grid (24^3 = 13,824), and the marching
      windows' 4x64 tanh nets (convection_1d: S = 3, wave_1d: S = 5), in
      the first and the last window's slab, at the batch a step (5,632 and
      7,168 points) and at the density grid (101^2, 111^2), and the
      inverse path's 4x32 tanh net on 3 padded features (heat_2d's
      "u_t - lam*u_xx", S = 4, at its batch of 2,800 points, its density
      grid of 111^2 and the served tier of 1,024; poisson_1d's "u_xx +
      lam*u", S = 3, at 2,700 and 111); then, in the other W modes of its
      plan, heat_2d's 6x96 at its batch (28,000) and a 6x128
      at 16,384 ("layer"), a 3x256 at 4,096 ("layer", W in chunks) and a
      3x700 net with 3 coordinates, S = 10, at 2,048 ("l1").  Each case
      prints B1's plan (points per tile, blocks, threads, W mode, rows of
      W staged, row stride, shared memory), whose shared memory must equal
      the kernel's own count, and must launch B1 once; every W mode must
      have run.
   b. B2 through the autograd Function (B1 forward, B2 backward) against
      B2's plain version on the same cotangent and against autograd
      through the plain Taylor-2 recurrence, per leaf, on the 6x80
      annulus net at the recipe's batch (46,000), a ragged 1,077 and the
      recipe's L-BFGS grid (450^2 = 202,500), the pad_to=3 net, the
      3-coordinate net, the poisson_3d net at its two sizes and the
      marching windows' and the inverse cases' nets at their batch; the
      same
      under the hard-BC product rule at those sizes, the 3-D product rule
      of poisson_3d included; points that require a gradient must be
      refused.  Each case prints B2's plan (points per tile, blocks, rows
      of W staged at once, accumulation mode, shared memory, scratch),
      whose shared memory must equal the kernel's own count; a 6x128 net
      at 16,384 points and heat_2d's 6x96 net at 28,000, whose gradients
      do not fit in shared memory beside the whole of a layer's W, and a
      3x256 net at 4,096 points, too wide for the whole W, are held too,
      so that both accumulation modes ("smem", "global") and W staged in
      chunks run.
   c. B3 against its plain version over 1,000 steps, with a learning-rate
      change half-way, on n = 32,801 (the 6x80 net on 3 features), an odd
      n, 140,001 (past one grid: the threads loop), 12,801 (the
      marching windows' 4x64 net on 3 features) and the system path's
      vectors (17,091: kovasznay's and taylor_green's 5x64 nets with 3
      outputs; 37,826: schrodinger's 5x96 with 2; 1 and the other leaves
      of phase 5f's inverse case under the tree layout), the inverse
      path's (3,330: the 4x32 net and lam raveled; 96, 1,024, 32 and 1:
      its leaves under the tree layout) and the patch path's stacked
      vectors (468,036: 36 nets of 6x50 on 3 features; 2,824: the tests'
      8 nets of 2x16), each on aligned
      vectors and on views one float off 16-byte alignment: through the
      Adam phase's launcher (FusedAdam, the step and the bias corrections
      read on the device) and through adam_update_flat, which must agree
      bitwise; then phase 5j's resumed launcher (resume_adam_cases: the
      32,801-float vector from step 101, as a resumed Adam phase builds
      it) over its 120 steps from moments that are not zero, against the
      plain version from the same step; then 10 launcher steps captured in
      one CUDA graph (the
      capture counts no launch), replayed 3 times (lr halved between the
      first and the second replay), against 30 plain steps, with the
      device step at 31; a fourth replay, past the launcher's table, must
      update nothing and make the device step raise.
4. Serve (the first slice's path): two annulus checkpoints written from
   a seeded initialisation in the format run_training writes — the 6x80
   hard-BC net and a 2-stage hard-BC chain — each served by PINNServer on
   the card behind ThreadingHTTPServer; /health, /predict and /residual
   at 1, 1,000 and 65,536 points, checked against the direct predictor,
   the plain-version residual and the exact hard-BC boundary values.  B1's
   launch count is reset before this phase and must grow with every
   /residual request.
5. Train (the second slice's path): first, at step 0, the kernel-engine
   gradient of the full loss against the generic engine's.  Then
   run_training on the hard-BC annulus at the recipe's batch: stage 1
   6x80 tanh, stage 2 6x50 sin composed, about 300 Adam steps each
   through B1 + B2 + B3, then L-BFGS; launch counts reset before and read
   after (here and in 5b-5d B3 once per Adam step, every launch through
   the phase's launcher), loss drops, rel-L2, the 11 artifacts and the
   checkpoints checked; the stage-2 checkpoint is served and /predict
   checked against the trainer's predictor.
5b. Recipe (the flagship recipe's path): get_recipe("annulus_laplace") as
   written — 6x80, the 46,000-point batch, lbfgs_grid=450,
   lbfgs_rounds=3, lsq_polish="auto", deflation="full",
   adam_precision="default" — with only the budgets cut, through
   run_training on the card: Adam through B1 + B2 + B3 (launch counts
   reset before, read after), three L-BFGS rounds on the 202,500-point
   grid each followed by the exact float64 last-layer solve (objective
   post <= pre, applied), the float64 evaluation, the Galerkin defect
   correction (kind, residual drop, modes, rel-L2 before and after), the
   checkpoint whose meta carries it, and the served /predict of that
   checkpoint against the trainer's corrected predictor and against the
   same checkpoint served without its correction; its served /residual
   against the residual of the trainer's corrected predictor, with the
   engine that answered it (B1's launch count over the request).
5c. poisson_3d (the 3-D training path, the newest main path):
   get_recipe("poisson_3d") as written — 5x64 hard BC, the 7,200-point batch from the n-D sampler on
   a 31^3 density grid, lbfgs_grid=24 (13,824 points), 2 rounds,
   lsq_polish="auto", testing_size=(48, 48, 48) — with only the budgets
   and the cadences that scale with them cut, through run_training on the
   card: the step-0 gradient of the kernel engine against the generic
   engine's at the recipe's batch first; then Adam through B1 + B2 + B3 at
   d = 3, S = 7 (launch counts reset before, read after; B3 equals the
   Adam steps), the 3-D density refreshed on the card, two L-BFGS rounds
   each followed by the last-layer solve at d = 3 (post <= pre), rel-L2
   on the 48^3 grid under a stated bar, and the checkpoint served:
   /predict and /residual at 3-coordinate points against the trainer's
   predictor and residual, B1's count growing over /residual.
5d. The other recipes' paths, each at a cut budget: helmholtz_2d
   (two Fourier stages, the second warm-started; the generic engine by
   structure: B1 and B2 launch 0 times, B3 every Adam step), burgers_1d
   (two composed stages, nonlinear: the last-layer solve skipped, the
   Galerkin correction's Newton step or its guard), lshape_laplace (the
   masked domain; with lsq_polish and deflation asked for, both skipped
   with a log line), kdv_1d (order 3: the generic engine, B1 and B2 0
   times).
5e. Marching (the time-marching slice's path): the three marching
   recipes through run_time_marching at their full width and batch (4x64
   tanh, 4,096 + 1,024 points and 512 per BC group a step), each window's
   budgets cut (MARCH_CUTS: convection_1d 8 windows of 300 Adam steps /
   lbfgs_epochs 150 against 20,000 / 6,000; wave_1d 4 of 300 / 150
   against 20,000 / 6,000; allen_cahn 8 of 100 / 60 against 12,000 /
   4,000; tail_max 20, density_every 100, plateau_every 200): launch
   counts reset before each recipe and read after (B1 and B2 in
   convection_1d and wave_1d, B1 and B2 no time in allen_cahn, whose
   periodic_fit features take the generic engine; B3 once per Adam step
   of every window, through the launchers); the shape of every B1 and B2
   launch (widths, streams, N) among those phases 3a and 3b hold, and
   every B3 vector's size among phase 3c's; every earlier window's
   parameters bitwise as its training left them, with no gradient; the
   composite equal to window k inside slab k; every handoff target (and
   wave_1d's velocity) equal to the previous window on its plane; the
   composite rel-L2 finite and printed beside tpinn's TPU record; the
   march.json record served on the card, /predict within 1e-6 of the
   in-process composite, /residual's route and B1 count; convection_1d's
   first two windows trained again with the same loss histories, bit for
   bit.
5f. Coupled systems (the system slice's path): the three system recipes
   (SYSTEM_RECIPES, built into a TrainSpec as tpinn's `system --recipe`
   does) through run_system at their full width and batch, the budgets
   cut (SYSTEM_CUTS: kovasznay, the main path, 300 / 150 against 12,000 /
   8,000 at 5x64 and 13,600 points a step; taylor_green 100 / 60 against
   10,000 / 8,000, 3 coordinates with the testing_size fallback;
   schrodinger 100 / 60 against 20,000 / 8,000, periodic_fit and the
   numpy oracle; tail_max 20 and the cadences as in 5e): launch counts
   reset before each and read after (B3 once per Adam step, tail
   included, through the launcher; B1 and B2 no time: the nets have 2 or
   3 outputs and take the generic engine); every B3 vector of a size
   phase 3c holds; rel-L2 aggregate and per field finite and printed
   beside tpinn's TPU record; params_stage_1.npz and system.json written;
   the checkpoint served on the card by PINNServer with no preset,
   /predict within rtol 1e-5, atol 1e-6 of the trainer's predictor at
   1,000 points, /residual one finite column per equation (B1 +0);
   kovasznay's first 50 Adam steps run twice, one loss-history digest
   equal to the main run's first rows; the tests' inverse oscillator
   (u_x - v, v_x + w2*u) under adam_layout="tree", its 1-element
   coefficient vector through B3 on the card, w2 recovered within 1e-2
   and printed.
5g. Scalar inverse (the inverse slice's path): first, at the heat case's
   batch, the gradient of the inverse loss through B1/B2 against the same
   loss through the generic engine, every net leaf and lam (the
   tolerances of phase 5's step 0).  Then `tpinn invert`'s heat-
   diffusivity identification (heat_2d with "u_t - lam*u_xx" from lam =
   0.3), built as tpinn's CLI builds it (invert_spec: 4x32 tanh, 2,000 +
   500 points and 100 per BC group a step, 200 observations, seed 1234),
   through run_inverse on the card with the budgets cut (INVERSE_CASES:
   300 / 150 against the CLI's 4,000 / 3,000; tail_max 20, density_every
   100, plateau_every 200): launch counts reset before and read after (B1
   and B2 at least once per Adam step, B3 once, through the launcher, on
   the 3,330-float vector of the net and lam), the loss drops, |lam - 1|
   below |0.3 - 1|, the checkpoint, inverse.json and the UI artifacts
   written; the checkpoint served on the card with no preset: /health's
   coef equal to inverse.json's, /predict within 1e-6 of the trainer's at
   1,000 points, /residual through B1 (its count grows) against the
   trainer's residual at the recovered lam through the generic engine.
   The same under adam_layout="tree" (B3 once per step on each of 11
   vectors, lam's of 1 among them).  The eigenvalue mode: poisson_1d with
   "u_xx + lam*u" from lam = 8, normalize 0.5, at 1,000 / 600 (B1, B2,
   B3; lam moves toward pi^2; mean u^2 on the pin points printed beside
   0.5).  Every B1 and B2 launch of the phase at a shape phases 3a and 3b
   hold, every B3 vector at a size 3c holds; the heat case's first 50
   Adam steps run twice, one loss-history digest equal to the main run's
   first rows.
5h. Ensembles, patches and the reference-semantics mode (the ensemble
   and patch slice's paths).  a: get_recipe("annulus_laplace") with two
   members through run_ensemble_training on the card at phase 5b's cut
   (300 / 900, tail_max 50): launch counts read around each member (B1
   and B2 at least once per Adam step, at shapes phase 3b holds; B3 once,
   through the launcher, on the 32,801-float vector); the convex weights
   sum to 1 within 1e-12 (their kind printed); no member checkpoint
   carries a deflation; rel-L2 <= 1.5 x the best member's (tpinn's bar);
   the error correlation and every rel-L2 printed; ensemble.json served on
   the card: /predict within 1e-6 of EnsembleResult.predict, /uncertainty
   of shape [n] and >= 0, /residual against the corrected mean's
   residual_fast (rtol 1e-3, atol 1e-4) with its engine.  b: patched
   helmholtz_2d as `tpinn train --patches 6x6` builds it (36 nets of 6x50
   on 3 padded features, 4,900 points a step, seed 1234), budgets cut from
   8,000 / 3,000 to 300 / 150, cadences as in 5e, through run_patched:
   B1 = B2 = 0 (the generic engine), B3 once per Adam step on the
   468,036-float stacked vector; the loss drops; rel-L2 finite and
   printed; params_stage_1.npz and patched.json written and served
   (/predict within 1e-6); the first 50 Adam steps run twice, one digest
   equal to the main run's first rows.  c: at bench.py's shape (soft-BC
   annulus, 6x60 float64, 5,200 points) reference_residual_polar against
   the forward engine's residual_fast (rtol 1e-8, atol 1e-10) and 30
   reference Adam steps lower the loss.
5i. The online calculator (the calculator slice's path): the port's lite
   web app (tpinn_torch.app.lite) in a thread, its SessionManager on the
   card; tpinn's __main__ demo request (polar Laplace on the annulus,
   6x60 tanh, 3,000 + 1,000 + 1,000 points, a 111x111 test grid, then the
   6x50 sin correction stage) at its full width and batch, its budgets
   cut (CALC_CUT: 200 / 100 a first stage against 1,000 / 1,000), POSTed
   to /api/start and /api/status polled to done: launch counts reset
   before and read after (B1 and B2 at least once per Adam step, B3 once,
   through the launchers), the 11 artifacts and 2 checkpoints, every
   /api/figure tab of its type with finite data, rel-L2 of the stage-2
   field against u = log(r)/log(0.1) equal to the logged one.  Then two
   sessions started together, adam_precision "default" and "highest":
   both running at first, one logs that it waits for the device, each
   Adam phase runs under its own TF32 setting, the two sessions' phases
   do not interleave, and allow_tf32 ends as it began.  Then `python -m
   tpinn_torch train --problem poisson_1d --device cuda` at a cut budget
   in its own process, its JSON line parsed.
5j. Mid-stage resume, lbfgs_device and profiling (the resume slice's
   path): a. the flagship recipe (6x80 hard BC, 46,000 points a step) at
   RESUME_ADAM / RESUME_LBFGS with its cadences cut (draws every 30 steps,
   density refreshes every 40, plateau checks every 60, a tail of 20), the
   last-layer solves and the correction off, and checkpoint_every=50,
   through run_training on the card: run A
   uninterrupted; run B killed by an exception raised right after the
   phase file of step 100 is written (utils.checkpoint.save_phase_state
   wrapped), then run again with resume=True: the resume log line, the two
   runs' loss-history and final-params digests equal bit for bit, B1 and
   B2 at least once per resumed step and B3 once, through one launcher
   built at step 101 whose device step ends at the Adam steps + 1 (launch
   counts reset before and read after the resumed run); every B1/B2 launch
   of both runs at a shape phases 3a and 3b hold (resume_kernel_cases),
   the B3 launcher at a (size, start) 3c holds.  b. One L-BFGS round (one
   iterate) on a density draw from run A's Adam result (its phase file,
   run_training(resume=True), tail 0), with lbfgs_device="cpu" and on the
   card, each one call timed by profiling.timed: row
   0 of the two within 1e-5 relative, each final loss at most its row 0,
   the params returned on the card.  c. profiling.trace of 10 flagship
   Adam steps (kernel engine): device operations a step and the
   device-busy share from the trace's kernel, copy and set events; the
   StepTimer median (CUDA events) over 20 steps beside the host-clock
   median.  Outputs in build/smoke/resume/.
6. Timing (medians of synchronised runs): B1 inside the residual at the
   serving shapes; B1 alone against its plain version at the served
   262,144 points, the recipe's batch and L-BFGS grid (46,000, 202,500)
   and poisson_3d's (7,200, 13,824), around the call, on the device
   behind a long kernel and in host time a call, and each net whose
   weights B1 stages in shared memory against the same plan with them
   read through L1; the Adam step with the kernel engine
   against the plain engine at the recipe's shape, at bench.py's and at
   poisson_3d's; B2 alone against its plain version at the recipe's
   batch and L-BFGS grid (202,500) and at poisson_3d's (7,200, 13,824),
   B3 (the Adam phase's launcher) alone against its plain version and
   against the one PyTorch call that computes the same update
   (torch._fused_adam_, lr a device tensor) in four measures: around the
   call, host time a call, device time a launch in a queue of 100 behind
   a long kernel, and device time a launch replayed from a CUDA graph;
   the kovasznay Adam step at the recipe's width and batch (the generic
   engine; B3 against its plain version) and /residual of phase 5f's
   kovasznay checkpoint at 65,536 points; the heat inverse Adam step at
   the CLI's width and batch, its residual through B1/B2 against the
   generic engine (B3 in both); the patched Adam step at 5h-b's shape (B3
   against its plain version) and, at bench.py's shape, the reference-
   semantics step (float64, reverse over reverse) against the kernel-
   engine step.

Partial runs, for work on kernels B1, B2 and B3 and on one path (not part
of the smoke):

    python3 chip_smoke.py --b1-only            # phases 2, 3a, B1's timing
    python3 chip_smoke.py --b1-compare DIR     # B1 here and in checkout DIR
    python3 chip_smoke.py --b2-only            # phases 2, 3b, B2's timing
    python3 chip_smoke.py --b2-compare DIR     # B2 here and in checkout DIR
    python3 chip_smoke.py --b3-only            # phases 2, 3c, B3's timing
    python3 chip_smoke.py --b3-compare DIR     # B3 here and in checkout DIR
    python3 chip_smoke.py --timing-compare DIR # residual, Adam step: DIR, here
    python3 chip_smoke.py --lbfgs-compare DIR  # phases 5b, 5c in DIR, here
    python3 chip_smoke.py --p3d-repeat DIR N   # 5c's training N times each
    python3 chip_smoke.py --march-only         # phases 2 and 5e
    python3 chip_smoke.py --system-only        # phases 2, 3c, 5f, system timing
    python3 chip_smoke.py --system-recipe NAME # one system recipe as written
    python3 chip_smoke.py --inverse-only       # phases 2, 3a-3c, 5g, its timing
    python3 chip_smoke.py --inverse-recipe     # the heat run as `tpinn invert`
    python3 chip_smoke.py --ensemble-patch-only # phases 2, 3c, 5h, its timing
    python3 chip_smoke.py --patch-recipe       # tpinn's FBPINN case as written
    python3 chip_smoke.py --calculator-only    # phase 5i, kernels built in it
    python3 chip_smoke.py --resume-only        # phase 2, 3c's resumed B3, 5j
    python3 chip_smoke.py --determinism [DIR]  # warned ops of 5c's training

The compares time the kernel at phase 6's shapes in DIR (say a git
archive of the parent commit) and in this tree, one process each, in the
order DIR, here, here, DIR, on one card; B1's and B3's also print this
tree's mean time over DIR's per shape or measure (B1: around the call,
on the device and on the host; B3: those and a graph replay, beside
torch._fused_adam_ in each run) and the largest difference between the
two trees' outputs (B3: after 1,000 steps).  --timing-compare times
phase 6's residual through B1 and Adam step (kernel and plain engines)
in the same order, and prints this tree's mean over DIR's per timing.
--lbfgs-compare runs phases 5b and 5c in DIR and then here, each
printing per run an LBFGS_COUNTS line: Adam steps, L-BFGS iterates and
evaluations per round, kernel launches.
--p3d-repeat runs phase 5c's training N times in DIR and N times here,
two processes per tree at once on one card, and prints each run's rel-L2,
B3 launchers' device steps and loss-history digest, the distinct outcomes
per tree, and where a run's history parts from DIR's first run.
--determinism runs phase 5c's training once (in DIR first, if given)
under torch.use_deterministic_algorithms(True, warn_only=True) with
CUBLAS_WORKSPACE_CONFIG=:4096:8 in that process only, and lists every
operation PyTorch warned about with the line of Python that called it.
--inverse-recipe runs phase 5g's heat identification with the CLI's
budgets (4,000 / 3,000) and TrainSpec's cadences, prints an
INVERSE_RECIPE line (lam, coef_adam, rel-L2, wall time, launches) and
fails unless |lam - 1| < 1e-2 (the bar of tests/test_inverse.py).
--patch-recipe runs tpinn's FBPINN case (u = sin(15πx), 8 patches of
2x16, 15,000 / 4,500) through run_patched, prints a PATCH_RECIPE line
(rel-L2, wall time, launches) and fails unless rel-L2 < 2e-2 (the bar of
tests/test_patch.py).

The line before the last is a JSON object describing the kernels (each
with its launches on the six newest main paths, phase 5e's three
marching recipes, phase 5f's coupled systems, phase 5g's inverse runs,
phase 5h's ensemble members and patched run, phase 5i's demo session
and phase 5j's resumed run together, and on every path by name, its time, its plain version's, the card's bound for the
same work and, where one PyTorch call computes the same function, that
call's time; B1 and B2 with every timed shape and its plan under
"shapes", B1's times around the call, with its device and host times
beside them, and its W modes against "l1" under "w_modes"; B3 with its
and the library's host, device and graph-replay times); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"
SEED = 0
IDX5 = [(), (0,), (1,), (0, 0), (1, 1)]           # the annulus residual's plan
IDX6 = IDX5 + [(0, 1)]
REL_TOL = 1e-4      # per stream: max |kernel - ref| / max |ref|
RES_RTOL, RES_ATOL = 1e-3, 1e-4   # residual tolerance (1/r^2 scales u_tt)
# B2, per leaf: max |kernel - ref| <= GRAD_REL * max |ref| + GRAD_ABS (fp32
# sums over all points in another order)
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
# step-0 gradient of the full loss, kernel vs generic engine (the tolerance
# of tests/test_kernels.py for the Pallas custom_vjp)
STEP0_RTOL, STEP0_ATOL = 2e-3, 2e-5
ADAM_RTOL = 1e-6    # B3 vs plain, per vector: max |diff| / max |ref|
TIMED_RUNS = 15
KERNELS = ("taylor2_fwd", "taylor2_bwd", "adam")
# the annulus_laplace recipe's batch (tpinn/problems/recipes.py:92-102)
RECIPE_COUNTS = dict(n_col=30000, n_band=5000, n_adaptive=10000, n_bd=500)
RECIPE_N = 30000 + 5000 + 10000 + 2 * 500
# bench.py's shape: 6x60 soft-BC annulus, 5,200 points (bench.py:44-46)
BENCH_COUNTS = dict(n_col=3000, n_band=1000, n_adaptive=1000, n_bd=100)
ADAM_N = 32_801     # parameters of the 6x80 net on 3 features
ADAM_STEPS = 1000
TRAIN_ADAM = 300    # Adam steps per stage in the training phase
TRAIN_LBFGS = 30    # lbfgs_epochs per stage (max_iters = epochs / 3)
RECIPE_ADAM = 300   # phase 5b: adam_epochs of the recipe, cut from 8,000
# phase 5b: lbfgs_epochs, cut from 8,000 (100 iterations per round).  270
# also passed every check, but its correction's resid_drop of 0.783 lay
# close to the 0.8 above which polish.galerkin_defect keeps no correction
RECIPE_LBFGS = 900
RECIPE_GRID_N = 450 * 450   # points of the recipe's lbfgs_grid
RECIPE_DENSITY_N = 111 * 111  # the recipe's density grid (grid=111)
# phase 3b: a 6x128 net and heat_2d's 6x96 net at its recipe's batch
# (tpinn/problems/recipes.py), whose gradients B2 cannot keep in shared
# memory, and a 3x256 net, whose W it stages in chunks of rows
WIDE_N = 16_384
HEAT_N = 20000 + 2000 + 6000
CHUNK_N = 4_096
# phase 3a: a 3x700 net at S = 10, too wide for W in shared memory beside
# the stream buffers of B1
L1_N = 2_048
# the poisson_3d recipe (tpinn_torch/problems/recipes.py): 5x64 hard BC,
# u and the three firsts and pure seconds of the 3-D product rule
P3D_COUNTS = dict(n_col=4000, n_band=1000, n_adaptive=1000, n_bd=200, grid=31)
P3D_N = 4000 + 1000 + 1000 + 6 * 200
P3D_GRID_N = 24 ** 3
IDX7 = [(), (0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]
# phase 5c: adam_epochs and lbfgs_epochs of the recipe, cut from 4,000 each
# (200 L-BFGS iterations per round), and the bar for rel-L2 at that budget.
# At 300 / 600 the run fails the bar by design of the method, not by a
# fault: after 300 Adam steps the hidden basis is nearly rank-deficient, the
# float64 last-layer solve lands on large cancelling weights, and their
# float32 cast is useless (rel-L2 1.7; the reference package does the same)
P3D_ADAM = 1000
P3D_LBFGS = 1200
P3D_REL_L2 = 1e-3
# phase 5e: the three marching recipes at their widths, batches and
# windows (tpinn_torch/problems/recipes.py; 4x64 tanh, 4,096 + 1,024
# points and 512 per BC group a step; 8, 4 and 8 windows), each window's
# budgets cut: (adam_epochs, lbfgs_epochs) against the recipe's 20,000 /
# 6,000 (convection_1d, wave_1d) and 12,000 / 4,000 (allen_cahn) a
# window; the cadences that scale with the budget cut as in phase 5c
MARCH_CUTS = {"convection_1d": (300, 150), "wave_1d": (300, 150),
              "allen_cahn": (100, 60)}
MARCH_CADENCE = dict(tail_max=20, density_every=100, plateau_every=200)
MARCH_TOL = 1e-6    # composite vs its windows, handoffs, served /predict
# phase 5f: the three coupled-system recipes (SYSTEM_RECIPES, built into a
# TrainSpec as tpinn's `system --recipe` does: system_spec) at their widths
# and batches, the budgets cut: (adam_epochs, lbfgs_epochs) against the
# recipes' 12,000 / 8,000 (kovasznay, the main path: 5x64, 13,600 points a
# step), 10,000 / 8,000 (taylor_green) and 20,000 / 8,000 (schrodinger);
# tail_max 4,000 -> 20 and the cadences that scale with the budget cut as
# in phase 5e
SYSTEM_CUTS = {"kovasznay": (300, 150), "taylor_green": (100, 60),
               "schrodinger": (100, 60)}
SYSTEM_CADENCE = MARCH_CADENCE
SYSTEM_REPEAT = 50  # Adam steps of kovasznay's training run twice
# phase 5g: `tpinn invert`'s heat-diffusivity identification and its
# eigenvalue mode (preset, equation, coefficient and its start, normalize,
# budgets), built into an InverseSpec and a TrainSpec as tpinn's `invert`
# builds them (invert_spec) at the CLI's width and batch: 4x32 tanh, 2,000
# + 500 points and 100 per BC group a step, 200 observations.  The budgets
# are cut from the CLI's 4,000 / 3,000, the cadences as in phase 5e.  The
# eigen case needs more than the heat case: at 300 / 150 its net sits at
# the trivial u = 0 (the saddle of the mean-square pin) after Adam, and 50
# L-BFGS iterations do not leave it (lam stays at 7.98; CPU runs)
INVERSE_CASES = {
    "heat": ("heat_2d", "u_t - lam*u_xx", {"lam": 0.3}, 0.0, (300, 150)),
    "eigen": ("poisson_1d", "u_xx + lam*u", {"lam": 8.0}, 0.5, (1000, 600)),
}
INVERSE_CADENCE = MARCH_CADENCE
INVERSE_REPEAT = 50  # Adam steps of the heat case run twice
INVERSE_SERVE_N = 1_000  # points a served request (B1 at the 1,024 tier)
INVERSE_BAR = 1e-2  # |lam - 1| of --inverse-recipe (tests/test_inverse.py)
# phase 5h: the flagship recipe with two ensemble members at phase 5b's
# cut; patched helmholtz_2d as `tpinn train --patches 6x6` builds it
# (patch_cli_spec), budgets cut from the CLI's 8,000 / 3,000, the cadences
# as in phase 5e; refmode at bench.py's shape, its residual against the
# forward engine in float64 and REF_STEPS reference Adam steps
ENSEMBLE_K = 2
PATCH_N = (6, 6)
PATCH_CUT = (300, 150)
PATCH_CADENCE = MARCH_CADENCE
PATCH_REPEAT = 50   # Adam steps of the patched run trained twice
PATCH_BAR = 2e-2    # rel-L2 of --patch-recipe (tests/test_patch.py)
REF_STEPS = 30
REF_RTOL, REF_ATOL = 1e-8, 1e-10
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6  # served /predict vs the trainer's
# phase 5i: tpinn's __main__ demo request (tpinn/core/train.py:1771-1791)
# posted to the port's lite calculator at its full width and batch: 6x60
# tanh, 3,000 + 1,000 + 1,000 points, a 111x111 test grid, then the 6x50
# sin correction stage at twice the points.  (adam, lbfgs) of the first
# stage cut from 1,000 / 1,000 (the second stage takes three times the
# first's); the two overlapping sessions at a smaller cut; the CLI run of
# poisson_1d at the CLI's width and batch, cut from 8,000 / 3,000
CALC_CUT = (200, 100)
CALC_PAIR_CUT = (50, 30)
CALC_CLI_CUT = (300, 150)
CALC_TIMEOUT = 300  # seconds a calculator session or the CLI run may take
# the demo leaves u free in t (no condition in t, and the periodic feature
# is 2*pi-periodic on t in [0, 1]), so rel-L2 against log(r)/log(0.1) says
# little; its gates: U on each Dirichlet column (u = 1 at r = 0.1, 0 at
# r = 1) within a tenth of the jump between them (RMS), the correction
# stage's residual RMS at most half the first stage's, and the demo's
# rel-L2 within a factor of the same run's with each kernel's plain
# version in its place (plain_kernels)
CALC_BC_TOL = 0.1
CALC_RESID_DROP = 0.5
CALC_WITNESS = 2.0
CALC_FIGURES = {"colloc": "heatmap_scatter", "solution": "dual_heatmap",
                "error": "heatmap", "loss": "lines_log",
                "boundary": "lines_log_pair", "spectrum": "heatmap"}
# phase 5j: the flagship recipe (6x80 hard BC, 46,000 points a step) with
# its Adam budget cut from 8,000 to RESUME_ADAM and lbfgs_epochs from 8,000
# to 9 (3 rounds of one iterate on the 450^2 grid), the last-layer solves
# and the correction off (they come after the phase resumed); the cadences
# cut so
# that the draws (every 30 steps), the density refreshes (every 40) and a
# plateau check (every 60) fall inside the resumed window; a phase file
# every 50 steps (log_every 5: a log chunk of 50); run B killed right
# after the save at step RESUME_KILL
RESUME_ADAM = 200
RESUME_KILL = 100
RESUME_LBFGS = 9
RESUME_CADENCE = dict(tail_max=20, resample_every=30, density_every=40,
                      plateau_every=60, log_every=5, checkpoint_every=50)
RESUME_LBFGS_RTOL = 1e-5   # L-BFGS row 0 on the CPU vs on the card
PROFILE_STEPS = 10         # flagship Adam steps in the profiler's trace
TIMER_STEPS = 20           # flagship Adam steps timed by StepTimer
QUEUED = 100        # back-to-back launches timed behind a long kernel
# B3 past one grid of 132 SMs x 4 blocks x 256 threads: its threads loop
LOOP_N = 140_001
# steps of B3's launcher in b3_times: its calls and graph replays (1,224)
B3_TIMED_STEPS = 2000
# the card's published peaks (H100 SXM data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def box_points(gen, n, lo, hi, device):
    import torch

    lo = torch.tensor(lo, dtype=torch.float32)
    hi = torch.tensor(hi, dtype=torch.float32)
    u = torch.rand((n, len(lo)), generator=gen, dtype=torch.float32)
    return (lo + u * (hi - lo)).to(device)


def plain_partials(pred, params, z, indices):
    """u-partials of a served predictor with kernel B1 replaced by its
    plain version (taylor2_mlp) — same hard-BC and stage structure."""
    from tpinn_torch.core import net, taylor

    if hasattr(pred, "tpinn_hard"):
        lift, bubble = pred.tpinn_hard
        raw = pred.tpinn_raw
        return net.hard_bc_partials(
            lambda p, zz, need: plain_partials(raw, p, zz, need),
            lift, bubble)(params, z, indices)
    if pred.tpinn_kind == "sum":
        a = plain_partials(pred.tpinn_stage, params["stage"], z, indices)
        b = plain_partials(pred.tpinn_prev, params["prev"], z, indices)
        return {k: a[k] + b[k] for k in a}
    lb, ub = pred.tpinn_bounds
    return taylor.taylor2_mlp(params, z, pred.tpinn_spec,
                              pred.tpinn_feature_map, lb, ub, indices)


def sync_ms(fn) -> float:
    """Host time of one call that ends in torch.cuda.synchronize()."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_cases():
    """(name, spec, fm, lb, ub, streams, N) for phase 3."""
    from tpinn_torch.core import net, taylor

    two_pi = 2.0 * math.pi
    annulus = net.MLPSpec(depth=6, width=80)
    annulus_fm = net.feature_map_for(("minmax", "periodic"))
    return [
        ("annulus 6x80 tanh", annulus, annulus_fm, (0.1, 0.0), (1.0, two_pi),
         IDX5, 262_144),
        ("annulus 6x80 tanh ragged", annulus, annulus_fm, (0.1, 0.0),
         (1.0, two_pi), IDX5, 1_077),
        ("annulus 6x80 tanh, the recipe's L-BFGS grid", annulus, annulus_fm,
         (0.1, 0.0), (1.0, two_pi), IDX5, RECIPE_GRID_N),
        ("sin first, minmax x2, pad_to=3",
         net.MLPSpec(depth=6, width=64, act_first="sin", scl=3.0, epsil=0.5),
         net.feature_map_for(("minmax", "minmax"), pad_to=3),
         (0.0, 0.0), (1.0, 1.0), IDX6, 65_536),
        ("3 coordinates, full order-2 plan",
         net.MLPSpec(depth=4, width=48, scl=1.3, epsil=0.7),
         net.feature_map_for(("minmax", "periodic", "identity")),
         (0.0, 0.0, -1.0), (1.0, two_pi, 1.0),
         taylor.plan_streams([(i, j) for i in range(3) for j in range(i, 3)]),
         32_768),
        ("poisson_3d 5x64 tanh, the recipe's batch", p3d_spec(),
         net.feature_map_for(("minmax",) * 3), (0.0,) * 3, (1.0,) * 3, IDX7,
         P3D_N),
        ("poisson_3d 5x64 tanh, the recipe's L-BFGS grid", p3d_spec(),
         net.feature_map_for(("minmax",) * 3), (0.0,) * 3, (1.0,) * 3, IDX7,
         P3D_GRID_N),
    ]


def march_kernel_cases():
    """(name, spec, fm, lb, ub, streams, N, backward) of phases 3a and 3b
    for the marching path (phase 5e): the window nets of convection_1d and
    wave_1d as their recipes build them, in the first and the last
    window's slab, with the stream plan of their equation, at the batch a
    step (n_col + n_band + n_adaptive + n_bd per BC group of the window:
    B1 and B2) and at the density grid (grid^2 points: B1 only)."""
    from tpinn_torch import problems
    from tpinn_torch.core import net, pde, taylor
    from tpinn_torch.core.march import window_problem

    cases = []
    for name in ("convection_1d", "wave_1d"):
        problem, spec = problems.get_recipe(name)
        windows = problems.RECIPES[name].march
        st = spec.stages[0]
        mspec = net.MLPSpec(depth=st.depth, width=st.width,
                            act_first=st.act_first, act_hidden=st.act_hidden,
                            scl=st.scl, epsil=st.epsil)
        fm = net.feature_map_for(problem.feature_kinds,
                                 pad_to=spec.pad_features)
        ai = problem.coords.index("t")
        compiled = pde.compile_pde(problem.equation, problem.coords)
        streams = taylor.plan_streams(compiled.indices)
        second = max(ix.count(ai) for ix in compiled.indices) == 2
        edges = [problem.lb[ai] + (problem.ub[ai] - problem.lb[ai]) * k
                 / windows for k in range(windows + 1)]
        for k in (0, windows - 1):
            sub = window_problem(problem, ai, edges[k], edges[k + 1], k,
                                 (lambda z: z[:, :1]) if k else None,
                                 handoff_velocity=second)
            batch = (spec.n_col + spec.n_band + spec.n_adaptive
                     + spec.n_bd * len(sub.bc_groups))
            for n, what, backward in ((batch, "the batch", True),
                                      (spec.grid ** 2, "the density grid",
                                       False)):
                cases.append((f"{name} {st.depth}x{st.width} {st.act_first}, "
                              f"window {k + 1}, {what}", mspec, fm, sub.lb,
                              sub.ub, streams, n, backward))
    return cases


def march_adam_sizes():
    """The parameter counts of the three marching recipes' window nets:
    the vectors B3 updates on the marching path (phase 3c holds them)."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import net

    sizes = set()
    for name in ("convection_1d", "wave_1d", "allen_cahn"):
        problem, spec = problems.get_recipe(name)
        st = spec.stages[0]
        fm = net.feature_map_for(problem.feature_kinds,
                                 pad_to=spec.pad_features)
        params = net.init_params(
            torch.Generator().manual_seed(SEED),
            net.MLPSpec(depth=st.depth, width=st.width), fm, "cpu")
        sizes.add(sum(t.numel() for t in leaves_of(params)))
    return sorted(sizes)


def b1_mode_cases():
    """(name, spec, fm, lb, ub, streams, N) of phase 3a's nets whose
    weights B1 cannot keep resident: heat_2d's recipe net at its batch and
    a 6x128 net (each layer's W staged per tile), a 3x256 net (W staged in
    chunks of rows) and a 3x700 net at S = 10 (W read through L1)."""
    from tpinn_torch.core import net, taylor

    annulus_fm = net.feature_map_for(("minmax", "periodic"))
    return [
        ("heat_2d 6x96 tanh, the recipe's batch", net.MLPSpec(depth=6, width=96),
         net.feature_map_for(("minmax", "minmax"), pad_to=3), (0.0, 0.0),
         (1.0, 1.0), [(), (0,), (1,), (0, 0)], HEAT_N),
        ("annulus 6x128 tanh", net.MLPSpec(depth=6, width=128), annulus_fm,
         (0.1, 0.0), (1.0, 2 * math.pi), IDX5, WIDE_N),
        ("annulus 3x256 tanh", net.MLPSpec(depth=3, width=256), annulus_fm,
         (0.1, 0.0), (1.0, 2 * math.pi), IDX5, CHUNK_N),
        ("3 coordinates 3x700, S = 10",
         net.MLPSpec(depth=3, width=700, scl=1.3, epsil=0.7),
         net.feature_map_for(("minmax", "periodic", "identity")),
         (0.0, 0.0, -1.0), (1.0, 2 * math.pi, 1.0),
         taylor.plan_streams([(i, j) for i in range(3) for j in range(i, 3)]),
         L1_N),
    ]


def phase_kernel_vs_plain(dev, gen):
    """B1 against its plain version and the generic jvp engine, per
    stream, in every W mode; each case's plan against the kernel's own
    count of its shared memory."""
    import torch

    from tpinn_torch.core import deriv, net
    from tpinn_torch.kernels import _build, mlp_taylor

    lib = _build.load("taylor2_fwd")
    lib.tpinn_taylor2_fwd_smem.restype = ctypes.c_longlong
    lib.tpinn_taylor2_fwd_smem.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5
    check(lib.tpinn_taylor2_fwd_max_threads() == mlp_taylor.THREADS,
          "the wrapper's THREADS differs from the kernel's")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst_abs = 0.0
    modes, chunked = set(), False
    paths = [case[:-1] for case in march_kernel_cases()
             + inverse_kernel_cases() + calculator_kernel_cases()]
    # phase 5j's density grid (its batch and L-BFGS grid are kernel_cases')
    paths += [case[:-1] for case in resume_kernel_cases()
              if case[6] == RECIPE_DENSITY_N]
    for name, spec, fm, lo, hi, streams, n in (kernel_cases() + paths
                                               + b1_mode_cases()):
        dims = [fm.num_features] + [spec.width] * spec.depth + [1]
        plan = mlp_taylor.tiling(dims, len(streams), n, sms)
        c_smem = lib.tpinn_taylor2_fwd_smem(
            len(dims) - 1, (ctypes.c_int * len(dims))(*dims), len(streams),
            plan.tp, mlp_taylor.W_MODES[plan.w_mode], plan.kc, plan.ks)
        check(c_smem == plan.smem_bytes <= 232_448,
              f"{name}: plan's shared memory {plan.smem_bytes} B, the "
              f"kernel's {c_smem} B")
        modes.add(plan.w_mode)
        chunked |= plan.w_mode == "layer" and plan.kc < max(dims[:-2])
        params = net.init_params(gen, spec, fm, dev)
        lb = torch.tensor(lo, dtype=torch.float32, device=dev)
        ub = torch.tensor(hi, dtype=torch.float32, device=dev)
        z = box_points(gen, n, lo, hi, dev)
        before = mlp_taylor.LAUNCHES
        got = mlp_taylor.taylor2_streams(params, z, spec, fm, lo, hi, streams)
        check(mlp_taylor.LAUNCHES == before + 1, f"{name}: B1 not launched")
        plain = mlp_taylor.taylor2_streams_reference(params, z, spec, fm, lo,
                                                     hi, streams)
        pred = net.make_predictor(spec, fm, lb, ub)
        gparts = deriv.partials(lambda zz: pred(params, zz), z, streams)
        generic = torch.cat([gparts[st] for st in streams], dim=1)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        print(f"  {name}: N={n} S={len(streams)} plan {plan}")
        for k, st in enumerate(streams):
            scale_p = plain[:, k].abs().max().item()
            scale_g = generic[:, k].abs().max().item()
            err_p = (got[:, k] - plain[:, k]).abs().max().item()
            err_g = (got[:, k] - generic[:, k]).abs().max().item()
            worst_abs = max(worst_abs, err_p)
            rel_p, rel_g = err_p / scale_p, err_g / scale_g
            print(f"    stream {str(st):7s} max|ref| {scale_p:.4e}  "
                  f"rel err vs plain {rel_p:.3e}  vs jvp {rel_g:.3e}")
            check(rel_p <= REL_TOL, f"{name} stream {st} vs plain: {rel_p}")
            check(rel_g <= REL_TOL, f"{name} stream {st} vs jvp: {rel_g}")
    check(modes == set(mlp_taylor.W_MODES) and chunked,
          f"phase 3a held the W modes {sorted(modes)} only, W chunked: "
          f"{chunked}")
    return worst_abs


def leaves_of(params):
    return [t for layer in params["layers"] for t in (layer["w"], layer["b"])]


def check_grads(name, got, ref, rtol=None, atol=None) -> float:
    """Per leaf: max |got - ref| <= GRAD_REL * max |ref| + GRAD_ABS, or,
    with rtol/atol, |got - ref| <= atol + rtol * |ref| elementwise.
    Returns the largest absolute difference."""
    worst = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        if rtol is None:
            ok = err <= GRAD_REL * scale + GRAD_ABS
        else:
            ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
        check(ok, f"{name}, leaf {k}: max |diff| {err:.3e}, max |ref| "
                  f"{scale:.3e}")
        worst = max(worst, err)
    return worst


def phase_b2(dev, gen):
    """B1 + B2 through the autograd Function against B2's plain version
    and against autograd through the plain Taylor-2 recurrence."""
    import torch

    from tpinn_torch.core import net, taylor
    from tpinn_torch.kernels import _build, mlp_taylor, taylor_vjp

    # per case of kernel_cases(), then a net whose gradient does not fit
    # in shared memory (the kernel adds it per tile in device memory)
    sizes = (RECIPE_N, 1_077, RECIPE_GRID_N, 16_384, 8_192, P3D_N,
             P3D_GRID_N)
    cases = [(n, *case[:-1]) for n, case in zip(sizes, kernel_cases())]
    cases.append((WIDE_N, "annulus 6x128 tanh, gradient too large for "
                  "shared memory", net.MLPSpec(depth=6, width=128),
                  net.feature_map_for(("minmax", "periodic")), (0.1, 0.0),
                  (1.0, 2 * math.pi), IDX5))
    # heat_2d's recipe net at its batch: the one shipped recipe whose
    # gradient goes to device memory
    cases.append((HEAT_N, "heat_2d 6x96 tanh, gradient too large for "
                  "shared memory", net.MLPSpec(depth=6, width=96),
                  net.feature_map_for(("minmax", "minmax"), pad_to=3),
                  (0.0, 0.0), (1.0, 1.0), [(), (0,), (1,), (0, 0)]))
    # too wide for the whole of a layer's W: W staged in chunks of rows
    cases.append((CHUNK_N, "annulus 3x256 tanh, W staged in chunks",
                  net.MLPSpec(depth=3, width=256),
                  net.feature_map_for(("minmax", "periodic")), (0.1, 0.0),
                  (1.0, 2 * math.pi), IDX5))
    # the marching windows, the inverse cases' net and the calculator's
    # two stages at their batch (phases 5e's, 5g's and 5i's B2 launches)
    cases += [(n, name, spec, fm, lo, hi, streams) for
              name, spec, fm, lo, hi, streams, n, backward in
              march_kernel_cases() + inverse_kernel_cases()
              + calculator_kernel_cases() if backward]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load("taylor2_bwd")
    lib.tpinn_taylor2_bwd_smem.restype = ctypes.c_longlong
    lib.tpinn_taylor2_bwd_smem.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    check(lib.tpinn_taylor2_bwd_threads() == taylor_vjp.THREADS,
          "the wrapper's THREADS differs from the kernel's")
    worst_abs = 0.0
    modes = set()
    chunked = False
    for n, name, spec, fm, lo, hi, streams in cases:
        dims = [fm.num_features] + [spec.width] * spec.depth + [1]
        plan = taylor_vjp.tiling(dims, len(streams), n, sms)
        c_smem = lib.tpinn_taylor2_bwd_smem(
            len(dims) - 1, (ctypes.c_int * len(dims))(*dims), len(streams),
            plan.tp, plan.kc, int(plan.accumulate == "smem"))
        check(c_smem == plan.smem_bytes <= 232_448,
              f"{name}: plan's shared memory {plan.smem_bytes} B, the "
              f"kernel's {c_smem} B")
        modes.add(plan.accumulate)
        chunked |= plan.kc < max(dims[:-1])
        print(f"  {name}: plan {plan}")
        params = net.init_params(gen, spec, fm, dev)
        leaves = leaves_of(params)
        for t in leaves:
            t.requires_grad_(True)
        z = box_points(gen, n, lo, hi, dev)
        ct = torch.randn((n, len(streams)), generator=gen).to(dev)
        before = (mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES)
        runs = []
        for _ in range(2):
            out = taylor_vjp.kernel_streams(params, z, spec, fm, lo, hi,
                                            streams)
            runs.append(torch.autograd.grad((out * ct).sum(), leaves))
        torch.cuda.synchronize()
        grew = (mlp_taylor.LAUNCHES - before[0],
                taylor_vjp.LAUNCHES - before[1])
        check(grew == (2, 2), f"{name}: B1/B2 launches {grew}, expected (2, 2)")
        got = runs[0]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{name}: B2 gradient not bitwise repeatable")
        layers = [{"w": t["w"].detach(), "b": t["b"].detach()}
                  for t in params["layers"]]
        plain = leaves_of({"layers": taylor_vjp.taylor2_backward_reference(
            layers, z, ct, spec, fm, lo, hi, streams)})
        lb = torch.tensor(lo, dtype=torch.float32, device=dev)
        ub = torch.tensor(hi, dtype=torch.float32, device=dev)
        parts = taylor.taylor2_mlp(params, z, spec, fm, lb, ub, streams)
        cols = torch.cat([parts[st] for st in streams], dim=1)
        auto = torch.autograd.grad((cols * ct).sum(), leaves)
        err_p = check_grads(f"{name}: B2 vs plain", got, plain)
        err_a = check_grads(f"{name}: B2 vs autograd", got, auto)
        worst_abs = max(worst_abs, err_p)
        print(f"  {name}: N={n} S={len(streams)} max |grad| "
              f"{max(g.abs().max().item() for g in plain):.4e}, max abs err "
              f"vs plain {err_p:.3e}, vs autograd {err_a:.3e}, repeatable")
        try:
            taylor_vjp.kernel_streams(params, z.clone().requires_grad_(True),
                                      spec, fm, lo, hi, streams)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"{name}: points requiring a gradient were "
                               f"not refused")
    check(modes == {"smem", "global"} and chunked,
          f"phase 3b held the accumulation modes {sorted(modes)} only, W "
          f"chunked: {chunked}")

    # the hard-BC product rule: the residual-MSE gradient of the kernel
    # engine against the plain engine and the generic jvp engine
    from tpinn_torch import problems

    annulus = problems.with_hard_bc(problems.annulus_laplace())
    cube = problems.with_hard_bc(problems.poisson_3d())
    for problem, mspec, n in ((annulus, annulus_spec(), RECIPE_N),
                              (annulus, annulus_spec(), 1_077),
                              (annulus, annulus_spec(), RECIPE_GRID_N),
                              (cube, p3d_spec(), P3D_N),
                              (cube, p3d_spec(), P3D_GRID_N)):
        pred, compiled, params, data, lw = loss_setup(
            problem, mspec, dev, col_only=n)
        got, ref = loss_grads(pred, compiled, params, data, lw, "kernel")
        plain, _ = loss_grads(plain_engine(pred), compiled, params, data, lw,
                              "fused", ref)
        generic, _ = loss_grads(pred, compiled, params, data, lw, "generic",
                                ref)
        what = f"{problem.name} {mspec.depth}x{mspec.width}, N={n}"
        err_p = check_grads(f"hard-BC {what}: kernel vs plain", got, plain)
        err_g = check_grads(f"hard-BC {what}: kernel vs generic", got,
                            generic, STEP0_RTOL, STEP0_ATOL)
        worst_abs = max(worst_abs, err_p)
        print(f"  hard-BC residual MSE, {what}: max abs err vs plain "
              f"{err_p:.3e}, vs generic {err_g:.3e}")
    return worst_abs


def cli_args(*argv):
    """A `python -m tpinn_torch` command line, parsed by the port's CLI."""
    from tpinn_torch import cli

    return cli.build_parser().parse_args([str(a) for a in argv])


def system_spec(name, adam_epochs=None, lbfgs_epochs=None, **spec_kw):
    """SYSTEM_RECIPES[name] as `python -m tpinn_torch system --name NAME
    --recipe` builds it (cli.system_spec, tpinn's CLI field for field):
    one stage of depth x width, scl = epsil = 1, n_band 0, lw (1, 0), seed
    1234, pad_features 3; the budgets replaced where given, and the
    TrainSpec fields of spec_kw."""
    import dataclasses

    from tpinn_torch import cli

    _, spec = cli.system_spec(cli_args("system", "--name", name, "--recipe"))
    st = spec.stages[0]
    st = dataclasses.replace(
        st, adam_epochs=st.adam_epochs if adam_epochs is None else adam_epochs,
        lbfgs_epochs=(st.lbfgs_epochs if lbfgs_epochs is None
                      else lbfgs_epochs))
    return dataclasses.replace(spec, stages=(st,), **spec_kw)


def inverse_case():
    """Phase 5f's inverse system, the tests' oscillator: u_x - v, v_x +
    w2*u on [0, 1], u(0) = 0, full-state observations of u = sin(pi x), v
    = pi cos(pi x) (true w2 = pi^2), w2 from 5.0, at the tests' size
    (tests/test_torch_system_train.py), with adam_layout="tree": one B3
    vector per leaf, the coefficient a 1-element one.  Returns (problem,
    InverseSpec, TrainSpec)."""
    import math

    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.inverse import InverseSpec
    from tpinn_torch.core.system import SystemSpec
    from tpinn_torch.core.train import StageSpec, TrainSpec

    pi = math.pi
    problem = SystemSpec(
        name="osc_inverse", equations=("u_x - v", "v_x + w2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0,
                                  field=0),),
        exact=lambda z: torch.cat([torch.sin(pi * z[:, :1]),
                                   pi * torch.cos(pi * z[:, :1])], dim=1))
    spec = TrainSpec(
        n_col=256, n_band=0, n_adaptive=64, n_bd=16, seed=1,
        stages=(StageSpec(depth=3, width=24, adam_epochs=600,
                          lbfgs_epochs=900),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        log_every=300, adam_layout="tree")
    return problem, InverseSpec(params=("w2",), init=(5.0,), n_obs=80), spec


def system_adam_sizes():
    """The vectors B3 updates on the system path: the three system
    recipes' nets raveled (the flat layout) and, under the tree layout,
    each leaf of the inverse case's {"net", "coef"} tree (its coefficient
    a 1-element vector).  Phase 3c holds them."""
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.problems.systems import SYSTEM_RECIPES, get_system

    sizes = set()
    for name in SYSTEM_RECIPES:
        problem, st = get_system(name), system_spec(name).stages[0]
        fm = net.feature_map_for(problem.feature_kinds, pad_to=3)
        params = net.init_params(
            torch.Generator().manual_seed(SEED),
            net.MLPSpec(depth=st.depth, width=st.width,
                        out_dim=len(problem.fields)), fm, "cpu")
        sizes.add(sum(t.numel() for t in leaves_of(params)))
    problem, _, spec = inverse_case()
    st = spec.stages[0]
    params = net.init_params(
        torch.Generator().manual_seed(SEED),
        net.MLPSpec(depth=st.depth, width=st.width,
                    out_dim=len(problem.fields)),
        net.feature_map_for(problem.feature_kinds,
                            pad_to=spec.pad_features), "cpu")
    sizes.update(t.numel() for t in leaves_of(params))
    sizes.add(1)
    return sorted(sizes)


def invert_spec(name, adam_epochs=None, lbfgs_epochs=None, **spec_kw):
    """INVERSE_CASES[name] as `python -m tpinn_torch invert --problem P
    --equation E --param lam=INIT [--normalize N]` builds it
    (cli.invert_spec, tpinn's CLI field for field): the preset with its
    equation replaced (in eigen mode its oracle dropped: it solves the
    original equation), and the CLI's defaults: 4x32, scl = epsil = 1,
    n_col 2,000, n_band 0, n_adaptive 500, n_bd 100, n_obs 200, lw (1, 0),
    seed 1234, pad_features 3, adam 4,000, lbfgs 3,000; the budgets
    replaced where given, and the TrainSpec fields of spec_kw.  Returns
    (problem, InverseSpec, TrainSpec)."""
    import dataclasses

    from tpinn_torch import cli

    preset, equation, coef, normalize, _ = INVERSE_CASES[name]
    argv = ["invert", "--problem", preset, "--equation", equation,
            "--normalize", normalize]
    for k, v in coef.items():
        argv += ["--param", f"{k}={v!r}"]
    for flag, value in (("--adam", adam_epochs), ("--lbfgs", lbfgs_epochs)):
        if value is not None:
            argv += [flag, value]
    problem, inv, spec = cli.invert_spec(cli_args(*argv))
    return problem, inv, dataclasses.replace(spec, **spec_kw)


def inverse_net(problem, spec):
    """(MLPSpec, feature map) of invert_spec's net for ``problem``."""
    from tpinn_torch.core import net

    st = spec.stages[0]
    return (net.MLPSpec(depth=st.depth, width=st.width, scl=st.scl,
                        epsil=st.epsil),
            net.feature_map_for(problem.feature_kinds,
                                pad_to=spec.pad_features))


def inverse_kernel_cases():
    """(name, spec, fm, lb, ub, streams, N, backward) of phases 3a and 3b
    for the inverse path (phase 5g): the CLI's 4x32 net on 3 padded
    features in both cases, with the stream plan of the equation, at the
    batch a step (n_col + n_adaptive + n_bd per BC group: B1 and B2, the
    step-0 check, every Adam step and L-BFGS evaluation), at the density
    grid (grid^d points: B1, the refresh; in 2-D also the artifacts'
    residual on the 111^2 test grid) and, for the served heat checkpoint,
    at the tier of INVERSE_SERVE_N points (B1, /residual)."""
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import pde, taylor

    cases = []
    for name in INVERSE_CASES:
        problem, inv, spec = invert_spec(name)
        mspec, fm = inverse_net(problem, spec)
        compiled = pde.compile_pde(problem.equation, problem.coords,
                                   inv.params)
        streams = taylor.plan_streams(compiled.indices)
        batch = (spec.n_col + spec.n_band + spec.n_adaptive
                 + spec.n_bd * len(problem.bc_groups))
        sizes = [(batch, "the batch", True),
                 (spec.grid ** problem.dim, "the density grid", False)]
        if name == "heat":
            sizes.append((PINNServer._tier(INVERSE_SERVE_N),
                          "the served tier", False))
        for n, what, backward in sizes:
            cases.append((f"inverse {name} ({problem.name}) {mspec.depth}x"
                          f"{mspec.width} tanh, {what}", mspec, fm,
                          problem.lb, problem.ub, streams, n, backward))
    return cases


def inverse_adam_sizes():
    """The vectors B3 updates on the inverse path: the net and its
    coefficient raveled together (the flat layout: 3,330 for the 4x32 net
    on 3 features) and, under the tree layout, each net leaf and the
    coefficient's 1-element vector.  Phase 3c holds them."""
    import torch

    from tpinn_torch.core import net

    sizes = set()
    for name in INVERSE_CASES:
        problem, inv, spec = invert_spec(name)
        mspec, fm = inverse_net(problem, spec)
        leaves = [t.numel() for t in leaves_of(net.init_params(
            torch.Generator().manual_seed(SEED), mspec, fm, "cpu"))]
        leaves += [1] * len(inv.params)
        sizes.update([sum(leaves), *leaves])
    return sorted(sizes)


def at_offset(x, offset):
    """A copy of the 1-D ``x`` as a view ``offset`` elements into a buffer
    of its own: at offset 1 a float32 vector sits 4 bytes off 16-byte
    alignment."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x
    return buf[offset:]


def phase_b3(dev):
    """B3 against its plain version over ADAM_STEPS steps, lr halved at
    the midpoint, through the Adam phase's launcher (FusedAdam, the step
    counted on the device) and through adam_update_flat side by side, at
    n = ADAM_N, 1,001 (one element a thread), LOOP_N (the threads loop),
    the marching windows' parameter count, the system path's vectors
    (system_adam_sizes: 17,091, 37,826, 1 and the inverse case's leaves),
    the inverse path's (inverse_adam_sizes: 3,330 and the leaves), the
    patch path's stacked vectors (patch_adam_sizes: 468,036 and 2,824) and
    the calculator's stage trees (calculator_adam_sizes: 18,601 and
    31,602), on aligned vectors and on views one float off alignment; then
    the graph check."""
    import torch

    from tpinn_torch.kernels import adam

    worst_abs = 0.0
    sizes = {*march_adam_sizes(), *system_adam_sizes(),
             *inverse_adam_sizes(), *patch_adam_sizes(),
             *calculator_adam_sizes()} - {ADAM_N, 1_001, LOOP_N}
    for n in (ADAM_N, 1_001, LOOP_N, *sorted(sizes)):
        for offset in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            p0 = torch.randn(n, generator=gen, device=dev)
            z = torch.zeros_like(p0)
            routes = {"launcher": [at_offset(x, offset) for x in (p0, z, z)],
                      "adam_update_flat": [at_offset(x, offset)
                                           for x in (p0, z, z)]}
            pr, mr, vr = p0.clone(), z.clone(), z.clone()
            lr = torch.full((1,), 1e-3, device=dev)
            lr_r = lr.clone()
            launcher = adam.FusedAdam(*routes["launcher"], lr, ADAM_STEPS)
            before = adam.LAUNCHES
            for t in range(1, ADAM_STEPS + 1):
                if t == ADAM_STEPS // 2 + 1:
                    lr.mul_(0.5)
                    lr_r.mul_(0.5)
                g = at_offset(torch.randn(n, generator=gen, device=dev),
                              offset)
                launcher.step(g)
                adam.adam_update_flat(g, *routes["adam_update_flat"], lr, t)
                adam.adam_update_reference(g, pr, mr, vr, lr_r, t)
            torch.cuda.synchronize()
            what = f"B3 n={n} offset {offset}"
            check(adam.LAUNCHES - before == 2 * ADAM_STEPS,
                  f"{what}: launched {adam.LAUNCHES - before} times in "
                  f"{ADAM_STEPS} steps of two routes")
            check(launcher.t == ADAM_STEPS + 1,
                  f"{what}: the device step reads {launcher.t}")
            check(all(torch.equal(a, b) for a, b in
                      zip(*routes.values())),
                  f"{what}: the launcher and adam_update_flat differ")
            errs = []
            for name, a, b in zip("pmv", routes["launcher"], (pr, mr, vr)):
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                check(err <= ADAM_RTOL * scale,
                      f"{what} {name}: max |diff| {err:.3e}, max |ref| "
                      f"{scale:.3e}")
                errs.append(f"{name} {err:.2e}")
                worst_abs = max(worst_abs, err)
            print(f"  {what} ({'aligned' if offset == 0 else 'unaligned'}): "
                  f"{ADAM_STEPS} steps, lr halved at step "
                  f"{ADAM_STEPS // 2 + 1}; launcher and adam_update_flat "
                  f"identical, device step {launcher.t}; max abs err vs "
                  f"plain " + ", ".join(errs))
    worst_abs = max(worst_abs, b3_resumed(dev))
    return max(worst_abs, b3_graph_check(dev))


def resume_adam_cases():
    """(n, start) of every B3 launcher phase 5j's resumed Adam phase
    builds: the flagship's flat vector (ADAM_N floats) from step
    RESUME_KILL + 1.  Phase 3c holds them (b3_resumed)."""
    return [(ADAM_N, RESUME_KILL + 1)]


def b3_resumed(dev):
    """B3 through a launcher built at start > 1, as a resumed Adam phase
    builds it (bias corrections and device step from ``start``), on
    moments that are not zero, against its plain version from the same
    step and against adam_update_flat at each step, for the steps the
    resumed phase may take (tail included), lr halved half-way; aligned
    and one float off alignment.  Returns the largest absolute
    difference."""
    import torch

    from tpinn_torch.kernels import adam

    worst = 0.0
    steps = RESUME_ADAM + RESUME_CADENCE["tail_max"] - RESUME_KILL
    for n, start in resume_adam_cases():
        for offset in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(SEED + 2)
            p0 = torch.randn(n, generator=gen, device=dev)
            m0 = 1e-2 * torch.randn(n, generator=gen, device=dev)
            v0 = 1e-4 * torch.rand(n, generator=gen, device=dev)
            routes = {k: [at_offset(x, offset) for x in (p0, m0, v0)]
                      for k in ("launcher", "adam_update_flat")}
            pr, mr, vr = p0.clone(), m0.clone(), v0.clone()
            lr = torch.full((1,), 5e-4, device=dev)
            lr_r = lr.clone()
            launcher = adam.FusedAdam(*routes["launcher"], lr, steps,
                                      start=start)
            before = adam.LAUNCHES
            for k in range(steps):
                if k == steps // 2:
                    lr.mul_(0.5)
                    lr_r.mul_(0.5)
                g = at_offset(torch.randn(n, generator=gen, device=dev),
                              offset)
                launcher.step(g)
                adam.adam_update_flat(g, *routes["adam_update_flat"], lr,
                                      start + k)
                adam.adam_update_reference(g, pr, mr, vr, lr_r, start + k)
            torch.cuda.synchronize()
            what = f"B3 n={n} from step {start} offset {offset}"
            check(adam.LAUNCHES - before == 2 * steps,
                  f"{what}: launched {adam.LAUNCHES - before} times in "
                  f"{steps} steps of two routes")
            check(launcher.t == start + steps,
                  f"{what}: the device step reads {launcher.t}")
            check(all(torch.equal(a, b) for a, b in zip(*routes.values())),
                  f"{what}: the launcher and adam_update_flat differ")
            errs = []
            for name, a, b in zip("pmv", routes["launcher"], (pr, mr, vr)):
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                check(err <= ADAM_RTOL * scale,
                      f"{what} {name}: max |diff| {err:.3e}, max |ref| "
                      f"{scale:.3e}")
                errs.append(f"{name} {err:.2e}")
                worst = max(worst, err)
            print(f"  {what} ({'aligned' if offset == 0 else 'unaligned'}, "
                  f"phase 5j's resumed launcher): {steps} steps from t = "
                  f"{start}, lr halved at t = {start + steps // 2}; launcher "
                  f"and adam_update_flat identical, device step "
                  f"{launcher.t}; max abs err vs plain " + ", ".join(errs))
    return worst


def b3_graph_check(dev, k=10, replays=3):
    """``k`` launcher steps captured in one CUDA graph, replayed
    ``replays`` times, each time with a new gradient copied into the
    captured one and lr halved (outside the graph) between the first and
    the second replay, against k * replays plain steps on the same
    gradients; the device step must read k * replays + 1, and the capture
    must count no launch.  One replay more runs past the launcher's table:
    it must leave p, m and v as they were and make the device step raise.
    Returns the largest absolute difference."""
    import torch

    from tpinn_torch.kernels import adam

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p = torch.randn(ADAM_N, generator=gen, device=dev)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    grads = [torch.randn(ADAM_N, generator=gen, device=dev)
             for _ in range(replays)]
    pr, mr, vr = p.clone(), m.clone(), v.clone()
    lr = torch.full((1,), 1e-3, device=dev)
    lr_r = lr.clone()
    launcher = adam.FusedAdam(p, m, v, lr, k * replays)
    g_static = torch.empty_like(p)
    graph = torch.cuda.CUDAGraph()
    before = adam.LAUNCHES
    with torch.cuda.graph(graph):
        for _ in range(k):
            launcher.step(g_static)
    torch.cuda.synchronize()
    check(launcher.t == 1, f"B3 graph: capture moved the device step to "
                           f"{launcher.t}")
    check(adam.LAUNCHES == before, f"B3 graph: the capture counted "
                                   f"{adam.LAUNCHES - before} launches")
    for r, g in enumerate(grads):
        if r == 1:
            lr.mul_(0.5)
        g_static.copy_(g)
        graph.replay()
    for t in range(1, k * replays + 1):
        if t == k + 1:
            lr_r.mul_(0.5)
        adam.adam_update_reference(grads[(t - 1) // k], pr, mr, vr, lr_r, t)
    torch.cuda.synchronize()
    check(launcher.t == k * replays + 1,
          f"B3 graph: the device step reads {launcher.t} after {replays} "
          f"replays of {k} launches (the capture did not see the launches "
          f"on PyTorch's current stream)")
    worst, errs = 0.0, []
    for name, a, b in zip("pmv", (p, m, v), (pr, mr, vr)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= ADAM_RTOL * scale,
              f"B3 graph {name}: max |diff| {err:.3e}, max |ref| {scale:.3e}")
        errs.append(f"{name} {err:.2e}")
        worst = max(worst, err)
    kept = [x.clone() for x in (p, m, v)]
    graph.replay()                       # past the table: nothing updated
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((p, m, v), kept)),
          "B3 graph: a replay past the launcher's table changed p, m or v")
    try:
        past = launcher.t
    except RuntimeError as e:
        past = str(e)
    check(isinstance(past, str) and "past the last step" in past,
          f"B3 graph: after a replay past the table the device step read "
          f"{past!r} instead of raising")
    print(f"  B3 graph, n={ADAM_N}: {k} launcher steps captured on PyTorch's "
          f"current stream (no launch counted), replayed {replays} times (lr "
          f"halved between the first and the second replay): device step "
          f"{k * replays + 1}; max abs err vs {k * replays} plain steps "
          + ", ".join(errs) + "; one replay more, past the table, updated "
          f"nothing and the device step raised: {past}")
    return worst


def annulus_spec(width=80):
    from tpinn_torch.core import net

    return net.MLPSpec(depth=6, width=width)


def p3d_spec():
    from tpinn_torch.core import net

    return net.MLPSpec(depth=5, width=64)


def loss_setup(problem, mspec, dev, counts=None, col_only=None):
    """Predictor, compiled PDE, seeded params, a point set and lw for the
    Adam-step checks and timings: the sampler's draw at ``counts``, or
    ``col_only`` uniform collocation points and no BC terms."""
    import torch

    from tpinn_torch.core import net, pde, sample

    fm = net.feature_map_for(problem.feature_kinds)
    lb = torch.tensor(problem.lb, dtype=torch.float32, device=dev)
    ub = torch.tensor(problem.ub, dtype=torch.float32, device=dev)
    pred = net.make_predictor(mspec, fm, lb, ub)
    if problem.hard_bc:
        pred = net.wrap_hard_bc(pred, *(pde.compile_coord_expr(
            e, problem.coords) for e in problem.hard_bc))
    compiled = pde.compile_pde(problem.equation, problem.coords)
    params = net.init_params(torch.Generator().manual_seed(SEED), mspec, fm,
                             dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if col_only is not None:
        data = {"x_col": box_points(torch.Generator().manual_seed(SEED),
                                    col_only, problem.lb, problem.ub, dev),
                "x_bd": [], "u_bd": []}
    else:
        sample_fn, grids = sample.sampler_for(
            sample.SamplerConfig(**counts), problem.bc_groups, problem.lb,
            problem.ub, torch.float32, dev)
        data = sample_fn(gen, torch.ones_like(grids[0]))
    lw = torch.tensor([0.05, 0.0], device=dev)
    return pred, compiled, params, data, lw


def plain_engine(pred):
    """``pred`` whose structured partials come from B1's plain version
    under autograd: make_loss(engine='fused') on it launches no kernel."""
    def f(params, z):
        return pred(params, z)

    f.tpinn_partials = lambda p, z, idx: plain_partials(pred, p, z, idx)
    return f


def loss_grads(pred, compiled, params, data, lw, engine, ref=None):
    """Per-leaf gradient of the normalised loss (ref = the loss at these
    params unless given) with one residual engine; returns (grads, ref)."""
    import torch

    from tpinn_torch.core import loss as loss_mod

    loss_fn = loss_mod.make_loss(pred, compiled, engine=engine)
    leaves = [t.detach().requires_grad_(True) for t in leaves_of(params)]
    p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                    for i in range(len(leaves) // 2)]}
    if ref is None:
        with torch.no_grad():
            ref = loss_fn(p, data, lw, torch.ones((), device=lw.device))[1][0]
    loss_n, _ = loss_fn(p, data, lw, ref)
    return torch.autograd.grad(loss_n, leaves), ref


def write_checkpoints(gen):
    """The 6x80 hard-BC annulus net and a 2-stage hard-BC chain, in the
    format tpinn's run_training writes (tpinn/core/train.py)."""
    from tpinn_torch import problems
    from tpinn_torch.core import net
    from tpinn_torch.utils import checkpoint

    problem = problems.with_hard_bc(problems.annulus_laplace())
    fm = net.feature_map_for(problem.feature_kinds)
    s1 = net.MLPSpec(depth=6, width=80)
    s2 = net.MLPSpec(depth=6, width=50, act_first="sin", scl=7.0, epsil=0.03)
    p1 = net.init_params(gen, s1, fm, "cpu")
    p2 = net.init_params(gen, s2, fm, "cpu")

    def meta(stage, spec, chain):
        return {"stage": stage, "scl": spec.scl, "epsil": spec.epsil,
                "problem": problem.name,
                "chain": [net.spec_to_dict(s) for s in chain],
                "feature_kinds": list(problem.feature_kinds),
                "lb": list(problem.lb), "ub": list(problem.ub),
                "hard_bc": list(problem.hard_bc),
                "coords": list(problem.coords), "pad_features": 0,
                "deflation": None}

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    single = SMOKE_DIR / "annulus_6x80_hardbc.npz"
    chain = SMOKE_DIR / "annulus_chain_hardbc.npz"
    checkpoint.save_pytree(single, p1, meta(1, s1, [s1]))
    checkpoint.save_pytree(chain, net.compose_params(p2, p1),
                           meta(2, s2, [s1, s2]))
    return [("6x80 hard-BC", single), ("2-stage hard-BC chain", chain)]


def post(base, route, points):
    body = json.dumps({"points": points}).encode()
    req = urllib.request.Request(base + route, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def http_server(srv, make_handler=None):
    """Serve ``srv`` over HTTP on a free localhost port for the block
    (through app.serve's handler, or ``make_handler``'s); yields the base
    URL and stops the server thread after it."""
    if make_handler is None:
        from tpinn_torch.app.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "server thread did not stop")


def phase_serve(dev, ckpts):
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.kernels import mlp_taylor

    rng = np.random.default_rng(SEED)
    servers = []
    for name, path in ckpts:
        srv = PINNServer(str(path), "annulus_laplace", device=dev)
        with http_server(srv) as base:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                h = json.loads(r.read())
            check(h.get("ok") is True and h["problem"] == "annulus_laplace",
                  f"{name}: /health {h}")
            for n in (1, 1_000, 65_536):
                pts = np.stack([rng.uniform(0.1, 1.0, n),
                                rng.uniform(0.0, 2 * np.pi, n)],
                               axis=1).astype(np.float32)
                t0 = time.perf_counter()
                u = np.asarray(post(base, "/predict", pts.tolist())["u"])
                t_pred = time.perf_counter() - t0
                before = mlp_taylor.LAUNCHES
                t0 = time.perf_counter()
                f = np.asarray(post(base, "/residual", pts.tolist())["f"])
                t_res = time.perf_counter() - t0
                grew = mlp_taylor.LAUNCHES - before
                check(grew > 0, f"{name}: /residual at {n} launched no kernel")
                check(u.shape == (n,) and f.shape == (n,),
                      f"{name}: shapes {u.shape} {f.shape}")
                check(bool(np.isfinite(u).all() and np.isfinite(f).all()),
                      f"{name}: non-finite answer at {n} points")
                z = torch.from_numpy(pts).to(dev)
                direct = srv.predictor(srv.params, z)[:, 0].cpu().numpy()
                plain = srv.compiled.evaluate(
                    z, plain_partials(srv.predictor, srv.params, z,
                                      srv.compiled.indices))[:, 0].cpu().numpy()
                err_u = float(np.abs(u - direct).max())
                err_f = float(np.abs(f - plain).max())
                check(np.allclose(u, direct, rtol=1e-5, atol=1e-6),
                      f"{name}: /predict vs direct, max err {err_u}")
                check(np.allclose(f, plain, rtol=RES_RTOL, atol=RES_ATOL),
                      f"{name}: /residual vs plain, max err {err_f}")
                print(f"  {name}: n={n:6d} /predict {t_pred * 1e3:8.1f} ms "
                      f"(max err vs direct {err_u:.2e}), /residual "
                      f"{t_res * 1e3:8.1f} ms (max err vs plain {err_f:.2e}, "
                      f"max |f| {np.abs(plain).max():.3e}), launches +{grew}")
            theta = np.linspace(0.0, 2 * np.pi, 17)
            inner = np.asarray(post(base, "/predict",
                                    [[0.1, t] for t in theta])["u"])
            outer = np.asarray(post(base, "/predict",
                                    [[1.0, t] for t in theta])["u"])
            e_in = float(np.abs(inner - 1.0).max())
            e_out = float(np.abs(outer).max())
            check(e_in <= 1e-6 and e_out <= 1e-6,
                  f"{name}: boundary values |u(0.1)-1| {e_in}, |u(1)| {e_out}")
            print(f"  {name}: |u(0.1,t) - 1| <= {e_in:.1e}, "
                  f"|u(1,t)| <= {e_out:.1e}")
        servers.append((name, srv))
    return servers


def phase_train(dev):
    """run_training on the hard-BC annulus at the recipe's batch, with the
    step-0 gradient check before it and the trained checkpoint served
    after it.  Returns the kernels' launch counts of the run."""
    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core.train import StageSpec, TrainSpec, run_training
    from tpinn_torch.utils import artifacts

    problem = problems.with_hard_bc(problems.annulus_laplace())
    pred, compiled, params, data, lw = loss_setup(
        problem, annulus_spec(), dev, counts=RECIPE_COUNTS)
    check(data["x_col"].shape[0] == RECIPE_N, "recipe batch size")
    got, ref = loss_grads(pred, compiled, params, data, lw, "kernel")
    generic, _ = loss_grads(pred, compiled, params, data, lw, "generic", ref)
    err = check_grads("step-0 gradient, kernel vs generic engine", got,
                      generic, STEP0_RTOL, STEP0_ATOL)
    print(f"  step-0 gradient of the full loss (N={RECIPE_N}): kernel vs "
          f"generic engine max abs err {err:.3e} (rtol {STEP0_RTOL}, atol "
          f"{STEP0_ATOL})")

    spec = TrainSpec(
        **RECIPE_COUNTS, lw=(0.05, 0.0),
        stages=(StageSpec(depth=6, width=80, scl=1.0, epsil=1.0,
                          adam_epochs=TRAIN_ADAM, lbfgs_epochs=TRAIN_LBFGS),
                StageSpec(depth=6, width=50, act_first="sin",
                          adam_epochs=TRAIN_ADAM, lbfgs_epochs=TRAIN_LBFGS)),
        resample_every=100, density_every=100, plateau_every=200,
        tail_max=50, engine="generic", adam_engine="kernel")
    out = SMOKE_DIR / "train"
    shutil.rmtree(out, ignore_errors=True)
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    with adam_launchers() as built:
        res = run_training(problem, spec, output_dir=str(out),
                           log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for line in lines:
        print(f"  | {line}")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    check(len(n_adam) == 2, f"Adam phases logged: {n_adam}")
    print(f"  run_training: {seconds:.1f} s, Adam steps {n_adam}, launches "
          f"{launches}")
    for k, count in launches.items():
        check(count >= sum(n_adam),
              f"{k} launched {count} times for {sum(n_adam)} Adam steps")
    check_adam_route("train", built, launches["adam"], n_adam)

    h1, h2 = res.stages[0].history, res.stages[1].history
    drop = h1[0, 0] / h1[n_adam[0] - 1, 0]
    print(f"  stage 1 loss {h1[0, 0]:.4e} -> {h1[n_adam[0] - 1, 0]:.4e} over "
          f"Adam ({drop:.1f}x), {h1[-1, 0]:.4e} after L-BFGS; stage 2 "
          f"{h2[0, 0]:.4e} -> {h2[-1, 0]:.4e}; rel-L2 {res.rel_l2:.4e}")
    check(drop >= 10.0, f"stage-1 Adam loss drop {drop:.2f}x < 10x")
    check(h2[-1, 0] < h2[0, 0], "stage-2 loss did not fall")
    check(res.rel_l2 is not None and math.isfinite(res.rel_l2), "rel-L2")

    # the artifact contract (keys and shapes of tests/test_train_e2e.py)
    nt = spec.testing_size
    for name in artifacts.ARTIFACT_NAMES + ["params_stage_1.npz",
                                            "params_stage_2.npz"]:
        check((out / name).exists(), f"missing {name}")
    expect = {"solution_residual_1.npz": {"r", "t_vec", "U", "F"},
              "solution_residual_2.npz": {"r", "t", "U", "F"},
              "error_1.npz": {"r", "t", "Error"},
              "boundary_loss_1.npz": {"loss_xy_l", "loss_xy_r"},
              "frequency_spectrum.npz": {"freq_x", "freq_t", "log_mag"},
              "collocation_point_1.npz": {"U", "X_col", "limit"}}
    for name, keys in expect.items():
        with np.load(out / name) as d:
            check(set(d.keys()) == keys, f"{name} keys {sorted(d.keys())}")
    with np.load(out / "solution_residual_1.npz") as d:
        check(d["U"].shape == (nt[1], nt[0]), "U shape")
    with np.load(out / "error_1.npz") as d:
        check(d["Error"].shape == (nt[1], nt[0]), "Error shape")
    with np.load(out / "frequency_spectrum.npz") as d:
        check(d["log_mag"].shape == (nt[1], nt[0]), "log_mag shape")
    with np.load(out / "collocation_point_1.npz") as d:
        check(d["X_col"].shape == (RECIPE_N, 2), "X_col shape")
    with np.load(out / "loss_1.npz") as a, np.load(out / "loss_2.npz") as b:
        check(a["loss"].shape[1] == 3 + 2 + 1, "loss_info width")
        check(b["loss"].shape[0] > a["loss"].shape[0], "stage-2 loss rows")
    print(f"  {len(artifacts.ARTIFACT_NAMES)} artifacts and 2 checkpoints "
          f"written, keys and shapes checked")

    # the trained chain, served
    srv = PINNServer(str(out / "params_stage_2.npz"), "annulus_laplace",
                     device=dev)
    rng = np.random.default_rng(SEED)
    pts = np.stack([rng.uniform(0.1, 1.0, 1_000),
                    rng.uniform(0.0, 2 * np.pi, 1_000)], axis=1).astype(
                        np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
    with torch.no_grad():
        want = res.predict(torch.from_numpy(pts).to(dev))[:, 0].cpu().numpy()
    err_u = float(np.abs(u - want).max())
    check(np.allclose(u, want, rtol=1e-5, atol=1e-6),
          f"served /predict vs trainer's predictor, max err {err_u}")
    print(f"  params_stage_2.npz served: /predict at 1,000 points equals the "
          f"trainer's predictor (max err {err_u:.2e})")
    return launches


def phase_recipe(dev, card, adam_epochs=RECIPE_ADAM,
                 lbfgs_epochs=RECIPE_LBFGS, tail_max=50, seed=None):
    """The annulus_laplace recipe with its budgets cut, end to end: Adam
    through the kernels, three L-BFGS rounds each followed by the exact
    last-layer solve, the float64 evaluation, the Galerkin defect
    correction, the checkpoint with the correction in its meta, served.
    Returns the kernels' launch counts of the run."""
    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import polish
    from tpinn_torch.kernels import mlp_taylor
    from tpinn_torch.utils import checkpoint

    problem, spec = problems.get_recipe("annulus_laplace")
    stage = spec.stages[0]
    check((stage.depth, stage.width, stage.lbfgs_grid, stage.lbfgs_rounds)
          == (6, 80, 450, 3) and spec.lsq_polish == "auto"
          and spec.deflation == "full" and spec.adam_precision == "default"
          and spec.n_col + spec.n_band + spec.n_adaptive + 2 * spec.n_bd
          == RECIPE_N, "the annulus_laplace recipe is not the flagship's")
    # only the budgets are cut: Adam and L-BFGS epochs, and the Adam tail
    # (up to tail_max further steps while the loss still improves)
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    _, spec, res, lines, launches, n_adam, _ = run_recipe_cut(
        "annulus_laplace", dev, [(adam_epochs, lbfgs_epochs)],
        tail_max=tail_max, seed=spec.seed if seed is None else seed)
    out = SMOKE_DIR / "annulus_laplace"
    check(torch.backends.cuda.matmul.allow_tf32 == tf32_before,
          "adam_precision leaked out of the Adam phase")
    print(f"  seed {spec.seed}")
    for k, count in launches.items():
        check(count >= n_adam[0],
              f"{k} launched {count} times for {n_adam[0]} Adam steps")

    # the exact last-layer solve after every L-BFGS round
    solves = polish_lines(lines)
    check(len(solves) == stage.lbfgs_rounds,
          f"{len(solves)} lsq polish lines for {stage.lbfgs_rounds} rounds")
    for k, (obj0, obj1, applied, secs) in enumerate(solves):
        check(applied and obj1 <= obj0,
              f"round {k + 1}: lsq polish {obj0} -> {obj1}, applied {applied}")
        print(f"  round {k + 1}: last-layer solve on the 202,500-point grid, "
              f"objective {obj0:.4e} -> {obj1:.4e}, {secs:.2f} s wall on "
              f"{card}")

    # the correction: kind, what it absorbed, accuracy before and after
    _, meta = checkpoint.load_pytree(out / "params_stage_1.npz",
                                     res.stages[0].params)
    defl = meta.get("deflation")
    check(bool(defl), "the checkpoint's meta carries no deflation")
    check(defl["kind"] == "galerkin" and not defl.get("soft"),
          f"correction kind {defl['kind']} (r faces vanish, θ is periodic: "
          f"expected the hard-BC galerkin family)")
    wall = [float(m.group(1)) for m in
            (re.search(r"galerkin correction in (\S+) s", ln) for ln in lines)
            if m]
    check(len(wall) == 1, "no correction wall time logged")
    before, after = defl["rel_l2_before"], res.rel_l2
    print(f"  correction: kind {defl['kind']}, {len(defl['modes'])} modes, "
          f"resid_drop {defl['resid_drop']:.4e}, {wall[0]:.2f} s wall on "
          f"{card}")
    print(f"  rel-L2 before the correction {before:.4e}, after {after:.4e} "
          f"({before / after:.2f}x)")
    check(math.isfinite(after) and after <= before,
          f"rel-L2 {before} -> {after}: the correction made it worse")

    # the checkpoint, served with and without its correction
    bare = out / "uncorrected.npz"
    checkpoint.save_pytree(bare, res.stages[0].params,
                           {**meta, "deflation": None})
    rng = np.random.default_rng(SEED)
    pts = np.stack([rng.uniform(0.1, 1.0, 1_000),
                    rng.uniform(0.0, 2 * np.pi, 1_000)], axis=1).astype(
                        np.float32)
    answers = []
    for path in (out / "params_stage_1.npz", bare):
        srv = PINNServer(str(path), "annulus_laplace", device=dev)
        with http_server(srv) as base:
            answers.append(np.asarray(post(base, "/predict",
                                           pts.tolist())["u"]))
            if path != bare:
                b1_before = mlp_taylor.LAUNCHES
                f_served = np.asarray(post(base, "/residual",
                                           pts.tolist())["f"])
                b1_grew = mlp_taylor.LAUNCHES - b1_before
                compiled = srv.compiled
    z = torch.from_numpy(pts).to(dev)
    with torch.no_grad():
        want = res.predict(z)[:, 0].cpu().numpy()
        term = polish.deflation_term(defl)(z)[:, 0].cpu().numpy()
    err_u = float(np.abs(answers[0] - want).max())
    err_t = float(np.abs((answers[1] - answers[0]) - term).max())
    check(err_u <= 1e-6, f"served /predict vs the trainer's corrected "
                         f"predictor: max err {err_u}")
    check(float(np.abs(term).max()) > 0.0 and err_t <= 1e-6,
          f"uncorrected - corrected /predict vs the term: max err {err_t}, "
          f"max |term| {np.abs(term).max()}")
    print(f"  params_stage_1.npz served: /predict at 1,000 points equals the "
          f"trainer's corrected predictor (max abs difference {err_u:.2e}) "
          f"and differs from the uncorrected net by the term (max |term| "
          f"{np.abs(term).max():.3e}, max abs difference {err_t:.2e})")

    # the served residual of the corrected checkpoint.  The correction term
    # hides the net's structure from the dispatcher, so the request is
    # answered by the generic jvp engine and launches B1 no time (the count
    # is printed); it is held against the trainer's corrected predictor.
    f_want = compiled.residual_fast(lambda _, zz: res.predict(zz), None,
                                    z)[:, 0].detach().cpu().numpy()
    err_f = float(np.abs(f_served - f_want).max())
    check(f_served.shape == (1_000,) and bool(np.isfinite(f_served).all()),
          "served /residual of the corrected checkpoint: shape or values")
    check(np.allclose(f_served, f_want, rtol=RES_RTOL, atol=RES_ATOL),
          f"served /residual vs the trainer's corrected predictor: max err "
          f"{err_f}")
    print(f"  params_stage_1.npz served: /residual at 1,000 points equals the "
          f"residual of the trainer's corrected predictor (max abs difference "
          f"{err_f:.2e}, max |f| {np.abs(f_want).max():.3e}); engine: "
          f"{'kernel B1' if b1_grew else 'generic jvp'}, taylor2_fwd launches "
          f"+{b1_grew}")
    return launches


def reset_launches():
    from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp

    mlp_taylor.LAUNCHES = taylor_vjp.LAUNCHES = adam.LAUNCHES = 0


def read_launches() -> dict:
    from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp

    return {"taylor2_fwd": mlp_taylor.LAUNCHES,
            "taylor2_bwd": taylor_vjp.LAUNCHES, "adam": adam.LAUNCHES}


@contextlib.contextmanager
def lbfgs_counts():
    """Counts every L-BFGS round run inside: yields a list that gets
    (iterates, loss evaluations) per round."""
    from tpinn_torch.core import optim

    rounds = []
    inner = optim.lbfgs_minimize

    def counted(value_and_grad_fn, x0, config):
        evals = [0]

        def fn(x):
            evals[0] += 1
            return value_and_grad_fn(x)

        res = inner(fn, x0, config)
        rounds.append((res.n_iters, evals[0]))
        return res

    optim.lbfgs_minimize = counted
    try:
        yield rounds
    finally:
        optim.lbfgs_minimize = inner


@contextlib.contextmanager
def adam_launchers():
    """Records every B3 launcher (FusedAdam) the Adam phases build inside:
    yields the list, or None in a tree without the launcher (a parent
    checkout in lbfgs_compare)."""
    from tpinn_torch.kernels import adam

    inner = getattr(adam, "FusedAdam", None)
    if inner is None:
        yield None
        return
    built = []

    class Recorded(inner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.start = kwargs.get("start", 1)
            built.append(self)

    adam.FusedAdam = Recorded
    try:
        yield built
    finally:
        adam.FusedAdam = inner


def check_adam_route(what, built, launches, n_adam):
    """B3 launched once per Adam step, every launch through a launcher: the
    launchers' device steps (each starts at 1) add up to the launches."""
    check(launches == sum(n_adam),
          f"{what}: adam launched {launches} times for {sum(n_adam)} Adam "
          f"steps")
    if built is not None:
        taken = sum(x.t - 1 for x in built)
        check(len(built) == len(n_adam) and taken == launches,
              f"{what}: {len(built)} launchers took {taken} steps, B3 "
              f"launched {launches} times in {len(n_adam)} Adam phases")


def run_recipe_cut(name, dev, budgets, out_dir=SMOKE_DIR, **spec_kw):
    """get_recipe(name) with stage k's (adam_epochs, lbfgs_epochs) set to
    budgets[k] and the TrainSpec fields of ``spec_kw`` replaced, through
    run_training on the card, or for a marching recipe through
    run_time_marching over its ``march`` windows (as tpinn's CLI
    dispatches; ``budgets`` then cut every window), artifacts under
    ``out_dir``/name, with the launch counts reset before and read after.
    Returns (problem, spec, result, log lines, launches, Adam steps per
    stage and window, seconds)."""
    import dataclasses

    import torch

    from tpinn_torch import problems
    from tpinn_torch.core.train import run_training

    problem, spec = problems.get_recipe(name)
    windows = problems.RECIPES[name].march
    check(len(budgets) == len(spec.stages), f"{name}: one budget per stage")
    spec = dataclasses.replace(
        spec, stages=tuple(dataclasses.replace(st, adam_epochs=a,
                                               lbfgs_epochs=b)
                           for st, (a, b) in zip(spec.stages, budgets)),
        **spec_kw)
    out = Path(out_dir) / name
    shutil.rmtree(out, ignore_errors=True)
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    with lbfgs_counts() as rounds, adam_launchers() as built:
        if windows:
            # imported here: a checkout before marching (--p3d-repeat's
            # parent) runs the other branch only
            from tpinn_torch.core.march import run_time_marching

            res = run_time_marching(problem, spec, windows,
                                    output_dir=str(out),
                                    log_fn=lines.append, device=dev)
        else:
            res = run_training(problem, spec, output_dir=str(out),
                               log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for line in lines:
        print(f"  | {line}")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    check(len(n_adam) == len(budgets) * max(1, windows)
          and all(n >= a for n, (a, _) in zip(n_adam, budgets
                                              * max(1, windows))),
          f"{name}: Adam phases logged {n_adam} for budgets {budgets}")
    check_adam_route(name, built, launches["adam"], n_adam)
    check(res.rel_l2 is not None and math.isfinite(res.rel_l2),
          f"{name}: rel-L2 {res.rel_l2}")
    how = (f"run_time_marching(get_recipe({name!r}), {windows} windows"
           if windows else f"run_training(get_recipe({name!r})")
    print(f"  {how}, budgets {budgets}): {seconds:.1f} s, Adam steps "
          f"{n_adam}, launches {launches}, rel-L2 {res.rel_l2:.4e}")
    # where the kernel engine takes the loss, every loss evaluation
    # launches B1 and B2 once: their counts follow the L-BFGS evaluations
    print("LBFGS_COUNTS " + json.dumps({
        "recipe": name, "adam_steps": n_adam,
        "lbfgs_iterates": [it for it, _ in rounds],
        "lbfgs_evaluations": [ev for _, ev in rounds],
        "launches": launches, "rel_l2": res.rel_l2}), flush=True)
    return problem, spec, res, lines, launches, n_adam, seconds


def polish_lines(lines):
    """(pre, post, applied, seconds) of every last-layer solve logged."""
    found = [re.search(r"lsq polish objective (\S+) -> (\S+)( \(not "
                       r"applied\))? in (\S+) s", ln) for ln in lines]
    return [(float(m.group(1)), float(m.group(2)), m.group(3) is None,
             float(m.group(4))) for m in found if m]


def phase_poisson3d(dev, card, adam_epochs=P3D_ADAM, lbfgs_epochs=P3D_LBFGS,
                    tail_max=50, density_every=100, plateau_every=200):
    """The poisson_3d recipe end to end at d = 3: the step-0 gradient
    check, Adam through the kernels with the n-D sampler and density, two
    L-BFGS rounds on the 24^3 grid each followed by the last-layer solve,
    the 48^3 float64 evaluation, the checkpoint served.  The defaults cut
    the budgets; (4000, 4000, 4000, 2000, 4000) is the recipe as written.
    Returns the kernels' launch counts of the run."""
    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.kernels import mlp_taylor

    problem, spec = problems.get_recipe("poisson_3d")
    stage = spec.stages[0]
    check((stage.depth, stage.width, stage.lbfgs_grid, stage.lbfgs_rounds,
           spec.grid, spec.testing_size, spec.lsq_polish, spec.deflation)
          == (5, 64, 24, 2, 31, (48, 48, 48), "auto", "off")
          and problem.hard_bc is not None
          and spec.n_col + spec.n_band + spec.n_adaptive + 6 * spec.n_bd
          == P3D_N, "the poisson_3d recipe is not the one this phase expects")

    pred, compiled, params, data, lw = loss_setup(problem, p3d_spec(), dev,
                                                  counts=P3D_COUNTS)
    check(data["x_col"].shape == (P3D_N, 3), "poisson_3d batch shape")
    check(sorted(compiled.indices, key=lambda t: (len(t), t))
          == [(0, 0), (1, 1), (2, 2)], "poisson_3d residual indices")
    got, ref = loss_grads(pred, compiled, params, data, lw, "kernel")
    generic, _ = loss_grads(pred, compiled, params, data, lw, "generic", ref)
    err = check_grads("poisson_3d step-0 gradient, kernel vs generic engine",
                      got, generic, STEP0_RTOL, STEP0_ATOL)
    print(f"  step-0 gradient of the full loss (5x64 hard-BC, N={P3D_N}, "
          f"S=7): kernel vs generic engine max abs err {err:.3e} (rtol "
          f"{STEP0_RTOL}, atol {STEP0_ATOL})")

    _, spec, res, lines, launches, n_adam, seconds = run_recipe_cut(
        "poisson_3d", dev, [(adam_epochs, lbfgs_epochs)], tail_max=tail_max,
        density_every=density_every, plateau_every=plateau_every)
    for k, count in launches.items():
        check(count >= n_adam[0],
              f"{k} launched {count} times for {n_adam[0]} Adam steps")
    check(any(f"deterministic 24^3 grid ({P3D_GRID_N} pts)" in ln
              for ln in lines), "the L-BFGS grid is not 24^3")
    h = res.stages[0].history
    print(f"  loss {h[0, 0]:.4e} -> {h[n_adam[0] - 1, 0]:.4e} over Adam "
          f"({h[0, 0] / h[n_adam[0] - 1, 0]:.2f}x), {h[-1, 0]:.4e} after "
          f"the last L-BFGS round; "
          f"{seconds / max(1, n_adam[0]) * 1e3:.0f} ms of run per Adam step "
          f"at most, on {card}")
    check(h[n_adam[0] - 1, 0] < h[0, 0], "the Adam phase did not lower the loss")
    solves = polish_lines(lines)
    check(len(solves) == stage.lbfgs_rounds,
          f"{len(solves)} lsq polish lines for {stage.lbfgs_rounds} rounds")
    for k, (obj0, obj1, applied, secs) in enumerate(solves):
        check(obj1 <= obj0, f"round {k + 1}: lsq polish {obj0} -> {obj1}")
        print(f"  round {k + 1}: last-layer solve at d = 3 on the "
              f"{P3D_GRID_N}-point grid, objective {obj0:.4e} -> {obj1:.4e}"
              f"{'' if applied else ' (not applied)'}, {secs:.2f} s wall on "
              f"{card}")
    check(solves[0][2], "the first last-layer solve was not applied")
    # the history's last row precedes the last solve; the solve's own
    # objective (lw0 * mean r^2 on the grid) is the loss where the run ends
    check(solves[-1][1] < 0.1 * h[0, 0],
          f"loss {h[0, 0]:.3e} -> {solves[-1][1]:.3e} after the last solve: "
          f"drop < 10x")
    check(res.stages[0].U.shape == (48 ** 3, 1), "evaluation grid shape")
    print(f"  rel-L2 on the 48^3 grid {res.rel_l2:.4e} (bar {P3D_REL_L2:g} at "
          f"this budget; tpinn's TPU v5e record at 4,000 + 4,000: 8.9e-6)")
    check(res.rel_l2 <= P3D_REL_L2, f"rel-L2 {res.rel_l2} above {P3D_REL_L2}")

    # the 3-coordinate checkpoint, served
    out = SMOKE_DIR / "poisson_3d"
    check((out / "params_stage_1.npz").exists() and (out / "loss_1.npz").exists(),
          "poisson_3d checkpoint or loss history missing")
    srv = PINNServer(str(out / "params_stage_1.npz"), "poisson_3d", device=dev)
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(0.0, 1.0, (1_000, 3)).astype(np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
        before = mlp_taylor.LAUNCHES
        f = np.asarray(post(base, "/residual", pts.tolist())["f"])
        grew = mlp_taylor.LAUNCHES - before
        faces = np.asarray(post(base, "/predict", [
            [0.0, 0.3, 0.7], [1.0, 0.2, 0.9], [0.4, 0.0, 0.1],
            [0.6, 1.0, 0.5], [0.8, 0.3, 0.0], [0.1, 0.9, 1.0]])["u"])
    z = torch.from_numpy(pts).to(dev)
    with torch.no_grad():
        want = res.predict(z)[:, 0].cpu().numpy()
        f_plain = srv.compiled.evaluate(
            z, plain_partials(srv.predictor, srv.params, z,
                              srv.compiled.indices))[:, 0].cpu().numpy()
    f_train = srv.compiled.residual(res.predict, z)[:, 0].detach().cpu().numpy()
    err_u = float(np.abs(u - want).max())
    err_f = float(np.abs(f - f_plain).max())
    err_g = float(np.abs(f - f_train).max())
    scale_f = float(np.abs(f_train).max())
    check(u.shape == (1_000,) and f.shape == (1_000,)
          and bool(np.isfinite(u).all() and np.isfinite(f).all()),
          "served poisson_3d answers: shape or values")
    check(np.allclose(u, want, rtol=1e-5, atol=1e-6),
          f"served /predict vs the trainer's predictor: max err {err_u}")
    check(np.allclose(f, f_plain, rtol=RES_RTOL, atol=RES_ATOL),
          f"served /residual vs the plain version: max err {err_f}")
    # against the trainer's residual through the generic jvp engine: two
    # float32 engines on second derivatives, held relative to the field
    check(err_g <= RES_RTOL * scale_f + RES_ATOL,
          f"served /residual vs the trainer's residual: max err {err_g}, "
          f"max |f| {scale_f}")
    check(grew > 0, "served /residual at 3-coordinate points launched no kernel")
    check(float(np.abs(faces).max()) <= 1e-6,
          f"hard-BC values on the cube's faces: {np.abs(faces).max()}")
    print(f"  params_stage_1.npz served at 1,000 3-coordinate points: "
          f"/predict equals the trainer's predictor (max abs difference "
          f"{err_u:.2e}); /residual equals the plain version ({err_f:.2e}) "
          f"and the trainer's residual ({err_g:.2e}, max |f| {scale_f:.3e}), "
          f"taylor2_fwd launches +{grew}; |u| on the six faces <= "
          f"{np.abs(faces).max():.1e}")
    return launches


def phase_other_paths(dev, card):
    """The other recipes' code paths (Fourier stages, a nonlinear equation,
    a masked domain, order 3), each at a cut budget.  Returns {recipe:
    launches}."""
    import numpy as np

    cadence = dict(tail_max=20, density_every=100, plateau_every=200)
    by_path = {}

    # helmholtz_2d: Fourier features, so the generic engine by structure
    _, spec, res, lines, launches, n_adam, _ = run_recipe_cut(
        "helmholtz_2d", dev, [(100, 90), (100, 90)], **cadence)
    check(all(st.fourier_features == 64 for st in spec.stages)
          and spec.stages[1].init_from == "prev" and spec.stages[0].equation
          and spec.lw == (1e-4, 0.0) and spec.adam_precision is None,
          "the helmholtz_2d recipe is not the one this phase expects")
    check(launches["taylor2_fwd"] == 0 and launches["taylor2_bwd"] == 0,
          f"helmholtz_2d (Fourier features) launched B1/B2: {launches}")
    check(any("equation override" in ln for ln in lines)
          and any("warm start from stage 1" in ln for ln in lines),
          "helmholtz_2d: no equation override or warm start logged")
    for k, st in enumerate(res.stages):
        check(sorted(st.params) == ["fourier_b", "layers"],
              f"helmholtz_2d stage {k + 1} params {sorted(st.params)}")
        check(st.history[-1, 0] < st.history[0, 0],
              f"helmholtz_2d stage {k + 1} loss did not fall")
        print(f"  helmholtz_2d stage {k + 1}: loss {st.history[0, 0]:.4e} -> "
              f"{st.history[-1, 0]:.4e}")
    for obj0, obj1, _, _ in polish_lines(lines):
        check(obj1 <= obj0, f"helmholtz_2d lsq polish {obj0} -> {obj1}")
    print(f"  helmholtz_2d: route generic jvp (taylor2_fwd +0, taylor2_bwd "
          f"+0, adam +{launches['adam']}), {len(polish_lines(lines))} "
          f"last-layer solves on the Fourier basis, on {card}")
    by_path["helmholtz_2d"] = launches

    # burgers_1d: nonlinear, two composed stages, the Newton correction.
    # The checks below hold either outcome of the correction's own guard.
    # At 500 / 500 a stage the H100 applies it (resid_drop 0.690), but the
    # outcome flips without order between nearby budgets (declined at
    # 400 / 300 and 600 / 400, applied at 500 / 300, 400 / 400 and
    # 800 / 600), so the branch that runs moves with the last digits of
    # B1's and B2's sums
    _, spec, res, lines, launches, n_adam, _ = run_recipe_cut(
        "burgers_1d", dev, [(500, 500), (500, 500)], **cadence)
    check(sum("lsq_polish skipped (equation nonlinear in u)" in ln
              for ln in lines) == 2 and not polish_lines(lines),
          "burgers_1d: the last-layer solve was not skipped in both stages")
    check(launches["taylor2_fwd"] >= sum(n_adam)
          and launches["taylor2_bwd"] >= sum(n_adam),
          f"burgers_1d: both stages should ride B1/B2: {launches}")
    with np.load(SMOKE_DIR / "burgers_1d" / "params_stage_2.npz") as raw:
        meta = json.loads(bytes(raw["__meta__"]).decode())
    defl = meta["deflation"]
    said = [ln for ln in lines if ln.startswith("deflation='full'")]
    check(len(said) == 1, "burgers_1d: no deflation line logged")
    if defl is None:
        check("no applicable correction" in said[0], said[0])
        print(f"  burgers_1d: the correction declined by its own guard "
              f"({said[0]}); rel-L2 {res.rel_l2:.4e}")
    else:
        check(defl["kind"] == "galerkin", f"burgers_1d kind {defl['kind']}")
        print(f"  burgers_1d: correction kind {defl['kind']} (Newton step), "
              f"{len(defl['modes'])} modes, resid_drop "
              f"{defl['resid_drop']:.4e}; rel-L2 before "
              f"{defl['rel_l2_before']:.4e}, after {res.rel_l2:.4e}")
        check(res.rel_l2 <= defl["rel_l2_before"],
              f"burgers_1d: rel-L2 {defl['rel_l2_before']} -> {res.rel_l2}")
    h1 = res.stages[0].history
    check(h1[-1, 0] < 0.1 * h1[0, 0], "burgers_1d stage-1 loss drop < 10x")
    by_path["burgers_1d"] = launches

    # lshape_laplace: the masked domain; polish and deflation asked for so
    # that their skips show (the recipe leaves both off)
    problem, spec, res, lines, launches, n_adam, _ = run_recipe_cut(
        "lshape_laplace", dev, [(150, 90)], lsq_polish="auto",
        deflation="full", **cadence)
    check(problem.eval_mask is not None, "lshape_laplace has no mask")
    for text in ("lsq_polish skipped (masked non-box domain)",
                 "deflation skipped: masked non-box domain",
                 "final rel-L2 vs analytic (masked, "):
        check(any(text in ln for ln in lines), f"lshape_laplace: no {text!r}")
    h = res.stages[0].history
    check(h[-1, 0] < h[0, 0], "lshape_laplace loss did not fall")
    check(launches["taylor2_fwd"] >= n_adam[0], f"lshape_laplace: {launches}")
    print(f"  lshape_laplace: skips logged, masked rel-L2 {res.rel_l2:.4e}, "
          f"loss {h[0, 0]:.4e} -> {h[-1, 0]:.4e}")
    by_path["lshape_laplace"] = launches

    # kdv_1d: order 3, the generic engine
    _, spec, res, lines, launches, n_adam, _ = run_recipe_cut(
        "kdv_1d", dev, [(150, 90)], **cadence)
    check(launches["taylor2_fwd"] == 0 and launches["taylor2_bwd"] == 0,
          f"kdv_1d (order 3) launched B1/B2: {launches}")
    h = res.stages[0].history
    check(h[-1, 0] < h[0, 0], "kdv_1d loss did not fall")
    print(f"  kdv_1d: route generic jvp (order 3), loss {h[0, 0]:.4e} -> "
          f"{h[-1, 0]:.4e}, rel-L2 {res.rel_l2:.4e}")
    by_path["kdv_1d"] = launches
    return by_path


@contextlib.contextmanager
def window_snapshots():
    """Records a copy of every march window's parameters as its
    run_training returns them: yields the list (one list of leaves per
    window)."""
    from tpinn_torch.core import march, optim

    taken = []
    inner = march.run_training

    def recorded(*args, **kwargs):
        res = inner(*args, **kwargs)
        taken.append([x.clone() for x in
                      optim.tree_leaves(res.stages[-1].params)])
        return res

    march.run_training = recorded
    try:
        yield taken
    finally:
        march.run_training = inner


@contextlib.contextmanager
def kernel_shapes():
    """Records the shape of every B1 and B2 launch made inside: yields a
    Counter of (kernel, layer widths, streams, N)."""
    import collections

    from tpinn_torch.kernels import mlp_taylor, taylor_vjp

    seen = collections.Counter()
    fwd, bwd = mlp_taylor._launch, taylor_vjp._launch

    def b1(params, z, spec, fm, lb, ub, streams, dims):
        seen["taylor2_fwd", tuple(dims), tuple(map(tuple, streams)),
             z.shape[0]] += 1
        return fwd(params, z, spec, fm, lb, ub, streams, dims)

    def b2(layers, z, ct, spec, fm, lb, ub, streams):
        dims = (fm.num_features, *(int(x["w"].shape[1]) for x in layers))
        seen["taylor2_bwd", dims, tuple(map(tuple, streams)),
             z.shape[0]] += 1
        return bwd(layers, z, ct, spec, fm, lb, ub, streams)

    mlp_taylor._launch, taylor_vjp._launch = b1, b2
    try:
        yield seen
    finally:
        mlp_taylor._launch, taylor_vjp._launch = fwd, bwd


def held_shapes(cases) -> set:
    """The (kernel, layer widths, streams, N) that phases 3a and 3b hold
    against the plain versions for a path's ``cases`` (march_kernel_cases,
    inverse_kernel_cases)."""
    held = set()
    for _, spec, fm, _, _, streams, n, backward in cases:
        key = ((fm.num_features, *[spec.width] * spec.depth, 1),
               tuple(map(tuple, streams)), n)
        held.add(("taylor2_fwd", *key))
        if backward:
            held.add(("taylor2_bwd", *key))
    return held


def check_held(what, shapes, held):
    """Every B1/B2 launch at a shape phases 3a and 3b hold."""
    stray = sorted(set(shapes) - held)
    check(not stray, f"{what}: B1/B2 launched at shapes phases 3a and 3b "
                     f"do not hold: {stray}")
    for (k, dims, streams, n), c in sorted(shapes.items()):
        print(f"  {what}: {k} at N={n}, widths {list(dims)}, streams "
              f"{list(streams)}: {c} launches (held in phase "
              f"{'3a' if k == 'taylor2_fwd' else '3b'})")


def history_digest(h) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(h).tobytes()).hexdigest()


def check_march(name, problem, res, dev, card):
    """The composite against its windows inside their slabs, and every
    handoff target against the previous window on its plane (value, and
    for second order in t the velocity)."""
    import numpy as np
    import torch

    from tpinn_torch.core.march import axis_derivative

    ai, edges = res.axis_index, res.edges
    xi = 1 - ai
    gen = torch.Generator().manual_seed(SEED)
    worst_c = worst_h = 0.0
    for k, win in enumerate(res.windows):
        # inside slab k, and on its lower edge (an inner edge belongs to
        # the later window)
        z = torch.rand((200, 2), generator=gen, dtype=torch.float64)
        z[:, xi] = problem.lb[xi] + z[:, xi] * (problem.ub[xi]
                                                - problem.lb[xi])
        z[:, ai] = edges[k] + z[:, ai] * (edges[k + 1] - edges[k])
        z[:8, ai] = edges[k]
        z = z.to(torch.float32)
        if k + 1 < len(res.windows):
            z[:, ai].clamp_(max=np.nextafter(np.float32(edges[k + 1]),
                                             np.float32(0.0)))
        z = z.to(dev)
        with torch.no_grad():
            diff = float((res.predict(z) - win.predict(z)).abs().max())
        worst_c = max(worst_c, diff)
        check(diff <= MARCH_TOL,
              f"{name}: the composite differs from window {k + 1} inside "
              f"its slab by {diff}")
        if k == 0:
            continue
        groups = win.problem.bc_groups
        velocity = groups[-1].operator is not None
        plane = z.clone()
        plane[:, ai] = float(edges[k])
        prev = res.windows[k - 1].predict
        pairs = [(groups[-1 - velocity], prev)]
        if velocity:
            pairs.append((groups[-1], axis_derivative(prev, ai)))
        for grp, want in pairs:
            with torch.no_grad():
                diff = float((grp.target(plane) - want(plane)).abs().max())
            worst_h = max(worst_h, diff)
            check(diff <= MARCH_TOL,
                  f"{name} window {k + 1}: handoff {grp.value_expr!r} "
                  f"differs from window {k} on the plane by {diff}")
    print(f"  {name}: composite equals window k inside slab k (max abs "
          f"difference {worst_c:.2e}); every handoff target equals the "
          f"previous window on its plane ({worst_h:.2e}), on {card}")


def phase_march(dev, card):
    """The three marching recipes through run_time_marching at their full
    width and batch, each window's budgets cut (MARCH_CUTS): launch counts
    reset before each and read after (B1 and B2 in convection_1d and
    wave_1d, B1 no time in allen_cahn, B3 once per Adam step of every
    window, through the launchers), every B1 and B2 launch at a shape that
    phases 3a and 3b hold and every B3 launcher on a vector of a size that
    phase 3c holds, earlier windows bitwise unchanged with
    no gradient, the composite against its windows and the handoffs
    against the previous windows, the composite rel-L2 beside tpinn's TPU
    record, march.json served on the card (/predict against the composite,
    /residual's route), and convection_1d's first two windows run again
    with the same loss histories.  Returns {recipe: launches}."""
    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import optim
    from tpinn_torch.core.march import window_problem
    from tpinn_torch.core.train import run_training
    from tpinn_torch.kernels import mlp_taylor

    by_path = {}
    held = held_shapes(march_kernel_cases())
    for name, budget in MARCH_CUTS.items():
        rec = problems.RECIPES[name]
        problem, spec = problems.get_recipe(name)
        check(rec.march > 0 and not rec.hard_bc and len(spec.stages) == 1
              and (spec.stages[0].depth, spec.stages[0].width) == (4, 64)
              and (spec.n_col, spec.n_band, spec.n_adaptive, spec.n_bd)
              == (4096, 0, 1024, 512),
              f"the {name} recipe is not the one phase 5e expects")
        with window_snapshots() as taken, kernel_shapes() as shapes, \
                adam_launchers() as vectors:
            problem, spec, res, lines, launches, n_adam, seconds = \
                run_recipe_cut(name, dev, [budget], out_dir=SMOKE_DIR /
                               "march", **MARCH_CADENCE)
        windows = rec.march
        # every launch of the path at a shape phases 3a-3c hold against the
        # plain versions
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check(sum(c for key, c in shapes.items() if key[0] == k)
                  == launches[k], f"{name}: {k} shapes recorded for "
                                  f"{launches[k]} launches")
        check_held(name, shapes, held)
        sizes = sorted({x.p.numel() for x in vectors})
        check(len(vectors) == len(n_adam)
              and set(sizes) <= set(march_adam_sizes()),
              f"{name}: {len(vectors)} B3 launchers on vectors of {sizes}")
        print(f"  {name}: B3 on {len(vectors)} vectors of {sizes} "
              f"parameters (held in phase 3c)")
        out = SMOKE_DIR / "march" / name
        check(len(res.windows) == windows, f"{name}: {len(res.windows)} "
                                           f"windows for {windows}")
        kernel_path = name != "allen_cahn"
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check((launches[k] >= sum(n_adam)) if kernel_path
                  else launches[k] == 0,
                  f"{name}: {k} launched {launches[k]} times over "
                  f"{sum(n_adam)} Adam steps")
        # earlier windows end as their own training left them
        for k, (win, snap) in enumerate(zip(res.windows, taken)):
            leaves = optim.tree_leaves(win.stages[-1].params)
            check(len(leaves) == len(snap)
                  and all(x.grad is None and torch.equal(x, y)
                          for x, y in zip(leaves, snap)),
                  f"{name}: window {k + 1}'s parameters changed or hold a "
                  f"gradient after later windows trained")
        print(f"  {name}: {windows} windows of {budget[0]} / {budget[1]}: "
              f"{seconds:.1f} s, Adam steps {sum(n_adam)}, launches "
              f"{launches}; composite rel-L2 {res.rel_l2:.4e} (TPU record "
              f"{rec.run_tag}, {rec.march} windows at the full budget: "
              f"{rec.expected_rel_l2:g}), windows "
              + ", ".join(f"{w.rel_l2:.3e}" for w in res.windows)
              + f"; route {'kernels B1 + B2' if kernel_path else 'generic jvp'}"
              f", on {card}")
        check_march(name, problem, res, dev, card)

        # the record served on the card
        record = json.loads((out / "march.json").read_text())
        check(record["windows"] == [f"window_{k + 1}/params_stage_1.npz"
                                    for k in range(windows)]
              and record["rel_l2"] == res.rel_l2,
              f"{name}: march.json {record}")
        srv = PINNServer(str(out), name, device=dev)
        rng = np.random.default_rng(SEED)
        pts = np.stack([rng.uniform(problem.lb[0], problem.ub[0], 1_000),
                        rng.uniform(problem.lb[1], problem.ub[1], 1_000)],
                       axis=1).astype(np.float32)
        pts[:windows + 1, 1] = res.edges
        with http_server(srv) as base:
            u = np.asarray(post(base, "/predict", pts.tolist())["u"])
            before = mlp_taylor.LAUNCHES
            f = np.asarray(post(base, "/residual", pts.tolist())["f"])
            grew = mlp_taylor.LAUNCHES - before
        with torch.no_grad():
            want = res.predict(torch.from_numpy(pts).to(dev))[:, 0]
        err = float(np.abs(u - want.cpu().numpy()).max())
        check(u.shape == f.shape == (1_000,) and bool(np.isfinite(u).all()
                                                      and np.isfinite(f).all()),
              f"{name}: served answers: shape or values")
        check(err <= MARCH_TOL,
              f"{name}: served /predict vs the composite: max err {err}")
        print(f"  {name}: march.json served on the card: /predict equals "
              f"the in-process composite at 1,000 points, the edges among "
              f"them (max abs difference {err:.2e}); /residual through the "
              f"composite: route {'kernel B1' if grew else 'generic jvp'}, "
              f"taylor2_fwd launches +{grew}")
        by_path[name] = launches

        if name == "convection_1d":
            # the first two windows again: the same loss histories, bit for
            # bit (the density-weighted draws in the L-BFGS rounds)
            ai, edges = res.axis_index, res.edges
            prev = None
            for k in range(2):
                sub = window_problem(problem, ai, edges[k], edges[k + 1], k,
                                     prev)
                again = run_training(sub, spec, device=dev)
                a, b = (history_digest(r.history)
                        for r in (res.windows[k], again))
                check(a == b, f"convection_1d window {k + 1} run twice: "
                              f"loss-history digests {a[:12]} and {b[:12]}")
                print(f"  convection_1d window {k + 1} run twice: one "
                      f"loss-history digest {a[:12]} "
                      f"({len(again.history)} rows)")
                prev = again.predict
    return by_path


def run_system_counted(problem, spec, dev, out=None, inverse=None):
    """run_system on the card, its checkpoint and record under ``out``
    (when given), the launch counts reset before and read after, every
    B3 launcher recorded.  Returns (result, log lines, launches, Adam
    steps, launchers built, seconds)."""
    import torch

    from tpinn_torch.core.system import run_system

    if out is not None:
        shutil.rmtree(out, ignore_errors=True)
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    with adam_launchers() as built:
        res = run_system(problem, spec, inverse=inverse,
                         output_dir=None if out is None else str(out),
                         log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for line in lines:
        print(f"  | {line}")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    st = spec.stages[0]
    check(len(n_adam) == 1 and n_adam[0] >= st.adam_epochs,
          f"{problem.name}: Adam phases logged {n_adam} for "
          f"{st.adam_epochs} steps")
    return res, lines, launches, n_adam[0], built, seconds


def check_served_system(name, problem, res, out, dev, card):
    """The system checkpoint served by PINNServer on the card with no
    preset: /predict against the trainer's predictor (SERVE_RTOL,
    SERVE_ATOL) at 1,000 points of the box, /residual one finite column
    per equation through the generic engine (B1 no launch)."""
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.kernels import mlp_taylor

    srv = PINNServer(str(out / "params_stage_1.npz"), device=dev)
    check(srv.problem.name == problem.name,
          f"{name}: served as {srv.problem.name!r}")
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(problem.lb, problem.ub,
                      (1_000, problem.dim)).astype(np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
        before = mlp_taylor.LAUNCHES
        f = np.asarray(post(base, "/residual", pts.tolist())["f"])
        grew = mlp_taylor.LAUNCHES - before
    with torch.no_grad():
        want = res.predict(torch.from_numpy(pts).to(dev)).cpu().numpy()
    m, n_eq = len(problem.fields), len(problem.equations)
    check(u.shape == (1_000, m) and f.shape == (1_000, n_eq)
          and bool(np.isfinite(u).all() and np.isfinite(f).all()),
          f"{name}: served answers {u.shape}, {f.shape}, or not finite")
    err = float(np.abs(u - want).max())
    check(bool(np.all(np.abs(u - want) <= SERVE_ATOL
                      + SERVE_RTOL * np.abs(want))),
          f"{name}: served /predict vs the trainer's: max abs err {err}")
    check(grew == 0, f"{name}: /residual launched B1 {grew} times")
    print(f"  {name}: checkpoint served on the card with no preset: "
          f"/predict [1000, {m}] equals the trainer's predictor (max abs "
          f"difference {err:.2e}, rtol {SERVE_RTOL:g}, atol "
          f"{SERVE_ATOL:g}); /residual [1000, {n_eq}] finite, max |f| "
          f"{float(np.abs(f).max()):.3e}, generic engine (B1 +0), on {card}")


def phase_system(dev, card, cuts=SYSTEM_CUTS, repeat=True, inverse=True,
                 **spec_kw):
    """The coupled-system path: each SYSTEM_RECIPES preset through
    run_system on the card at its width and batch with the budgets of
    ``cuts`` (and SYSTEM_CADENCE, unless spec_kw replaces it): launch
    counts reset before and read after (B3 once per Adam step, tail
    included, through the launcher; B1 and B2 no time: the nets have 2 or
    3 outputs, the generic engine), every B3 vector of a size phase 3c
    holds, rel-L2 aggregate and per field finite and printed beside
    tpinn's TPU record, the checkpoint and system.json written and served
    (check_served_system); with ``repeat``, kovasznay's first
    SYSTEM_REPEAT Adam steps run twice (the same loss-history digest, and
    the main run's first rows); with ``inverse``, the inverse case
    (inverse_case) under adam_layout="tree", its 1-element coefficient
    vector through B3, w2 recovered within 1e-2.  Returns {path:
    launches}."""
    import dataclasses
    import math

    import numpy as np

    from tpinn_torch.core.system import run_system
    from tpinn_torch.problems.systems import SYSTEM_RECIPES, get_system

    by_path = {}
    held = set(system_adam_sizes())
    kw = {**SYSTEM_CADENCE, **spec_kw}
    for name, (adam_epochs, lbfgs_epochs) in cuts.items():
        rec = SYSTEM_RECIPES[name]
        problem = get_system(name)
        spec = system_spec(name, adam_epochs, lbfgs_epochs, **kw)
        out = SMOKE_DIR / "system" / name
        res, lines, launches, n_adam, built, seconds = run_system_counted(
            problem, spec, dev, out)
        check_adam_route(name, built, launches["adam"], [n_adam])
        st = spec.stages[0]
        n_pts = spec.n_col + spec.n_adaptive + spec.n_bd * len(
            problem.bc_groups)
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check(launches[k] == 0, f"{name}: {k} launched {launches[k]} "
                                    f"times on a {len(problem.fields)}-output "
                                    f"net")
        sizes = sorted({x.p.numel() for x in built})
        check(set(sizes) <= held, f"{name}: B3 on vectors of {sizes}, not "
                                  f"all held in phase 3c")
        fields = res.rel_l2_fields or ()
        check(res.rel_l2 is not None and math.isfinite(res.rel_l2)
              and len(fields) == len(problem.fields)
              and all(math.isfinite(e) for e in fields),
              f"{name}: rel-L2 {res.rel_l2}, per field {fields}")
        record = json.loads((out / "system.json").read_text())
        check(record["rel_l2"] == res.rel_l2
              and record["fields"] == list(problem.fields),
              f"{name}: system.json {record}")
        if name == "taylor_green":
            check(any("is not 3-D" in ln for ln in lines),
                  "taylor_green: no testing_size fallback logged")
        print(f"  run_system(get_system({name!r})), {st.depth}x{st.width}, "
              f"{n_pts} points a step, budgets {st.adam_epochs} / "
              f"{st.lbfgs_epochs} (recipe {rec['adam']} / {rec['lbfgs']}): "
              f"{seconds:.1f} s, Adam steps {n_adam}, launches "
              f"{launches}, B3 on vectors of {sizes} (held in phase 3c); "
              f"rel-L2 {res.rel_l2:.4e} ("
              + ", ".join(f"{f}={e:.4e}" for f, e in zip(problem.fields,
                                                         fields))
              + f"; TPU record {rec['run_tag']} at the full budget: "
              f"{rec['expected_rel_l2']:g}), on {card}")
        check_served_system(name, problem, res, out, dev, card)
        by_path[name] = launches

        if repeat and name == "kovasznay":
            # the first SYSTEM_REPEAT Adam steps twice: one history, and
            # the main run's first rows
            short = dataclasses.replace(spec, tail_max=0, stages=(
                dataclasses.replace(st, adam_epochs=SYSTEM_REPEAT,
                                    lbfgs_epochs=0),))
            hists = [run_system(problem, short, device=dev).history
                     for _ in range(2)]
            digests = [history_digest(h) for h in hists]
            main = history_digest(np.ascontiguousarray(
                res.history[:SYSTEM_REPEAT]))
            check(digests[0] == digests[1] == main,
                  f"kovasznay: {SYSTEM_REPEAT} Adam steps twice gave "
                  f"digests {digests[0][:12]}, {digests[1][:12]}; the main "
                  f"run's first rows {main[:12]}")
            print(f"  kovasznay: the first {SYSTEM_REPEAT} Adam steps run "
                  f"twice: one loss-history digest {digests[0][:12]}, the "
                  f"main run's first {SYSTEM_REPEAT} rows the same")

    if inverse:
        problem, inv, spec = inverse_case()
        res, lines, launches, n_adam, built, seconds = run_system_counted(
            problem, spec, dev, inverse=inv)
        sizes = [x.p.numel() for x in built]
        check(len(built) > 1 and launches["adam"] == n_adam * len(built)
              and all(x.t - 1 == n_adam for x in built),
              f"inverse system: B3 launched {launches['adam']} times for "
              f"{n_adam} Adam steps on {len(built)} leaves")
        check(1 in sizes and set(sizes) <= held,
              f"inverse system: B3 vectors {sizes}")
        check(launches["taylor2_fwd"] == launches["taylor2_bwd"] == 0,
              f"inverse system: launches {launches}")
        w2 = res.coef["w2"]
        err = abs(w2 - math.pi ** 2) / math.pi ** 2
        check(isinstance(w2, float) and err < 1e-2 and res.rel_l2 < 5e-3,
              f"inverse system: w2 {w2} ({err:.2e} off pi^2), rel-L2 "
              f"{res.rel_l2}")
        print(f"  inverse system (u_x - v, v_x + w2*u; adam_layout='tree'): "
              f"{seconds:.1f} s, Adam steps {n_adam}, B3 {launches['adam']}"
              f" launches on {len(built)} vectors of {sorted(sizes)} "
              f"(the coefficient's of 1 among them); recovered w2 = {w2:.6f}"
              f" (pi^2 = {math.pi ** 2:.6f}, {err:.2e} off), rel-L2 "
              f"{res.rel_l2:.4e}, on {card}")
        by_path["inverse"] = launches
    return by_path


def system_timing(dev, card):
    """Phase 6's system timings: the kovasznay Adam step at the recipe's
    width and batch (5x64, 13,600 points; the generic engine and autograd,
    then B3 through a launcher, against the same step with B3's plain
    version) and /residual of phase 5f's kovasznay checkpoint served at
    65,536 points (the generic engine); synchronised host clock, medians
    of TIMED_RUNS."""
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import net, pde, sample
    from tpinn_torch.core.system import make_system_loss
    from tpinn_torch.problems.systems import get_system

    problem = get_system("kovasznay")
    spec = system_spec("kovasznay")
    st = spec.stages[0]
    fm = net.feature_map_for(problem.feature_kinds, pad_to=spec.pad_features)
    lb = torch.tensor(problem.lb, device=dev)
    ub = torch.tensor(problem.ub, device=dev)
    mspec = net.MLPSpec(depth=st.depth, width=st.width, out_dim=3)
    params = net.init_params(torch.Generator().manual_seed(SEED), mspec, fm,
                             dev)
    pred = net.make_predictor(mspec, fm, lb, ub)
    compiled = pde.compile_system(problem.equations, problem.coords,
                                  problem.fields)
    sample_fn, grids = sample.sampler_for(
        sample.SamplerConfig(n_col=spec.n_col, n_band=0,
                             n_adaptive=spec.n_adaptive, n_bd=spec.n_bd,
                             grid=spec.grid),
        problem.bc_groups, problem.lb, problem.ub, torch.float32, dev)
    data = sample_fn(torch.Generator(device=dev).manual_seed(SEED),
                     torch.ones_like(grids[0]))
    loss_fn = make_system_loss(pred, compiled,
                               tuple(g.field for g in problem.bc_groups))
    lw = torch.tensor(spec.lw, device=dev)
    with torch.no_grad():
        ref = loss_fn(params, data, lw, torch.ones((), device=dev))[1][0]
    n = data["x_col"].shape[0]
    ms = alternating_ms({
        "b3": adam_step(loss_fn, params, data, lw, ref),
        "plain": adam_step(loss_fn, params, data, lw, ref, plain=True)})
    print(f"  Adam step, kovasznay ({st.depth}x{st.width}, 3 outputs, "
          f"{n} points, generic engine): with B3 {ms['b3']:.3f} ms, with "
          f"B3's plain version {ms['plain']:.3f} ms (synchronised host "
          f"clock, median of {TIMED_RUNS}, alternating), on {card}")
    srv = PINNServer(str(SMOKE_DIR / "system" / "kovasznay" /
                         "params_stage_1.npz"), device=dev)
    rng = np.random.default_rng(SEED)
    z = torch.from_numpy(rng.uniform(problem.lb, problem.ub, (65_536, 2))
                         .astype(np.float32)).to(dev)
    res_ms = statistics.median(
        [sync_ms(lambda: srv._residual(z)) for _ in range(3 + TIMED_RUNS)]
        [3:])
    print(f"  residual (kovasznay system checkpoint, 3 equations) N=65536: "
          f"{res_ms:.3f} ms (generic engine; synchronised host clock, "
          f"median of {TIMED_RUNS}), on {card}")
    return {"step_kovasznay": (ms["b3"], ms["plain"]),
            "residual_kovasznay_65536": res_ms}


def system_only() -> None:
    """Phases 1, 2, 3c, 5f and phase 6's system timings alone."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3c. B3 vs plain")
    phase_b3(dev)
    phase("5f. coupled systems (the system slice's path)")
    phase_system(dev, card)
    phase("6. system timing")
    system_timing(dev, card)


def system_recipe(name) -> None:
    """One system recipe as written (SYSTEM_RECIPES' budgets, TrainSpec's
    cadences) through run_system on the card, served afterwards."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase(f"5f. {name} as written")
    phase_system(dev, card, cuts={name: (None, None)}, repeat=False,
                 inverse=False, tail_max=4000, density_every=2000,
                 plateau_every=4000)


def inverse_loss_setup(dev):
    """The heat case's inverse loss at its batch, as run_inverse builds it
    (invert_spec's net and equation, the synthesized observations, one
    draw of the sampler): returns (loss of a predictor, the kernel
    predictor, its generic twin, a fresh joint tree at the start values,
    data, lw).  The twin has no structured partials, so its residual takes
    the generic engine (deriv.partials) and autograd."""
    import torch

    from tpinn_torch.core import net, pde, sample
    from tpinn_torch.core.inverse import (make_inverse_loss,
                                          synth_observations)

    problem, inv, spec = invert_spec("heat")
    mspec, fm = inverse_net(problem, spec)
    lb = torch.tensor(problem.lb, device=dev)
    ub = torch.tensor(problem.ub, device=dev)
    pred = net.make_predictor(mspec, fm, lb, ub)
    compiled = pde.compile_pde(problem.equation, problem.coords, inv.params)
    z_obs, u_obs = synth_observations(problem, inv, torch.float32, dev)
    sample_fn, grids = sample.sampler_for(
        sample.SamplerConfig(n_col=spec.n_col, n_band=spec.n_band,
                             n_adaptive=spec.n_adaptive, n_bd=spec.n_bd,
                             grid=spec.grid),
        problem.bc_groups, problem.lb, problem.ub, torch.float32, dev)
    data = sample_fn(torch.Generator(device=dev).manual_seed(SEED),
                     torch.ones_like(grids[0]))
    lw = torch.tensor(spec.lw, device=dev)

    def loss_of(p):
        return make_inverse_loss(p, compiled, z_obs, u_obs)

    def tree():
        return {"net": net.init_params(torch.Generator().manual_seed(SEED),
                                       mspec, fm, dev),
                "coef": {n: torch.tensor(v, device=dev)
                         for n, v in zip(inv.params, inv.init)}}

    return loss_of, pred, (lambda p, z: pred(p, z)), tree, data, lw


def inverse_step0(dev):
    """The heat case's inverse-loss gradient at its batch through B1/B2
    against the same loss through the generic engine, every net leaf and
    lam (STEP0_RTOL, STEP0_ATOL).  Returns the largest difference."""
    import torch

    loss_of, pred, generic, tree, data, lw = inverse_loss_setup(dev)

    def grads(p, ref=None):
        joint = tree()
        leaves = [t.requires_grad_(True) for t in leaves_of(joint["net"])]
        leaves += [t.requires_grad_(True) for t in joint["coef"].values()]
        loss_fn = loss_of(p)
        if ref is None:
            with torch.no_grad():
                ref = loss_fn(joint, data, lw,
                              torch.ones((), device=dev))[1][0]
        loss_n, _ = loss_fn(joint, data, lw, ref)
        return torch.autograd.grad(loss_n, leaves), ref

    before = read_launches()
    got, ref = grads(pred)
    generic_grads, _ = grads(generic, ref)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in read_launches().items()}
    check(grew["taylor2_fwd"] >= 1 and grew["taylor2_bwd"] == 1,
          f"inverse step 0: launches {grew}")
    err = check_grads("inverse step-0 gradient, kernel vs generic engine",
                      got, generic_grads, STEP0_RTOL, STEP0_ATOL)
    n = data["x_col"].shape[0]
    print(f"  step-0 gradient of the heat inverse loss (N={n}, "
          f"{len(got) - 1} net leaves and lam): kernel vs generic engine max "
          f"abs err {err:.3e} (rtol {STEP0_RTOL}, atol {STEP0_ATOL}); d/dlam "
          f"{float(got[-1]):.6e} against {float(generic_grads[-1]):.6e}; "
          f"launches {grew}")
    return err


def run_inverse_counted(problem, inv, spec, dev, out=None):
    """run_inverse on the card, its checkpoint, record and artifacts under
    ``out`` (when given), the launch counts reset before and read after,
    every B3 launcher and the shape of every B1 and B2 launch recorded.
    Returns (result, log lines, launches, Adam steps, launchers built,
    shapes, seconds)."""
    import torch

    from tpinn_torch.core.inverse import run_inverse

    if out is not None:
        shutil.rmtree(out, ignore_errors=True)
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    with adam_launchers() as built, kernel_shapes() as shapes:
        res = run_inverse(problem, inv, spec,
                          output_dir=None if out is None else str(out),
                          log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for line in lines:
        print(f"  | {line}")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    st = spec.stages[0]
    check(len(n_adam) == 1 and n_adam[0] >= st.adam_epochs,
          f"{problem.name}: Adam phases logged {n_adam} for "
          f"{st.adam_epochs} steps")
    for k in ("taylor2_fwd", "taylor2_bwd"):
        check(sum(c for key, c in shapes.items() if key[0] == k)
              == launches[k], f"{problem.name}: {k} shapes recorded for "
                              f"{launches[k]} launches")
        check(launches[k] >= n_adam[0],
              f"{problem.name}: {k} launched {launches[k]} times over "
              f"{n_adam[0]} Adam steps")
    return res, lines, launches, n_adam[0], built, shapes, seconds


def check_served_inverse(problem, inv, res, out, dev, card):
    """The heat checkpoint served by PINNServer on the card with no
    preset: /health's coef equal to inverse.json's, /predict within
    MARCH_TOL of the trainer's predictor, /residual through B1 (its count
    grows) against the trainer's predictor's residual at the recovered
    coefficient through the generic engine (RES_RTOL, RES_ATOL).  Returns
    the shapes of the B1 launches it made."""
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import pde
    from tpinn_torch.kernels import mlp_taylor

    record = json.loads((out / "inverse.json").read_text())
    srv = PINNServer(str(out / "params_stage_1.npz"), device=dev)
    check(srv.problem.name == problem.name
          and srv.problem.equation == problem.equation,
          f"served as {srv.problem.name!r}: {srv.problem.equation!r}")
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(problem.lb, problem.ub,
                      (INVERSE_SERVE_N, problem.dim)).astype(np.float32)
    with kernel_shapes() as shapes, http_server(srv) as base:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
        before = mlp_taylor.LAUNCHES
        f = np.asarray(post(base, "/residual", pts.tolist())["f"])
        grew = mlp_taylor.LAUNCHES - before
    check(health["coef"] == record["coef"] == res.coef,
          f"/health coef {health.get('coef')}, inverse.json "
          f"{record['coef']}, trainer {res.coef}")
    z = torch.from_numpy(pts).to(dev)
    compiled = pde.compile_pde(problem.equation, problem.coords, inv.params)
    coef = {k: torch.tensor(v, device=dev) for k, v in res.coef.items()}
    with torch.no_grad():
        want_u = res.predict(z)[:, 0].cpu().numpy()
    want_f = compiled.residual(res.predict, z, coef)[:, 0].detach()
    want_f = want_f.cpu().numpy()
    err_u = float(np.abs(u - want_u).max())
    err_f = float(np.abs(f - want_f).max())
    check(u.shape == f.shape == (INVERSE_SERVE_N,)
          and bool(np.isfinite(u).all() and np.isfinite(f).all()),
          f"served answers {u.shape}, {f.shape}, or not finite")
    check(err_u <= MARCH_TOL, f"served /predict vs the trainer's: {err_u}")
    check(grew > 0, "served /residual launched B1 no time")
    check(np.allclose(f, want_f, rtol=RES_RTOL, atol=RES_ATOL),
          f"served /residual vs the trainer's residual at the recovered "
          f"coefficient: max abs err {err_f}")
    print(f"  inverse heat: checkpoint served on the card with no preset: "
          f"/health coef {health['coef']} (inverse.json's); /predict at "
          f"{INVERSE_SERVE_N} points equals the trainer's (max abs "
          f"difference {err_u:.2e}); /residual through kernel B1 "
          f"(taylor2_fwd launches +{grew}) against the trainer's residual at "
          f"lam = {res.coef['lam']:.6f} through the generic engine: max abs "
          f"difference {err_f:.2e} (max |f| {float(np.abs(want_f).max()):.3e}),"
          f" on {card}")
    return shapes


def phase_inverse(dev, card):
    """The scalar inverse path: the step-0 gradient of the heat case's
    inverse loss (inverse_step0); the heat identification through
    run_inverse on the card at the CLI's width and batch with the budgets
    cut (INVERSE_CASES): B1 and B2 at least once per Adam step, B3 once,
    every launch through the launcher, on the flat 3,330-float vector; the
    loss drops, |lam - 1| below |0.3 - 1|, the checkpoint, inverse.json and
    the UI artifacts written and served (check_served_inverse); the same
    under adam_layout="tree" (B3 once per step per leaf, the coefficient a
    1-element vector); the eigenvalue mode (lam moves toward pi^2, mean
    u^2 beside the pin); every B1/B2 launch at a shape phases 3a and 3b
    hold and every B3 vector at a size 3c holds; the heat case's first
    INVERSE_REPEAT Adam steps twice, one loss-history digest.  Returns
    {path: launches}."""
    import dataclasses

    import numpy as np
    import torch

    from tpinn_torch.core.inverse import run_inverse

    by_path = {}
    held = held_shapes(inverse_kernel_cases())
    held_sizes = set(inverse_adam_sizes())
    inverse_step0(dev)

    # the heat identification, flat layout, written and served
    problem, inv, spec = invert_spec("heat", *INVERSE_CASES["heat"][4],
                                     **INVERSE_CADENCE)
    st = spec.stages[0]
    out = SMOKE_DIR / "inverse" / "heat"
    res, lines, launches, n_adam, built, shapes, seconds = \
        run_inverse_counted(problem, inv, spec, dev, out)
    check_adam_route("inverse heat", built, launches["adam"], [n_adam])
    sizes = sorted({x.p.numel() for x in built})
    check(sizes == [max(held_sizes)], f"inverse heat: B3 on vectors of "
                                      f"{sizes}")
    h = res.history
    check(h[n_adam - 1, 0] < h[0, 0] and h[-1, 0] < h[n_adam - 1, 0],
          f"inverse heat: loss {h[0, 0]:.4e} -> {h[n_adam - 1, 0]:.4e} (Adam)"
          f" -> {h[-1, 0]:.4e} (L-BFGS)")
    lam, lam0 = res.coef["lam"], inv.init[0]
    check(abs(lam - 1.0) < abs(lam0 - 1.0),
          f"inverse heat: lam {lam} from {lam0} (true 1)")
    record = json.loads((out / "inverse.json").read_text())
    check(record["coef"] == res.coef and record["rel_l2"] == res.rel_l2,
          f"inverse heat: inverse.json {record}")
    written = sorted(p.name for p in out.glob("*.npz"))
    check(written == sorted(["boundary_loss_1.npz", "collocation_point_1.npz",
                             "error_1.npz", "frequency_spectrum.npz",
                             "loss_1.npz", "params_stage_1.npz",
                             "solution_residual_1.npz"]),
          f"inverse heat: files written {written}")
    n_pts = (spec.n_col + spec.n_adaptive
             + spec.n_bd * len(problem.bc_groups))
    print(f"  run_inverse(heat_2d, 'u_t - lam*u_xx', lam=0.3), "
          f"{st.depth}x{st.width}, {n_pts} points a step and {inv.n_obs} "
          f"observations, budgets {st.adam_epochs} / {st.lbfgs_epochs} (CLI "
          f"4000 / 3000): {seconds:.1f} s, Adam steps {n_adam}, launches "
          f"{launches}, B3 on vectors of {sizes} (held in phase 3c); loss "
          f"{h[0, 0]:.4e} -> {h[n_adam - 1, 0]:.4e} (Adam) -> {h[-1, 0]:.4e}; "
          f"lam {res.coef_adam['lam']:.6f} after Adam, {lam:.6f} after L-BFGS "
          f"(true 1; TPU record iV1 at the full budget: 0.9976), rel-L2 "
          f"{res.rel_l2:.4e}; checkpoint, inverse.json and 5 artifacts "
          f"written, on {card}")
    by_path["heat"] = launches
    shapes = shapes + check_served_inverse(problem, inv, res, out, dev, card)
    check_held("inverse heat", shapes, held)

    # the tree layout: one B3 vector per leaf, the coefficient's of 1
    tree_spec = dataclasses.replace(spec, adam_layout="tree")
    res_t, _, launches, n_adam_t, built, shapes, seconds = \
        run_inverse_counted(problem, inv, tree_spec, dev)
    n_vec = len(leaves_of(res_t.params["net"])) + len(inv.params)
    sizes = [x.p.numel() for x in built]
    check(len(built) == n_vec and launches["adam"] == n_adam_t * n_vec
          and all(x.t - 1 == n_adam_t for x in built),
          f"inverse heat tree: B3 launched {launches['adam']} times for "
          f"{n_adam_t} Adam steps on {len(built)} vectors")
    check(1 in sizes and set(sizes) <= held_sizes,
          f"inverse heat tree: B3 vectors {sizes}")
    check_held("inverse heat tree", shapes, held)
    print(f"  inverse heat, adam_layout='tree': {seconds:.1f} s, Adam steps "
          f"{n_adam_t}, launches {launches}, B3 on {n_vec} vectors of "
          f"{sorted(sizes)} (the coefficient's of 1 among them); lam "
          f"{res_t.coef['lam']:.6f} (flat: {lam:.6f}), on {card}")
    by_path["heat_tree"] = launches

    # the eigenvalue mode
    problem_e, inv_e, spec_e = invert_spec(
        "eigen", *INVERSE_CASES["eigen"][4], **INVERSE_CADENCE)
    res_e, _, launches, n_adam_e, built, shapes, seconds = \
        run_inverse_counted(problem_e, inv_e, spec_e, dev)
    check_adam_route("inverse eigen", built, launches["adam"], [n_adam_e])
    check_held("inverse eigen", shapes, held)
    lam_e, pi2 = res_e.coef["lam"], math.pi ** 2
    check(abs(lam_e - pi2) < abs(inv_e.init[0] - pi2),
          f"inverse eigen: lam {lam_e} from {inv_e.init[0]} (pi^2 = {pi2})")
    with torch.no_grad():
        u = res_e.predict(torch.from_numpy(res_e.z_obs).to(dev))
    msq = float(torch.mean(u * u))
    check(res_e.rel_l2 is None and math.isfinite(msq),
          f"inverse eigen: rel-L2 {res_e.rel_l2}, mean u^2 {msq}")
    st_e = spec_e.stages[0]
    print(f"  run_inverse(poisson_1d, 'u_xx + lam*u', lam=8, normalize=0.5),"
          f" {st_e.depth}x{st_e.width}, budgets {st_e.adam_epochs} / "
          f"{st_e.lbfgs_epochs}: {seconds:.1f} s, Adam steps {n_adam_e}, "
          f"launches {launches}; lam {res_e.coef_adam['lam']:.6f} after Adam,"
          f" {lam_e:.6f} after L-BFGS (pi^2 = {pi2:.6f}, "
          f"{abs(lam_e - pi2) / pi2:.2e} off); mean u^2 on the {inv_e.n_obs} "
          f"pin points {msq:.6f} (pin 0.5), on {card}")
    by_path["eigen"] = launches

    # the first INVERSE_REPEAT Adam steps twice: one history, and the main
    # run's first rows
    short = dataclasses.replace(spec, tail_max=0, stages=(
        dataclasses.replace(st, adam_epochs=INVERSE_REPEAT,
                            lbfgs_epochs=0),))
    digests = [history_digest(run_inverse(problem, inv, short,
                                          device=dev).history)
               for _ in range(2)]
    main = history_digest(np.ascontiguousarray(h[:INVERSE_REPEAT]))
    check(digests[0] == digests[1] == main,
          f"inverse heat: {INVERSE_REPEAT} Adam steps twice gave digests "
          f"{digests[0][:12]}, {digests[1][:12]}; the main run's first rows "
          f"{main[:12]}")
    print(f"  inverse heat: the first {INVERSE_REPEAT} Adam steps run twice: "
          f"one loss-history digest {digests[0][:12]}, the main run's first "
          f"{INVERSE_REPEAT} rows the same")
    return by_path


def inverse_timing(dev, card):
    """Phase 6's inverse timing: the heat case's Adam step at the CLI's
    width and batch (flat layout, B3 through a launcher) with the residual
    through B1/B2 against the same step through the generic engine;
    synchronised host clock, medians of TIMED_RUNS, alternating."""
    import torch

    loss_of, pred, generic, tree, data, lw = inverse_loss_setup(dev)
    joint = tree()
    with torch.no_grad():
        ref = loss_of(pred)(joint, data, lw, torch.ones((), device=dev))[1][0]
    ms = alternating_ms({
        "kernel": adam_step(loss_of(pred), joint, data, lw, ref),
        "generic": adam_step(loss_of(generic), tree(), data, lw, ref)})
    print(f"  Adam step, heat inverse (4x32, {data['x_col'].shape[0]} points "
          f"and 200 observations, lam in the flat vector): kernel route "
          f"(B1 + B2 + B3) {ms['kernel']:.3f} ms, generic engine (with B3) "
          f"{ms['generic']:.3f} ms (synchronised host clock, median of "
          f"{TIMED_RUNS}, alternating), on {card}")
    return {"step_inverse_heat": (ms["kernel"], ms["generic"])}


def inverse_only() -> None:
    """Phases 1, 2, 3a-3c and 5g alone: the inverse path on the card."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    gen = torch.Generator().manual_seed(SEED)
    phase("3a. B1 vs plain")
    phase_kernel_vs_plain(dev, gen)
    phase("3b. B2 vs plain")
    phase_b2(dev, gen)
    phase("3c. B3 vs plain")
    phase_b3(dev)
    phase("5g. scalar inverse (the inverse slice's path)")
    phase_inverse(dev, card)
    phase("6. inverse timing")
    inverse_timing(dev, card)


def inverse_recipe() -> None:
    """`tpinn invert`'s heat-diffusivity run as the CLI writes it (budgets
    4,000 / 3,000, TrainSpec's cadences) through run_inverse on the card:
    lam, coef_adam, rel-L2 and the wall time, against |lam - 1| <
    INVERSE_BAR."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("5g. tpinn invert's heat run as written")
    problem, inv, spec = invert_spec("heat")
    res, _, launches, n_adam, built, shapes, seconds = run_inverse_counted(
        problem, inv, spec, dev, SMOKE_DIR / "inverse" / "heat_recipe")
    check_adam_route("inverse recipe", built, launches["adam"], [n_adam])
    check_held("inverse recipe", shapes, held_shapes(inverse_kernel_cases()))
    lam = res.coef["lam"]
    print("INVERSE_RECIPE " + json.dumps({
        "lam": lam, "coef_adam": res.coef_adam["lam"], "rel_l2": res.rel_l2,
        "seconds": seconds, "adam_steps": n_adam,
        "rows": int(res.history.shape[0]), "launches": launches,
        "card": card}), flush=True)
    check(abs(lam - 1.0) < INVERSE_BAR,
          f"inverse recipe: |lam - 1| = {abs(lam - 1.0):.3e} against the bar "
          f"{INVERSE_BAR}")


# ---------------------------------------------------------------------------
# Phase 5h: ensembles, overlapping patches and the reference-semantics mode
# ---------------------------------------------------------------------------


def ensemble_kernel_cases():
    """(name, spec, fm, lb, ub, streams, N, backward) of the shapes the
    ensemble path launches B1 and B2 at: each member is the flagship
    recipe's 6x80 hard-BC net, at its batch (the Adam steps) and at its
    L-BFGS grid (450^2), B1 and B2 both.  Phase 3b holds both (kernel_cases
    at RECIPE_N and RECIPE_GRID_N)."""
    from tpinn_torch.core import net

    annulus_fm = net.feature_map_for(("minmax", "periodic"))
    return [(f"annulus_laplace recipe 6x80, {what}", annulus_spec(),
             annulus_fm, (0.1, 0.0), (1.0, 2 * math.pi), IDX5, n, True)
            for what, n in (("the batch", RECIPE_N),
                            ("the L-BFGS grid", RECIPE_GRID_N))]


def patch_cli_spec(adam_epochs=8000, lbfgs_epochs=3000, **spec_kw):
    """helmholtz_2d and its TrainSpec as `python -m tpinn_torch train
    --problem helmholtz_2d --patches 6x6` builds them at the CLI's
    defaults (cli.train_spec, tpinn's CLI field for field): a 6x50 tanh
    net per patch on 3 padded features, 3,000 + 500 + 1,000 points and 100
    per BC group a step, lw (1, 0), seed 1234; the TrainSpec fields of
    ``spec_kw`` replaced."""
    import dataclasses

    from tpinn_torch import cli

    problem, spec = cli.train_spec(cli_args(
        "train", "--problem", "helmholtz_2d", "--patches",
        "x".join(map(str, PATCH_N)), "--adam", adam_epochs, "--lbfgs",
        lbfgs_epochs))
    return problem, dataclasses.replace(spec, **spec_kw)


def patch_adam_sizes():
    """The stacked vectors B3 updates on the patch path: 5h-b's 36 nets of
    6x50 on 3 features (468,036 floats) and the tests' 8 nets of 2x16
    (2,824).  Phase 3c holds them."""
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.core.patch import PatchSpec, init_patch_params

    sizes = []
    for n, depth, width in ((PATCH_N, 6, 50), ((8,), 2, 16)):
        params = init_patch_params(torch.Generator().manual_seed(SEED),
                                   net.MLPSpec(depth=depth, width=width),
                                   PatchSpec(n=n), pad_features=3)
        sizes.append(sum(t.numel() for t in leaves_of(params)))
    return sorted(sizes)


@contextlib.contextmanager
def member_launches():
    """Reads the kernels' launch counts around every ensemble member's
    run_training: yields the list that gets one dict per member."""
    from tpinn_torch.core import ensemble

    counts = []
    inner = ensemble.run_training

    def counted(*args, **kwargs):
        reset_launches()
        res = inner(*args, **kwargs)
        counts.append(read_launches())
        return res

    ensemble.run_training = counted
    try:
        yield counts
    finally:
        ensemble.run_training = inner


def adam_steps_logged(lines):
    return [int(m.group(1)) for m in
            (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]


def phase_ensemble(dev, card):
    """5h-a: get_recipe("annulus_laplace") with two members through
    run_ensemble_training at phase 5b's cut: B1 and B2 at least once per
    Adam step of each member at shapes phase 3b holds, B3 once on the
    32,801-float vector; convex weights; no member deflation; rel-L2 within
    tpinn's bar; ensemble.json served (/predict, /uncertainty, /residual).
    Returns {path: launches}."""
    import dataclasses

    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core.ensemble import run_ensemble_training
    from tpinn_torch.kernels import mlp_taylor

    problem, spec = problems.get_recipe("annulus_laplace")
    spec = dataclasses.replace(spec, tail_max=50, stages=(dataclasses.replace(
        spec.stages[0], adam_epochs=RECIPE_ADAM,
        lbfgs_epochs=RECIPE_LBFGS),))
    out = SMOKE_DIR / "ensemble"
    shutil.rmtree(out, ignore_errors=True)
    lines = []
    t0 = time.perf_counter()
    with member_launches() as counts, adam_launchers() as built, \
            kernel_shapes() as shapes:
        res = run_ensemble_training(problem, spec, n_members=ENSEMBLE_K,
                                    output_dir=str(out), log_fn=lines.append,
                                    device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in lines:
        print(f"  | {line}")
    n_adam = adam_steps_logged(lines)
    check(len(n_adam) == len(counts) == ENSEMBLE_K
          and all(n >= RECIPE_ADAM for n in n_adam),
          f"ensemble: Adam phases {n_adam}, members counted {len(counts)}")
    by_path = {}
    for i, (c, n) in enumerate(zip(counts, n_adam)):
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check(c[k] >= n, f"ensemble member {i}: {k} launched {c[k]} "
                             f"times for {n} Adam steps")
        by_path[f"ensemble_member_{i}"] = c
    check_adam_route("ensemble", built, sum(c["adam"] for c in counts),
                     n_adam)
    sizes = sorted({x.p.numel() for x in built})
    check(sizes == [ADAM_N], f"ensemble: B3 on vectors of {sizes}")
    check_held("ensemble", shapes, held_shapes(ensemble_kernel_cases()))
    w = np.asarray(res.weights)
    how = re.search(r"ensemble weights \((\S+)\)", "\n".join(lines))
    check(abs(float(w.sum()) - 1.0) <= 1e-12 and how is not None,
          f"ensemble: weights {w.tolist()} sum to {w.sum()}")
    record = json.loads((out / "ensemble.json").read_text())
    for m in record["members"]:
        with np.load(out / m) as raw:
            meta = json.loads(bytes(raw["__meta__"]).decode())
        check(meta.get("deflation") in (None, {}),
              f"ensemble: member checkpoint {m} carries a deflation")
    best = min(res.rel_l2_members)
    check(res.rel_l2 is not None and math.isfinite(res.rel_l2)
          and res.rel_l2 <= 1.5 * best,
          f"ensemble: rel-L2 {res.rel_l2} against 1.5 x the best member "
          f"{best}")
    print(f"  run_ensemble_training(get_recipe('annulus_laplace'), "
          f"n_members={ENSEMBLE_K}, budgets {RECIPE_ADAM} / {RECIPE_LBFGS}, "
          f"tail_max 50): {seconds:.1f} s, Adam steps {n_adam}, launches "
          f"per member {counts}, B3 on vectors of {sizes}; weights "
          f"({how.group(1)}) {w.tolist()} (sum - 1 = {w.sum() - 1.0:.1e}); "
          f"error correlation {res.err_correlation}; rel-L2 members "
          f"{res.rel_l2_members}, raw mean {res.rel_l2_mean_raw:.4e}, final "
          f"{res.rel_l2:.4e} (correction "
          f"{(res.deflation or {}).get('kind')}), on {card}")

    # ensemble.json served on the card
    srv = PINNServer(str(out), "annulus_laplace", device=dev)
    rng = np.random.default_rng(SEED)
    pts = np.stack([rng.uniform(0.1, 1.0, 1_000),
                    rng.uniform(0.0, 2 * np.pi, 1_000)],
                   axis=1).astype(np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
        std = np.asarray(post(base, "/uncertainty", pts.tolist())["std"])
        before = mlp_taylor.LAUNCHES
        f = np.asarray(post(base, "/residual", pts.tolist())["f"])
        grew = mlp_taylor.LAUNCHES - before
    z = torch.from_numpy(pts).to(dev)
    with torch.no_grad():
        want_u = res.predict(z)[:, 0].cpu().numpy()
    want_f = srv.compiled.residual_fast(lambda _, zz: res.predict(zz), None,
                                        z)[:, 0].detach().cpu().numpy()
    err_u = float(np.abs(u - want_u).max())
    err_f = float(np.abs(f - want_f).max())
    check(err_u <= 1e-6, f"ensemble: served /predict vs the trainer's: "
                         f"{err_u}")
    check(std.shape == (1_000,) and bool((std >= 0).all()),
          f"ensemble: /uncertainty shape {std.shape} or negative")
    check(f.shape == (1_000,) and bool(np.isfinite(f).all())
          and np.allclose(f, want_f, rtol=RES_RTOL, atol=RES_ATOL),
          f"ensemble: served /residual vs the corrected mean's: {err_f}")
    print(f"  ensemble.json served on the card: /predict at 1,000 points "
          f"equals EnsembleResult.predict (max abs difference {err_u:.2e}); "
          f"/uncertainty in [{std.min():.3e}, {std.max():.3e}]; /residual "
          f"against the corrected mean's residual_fast: max abs difference "
          f"{err_f:.2e} (max |f| {np.abs(want_f).max():.3e}), engine "
          f"{'kernel B1' if grew else 'generic jvp'} (taylor2_fwd +{grew}), "
          f"on {card}")
    return by_path


def run_patched_counted(problem, spec, dev, out=None):
    """run_patched (6x6 patches) on the card, its checkpoint and record
    under ``out`` (when given), the launch counts reset before and read
    after, every B3 launcher recorded.  Returns (result, log lines,
    launches, Adam steps, launchers built, seconds)."""
    import torch

    from tpinn_torch.core.patch import PatchSpec, run_patched

    if out is not None:
        shutil.rmtree(out, ignore_errors=True)
    lines = []
    reset_launches()
    t0 = time.perf_counter()
    with adam_launchers() as built:
        res = run_patched(problem, spec, PatchSpec(n=PATCH_N),
                          output_dir=None if out is None else str(out),
                          log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    n_adam = adam_steps_logged(lines)
    check(len(n_adam) == 1 and n_adam[0] >= spec.stages[0].adam_epochs,
          f"patched: Adam phases logged {n_adam}")
    return res, lines, launches, n_adam[0], built, seconds


def phase_patch(dev, card):
    """5h-b: patched helmholtz_2d with 6x6 patches of the CLI's 6x50 net
    (patch_cli_spec) through run_patched at the cut budget: B1 = B2 = 0, B3
    once per Adam step on the stacked vector (a size phase 3c holds); the
    loss drops; rel-L2 finite; checkpoint and patched.json written and
    served (/predict); the first PATCH_REPEAT Adam steps twice, one
    digest.  Returns {path: launches}."""
    import dataclasses

    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer

    problem, spec = patch_cli_spec(*PATCH_CUT, **PATCH_CADENCE)
    st = spec.stages[0]
    out = SMOKE_DIR / "patch"
    torch.cuda.reset_peak_memory_stats(dev)
    res, lines, launches, n_adam, built, seconds = run_patched_counted(
        problem, spec, dev, out)
    for line in lines:
        print(f"  | {line}")
    check(launches["taylor2_fwd"] == launches["taylor2_bwd"] == 0,
          f"patched: B1/B2 launched {launches} (the generic engine expected)")
    check_adam_route("patched", built, launches["adam"], [n_adam])
    sizes = sorted({x.p.numel() for x in built})
    check(sizes == [max(patch_adam_sizes())],
          f"patched: B3 on vectors of {sizes}")
    h = res.history
    check(h[n_adam - 1, 0] < h[0, 0] and h[-1, 0] <= h[n_adam, 0],
          f"patched: loss {h[0, 0]:.4e} -> {h[n_adam - 1, 0]:.4e} (Adam), "
          f"L-BFGS {h[n_adam, 0]:.4e} -> {h[-1, 0]:.4e}")
    check(res.rel_l2 is not None and math.isfinite(res.rel_l2),
          f"patched: rel-L2 {res.rel_l2}")
    written = sorted(p.name for p in out.iterdir())
    check(written == ["params_stage_1.npz", "patched.json"],
          f"patched: files written {written}")
    n_pts = spec.n_col + spec.n_band + spec.n_adaptive + 4 * spec.n_bd
    print(f"  run_patched(helmholtz_2d, PatchSpec(n={PATCH_N})), "
          f"{res.n_patches} nets of {st.depth}x{st.width}, {n_pts} "
          f"collocation and {4 * spec.n_bd} boundary points a step, budgets {st.adam_epochs} / {st.lbfgs_epochs} (CLI 8000 / "
          f"3000): {seconds:.1f} s, Adam steps {n_adam}, launches "
          f"{launches}, B3 on vectors of {sizes} (held in phase 3c); loss "
          f"{h[0, 0]:.4e} -> {h[n_adam - 1, 0]:.4e} (Adam) -> {h[-1, 0]:.4e} "
          f"(L-BFGS); rel-L2 {res.rel_l2:.4e} (no record: hP1 never ran), "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB, on {card}")

    srv = PINNServer(str(out / "params_stage_1.npz"), "helmholtz_2d",
                     device=dev)
    pts = np.random.default_rng(SEED).uniform(
        0.0, 1.0, (1_000, 2)).astype(np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
    with torch.no_grad():
        want = res.predict(torch.from_numpy(pts).to(dev))[:, 0].cpu().numpy()
    err = float(np.abs(u - want).max())
    check(err <= 1e-6, f"patched: served /predict vs the trainer's: {err}")
    print(f"  params_stage_1.npz served on the card: /predict at 1,000 points "
          f"equals PatchResult.predict (max abs difference {err:.2e})")

    short = dataclasses.replace(spec, tail_max=0, stages=(
        dataclasses.replace(st, adam_epochs=PATCH_REPEAT, lbfgs_epochs=0),))
    digests = [history_digest(run_patched_counted(problem, short, dev)[0]
                              .history) for _ in range(2)]
    main = history_digest(np.ascontiguousarray(h[:PATCH_REPEAT]))
    check(digests[0] == digests[1] == main,
          f"patched: {PATCH_REPEAT} Adam steps twice gave digests "
          f"{digests[0][:12]}, {digests[1][:12]}; the main run's first rows "
          f"{main[:12]}")
    print(f"  patched: the first {PATCH_REPEAT} Adam steps run twice: one "
          f"loss-history digest {digests[0][:12]}, the main run's first "
          f"{PATCH_REPEAT} rows the same")
    return {"patch_helmholtz_2d": launches}


def refmode_setup(dev):
    """bench.py's reference arm on the card: the soft-BC annulus, a 6x60
    float64 net, 5,200 points (bench.py's counts) in float64.  Returns
    (predictor, params, compiled, data, lw)."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import net, pde, sample

    f64 = torch.float64
    problem = problems.annulus_laplace()
    fm = net.feature_map_for(problem.feature_kinds)
    pred = net.make_predictor(annulus_spec(60), fm,
                              torch.tensor(problem.lb, dtype=f64, device=dev),
                              torch.tensor(problem.ub, dtype=f64, device=dev))
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             annulus_spec(60), fm, dev, f64)
    sample_fn, grids = sample.sampler_for(
        sample.SamplerConfig(**BENCH_COUNTS), problem.bc_groups, problem.lb,
        problem.ub, f64, dev)
    data = sample_fn(torch.Generator(device=dev).manual_seed(SEED),
                     torch.ones_like(grids[0]))
    compiled = pde.compile_pde(problem.equation, problem.coords)
    lw = torch.tensor([0.05, 0.0], dtype=f64, device=dev)
    return pred, params, compiled, data, lw


def phase_refmode(dev, card):
    """5h-c: reference_residual_polar against the generic forward engine
    in float64 on the card at bench.py's shape, and REF_STEPS reference
    Adam steps lower the loss."""
    import torch

    from tpinn_torch.core import refmode

    pred, params, compiled, data, lw = refmode_setup(dev)
    z = data["x_col"]
    f_ref = refmode.reference_residual_polar(lambda zz: pred(params, zz), z)
    with torch.no_grad():
        f_fwd = compiled.residual_fast(pred, params, z)
    err = float((f_ref - f_fwd).abs().max())
    check(f_ref.dtype == torch.float64 and bool(torch.allclose(
        f_ref, f_fwd, rtol=REF_RTOL, atol=REF_ATOL)),
          f"refmode: residual vs the forward engine, max abs err {err}")
    opt, step = refmode.make_reference_adam_step(
        refmode.make_reference_loss(pred))
    state = opt.init(params)
    one = torch.ones((), dtype=torch.float64, device=dev)
    p = params
    t0 = time.perf_counter()
    for k in range(REF_STEPS):
        p, state, info = step(p, state, data, lw, one)
        if k == 0:
            first = float(info[0])
    last = float(info[0])
    seconds = time.perf_counter() - t0
    check(last < first, f"refmode: loss {first} -> {last} over {REF_STEPS} "
                        f"steps")
    print(f"  refmode at bench.py's shape (6x60 float64, {z.shape[0]} "
          f"collocation points): reverse-over-reverse residual equals the "
          f"forward engine's (max abs difference {err:.2e}, max |f| "
          f"{float(f_fwd.abs().max()):.3e}); {REF_STEPS} reference Adam "
          f"steps: loss {first:.6e} -> {last:.6e} in {seconds:.2f} s, on "
          f"{card}")


def phase_ensemble_patch(dev, card):
    """Phase 5h: 5h-a (phase_ensemble), 5h-b (phase_patch), 5h-c
    (phase_refmode).  Returns {path: launches}."""
    by_path = phase_ensemble(dev, card)
    by_path.update(phase_patch(dev, card))
    phase_refmode(dev, card)
    for k in KERNELS:
        check(sum(by_path[f"ensemble_member_{i}"][k]
                  for i in range(ENSEMBLE_K)) > 0,
              f"{k} launched no time on the ensemble path")
    check(by_path["patch_helmholtz_2d"]["adam"] > 0,
          "adam launched no time on the patch path")
    return by_path


def ensemble_patch_timing(dev, card):
    """Phase 6's 5h timings, synchronised host clock, medians of
    TIMED_RUNS, alternating: the patched Adam step at 5h-b's shape (B3 on
    the stacked vector through a launcher, against B3's plain version);
    the reference-semantics step at bench.py's shape (float64, reverse
    over reverse, plain Adam) against the kernel-engine step at that shape
    (float32, B1 + B2 + B3)."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import loss as loss_mod
    from tpinn_torch.core import net, pde, refmode, sample
    from tpinn_torch.core.patch import (PatchSpec, init_patch_params,
                                        make_patch_predictor)

    problem, spec = patch_cli_spec()
    st = spec.stages[0]
    mspec = net.MLPSpec(depth=st.depth, width=st.width)
    pred = make_patch_predictor(mspec, PatchSpec(n=PATCH_N), problem.lb,
                                problem.ub, pad_features=3, device=dev)
    params = init_patch_params(torch.Generator().manual_seed(SEED), mspec,
                               PatchSpec(n=PATCH_N), pad_features=3,
                               device=dev)
    sample_fn, grids = sample.sampler_for(
        sample.SamplerConfig(n_col=spec.n_col, n_band=spec.n_band,
                             n_adaptive=spec.n_adaptive, n_bd=spec.n_bd,
                             grid=spec.grid),
        problem.bc_groups, problem.lb, problem.ub, torch.float32, dev)
    data = sample_fn(torch.Generator(device=dev).manual_seed(SEED),
                     torch.ones_like(grids[0]))
    loss_fn = loss_mod.make_loss(pred, pde.compile_pde(problem.equation,
                                                       problem.coords))
    lw = torch.tensor(spec.lw, device=dev)
    with torch.no_grad():
        ref = loss_fn(params, data, lw, torch.ones((), device=dev))[1][0]
    ms = alternating_ms({
        "b3": adam_step(loss_fn, params, data, lw, ref),
        "plain": adam_step(loss_fn, params, data, lw, ref, plain=True)})
    n_bd = sum(x.shape[0] for x in data["x_bd"])
    print(f"  Adam step, patched helmholtz_2d ({PATCH_N[0]}x{PATCH_N[1]} "
          f"patches of {st.depth}x{st.width}, {data['x_col'].shape[0]} "
          f"collocation and {n_bd} boundary points, generic engine): "
          f"with B3 {ms['b3']:.3f} ms, with B3's plain version "
          f"{ms['plain']:.3f} ms (synchronised host clock, median of "
          f"{TIMED_RUNS}, alternating), on {card}")
    out = {"step_patch_helmholtz_2d": (ms["b3"], ms["plain"])}
    del params, data

    pred64, p64, _, data64, lw64 = refmode_setup(dev)
    opt, ref_step = refmode.make_reference_adam_step(
        refmode.make_reference_loss(pred64))
    state = [p64, opt.init(p64)]
    one = torch.ones((), dtype=torch.float64, device=dev)

    def reference():
        state[0], state[1], _ = ref_step(state[0], state[1], data64, lw64, one)

    annulus = problems.annulus_laplace()
    kpred, compiled, kparams, kdata, klw = loss_setup(
        annulus, annulus_spec(60), dev, counts=BENCH_COUNTS)
    with torch.no_grad():
        kref = loss_mod.make_loss(kpred, compiled)(
            kparams, kdata, klw, torch.ones((), device=dev))[1][0]
    ms = alternating_ms({
        "reference": reference,
        "kernel": adam_step(loss_mod.make_loss(kpred, compiled,
                                               engine="kernel"),
                            kparams, kdata, klw, kref)})
    print(f"  Adam step at bench.py's shape (6x60 soft-BC annulus, "
          f"{kdata['x_col'].shape[0]} collocation points): reference "
          f"semantics (float64, reverse over reverse, plain Adam) "
          f"{ms['reference']:.3f} ms, kernel engine (float32, B1 + B2 + B3) "
          f"{ms['kernel']:.3f} ms (synchronised host clock, median of "
          f"{TIMED_RUNS}, alternating), on {card}")
    out["step_refmode_bench"] = (ms["reference"], ms["kernel"])
    return out


def ensemble_patch_only() -> None:
    """Phases 1, 2, 3c, 5h and its timing alone."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3c. B3 vs plain")
    phase_b3(dev)
    phase("5h. ensembles, patches, refmode")
    phase_ensemble_patch(dev, card)
    phase("6. ensemble, patch and refmode timing")
    ensemble_patch_timing(dev, card)


def patch_recipe() -> None:
    """tpinn's FBPINN case as written (tests/test_patch.py): u =
    sin(15πx) with 8 patches of 2x16 at 15,000 / 4,500 through run_patched
    on the card; prints a PATCH_RECIPE line and fails unless rel-L2 <
    PATCH_BAR."""
    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.patch import PatchSpec, run_patched
    from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("5h. tpinn's FBPINN case as written")
    w = 15 * math.pi
    problem = ProblemSpec(
        name="hf_poisson", equation=f"u_xx + {w * w}*sin({w}*x)",
        coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
                   sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0)),
        exact=lambda z: torch.sin(w * z))
    spec = TrainSpec(
        n_col=2048, n_band=0, n_adaptive=0, n_bd=32, testing_size=(512,),
        lw=(1e-5, 0.0), grid=128, pad_features=3,
        stages=(StageSpec(depth=2, width=16, scl=2.0, epsil=1.0,
                          adam_epochs=15000, lbfgs_epochs=4500),),
        log_every=5000, density_every=10**9, plateau_every=3000)
    reset_launches()
    t0 = time.perf_counter()
    res = run_patched(problem, spec, PatchSpec(n=(8,), overlap=0.5),
                      print_log=True, device=dev)
    seconds = time.perf_counter() - t0
    print("PATCH_RECIPE " + json.dumps({
        "rel_l2": res.rel_l2, "seconds": seconds,
        "rows": int(res.history.shape[0]), "launches": read_launches(),
        "card": card}), flush=True)
    check(res.rel_l2 is not None and res.rel_l2 < PATCH_BAR,
          f"patch recipe: rel-L2 {res.rel_l2} against the bar {PATCH_BAR}")


def calculator_nets():
    """The demo request's run as run_pinn_training builds it
    (train.ui_problem_spec): (problem, spec, feature map, stream plan,
    [(MLPSpec, batch) a stage]).  The stages are the 6x60 tanh net and the
    6x50 sin correction on the polar features (r, cos t, sin t); a stage's
    batch is n_col + n_band + n_adaptive + n_bd per BC group, each scaled
    by its sample_scale (5,200 and 10,400 points).  The correction's scl
    and epsil come from stage 1's errors at run time; they change no
    shape, and the specs take the demo's (about 1.7 and 0.1)."""
    from tpinn_torch.core import net, pde, taylor
    from tpinn_torch.core.train import ui_problem_spec

    problem, spec, _, _ = ui_problem_spec(**calculator_request(*CALC_CUT))
    fm = net.feature_map_for(problem.feature_kinds, pad_to=spec.pad_features)
    streams = taylor.plan_streams(
        pde.compile_pde(problem.equation, problem.coords).indices)
    stages = []
    for st in spec.stages:
        sc = st.sample_scale
        batch = (int(spec.n_col * sc) + int(spec.n_band * sc)
                 + int(spec.n_adaptive * sc)
                 + int(spec.n_bd * sc) * len(problem.bc_groups))
        stages.append((net.MLPSpec(
            depth=st.depth, width=st.width, act_first=st.act_first,
            act_hidden=st.act_hidden, scl=1.7 if st.scl is None else st.scl,
            epsil=0.1 if st.epsil is None else st.epsil), batch))
    return problem, spec, fm, streams, stages


def calculator_kernel_cases():
    """(name, spec, fm, lb, ub, streams, N, backward) of phases 3a and 3b
    for the calculator path (phase 5i, calculator_nets): each stage's net
    at its own batch (B1 and B2: the Adam steps and L-BFGS evaluations),
    the first stage's net also at the second's batch (B1: the frozen stage
    under the correction), and both nets at the density grid and the test
    grid (B1: the density refreshes, the stage diagnostics and the
    artifacts; 111^2 points each in the demo)."""
    problem, spec, fm, streams, stages = calculator_nets()
    grids = sorted({spec.grid ** problem.dim, math.prod(spec.testing_size)})
    cases = []
    for k, (mspec, batch) in enumerate(stages):
        sizes = [(batch, f"stage {k + 1}'s batch", True)]
        sizes += [(n, f"stage {j + 1}'s batch, frozen", False)
                  for j, (_, n) in enumerate(stages) if j > k]
        sizes += [(n, "the density and test grid", False) for n in grids]
        for n, what, backward in sizes:
            cases.append((f"calculator stage {k + 1} {mspec.depth}x"
                          f"{mspec.width} {mspec.act_first}, {what}", mspec,
                          fm, problem.lb, problem.ub, streams, n, backward))
    return cases


def calculator_adam_sizes():
    """The vectors B3 updates on the calculator path, a stage's parameter
    tree raveled (the flat layout): 18,601 floats for the 6x60 net on the
    3 polar features, then 31,602 for the correction's tree, which holds
    the 6x50 net (13,001) beside the frozen first stage (its gradient
    zero).  Phase 3c holds them."""
    import torch

    from tpinn_torch.core import net

    _, _, fm, _, stages = calculator_nets()
    sizes, total = [], 0
    for mspec, _ in stages:
        total += sum(t.numel() for t in leaves_of(net.init_params(
            torch.Generator().manual_seed(SEED), mspec, fm, "cpu")))
        sizes.append(total)
    return sizes


def calculator_request(adam, lbfgs, **options):
    """tpinn's __main__ demo as the calculator's page posts it (its form's
    defaults), with the first stage's budgets ``adam`` / ``lbfgs`` and the
    advanced ``options``."""
    return {
        "equation": "u_rr + 1/r*u_r + 1/r**2*u_tt",
        "boundary": {"bd_x1_min": 0.1, "bd_x1_max": 0.1, "bd_y1_min": 0,
                     "bd_y1_max": 1, "bd_u1": 1,
                     "bd_x2_min": 1, "bd_x2_max": 1, "bd_y2_min": 0,
                     "bd_y2_max": 1, "bd_u2": 0},
        "domain": {"x_min": 0.1, "x_max": 1, "y_min": 0, "y_max": 1},
        "scl": 1, "epsil": 1,
        "sample_points": {"n_col": 3000, "n_bd": 1000, "n_add": 1000},
        "network_size": {"depth": 60, "width": 6},
        "testing_size": {"x": 111, "y": 111},
        "epochs": {"adam": adam, "lbfgs": lbfgs},
        "equation_weight": {"f": 0.05, "df": 0},
        "options": options,
    }


def get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def start_session(base, session, request):
    body = json.dumps({"session": session, **request}).encode()
    req = urllib.request.Request(base + "/api/start", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        reply = json.loads(r.read())
    check(reply == {"ok": True}, f"/api/start {session}: {reply}")


def wait_session(base, session):
    """Polls /api/status until the session ends; its log lines."""
    deadline = time.monotonic() + CALC_TIMEOUT
    while True:
        st = get_json(base, f"/api/status?session={session}")
        if st["status"] in ("done", "error"):
            break
        check(time.monotonic() < deadline,
              f"session {session} still {st['status']} after "
              f"{CALC_TIMEOUT} s")
        time.sleep(0.25)
    check(st["status"] == "done", f"session {session} ended "
          f"{st['status']}: {st['error']}\n{st['log'][-3000:]}")
    return st["log"].splitlines()


def finite_payload(payload) -> bool:
    """Every number of a figure payload's data is finite."""
    import numpy as np

    arrays = [payload[k] for k in ("x", "y", "z", "z1", "z2", "points_x",
                                   "points_y") if k in payload]
    arrays += [s["y"] for s in payload.get("series", [])]
    return all(np.isfinite(np.asarray(a, dtype=np.float64)).all()
               for a in arrays)


def phase_calculator(dev, card):
    """Phase 5i: the online calculator.  The lite server with
    SessionManager(device="cuda") in a thread; the demo request at full
    width posted to /api/start and polled to done; B1/B2 at least once per
    Adam step and B3 once, through the launchers, each at a shape phases
    3a-3c hold (calculator_kernel_cases, calculator_adam_sizes); the 11
    artifacts and every figure tab; rel-L2 against the polar oracle, the
    Dirichlet columns, the error artifact, the correction's residual drop,
    and the same run through the plain derivatives.  Then two sessions
    started together (adam_precision "default" and "highest"): one waits
    for the device, each Adam phase runs under its own TF32 setting and
    the flag ends as it began.  Then `python -m tpinn_torch train --problem
    poisson_1d --device cuda` in a subprocess.  Returns the demo session's
    launches."""
    import numpy as np
    import torch

    from tpinn_torch.app import lite
    from tpinn_torch.app.controller import SessionManager
    from tpinn_torch.app.figure_data import FIGURES
    from tpinn_torch.core import train
    from tpinn_torch.utils import artifacts

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "calculator"
    shutil.rmtree(root, ignore_errors=True)
    mgr = SessionManager(str(root), device=dev)
    with http_server(mgr, lite.make_handler) as base:
        page = urllib.request.urlopen(base + "/", timeout=60).read().decode()
        check("Start Training" in page, "the calculator's page")
        req = calculator_request(*CALC_CUT)
        check(get_json(base, "/api/validate?eq=" + urllib.parse.quote(
            req["equation"]))["valid"], "the demo equation does not validate")

        held = held_shapes(calculator_kernel_cases())
        reset_launches()
        t0 = time.perf_counter()
        with adam_launchers() as built, kernel_shapes() as shapes:
            start_session(base, "demo", req)
            lines = wait_session(base, "demo")
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        for line in lines:
            print(f"  | {line}")
        n_adam = [int(m.group(1)) for m in
                  (re.search(r"Adam done \((\d+) steps", ln) for ln in lines)
                  if m]
        check(len(n_adam) == 2, f"Adam phases logged: {n_adam}")
        print(f"  demo session (6x60 then 6x50 sin, budgets {CALC_CUT} a "
              f"first stage): {seconds:.1f} s, Adam steps {n_adam}, "
              f"launches {launches}, on {card}")
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check(launches[k] >= sum(n_adam),
                  f"{k} launched {launches[k]} times for {sum(n_adam)} Adam "
                  f"steps")
        check_adam_route("calculator", built, launches["adam"], n_adam)
        # every launch of the path at a shape phases 3a-3c hold against the
        # plain versions
        for k in ("taylor2_fwd", "taylor2_bwd"):
            check(sum(c for key, c in shapes.items() if key[0] == k)
                  == launches[k], f"calculator: {k} shapes recorded for "
                                  f"{launches[k]} launches")
        check_held("calculator", shapes, held)
        sizes = [x.p.numel() for x in built]
        check(sizes == calculator_adam_sizes(),
              f"calculator: B3 launchers on vectors of {sizes}")
        print(f"  calculator: B3 on vectors of {sizes} parameters, a stage "
              f"each (held in phase 3c)")

        out = mgr.session_dir("demo")
        for name in artifacts.ARTIFACT_NAMES + ["params_stage_1.npz",
                                                "params_stage_2.npz"]:
            check((out / name).exists(), f"calculator: missing {name}")
        with np.load(out / "collocation_point_1.npz") as d:
            n_col = d["X_col"].shape[0]
            check(d["X_col"].shape[1] == 2 and n_col >= 5000,
                  f"collocation points {d['X_col'].shape}")
        for name in FIGURES:
            fig = get_json(base, f"/api/figure?session=demo&name={name}")
            want = CALC_FIGURES[name.split("_")[0]]
            check(fig["type"] == want and finite_payload(fig),
                  f"/api/figure {name}: {fig['type']} (want {want})")
        with np.load(out / "solution_residual_2.npz") as d:
            U, r = d["U"].astype(np.float64), d["r"].astype(np.float64)
        check(U.shape == (111, 111), f"U shape {U.shape}")
        exact = np.broadcast_to(np.log(r) / np.log(0.1), U.shape)
        rel = float(np.linalg.norm(U - exact) / np.linalg.norm(exact))
        logged = [float(ln.rsplit(":", 1)[1]) for ln in lines
                  if ln.startswith("final rel-L2 vs analytic")]
        check(math.isfinite(rel) and rel < 1.0 and len(logged) == 1
              and abs(rel - logged[0]) <= 1e-3 * logged[0],
              f"rel-L2 {rel} against the polar oracle, logged {logged}")
        print(f"  {len(artifacts.ARTIFACT_NAMES)} artifacts, 2 checkpoints "
              f"and {len(FIGURES)} figure payloads ({n_col:,} collocation "
              f"points a stage-1 draw); rel-L2 against u = log(r)/log(0.1) "
              f"on the 111x111 grid {rel:.4e} (logged {logged[0]:.4e})")
        calculator_gates(dev, lines, out, req, rel, card)

        # two overlapping sessions: they take turns on the device, and the
        # process-wide TF32 flag follows each Adam phase and ends as it began
        before = torch.backends.cuda.matmul.allow_tf32
        seen = []
        inner = train.adam_matmul_precision

        @contextlib.contextmanager
        def spy(name):
            with inner(name):
                seen.append((name, torch.backends.cuda.matmul.allow_tf32))
                yield

        train.adam_matmul_precision = spy
        try:
            t0 = time.perf_counter()
            pair = (("tf32", "default"), ("fp32", "highest"))
            for sid, prec in pair:
                start_session(base, sid, calculator_request(
                    *CALC_PAIR_CUT, adam_precision=prec))
            states = [get_json(base, f"/api/status?session={sid}")["status"]
                      for sid, _ in pair]
            logs = {sid: wait_session(base, sid) for sid, _ in pair}
            pair_seconds = time.perf_counter() - t0
        finally:
            train.adam_matmul_precision = inner
        waited = [sid for sid, log in logs.items()
                  if any("waiting for the device" in ln for ln in log)]
        check(states == ["running", "running"], f"pair states {states}")
        check(len(waited) == 1, f"sessions that waited: {waited}")
        check(torch.backends.cuda.matmul.allow_tf32 == before,
              "TF32 flag changed by the sessions")
        check(sorted(seen) == [("default", True)] * 2
              + [("highest", False)] * 2, f"Adam phases saw {seen}")
        check(seen[0][0] == seen[1][0] and seen[2][0] == seen[3][0],
              f"Adam phases of the two sessions interleaved: {seen}")
        print(f"  two sessions started together ({CALC_PAIR_CUT}): both "
              f"done in {pair_seconds:.1f} s, {waited[0]!r} waited for the "
              f"device; Adam phases in order {[n for n, _ in seen]} with "
              f"TF32 {[f for _, f in seen]}; allow_tf32 back at {before}")

    out = SMOKE_DIR / "cli_poisson_1d"
    shutil.rmtree(out, ignore_errors=True)
    argv = [sys.executable, "-m", "tpinn_torch", "train", "--problem",
            "poisson_1d", "--device", dev.type, "--adam", str(CALC_CLI_CUT[0]),
            "--lbfgs", str(CALC_CLI_CUT[1]), "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=CALC_TIMEOUT)
    cli_seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI run exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    check(result["problem"] == "poisson_1d" and result["steps"] > 0
          and result["rel_l2"] is not None
          and math.isfinite(result["rel_l2"])
          and (out / "params_stage_1.npz").exists(),
          f"the CLI run's result {result}")
    print(f"  python -m tpinn_torch train --problem poisson_1d --device "
          f"{dev.type} (6x50, {CALC_CLI_CUT}): {cli_seconds:.1f} s in its "
          f"own process, "
          f"{json.dumps(result)}")
    print(f"  phase 5i: {time.perf_counter() - t_phase:.1f} s, calculator "
          f"launches {launches}, on {card}")
    return launches


def calculator_gates(dev, lines, out, req, rel, card):
    """The demo's checks beyond rel-L2 (see CALC_BC_TOL): U on the two
    Dirichlet columns, the error artifact against U and the oracle, the
    residual artifact against the logged RMS, the correction stage's
    residual drop, and the request's run (train.ui_problem_spec, then
    run_training: the seed and budgets the demo's) with each kernel's
    plain version in its place against the demo's rel-L2."""
    import numpy as np
    import torch

    from tpinn_torch.core import train

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x))))

    def stage_rms(log):
        found = (re.search(r"stage (\d+): residual RMS (\S+?),?( |$)", ln)
                 for ln in log)
        return {int(m.group(1)): float(m.group(2)) for m in found if m}

    with np.load(out / "solution_residual_2.npz") as d:
        U, F, r = (d[k].astype(np.float64) for k in ("U", "F", "r"))
    with np.load(out / "error_2.npz") as d:
        E = d["Error"].astype(np.float64)
    exact = np.log(r) / np.log(0.1)
    check(abs(r[0] - 0.1) < 1e-6 and abs(r[-1] - 1.0) < 1e-6,
          f"the test grid's r runs {r[0]} .. {r[-1]}")
    bc = (rms(U[:, 0] - 1.0), rms(U[:, -1]))
    check(max(bc) <= CALC_BC_TOL, f"U on the Dirichlet columns: RMS "
          f"{bc[0]:.3e} at r = 0.1, {bc[1]:.3e} at r = 1 (bar {CALC_BC_TOL})")
    err_e = float(np.abs(E - (U - exact)).max())
    check(err_e <= 1e-5, f"error_2.npz differs from U - u_exact by {err_e}")
    r_rms = stage_rms(lines)
    check(sorted(r_rms) == [1, 2] and abs(rms(F) - r_rms[2])
          <= 1e-3 * r_rms[2], f"residual RMS logged {r_rms}, of "
          f"solution_residual_2.npz's F {rms(F)}")
    drop = r_rms[2] / r_rms[1]
    check(drop <= CALC_RESID_DROP, f"the correction stage's residual RMS "
          f"{r_rms[2]:.4e} against the first stage's {r_rms[1]:.4e}")
    print(f"  U on the Dirichlet columns: RMS {bc[0]:.4e} at r = 0.1, "
          f"{bc[1]:.4e} at r = 1 (bar {CALC_BC_TOL}); error_2.npz = U - "
          f"u_exact to {err_e:.1e}; residual RMS {r_rms[1]:.4e} -> "
          f"{r_rms[2]:.4e} (x{drop:.4f}, bar {CALC_RESID_DROP})")

    # the witness: the same run, the kernels' plain versions in their place
    problem, spec, _, _ = train.ui_problem_spec(**req)
    plain_lines = []
    reset_launches()
    t0 = time.perf_counter()
    with plain_kernels():
        res = train.run_training(problem, spec, log_fn=plain_lines.append,
                                 device=dev)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    witness = res.rel_l2
    ratio = max(rel, witness) / min(rel, witness)
    w_rms = stage_rms(plain_lines)
    print(f"  the request with the kernels' plain versions in their place "
          f"(seed and budgets the demo's): {seconds:.1f} s, rel-L2 "
          f"{witness:.4e} against the demo's {rel:.4e} (factor "
          f"{ratio:.4f}, bar {CALC_WITNESS}); residual RMS {w_rms.get(1)} "
          f"-> {w_rms.get(2)}; launches {launches}; on {card}")
    check(not any(launches.values()), f"the plain run launched {launches}")
    check(math.isfinite(witness) and ratio <= CALC_WITNESS,
          f"rel-L2 {rel:.4e} through the kernels, {witness:.4e} through "
          f"their plain versions (factor {ratio:.3f}, bar {CALC_WITNESS})")


@contextlib.contextmanager
def plain_kernels():
    """Every B1, B2 and B3 launch inside replaced by the kernel's plain
    version on the same tensors; the launch counts stay where they are."""
    from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp

    fwd, bwd, launcher = mlp_taylor._launch, taylor_vjp._launch, adam.FusedAdam

    def b1(params, z, spec, fm, lb, ub, streams, dims):
        return mlp_taylor.taylor2_streams_reference(params, z, spec, fm, lb,
                                                    ub, streams)

    def b2(layers, z, ct, spec, fm, lb, ub, streams):
        return taylor_vjp.taylor2_backward_reference(layers, z, ct, spec, fm,
                                                     lb, ub, streams)

    class PlainAdam:
        """FusedAdam's interface over adam_update_reference."""

        def __init__(self, p, m, v, lr, steps, b1=0.9, b2=0.999, eps=1e-8,
                     start=1):
            self.p, self.m, self.v, self.lr, self.t = p, m, v, lr, start
            self.consts = (b1, b2, eps)

        def step(self, g):
            adam.adam_update_reference(g, self.p, self.m, self.v, self.lr,
                                       self.t, *self.consts)
            self.t += 1
            return self.p, self.m, self.v

    mlp_taylor._launch, taylor_vjp._launch, adam.FusedAdam = b1, b2, PlainAdam
    try:
        yield
    finally:
        mlp_taylor._launch, taylor_vjp._launch, adam.FusedAdam = (fwd, bwd,
                                                                  launcher)


def calculator_only() -> None:
    """Phases 1 and 5i alone.  Nothing is built beforehand: the demo
    session's thread builds the kernels at their first use."""
    import torch

    from tpinn_torch.kernels import _build

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("5i. the online calculator")
    phase_calculator(dev, card)
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"  {name} built in the session thread in "
              f"{info['seconds']:.2f} s (cached: {info['cached']})")


def resume_kernel_cases():
    """(name, spec, fm, lb, ub, streams, N, backward) of the shapes phase
    5j launches B1 and B2 at: the flagship's 6x80 hard-BC net at its batch
    (the Adam steps) and its L-BFGS grid (450^2), B1 and B2 both, and at
    its density grid (111^2, B1: the refreshes in the resumed window).
    Phases 3a and 3b hold them."""
    from tpinn_torch.core import net

    annulus_fm = net.feature_map_for(("minmax", "periodic"))
    return [(f"annulus_laplace recipe 6x80, {what}", annulus_spec(),
             annulus_fm, (0.1, 0.0), (1.0, 2 * math.pi), IDX5, n, backward)
            for what, n, backward in (
                ("the batch", RECIPE_N, True),
                ("the L-BFGS grid", RECIPE_GRID_N, True),
                ("the density grid", RECIPE_DENSITY_N, False))]


def params_digest(params) -> str:
    import numpy as np

    return history_digest(np.concatenate(
        [x.detach().cpu().numpy().ravel() for x in leaves_of(params)]))


def resume_spec(**stage_kw):
    """The flagship recipe at phase 5j's cut (RESUME_ADAM, RESUME_LBFGS,
    RESUME_CADENCE); the StageSpec fields of ``stage_kw`` replaced."""
    import dataclasses

    from tpinn_torch import problems

    problem, spec = problems.get_recipe("annulus_laplace")
    st = dataclasses.replace(spec.stages[0], **{
        "adam_epochs": RESUME_ADAM, "lbfgs_epochs": RESUME_LBFGS,
        **stage_kw})
    return problem, dataclasses.replace(spec, stages=(st,), **RESUME_CADENCE)


def phase_resume(dev, card):
    """Phase 5j: (a) the flagship at its full width and batch through
    run_training with checkpoint_every: run A uninterrupted; run B killed
    by an exception raised right after the phase file of step RESUME_KILL
    is written, then resumed with resume=True; the two runs' loss-history
    and final-params digests equal bit for bit; B1, B2 and B3 launched in
    the resumed run at shapes phases 3a-3c hold, B3 from step RESUME_KILL +
    1 with the device step at the Adam steps + 1.  (b) One L-BFGS round
    from run A's Adam result through run_training(resume=True) with
    lbfgs_device="cpu" and with the default (the card): row 0 of the two
    histories within RESUME_LBFGS_RTOL, each final loss at most its row 0,
    the params back on the card; both timed by profiling.timed.  (c) A
    profiling.trace of PROFILE_STEPS flagship Adam steps: device operations
    a step and the device-busy share from the trace's kernel events; the
    StepTimer median (CUDA events) beside the host-clock median.  Returns
    the resumed run's launches."""
    import dataclasses

    import numpy as np
    import torch

    from tpinn_torch.core import train
    from tpinn_torch.utils import checkpoint, profiling

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "resume"
    shutil.rmtree(root, ignore_errors=True)
    problem, spec = resume_spec()
    spec = dataclasses.replace(spec, lsq_polish="off", deflation="off")
    window = range(RESUME_KILL, RESUME_ADAM)
    check(all(any(s % every == 0 for s in window) for every in (
        spec.resample_every, spec.density_every, spec.plateau_every)),
        "5j: a draw, a density refresh and a plateau check must fall in "
        "the resumed window")
    held = held_shapes(resume_kernel_cases())

    def run(out, **kw):
        lines = []
        reset_launches()
        t0 = time.perf_counter()
        with kernel_shapes() as shapes, adam_launchers() as built:
            res = train.run_training(problem, spec, output_dir=str(out),
                                     log_fn=lines.append, device=dev, **kw)
        torch.cuda.synchronize()
        return res, lines, read_launches(), shapes, built, (
            time.perf_counter() - t0)

    # (a) run A; run B killed after a mid-scan save, then resumed
    res_a, lines_a, launches_a, shapes_a, _, secs_a = run(root / "a")
    save = checkpoint.save_phase_state

    class Killed(Exception):
        pass

    def killer(path, done, state, hist, layout):
        save(path, done, state, hist, layout)
        if done >= RESUME_KILL:
            raise Killed(f"killed after the save at step {done}")

    checkpoint.save_phase_state = killer
    try:
        run(root / "b")
        check(False, "5j: run B was not killed")
    except Killed as e:
        print(f"  run B: {e}")
    finally:
        checkpoint.save_phase_state = save
    res_b, lines_b, launches, shapes_b, built, secs_b = run(root / "b",
                                                            resume=True)
    resumed = [ln for ln in lines_b if "resuming Adam mid-stage" in ln]
    check(resumed == [f"stage 1: resuming Adam mid-stage at step "
                      f"{RESUME_KILL}/{RESUME_ADAM}"],
          f"5j: the resume log line: {resumed}")
    print(f"  | {resumed[0]}")
    n_adam = adam_steps_logged(lines_b)
    check(n_adam == adam_steps_logged(lines_a) and len(n_adam) == 1,
          f"5j: Adam steps {adam_steps_logged(lines_a)} (A), {n_adam} (B)")
    digests = {k: (history_digest(r.history),
                   params_digest(r.stages[0].params))
               for k, r in (("A", res_a), ("B", res_b))}
    print(f"  run A {secs_a:.1f} s, run B resumed {secs_b:.1f} s; Adam steps "
          f"{n_adam[0]}; history digests A {digests['A'][0]} B "
          f"{digests['B'][0]}; final-params digests A {digests['A'][1]} B "
          f"{digests['B'][1]}; rel-L2 {res_a.rel_l2:.6e} / "
          f"{res_b.rel_l2:.6e}")
    check(digests["A"] == digests["B"],
          "5j: the resumed run parts from the uninterrupted one")
    steps_b = n_adam[0] - RESUME_KILL
    check(launches["adam"] == steps_b and len(built) == 1
          and built[0].start == RESUME_KILL + 1
          and built[0].t == n_adam[0] + 1,
          f"5j: B3 launched {launches['adam']} times for {steps_b} resumed "
          f"steps; launchers from {[x.start for x in built]}, device step "
          f"{[x.t for x in built]}")
    print(f"  resumed phase: B3 launcher from t = {built[0].start}, device "
          f"step {built[0].t} after it ({steps_b} resumed steps); launches "
          f"{launches} (run A {launches_a})")
    for k in ("taylor2_fwd", "taylor2_bwd"):
        check(launches[k] >= steps_b,
              f"5j: {k} launched {launches[k]} times for {steps_b} steps")
    check_held("resume", shapes_a + shapes_b, held)
    sizes = set(resume_adam_cases())
    check(all((x.p.numel(), x.start) in sizes for x in built),
          f"5j: B3 launchers at (n, start) "
          f"{[(x.p.numel(), x.start) for x in built]}, phase 3c holds "
          f"{sorted(sizes)}")

    # (b) one L-BFGS round from run A's Adam result, on the CPU and here
    spec_l = dataclasses.replace(spec, tail_max=0, stages=(
        dataclasses.replace(spec.stages[0], lbfgs_epochs=3, lbfgs_rounds=1,
                            lbfgs_grid=0),))
    rounds = {}
    for where in ("cpu", None):
        calls = [0]

        def one_round(where=where, calls=calls):
            calls[0] += 1
            out = root / f"lbfgs_{where or 'card'}_{calls[0]}"
            out.mkdir(parents=True)
            shutil.copy(root / "a" / "adam_state_stage_1.npz", out)
            lines = []
            res = train.run_training(
                problem, dataclasses.replace(spec_l, lbfgs_device=where),
                output_dir=str(out), resume=True, log_fn=lines.append,
                device=dev)
            return res, lines

        # one timed call, no warm-up: the kernels ran in (a)
        (res, lines), secs = profiling.timed(one_round, warmup=0, iters=1)
        hist = res.stages[0].history
        check(any(f"resuming Adam mid-stage at step {RESUME_ADAM}/" in ln
                  for ln in lines), "5j-b: the round did not resume from "
                                    "run A's phase file")
        check(hist.shape[0] > RESUME_ADAM + 1 and bool(np.isfinite(
            hist).all()), f"5j-b: history of shape {hist.shape}")
        row0, last = float(hist[RESUME_ADAM, 0]), float(hist[-1, 0])
        check(last <= row0, f"5j-b ({where or 'card'}): final loss {last} "
                            f"above row 0 {row0}")
        devs = {x.device.type for x in leaves_of(res.stages[0].params)}
        check(devs == {"cuda"}, f"5j-b: params returned on {devs}")
        rounds[where or "card"] = (row0, last, secs,
                                   hist.shape[0] - RESUME_ADAM - 1)
    (c0, c1, c_s, c_n), (g0, g1, g_s, g_n) = rounds["cpu"], rounds["card"]
    rel = abs(c0 - g0) / abs(g0)
    print(f"  one L-BFGS round (lbfgs_epochs 3: one iterate) on a density "
          f"draw of {RECIPE_N:,} points from run A's Adam result, "
          f"run_training(resume=True) a call (profiling.timed): "
          f"lbfgs_device='cpu' {c_s:.3f} s (loss {c0:.6e} -> {c1:.6e}, {c_n} "
          f"rows) vs on the card {g_s:.3f} s ({g0:.6e} -> {g1:.6e}, {g_n} "
          f"rows); row 0 relative difference {rel:.3e} (bar "
          f"{RESUME_LBFGS_RTOL}); {torch.get_num_threads()} CPU threads, "
          f"{card}")
    check(rel <= RESUME_LBFGS_RTOL, f"5j-b: row 0 on the CPU {c0}, on the "
                                    f"card {g0}")

    # (c) a profiler trace and StepTimer on the flagship Adam step
    profile_steps(dev, card, root / "trace")
    print(f"  phase 5j: {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def profile_steps(dev, card, logdir):
    """PROFILE_STEPS flagship Adam steps (6x80 hard BC, 46,000 points,
    kernel engine: B1 + B2 + B3) under profiling.trace: device operations
    a step (kernels, copies and sets in the trace) and the device-busy
    share, the union of their intervals over the span of the steps (an
    annotation around them, ended by a synchronisation); then
    TIMER_STEPS steps under profiling.StepTimer (CUDA events) with the
    host clock around each."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import loss as loss_mod
    from tpinn_torch.utils import profiling

    problem = problems.with_hard_bc(problems.annulus_laplace())
    pred, compiled, params, data, lw = loss_setup(problem, annulus_spec(80),
                                                  dev, counts=RECIPE_COUNTS)
    with torch.no_grad():
        ref = loss_mod.make_loss(pred, compiled)(
            params, data, lw, torch.ones((), device=dev))[1][0]
    step = adam_step(loss_mod.make_loss(pred, compiled, engine="kernel"),
                     params, data, lw, ref)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profiling.trace(str(logdir)):
        with torch.profiler.record_function("tpinn_adam_steps"):
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "tpinn_adam_steps"
            and e.get("cat") == "user_annotation"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("ph") == "X" and e.get("cat")
                    in ("kernel", "gpu_memcpy", "gpu_memset"))
    if span and device:
        lo = float(span[0]["ts"])
        hi = lo + float(span[0]["dur"])
        busy, end = 0.0, lo
        for a, b in device:
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        print(f"  profiling.trace of {PROFILE_STEPS} flagship Adam steps: "
              f"{len(device) / PROFILE_STEPS:.1f} device operations a step, "
              f"{(hi - lo) / 1e3 / PROFILE_STEPS:.3f} ms a step, device busy "
              f"{busy / 1e3 / PROFILE_STEPS:.3f} ms a step, share "
              f"{busy / (hi - lo):.4f} (trace: {logdir / 'trace.json'}), "
              f"{card}")
    else:
        print(f"  profiling.trace: {len(device)} device events, "
              f"{len(span)} step spans in the trace: device-busy share "
              f"not measured")
    timer, host = profiling.StepTimer(), []
    for _ in range(TIMER_STEPS):
        t0 = time.perf_counter()
        with timer.step() as t:
            t.observe(step())
        host.append(time.perf_counter() - t0)
    print(f"  StepTimer over {TIMER_STEPS} flagship Adam steps (CUDA "
          f"events): median {statistics.median(timer.times) * 1e3:.3f} ms, "
          f"{timer.summary()}; host clock around each step (synchronised): "
          f"median {statistics.median(host) * 1e3:.3f} ms, {card}")


def resume_only() -> None:
    """Phases 1 and 2, B3 from a resumed step (phase 3c's b3_resumed) and
    phase 5j alone."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3c. B3 from a resumed step")
    b3_resumed(dev)
    phase("5j. mid-stage resume, lbfgs_device, profiling")
    launches = phase_resume(dev, card)
    print(f"  launches of the resumed run: {launches}")


def queued_ms(fn, blocker) -> float:
    """Device time per launch of ``fn`` in a queue of QUEUED launches: the
    host enqueues them while ``blocker`` (a long kernel) still runs, so the
    two events bracket back-to-back device work, not the host calls.
    Median of five queues."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        blocker()
        a.record()
        for _ in range(QUEUED):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / QUEUED)
    return statistics.median(times)


def event_ms(fn, blocker=None) -> float:
    """Median time of ``fn`` between two CUDA events around one call,
    over TIMED_RUNS after three warm-up calls.  Without ``blocker`` the
    card is idle when the first event is recorded, so the span also holds
    the host's part of the call before its launch.  With ``blocker`` (a
    long kernel) the events are enqueued behind it and the host's part
    falls inside the blocker's run: the device time alone."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if blocker is not None:
            torch.cuda.synchronize()
            blocker()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, calls=20) -> float:
    """Host time of one call of ``fn`` that only enqueues device work:
    ``calls`` calls in a row with no synchronisation between them, the
    median over five such runs.  The launches queue up, so the card does
    not hold the host back."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, blocker) -> float:
    """Device time per launch of ``fn`` replayed from a CUDA graph that
    captured QUEUED calls of it: each replay enqueued behind ``blocker`` (a
    long kernel), between two events, so the host's part stays outside;
    median of five replays after one warm-up replay."""
    import torch

    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(QUEUED):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        blocker()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / QUEUED)
    return statistics.median(times)


def alternating_ms(fns) -> dict:
    """Median synchronised host time of each of two callables, alternated
    run by run (a, b, b, a, ...) after three warm-up calls each."""
    names = list(fns)
    for _ in range(3):
        for k in names:
            fns[k]()
    ts = {k: [] for k in names}
    for r in range(TIMED_RUNS):
        for k in (names if r % 2 == 0 else names[::-1]):
            ts[k].append(sync_ms(fns[k]))
    return {k: statistics.median(v) for k, v in ts.items()}


def adam_step(loss_fn, params, data, lw, ref, plain=False):
    """One Adam step as the flat-layout phase takes it: loss, the flat
    gradient in one autograd call, then the update in place, through the
    phase's launcher (B3) or, with ``plain``, B3's plain version."""
    import torch

    from tpinn_torch.core import optim
    from tpinn_torch.kernels import adam

    flat, unravel = optim.ravel_tree(params)
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    lr = torch.full((1,), 1e-3, device=flat.device)
    launcher = None if plain else adam.FusedAdam(flat, m, v, lr, ADAM_STEPS)
    t = [0]

    def step():
        t[0] += 1
        flat.requires_grad_(True)
        loss_n, _ = loss_fn(unravel(flat), data, lw, ref)
        (g,) = torch.autograd.grad(loss_n, flat)
        with torch.no_grad():
            if plain:
                adam.adam_update_reference(g, flat.detach(), m, v, lr, t[0])
            else:
                launcher.step(g)
        return loss_n.detach()

    return step


def b2_shapes():
    """(key, label, spec, feature kinds, lb, ub, streams, N) of the B2
    calls timed in phase 6: the raw net of the main paths under their
    hard-BC residual's stream set, at the flagship's batch and L-BFGS
    grid and at poisson_3d's."""
    annulus = (annulus_spec(), ("minmax", "periodic"), (0.1, 0.0),
               (1.0, 2 * math.pi), IDX5)
    cube = (p3d_spec(), ("minmax",) * 3, (0.0,) * 3, (1.0,) * 3, IDX7)
    return [("taylor2_bwd", "6x80 S=5, the recipe's batch", *annulus,
             RECIPE_N),
            ("taylor2_bwd_grid", "6x80 S=5, the recipe's L-BFGS grid",
             *annulus, RECIPE_GRID_N),
            ("taylor2_bwd_3d", "5x64 S=7, poisson_3d's batch", *cube, P3D_N),
            ("taylor2_bwd_3d_grid", "5x64 S=7, poisson_3d's L-BFGS grid",
             *cube, P3D_GRID_N)]


def b2_work(n, spec, n_features, d, n_streams):
    """(bytes, operations) of one B2 call on a plain net: the points and
    the cotangents read, the weights read and the gradient written once;
    2 FLOP per multiply-add of the products the function needs: X = H W
    of the hidden layers, H^T dX of every layer, dX W^T of every layer but
    the first (the points get no cotangent)."""
    w, L = spec.width, spec.depth
    n_par = n_features * w + w + (L - 1) * (w * w + w) + w + 1
    n_bytes = 4 * (n * (d + n_streams) + 2 * n_par)
    n_ops = 2 * n * n_streams * (2 * n_features * w + 3 * (L - 1) * w * w
                                 + 2 * w)
    return n_bytes, n_ops


def b2_times(dev, plain=True) -> dict:
    """{key: (kernel ms, plain ms or None)} of B2 alone at b2_shapes(),
    CUDA events, median of TIMED_RUNS.  Uses only taylor_vjp's public
    functions, so it also times another tree's B2 (b2_compare)."""
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.kernels import taylor_vjp

    out = {}
    for key, label, spec, kinds, lo, hi, streams, n in b2_shapes():
        fm = net.feature_map_for(kinds)
        gen = torch.Generator().manual_seed(SEED)
        layers = net.init_params(gen, spec, fm, dev)["layers"]
        z = box_points(gen, n, lo, hi, dev)
        ct = torch.randn((n, len(streams)), generator=gen).to(dev)
        args = (layers, z, ct, spec, fm, lo, hi, streams)
        k_ms = event_ms(lambda: taylor_vjp.taylor2_backward(*args))
        p_ms = (event_ms(lambda: taylor_vjp.taylor2_backward_reference(*args))
                if plain else None)
        out[key] = (k_ms, p_ms)
        print(f"  taylor2_bwd alone, {label} (N={n}): kernel {k_ms:.4f} ms"
              + (f", plain {p_ms:.4f} ms" if plain else "")
              + f" (CUDA events, median of {TIMED_RUNS})", flush=True)
    return out


def b1_shapes():
    """(key, label, spec, feature kinds, lb, ub, streams, N) of the B1
    calls timed in phase 6: the served 6x80 annulus net at 262,144 points,
    the flagship's raw net at its batch and L-BFGS grid, poisson_3d's at
    its batch and L-BFGS grid, each under its residual's stream set."""
    annulus = (annulus_spec(), ("minmax", "periodic"), (0.1, 0.0),
               (1.0, 2 * math.pi), IDX5)
    cube = (p3d_spec(), ("minmax",) * 3, (0.0,) * 3, (1.0,) * 3, IDX7)
    return [("taylor2_fwd", "6x80 S=5, served", *annulus, 262_144),
            ("taylor2_fwd_batch", "6x80 S=5, the recipe's batch", *annulus,
             RECIPE_N),
            ("taylor2_fwd_grid", "6x80 S=5, the recipe's L-BFGS grid",
             *annulus, RECIPE_GRID_N),
            ("taylor2_fwd_3d", "5x64 S=7, poisson_3d's batch", *cube, P3D_N),
            ("taylor2_fwd_3d_grid", "5x64 S=7, poisson_3d's L-BFGS grid",
             *cube, P3D_GRID_N)]


def b1_work(n, spec, n_features, d, n_streams):
    """(bytes, operations) of one B1 call on a plain net: the points read,
    the weights read and [N, S] written once; 2 FLOP per multiply-add of
    every layer's product on every stream."""
    w, L = spec.width, spec.depth
    n_par = n_features * w + w + (L - 1) * (w * w + w) + w + 1
    n_bytes = 4 * (n * (d + n_streams) + n_par)
    n_ops = 2 * n * n_streams * (n_features * w + (L - 1) * w * w + w)
    return n_bytes, n_ops


def b1_times(dev, plain=True, save=None) -> dict:
    """{key: (kernel ms, plain ms or None, {"device_ms", "host_ms"})} of
    B1 alone at b1_shapes(): CUDA events around one call (event_ms, the
    host's part of the call included, as phase 6 times every kernel), the
    device time alone (event_ms behind a long kernel) and the host's time
    per call (host_ms).  Uses only mlp_taylor's public functions, so it
    also times another tree's B1 (b1_compare); ``save``, a path, keeps
    the kernel's outputs there."""
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.kernels import mlp_taylor

    big = torch.randn((2048, 2048), device=dev)
    blocker = lambda: torch.matmul(big, big)
    out, outputs = {}, {}
    for key, label, spec, kinds, lo, hi, streams, n in b1_shapes():
        fm = net.feature_map_for(kinds)
        gen = torch.Generator().manual_seed(SEED)
        params = net.init_params(gen, spec, fm, dev)
        z = box_points(gen, n, lo, hi, dev)
        args = (params, z, spec, fm, lo, hi, streams)
        outputs[key] = mlp_taylor.taylor2_streams(*args).cpu()
        kernel = lambda: mlp_taylor.taylor2_streams(*args)
        k_ms = event_ms(kernel)
        p_ms = (event_ms(lambda: mlp_taylor.taylor2_streams_reference(*args))
                if plain else None)
        extra = {"device_ms": event_ms(kernel, blocker),
                 "host_ms": host_ms(kernel)}
        out[key] = (k_ms, p_ms, extra)
        print(f"  taylor2_fwd alone, {label} (N={n}): kernel {k_ms:.4f} ms "
              f"around the call, {extra['device_ms']:.4f} ms on the device, "
              f"{extra['host_ms']:.4f} ms of host a call"
              + (f"; plain {p_ms:.4f} ms" if plain else "")
              + f" (CUDA events, medians of {TIMED_RUNS})", flush=True)
    if save is not None:
        Path(save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, save)
    return out


@contextlib.contextmanager
def b1_plan(plan):
    """Every B1 launch inside the block runs under ``plan`` instead of the
    plan mlp_taylor.tiling chooses."""
    from tpinn_torch.kernels import mlp_taylor

    tiling = mlp_taylor.tiling
    mlp_taylor.tiling = lambda *_: plan
    mlp_taylor._static_args.cache_clear()
    try:
        yield
    finally:
        mlp_taylor.tiling = tiling
        mlp_taylor._static_args.cache_clear()


def b1_mode_times(dev) -> list:
    """B1's device time under its own plan and under the same plan with W
    read through L1 ("l1"), for phase 3a's nets that cannot keep W
    resident and for the flagship's 6x80 net at its batch (W resident):
    what staging W in shared memory buys at each.  event_ms behind a long
    kernel; the largest difference between the two outputs."""
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.kernels import mlp_taylor

    big = torch.randn((2048, 2048), device=dev)
    blocker = lambda: torch.matmul(big, big)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, label, spec, kinds, lo, hi, streams, n = b1_shapes()[1]
    cases = [(f"annulus {label}", spec, net.feature_map_for(kinds), lo, hi,
              streams, n)] + b1_mode_cases()
    rows = []
    for name, spec, fm, lo, hi, streams, n in cases:
        dims = [fm.num_features] + [spec.width] * spec.depth + [1]
        S = len(streams)
        plan = mlp_taylor.tiling(dims, S, n, sms)
        if plan.w_mode == "l1":
            continue
        l1 = plan._replace(w_mode="l1", kc=0, smem_bytes=mlp_taylor.smem_bytes(
            S, plan.tp, 0, plan.ks))
        gen = torch.Generator().manual_seed(SEED)
        params = net.init_params(gen, spec, fm, dev)
        z = box_points(gen, n, lo, hi, dev)
        kernel = lambda: mlp_taylor.taylor2_streams(params, z, spec, fm, lo,
                                                    hi, streams)
        ms, got = {}, {}
        for which in (plan, l1, l1, plan):
            with b1_plan(which):
                got[which.w_mode] = kernel()
                ms.setdefault(which.w_mode, []).append(
                    event_ms(kernel, blocker))
        diff = (got[plan.w_mode] - got["l1"]).abs().max().item()
        row = {"case": name, "N": n, "S": S, "plan": plan._asdict(),
               "ms": statistics.mean(ms[plan.w_mode]),
               "l1_ms": statistics.mean(ms["l1"])}
        rows.append(row)
        print(f"  B1 W modes, {name} (N={n}, S={S}): {plan.w_mode} "
              f"{ms[plan.w_mode][0]:.4f}, {ms[plan.w_mode][1]:.4f} ms, l1 "
              f"{ms['l1'][0]:.4f}, {ms['l1'][1]:.4f} ms on the device: "
              f"{row['ms'] / row['l1_ms']:.3f}x; max |difference| "
              f"{diff:.3e}; plan {plan}", flush=True)
    return rows


# the head of a run in another checkout (in_trees): this file loaded as a
# module ``s`` with the checkout's tpinn_torch first on the path
_IN_TREE = "\n".join([
    "import importlib.util, json, sys, torch",
    "tree, smoke, run = sys.argv[1], sys.argv[2], int(sys.argv[3])",
    "sys.path.insert(0, tree)",
    "spec = importlib.util.spec_from_file_location('smoke', smoke)",
    "s = importlib.util.module_from_spec(spec)",
    "spec.loader.exec_module(s)",
    "torch.backends.cuda.matmul.allow_tf32 = False",
    "torch.backends.cudnn.allow_tf32 = False",
    "torch.set_float32_matmul_precision('highest')",
    "dev = torch.device('cuda', 0)"])


def in_trees(trees, body) -> list:
    """Runs the Python lines ``body`` after _IN_TREE once per checkout in
    ``trees``, in that order, one process each, on one card (``run`` is
    the index of the run); echoes and returns each run's output."""
    print(f"  card: {card_line()}")
    code = "\n".join([_IN_TREE, *body])
    outs = []
    for run, tree in enumerate(trees):
        proc = subprocess.run(
            [sys.executable, "-c", code, tree, str(ROOT / "chip_smoke.py"),
             str(run)], cwd=tree, capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            raise RuntimeError(f"the run in {tree} failed")
        outs.append(proc.stdout)
    return outs


def b1_compare(parent: str) -> None:
    """B1 alone at b1_shapes() in this tree and in another checkout
    (``parent``, e.g. a git archive of the parent commit), in the order
    parent, this, this, parent; one B1_TIMES JSON line per run, then per
    shape this tree's mean time over the parent's around the call (the
    measure of phase 6), on the device alone and in host time per call,
    and the largest difference between the two trees' outputs (and
    within each tree)."""
    import torch

    here, there = str(ROOT), str(Path(parent).resolve())
    saved = ROOT / "build" / "b1_compare"
    outs = in_trees((there, here, here, there), [
        "from tpinn_torch.kernels import mlp_taylor",
        f"t = s.b1_times(dev, plain=False, save='{saved}/run%d.pt' % run)",
        "sms = torch.cuda.get_device_properties(dev).multi_processor_count",
        "plans = [str(mlp_taylor.tiling([3] + [sp.width] * sp.depth + [1], "
        "len(st), n, sms)) if hasattr(mlp_taylor, 'Plan') else None "
        "for _, _, sp, _, _, _, st, n in s.b1_shapes()]",
        "print('B1_TIMES ' + json.dumps({'tree': tree, 'plans': plans, "
        "'ms': {k: {'ms': v[0], **v[2]} for k, v in t.items()}}))"])
    ms = [json.loads(line.split(" ", 1)[1])["ms"] for out in outs
          for line in out.splitlines() if line.startswith("B1_TIMES ")]
    res = [torch.load(saved / f"run{r}.pt") for r in range(4)]
    for key, label, *_, n in b1_shapes():
        parts = []
        for what, field in (("around the call", "ms"),
                            ("on the device", "device_ms"),
                            ("host a call", "host_ms")):
            t = [m[key][field] for m in ms]
            parts.append(f"{what} this tree {t[1]:.4f}, {t[2]:.4f} ms, the "
                         f"parent {t[0]:.4f}, {t[3]:.4f} ms: "
                         f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}x")
        scale = res[0][key].abs().max().item()
        diff = (res[1][key] - res[0][key]).abs().max().item()
        same = max((res[1][key] - res[2][key]).abs().max().item(),
                   (res[0][key] - res[3][key]).abs().max().item())
        print(f"  B1 {label} (N={n}): " + "; ".join(parts)
              + f"; max |this - parent| {diff:.3e} on max |out| {scale:.4e}, "
              f"within a tree {same:.1e}")
    print("B1_COMPARE " + json.dumps({"ms": ms}))


def b2_compare(parent: str) -> None:
    """B2 alone at b2_shapes() in this tree and in another checkout
    (``parent``, e.g. a git archive of the parent commit), in the order
    parent, this, this, parent; one JSON line per run."""
    here, there = str(ROOT), str(Path(parent).resolve())
    in_trees((there, here, here, there), [
        "from tpinn_torch.kernels import taylor_vjp",
        "t = s.b2_times(dev, plain=False)",
        "plans = [str(taylor_vjp.tiling([3] + [sp.width] * sp.depth + [1], "
        "len(st), n)) if hasattr(taylor_vjp, 'Plan') else None "
        "for _, _, sp, _, _, _, st, n in s.b2_shapes()]",
        "print('B2_TIMES ' + json.dumps({'tree': tree, 'plans': plans, "
        "'ms': {k: v[0] for k, v in t.items()}}))"])


def b3_compare(parent: str) -> None:
    """B3 alone (b3_times) in this tree and in another checkout
    (``parent``, e.g. a git archive of the parent commit), in the order
    parent, this, this, parent, one process each; per measure this tree's
    mean over the parent's and each run's torch._fused_adam_, then the
    largest difference between the two trees' p, m and v after
    ADAM_STEPS steps (b3_run)."""
    import torch

    here, there = str(ROOT), str(Path(parent).resolve())
    saved = ROOT / "build" / "b3_compare"
    outs = in_trees((there, here, here, there), [
        f"t = s.b3_times(dev, save='{saved}/run%d.pt' % run)",
        "print('B3_TIMES ' + json.dumps({'tree': tree, 'ms': t}))"])
    ms = [json.loads(line.split(" ", 1)[1])["ms"] for out in outs
          for line in out.splitlines() if line.startswith("B3_TIMES ")]
    res = [torch.load(saved / f"run{r}.pt") for r in range(4)]
    for what, key in (("around the call", "ms"), ("host a call", "host_ms"),
                      ("on the device, queued", "device_ms"),
                      ("replayed from a graph", "graph_ms")):
        t = [m[key] for m in ms]
        lib = [m["library_" + key] for m in ms]
        us = lambda x: f"{x * 1e3:.2f}" if x is not None else "-"
        ratio = (f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}x" if None not in t
                 else "-")
        print(f"  B3 {what}: this tree {us(t[1])}, {us(t[2])} us, the parent "
              f"{us(t[0])}, {us(t[3])} us: {ratio}; torch._fused_adam_ "
              f"{', '.join(us(x) for x in lib)} us in the same four runs; "
              f"this tree's B3 no slower than the library in both its runs: "
              f"{all(t[r] <= lib[r] for r in (1, 2))}")
    diff = max((a - b).abs().max().item() for a, b in zip(res[1], res[0]))
    same = max((a - b).abs().max().item() for r, s in ((1, 2), (0, 3))
               for a, b in zip(res[r], res[s]))
    print(f"  B3 after {ADAM_STEPS} steps (n={ADAM_N}, lr halved at the "
          f"midpoint): max |this - parent| {diff:.3e} over p, m, v, within "
          f"a tree {same:.1e}")
    print("B3_COMPARE " + json.dumps({"ms": ms, "max_diff": diff}))


def timing_compare(parent: str) -> None:
    """Phase 6's end-to-end timings in another checkout (``parent``) and
    in this tree, in the order parent, this, this, parent, one process
    each: the residual of the served 6x80 checkpoint through B1
    (phase_timing) and the Adam step with the kernel and the plain
    engines (adam_step_times); one TIMING JSON line per run, then per
    timing this tree's mean over the parent's."""
    here, there = str(ROOT), str(Path(parent).resolve())
    outs = in_trees((there, here, here, there), [
        "from tpinn_torch.app.serve import PINNServer",
        "from tpinn_torch.kernels import _build",
        "_build.load_all(s.KERNELS)",
        "gen = torch.Generator().manual_seed(s.SEED)",
        "name, path = s.write_checkpoints(gen)[0]",
        "srv = PINNServer(str(path), 'annulus_laplace', device=dev)",
        "t = s.phase_timing(dev, gen, [(name, srv)])",
        "t.update(s.adam_step_times(dev))",
        "print('TIMING ' + json.dumps({'tree': tree, 'ms': t}))"])
    ms = [json.loads(line.split(" ", 1)[1])["ms"] for out in outs
          for line in out.splitlines() if line.startswith("TIMING ")]
    for key in ms[0]:
        for i, engine in enumerate(("kernel", "plain")):
            t = [m[key][i] for m in ms]
            print(f"  {key}, {engine}: this tree {t[1]:.3f}, {t[2]:.3f} ms, "
                  f"the parent {t[0]:.3f}, {t[3]:.3f} ms: "
                  f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}x")
    print("TIMING_COMPARE " + json.dumps({"ms": ms}))


def lbfgs_compare(parent: str) -> None:
    """Phases 5b and 5c in another checkout (``parent``) and in this tree,
    in that order: their LBFGS_COUNTS lines give the kernels' launches
    beside the Adam steps and the L-BFGS iterates and evaluations."""
    in_trees((str(Path(parent).resolve()), str(ROOT)), [
        "from tpinn_torch.kernels import _build",
        "_build.load_all(s.KERNELS)",
        "s.phase_recipe(dev, s.card_line())",
        "s.phase_poisson3d(dev, s.card_line())"])


def p3d_runs(dev, runs: int, tag: str) -> None:
    """Phase 5c's training (the poisson_3d recipe at phase 5c's cut, no
    serving) ``runs`` times in this process, for p3d_repeat: one P3D_RUN
    line per run with rel-L2 to all digits, the L-BFGS evaluations, the
    launches, the device step of every B3 launcher (read after the run;
    a block whose slot fell behind, or a flagged slot, raises, and the
    run reports the error) and the SHA-1 of the loss history (a row per
    Adam step and per L-BFGS record), which is kept under build/."""
    import numpy as np

    saved = ROOT / "build" / "p3d_repeat"
    saved.mkdir(parents=True, exist_ok=True)
    for k in range(runs):
        row = {"tag": tag, "run": k}
        try:
            with adam_launchers() as built:
                _, _, res, _, launches, n_adam, seconds = run_recipe_cut(
                    "poisson_3d", dev, [(P3D_ADAM, P3D_LBFGS)],
                    out_dir=saved / f"{tag}_out", tail_max=50,
                    density_every=100, plateau_every=200)
            hist = np.ascontiguousarray(res.history)
            np.save(saved / f"{tag}_{k}.npy", hist)
            row.update(rel_l2=res.rel_l2, adam_steps=n_adam,
                       launches=launches, seconds=seconds,
                       adam_t=None if built is None else [x.t for x in built],
                       history_sha1=history_digest(hist))
        except Exception as e:  # reported per run; the others go on
            row["error"] = f"{type(e).__name__}: {e}"
        print("P3D_RUN " + json.dumps(row), flush=True)


def p3d_repeat(parent: str, runs: int) -> None:
    """Phase 5c's training ``runs`` times in this tree and ``runs`` times
    in another checkout (``parent``, e.g. a git archive of the parent
    commit), on one card, two worker processes per tree at once (p3d_runs,
    each its half of the runs in turn), so that both trees run under the
    same load.  Prints every P3D_RUN line, then per tree the distinct
    outcomes (rel-L2, L-BFGS evaluations, history digest) with their
    counts, and for every run whose history is not the parent's first
    run's (its first that ended without an error), the first row where
    they part.  Worker logs go to
    build/p3d_repeat/."""
    import collections
    import os

    import numpy as np

    print(f"  card: {card_line()}")
    saved = ROOT / "build" / "p3d_repeat"
    shutil.rmtree(saved, ignore_errors=True)
    saved.mkdir(parents=True)
    trees = {"parent": str(Path(parent).resolve()), "this": str(ROOT)}
    code = "\n".join([_IN_TREE, "from tpinn_torch.kernels import _build",
                      "_build.load_all(s.KERNELS)",
                      "s.p3d_runs(dev, int(sys.argv[4]), sys.argv[5])"])
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for w in range(4):
        name = ("parent", "this")[w % 2]
        tag = f"{name}{w // 2}"
        log = open(saved / f"{tag}.log", "w")
        procs.append((tag, log, subprocess.Popen(
            [sys.executable, "-c", code, trees[name],
             str(ROOT / "chip_smoke.py"), str(w),
             str((runs + 1 - w // 2) // 2), tag],
            cwd=trees[name], stdout=log, stderr=subprocess.STDOUT,
            text=True, env=env)))
    try:
        for tag, log, proc in procs:
            proc.wait(timeout=3000)
    finally:
        for tag, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    rows = []
    for tag, _, proc in procs:
        text = (saved / f"{tag}.log").read_text()
        found = [json.loads(line.split(" ", 1)[1]) for line in
                 text.splitlines() if line.startswith("P3D_RUN ")]
        for row in found:
            print("P3D_RUN " + json.dumps(row))
        if proc.returncode != 0:
            print(text[-4000:])
            raise RuntimeError(f"the worker {tag} failed")
        rows += found
    # the parent's first run that ended without an error
    first = next((r for r in rows if r["tag"].startswith("parent")
                  and "error" not in r), None)
    base = (None if first is None else
            np.load(saved / f"{first['tag']}_{first['run']}.npy"))
    for name in ("parent", "this"):
        mine = [r for r in rows if r["tag"].startswith(name)]
        outcomes = collections.Counter(
            r.get("error") or (repr(r["rel_l2"]), r["history_sha1"][:12])
            for r in mine)
        print(f"  {name}: {len(mine)} runs, {len(outcomes)} outcome(s): "
              + "; ".join(f"{n} x {o}" for o, n in outcomes.most_common()))
        for r in mine:
            if "error" in r or base is None:
                continue
            hist = np.load(saved / f"{r['tag']}_{r['run']}.npy")
            rows_n = min(len(hist), len(base))
            parted = np.nonzero(np.any(hist[:rows_n] != base[:rows_n],
                                       axis=1))[0]
            if len(parted) or len(hist) != len(base):
                at = int(parted[0]) if len(parted) else rows_n
                print(f"  {name} {r['tag']} run {r['run']}: history parts "
                      f"from the parent's first run at row {at} (Adam "
                      f"steps {r['adam_steps']}), rel-L2 {r['rel_l2']!r}, "
                      f"launchers' device steps {r['adam_t']}")
    print("P3D_REPEAT " + json.dumps(
        {name: collections.Counter(
            r.get("error") or repr(r["rel_l2"]) for r in rows
            if r["tag"].startswith(name)) for name in ("parent", "this")}))


def b3_run(dev, steps=ADAM_STEPS):
    """(p, m, v) on the host after ``steps`` Adam steps at n = ADAM_N from
    seeded vectors and gradients, lr halved at the midpoint: through the
    Adam phase's launcher where the tree has one, else through
    adam_update_flat with the host's step (a tree before the launcher)."""
    import torch

    from tpinn_torch.kernels import adam

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = torch.randn(ADAM_N, generator=gen, device=dev)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-3, device=dev)
    launcher = (adam.FusedAdam(p, m, v, lr, steps)
                if hasattr(adam, "FusedAdam") else None)
    for t in range(1, steps + 1):
        if t == steps // 2 + 1:
            lr.mul_(0.5)
        g = torch.randn(ADAM_N, generator=gen, device=dev)
        if launcher is None:
            adam.adam_update_flat(g, p, m, v, lr, t)
        else:
            launcher.step(g)
    return [x.cpu() for x in (p, m, v)]


def b3_times(dev, save=None) -> dict:
    """B3 and torch._fused_adam_ (the one PyTorch call that computes the
    same update, with lr as a device tensor; timed here, used nowhere in
    the port) at n = ADAM_N in four measures each: CUDA events around one
    call (``ms``, the host's part of the call included), host time a call
    (``host_ms``), device time a launch in a queue of QUEUED behind a long
    kernel (``device_ms``) and device time a launch replayed from a CUDA
    graph of QUEUED launches (``graph_ms``); B3's plain version around the
    call.  B3 is the Adam phase's launcher (FusedAdam.step) where the tree
    has one, else adam_update_flat at a fixed step, so this also times
    another tree's B3 (b3_compare; no graph there: that B3 takes its step
    from the host).  ``save``, a path, keeps b3_run's vectors there."""
    import torch

    from tpinn_torch.kernels import adam

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, p = (torch.randn(ADAM_N, generator=gen, device=dev) for _ in range(2))
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-3, device=dev)
    launcher = (adam.FusedAdam(p, m, v, lr, B3_TIMED_STEPS)
                if hasattr(adam, "FusedAdam") else None)
    kernel = ((lambda: launcher.step(g)) if launcher is not None else
              (lambda: adam.adam_update_flat(g, p, m, v, lr, 10)))
    step10 = [torch.full((), 10.0, device=dev)]
    lib_pmv = [x.clone() for x in (p, m, v)]

    def library(pmv=lib_pmv):
        torch._fused_adam_([pmv[0]], [g], [pmv[1]], [pmv[2]], [], step10,
                           lr=lr, beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    state = [x.clone() for x in (p, m, v)]
    want = [x.clone() for x in state]
    library(state)
    adam.adam_update_reference(g, *want, lr, 10)
    err = max((a - b).abs().max().item() for a, b in zip(state, want))
    check(err <= 1e-5 * max(x.abs().max().item() for x in want),
          f"torch._fused_adam_ vs B3's plain version: max abs err {err}")
    big = torch.randn((8192, 8192), device=dev)
    blocker = lambda: [torch.matmul(big, big) for _ in range(4)]
    out = {}
    for key, measure in (("ms", event_ms), ("host_ms", host_ms),
                         ("device_ms", lambda fn: queued_ms(fn, blocker)),
                         ("graph_ms", lambda fn: graph_ms(fn, blocker))):
        out[key] = (measure(kernel) if launcher is not None
                    or key != "graph_ms" else None)
        out["library_" + key] = measure(library)
    out["plain_ms"] = event_ms(
        lambda: adam.adam_update_reference(g, p, m, v, lr, 10))
    if launcher is not None:
        # t raises if a launch ran past the table (and updated nothing)
        check(launcher.t <= B3_TIMED_STEPS,
              f"B3 timing ran past its launcher's {B3_TIMED_STEPS} steps")
    us = {k: (f"{x * 1e3:.2f}" if x is not None else "-")
          for k, x in out.items()}
    route = "launcher" if launcher is not None else "adam_update_flat"
    print(f"  adam alone n={ADAM_N} ({route}), B3 / torch._fused_adam_: "
          f"around the call {us['ms']} / "
          f"{us['library_ms']} us, host a call {us['host_ms']} / "
          f"{us['library_host_ms']} us, on the device in a queue of {QUEUED} "
          f"{us['device_ms']} / {us['library_device_ms']} us, replayed "
          f"from a graph of {QUEUED} {us['graph_ms']} / "
          f"{us['library_graph_ms']} us; plain {us['plain_ms']} us around "
          f"the call (CUDA events; the library agrees with the plain "
          f"version to {err:.1e})", flush=True)
    if save is not None:
        Path(save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(b3_run(dev), save)
    return out


def phase_timing_train(dev):
    """The Adam step, kernel engine (B1 + B2 + B3) against the plain
    engine (plain B1, autograd, plain Adam), and B2 and B3 alone."""
    out = adam_step_times(dev)
    out.update(b2_times(dev))
    out["adam"] = b3_times(dev)
    return out


def adam_step_times(dev):
    """The Adam step with the kernel engine (B1 + B2 + B3) against the
    plain engine (plain B1, autograd, plain Adam) at the recipe's shape,
    bench.py's and poisson_3d's: {"step_<shape>": (kernel, plain) ms}."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import loss as loss_mod

    out = {}
    shapes = (("recipe", problems.with_hard_bc(problems.annulus_laplace()),
               annulus_spec(80), RECIPE_COUNTS),
              ("bench", problems.annulus_laplace(), annulus_spec(60),
               BENCH_COUNTS),
              ("poisson_3d", problems.with_hard_bc(problems.poisson_3d()),
               p3d_spec(), P3D_COUNTS))
    for label, problem, mspec, counts in shapes:
        pred, compiled, params, data, lw = loss_setup(problem, mspec, dev,
                                                      counts=counts)
        n = data["x_col"].shape[0]
        with torch.no_grad():
            ref = loss_mod.make_loss(pred, compiled)(
                params, data, lw, torch.ones((), device=dev))[1][0]
        steps = {
            "kernel": adam_step(loss_mod.make_loss(pred, compiled,
                                                   engine="kernel"),
                                params, data, lw, ref),
            "plain": adam_step(loss_mod.make_loss(plain_engine(pred), compiled,
                                                  engine="fused"),
                               params, data, lw, ref, plain=True)}
        ms = alternating_ms(steps)
        out[f"step_{label}"] = (ms["kernel"], ms["plain"])
        print(f"  Adam step, {label} shape ({mspec.depth}x{mspec.width}"
              f"{' hard-BC' if problem.hard_bc else ' soft-BC'}, N={n}): "
              f"kernel engine {ms['kernel']:.3f} ms, plain engine "
              f"{ms['plain']:.3f} ms (synchronised host clock, median of "
              f"{TIMED_RUNS}, alternating)")
    return out


def phase_timing(dev, gen, servers):
    out = {}
    name, srv = servers[0]
    compiled = srv.compiled
    for n in (65_536, 262_144):
        z = box_points(gen, n, (0.1, 0.0), (1.0, 2 * math.pi), dev)
        kern = lambda: compiled.residual_fast(srv.predictor, srv.params, z)
        plain = lambda: compiled.evaluate(
            z, plain_partials(srv.predictor, srv.params, z, compiled.indices))
        for _ in range(3):
            kern()
            plain()
        ts = {"kernel": [], "plain": []}
        for r in range(TIMED_RUNS):  # alternate: plain, kernel, kernel, plain
            order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
            for which in order:
                ts[which].append(sync_ms(kern if which == "kernel" else plain))
        k_ms, p_ms = statistics.median(ts["kernel"]), statistics.median(ts["plain"])
        out[f"residual_{n}"] = (k_ms, p_ms)
        print(f"  residual ({name}) N={n}: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms (median of {TIMED_RUNS} synchronised runs each)")
    return out


def bound(n_bytes, n_ops) -> dict:
    """The least time the card could take for work of these bytes and
    fp32 operations, and which of the two bounds it."""
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def shape_rows(name, shapes, work_fn, tiling, times, sms, card) -> list:
    """One row per timed shape of a kernel (phase 6's times under the
    shape's key): its time, its plain version's, its bound and the plan
    it ran under."""
    rows = []
    for key, label, spec, kinds, lo, hi, streams, n in shapes:
        nf = 3                       # minmax x2 + periodic, or minmax x3
        S = len(streams)
        plan = tiling([nf] + [spec.width] * spec.depth + [1], S, n, sms)
        k_ms, p_ms, *extra = times[key]
        rows.append({"shape": label, "N": n, "S": S, "ms": k_ms,
                     "plain_ms": p_ms, **(extra[0] if extra else {}),
                     **bound(*work_fn(n, spec, nf, len(kinds), S)),
                     **plan._asdict()})
        print(f"  {name}, {label} (N={n}): {k_ms:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.5f} ms ({100 * rows[-1]['bound_ms'] / k_ms:.1f}% "
              f"of the time), plain {p_ms:.4f} ms; plan {plan}; on {card}")
    return rows


def phase_build() -> None:
    """Build the kernels (one nvcc each, all started together); print the
    build times and ptxas's register and spill lines."""
    from tpinn_torch.kernels import _build

    _build.load_all(KERNELS)
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"  built {Path(info['path']).name} in {info['seconds']:.2f} s "
              f"(cached: {info['cached']})")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print("    ptxas: " + line.strip())


def b2_only() -> None:
    """Phases 2, 3b and B2's timing of phase 6 alone, for fast iteration
    on kernel B2."""
    import torch

    print(f"  card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3b. B2 vs plain")
    phase_b2(dev, torch.Generator().manual_seed(SEED))
    phase("6. B2 timing")
    b2_times(dev)


def b1_only() -> None:
    """Phases 2, 3a and B1's timing of phase 6 alone, for fast iteration
    on kernel B1."""
    import torch

    print(f"  card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3a. B1 vs plain")
    phase_kernel_vs_plain(dev, torch.Generator().manual_seed(SEED))
    phase("6. B1 timing")
    b1_times(dev)
    b1_mode_times(dev)


def b3_only() -> None:
    """Phases 2, 3c and B3's timing of phase 6 alone, for fast iteration
    on kernel B3."""
    import torch

    print(f"  card: {card_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("3c. B3 vs plain")
    phase_b3(dev)
    phase("6. B3 timing")
    b3_times(dev)


def march_only() -> None:
    """Phases 1, 2 and 5e alone: the marching path on the card."""
    import torch

    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase("2. build")
    phase_build()
    phase("5e. marching (the time-marching slice's path)")
    phase_march(dev, card)


def determinism(parent=None) -> None:
    """Phase 5c's training once (in ``parent`` first, if given, then in
    this tree), each run in its own process under
    torch.use_deterministic_algorithms(True, warn_only=True) with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 set in that process before cuBLAS
    starts; prints every operation PyTorch warned about (its message, the
    line of Python that called it, how often) and the run's rel-L2."""
    trees = ([str(Path(parent).resolve())] if parent else []) + [str(ROOT)]
    in_trees(trees, [
        "import collections, os, warnings",
        "os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'",
        "from tpinn_torch.kernels import _build",
        "_build.load_all(s.KERNELS)",
        "torch.use_deterministic_algorithms(True, warn_only=True)",
        "with warnings.catch_warnings(record=True) as caught:",
        "    warnings.simplefilter('always')",
        "    res = s.run_recipe_cut('poisson_3d', dev, [(s.P3D_ADAM, "
        "s.P3D_LBFGS)], out_dir=s.SMOKE_DIR / 'determinism', tail_max=50, "
        "density_every=100, plateau_every=200)[2]",
        "ops = collections.Counter((str(w.message).splitlines()[0], "
        "f'{w.filename}:{w.lineno}') for w in caught "
        "if 'deterministic' in str(w.message))",
        "for (msg, where), n in ops.most_common():",
        "    print(f'  warned {n} times at {where}: {msg}')",
        "print('DETERMINISM ' + json.dumps({'tree': tree, "
        "'rel_l2': res.rel_l2, 'warned': [{'op': m, 'where': w, 'count': n} "
        "for (m, w), n in ops.most_common()]}))"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpinn_torch.kernels import mlp_taylor

    phase("1. device")
    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase("2. build")
    phase_build()

    gen = torch.Generator().manual_seed(SEED)
    phase("3a. B1 vs plain")
    err_fwd = phase_kernel_vs_plain(dev, gen)
    phase("3b. B2 vs plain")
    err_bwd = phase_b2(dev, gen)
    phase("3c. B3 vs plain")
    err_adam = phase_b3(dev)

    phase("4. serve (the first slice's path)")
    ckpts = write_checkpoints(gen)
    mlp_taylor.LAUNCHES = 0
    servers = phase_serve(dev, ckpts)
    serve_launches = mlp_taylor.LAUNCHES
    check(serve_launches > 0, "serving launched kernel B1 no time")
    print(f"  taylor2_fwd launches during serving: {serve_launches}")

    phase("5. train (the second slice's path)")
    train_launches = phase_train(dev)

    phase("5b. recipe (the flagship recipe's path)")
    recipe_launches = phase_recipe(dev, card)

    phase("5c. poisson_3d (the 3-D training path)")
    p3d_launches = phase_poisson3d(dev, card)

    phase("5d. the other recipes' paths")
    other_launches = phase_other_paths(dev, card)

    phase("5e. marching (the time-marching slice's path)")
    march_launches = phase_march(dev, card)
    for k in KERNELS:
        check(sum(v[k] for v in march_launches.values()) > 0,
              f"{k} launched no time on the marching path")

    phase("5f. coupled systems (the system slice's path)")
    system_launches = phase_system(dev, card)
    check(system_launches["kovasznay"]["adam"] > 0,
          "adam launched no time on the system path")

    phase("5g. scalar inverse (the inverse slice's path)")
    inverse_launches = phase_inverse(dev, card)
    for k in KERNELS:
        check(sum(v[k] for v in inverse_launches.values()) > 0,
              f"{k} launched no time on the inverse path")

    phase("5h. ensembles, patches, refmode (the ensemble and patch paths)")
    ep_launches = phase_ensemble_patch(dev, card)

    phase("5i. the online calculator (the calculator slice's path)")
    calc_launches = phase_calculator(dev, card)
    for k in KERNELS:
        check(calc_launches[k] > 0, f"{k} launched no time on the "
              f"calculator path")

    phase("5j. mid-stage resume, lbfgs_device, profiling")
    resume_launches = phase_resume(dev, card)
    for k in KERNELS:
        check(resume_launches[k] > 0, f"{k} launched no time in the resumed "
              f"run")
    # the kernels line's launches: the six newest main paths, marching
    # (B1, B2, B3), coupled systems (B3 only), scalar inverse (B1, B2, B3),
    # ensembles and patches (B1, B2, B3; B3 only), the calculator (B1, B2,
    # B3) and the resumed flagship run (B1, B2, B3), each read on its own
    launches = {k: sum(v[k] for v in (*march_launches.values(),
                                      *system_launches.values(),
                                      *inverse_launches.values(),
                                      *ep_launches.values(),
                                      calc_launches, resume_launches))
                for k in KERNELS}

    phase("6. timing")
    times = phase_timing(dev, gen, servers)
    times.update(phase_timing_train(dev))
    times.update(b1_times(dev))
    mode_rows = b1_mode_times(dev)
    times.update(system_timing(dev, card))
    times.update(inverse_timing(dev, card))
    times.update(ensemble_patch_timing(dev, card))
    for n in (65_536, 262_144):
        k_ms, p_ms = times[f"residual_{n}"]
        print(f"  residual N={n}: kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms "
              f"on {card}")
    for label in ("recipe", "bench", "poisson_3d"):
        k_ms, p_ms = times[f"step_{label}"]
        print(f"  Adam step ({label}): kernel engine {k_ms:.3f} ms vs plain "
              f"{p_ms:.3f} ms on {card}")
    k_ms, p_ms = times["step_kovasznay"]
    print(f"  Adam step (kovasznay system): with B3 {k_ms:.3f} ms vs plain "
          f"Adam {p_ms:.3f} ms; /residual of its checkpoint at 65,536 "
          f"points {times['residual_kovasznay_65536']:.3f} ms, on {card}")
    k_ms, g_ms = times["step_inverse_heat"]
    print(f"  Adam step (heat inverse): kernel route {k_ms:.3f} ms vs generic "
          f"engine {g_ms:.3f} ms, on {card}")
    k_ms, p_ms = times["step_patch_helmholtz_2d"]
    print(f"  Adam step (patched helmholtz_2d, 6x6): with B3 {k_ms:.3f} ms vs "
          f"plain Adam {p_ms:.3f} ms, on {card}")
    r_ms, k_ms = times["step_refmode_bench"]
    print(f"  Adam step (bench.py's shape): reference semantics {r_ms:.3f} ms "
          f"vs kernel engine {k_ms:.3f} ms, on {card}")

    print(f"  card: {card}")
    # the least time the card could take for each kernel's timed call: the
    # larger of its bytes (inputs read once, outputs written once) over the
    # memory rate and its operations over the fp32 FMA peak; B1's and B2's
    # counts are b1_work's and b2_work's at each timed shape
    from tpinn_torch.kernels import taylor_vjp

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b1_rows = shape_rows("taylor2_fwd", b1_shapes(), b1_work,
                         mlp_taylor.tiling, times, sms, card)
    b2_rows = shape_rows("taylor2_bwd", b2_shapes(), b2_work,
                         taylor_vjp.tiling, times, sms, card)
    work = {"adam": (4 * 7 * ADAM_N, 16 * ADAM_N)}
    b3 = times["adam"]
    rows = (("taylor2_fwd", "taylor2_fwd", "tpinn/kernels/mlp_taylor.py:155",
             err_fwd, b1_rows[0],
             {"w_mode": b1_rows[0]["w_mode"], "device_ms":
              b1_rows[0]["device_ms"], "shapes": b1_rows,
              "w_modes": mode_rows}),
            ("taylor2_bwd", "taylor2_bwd", "tpinn/kernels/taylor_vjp.py:203",
             err_bwd, b2_rows[0],
             {"accumulate": b2_rows[0]["accumulate"],
              "scratch_bytes": b2_rows[0]["scratch_bytes"],
              "shapes": b2_rows}),
            ("adam_update", "adam", "tpinn/kernels/adam.py:46", err_adam,
             {"ms": b3["ms"], "plain_ms": b3["plain_ms"],
              "library_ms": b3["library_ms"], **bound(*work["adam"])},
             {**{k: b3[k] for k in ("host_ms", "device_ms", "graph_ms",
                                    "library_host_ms", "library_device_ms",
                                    "library_graph_ms")}}))
    kernels = []
    for name, src, where, err, timed, extra in rows:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpinn_torch/kernels/csrc/{src}.cu", "replaces": where,
            "launches": launches[src], "max_abs_err": err,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed.get("library_ms"),
            "launches_by_path": {"serve": serve_launches if src ==
                                 "taylor2_fwd" else 0,
                                 "train": train_launches[src],
                                 "recipe": recipe_launches[src],
                                 "poisson_3d": p3d_launches[src],
                                 **{k: v[src] for k, v in
                                    other_launches.items()},
                                 **{f"march_{k}": v[src] for k, v in
                                    march_launches.items()},
                                 **{f"system_{k}": v[src] for k, v in
                                    system_launches.items()},
                                 **{f"inverse_{k}": v[src] for k, v in
                                    inverse_launches.items()},
                                 **{k: v[src] for k, v in
                                    ep_launches.items()},
                                 "calculator": calc_launches[src],
                                 "resume": resume_launches[src]}, **extra})
        k = kernels[-1]
        print(f"  {name}: {k['ms']:.4f} ms, bound {k['bound_ms']:.5f} ms by "
              f"{k['bound_by']} ({100 * k['bound_ms'] / k['ms']:.1f}% of the "
              f"time), launches on the marching, system, inverse, ensemble, "
              f"patch, calculator and resume paths {launches[src]}, on "
              f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--b1-only"]:
        b1_only()
    elif sys.argv[1:2] == ["--b1-compare"] and len(sys.argv) == 3:
        b1_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b2-only"]:
        b2_only()
    elif sys.argv[1:2] == ["--b2-compare"] and len(sys.argv) == 3:
        b2_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--b3-only"]:
        b3_only()
    elif sys.argv[1:2] == ["--b3-compare"] and len(sys.argv) == 3:
        b3_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--timing-compare"] and len(sys.argv) == 3:
        timing_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--lbfgs-compare"] and len(sys.argv) == 3:
        lbfgs_compare(sys.argv[2])
    elif sys.argv[1:2] == ["--p3d-repeat"] and len(sys.argv) == 4:
        p3d_repeat(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--march-only"]:
        march_only()
    elif sys.argv[1:2] == ["--system-only"]:
        system_only()
    elif sys.argv[1:2] == ["--system-recipe"] and len(sys.argv) == 3:
        system_recipe(sys.argv[2])
    elif sys.argv[1:2] == ["--inverse-only"]:
        inverse_only()
    elif sys.argv[1:2] == ["--inverse-recipe"]:
        inverse_recipe()
    elif sys.argv[1:2] == ["--ensemble-patch-only"]:
        ensemble_patch_only()
    elif sys.argv[1:2] == ["--patch-recipe"]:
        patch_recipe()
    elif sys.argv[1:2] == ["--calculator-only"]:
        calculator_only()
    elif sys.argv[1:2] == ["--resume-only"]:
        resume_only()
    elif sys.argv[1:2] == ["--determinism"] and len(sys.argv) <= 3:
        determinism(sys.argv[2] if len(sys.argv) == 3 else None)
    else:
        sys.exit(main())
