#!/usr/bin/env python3
"""Smoke run of the ``ionflux_torch`` port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ionflux_torch/csrc`` (five sources, one nvcc
each, started together; sm_90a), drives the paths of the port at full
width and holds every kernel (the seven ports of the TPU kernels, the
popsweep in both of its modes, and K1 and K2, which have no Pallas
counterpart) against its plain PyTorch version on the same inputs.  The
d0 fit's four objectives and its device-resident CMA-ES (r) follow the d0
path, D2's surface training (q) follows them, and the on-device derivative
surface (s) runs last.

The forward-simulation path: the trained 200-wide, 7-layer NN-f
(``out/d1``) and NN-d (``out/d2``) models.
  (a) device, kernel build, weights (loaded through the carry-over function),
      and ``entry()`` on the card;
  (b)-(d) the path with every launch counter set to 0 just before it:
      ``simulate_family(backend="pallas")`` on the activation family (B = 7,
      80,001 knots), ``simulate_population`` of 64 perturbed d1 members on
      the deactivation family (9 rows padded to 16, 100,001 knots) and of 4
      perturbed d2 members (NN-d) on the activation family;
  (b') ``fused_nnf_solve_ft`` at B = 40 (two clusters) on 1 s of activation
      steps at 0.1 ms knots, 512 trips, for d1 and for a 5 x 512
      ``nnf_init`` net (too large for a cluster: the mlp() pass);
      counters are read just after, and each sweep launch's layer pass
      (cluster size, clusters) is printed;
  then each kernel against its plain version (max |dy| on the gates <= 5e-3,
  no inf where the plain version is finite), the sweep against ``odeint``,
  the sweep's records through the cluster pass against mlp()'s and against
  clusters of 16 (bit for bit; also at (b')), and the kernel and plain
  times with CUDA events after a warm-up.

The d0 fit (``scripts/train_d0_torch.py``), counters again set to 0 just
before it and read just after:
  (f) ``generate_data``: Markov ground truth on the recorded Pr3 (7 x 82,581
      knots) and Pr5 (9 x 103,225 knots) by the chained adaptive solve, the
      seed-0 noise, the [::10] lattice;
  (g) one objective evaluation at the CMA-ES default population (8): 16
      chained launches of the HH-population kernel, eager, after which the
      objective captures them, their dense output and the SSE as one CUDA
      graph (the capture counts no launch); its SSE against an independent
      ``odeint_chained`` evaluation of the same member (1e-3 relative);
  (h) five CMA-ES generations, each one replay of that graph (5 x 16 more
      launches), the replayed SSE against the eager ``device_fn`` bit for
      bit, and a profiler trace of one more evaluation: the kernel's share
      of a generation;
  then, still counted, the fitted candidates on the first Pr3 sweep by the
  RK4 kernel against the adaptive kernel (2e-3), and 64 perturbed d1 members
  on one activation protocol through the population solve;
  (i)-(k) the three kernels of this path against their plain versions: the
  HH-population kernel at 128 lanes on a Pr3 and a Pr5 sweep with a y0 carry
  and with a stiff lane that must die alone, the RK4 kernel, the population
  solve; times and bounds (each plain version, seconds long, timed on its
  one call with no warm-up run).

The while-loop sweep, the popsweep's mxu_bf16 mode and the Mosaic probe,
each through its entry point, counters set to 0 just before and read just
after:
  (l) ``fused_nnf_solve`` of d1 on the activation family (B = 7, 80,001
      knots, rtol 1e-6, max_rec 16384);
  (l') ``fused_nnf_solve`` of a 5 x 200 ``nnf_init`` net on two activation
      protocols at 1 ms knots (tests/test_pallas_tpu.py's case);
  (m) ``simulate_population(mxu_bf16=True)`` at (c)'s shape (64 members of
      the 5 x 200 ``nnf_init`` net, bench.py's bf16 popsweep nets, on the
      deactivation family, 9 rows padded to 16, so the biases are rounded
      to bf16 too);
  (n) ``scripts/probe_mosaic_bias_fault_torch.py`` in both cases;
  then (l) kernel vs plain (5e-3 on the gates), its records through the
  cluster pass against mlp()'s (bit for bit), its records against the
  sweep kernel's accepted trips of (b) (printed, expected identical), its
  gates against (b)'s within 5e-3 and its currents against (b)'s odeint
  within 5e-3; (l') against odeint within 2e-2; (m) kernel vs plain
  (5e-3), bf16 vs the f32 kernel on the same nets (above 0; below 2% of the
  currents' range at tests/test_pallas.py's 1 x 16 shape) and the bf16
  kernel on (c)'s d1 members (logged); (n) kernel vs plain and bias vs fold
  within 1e-5; times and bounds.
  (n) also logs the probe's bound for the work its kernel does (column 0
      only) beside the whole product's, and its chain floor (64 trips x 6
      dependent operations x 4 cycles at the card's maximum SM clock);
  (o) the ring pass of the popsweep (f32 and bf16) and of the population
      solve on 4 members of the registry's 500-wide architecture (s07), and
      the mlp() pass of the bf16 popsweep on 4 members of 2 x 960 x 960 x 1
      (past the ring's widest bf16 layer), kernel vs plain within 5e-3
      (comparisons only);

Checkpoint validation on the recordings (studies.table_rollout_maes_pop's
shape), counters set to 0 just before and read just after:
  (p) 64 perturbed d1 members on the five table-1 recordings (pr3, pr5,
      pr4, sinewave, aps at 0.1 ms; 5 rows padded to 8), segments of
      103,224 samples (9), chunks of 4,096, 32,768 trips, rtol 1e-6:
      ``simulate_population_real`` (9 chained popsweep launches), then
      ``population_rollout_maes`` against member 0's currents plus
      ``NOISE_SIGMA`` noise (``RandomState(0)``), Pr4 scored on sweeps 1-3:
      a first call (the eager chain, then its capture as one CUDA graph)
      and a graph replay (9 launches each); then the replay against the
      eager chain (bit for bit), the replay under the profiler (device
      idle share), the executed trips of each segment, the MAEs against
      the host reduction of the currents (rtol 2e-4, atol 1e-6) and member
      0's Pr4 currents against the plain chained ``simulate_long`` (2e-2 of
      the range), with seconds;

The d0 fit's other paths (``scripts/train_d0_torch.py``), counters set to
0 just before and read just after:
  (r) on (f)'s data at the CMA-ES default population (8): the lockstep
      (``make_objective``: ``odeint_batched`` per sweep, blocks replayed as
      CUDA graphs), analytic (exact propagator; one graph replay a
      generation), fused and native (C++ host solver) objectives at P0 and
      (not the native one) at 8 members P0 (1 + 0.05 N(0, 1))
      (``RandomState(0)``), pairwise within 1e-2 relative, with seconds per
      evaluation; the blocked lockstep solve of Pr3 sweep 0 at 8 lanes
      against its stepwise reference (records, counts and outputs bit for
      bit; ms per step); two host-``cmaes`` generations over the lockstep
      objective; the full d0 fit by ``cmaes_onchip`` over the analytic
      objective (JAX's settings, capped at 600 generations; each parameter
      within 0.5% of the reference d0 fit; ms per replayed generation and
      the device's idle share); ``cmaes_onchip`` over the fused objective
      cut to 16 generations (B3's launches counted through the replays);
      then K2 (``ops.sym_eig``, the Jacobi eigensolver inside
      ``cmaes_onchip``) on 1,000 SPD 4 x 4 against its plain version and
      torch.linalg.eigh;

D2's surface-training recipe (``studies.run_study_validated``):
  (q) ``study_surface(D2)`` at full size (the 16 ground-truth and 16 r-gate
      solves by the device-paced ``odeint``, timed apart from the host's
      splines); the device-paced ``odeint`` against ``_odeint_stepwise`` on
      one activation protocol's Markov ground truth, both on the card (bit
      for bit: records, counts and outputs), with ms per step, the
      device's idle share (profiled to 1,200 ms) and its current against
      the CPU's;
      ``_table_targets(D2, noisy=True)`` (five chained ground-truth solves
      on the recordings); then, counters set to 0 just before and read just
      after, ``run_study_validated(D2, n_seeds=2, iters=800)``: the full
      7-layer, 200-wide NN-d trained on the full surface (ms per Adam update
      against its bound; one update captured as a CUDA graph and replayed),
      its four checkpoints scored through B1's chained
      launches (``table_rollout_maes_pop``, 8,192 trips), the rows that came
      back non-finite rescored singly (counted, with seconds), the kept
      (seed, iteration, score); then one 50-update chunk under the profiler
      (idle share), 50 captured updates against the CPU's eager ones (loss
      traces within 1e-3 relative) and one checkpoint the chain scored
      finite against
      ``table_rollout_maes`` (1e-2 relative on each column), or a line
      saying every row was rescored;
The on-device derivative surface, counter set to 0 just before and read
just after:
  (s) ``estimate_gate_surface_ondevice`` on the activation protocol at -60
      mV (80,001 samples, the default ``SurfaceConfig``) against the scipy
      path (RMS within 1e-6 on a, 5e-6 on dadt, tests/test_spline.py's
      bounds), with seconds for both; K1 (``ops.spline.
      tridiag_solve_batched``, one launch for the protocol's segments)
      against its plain version (didt within 1e-5 of its scale);
The other solvers and neural-ODE training through the solve (no kernel:
torch ops, replayed from CUDA graphs):
  (t) ``eval.simulate(method=...)`` for adams, vcabm and rosenbrock on
      HH_B06 over ``activation_protocol(0.0)`` (801 outputs to 8,000 ms,
      tests/test_implicit.py's case) and on d1 over the 20 mV activation
      step's first 2,000 ms, each against ``odeint``'s current (2e-3; Adams
      5e-3 within 50 ms of a step edge, as JAX's own Adams); to 1,200 ms
      (the 1,000 ms edge included) each blocked solve against its
      stepwise loop bit for bit, with ms per step; the device's idle share
      to 30 ms (HH_B06 only: d1's is a depth cut); ``odeint_rk4`` at a constant 0 mV (250 ms) against ``odeint``
      and the closed form (1e-5);
  (u) ``scripts/train_neural_ode_torch.py``'s ``main(--protocol act)`` at
      full width (2-200x5-1, pretrained) for three RK4-mode updates (the
      fused path: ``ops/node_rk4.py``'s two kernels a solve) and two
      adjoint-mode updates (the backward interval captured once); the RK4
      run's node_fwd and node_vjp launches (exactly iters + 1 and iters)
      and each kernel's device ms against its bound (a ``kernels`` row
      each); ms per update against its bound and chain floor, the fused
      update's kernel count, its first loss and gradient at 301 outputs
      against the float64 plain reference's and the eager update's, the
      graph path's kernels a replay; on a 40 ms window the graph path's
      replayed updates (the size rule forced to 0) against eager ones (bit
      for bit), the fused updates against the float64 reference and the
      eager ones (losses, first gradient, change; the card test's
      tolerances, tests/_node_reference.py) and the modes' idle share; the
      adjoint's gradient against backprop
      through RK4 (n_sub 32; relative error below 1e-3); JAX's
      out/neural-ode/model.npz through the RK4 solve to 1,500 ms, card
      against CPU (1e-4 of the largest current);
The s-studies and the d-study replay (no kernel; the device-paced
``odeint`` and the chained solve), on a stand-in reference checkout
(``standin_reference``: test-protocols/ap2hz.csv is the recorded APs
waveform's first 3,000 ms, written before ``studies`` is imported):
  (v) ``studies.predict_study`` of the committed out/s1 model (out/s2's
      is the depth cut) on all 26 prediction rows, every row
      but AP2Hz against the JAX
      package's out/<s>/log2 (1e-2 relative; a TPU's numbers), seconds per
      row; the 3 ms and 10 ms activation-time-constant rows of S1 by one
      ``simulate_cases`` on the card and on the CPU (1e-4 of the range 50
      ms or more from a step edge, 1e-3 anywhere);
      ``run_study_validated(S1, metric=s_rollout_maes)`` on S1's full
      surface, cut in depth to 1 seed x 400 updates (1 checkpoint; full
      MLP, full 1,000-update pretrain), then 100
      updates replayed from the captured update: the surface's seconds, ms
      per replayed Adam update, seconds per ``s_rollout_maes`` call, the
      kept checkpoint; ``run_study(S2)`` at 200 updates on the cached surface,
      with the kept S1 net's "Target Loss", ending in its AP2Hz line;
  (w) ``scripts/table_1_torch.py``'s ``main`` on out/d1, out/d2 and
      HH_D0_FIT, cut to the Sinusoidal and APs columns (8 solves; the
      chained Pr3 / Pr5 / Pr4 columns took ~65 s more) and timed by
      ``utils.timing.StageTimer`` on the card, its MAEs against
      out/table-1/table-1.txt (JAX on a TPU with the reference's noise:
      1e-2 relative, a rough check), and its ``--cached`` rerun equal;
The real-data path (``ionflux_torch.realdata``, ``rstudies``,
``scripts/train_r0_bad_torch.py``) on full-length stand-in caches that it
writes into the stand-in checkout (``tests/_r_study_standins.py``: r1/ on
Pr3 + Pr5, 213,804 points; r1-bad/ on Pr3 + Pr4, 147,336), counters set
to 0 just before and read just after:
  (x) in the defaults a user gets (float32 recoveries, no patch):
      ``run_real_study(R1)`` at full width (5 x 200 NN-f, the
      1,000-update pretrain) cut in depth to one 400-update chunk,
      validated on Pr5 by the chained solve, then 100 updates replayed from
      the captured update (ms per replayed Adam update, s per validation,
      the kept Pr5 MAE); ``predict_real_study`` of the committed out/r1
      against the JAX package's CPU MAEs on the same stand-in (1e-2
      relative; out/r2's replay is the depth cut); every protocol these
      recovered (``recover_measurements`` of r1/ and r1-bad/) against a g r
      (V - E) with r by the exact propagator (1e-4 of the range); r0-bad
      at population 8 on the recovered r1-bad currents: its four objectives
      against the analytic one (1e-2), two fused evaluations (23 B3
      launches each, the second one graph replay), the host-loop CMA-ES
      over the analytic objective (uncut) and ``cmaes_onchip`` (K2; uncut,
      JAX's rule stops it), both within 1e-2 of the stand-in's generating
      p1-p4, and ``cmaes_onchip`` over the fused objective (16
      generations, B3 counted through the replayed chunks); then the
      replay against the eager objective (bit for bit) and B3 against its
      plain version on r0-bad's lattice, Pr3 sweep 0 and Pr4 sweep 0 with
      the y0 carry (5e-3);
The r-study replay drivers (no kernel; the chained solve and the
device-paced ``odeint``), on (x)'s stand-in checkout with the replay files
of tests/_r_replay_standins.py (state dicts of the committed models, the
HH fit's traces):
  (y) ``scripts/table_2_torch.py``'s ``main`` at full length in the default
      mode (out/r1, out/r2, HH_CELL5_FIT), its MAEs against the JAX
      package's CPU ones on the same stand-in (tests/_r_replay_reference.py;
      1e-2 relative), its calls' seconds; ``figure_7_torch.main`` at full
      length (the a-trajectories' ranges); figures 4, 4-s, 5 and 6, table
      S1 (two of the twelve architectures, ``--stored-pr4``) and the
      supplements (the AP2Hz case) on the short two-sweep stand-ins, in
      processes of their own started with the phase: one on the card,
      three on the CPU, each MAE card against CPU within 1e-3 relative
      (the supplements' within 1e-3 of the case's current range);
The sharded population path (``parallel``, B1 in two processes):
  (z) ``simulate_population_sharded`` of (c)'s 64 perturbed d1 members on
      the deactivation family over two gloo processes sharing the card (32
      members a rank, one B1 launch each, counted in the rank; the
      currents gathered through the host): each rank's shard against one
      process's ``simulate_population`` of it (bit for bit), the gather
      against (c)'s unsharded launch (5e-3, JAX's), every rank's copy
      equal; then ``entry.dryrun_multichip(2)`` on the card;
  (e) the kernel table as one JSON line, the card's name and power limit, and
      the final ``{"ok": true, ...}`` line.

Every row of the kernel table names its layer pass (``layer_pass``).  The
HH trip kernel's row carries its executed trips, ms per executed trip (also
at the fit's 8 lanes), design and helper threads per lane; the RK4 kernel's its
microseconds per substep, design and lanes per block.  The
rows of the three launches that take the ring layer pass (the popsweep in
f32 and in bf16, the population solve) also carry their executed trips
(``n_valid``), the milliseconds per executed trip and the pass's design;
the two sweeps' rows (the cluster pass) their executed trips or steps, the
milliseconds per trip or step, the cluster size and count and the mlp()
pass's time on the same inputs (B2 also at clusters of 16 and at (b')).
The f32 popsweep's ``launches`` adds (p)'s, (q)'s and (z)'s (its ranks')
to the forward path's (``launches_by_path``), and its row carries (p)'s
eager and replay seconds and ms per executed trip and (q)'s chain seconds, rescored rows,
ms per Adam update, its bound and the chunk's idle share; the probe's its
bound for the whole product, its chain floor and the SM clock it was taken
at.  The HH trip kernel's ``launches`` adds (r)'s (``launches_by_path``)
and its row carries the ms per replayed generation of ``cmaes_onchip`` over
the fused objective.  The rows of K1 and K2 name no TPU kernel (they replace
a ``lax.scan`` and ``jnp.linalg.eigh``) and carry their design; K2's
``library_ms`` is torch.linalg.eigh's time on the same matrices.

Any failing phase raises, so the script exits non-zero and prints no result.
Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

GATE_TOL = 5e-3       # kernel vs plain: two adaptive f32 solves whose MLP
                      # sums run in different orders (a borderline accept
                      # can flip), the bound tests/test_pallas.py holds
CURRENT_TOL = 5e-3    # fused sweep vs odeint currents (tests/test_eval.py)
SSE_TOL = 1e-3        # the objective's SSE vs an odeint_chained evaluation
RK4_TOL = 2e-3        # fixed-step RK4 vs a tight adaptive solve
                      # (tests/test_pallas.py); the adaptive kernel runs at
                      # ORACLE's tolerances for it, since at the objective's
                      # 1e-5 its dense output across a voltage step edge is
                      # itself off by ~2e-3
ORACLE = dict(rtol=1e-6, atol=1e-8, trips=4096)
RK4_PLAIN_TOL = 1e-5  # RK4 kernel vs plain: no controller, same arithmetic
TRIPS = 4096          # the MLP trip solves
HH_TRIPS = 2048       # the HH-population solve, as the d0 objective runs it
RK4_WINDOW = 10000    # knots of Pr3 sweep 0 on which the plain RK4 runs
P_POP, P_NND = 64, 4
WHILE = dict(rtol=1e-6, atol=1e-8, max_rec=16384, max_steps=100_000)
WHILE_ODE_TOL = 2e-2  # (l'): the while sweep vs odeint (tests/test_pallas_tpu.py)
B40, B40_TRIPS = 40, 512   # (b'): B2 on two clusters, 1 s of protocol
B40_TOL = dict(rtol=1e-6, atol=1e-8)
BF16_DEV = 0.02       # (m): bf16 vs f32 currents, of their range, at the
                      # shape of tests/test_pallas.py::
                      # test_popsweep_mxu_bf16_storage (3 nets of 1 x 16)
PROBE_TOL = 1e-5      # (n): probe kernel vs plain, and bias vs fold
# (p): checkpoint validation on the table-1 recordings, at the shape
# studies.table_rollout_maes_pop runs: 64 members, the five recordings in
# its order, segments of 103,224 samples, chunks of 4,096, rtol 1e-6 /
# atol 1e-8, Pr4 scored on sweeps 1-3.  Trips: 32,768, not the study's
# 8,192: Pr3's -80 -> +60 mV edge falls 8,887.5 ms into the fifth segment,
# where the shared f32 clock crawls through ~15,000 trips of tiny steps for
# these 64 members (16,768 executed), so at 8,192 (or 16,384) the launch
# falls short and the whole batch scores inf (PERF.md)
VAL_NAMES = ["pr3-cell5", "pr5-cell5", "pr4-cell5", "sinewave-cell5",
             "aps-cell5"]
VAL_KW = dict(trips=32_768, seg_samples=103_224, chunk=4096, rtol=1e-6,
              atol=1e-8)
MAE_RTOL, MAE_ATOL = 2e-4, 1e-6   # device vs host reduction (test_pallas.py)
LONG_TOL = 2e-2       # chained popsweep vs simulate_long, of the range
# (q): D2's recipe, cut in depth from 6 seeds x 8,000 updates to 2 x 800
# (4 checkpoints of the full 7-layer, 200-wide NN-d on the full surface)
Q_SEEDS, Q_ITERS = 2, 800
Q_PROFILE_MS = 1200.0  # the profiled odeint's horizon, the 1,000 ms edge in
SURF_FAR_TOL = 1e-5   # card vs CPU ground truth, of the range, >= 50 ms from
                      # a step edge (tests/test_torch_surface.py)
SURF_ALL_TOL = 1e-3   # anywhere: at an edge the two adaptive solves straddle
                      # it differently
Q_LOSS_RTOL = 1e-3    # Adam loss traces, card (captured, capturable Adam)
                      # vs CPU (eager): sums in other orders, as
                      # tests/test_torch_train.py holds JAX's
Q_MAE_RTOL = 1e-2     # a checkpoint's MAEs, B1 chain vs the plain chained
                      # solve: currents within ~5e-4 of their range (p), the
                      # MAEs ~0.1 (the targets' noise)

# (r): the d0 objectives and the device-resident fit, at the CMA-ES default
# population on the recorded Pr3 and Pr5, full size
R_SPREAD = 0.05       # members P0 (1 + 0.05 N(0, 1)), RandomState(0)
OBJ_RTOL = 1e-2       # the four objectives pairwise (the analytic vs
                      # lockstep gap is ~0.7%, tests/test_analytic.py)
FIT_RTOL = 5e-3       # cmaes_onchip's analytic fit vs the reference d0 fit
FIT_CAP = 600         # generations
FUSED_ITERS = 16      # cmaes_onchip over the fused objective: two chunks
K2_TOL = 1e-5         # K2 vs torch.linalg.eigh, of each matrix's scale
# (s): the on-device derivative surface, tests/test_spline.py's case
SURF_RMS_A, SURF_RMS_D = 1e-6, 5e-6   # against the scipy path (its bounds)
K1_RTOL = 1e-5        # K1 vs plain on didt, of its scale

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): float32 on
# the CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth.  The kernels
# run float32 FMA, no tensor cores; the popsweep's mxu_bf16 mode multiplies
# bf16 operands, so its bound takes the bf16 rate.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


T0 = time.perf_counter()


def log(*args) -> None:
    """A line of the run's log, led by the seconds since the start."""
    print(f"[{time.perf_counter() - T0:6.1f}]", *args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (MHz), the clock it runs at under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def cuda_ms(fn, reps: int, warm: bool = True):
    """Mean milliseconds of fn() over reps launches after one warm-up (none
    with ``warm=False``), with CUDA events; returns (ms, last result)."""
    out = fn() if warm else None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def gate_diff(name: str, ys_k: torch.Tensor, ys_p: torch.Tensor) -> float:
    """max |dy| between kernel and plain gates; fails past GATE_TOL or where
    one is finite and the other is not."""
    fin_k, fin_p = torch.isfinite(ys_k), torch.isfinite(ys_p)
    if not bool(torch.equal(fin_k, fin_p)):
        raise RuntimeError(f"{name}: kernel and plain version disagree on "
                           f"which outputs are finite")
    if not bool(fin_p.any()):
        raise RuntimeError(f"{name}: no finite output")
    err = float((ys_k - ys_p)[fin_p].abs().max())
    log(f"{name}: max |dy| kernel vs plain = {err:.3e} (tol {GATE_TOL})")
    if not err <= GATE_TOL:
        raise RuntimeError(f"{name}: kernel vs plain {err} > {GATE_TOL}")
    return err


def population(leaves, members: int, seed: int):
    """Net leaves of one model times (1 + 0.01 N(0, 1)) per member, from
    numpy.random.RandomState(seed); the 8 HH scalars stay shared."""
    rs = np.random.RandomState(seed)
    net, hh = leaves[:-8], leaves[-8:]
    pop = [(x[None] * (1.0 + 0.01 * rs.randn(members, *x.shape))
            ).astype(np.float32) for x in net]
    return pop + hh


def npz_leaves(path: str) -> list:
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def mlp_work(leaves) -> tuple[int, int]:
    """(MACs per MLP evaluation, number of net parameters) of a checkpoint's
    leaves (W0, b0, W1, b1, ..., then 8 HH scalars)."""
    sizes = [int(leaves[0].shape[0])] + [
        int(w.shape[1]) for w in leaves[0:-8:2]]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return macs, sum(int(x.size) for x in leaves[:-8])


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from ionflux_torch.ops import bias_probe as B
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.ops import hh_solve as H
    from ionflux_torch.ops import node_rk4 as NR
    from ionflux_torch.ops import spline as SP
    from ionflux_torch.ops import sym_eig as SE

    for k in (F.fused_nnf_solve_ft, F.fused_nnf_popsweep_solve_ft,
              F.fused_nnf_pop_solve_ft, F.fused_nnf_solve,
              H.fused_hh_pop_solve_ft, H.fused_hh_rk4, B.bias_probe,
              SP.tridiag_solve_batched, SE.sym_eig, NR._fwd_cuda,
              NR._vjp_cuda):
        k.launches = 0


def roofline(ops: float, nbytes: float, flops: float = F32_FLOPS):
    """Least time (ms) for `ops` operations at `flops` per second and
    `nbytes` bytes, and which of the two bounds it."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# One HH right-hand side: 4 expf, each counted as ONE operation, and 12
# multiplies and adds.
HH_RHS_OPS = 4 + 12


def trip_bound(n_valid: int, lanes: int, rhs_ops: int, in_bytes: int,
               flops: float = F32_FLOPS):
    """Bound of a trip solve: 6 right-hand sides of rhs_ops operations (an
    MLP: 2 per MAC) per lane per executed trip; the inputs read once and the
    executed trips' records (t, h, start y, 7 stages) written once."""
    return roofline(n_valid * 6 * rhs_ops * lanes,
                    in_bytes + n_valid * (2 + 2 * lanes + 7 * 2 * lanes) * 4,
                    flops)


# The layer pass of the population launches (B1 in both modes, B4): each
# member's weights streamed through a ring of three shared-memory stages by
# bulk asynchronous copies (TMA, one mbarrier per stage), multiplied from
# shared memory (mma.sync in bf16); csrc/fused_solve.cu says more.
RING_DESIGN = "pr4-bulk-copy-ring-3x64KB+mma.sync-bf16"
NO_PASS = "none (no MLP)"   # the HH kernels' and the probe's rows
# The HH kernels' designs (csrc/hh_solve.cu): the trip kernel's chain warps
# (one thread per lane's dependent chain and the controller) and helper
# warps (the rates off the chain, the records), two named barriers a trip;
# RK4's producer warps feeding one consumer thread per lane through an
# mbarrier ring, lanes spread over blocks
HH_TRIP_DESIGN = "chain-warps+helper-warps"
HH_RK4_DESIGN = "producer-warps+mbarrier-ring"
# The probe (csrc/bias_probe.cu): one thread per (member, row) chain, acc in
# a register, column 0 only, no barrier; 8 operations per row and trip, 6 of
# them on the dependent chain, each at least FP32_LATENCY cycles
PROBE_DESIGN = "thread-per-row-chain"
PROBE_ROW_OPS, PROBE_CHAIN_OPS, FP32_LATENCY = 8, 6, 4
WIDE_SIZES = (2, 500, 500, 1)   # the registry's s07 architecture
MLP_BF16_SIZES = (2, 960, 960, 1)   # past the ring's widest bf16 layer


def ring_fields(n_valid: int, ms: float) -> dict:
    """The extra kernel-row fields of a launch through the ring pass: its
    executed trips, the milliseconds per executed trip and the design."""
    return dict(n_valid=n_valid, ms_per_trip=ms / n_valid,
                design=RING_DESIGN, layer_pass="ring")


def pass_text(info: dict) -> str:
    """A sweep launch's layer pass as chip_smoke prints it."""
    if info["layer_pass"] == "cluster":
        return (f"cluster pass, {info['cluster_size']} blocks per cluster, "
                f"{info['clusters']} cluster(s)")
    return "mlp() pass (weights from L2)"


def same_records(out_a, out_b, n: int) -> bool:
    """Whether two trip or while launches wrote the same first n records,
    bit for bit (NaN included), and the same n_out."""
    return bool(torch.equal(out_a[3], out_b[3])) and all(
        bool(torch.equal(a[:n].view(torch.int32), b[:n].view(torch.int32)))
        for a, b in zip(out_a[:3], out_b[:3]))


# What a cluster-pass launch's row adds: its pass and geometry, executed
# trips (steps for B6), ms per trip, and the mlp() pass's time on the same
# inputs, whose records it must equal bit for bit (csrc/fused_solve.cu).
def cluster_fields(info: dict, n: int, ms: float, ms_mlp: float) -> dict:
    return dict(layer_pass=info["layer_pass"],
                cluster_size=info["cluster_size"], clusters=info["clusters"],
                n_valid=n, ms_per_trip=ms / n, mlp_ms=ms_mlp)


def check_counts(what: str, launches: dict,
                 expected: dict | None = None) -> None:
    """Every kernel launched at least once, and exactly ``expected``
    times where that is given."""
    log(f"{what}: launches {launches}")
    for n, c in launches.items():
        if c < 1:
            raise RuntimeError(f"{what} never launched {n}")
    if expected is not None and launches != expected:
        raise RuntimeError(f"{what}: launches {launches}, expected "
                           f"{expected}")


def profiled(call, kernel: str) -> tuple[float, float, float]:
    """One ``call()`` under the profiler: (host seconds, device busy ms
    summed over every kernel, of it the ms of kernels whose name holds
    ``kernel``); busy 0 if the trace holds no device time.  Only the
    device's own events count: an operator's row repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    busy = mine = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        busy += us
        if kernel in e.key:
            mine += us
    return secs, busy / 1e3, mine / 1e3


def evaluation_profile(objective, xs, secs_per_generation: float) -> None:
    """Where one objective evaluation's time goes: a profiler trace of one
    more evaluation (16 more launches), by kernel."""
    _, busy, trip = profiled(lambda: objective(xs), "hh_trip_kernel")
    if busy <= 0.0:
        log("(h) profiler: no device time in the trace; kernel share of a "
            "generation not measured")
        return
    wall = secs_per_generation * 1e3
    log(f"(h) one evaluation (profiler trace): device busy {busy:.3f} "
        f"ms, of which the HH-population kernel {trip:.3f} ms and "
        f"phase 2 with the objective's torch ops {busy - trip:.3f} "
        f"ms; against {wall:.3f} ms per generation on the host clock "
        f"(untraced) the device is idle {100 * (1 - busy / wall):.1f}%")


def forward_path(dev, rows) -> dict:
    """Phases (a)-(d): the forward-simulation path and its two kernels.
    Returns what the later phases compare with: the f32 popsweep currents,
    the sweep's odeint currents and the sweep kernel's records and gates."""
    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.entry import entry
    from ionflux_torch.models import nn as N
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import load_pytree, params_from_leaves

    d1_path = os.path.join(ROOT, "out", "d1", "model.npz")
    d2_path = os.path.join(ROOT, "out", "d2", "model.npz")
    d1 = load_pytree(d1_path, "nnf", device=dev)
    d2 = load_pytree(d2_path, "nnd", device=dev)
    d1_leaves, d2_leaves = npz_leaves(d1_path), npz_leaves(d2_path)
    macs, n_params = mlp_work(d1_leaves)
    log(f"(a) d1/d2 MLP: {macs} MACs per evaluation; d1 r-gate "
        f"{tuple(float(x) for x in d1.rgate[4:])}, d2 base "
        f"{tuple(float(x) for x in d2.hh)}")
    pop64 = params_from_leaves(population(d1_leaves, P_POP, 0), "nnf", dev)
    pop4 = params_from_leaves(population(d2_leaves, P_NND, 1), "nnd", dev)

    fn, args = entry(device=dev)
    i_entry = fn(*args)
    torch.cuda.synchronize()
    if i_entry.shape != (1601,) or not bool(torch.isfinite(i_entry).all()):
        raise RuntimeError("entry(): non-finite or misshapen currents")
    log(f"(a) entry() on the card: {tuple(i_entry.shape)} currents, peak "
        f"{float(i_entry.abs().max()):.4f}")

    act = P.activation_family(0.1, device=dev)
    deact = P.deactivation_family(0.1, device=dev)
    ts_act, ts_deact = act[0].times(), deact[0].times()
    log(f"protocols: activation {len(act)} x {act[0].n} knots, deactivation "
        f"{len(deact)} x {deact[0].n} knots")
    # (b'): B2 at B = 40 (two clusters) on 1 s of activation steps at 0.1
    # ms knots (-80 mV, then from 100 ms a step to -60..+60 mV), d1 and a
    # 5 x 512 nnf_init net (5.2 MB of weights: the mlp() pass)
    v40 = torch.full((B40, 10001), -80.0, device=dev)
    v40[:, 1000:] = torch.linspace(-60.0, 60.0, B40, device=dev)[:, None]
    ts40 = torch.arange(0, 10001, 10, device=dev).float() * 0.1
    wide512 = N.nnf_init(torch.Generator().manual_seed(0), HH_B06, 5, 512,
                         device=dev)
    kw40 = dict(proto_dt=0.1, trips=B40_TRIPS, **B40_TOL)

    # ---- (b)-(d) the path, counted -----------------------------------------
    kernels = {"fused_nnf_solve_ft": F.fused_nnf_solve_ft,
               "fused_nnf_popsweep_solve_ft": F.fused_nnf_popsweep_solve_ft}
    calls = {
        "sweep": lambda: E.simulate_family("nnf", d1, act, ts_act, SYNTHETIC,
                                           backend="pallas", trips=TRIPS),
        "popsweep": lambda: E.simulate_population(
            "nnf", pop64, deact, ts_deact, SYNTHETIC, trips=TRIPS),
        "nnd popsweep": lambda: E.simulate_population(
            "nnd", pop4, act, ts_act, SYNTHETIC, trips=TRIPS),
        "b40": lambda: F.fused_nnf_solve_ft(d1.net, d1.rgate, v40, ts40,
                                            **kw40),
        "w40": lambda: F.fused_nnf_solve_ft(wide512.net, wide512.rgate, v40,
                                            ts40, **kw40)}
    reset_counts()
    out, secs, path_pass = {}, {}, {}
    for name, call in calls.items():
        t = time.perf_counter()
        out[name] = call()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        if name in ("sweep", "b40", "w40"):
            path_pass[name] = F.fused_nnf_solve_ft.last_pass
    launches = {n: k.launches for n, k in kernels.items()}
    i_sweep, i_pop, i_nnd, i_b40, i_w40 = out.values()
    log(f"forward path: host clock s per call (first call, synchronised) "
        f"{secs}")
    check_counts("forward path", launches)
    log(f"(b) the sweep's launch: {pass_text(path_pass['sweep'])}; (b') at "
        f"B=40: {pass_text(path_pass['b40'])}, the 5x512 net: "
        f"{pass_text(path_pass['w40'])}")
    if (path_pass["sweep"]["layer_pass"] != "cluster"
            or path_pass["b40"]["clusters"] != 2
            or path_pass["w40"]["layer_pass"] != "mlp"):
        raise RuntimeError(f"the sweeps took other passes: {path_pass}")
    for name, cur, shape in (("sweep", i_sweep, (7, 80001)),
                             ("popsweep", i_pop, (P_POP, 9, 100001)),
                             ("nnd popsweep", i_nnd, (P_NND, 7, 80001)),
                             ("(b') d1 gates", i_b40, (B40, 1001, 2)),
                             ("(b') 5x512 gates", i_w40, (B40, 1001, 2))):
        if tuple(cur.shape) != shape:
            raise RuntimeError(f"{name}: shape {tuple(cur.shape)} != {shape}")
        if not bool(torch.isfinite(cur).all()):
            raise RuntimeError(f"{name}: non-finite currents")
        log(f"{name}: currents {shape}, peak |I| {float(cur.abs().max()):.4f}")

    # ---- (b) sweep kernel vs plain, vs odeint, times -----------------------
    b_act = P.stack(act)
    s = F._sweep_setup(d1.net, d1.rgate, b_act.v, ts_act, 0.0, 0.1,
                       float(ts_act[-1]), 1e-6, 1e-8, TRIPS, None)
    ms_k, out_k = cuda_ms(lambda: F._trip_solve_cuda(s), reps=3)
    ms_p, out_p = cuda_ms(lambda: F._trip_solve_plain(s), reps=1,
                          warm=False)
    ys_k = F._dense_eval_ft(*out_k[:3], out_k[3][0], out_k[3][1], ts_act,
                            lane_ok=out_k[4][0])
    ys_p = F._dense_eval_ft(*out_p[:3], out_p[3][0], out_p[3][1], ts_act,
                            lane_ok=out_p[4][0])
    n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
    info = F._trip_solve_cuda.last_pass
    log(f"(b) sweep B=7: n_acc/n_valid kernel {n_k}, plain {n_p}; kernel "
        f"{ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms per executed trip, "
        f"{pass_text(info)}), plain {ms_p:.1f} ms")
    err = gate_diff("(b) sweep", ys_k, ys_p)
    b2 = dict(out=out_k, ys=ys_k)
    # the same launch through mlp() (one launch, ~0.34 s) and through
    # clusters of 16: records bit for bit equal to the cluster pass's
    ms_g, out_g = cuda_ms(lambda: F._trip_solve_cuda(
        dataclasses.replace(s, cluster=0)), reps=1, warm=False)
    ms_16, out_16 = cuda_ms(lambda: F._trip_solve_cuda(
        dataclasses.replace(s, cluster=16)), reps=3)
    same_g, same_16 = (same_records(out_k, o, n_k[1]) for o in (out_g, out_16))
    log(f"(b) the same launch through mlp(): {ms_g:.3f} ms, records "
        f"{'bit-identical' if same_g else 'differ'}; through clusters of 16: "
        f"{ms_16:.3f} ms ({ms_16 / n_k[1]:.4f} ms per trip), records "
        f"{'bit-identical' if same_16 else 'differ'}")
    if not (same_g and same_16):
        raise RuntimeError("(b) the cluster pass's records differ from "
                           "mlp()'s or across cluster sizes")
    i_ode = E.simulate_family("nnf", d1, act, ts_act, SYNTHETIC,
                              backend="xla")
    d_ode = float((i_sweep - i_ode).abs().max())
    log(f"(b) sweep vs odeint: max |dI| = {d_ode:.3e} (tol {CURRENT_TOL}); "
        f"peak |I| {float(i_ode.abs().max()):.4f}")
    if not d_ode <= CURRENT_TOL:
        raise RuntimeError(f"sweep vs odeint {d_ode} > {CURRENT_TOL}")
    in_bytes = (b_act.v.numel() + n_params + 8) * 4
    b_ms, b_by = trip_bound(n_k[1], len(act), 2 * macs, in_bytes)
    row = dict(
        name="fused_nnf_solve_ft", route="cuda",
        source="ionflux_torch/csrc/fused_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:472",
        launches=launches["fused_nnf_solve_ft"], max_abs_err=err, ms=ms_k,
        plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **cluster_fields(info, n_k[1], ms_k, ms_g), ms_c16=ms_16)

    # ---- (b') B2 at B = 40 on two clusters, and the 5 x 512 net -----------
    for name, net, cur in (("d1", d1, i_b40), ("5x512", wide512, i_w40)):
        s = F._sweep_setup(net.net, net.rgate, v40, ts40, 0.0, 0.1, 1000.0,
                           B40_TOL["rtol"], B40_TOL["atol"], B40_TRIPS, None)
        ms_k, out_k = cuda_ms(lambda: F._trip_solve_cuda(s), reps=3)
        info = F._trip_solve_cuda.last_pass
        ms_p, out_p = cuda_ms(lambda: F._trip_solve_plain(s), reps=1,
                              warm=False)
        n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
        ys = [F._dense_eval_ft(*o[:3], o[3][0], o[3][1], ts40,
                               lane_ok=o[4][0]) for o in (out_k, out_p)]
        log(f"(b') {name} B={B40}: n_acc/n_valid kernel {n_k}, plain {n_p}; "
            f"kernel {ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms per executed "
            f"trip, {pass_text(info)}), plain {ms_p:.1f} ms; the path's "
            f"launch equals this one: {bool(torch.equal(cur, ys[0]))}")
        err = max(err, gate_diff(f"(b') {name} B={B40}", *ys))
        if name == "d1":
            ms_g, out_g = cuda_ms(lambda: F._trip_solve_cuda(
                dataclasses.replace(s, cluster=0)), reps=1, warm=False)
            same = same_records(out_k, out_g, n_k[1])
            log(f"(b') d1 B={B40} through mlp(): {ms_g:.3f} ms, records "
                f"{'bit-identical' if same else 'differ'}")
            if not same:
                raise RuntimeError("(b') cluster pass and mlp() differ")
            row.update(ms_b40=ms_k, ms_per_trip_b40=ms_k / n_k[1],
                       mlp_ms_b40=ms_g)
        else:
            row.update(ms_5x512_mlp_pass=ms_k)
    row["max_abs_err"] = err
    rows.append(row)

    # ---- (c) popsweep kernel vs plain (P = 64), times ----------------------
    b_de = P.stack(deact)
    s = F._popsweep_setup(pop64.net, pop64.rgate, b_de.v, ts_deact, 0.0,
                          0.1, float(ts_deact[-1]), 1e-5, 1e-7, TRIPS, None,
                          None, True, False, 1)
    ms_k, out_k = cuda_ms(lambda: F._trip_solve_cuda(s), reps=3)
    ms_p, out_p = cuda_ms(lambda: F._trip_solve_plain(s), reps=1,
                          warm=False)
    n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
    log(f"(c) popsweep P={P_POP} Q=9->16: n_acc/n_valid kernel {n_k}, plain "
        f"{n_p}; kernel {ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms per executed "
        f"trip), plain {ms_p:.1f} ms; block {s.block}")
    q_pad = s.y0.shape[1]
    recs = [F.PopsweepRecords(*o[:3], o[3][0], o[3][1], P_POP, q_pad, 9,
                              o[4]) for o in (out_k, out_p)]
    err = gate_diff(f"(c) popsweep P={P_POP}", recs[0].evaluate(ts_deact),
                    recs[1].evaluate(ts_deact))

    # ---- (d) NN-d popsweep kernel vs plain ---------------------------------
    kw = dict(proto_dt=0.1, trips=TRIPS)
    ys_k = F.fused_nnf_popsweep_solve_ft(pop4.net, pop4.hh, b_act.v, ts_act,
                                         base_hh=pop4.hh, **kw)
    ys_p = F.fused_nnf_popsweep_solve_ft_plain(pop4.net, pop4.hh, b_act.v,
                                               ts_act, base_hh=pop4.hh, **kw)
    err = max(err, gate_diff(f"(d) NN-d popsweep P={P_NND}", ys_k, ys_p))
    in_bytes = (b_de.v.numel() + P_POP * (n_params + 2 * 9) + 8) * 4
    b_ms, b_by = trip_bound(n_k[1], P_POP * 9, 2 * macs, in_bytes)
    rows.append(dict(
        name="fused_nnf_popsweep_solve_ft", route="cuda",
        source="ionflux_torch/csrc/fused_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:1459",
        launches=launches["fused_nnf_popsweep_solve_ft"], max_abs_err=err,
        ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, **ring_fields(n_k[1], ms_k)))
    return dict(i_pop=i_pop, i_ode=i_ode, b2=b2)


def d0_path(dev, rows):
    """Phases (f)-(k): the d0 whole-trace CMA-ES fit and its three kernels.
    Returns (f)'s data (d3, d5)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_d0_torch as T
    from ionflux_torch import protocols as P
    from ionflux_torch.fit.cmaes import _default_popsize, cmaes
    from ionflux_torch.models import hh_rhs
    from ionflux_torch.models.registry import HH_B06, HHParams, SYNTHETIC
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.ops import hh_solve as H
    from ionflux_torch.solver import odeint_chained
    from ionflux_torch.utils.ckpt import params_from_leaves

    f32 = torch.float32
    kernels = {"fused_hh_pop_solve_ft": H.fused_hh_pop_solve_ft,
               "fused_hh_rk4": H.fused_hh_rk4,
               "fused_nnf_pop_solve_ft": F.fused_nnf_pop_solve_ft}
    hh_pop = H.fused_hh_pop_solve_ft
    reset_counts()

    # ---- (f) data ----------------------------------------------------------
    t = time.perf_counter()
    d3, d5 = T.generate_data(device=dev)
    log(f"(f) generate_data: {d3.size} + {d5.size} points in "
        f"{time.perf_counter() - t:.1f} s; |d| max "
        f"{max(np.abs(d3).max(), np.abs(d5).max()):.4f}")
    if (d3.size, d5.size) != (57806, 92902):
        raise RuntimeError(f"data lengths {(d3.size, d5.size)}")
    if not (np.isfinite(d3).all() and np.isfinite(d5).all()):
        raise RuntimeError("generate_data: non-finite data")

    # ---- (g) one objective evaluation --------------------------------------
    pop = _default_popsize(len(T.P0))
    objective = T.make_objective_fused(d3, d5, pop, trips=HH_TRIPS,
                                       device=dev)
    t = time.perf_counter()
    sse0 = float(objective(T.P0[None])[0])
    secs_eval = time.perf_counter() - t
    log(f"(g) SSE(P0) = {sse0:.4f} at pop {pop}, trips {HH_TRIPS}: "
        f"{hh_pop.launches} launches, {secs_eval:.3f} s (first evaluation, "
        f"host clock)")
    if not np.isfinite(sse0) or hh_pop.launches != 16:
        raise RuntimeError(f"objective: SSE {sse0}, {hh_pop.launches} "
                           f"launches (expected finite, 16)")
    # the same member by the plain adaptive solve, chained over the sweeps
    # and across the Pr3 -> Pr5 boundary, on the same lattice
    t = time.perf_counter()
    params0 = HHParams(*T.P0, *T.RGATE)
    y = torch.tensor([0.0, 1.0], dtype=f32, device=dev)
    sse_ref = 0.0
    for rec, d in zip(T.RECORDINGS, (d3, d5)):
        protos, ts, _, _ = T._sweep_protos(rec, dev)
        ys = odeint_chained(
            lambda tt, yy, a: hh_rhs(a[0], tt, yy, P.voltage(a[1], tt)),
            y, ts, protos, params0, rtol=1e-6, atol=1e-8,
            buffer_size=16384, max_steps=200_000)
        i_sim = (ys[:, :-1, 0] * ys[:, :-1, 1]
                 * (protos.v[:, :-1] - float(SYNTHETIC.e)))
        i_lat = i_sim.reshape(-1)[::T.SUB].double().cpu().numpy()
        sse_ref += float(np.sum((i_lat - d) ** 2))
        y = ys[-1, -1]
    rel = abs(sse0 - sse_ref) / sse_ref
    log(f"(g) SSE(P0) by odeint_chained = {sse_ref:.4f} in "
        f"{time.perf_counter() - t:.1f} s; relative difference {rel:.3e} "
        f"(tol {SSE_TOL})")
    if not rel <= SSE_TOL:
        raise RuntimeError(f"objective vs odeint_chained: {rel} > {SSE_TOL}")

    # ---- (h) the fit takes five steps --------------------------------------
    asked = []          # each generation's candidates [pop, 4]

    def watched(xs):
        asked.append(xs.copy())
        return objective(xs)

    t = time.perf_counter()
    res = cmaes(watched, T.P0, sigma0=0.1 * T.P0,
                bounds=(0.1 * T.P0, 10.0 * T.P0), max_iterations=5)
    secs_fit = time.perf_counter() - t
    log(f"(h) cmaes: {res.iterations} generations, best SSE {res.fx:.4f} "
        f"(first generation's best {res.history[0][1]:.4f}, SSE(P0) "
        f"{sse0:.4f}), {secs_fit / res.iterations:.3f} s per generation "
        f"(host clock), x = {res.x.tolist()}")
    if not (np.isfinite(res.fx) and res.fx <= res.history[0][1]):
        raise RuntimeError("cmaes: best SSE not finite or above the first "
                           "generation's best")
    if hh_pop.launches != 16 * 6:
        raise RuntimeError(f"cmaes: {hh_pop.launches} launches after the "
                           f"fit (expected 96)")
    evaluation_profile(objective, asked[-1], secs_fit / res.iterations)

    # ---- still the path: the last generation by RK4, and the population
    #      solve of 64 member nets on one protocol ---------------------------
    protos3, _, _, period3 = T._sweep_protos(T.RECORDINGS[0], dev)
    protos5, _, _, period5 = T._sweep_protos(T.RECORDINGS[1], dev)
    dt = float(protos3.dt[0])
    n_out = period3 // 10 + 1
    ts_ms = torch.arange(n_out, dtype=f32, device=dev)
    rg = [float(x) for x in T.RGATE]
    last8 = torch.tensor(np.concatenate(
        [asked[-1], np.tile(rg, (pop, 1))], axis=1), dtype=f32, device=dev)
    ys_rk = H.fused_hh_rk4(last8, protos3.v[0], proto_dt=dt, dt_out=1.0,
                           n_out=n_out, n_sub=10)
    ys_ad = hh_pop(last8, protos3.v[0], ts_ms, proto_dt=dt, **ORACLE)
    d_rk = float((ys_rk - ys_ad).abs().max())
    log(f"last generation on Pr3 sweep 0: RK4 kernel vs adaptive kernel max "
        f"|dy| = {d_rk:.3e} (tol {RK4_TOL})")
    if not d_rk <= RK4_TOL:
        raise RuntimeError(f"RK4 vs adaptive {d_rk} > {RK4_TOL}")

    d1_leaves = npz_leaves(os.path.join(ROOT, "out", "d1", "model.npz"))
    macs, n_params = mlp_work(d1_leaves)
    pop64 = params_from_leaves(population(d1_leaves, P_POP, 0), "nnf", dev)
    act20 = P.activation_protocol(20.0, 0.1, device=dev)
    ts_act = act20.times()
    pop_kw = dict(proto_dt=0.1, rtol=1e-5, atol=1e-7, trips=TRIPS)
    t = time.perf_counter()
    ys_pop = F.fused_nnf_pop_solve_ft(pop64.net.layers, pop64.rgate, act20.v,
                                      ts_act, **pop_kw)
    torch.cuda.synchronize()
    log(f"population solve: {tuple(ys_pop.shape)} gates in "
        f"{time.perf_counter() - t:.3f} s (first call, host clock)")
    if (tuple(ys_pop.shape) != (P_POP, 80001, 2)
            or not bool(torch.isfinite(ys_pop).all())):
        raise RuntimeError("population solve: misshapen or non-finite")
    launches = {n: k.launches for n, k in kernels.items()}
    check_counts("d0 path", launches)
    # (h) the objective's graph against its eager device_fn, bit for bit
    # (comparison launches, after the path's counts were read)
    f_graph = objective(asked[-1])
    f_eager = objective.device_fn(torch.tensor(asked[-1], dtype=f32,
                                               device=dev))
    f_eager = f_eager.cpu().numpy().astype(np.float64)
    log(f"(h) last generation: graph replay SSE {f_graph.tolist()}; "
        f"{'bit-identical to' if np.array_equal(f_graph, f_eager) else 'DIFFERS from'}"
        f" the eager device_fn")
    if not np.array_equal(f_graph, f_eager):
        raise RuntimeError("the objective's CUDA graph and device_fn differ")

    # ---- (i) HH-population kernel vs plain at 128 lanes --------------------
    base = np.array([float(x) for x in HH_B06])
    pop128 = torch.tensor(
        base[None] * np.exp(0.1 * np.random.RandomState(0).randn(128, 8)),
        dtype=f32, device=dev)
    lat3 = torch.arange(0, period3 + 1, T.SUB, dtype=f32, device=dev) * dt
    lat5 = torch.arange(0, period5 + 1, T.SUB, dtype=f32, device=dev) * dt

    def hh_pair(name, params, v, ts, t_end, y0, trips, reps):
        kw = dict(proto_t0=0.0, proto_dt=dt, t_end=t_end, rtol=1e-5,
                  atol=1e-7, trips=trips)
        ms_k, out_k = cuda_ms(lambda: H._hh_pop_solve(
            params, v, y0, plain=False, **kw), reps=reps)
        ms_p, out_p = cuda_ms(lambda: H._hh_pop_solve(
            params, v, y0, plain=True, **kw), reps=1, warm=False)
        n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
        same = all(torch.equal(a[:n_p[1]], b[:n_p[1]])
                   for a, b in zip(out_k[:3], out_p[:3]))
        log(f"{name}: n_acc/n_valid kernel {n_k}, plain {n_p} (n_acc "
            f"{'equal' if n_k[0] == n_p[0] else 'differs'}; records "
            f"{'bit-identical' if same else 'differ'}); kernel {ms_k:.3f} "
            f"ms, plain {ms_p:.1f} ms")
        if n_k[1] != n_p[1]:
            raise RuntimeError(f"{name}: n_valid {n_k[1]} != {n_p[1]}")
        ys = [F._dense_eval_ft(*o[:3], o[3][0], o[3][1], ts, lane_ok=o[4])
              for o in (out_k, out_p)]
        return gate_diff(name, *ys), ms_k, ms_p, n_k, out_k[4], out_p[4], ys

    n_launch = hh_pop.launches
    err3, ms_k, ms_p, n_k, _, _, ys = hh_pair(
        "(i) HH pop B=128, Pr3 sweep 0", pop128, protos3.v[0], lat3,
        period3 * dt, None, HH_TRIPS, 3)
    layout128 = H.fused_hh_pop_solve_ft.last_layout
    y_carry = ys[0][:, -1, :].contiguous()
    in_bytes = (protos3.v[0].numel() + pop128.numel() + 2 * 128) * 4
    b_ms, b_by = trip_bound(n_k[1], 128, HH_RHS_OPS, in_bytes)
    # (these 128 sets spread the r-gate's rates too, which the fit keeps
    # fixed: the fastest lane's stability limit at -120 mV holds the shared
    # step near 3 ms for 6 s, so this sweep needs twice the fit's budget)
    err5, *_ = hh_pair("(i) HH pop B=128, Pr5 sweep 0 with the y0 carry",
                       pop128, protos5.v[0], lat5, period5 * dt, y_carry,
                       2 * HH_TRIPS, 1)
    # the shape the fit gives the kernel: 8 lanes, the last generation
    err8, ms8, _, n8, *_ = hh_pair(
        "(i) HH pop B=8 (the fit's last generation)", last8, protos3.v[0],
        lat3, period3 * dt, None, HH_TRIPS, 3)
    layout8 = H.fused_hh_pop_solve_ft.last_layout
    log(f"(i) trip kernel layouts as launched: B=128 {layout128}, B=8 "
        f"{layout8}")
    # a stiff lane (p2 = 1.0: k1 ~ e^20 at the +20 mV test step of Pr3 sweep
    # 4) pins the shared step; it must die alone, in both versions
    stiff = pop128.clone()
    stiff[1, 1] = 1.0
    errs, _, _, n_s, alive_k, alive_p, _ = hh_pair(
        "(i) HH pop B=128 with a stiff lane, Pr3 sweep 4", stiff,
        protos3.v[4], lat3, period3 * dt, None, 2 * HH_TRIPS, 1)
    want = torch.ones(128, dtype=torch.bool, device=dev)
    want[1] = False
    if not (torch.equal(alive_k, want) and torch.equal(alive_p, want)):
        raise RuntimeError(
            f"stiff lane: dead lanes kernel "
            f"{(~alive_k).nonzero().flatten().tolist()}, plain "
            f"{(~alive_p).nonzero().flatten().tolist()}; expected [1]")
    log(f"(i) stiff lane 1 dead alone in both versions after "
        f"{n_s[1]} trips")
    if hh_pop.launches - n_launch != 4 + 2 + 4 + 2:
        raise RuntimeError("HH pop wrapper miscounted its launches")
    rows.append(dict(
        name="fused_hh_pop_solve_ft", route="cuda",
        source="ionflux_torch/csrc/hh_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:1015",
        launches=launches["fused_hh_pop_solve_ft"],
        max_abs_err=max(err3, err5, err8, errs), ms=ms_k, plain_ms=ms_p,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, n_valid=n_k[1],
        ms_per_trip=ms_k / n_k[1], ms_at_8_lanes=ms8,
        ms_per_trip_at_8_lanes=ms8 / n8[1], design=HH_TRIP_DESIGN,
        helpers_per_lane=layout128["group"],
        helpers_per_lane_at_8=layout8["group"],
        layer_pass=NO_PASS))

    # ---- (j) RK4 kernel vs the adaptive kernel and vs plain ----------------
    rk = dict(proto_dt=dt, dt_out=1.0, n_sub=10)
    ms_k, ys_rk = cuda_ms(lambda: H.fused_hh_rk4(
        pop128, protos3.v[0], n_out=n_out, **rk), reps=3)
    rk4_layout = H.fused_hh_rk4.last_layout
    ys_ad = hh_pop(pop128, protos3.v[0], ts_ms, proto_dt=dt, **ORACLE)
    d_rk = float((ys_rk - ys_ad).abs().max())
    log(f"(j) RK4 B=128, {(n_out - 1) * 10} substeps, layout {rk4_layout}: "
        f"kernel {ms_k:.3f} ms; vs adaptive kernel max |dy| = {d_rk:.3e} (tol {RK4_TOL})")
    if not d_rk <= RK4_TOL:
        raise RuntimeError(f"RK4 vs adaptive {d_rk} > {RK4_TOL}")
    # the plain version is one host-paced chain per substep: hold it on the
    # window with the leak step and the onset of the test step
    win = protos3.v[0][:RK4_WINDOW + 1].contiguous()
    n_win = RK4_WINDOW // 10 + 1
    ms_w, ys_w = cuda_ms(lambda: H.fused_hh_rk4(
        pop128, win, n_out=n_win, **rk), reps=1)
    ms_p, ys_p = cuda_ms(lambda: H.fused_hh_rk4_plain(
        pop128, win, n_out=n_win, **rk), reps=1, warm=False)
    err = float((ys_w - ys_p).abs().max())
    log(f"(j) RK4 on the first {RK4_WINDOW + 1} knots: kernel {ms_w:.3f} ms, "
        f"plain {ms_p:.1f} ms, max |dy| kernel vs plain = {err:.3e} (tol "
        f"{RK4_PLAIN_TOL})")
    # and at the lane count the path gave it (the last generation's 8)
    ys_p8 = H.fused_hh_rk4_plain(last8, win, n_out=n_win, **rk)
    err8 = float((H.fused_hh_rk4(last8, win, n_out=n_win, **rk)
                  - ys_p8).abs().max())
    log(f"(j) RK4 B={pop} on the same window: max |dy| kernel vs plain = "
        f"{err8:.3e} (tol {RK4_PLAIN_TOL})")
    if not bool(torch.isfinite(ys_p8).all()):
        raise RuntimeError("RK4 plain at the fit's lane count: non-finite")
    err = max(err, err8)
    if not (bool(torch.isfinite(ys_p).all()) and err <= RK4_PLAIN_TOL):
        raise RuntimeError(f"RK4 kernel vs plain {err} > {RK4_PLAIN_TOL}")
    # per substep and lane: 4 right-hand sides and 26 multiplies and adds in
    # the stage and final sums of the two gates
    substeps = (n_out - 1) * 10
    b_ms, b_by = roofline(
        substeps * 128 * (4 * HH_RHS_OPS + 26),
        (protos3.v[0].numel() + pop128.numel() + n_out * 128 * 2) * 4)
    rows.append(dict(
        name="fused_hh_rk4", route="cuda",
        source="ionflux_torch/csrc/hh_solve.cu",
        replaces="ionflux/ops/pallas_rk4.py:87",
        launches=launches["fused_hh_rk4"], max_abs_err=err, ms=ms_k,
        plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plain_ms_covers=f"{n_win - 1} of {n_out - 1} output intervals",
        us_per_substep=ms_k * 1e3 / substeps, design=HH_RK4_DESIGN,
        lanes_per_block=rk4_layout["lanes_per_block"],
        layer_pass=NO_PASS))

    # ---- (k) population solve (Q = 1 case of the trip kernel) vs plain -----
    s = F._pop_setup(pop64.net.layers, pop64.rgate, act20.v, ts_act, 0.0,
                     0.1, float(ts_act[-1]), 1e-5, 1e-7, TRIPS)
    ms_k, out_k = cuda_ms(lambda: F._trip_solve_cuda(s), reps=3)
    ms_p, out_p = cuda_ms(lambda: F._trip_solve_plain(s), reps=1,
                          warm=False)
    n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
    log(f"(k) population solve P={P_POP}: n_acc/n_valid kernel {n_k}, plain "
        f"{n_p}; kernel {ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms per executed "
        f"trip), plain {ms_p:.1f} ms")
    ys_p = F.fused_nnf_pop_solve_ft_plain(pop64.net.layers, pop64.rgate,
                                          act20.v, ts_act, **pop_kw)
    if not bool(torch.isfinite(ys_p).all()):
        raise RuntimeError("population solve, plain: non-finite")
    err = gate_diff(f"(k) population solve P={P_POP}", ys_pop, ys_p)
    in_bytes = (act20.v.numel() + P_POP * n_params + 8) * 4
    b_ms, b_by = trip_bound(n_k[1], P_POP, 2 * macs, in_bytes)
    rows.append(dict(
        name="fused_nnf_pop_solve_ft", route="cuda",
        source="ionflux_torch/csrc/fused_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:760",
        launches=launches["fused_nnf_pop_solve_ft"], max_abs_err=err,
        ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, **ring_fields(n_k[1], ms_k)))
    return d3, d5


def wide_check(dev) -> None:
    """(o) The population launches' layer passes on wide nets: the ring at
    the registry's 500-wide architecture (s07), wider than one pass of its
    threads, and mlp() just past the ring's widest bf16 layer (2 x 960 x
    960 x 1, launch_plan's second branch): 4 members with weights 0.1
    sqrt(16 / fan-in) N(0, 1) and biases 0.01 N(0, 1) (``RandomState(5)``
    and ``RandomState(6)``), the popsweep in f32 and in bf16 on 9
    activation steps at 1 ms knots and the population solve on one; kernel
    against plain within 5e-3 on the gates.  Comparisons only: no path of
    the port sends such a net."""
    from ionflux_torch import protocols as P
    from ionflux_torch.models.registry import HH_B06
    from ionflux_torch.ops import fused_solve as F

    def members(sizes, seed):
        rs = np.random.RandomState(seed)
        return [(torch.tensor((0.1 * (16 / max(a, 16)) ** 0.5)
                              * rs.randn(4, a, b), dtype=torch.float32,
                              device=dev),
                 torch.tensor(0.01 * rs.randn(4, b), dtype=torch.float32,
                              device=dev))
                for a, b in zip(sizes[:-1], sizes[1:])]

    nets, nets960 = members(WIDE_SIZES, 5), members(MLP_BF16_SIZES, 6)
    levels = [float(x) for x in np.linspace(-60.0, 40.0, 9)]
    v9 = P.stack([P.activation_protocol(x, 1.0, device=dev)
                  for x in levels]).v
    v1 = P.activation_protocol(20.0, 1.0, device=dev).v
    ts = torch.arange(50.0, 8000.0, 100.0, device=dev)
    kw = dict(proto_dt=1.0, trips=2048)
    for name, kern, plain, net, v, extra, want in (
            ("popsweep f32", F.fused_nnf_popsweep_solve_ft,
             F.fused_nnf_popsweep_solve_ft_plain, nets, v9, {}, "ring"),
            ("popsweep bf16", F.fused_nnf_popsweep_solve_ft,
             F.fused_nnf_popsweep_solve_ft_plain, nets, v9,
             {"mxu_bf16": True}, "ring"),
            ("population solve", F.fused_nnf_pop_solve_ft,
             F.fused_nnf_pop_solve_ft_plain, nets, v1, {}, "ring"),
            ("popsweep bf16", F.fused_nnf_popsweep_solve_ft,
             F.fused_nnf_popsweep_solve_ft_plain, nets960, v9,
             {"mxu_bf16": True}, "mlp")):
        sizes = [2] + [w.shape[2] for w, _ in net]
        ms_k, ys_k = cuda_ms(lambda: kern(net, HH_B06, v, ts, **kw, **extra),
                             reps=1, warm=False)
        info = F._trip_solve_cuda.last_pass
        if info["layer_pass"] != want:
            raise RuntimeError(f"(o) {name}: took {info}, expected {want}")
        how = (f"ring pass, {info['row_tile']}-row tiles, "
               f"{info['column_passes']} column pass(es)" if want == "ring"
               else f"mlp() pass, {info['row_tile']}-row tiles")
        gate_diff(f"(o) {name}, 4 members of {'x'.join(map(str, sizes))} "
                  f"({how}; {ms_k:.1f} ms)", ys_k,
                  plain(net, HH_B06, v, ts, **kw, **extra))


def validation_path(dev, rows) -> None:
    """(p) Checkpoint validation on the five table-1 recordings: 64 d1
    members x (1 + 0.01 N(0, 1)) (``RandomState(0)``, as (c)) through
    ``simulate_population_real`` and ``population_rollout_maes`` at
    studies.table_rollout_maes_pop's shape; counters set to 0 just before
    and read just after.  Then, as comparisons: the chain eagerly and as a
    graph replay (bit for bit), its device idle share, the executed trips
    of each segment, the MAEs against the host reduction of the currents,
    and member 0 on Pr4 against the plain chained ``simulate_long``."""
    from ionflux_torch import eval as E
    from ionflux_torch import protorec
    from ionflux_torch.models import nn as N
    from ionflux_torch.models.registry import TABLE1
    from ionflux_torch.observe import NOISE_SIGMA
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import params_from_leaves

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import probe_validation_chain_torch as PV

    d1_leaves = npz_leaves(os.path.join(ROOT, "out", "d1", "model.npz"))
    pop = params_from_leaves(population(d1_leaves, P_POP, 0), "nnf", dev)
    n4 = protorec.SWEEPS["pr4-cell5"][1]
    spans = {"pr4-cell5": (n4, 4 * n4)}
    lens = [len(protorec.load_voltage(n)[0]) for n in VAL_NAMES]
    log(f"(p) recordings {dict(zip(VAL_NAMES, lens))}; {VAL_KW}; Pr4 "
        f"scored on samples {spans['pr4-cell5']}")
    kern = F.fused_nnf_popsweep_solve_ft

    # ---- the path, counted: the currents, then the MAEs (first call: the
    #      eager chain and its capture; second call: one graph replay) ------
    reset_counts()
    t = time.perf_counter()
    cur = E.simulate_population_real("nnf", pop, VAL_NAMES, TABLE1, **VAL_KW)
    secs_cur = time.perf_counter() - t
    n_seg = kern.launches
    rs = np.random.RandomState(0)
    truth = {n: cur[n][0] + NOISE_SIGMA * rs.randn(cur[n].shape[1])
             for n in VAL_NAMES}
    t = time.perf_counter()
    maes_first = E.population_rollout_maes("nnf", pop, VAL_NAMES, TABLE1,
                                           truth, spans=spans, **VAL_KW)
    secs_first = time.perf_counter() - t
    t = time.perf_counter()
    maes = E.population_rollout_maes("nnf", pop, VAL_NAMES, TABLE1, truth,
                                     spans=spans, **VAL_KW)
    secs_graph = time.perf_counter() - t
    launches = {"fused_nnf_popsweep_solve_ft": kern.launches}
    check_counts("validation path", launches)
    if launches["fused_nnf_popsweep_solve_ft"] != 3 * n_seg:
        raise RuntimeError(f"validation path: {launches} launches, "
                           f"expected 3 x {n_seg} segments")
    log(f"(p) simulate_population_real: {n_seg} segments, "
        f"{secs_cur:.3f} s; population_rollout_maes first call (eager "
        f"chain + capture) {secs_first:.3f} s, graph replay "
        f"{secs_graph:.3f} s (host clock)")
    for n, ln in zip(VAL_NAMES, lens):
        if cur[n].shape != (P_POP, ln):
            raise RuntimeError(f"(p) {n}: currents {cur[n].shape}")

    # ---- comparisons (after the path's counts were read) ------------------
    t = time.perf_counter()
    maes_eager = E.population_rollout_maes("nnf", pop, VAL_NAMES, TABLE1,
                                           truth, spans=spans, graph=False,
                                           **VAL_KW)
    secs_eager = time.perf_counter() - t
    same = (np.array_equal(maes, maes_eager, equal_nan=True)
            and np.array_equal(maes_first, maes_eager, equal_nan=True))
    log(f"(p) eager chain {secs_eager:.3f} s against the replay's "
        f"{secs_graph:.3f} s; replay {'bit-identical to' if same else 'DIFFERS from'}"
        f" the eager chain")
    if not same:
        raise RuntimeError("(p) the graph replay and the eager chain differ")
    # the replay profiled (the eager chain's profile, ~17 s mostly the
    # profiler's own, is a depth cut; PERF.md has its idle share)
    for label, call in (("graph replay", lambda: E.population_rollout_maes(
            "nnf", pop, VAL_NAMES, TABLE1, truth, spans=spans, **VAL_KW)),):
        secs, busy, trip = profiled(call, "trip_kernel")
        if busy <= 0.0:
            log(f"(p) {label} profiled: no device time in the trace; idle "
                f"share not measured")
        else:
            log(f"(p) {label} profiled: {secs:.3f} s host, device busy "
                f"{busy:.1f} ms (popsweep kernel {trip:.1f} ms, dense output "
                f"and reduction {busy - trip:.1f} ms), idle "
                f"{100 * (1 - busy / 1e3 / secs):.1f}%")
    alive = np.isfinite(maes).all(axis=1)
    log(f"(p) members finite on every recording: {int(alive.sum())} of "
        f"{P_POP}; member 0 MAEs {dict(zip(VAL_NAMES, maes[0].round(6)))}")
    if not alive[0]:
        raise RuntimeError("(p) member 0 did not end finite")

    # the host reduction of the currents (float64 means)
    want = np.stack([[np.mean(np.abs(
        cur[n][m, slice(*spans.get(n, (0, ln)))].astype(np.float64)
        - truth[n][slice(*spans.get(n, (0, ln)))]))
        for n, ln in zip(VAL_NAMES, lens)] for m in range(P_POP)])
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(maes)):
        raise RuntimeError("(p) device and host MAEs disagree on which are "
                           "finite")
    rel = float(np.max(np.abs(maes[fin] - want[fin])
                       / (MAE_ATOL + MAE_RTOL * np.abs(want[fin]))))
    log(f"(p) MAEs vs the host reduction of the currents: max "
        f"|d| / (atol + rtol |host|) = {rel:.3f} (must be <= 1; rtol "
        f"{MAE_RTOL}, atol {MAE_ATOL})")
    if not rel <= 1.0:
        raise RuntimeError(f"(p) device vs host MAEs: {rel}")

    # executed trips and kernel time of each segment (one more chain)
    _, dt, seg, _, _, seg_v, _ = E._segment_recordings(
        VAL_NAMES, seg_samples=VAL_KW["seg_samples"], chunk=VAL_KW["chunk"])
    per_seg = PV.chain_segments(
        pop.net.layers, pop.rgate, torch.as_tensor(seg_v, device=dev),
        float(dt), seg * float(dt), len(VAL_NAMES), trips=VAL_KW["trips"],
        rtol=VAL_KW["rtol"], atol=VAL_KW["atol"])
    trips_run = sum(x["n_valid"] for x in per_seg)
    seg_ms = sum(x["ms"] for x in per_seg)
    log(f"(p) B1 launches per chain {len(per_seg)}; per segment (n_valid, "
        f"n_acc): {[(x['n_valid'], x['n_acc']) for x in per_seg]}; kernel + "
        f"final state ms {[round(x['ms'], 2) for x in per_seg]}; ms per "
        f"executed trip {seg_ms / trips_run:.4f}")

    # member 0 on Pr4 against the plain chained solve
    member0 = N.NNfParams(pop.net.member(0), pop.rgate)
    t = time.perf_counter()
    i_long = E.simulate_long("nnf", member0, "pr4-cell5", TABLE1)
    torch.cuda.synchronize()
    secs_long = time.perf_counter() - t
    i_long = i_long.cpu().numpy()
    rng = float(i_long.max() - i_long.min())
    d_long = float(np.abs(cur["pr4-cell5"][0] - i_long).max())
    log(f"(p) member 0 on pr4-cell5: chained popsweep vs simulate_long "
        f"(plain chained odeint, {secs_long:.1f} s): max |dI| = "
        f"{d_long:.4e}, {d_long / rng:.3e} of the range (tol {LONG_TOL})")
    if not d_long <= LONG_TOL * rng:
        raise RuntimeError(f"(p) popsweep vs simulate_long {d_long}")
    rows_b1 = next(r for r in rows
                   if r["name"] == "fused_nnf_popsweep_solve_ft")
    rows_b1["launches_by_path"] = {
        "forward": rows_b1["launches"],
        "validation": launches["fused_nnf_popsweep_solve_ft"]}
    rows_b1["launches"] += launches["fused_nnf_popsweep_solve_ft"]
    rows_b1.update(validation_s_eager=secs_eager,
                   validation_s_graph=secs_graph,
                   validation_ms_per_trip=seg_ms / trips_run)


@contextlib.contextmanager
def timed_calls(module, name: str, log_to: list):
    """Replace module.name by a wrapper that synchronises the card around
    each call and appends (seconds, args, result, keywords) to log_to."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log_to.append((time.perf_counter() - t, args, out, kw))
        return out

    with mock.patch.object(module, name, wrapper):
        yield


def training_path(dev, rows) -> None:
    """(q) D2's surface-training recipe on the card: the derivative surface
    at full size, the device-paced odeint against the per-step loop, the
    table-1 targets, and ``run_study_validated`` (counters set to 0 just
    before it and read just after), then the comparisons."""
    import tempfile

    from ionflux_torch import data as D
    from ionflux_torch import protocols as P
    from ionflux_torch import studies as S
    from ionflux_torch.eval import _model_rhs
    from ionflux_torch import surface as SF
    from ionflux_torch.fit import train as FT
    from ionflux_torch.models import MARKOV_Y0_REST, mlp_sizes
    from ionflux_torch.models.registry import MARKOV_B06
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.solver import dopri5 as OD

    f32 = torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the surface at full size ------------------------------------
        gt_calls, r_calls = [], []
        t = time.perf_counter()
        with timed_calls(S, "synth_study_currents", gt_calls), \
                timed_calls(SF, "solve_r_gate", r_calls):
            v, a, dadt = S.study_surface(S.D2, tmp, device=dev)
        secs_surface = time.perf_counter() - t
        m1, m2 = P.s_study_masks()
        cfg = S.D2.cfg
        n_want = sum(len(np.flatnonzero(m)[cfg.skip::cfg.sparse])
                     for m in [m1] * 7 + [m2] * 9)
        keep = (a > 0) & (a < 1)
        log(f"(q) study_surface(D2): {v.size} points ({int(keep.sum())} "
            f"with 0 < a < 1) in {secs_surface:.1f} s: the 16 ground-truth "
            f"solves {gt_calls[0][0]:.1f} s, the 16 r-gate solves "
            f"{sum(c[0] for c in r_calls):.1f} s, the splines and the rest "
            f"on the host {secs_surface - gt_calls[0][0] - sum(c[0] for c in r_calls):.1f} s")
        if v.size != n_want or len(r_calls) != 16:
            raise RuntimeError(f"(q) surface: {v.size} points (expected "
                               f"{n_want}), {len(r_calls)} r-gate solves")
        if not (np.isfinite(v).all() and np.isfinite(a).all()
                and np.isfinite(dadt).all() and keep.mean() > 0.5):
            raise RuntimeError("(q) surface: non-finite values or most a "
                               "outside (0, 1)")

        # ---- the device-paced odeint against the per-step loop -----------
        t1 = torch.as_tensor(S.T1, dtype=f32, device=dev)
        proto = P.activation_protocol(0.0, device=dev)
        y0 = torch.as_tensor(MARKOV_Y0_REST, device=dev)
        args = (MARKOV_B06, proto)
        rhs = _model_rhs("markov")
        secs = {}
        out = {}
        for name, solve in (("blocked", OD.odeint),
                            ("stepwise", OD._odeint_stepwise)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = solve(rhs, y0, t1, args, return_stats=True)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
        (ys_b, st_b), (ys_s, st_s) = out["blocked"], out["stepwise"]
        same = st_b == st_s and bool(torch.equal(ys_b, ys_s))
        steps = st_b.n_steps
        log(f"(q) odeint, Markov ground truth on the 0 mV activation "
            f"protocol (80,001 outputs): {st_b}; device-paced "
            f"{secs['blocked']:.3f} s ({1e3 * secs['blocked'] / steps:.3f} "
            f"ms per step, blocks of {OD.BLOCK_STEPS} as replayed CUDA "
            f"graphs), per-step loop {secs['stepwise']:.3f} s "
            f"({1e3 * secs['stepwise'] / steps:.3f} ms per step); "
            f"{'bit-identical' if same else 'DIFFERENT'} records, counts "
            f"and outputs")
        if not (same and st_b.ok):
            raise RuntimeError(f"(q) blocked odeint {st_b} differs from the "
                               f"per-step loop {st_s}")
        # profiled to Q_PROFILE_MS only: the trace of the whole solve
        # (~360,000 kernels) took ~55 s to read back
        head = t1[t1 <= Q_PROFILE_MS]
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_head = OD.odeint(rhs, y0, head, args, return_stats=True)[1].n_steps
        torch.cuda.synchronize()
        s_head = time.perf_counter() - t
        p_secs, busy, _ = profiled(lambda: OD.odeint(rhs, y0, head, args),
                                   "none")
        if busy > 0:
            log(f"(q) odeint to {Q_PROFILE_MS:.0f} ms ({n_head} steps) "
                f"profiled: device busy {busy:.1f} ms ({busy / n_head:.3f} "
                f"ms per step; {p_secs:.3f} s host under the profiler), idle "
                f"{100 * (1 - busy / 1e3 / s_head):.1f}% of the unprofiled "
                f"solve's {s_head:.3f} s")
        # the card's ground truth against the CPU's (one protocol)
        cpu_cur = D.simulate_current(
            MARKOV_B06, P.activation_protocol(0.0, device="cpu"),
            t1.cpu()).double().numpy()
        gpu_cur = D.simulate_current(MARKOV_B06, proto, t1).double().cpu(
            ).numpy()
        rng = float(np.ptp(cpu_cur))
        tt = S.T1
        far = np.abs(tt[:, None] - np.array([1000.0, 6000.0, 7000.0,
                                             7500.0])[None]).min(axis=1) >= 50
        d_far = float(np.abs(gpu_cur - cpu_cur)[far].max())
        d_all = float(np.abs(gpu_cur - cpu_cur).max())
        log(f"(q) ground truth on the card vs the CPU: max |dI| "
            f"{d_far / rng:.2e} of the range at >= 50 ms from a step edge "
            f"(tol {SURF_FAR_TOL}), {d_all / rng:.2e} anywhere (tol "
            f"{SURF_ALL_TOL})")
        if not (d_far <= SURF_FAR_TOL * rng and d_all <= SURF_ALL_TOL * rng):
            raise RuntimeError(f"(q) card vs CPU ground truth {d_far}, "
                               f"{d_all}")

        # ---- the table-1 targets: five chained ground-truth solves ---------
        tgt_calls = []
        with timed_calls(S, "_sim_real_table", tgt_calls):
            S._table_targets(S.D2, noisy=True, device=dev)
        log(f"(q) _table_targets(D2, noisy=True): "
            f"{[(c[1][2], round(c[0], 1)) for c in tgt_calls]} s")
        if len(tgt_calls) != 5:
            raise RuntimeError(f"(q) {len(tgt_calls)} target solves")

        # ---- the path, counted: run_study_validated -------------------------
        chunks, chains, singles, pops = [], [], [], []
        reset_counts()
        t = time.perf_counter()
        with timed_calls(S, "fit_chunk", chunks), \
                timed_calls(S, "population_rollout_maes", chains), \
                timed_calls(S, "table_rollout_maes", singles), \
                timed_calls(S, "table_rollout_maes_pop", pops):
            kept = S.run_study_validated(S.D2, tmp, n_seeds=Q_SEEDS,
                                         iters=Q_ITERS, cached=True,
                                         device=dev)
        secs_run = time.perf_counter() - t
        kern = F.fused_nnf_popsweep_solve_ft
        launches = {"fused_nnf_popsweep_solve_ft": kern.launches}
        check_counts("training path", launches)
        n_iters = sum(c[2][2].shape[0] for c in chunks)
        secs_train = sum(c[0] for c in chunks)
        n_pts = int(chunks[0][1][2].shape[0])
        # one update: forward and backward (three products a layer, 2 FLOP
        # per MAC); bytes: each layer's activations written, read back and
        # their gradient written, plus x, y and the residual read
        sizes = mlp_sizes(5, 200)
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        it_ops = n_pts * 3 * 2 * macs
        it_bytes = n_pts * (sum(sizes[1:]) * 3 + 4) * 4
        b_ms, b_by = roofline(it_ops, it_bytes)
        # the first chunk warms up and captures the update; the rest replay
        later = chunks[1:]
        ms_it = 1e3 * sum(c[0] for c in later) / sum(
            c[2][2].shape[0] for c in later)
        log(f"(q) run_study_validated(D2, n_seeds={Q_SEEDS}, "
            f"iters={Q_ITERS}): {secs_run:.1f} s; training {n_iters} Adam "
            f"updates on {n_pts} points in {secs_train:.2f} s (the first "
            f"chunk, with the warm-up and the capture, {chunks[0][0]:.2f} "
            f"s); {ms_it:.3f} ms per replayed update against a bound of "
            f"{b_ms:.3f} ms ({b_by}; {it_ops:.3e} FLOP, {it_bytes:.3e} B)")
        res = pops[0][2]
        ckpts = pops[0][1][1]
        rescored = {id(c[1][1]) for c in singles}
        secs_chain = sum(c[0] for c in chains)
        log(f"(q) batched scoring of {len(ckpts)} checkpoints: "
            f"{len(chains)} chain call(s), {secs_chain:.2f} s, "
            f"{launches['fused_nnf_popsweep_solve_ft']} B1 launches; "
            f"{len(singles)} rows came back non-finite and were rescored "
            f"singly in {sum(c[0] for c in singles):.1f} s")
        its = [min(k, Q_ITERS) for k in range(400, Q_ITERS + 400, 400)]
        order = [(sd, it) for sd in range(Q_SEEDS) for it in its]
        scores = [r["score"] for r in res]
        k_best = int(np.argmin(scores))
        log(f"(q) scores {dict(zip(order, np.round(scores, 5)))}; kept "
            f"(seed, iter, score) = {order[k_best] + (scores[k_best],)}")
        if not (np.isfinite(scores[k_best]) and len(res) == len(order)):
            raise RuntimeError(f"(q) no finite checkpoint: {scores}")
        if not all(torch.equal(a, b) for (a, _), (b, _) in zip(
                kept.net.layers, ckpts[k_best].net.layers)):
            raise RuntimeError("(q) the kept model is not the best checkpoint")

        # ---- comparisons (after the path's counts were read) ---------------
        def chunk50():
            return FT.fit_chunk(kept.net, FT.init_opt_state(kept.net),
                                *chunks[0][1][2:6], iters=50, lr=1e-3,
                                step_size=400, gamma=0.9)

        c_secs, _ = cuda_ms(chunk50, reps=1)
        c_secs /= 1e3
        p_secs, busy, gemm = profiled(chunk50, "gemm")
        idle = (1 - busy / 1e3 / c_secs) if busy > 0 else None
        if busy > 0:
            log(f"(q) one 50-update chunk: {c_secs:.3f} s; profiled, device "
                f"busy {busy:.1f} ms (matrix products {gemm:.1f} ms; "
                f"{p_secs:.3f} s host under the profiler), idle "
                f"{100 * idle:.1f}% of the unprofiled chunk")
        # the captured update against the CPU's eager one: 50 updates of
        # the kept net on every 25th point of the surface
        sub = [t[::25] for t in chunks[0][1][2:5]]
        _, _, l_card = FT.fit_chunk(kept.net, FT.init_opt_state(kept.net),
                                    *sub, iters=50, lr=1e-3, step_size=10,
                                    gamma=0.9)
        cpu_net = [(w.cpu(), b.cpu()) for w, b in kept.net.layers]
        _, _, l_cpu = FT.fit_chunk(cpu_net, FT.init_opt_state(cpu_net),
                                   *[t.cpu() for t in sub], iters=50,
                                   lr=1e-3, step_size=10, gamma=0.9)
        d_loss = float(((l_card.cpu() - l_cpu) / l_cpu).abs().max())
        log(f"(q) 50 updates on {sub[0].shape[0]} points: the card's "
            f"captured update vs the CPU's eager one, loss traces within "
            f"{d_loss:.2e} relative (tol {Q_LOSS_RTOL})")
        if not d_loss <= Q_LOSS_RTOL:
            raise RuntimeError(f"(q) card vs CPU Adam trace {d_loss}")
        batch_ok = [k for k, p in enumerate(ckpts)
                    if id(p) not in rescored and np.isfinite(scores[k])]
        if batch_ok:
            k = batch_ok[0]
            t = time.perf_counter()
            plain = S.table_rollout_maes(S.D2, ckpts[k])
            secs_plain = time.perf_counter() - t
            cols = ["pr3", "pr5", "pr4", "sin", "aps"]
            rel = max(abs(res[k][c] - plain[c]) / (abs(plain[c]) + 1e-12)
                      for c in cols)
            log(f"(q) checkpoint {order[k]}: batched {res[k]} against the "
                f"plain chained solve {plain} ({secs_plain:.1f} s): max "
                f"relative difference {rel:.2e} (tol {Q_MAE_RTOL})")
            if not rel <= Q_MAE_RTOL:
                raise RuntimeError(f"(q) batched vs plain MAEs {rel}")
        else:
            log(f"(q) every row came back non-finite from the chain at "
                f"8,192 trips: the kept score is a rescored one")
    rows_b1 = next(r for r in rows
                   if r["name"] == "fused_nnf_popsweep_solve_ft")
    rows_b1["launches_by_path"]["training"] = launches[
        "fused_nnf_popsweep_solve_ft"]
    rows_b1["launches"] += launches["fused_nnf_popsweep_solve_ft"]
    rows_b1.update(training_chain_s=secs_chain, training_rescored=len(singles),
                   training_ms_per_update=ms_it, training_bound_ms=b_ms,
                   training_idle=idle)


def accepted_trips(rec_sc: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Indices of a trip solve's accepted trips: those after which the next
    trip starts later."""
    t = rec_sc[:n_valid, 0]
    return torch.nonzero(t[1:] != t[:-1]).flatten()


def while_probe_path(dev, rows, fwd: dict) -> None:
    """Phases (l)-(n): the while-loop sweep, the popsweep's mxu_bf16 mode
    and the Mosaic probe, each through its entry point, and their kernels
    against their plain versions."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import probe_mosaic_bias_fault_torch as PR
    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.models import nn as N
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.observe import gate_current
    from ionflux_torch.ops import bias_probe as B
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import (load_pytree, params_from_leaves,
                                         params_to_leaves)

    d1_path = os.path.join(ROOT, "out", "d1", "model.npz")
    d1 = load_pytree(d1_path, "nnf", device=dev)
    d1_leaves = npz_leaves(d1_path)
    macs, n_params = mlp_work(d1_leaves)
    pop64 = params_from_leaves(population(d1_leaves, P_POP, 0), "nnf", dev)
    act = P.activation_family(0.1, device=dev)
    deact = P.deactivation_family(0.1, device=dev)
    ts_act, ts_deact = act[0].times(), deact[0].times()
    b_act, b_de = P.stack(act), P.stack(deact)
    wide = N.nnf_init(torch.Generator().manual_seed(0), HH_B06, 5, 200,
                      device=dev)
    # (m)'s members: the 5 x 200 nnf_init net x (1 + 0.01 N(0, 1)), the
    # nets bench.py's popsweep runs in mxu_bf16.  Not d1: its bf16 solve at
    # rtol 1e-5 does not reach t_end within the trips (logged below).
    popw = params_from_leaves(population(params_to_leaves(wide), P_POP, 0),
                              "nnf", dev)
    act2 = [P.activation_protocol(v, 1.0, device=dev) for v in (-40.0, 20.0)]
    b_act2 = P.stack(act2)
    ts161 = torch.linspace(0.0, 8000.0, 161, device=dev)

    # ---- (l), (l'), (m), (n): the path, counted ----------------------------
    kernels = {"fused_nnf_solve": F.fused_nnf_solve,
               "fused_nnf_popsweep_solve_ft": F.fused_nnf_popsweep_solve_ft,
               "bias_probe": B.bias_probe}
    calls = {
        "(l) while sweep d1": lambda: F.fused_nnf_solve(
            d1.net, d1.rgate, b_act.v, ts_act, proto_dt=0.1, **WHILE),
        "(l') while sweep 5x200": lambda: F.fused_nnf_solve(
            wide.net, wide.rgate, b_act2.v, ts161, proto_dt=1.0,
            max_rec=4096),
        "(m) popsweep mxu_bf16": lambda: E.simulate_population(
            "nnf", popw, deact, ts_deact, SYNTHETIC, trips=TRIPS,
            mxu_bf16=True),
        "(n) probe bias": lambda: PR.main("bias", device=dev),
        "(n) probe fold": lambda: PR.main("fold", device=dev)}
    reset_counts()
    out, secs, path_pass = {}, {}, {}
    for name, call in calls.items():
        t = time.perf_counter()
        out[name] = call()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        if name.startswith("(l"):
            path_pass[name] = F.fused_nnf_solve.last_pass
    launches = {n: k.launches for n, k in kernels.items()}
    log(f"while/bf16/probe path: host clock s per call (first call, "
        f"synchronised) {secs}")
    check_counts("while/bf16/probe path", launches)
    for name, info in path_pass.items():
        log(f"{name}: {pass_text(info)}")
        if info["layer_pass"] != "cluster":
            raise RuntimeError(f"{name} took the {info['layer_pass']} pass")
    ys_l, ys_l2, i_bf, pr_bias, pr_fold = out.values()
    for name, x, shape in (("(l)", ys_l, (7, 80001, 2)),
                           ("(l')", ys_l2, (2, 161, 2)),
                           ("(m)", i_bf, (P_POP, 9, 100001)),
                           ("(n) bias", pr_bias, (64, 128)),
                           ("(n) fold", pr_fold, (64, 128))):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: shape {tuple(x.shape)} (expected "
                               f"{shape}) or non-finite values")

    # ---- (l) while-loop kernel vs plain, vs the sweep kernel, vs odeint ----
    s = F._sweep_setup(d1.net, d1.rgate, b_act.v, ts_act, 0.0, 0.1,
                       float(ts_act[-1]), WHILE["rtol"], WHILE["atol"],
                       WHILE["max_rec"], None, block=1)
    steps = WHILE["max_steps"]
    ms_k, out_k = cuda_ms(lambda: F._while_solve_cuda(s, steps), reps=3)
    info = F._while_solve_cuda.last_pass
    ms_p, out_p = cuda_ms(lambda: F._while_solve_plain(s, steps), reps=1,
                          warm=False)
    n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
    ys_k, ys_p = [F._dense_eval_popsweep_ft(*o[:3], o[3][0], o[3][0].abs(),
                                            ts_act)[0] for o in (out_k, out_p)]
    log(f"(l) while sweep B=7: n_acc/steps kernel {n_k}, plain {n_p}; kernel "
        f"{ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms per step, "
        f"{pass_text(info)}), plain {ms_p:.1f} ms; the path's launch equals "
        f"this one: {bool(torch.equal(ys_l, ys_k))}")
    err = gate_diff("(l) while sweep", ys_k, ys_p)
    # the same launch through mlp(): records bit for bit equal
    ms_g, out_g = cuda_ms(lambda: F._while_solve_cuda(
        dataclasses.replace(s, cluster=0), steps), reps=1, warm=False)
    same = same_records(out_k, out_g, n_k[0])
    log(f"(l) the same launch through mlp(): {ms_g:.3f} ms, records "
        f"{'bit-identical' if same else 'differ'}")
    if not same:
        raise RuntimeError("(l) the cluster pass's records differ from "
                           "mlp()'s")
    # its records against the sweep kernel's accepted trips of (b)
    b2_sc, b2_y, b2_k, b2_n, _ = fwd["b2"]["out"]
    acc = accepted_trips(b2_sc, int(b2_n[1]))
    n = min(n_k[0], acc.shape[0])
    diffs = torch.stack([
        (b2_sc[acc[:n]] - out_k[0][:n]).abs().amax(dim=1),
        (b2_y[acc[:n]] - out_k[1][:n]).abs().flatten(1).amax(dim=1),
        (b2_k[acc[:n]] - out_k[2][:n]).abs().flatten(1).amax(dim=1)])
    parted = torch.nonzero(diffs.amax(dim=0) != 0).flatten()
    log(f"(l) records vs the sweep kernel's accepted trips (n_acc {n_k[0]} "
        f"vs {acc.shape[0]} accepted of {int(b2_n[1])} trips): max |d| over "
        f"the first {n} = {float(diffs.max()):.3e}; first step at which they "
        f"part: {int(parted[0]) if parted.numel() else 'none'}")
    d_b2 = float((ys_k - fwd["b2"]["ys"]).abs().max())
    log(f"(l) gates vs the sweep kernel's: max |dy| = {d_b2:.3e} (tol "
        f"{GATE_TOL})")
    if not d_b2 <= GATE_TOL:
        raise RuntimeError(f"while vs sweep kernel {d_b2} > {GATE_TOL}")
    i_l = gate_current(ys_l, E._family_voltage(b_act, ts_act), SYNTHETIC)
    d_ode = float((i_l - fwd["i_ode"]).abs().max())
    log(f"(l) currents vs odeint: max |dI| = {d_ode:.3e} (tol "
        f"{CURRENT_TOL})")
    if not d_ode <= CURRENT_TOL:
        raise RuntimeError(f"while sweep vs odeint {d_ode} > {CURRENT_TOL}")
    in_bytes = (b_act.v.numel() + n_params + 4) * 4
    b_ms, b_by = trip_bound(n_k[1], len(act), 2 * macs, in_bytes)

    # ---- (l') the full-width test case against odeint ----------------------
    ref = torch.stack([E.solve_states("nnf", wide, p, ts161, rtol=1e-5,
                                      atol=1e-7) for p in act2])
    d_wide = float((ys_l2 - ref).abs().max())
    log(f"(l') 5x200 nnf_init on 2 protocols at 1 ms: max |dy| vs odeint = "
        f"{d_wide:.3e} (tol {WHILE_ODE_TOL})")
    if not d_wide < WHILE_ODE_TOL:
        raise RuntimeError(f"(l') while sweep vs odeint {d_wide}")
    rows.append(dict(
        name="fused_nnf_solve", route="cuda",
        source="ionflux_torch/csrc/fused_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:182",
        launches=launches["fused_nnf_solve"], max_abs_err=err, ms=ms_k,
        plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **cluster_fields(info, n_k[1], ms_k, ms_g)))

    # ---- (m) the popsweep in mxu_bf16 vs plain, vs f32 --------------------
    def pop_setup(pop, bf16):
        return F._popsweep_setup(pop.net, pop.rgate, b_de.v, ts_deact, 0.0,
                                 0.1, float(ts_deact[-1]), 1e-5, 1e-7, TRIPS,
                                 None, None, True, bf16, 1)

    s, s32 = pop_setup(popw, True), pop_setup(popw, False)
    q_pad = s.y0.shape[1]
    if q_pad != 16 or not all(torch.equal(b, b.bfloat16().float())
                              for _, b in s.layers):
        raise RuntimeError(f"(m): Q pads to {q_pad}; biases must be rounded")
    ms_k, out_k = cuda_ms(lambda: F._trip_solve_cuda(s), reps=3)
    ms_32, out_32 = cuda_ms(lambda: F._trip_solve_cuda(s32), reps=3)
    ms_p, out_p = cuda_ms(lambda: F._trip_solve_plain(s), reps=1,
                          warm=False)
    n_k, n_p, n_32 = (o[3].tolist() for o in (out_k, out_p, out_32))
    log(f"(m) popsweep mxu_bf16 P={P_POP} Q=9->16: n_acc/n_valid kernel "
        f"{n_k}, plain {n_p}; kernel {ms_k:.3f} ms ({ms_k / n_k[1]:.4f} ms "
        f"per trip), plain {ms_p:.1f} ms; the f32 kernel on the same nets: "
        f"n_acc/n_valid {n_32}, {ms_32:.3f} ms ({ms_32 / n_32[1]:.4f} ms per "
        f"trip)")
    recs = [F.PopsweepRecords(*o[:3], o[3][0], o[3][1], P_POP, q_pad, 9,
                              o[4]) for o in (out_k, out_p, out_32)]
    ys_bf = recs[0].evaluate(ts_deact)
    err = gate_diff("(m) popsweep mxu_bf16", ys_bf, recs[1].evaluate(ts_deact))
    v_de = E._family_voltage(b_de, ts_deact)[None]
    i_k = gate_current(ys_bf, v_de, SYNTHETIC)
    i_32 = gate_current(recs[2].evaluate(ts_deact), v_de, SYNTHETIC)
    dev_bf = float((i_k - i_32).abs().max())
    log(f"(m) bf16 vs f32 currents at full width: max |dI| = {dev_bf:.4e}, "
        f"{dev_bf / float(i_32.abs().max()):.3e} of their range (must be > "
        f"0); the path's launch equals this one: {bool(torch.equal(i_bf, i_k))}")
    if not dev_bf > 0.0:
        raise RuntimeError("(m) bf16 and f32 currents are identical")
    # the bound of tests/test_pallas.py::test_popsweep_mxu_bf16_storage at
    # its own shape: 3 nets of 1 x 16, two protocols at 1 ms, 161 times
    nets = [params_to_leaves(N.nnf_init(torch.Generator().manual_seed(k),
                                        HH_B06, 1, 16, device=dev))
            for k in range(3)]
    small = params_from_leaves([np.stack(x) for x in zip(*nets)], "nnf", dev)
    act40 = [P.activation_protocol(v, 1.0, device=dev) for v in (-40.0, 40.0)]
    i_small = [E.simulate_population("nnf", small, act40, ts161, SYNTHETIC,
                                     trips=2048, mxu_bf16=bf)
               for bf in (False, True)]
    dev_s = float((i_small[1] - i_small[0]).abs().max())
    rng_s = float(i_small[0].abs().max())
    log(f"(m) bf16 vs f32 currents at the reference test's shape: max |dI| "
        f"= {dev_s:.4e}, {dev_s / rng_s:.3e} of their range (must be in (0, "
        f"{BF16_DEV}))")
    if not 0.0 < dev_s < BF16_DEV * rng_s:
        raise RuntimeError(f"(m) small bf16 vs f32 {dev_s} of range {rng_s}")
    n_d1 = F._trip_solve_cuda(pop_setup(pop64, True))[3].tolist()
    log(f"(m) the bf16 kernel on the 64 d1 members of (c): n_acc/n_valid "
        f"{n_d1} of {TRIPS} trips (negative n_acc: t_end not reached)")
    in_bytes = (b_de.v.numel() + 8) * 4 + P_POP * (2 * macs
                                                   + 4 * (n_params - macs))
    b_ms, b_by = trip_bound(n_k[1], P_POP * 9, 2 * macs, in_bytes,
                            BF16_FLOPS)
    rows.append(dict(
        name="fused_nnf_popsweep_solve_ft[mxu_bf16]", route="cuda",
        source="ionflux_torch/csrc/fused_solve.cu",
        replaces="ionflux/ops/pallas_solve.py:1459",
        launches=launches["fused_nnf_popsweep_solve_ft"], max_abs_err=err,
        ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, **ring_fields(n_k[1], ms_k)))

    # ---- (n) the probe kernel vs plain, bias vs fold -----------------------
    import time_probe_torch as TT

    w, b = PR.probe_inputs(dev)
    err = 0.0
    ms, times = {}, {}
    for fold, got in ((False, pr_bias), (True, pr_fold)):
        # the kernel's own time (profiler), beside back-to-back calls as
        # the host issues them and as one CUDA graph replays them
        times[fold] = TT.probe_times(dev, fold, reps=200)
        us = times[fold]["us_kernel"] or times[fold]["us_graph"]
        ms[fold] = us / 1e3
        ms_p, ref = cuda_ms(lambda: B.bias_probe_plain(w, b, fold=fold),
                            reps=1)
        err = max(err, float((got - ref).abs().max()))
    d_case = float((pr_bias - pr_fold).abs().max())
    log(f"(n) probe: kernel {ms[False] * 1e3:.3f} us (bias), "
        f"{ms[True] * 1e3:.3f} us (fold) by the profiler; per call as the "
        f"host issues them {times[False]['us_eager']:.2f} / "
        f"{times[True]['us_eager']:.2f} us, in one CUDA graph "
        f"{times[False]['us_graph']:.3f} / {times[True]['us_graph']:.3f} "
        f"us; plain {ms_p:.2f} ms; kernel vs plain {err:.3e}, bias vs fold "
        f"{d_case:.3e} (tol {PROBE_TOL})")
    if not (err <= PROBE_TOL and d_case <= PROBE_TOL):
        raise RuntimeError(f"(n) probe: {err}, {d_case} > {PROBE_TOL}")
    p, _, m = w.shape
    q, trips = B.ROWS, B.TRIPS
    # the work the kernel does: per row and trip 8 operations (1 - acc, two
    # products, two sums, 1e-3 acc, its sum, tanhf counted as one) on
    # column 0 only; 3 floats read per member, [P, 128] written
    b_ms, b_by = roofline(trips * p * q * PROBE_ROW_OPS,
                          (3 * p + p * B.OUT_COLS) * 4)
    # what the JAX body computes: the whole [Q, 3] x [3, M] product
    full_ms, _ = roofline(trips * p * q * 2 * m * 3,
                          (w.numel() + b.numel() + p * B.OUT_COLS) * 4)
    mhz = sm_clock_mhz()
    floor_ms = trips * PROBE_CHAIN_OPS * FP32_LATENCY / (mhz * 1e3)
    log(f"(n) probe bound for the work done {b_ms * 1e3:.5f} us ({b_by}); "
        f"for the whole product {full_ms * 1e3:.5f} us; chain floor "
        f"{floor_ms * 1e3:.4f} us ({trips} trips x {PROBE_CHAIN_OPS} "
        f"dependent operations x {FP32_LATENCY} cycles at {mhz:.0f} MHz)")
    rows.append(dict(
        name="bias_probe", route="cuda",
        source="ionflux_torch/csrc/bias_probe.cu",
        replaces="scripts/probe_mosaic_bias_fault.py:41",
        launches=launches["bias_probe"], max_abs_err=err, ms=ms[False],
        plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms_fold=ms[True], ms_host_issued=times[False]["us_eager"] / 1e3,
        ms_graph=times[False]["us_graph"] / 1e3,
        bound_ms_whole_product=full_ms,
        chain_floor_ms=floor_ms, sm_clock_mhz=mhz, design=PROBE_DESIGN,
        layer_pass=NO_PASS))


def fit_path(dev, rows, d3, d5) -> None:
    """Phase (r): the four d0 objectives, the lockstep solve against its
    stepwise reference, the host loop over the lockstep objective, and the
    device-resident fit (``cmaes_onchip``) over the analytic and the fused
    objective; then K2 against its plain version and torch.linalg.eigh."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_d0_torch as T
    from ionflux_torch import protocols as P
    from ionflux_torch.fit.cmaes import _default_popsize, cmaes, cmaes_onchip
    from ionflux_torch.ops import hh_solve as H
    from ionflux_torch.ops import sym_eig as SE
    from ionflux_torch.solver import batched as TB

    f32 = torch.float32
    pop = _default_popsize(len(T.P0))
    xs = T.P0[None] * (1.0 + R_SPREAD * np.random.RandomState(0).randn(
        pop, 4))
    xs_t = torch.tensor(xs, dtype=f32, device=dev)
    b3 = H.fused_hh_pop_solve_ft
    reset_counts()

    # ---- the four objectives at P0 and at 8 members -----------------------
    objs = dict(
        lockstep=T.make_objective(d3, d5, pop, device=dev),
        analytic=T.make_objective_analytic(d3, d5, pop, device=dev),
        fused=T.make_objective_fused(d3, d5, pop, trips=HH_TRIPS,
                                     device=dev),
        native=T.make_objective_native(d3, d5))
    at_p0, at_xs, secs = {}, {}, {}
    for name, obj in objs.items():
        t = time.perf_counter()
        at_p0[name] = float(obj(T.P0[None])[0])
        first = time.perf_counter() - t
        if name != "native":
            t = time.perf_counter()
            at_xs[name] = obj(xs)
            secs[name] = time.perf_counter() - t
        else:
            secs[name] = first
        log(f"(r) {name}: SSE(P0) = {at_p0[name]:.6f}; first call "
            f"{first:.3f} s, {'second call (8 members)' if name != 'native' else 'one member'} "
            f"{secs[name]:.4f} s")
    ana = objs["analytic"]
    ms_eager, _ = cuda_ms(lambda: ana.device_fn(xs_t), reps=3)
    t = time.perf_counter()
    for _ in range(5):
        ana(xs)
    ms_replay = (time.perf_counter() - t) / 5 * 1e3
    # the objective's device time a generation: CUDA events around replays
    # of a graph of device_fn alone (the profiler's kernel sums run above
    # the unprofiled wall time for these ~1,000 small kernels)
    from ionflux_torch.ops._build import Graph
    g = Graph(ana.device_fn, xs_t.clone())
    ms_graph, _ = cuda_ms(g.replay, reps=20)
    log(f"(r) analytic objective, 8 members: eager {ms_eager:.3f} ms, "
        f"replayed {ms_replay:.3f} ms a generation (host clock, with the "
        f"SSE's copy to the host); its graph alone {ms_graph:.3f} ms (CUDA "
        f"events)")
    names = list(objs)
    worst = 0.0
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            rel = abs(at_p0[a] - at_p0[b]) / abs(at_p0[b])
            worst = max(worst, rel)
            if not (np.isfinite(at_p0[a]) and rel <= OBJ_RTOL):
                raise RuntimeError(f"(r) SSE(P0) {a} {at_p0[a]} vs {b} "
                                   f"{at_p0[b]}: {rel} > {OBJ_RTOL}")
            if a in at_xs and b in at_xs:
                rel = np.abs(at_xs[a] - at_xs[b]) / np.abs(at_xs[b])
                worst = max(worst, float(rel.max()))
                if not (np.all(np.isfinite(at_xs[a]))
                        and rel.max() <= OBJ_RTOL):
                    raise RuntimeError(f"(r) 8 members {a} vs {b}: "
                                       f"{rel.max()} > {OBJ_RTOL}")
    log(f"(r) objectives pairwise: worst relative difference {worst:.3e} "
        f"(tol {OBJ_RTOL}); SSE at the 8 members "
        f"{ {k: v.round(4).tolist() for k, v in at_xs.items()} }")

    # ---- the blocked lockstep solve vs its stepwise reference -------------
    protos3, ts3, _, _ = T._sweep_protos(T.RECORDINGS[0], dev)
    sweep0 = P.Protocol(protos3.t0[0], protos3.dt[0], protos3.v[0])
    y0 = torch.tensor([0.0, 1.0], dtype=f32, device=dev).repeat(pop, 1)
    solve = (T._rhs_hh_pop, y0, ts3, (xs_t, sweep0), 1e-5, 1e-7, 200_000,
             8192, None, None)
    out = {}
    for name, fn in (("blocked", TB._solve_blocked),
                     ("stepwise", TB._solve_stepwise)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, c = fn(*solve)
        ys = TB._finish(ts3, y0, st, c, False)
        torch.cuda.synchronize()
        out[name] = (st, ys, time.perf_counter() - t)
    (st_b, ys_b, s_b), (st_s, ys_s, s_s) = out["blocked"], out["stepwise"]
    n_acc, n_step = int(st_b.n_acc), int(st_b.n_step)
    same = ((n_acc, n_step) == (int(st_s.n_acc), int(st_s.n_step))
            and torch.equal(st_b.lane_ok, st_s.lane_ok)
            and all(torch.equal(a[:n_acc].view(torch.int32),
                                b[:n_acc].view(torch.int32))
                    for a, b in zip(st_b[10:], st_s[10:]))
            and torch.equal(ys_b.view(torch.int32), ys_s.view(torch.int32)))
    log(f"(r) lockstep Pr3 sweep 0 at {pop} lanes: {n_acc} accepted of "
        f"{n_step} steps; blocked {s_b * 1e3 / n_step:.3f} ms a step "
        f"({s_b:.3f} s), stepwise {s_s * 1e3 / n_step:.3f} ms a step "
        f"({s_s:.3f} s); records, counts and outputs "
        f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise RuntimeError("(r) the blocked lockstep solve differs from its "
                           "stepwise reference")

    # ---- two host-cmaes generations over the lockstep objective -----------
    t = time.perf_counter()
    res = cmaes(objs["lockstep"], T.P0, sigma0=0.1 * T.P0,
                bounds=(0.1 * T.P0, 10.0 * T.P0), max_iterations=2)
    secs_lock = (time.perf_counter() - t) / res.iterations
    log(f"(r) host cmaes over the lockstep objective: {res.iterations} "
        f"generations, {secs_lock:.3f} s a generation, best SSE "
        f"{res.fx:.4f}")
    if res.iterations != 2 or not np.isfinite(res.fx):
        raise RuntimeError("(r) host cmaes over the lockstep objective")

    # ---- the full d0 fit on the card: cmaes_onchip, analytic objective ----
    kw = dict(sigma0=T.P0 * 0.1, bounds=(T.P0 * 0.1, T.P0 * 10.0),
              max_unchanged_iterations=100, unchanged_threshold=1e-3,
              device=dev)
    t = time.perf_counter()
    cmaes_onchip(ana.device_fn, T.P0, max_iterations=8, **kw)
    s_short = time.perf_counter() - t          # capture + 2 replays
    t = time.perf_counter()
    fit = cmaes_onchip(ana.device_fn, T.P0, max_iterations=FIT_CAP, **kw)
    wall = time.perf_counter() - t
    replays = len(fit.history)
    ms_gen = (wall - s_short) * 1e3 / (8 * (replays - 2))
    ratio = fit.x / T.REF_D0
    log(f"(r) cmaes_onchip, analytic objective: {fit.iterations} "
        f"generations ({'cap reached' if fit.hit_max_iterations else 'unchanged rule'}), "
        f"{wall:.2f} s wall ({wall * 1e3 / fit.iterations:.3f} ms a "
        f"generation with the warm-up and the capture; {ms_gen:.3f} ms a "
        f"replayed generation, from {replays} replayed chunks less a "
        f"two-chunk fit's {s_short:.2f} s); best SSE {fit.fx:.6f}; "
        f"found/reference {ratio.tolist()}")
    log(f"(r) its device idle share, estimated: 1 - {ms_graph:.3f} ms (the "
        f"objective's graph, the bulk of a generation's device work) / "
        f"{ms_gen:.3f} ms a replayed generation = "
        f"{100 * (1 - ms_graph / ms_gen):.1f}%")
    if fit.hit_max_iterations or not np.all(np.abs(ratio - 1) <= FIT_RTOL):
        raise RuntimeError(f"(r) the on-card fit: found/reference {ratio} "
                           f"(tol {FIT_RTOL}), {fit.iterations} generations")

    # ---- cmaes_onchip over the fused objective, cut in depth --------------
    fus = objs["fused"]
    n0 = b3.launches
    t = time.perf_counter()
    res8 = cmaes_onchip(fus.device_fn, T.P0, max_iterations=8, **kw)
    s8 = time.perf_counter() - t
    n8 = b3.launches - n0
    t = time.perf_counter()
    res_f = cmaes_onchip(fus.device_fn, T.P0, max_iterations=FUSED_ITERS,
                         **kw)
    s16 = time.perf_counter() - t
    n16 = b3.launches - n0 - n8
    want = 16 * (1 + 8 * len(res_f.history))
    log(f"(r) cmaes_onchip, fused objective: {res_f.iterations} generations "
        f"(history {[h[0] for h in res_f.history]}), B3 launches {n16} (16 "
        f"eager warm-up + 16 x 8 x {len(res_f.history)} replayed, the "
        f"frozen lookahead chunk included; expected {want}); {s16:.3f} s "
        f"wall, {(s16 - s8) * 1e3 / 8:.3f} ms a replayed generation (against "
        f"the host loop's 0.013 s, PERF.md); best SSE {res_f.fx:.4f}")
    if (res_f.iterations != FUSED_ITERS or res8.iterations != 8
            or n16 != want or not np.isfinite(res_f.fx)):
        raise RuntimeError(f"(r) cmaes_onchip over the fused objective: "
                           f"{res_f.iterations} iterations, {n16} launches")
    launches = {"fused_hh_pop_solve_ft": b3.launches,
                "sym_eig": SE.sym_eig.launches}
    check_counts("(r) fit path", launches)
    for row in rows:
        if row["name"] == "fused_hh_pop_solve_ft":
            row["launches_by_path"] = {"d0 fit (f)-(k)": row["launches"],
                                       "objectives and fits (r)":
                                       launches["fused_hh_pop_solve_ft"]}
            row["launches"] += launches["fused_hh_pop_solve_ft"]
            row["onchip_ms_per_generation"] = (s16 - s8) * 1e3 / 8

    # ---- K2 against its plain version and torch.linalg.eigh ---------------
    rs = np.random.RandomState(1)
    q = rs.randn(1000, 4, 4)
    a = torch.tensor(q @ q.transpose(0, 2, 1) + 0.1 * np.eye(4), dtype=f32,
                     device=dev)
    ms_k, (w_k, v_k) = cuda_ms(lambda: SE.sym_eig(a), reps=50)
    ms_p, (w_p, v_p) = cuda_ms(lambda: SE.sym_eig_plain(a), reps=1,
                               warm=False)
    sweeps = SE.sym_eig_plain.last_sweeps
    ms_l, (w_l, v_l) = cuda_ms(lambda: torch.linalg.eigh(a), reps=5)
    same = torch.equal(w_k, w_p) and torch.equal(v_k, v_p)
    err = float(torch.maximum((w_k - w_p).abs().max(),
                              (v_k - v_p).abs().max()))
    scale = a.abs().amax(dim=(-2, -1), keepdim=True)
    d_w = float(((w_k - w_l).abs() / scale[..., 0]).max())
    rec = v_k @ torch.diag_embed(w_k) @ v_k.transpose(-2, -1)
    d_rec = float(((rec - a).abs() / scale).max())
    log(f"(r) K2 on 1,000 SPD 4 x 4: kernel vs plain "
        f"{'bit-identical' if same else f'max |d| {err:.3e}'} ({sweeps} "
        f"sweeps); vs torch.linalg.eigh: eigenvalues {d_w:.3e}, B diag(d) "
        f"B^T {d_rec:.3e} of the scale (tol {K2_TOL}); kernel {ms_k:.4f} "
        f"ms, plain {ms_p:.2f} ms, torch.linalg.eigh {ms_l:.4f} ms")
    if not (d_w <= K2_TOL and d_rec <= K2_TOL and err <= K2_TOL):
        raise RuntimeError("(r) K2 disagrees")
    # per matrix and sweep: 6 rotations of ~15 operations and 3 x 4 row
    # updates of 6; the matrices read once, w and v written once
    b_ms, b_by = roofline(1000 * sweeps * 6 * (15 + 3 * 4 * 6),
                          1000 * (16 + 4 + 16) * 4)
    rows.append(dict(
        name="sym_eig", route="cuda", source="ionflux_torch/csrc/sym_eig.cu",
        replaces="none (no pallas_call): jnp.linalg.eigh in "
                 "ionflux/fit/cmaes.py:260",
        launches=launches["sym_eig"], max_abs_err=err, ms=ms_k,
        plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=ms_l,
        design="warp-per-matrix-cyclic-jacobi", sweeps=sweeps,
        layer_pass=NO_PASS))


def surface_path(dev, rows) -> None:
    """Phase (s): the on-device derivative surface on the activation
    protocol at -60 mV (80,001 samples, tests/test_spline.py's case)
    against the scipy path, and K1 against its plain version on that
    protocol's segments."""
    from ionflux_torch import protocols as P
    from ionflux_torch.data import noise_sequence
    from ionflux_torch.eval import simulate_family
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.ops import spline as SP
    from ionflux_torch.surface import (SurfaceConfig, estimate_gate_surface,
                                       estimate_gate_surface_ondevice,
                                       smoothed_segments)

    f32 = torch.float32
    proto = P.activation_protocol(-60.0, 0.1, device=dev)
    # the grid made on the host, as the JAX test's: a float32 linspace made
    # on the card need not be strictly increasing, which FITPACK refuses
    t1 = torch.tensor(np.linspace(0.0, 8000.0, 80001), dtype=f32,
                      device=dev)
    cur = (simulate_family("hh", HH_B06, [proto], t1, SYNTHETIC)[0]
           .double().cpu().numpy() + noise_sequence([(80001,)], seed=0)[0])
    cur_t = torch.tensor(cur, dtype=f32, device=dev)
    mask1, _ = P.s_study_masks()
    cfg = SurfaceConfig()
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, a2, d2 = estimate_gate_surface_ondevice(proto, t1, cur_t, HH_B06,
                                               SYNTHETIC, mask1, cfg)
    s_dev = time.perf_counter() - t
    launches = {"tridiag_solve_batched": SP.tridiag_solve_batched.launches}
    check_counts("(s) surface path", launches)
    t = time.perf_counter()
    _, a1, d1 = estimate_gate_surface(proto, t1, cur, HH_B06, SYNTHETIC,
                                      mask1, cfg)
    s_host = time.perf_counter() - t
    rms_a = float(np.sqrt(np.mean((a1 - a2) ** 2)))
    rms_d = float(np.sqrt(np.mean((d1 - d2) ** 2)))
    log(f"(s) on-device surface: {len(a2)} points in {s_dev:.3f} s (the "
        f"r-gate solve included); scipy path {s_host:.3f} s; RMS a "
        f"{rms_a:.3e} (tol {SURF_RMS_A}), dadt {rms_d:.3e} (tol "
        f"{SURF_RMS_D})")
    if not (len(a1) == len(a2) and rms_a < SURF_RMS_A
            and rms_d < SURF_RMS_D):
        raise RuntimeError("(s) the on-device surface disagrees with the "
                           "scipy path")
    # K1 against its plain version on the protocol's segments
    _, smoothed = smoothed_segments(proto, t1, cur_t, cfg.smooth_window)
    dt = float(t1[1] - t1[0])
    system, _ = SP._spline_systems(smoothed, dt, "not-a-knot")
    lengths = system[4]
    ms_k, x_k = cuda_ms(lambda: SP.tridiag_solve_batched(*system), reps=20)
    ms_p, x_p = cuda_ms(lambda: SP.tridiag_solve_batched_plain(*system),
                        reps=1, warm=False)
    err = float((x_k - x_p).abs().max())
    d_k = torch.cat(SP.spline_derivative_segments(smoothed, dt))
    d_p = torch.cat(SP.spline_derivative_segments(
        [x.cpu() for x in smoothed], dt)).to(dev)
    rel = float((d_k - d_p).abs().max() / d_p.abs().max())
    log(f"(s) K1 on {len(lengths)} systems (longest {max(lengths)} rows): "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.1f} ms on the card; x "
        f"{'bit-identical' if torch.equal(x_k, x_p) else f'max |d| {err:.3e}'}"
        f"; didt vs the plain (CPU) path {rel:.3e} of its scale (tol "
        f"{K1_RTOL})")
    if not rel <= K1_RTOL:
        raise RuntimeError(f"(s) K1 vs plain on didt {rel} > {K1_RTOL}")
    n = sum(lengths)
    # forward 2 products, 2 differences, 2 quotients a row; back 1 and 1
    b_ms, b_by = roofline(8 * n, (5 * n + 3 * len(lengths)) * 4)
    rows.append(dict(
        name="tridiag_solve_batched", route="cuda",
        source="ionflux_torch/csrc/tridiag.cu",
        replaces="none (no pallas_call): lax.scan in "
                 "ionflux/ops/spline.py:23",
        launches=launches["tridiag_solve_batched"], max_abs_err=err,
        ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, systems=len(lengths), longest_system=max(lengths),
        design="thread-per-system", layer_pass=NO_PASS))


# (t): the other solvers on eval.simulate's route (tests/test_implicit.py's
# case and d1 over one activation step), each against odeint (dopri5)
METHODS = ("adams", "vcabm", "rosenbrock")
METHOD_TOL = 2e-3     # each method's current vs odeint's
# ... but Adams (ABM4) within 50 ms of a step edge: JAX's own Adams differs
# from its odeint by 2.45e-3 at the 7,000 ms edge of the 0 mV case
ADAMS_EDGE_TOL = 5e-3
EDGES_MS = (1000.0, 6000.0, 7000.0, 7500.0)   # the activation protocols'
RK4_T_SUB = 4         # odeint_rk4's substeps per 1 ms output interval
RK4_T_TOL = 1e-5      # its gates vs odeint and the closed form (the test's)
HEAD_MS = 1200.0      # the blocked/stepwise comparison and the timed solves
                      # run to here (the 1,000 ms step edge included)
PROFILE_MS = 30.0     # the profiled solves (each kernel is a trace event)
# the depth cut of (t): the idle share is profiled on the HH case only;
# d1's three profiled solves took ~30 s, nearly all of it the profiler's
# own (PERF.md has their idle shares)
# (u): neural-ODE training through the solve
NODE_STEPS = (3, 2)   # Adam updates by RK4 (the fused kernels) and by the
                      # adjoint
# the fused update is held to the float64 reference and to the eager
# update at tests/test_torch_node_rk4.py's card tolerances, which
# tests/_node_reference.py defines with the gap measure
ADJ_RK4_SUB = 32      # the fine RK4 the adjoint's gradient is held against
ADJ_REL = 1e-3        # adjoint vs backprop through a fine RK4 (JAX's bound)
MLP_LEVELS = 8        # dependent FMA levels of a 200-wide dot as a tree
CARRY_RTOL = 1e-4     # the carried net's RK4 current, card vs CPU


def kernel_trace(call, names=()) -> tuple[int, dict]:
    """Device kernels one ``call()`` runs (the profiler's count), and the
    device ms of the kernels whose name holds each of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in events), {
        n: sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if n in e.key) / 1e3 for n in names}


def idle_text(secs: float, busy_ms: float) -> str:
    """The idle share of an unprofiled run of ``secs`` whose profiled
    twin kept the device busy ``busy_ms`` (negative where the profiled
    kernels ran longer than the whole unprofiled run)."""
    if busy_ms <= 0:
        return "not measured"
    return (f"busy {busy_ms:.1f} ms of {1e3 * secs:.1f} unprofiled, idle "
            f"{100 * (1 - busy_ms / (1e3 * secs)):.1f}%")


def method_path(dev) -> None:
    """Phase (t): eval.simulate(method=...) for adams, vcabm and rosenbrock
    on HH_B06 over activation_protocol(0.0) (801 outputs to 8,000 ms) and on
    d1 (NN-f, out/d1) over the 20 mV activation step's first 2,000 ms (201
    outputs), each against odeint's current; each blocked solve against
    its stepwise loop (bit for bit), ms per step and the device's idle
    share; odeint_rk4 at a constant 0 mV against odeint and the closed
    form."""
    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.solver import adams, fixed, implicit, odeint, vcabm
    from ionflux_torch.utils.ckpt import load_pytree

    solvers = {"adams": (adams.odeint_adams, adams._adams_stepwise),
               "vcabm": (vcabm.odeint_vcabm, vcabm._vcabm_stepwise),
               "rosenbrock": (implicit.odeint_rosenbrock,
                              implicit._rosenbrock_stepwise)}
    d1 = load_pytree(os.path.join(ROOT, "out", "d1", "model.npz"), "nnf",
                     device=dev)
    cases = [("hh", "HH_B06, 0 mV, 8 s", HH_B06,
              P.activation_protocol(0.0, device=dev),
              torch.linspace(0.0, 8000.0, 801, device=dev)),
             ("nnf", "d1, 20 mV, 2 s", d1,
              P.activation_protocol(20.0, device=dev),
              torch.linspace(0.0, 2000.0, 201, device=dev))]
    kw = dict(rtol=1e-6, atol=1e-8)
    for kind, label, params, proto, ts in cases:
        ref = E.simulate(kind, params, proto, ts, SYNTHETIC, **kw)
        fn, y0, args = E._model_rhs(kind), E.default_y0(kind, device=dev), (
            params, proto)
        v = P.voltage(proto, ts)
        far = torch.as_tensor(np.abs(ts.cpu().numpy()[:, None] - np.array(
            EDGES_MS)[None]).min(axis=1) >= 50.0, device=dev)
        head = ts[ts <= HEAD_MS]   # the timed and stepwise solves' outputs
        short = ts[ts <= PROFILE_MS]
        steps, steps_s = {}, {}
        for m in METHODS:
            torch.cuda.synchronize()
            t = time.perf_counter()
            cur = E.simulate(kind, params, proto, ts, SYNTHETIC, method=m,
                             **kw)
            s_sim = time.perf_counter() - t
            diff = (cur - ref).abs()
            d, d_far = float(diff.max()), float(diff[far].max())
            tol = ADAMS_EDGE_TOL if m == "adams" else METHOD_TOL
            solve, stepwise = solvers[m]
            out, secs = {}, {}
            for name, f in (("blocked", solve), ("stepwise", stepwise)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out[name] = f(fn, y0, head, args, return_stats=True, **kw)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t
            (ys_b, st_b), (ys_s, st_s) = out["blocked"], out["stepwise"]
            same = st_b == st_s and bool(torch.equal(ys_b, ys_s))
            n = st_b.n_steps
            log(f"(t) {m} on {label}: |dI| vs odeint {d:.3e} (tol {tol}), "
                f"{d_far:.3e} at >= 50 ms from a step edge (tol "
                f"{METHOD_TOL}), simulate {s_sim:.2f} s (its first call "
                f"captures the block); to {HEAD_MS:.0f} ms: {st_b}; blocked "
                f"{secs['blocked']:.3f} s "
                f"({1e3 * secs['blocked'] / n:.3f} ms per step), stepwise "
                f"{secs['stepwise']:.3f} s ({1e3 * secs['stepwise'] / n:.3f}"
                f" ms per step), {'bit-identical' if same else 'DIFFERENT'}")
            if not (d <= tol and d_far <= METHOD_TOL and same and st_b.ok):
                raise RuntimeError(f"(t) {m} on {label}: |dI| {d}, blocked "
                                   f"{st_b} vs stepwise {st_s}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps[m] = solve(fn, y0, short, args, return_stats=True,
                             **kw)[1].n_steps
            torch.cuda.synchronize()
            steps_s[m] = time.perf_counter() - t
        if kind != "hh":   # the depth cut: d1's idle shares
            continue
        idle = {m: idle_text(steps_s[m], profiled(
            lambda f=solvers[m][0]: f(fn, y0, short, args, **kw), "none")[1])
            for m in METHODS}
        log(f"(t) {label}, each blocked solve to {PROFILE_MS:.0f} ms "
            f"profiled: " + "; ".join(f"{m} ({steps[m]} steps) {idle[m]}"
                                      for m in METHODS))

    # odeint_rk4 on tests/test_solver.py's case (HH_B06 at a constant 0 mV,
    # 1 ms outputs, 4 substeps), to 250 ms, against odeint and the closed
    # form
    proto = P.Protocol(torch.tensor(0.0, device=dev),
                       torch.tensor(5000.0, device=dev),
                       torch.tensor([0.0, 0.0], device=dev))
    ts = torch.linspace(0.0, 250.0, 251, device=dev)
    fn, y0 = E._model_rhs("hh"), E.default_y0("hh", device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ys = fixed.odeint_rk4(fn, y0, ts, (HH_B06, proto), n_sub=RK4_T_SUB)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    ref = odeint(fn, y0, ts, (HH_B06, proto), **kw)
    p = [float(x) for x in HH_B06]
    k = (p[0], p[2], p[4], p[6])   # the rates at 0 mV
    a_inf, r_inf = k[0] / (k[0] + k[1]), k[3] / (k[2] + k[3])
    tt = ts.double().cpu().numpy()
    exact = np.stack([a_inf * (1 - np.exp(-(k[0] + k[1]) * tt)),
                      r_inf + (1 - r_inf) * np.exp(-(k[2] + k[3]) * tt)], -1)
    d = float((ys - ref).abs().max())
    d_x = float(np.abs(ys.double().cpu().numpy() - exact).max())
    n = (ts.shape[0] - 1) * RK4_T_SUB
    log(f"(t) odeint_rk4 (n_sub {RK4_T_SUB}) on HH_B06 at a constant 0 mV: "
        f"max |dy| vs odeint {d:.3e}, vs the closed form {d_x:.3e} (tol "
        f"{RK4_T_TOL}); {secs:.3f} s eager ({1e3 * secs / n:.3f} ms per "
        f"step)")
    if not (d <= RK4_T_TOL and d_x <= RK4_T_TOL):
        raise RuntimeError(f"(t) odeint_rk4 vs odeint {d}, closed form {d_x}")


def neural_ode_path(dev, rows) -> None:
    """Phase (u): ``train_neural_ode_torch.main(--protocol act)`` at full
    width in both modes (NODE_STEPS Adam updates), the RK4 run's node_fwd
    and node_vjp launches counted (iters + 1 and iters) and each kernel's
    device ms (a row each), the fused update's kernels and its losses,
    gradient and change against the float64 plain reference and the eager
    update (the card test's tolerances), the graph path's replayed updates
    against eager ones (bit for bit, on a 40 ms window), the adjoint's
    gradient against backprop through a fine RK4, and the carried-across
    out/neural-ode/model.npz through the RK4 solve, card against CPU."""
    import tempfile

    sys.path[:0] = [os.path.join(ROOT, "scripts"), os.path.join(ROOT, "tests")]
    import _node_reference as R
    import train_neural_ode_torch as NO

    from ionflux_torch import protocols as P
    from ionflux_torch.models.registry import SYNTHETIC
    from ionflux_torch.ops import node_rk4 as NR
    from ionflux_torch.observe import gate_current
    from ionflux_torch.solver import adjoint as TAD
    from ionflux_torch.utils.ckpt import load_pytree

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mode, steps in zip(("rk4", "adjoint"), NODE_STEPS):
            argv = ["--protocol", "act", "--iters", str(steps), "--outdir",
                    tmp] + (["--adjoint"] if mode == "adjoint" else [])
            n_graphs = len(TAD._INTERVAL_GRAPHS)
            reset_counts()
            t = time.perf_counter()
            runs[mode] = run = NO.main(argv)
            secs = time.perf_counter() - t
            if not (np.isfinite(run.losses).all()
                    and np.isfinite(run.final_mae)):
                raise RuntimeError(f"(u) {mode}: non-finite loss or MAE")
            log(f"(u) main({' '.join(argv[:4])}"
                f"{' --adjoint' if mode == 'adjoint' else ''}): {secs:.1f} s;"
                f" losses {[round(x, 6) for x in run.losses]}; host s per "
                f"update {[round(x, 3) for x in run.step_s]}; final MAE vs "
                f"clean truth {run.final_mae:.4f}")
            if mode == "rk4":   # the updates and the final states()
                launches = {"node_fwd": NR._fwd_cuda.launches,
                            "node_vjp": NR._vjp_cuda.launches}
                check_counts("(u) main(--protocol act)", launches,
                             {"node_fwd": steps + 1, "node_vjp": steps})
            if mode == "adjoint" and len(TAD._INTERVAL_GRAPHS) != n_graphs + 1:
                raise RuntimeError("(u) the adjoint's backward interval was "
                                   "not captured exactly once")
    tr = runs["rk4"].trainer
    if not tr.fused:
        raise RuntimeError("(u) the published net did not take the fused "
                           "path")
    fused_ms = 1e3 * float(np.mean(runs["rk4"].step_s[1:]))
    adj_ms = [1e3 * x for x in runs["adjoint"].step_s]
    flops = 3 * 300 * NO.RK4_SUB * 4 * 2 * sum(
        int(w.numel() + b.numel()) for w, b in runs["rk4"].init)
    b_ms, b_by = roofline(flops, 0)
    chain = 300 * NO.RK4_SUB * 4 * len(runs["rk4"].init)
    floor_ms = chain * MLP_LEVELS * FP32_LATENCY / (sm_clock_mhz() * 1e3)
    n_fused, k_ms = kernel_trace(tr.step, tuple(launches))

    def trainer(ts, data, path):
        """A trainer of the pretrained net on the path asked: "fused",
        "graphs" (the size rule forced to 0) or "eager"."""
        with mock.patch.object(NR, "node_cluster", NR.node_cluster if
                               path == "fused" else lambda *_: 0):
            out = NO.Trainer(runs["rk4"].init, proto, ts, y0, data,
                             adjoint=False, graph=path != "eager")
        assert out.fused == (path == "fused")
        return out

    # the three paths on a 40 ms window (4 intervals), two updates each
    proto = P.activation_protocol(20.0, dt_ms=1.0, device=dev)
    ts = torch.linspace(0.0, 40.0, 5, device=dev)
    y0 = torch.tensor([0.0, 1.0], device=dev)
    data = runs["rk4"].data[:5].clone()
    trs = {path: trainer(ts, data, path)
           for path in ("eager", "graphs", "fused")}
    ms, win = {}, {}
    for path, t in trs.items():
        losses = [t.step()]
        first = [p.grad.detach().clone() for p in t.flat]
        ms[path], last = cuda_ms(t.step, reps=1, warm=False)
        win[path] = ([float(x) for x in losses + [last]], first, t.flat)
    eager, graphs, fused = trs["eager"], trs["graphs"], trs["fused"]
    same = win["eager"][0] == win["graphs"][0] and all(
        torch.equal(a, b) for a, b in zip(eager.flat, graphs.flat))
    init = [x for pair in runs["rk4"].init for x in pair]
    e_losses, e_first, e_flat = win["eager"]
    to_eager = R.gaps(win["fused"], (e_losses, e_first, [
        p.detach() - x for p, x in zip(e_flat, init)]), init)
    to_f64 = R.gaps(win["fused"], R.f64_reference(fused, init, 2), init)
    adj = NO.Trainer(runs["rk4"].init, proto, ts, y0, data, adjoint=True)
    adj.step()
    ms["adjoint"], _ = cuda_ms(adj.step, reps=1, warm=False)
    n_fwd, _ = kernel_trace(lambda: graphs._replay(0, *graphs._in[:3]))
    n_vjp, _ = kernel_trace(lambda: graphs._replay(1, *graphs._in))
    busy = {path: profiled(trs[path].step, "none")[1]
            for path in ("graphs", "fused")}
    busy["adjoint"] = profiled(adj.step, "none")[1]

    # the fused update's first loss and gradient at 301 outputs against the
    # eager update's (one eager update: ~2.1 M launches) and the float64
    # reference's; the forward's states against the reference's
    full = {path: trainer(runs["rk4"].trainer.ts, runs["rk4"].data, path)
            for path in ("eager", "fused")}
    with torch.no_grad():
        ys_fused = full["fused"].states()
    upd = {path: (float(t.step()), [p.grad for p in t.flat])
           for path, t in full.items()}
    t = time.perf_counter()
    r_losses, r_first, _, r_ys = R.f64_reference(full["fused"], init, 1)
    ref_s = time.perf_counter() - t
    (l_f, g_f), (l_e, g_e) = upd["fused"], upd["eager"]
    full_eager = (abs(l_f - l_e) / abs(l_e), R.norm_gap(g_f, g_e))
    full_f64 = (abs(l_f - r_losses[0]) / abs(r_losses[0]),
                R.norm_gap(g_f, r_first))
    err = {"node_fwd": float((ys_fused.double() - r_ys).abs().max()),
           "node_vjp": max(float((a.double() - b).abs().max())
                           for a, b in zip(g_f, r_first))}
    log(f"(u) RK4 update (9,600 right-hand sides forward), fused: "
        f"{fused_ms:.1f} ms an update, {n_fused} kernels, of which node_fwd"
        f" {k_ms['node_fwd']:.3f} ms and node_vjp {k_ms['node_vjp']:.3f} "
        f"ms (profiled); bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} "
        f"GFLOP); chain floor {chain} dependent layer applications forward,"
        f" {floor_ms:.3f} ms at {MLP_LEVELS} FMA levels each; the graph "
        f"path's interval graphs {n_fwd} and {n_vjp} kernels a replay "
        f"(captured in {graphs.capture_s:.2f} s); adjoint update ms "
        f"{[round(x, 1) for x in adj_ms]}")
    log(f"(u) 301 outputs, first update: fused vs float64 reference "
        f"({ref_s:.1f} s) loss {full_f64[0]:.2e} (tol {R.F64_LOSS_RTOL}), gradient "
        f"{full_f64[1]:.2e} by leaf (tol {R.F64_GRAD_TOL}), max |dys| "
        f"{err['node_fwd']:.2e}, max |dgrad| {err['node_vjp']:.2e}; fused "
        f"vs eager loss {full_eager[0]:.2e} (tol {R.EAGER_LOSS_RTOL}), "
        f"gradient {full_eager[1]:.2e} (tol {R.EAGER_GRAD_TOL})")
    log(f"(u) 40 ms window (4 intervals), two updates each: graphs vs "
        f"eager {'bit-identical' if same else 'DIFFERENT'} (loss, net); "
        f"fused vs float64 reference (loss, first gradient, change) "
        f"{[f'{x:.2e}' for x in to_f64]} (tol {R.F64_LOSS_RTOL}, "
        f"{R.F64_GRAD_TOL}, {R.F64_CHANGE_TOL}), vs eager "
        f"{[f'{x:.2e}' for x in to_eager]} (tol {R.EAGER_LOSS_RTOL}, "
        f"{R.EAGER_GRAD_TOL}, {R.EAGER_CHANGE_TOL}); eager "
        f"{ms['eager']:.1f} ms an update, graphs {ms['graphs']:.1f} ms, "
        f"fused {ms['fused']:.2f} ms, adjoint {ms['adjoint']:.1f} ms; "
        f"profiled: graphs {idle_text(ms['graphs'] / 1e3, busy['graphs'])};"
        f" fused {idle_text(ms['fused'] / 1e3, busy['fused'])}; adjoint "
        f"{idle_text(ms['adjoint'] / 1e3, busy['adjoint'])}")
    if not same:
        raise RuntimeError("(u) the replayed update differs from the eager "
                           "one")
    f64_tol = (R.F64_LOSS_RTOL, R.F64_GRAD_TOL, R.F64_CHANGE_TOL)
    eager_tol = (R.EAGER_LOSS_RTOL, R.EAGER_GRAD_TOL, R.EAGER_CHANGE_TOL)
    if not (all(g <= t for g, t in zip(to_f64 + full_f64, f64_tol + f64_tol))
            and all(g <= t for g, t in zip(to_eager + full_eager,
                                           eager_tol + eager_tol))):
        raise RuntimeError(f"(u) the fused update against float64 "
                           f"{to_f64}, {full_f64} and against eager "
                           f"{to_eager}, {full_eager}")
    for name, share in (("node_fwd", 1), ("node_vjp", 2)):
        bound, by = roofline(flops * share / 3, 0)
        rows.append(dict(
            name=name, route="cuda", source="ionflux_torch/csrc/node_rk4.cu",
            replaces="none (no pallas_call): odeint_rk4 under "
                     "jax.checkpoint, ionflux/solver/fixed.py:28",
            launches=launches[name], max_abs_err=err[name], ms=k_ms[name],
            plain_ms=None, bound_ms=bound, bound_by=by, library_ms=None,
            chain_floor_ms=floor_ms if name == "node_fwd" else None,
            cluster_size=tr.plan.csize, clusters=1,
            design="cluster-slices+k-split+mbarrier-dsmem",
            layer_pass="cluster"))

    # the adjoint's gradient against backprop through a fine RK4
    ts = torch.linspace(0.0, 500.0, 6, device=dev)
    y0 = torch.tensor([0.1, 0.9], device=dev)
    grads = {}
    for kind in ("adj", "rk4"):
        net = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for w, b in runs["rk4"].init]
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "adj":
            ys = TAD.odeint_adjoint(NO.rhs, y0, ts, (net, proto), 1e-7, 1e-9)
        else:
            ys = NO.odeint_rk4(NO.rhs, y0, ts, (net, proto),
                               n_sub=ADJ_RK4_SUB)
        (torch.mean(ys[:, 0] ** 2) + 0.3 * torch.mean(ys[:, 1])).backward()
        torch.cuda.synchronize()
        grads[kind] = (torch.cat([x.grad.reshape(-1) for p in net for x in p])
                       .double(), time.perf_counter() - t)
    (g1, s1), (g2, s2) = grads["adj"], grads["rk4"]
    rel = float((g1 - g2).norm() / g2.norm())
    elem = bool(((g1 - g2).abs() <= 1e-3 * g2.abs()
                 + 1e-3 * g2.abs().max()).all())
    log(f"(u) adjoint gradient (500 ms, 6 outputs, rtol 1e-7) vs backprop "
        f"through RK4 (n_sub {ADJ_RK4_SUB}): relative error {rel:.2e} (tol "
        f"{ADJ_REL}), elementwise {'within' if elem else 'OUTSIDE'} 1e-3; "
        f"{s1:.2f} s vs {s2:.2f} s")
    if not (rel < ADJ_REL and elem):
        raise RuntimeError(f"(u) adjoint vs backprop RK4 {rel}")

    # the carried-across JAX net through the RK4 solve: the card against
    # the CPU (which tests/test_torch_neural_ode.py holds against JAX's)
    path = os.path.join(ROOT, "out", "neural-ode", "model.npz")
    cur = {}
    for d in (dev, torch.device("cpu")):
        params = load_pytree(path, "nnf", device=d)
        pr = P.activation_protocol(20.0, dt_ms=1.0, device=d)
        ts = torch.linspace(0.0, 1500.0, 151, device=d)
        ys = NO.Trainer(params.net.layers, pr, ts,
                        torch.tensor([0.0, 1.0], device=d),
                        torch.zeros(151, device=d), adjoint=False).states()
        cur[d.type] = gate_current(ys, P.voltage(pr, ts), SYNTHETIC).cpu()
    d = float((cur["cuda"] - cur["cpu"]).abs().max())
    scale = float(cur["cpu"].abs().max())
    log(f"(u) out/neural-ode/model.npz through the RK4 solve (act, 151 "
        f"outputs to 1,500 ms): card vs CPU max |dI| {d:.3e} "
        f"({d / scale:.2e} of the largest current; tol {CARRY_RTOL})")
    if not (d <= CARRY_RTOL * scale and bool(torch.isfinite(cur["cuda"]).all())):
        raise RuntimeError(f"(u) carried net, card vs CPU RK4 {d}")


# (v): the s-studies on the card
STANDIN_MS = 3000.0   # the stand-in ap2hz.csv: the recorded APs' first 3 s
LOG2_RTOL = 1e-2      # --pred MAEs vs out/<s>/log2, which JAX wrote on a TPU
                      # (f32 dots as one bf16 pass): a rough check (the
                      # port's CPU and card runs land within 1.4e-3)
CPU_ROW_TOL = 1e-4    # two short rows, card vs CPU, of the current's range,
                      # 50 ms or more from a step edge ...
CPU_ROW_EDGE_TOL = 1e-3   # ... and anywhere: at an edge the two adaptive
                          # f32 solves straddle it differently ((q)'s rule)
CPU_ROWS = ("3.0ms", "10.0ms")   # the activation-time-constant rows
V_SEEDS, V_ITERS, V_EVERY = 1, 400, 400   # S1's recipe, cut from 4 x 4,000
V_REPLAY = 100        # updates replayed after it from the captured update
# the depth cut of (v): predict_study of S1 only; S2's (29.5 s,
# within 1.07e-3 of out/s2/log2 on the card, PERF.md) is left out
V_S2_ITERS = 200      # run_study(S2), cut from 4,000
# (w): the d-study replay
TABLE_RTOL = 1e-2     # table-1 MAEs vs out/table-1/table-1.txt (JAX on a
                      # TPU, the reference's yc-*.pt noise): a rough check
                      # (all five columns landed within 2.6e-3)
# the depth cut of (w): the two single-recording prediction columns; Pr3,
# Pr5 and Pr4 (the chained solve of (p) and (q)) took ~65 s more
TABLE_COLUMNS = ("Sinusoidal", "APs")


@contextlib.contextmanager
def tee_stdout(lines: list):
    """Print as usual and keep every line printed in ``lines``."""
    import io

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            sys.__stdout__.write(text)
            buf.write(text)
            return len(text)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        try:
            yield
        finally:
            lines.extend(buf.getvalue().splitlines())


def loss_lines(lines) -> list[tuple[str, float]]:
    """(label, MAE) of the printed "label | Total Loss x" lines, in order."""
    return [(ln.split("|")[0].strip(), float(ln.split()[-1]))
            for ln in lines if "| Total Loss" in ln]


def write_ap2hz_standin(refdir: str) -> str:
    """A stand-in test-protocols/ap2hz.csv under refdir: the recorded APs
    waveform's first 3,000 ms at 0.1 ms (30,001 rows of time [s], voltage
    [mV] under a header).  Written before the port's studies module is
    imported, which reads IONFLUX_REFERENCE then."""
    from ionflux_torch import protorec

    if "ionflux_torch.studies" in sys.modules:
        raise RuntimeError("write the stand-in before importing studies")
    v, dt = protorec.load_voltage("aps-cell5")
    n = int(round(STANDIN_MS / dt)) + 1
    path = os.path.join(refdir, "test-protocols", "ap2hz.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = np.stack([np.arange(n) * dt * 1e-3, v[:n]], axis=-1)
    np.savetxt(path, rows, delimiter=",", header="time[s],voltage[mV]",
               comments="", fmt="%.7g")
    return path


def standin_reference() -> str:
    """A temporary stand-in reference checkout holding (v)'s ap2hz.csv,
    named by IONFLUX_REFERENCE; returns its directory."""
    import tempfile

    refdir = tempfile.mkdtemp(prefix="ionflux-ref-")
    write_ap2hz_standin(refdir)
    os.environ["IONFLUX_REFERENCE"] = refdir
    return refdir


def s_study_path(dev) -> None:
    """(v) the s-studies on the card: ``predict_study`` of the committed
    S1 checkpoint against out/s1/log2 and two of S1's rows against the
    CPU, ``run_study_validated(S1, metric=s_rollout_maes)`` on S1's full
    surface (cut in depth; then V_REPLAY updates replayed from the captured
    update), and ``run_study(S2)`` on the cached surface."""
    import tempfile

    from ionflux_torch import eval as E
    from ionflux_torch import studies as S
    from ionflux_torch.fit import train as FT
    from ionflux_torch.models.registry import SYNTHETIC

    log(f"(v) AP2Hz is a STAND-IN: {S.REFDIR}/test-protocols/ap2hz.csv "
        f"holds the recorded APs' first {STANDIN_MS:.0f} ms, not the "
        f"reference's file; its rows are not the paper's numbers")
    t_phase = time.perf_counter()
    # ---- predict_study on the committed checkpoints ---------------------
    for spec in (S.S1,):
        params = S.load_study_params(spec, os.path.join(ROOT, "out",
                                                        spec.name), dev)
        lines, calls = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        with tee_stdout(lines), timed_calls(E, "simulate", calls):
            S.predict_study(spec, params)
        secs = time.perf_counter() - t
        got = loss_lines(lines)
        with open(os.path.join(ROOT, "out", spec.name, "log2")) as fh:
            want = loss_lines(fh.read().splitlines())
        if [g[0] for g in got[1:]] != [w[0] for w in want[1:]] \
                or len(got) != 26:
            raise RuntimeError(f"(v) {spec.name}: rows {got} against "
                               f"log2's {want}")
        n_rows = len(got)
        row_s = [calls[k][0] + calls[n_rows + k][0] for k in range(n_rows)]
        rel = [abs(g[1] - w[1]) / w[1] for g, w in zip(got[1:], want[1:])]
        log(f"(v) predict_study({spec.name}): {n_rows} rows in {secs:.1f} "
            f"s (truth {sum(c[0] for c in calls[:n_rows]):.1f} s, model "
            f"{sum(c[0] for c in calls[n_rows:]):.1f} s); s per row "
            f"{[round(x, 2) for x in row_s]}")
        log(f"(v) {spec.name} MAEs vs out/{spec.name}/log2 (all rows but "
            f"AP2Hz; JAX on a TPU): largest relative difference "
            f"{max(rel):.3e} at {got[1 + int(np.argmax(rel))][0]}; "
            f"AP2Hz (stand-in) {got[0][1]:.6f}")
        if not (all(np.isfinite(g[1]) for g in got)
                and max(rel) <= LOG2_RTOL):
            raise RuntimeError(f"(v) {spec.name}: {got} against {want} "
                               f"(rtol {LOG2_RTOL})")

    # two short rows (the 3 ms and 10 ms activation-time-constant steps),
    # one simulate_cases call on the card and the same on the CPU
    cpu = torch.device("cpu")
    pick, rows_c = [], None
    for d in (dev, cpu):
        rows_d = [r for r in S.prediction_cases(d)
                  if r[0].strip() in CPU_ROWS]
        p_d = S.load_study_params(S.S1, os.path.join(ROOT, "out", "s1"), d)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pick.append(E.simulate_cases(
            "nnf", p_d, [(r[2], r[3]) for r in rows_d], SYNTHETIC,
            **S._PRED_KW))
        torch.cuda.synchronize()
        log(f"(v) S1 rows {CPU_ROWS} by simulate_cases on {d.type}: "
            f"{time.perf_counter() - t:.1f} s")
        rows_c = rows_d
    for name, y_k, y_c, row in zip(CPU_ROWS, *pick, rows_c):
        yc, dy = y_c.double(), (y_k.double().cpu() - y_c.double()).abs()
        rng = float(yc.max() - yc.min())
        pr, ts = row[2], row[3].double()
        vk = pr.v.double()
        edges = float(pr.t0) + float(pr.dt) * torch.nonzero(
            vk[1:] != vk[:-1]).double()
        far = (ts[:, None] - edges[None, :, 0]).abs().min(dim=1).values >= 50
        err_all = float(dy.max()) / rng
        err_far = float(dy[far].max()) / rng
        log(f"(v) S1 row {name}: card vs CPU max |dI| {err_far:.3e} of the "
            f"range at {int(far.sum())} outputs 50 ms or more from an edge "
            f"(tolerance {CPU_ROW_TOL:g}), {err_all:.3e} anywhere "
            f"({CPU_ROW_EDGE_TOL:g})")
        if not (err_far <= CPU_ROW_TOL and err_all <= CPU_ROW_EDGE_TOL):
            raise RuntimeError(f"(v) row {name}: card vs CPU {err_far:.3e}"
                               f" / {err_all:.3e}")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- run_study_validated(S1, metric=s_rollout_maes) -------------
        out1 = os.path.join(tmp, "s1")
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, a, dadt = S.study_surface(S.S1, out1, device=dev)
        secs_surface = time.perf_counter() - t
        chunks, metric_calls, lines = [], [], []
        with tee_stdout(lines), timed_calls(S, "fit_chunk", chunks), \
                timed_calls(S, "s_rollout_maes", metric_calls):
            t = time.perf_counter()
            params1 = S.run_study_validated(
                S.S1, out1, n_seeds=V_SEEDS, iters=V_ITERS,
                val_every=V_EVERY, cached=True, metric=S.s_rollout_maes,
                device=dev)
            secs_run = time.perf_counter() - t
        # the study's update, replayed from the captured graph
        _, args, _, kw = chunks[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        S.fit_chunk(*args, **dict(kw, iters=V_REPLAY))
        torch.cuda.synchronize()
        ms_it = (time.perf_counter() - t) * 1e3 / V_REPLAY
        scores = [c[2]["score"] for c in metric_calls]
        kept_line = [ln for ln in lines if ln.startswith("kept")]
        log(f"(v) study_surface(S1): {v.size} points in {secs_surface:.1f} "
            f"s; run_study_validated(S1, n_seeds={V_SEEDS}, "
            f"iters={V_ITERS}, metric=s_rollout_maes): {secs_run:.1f} s; "
            f"{ms_it:.3f} ms per replayed Adam update ({V_REPLAY} more; "
            f"the chunk, with the warm-up and the capture, "
            f"{chunks[0][0]:.2f} s); "
            f"s_rollout_maes {[round(c[0], 1) for c in metric_calls]} s a "
            f"call (the first also solves the ground truth); scores "
            f"{[round(x, 5) for x in scores]}; {kept_line}")
        if not (len(metric_calls) == V_SEEDS * V_ITERS // V_EVERY
                and np.isfinite(min(scores)) and kept_line
                and os.path.exists(os.path.join(out1, "model.npz"))):
            raise RuntimeError(f"(v) run_study_validated(S1): {scores}")

        # ---- run_study(S2) on the cached surface ---------------------------
        out2 = os.path.join(tmp, "s2")
        os.makedirs(out2)
        shutil.copy(os.path.join(out1, "surface.npz"), out2)
        lines = []
        t = time.perf_counter()
        with tee_stdout(lines):
            S.run_study(S.S2, out2, iters=V_S2_ITERS, cached=True,
                        target_net=params1.net, device=dev)
        secs_s2 = time.perf_counter() - t
        ap = loss_lines(lines)
        log(f"(v) run_study(S2, iters={V_S2_ITERS}): {secs_s2:.1f} s; last "
            f"line {lines[-1]!r}")
        if not (ap and ap[-1][0] == "Pretraining" and np.isfinite(ap[-1][1])
                and any(ln.startswith("Target Loss") for ln in lines)):
            raise RuntimeError(f"(v) run_study(S2): {lines[-3:]}")
    log(f"(v) s-study phase: {time.perf_counter() - t_phase:.1f} s")


def replay_path(dev) -> None:
    """(w) the d-study replay: ``scripts/table_1_torch.py`` on out/d1,
    out/d2 and HH_D0_FIT, its MAEs against out/table-1/table-1.txt, one
    stage timed by ``utils.timing.StageTimer`` on the card."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import table_1_torch as T1
    finally:
        sys.path.pop(0)
    from ionflux_torch.utils.timing import StageTimer

    with open(os.path.join(ROOT, "out", "table-1", "table-1.txt")) as fh:
        want = {ln.split("&")[0].strip(): [float(x.strip(" \\\n"))
                                           for x in ln.split("&")[1:]]
                for ln in fh if ln.count("&") == 5 and "Pr3" not in ln}
    timer = StageTimer()
    cut = [c for c in T1.COLUMNS if c[0] in TABLE_COLUMNS]
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(T1, "COLUMNS", cut):
        with timer.stage("table_1_torch.main", sync=dev):
            table = T1.main(["--device", str(dev), "--outdir", tmp])
        with timer.stage("table_1_torch.main --cached", sync=dev):
            again = T1.main(["--cached", "--device", str(dev), "--outdir",
                             tmp])
    log("(w) StageTimer (synchronised with the card):\n" + timer.report())
    k_cols = [k for k, c in enumerate(T1.COLUMNS) if c[0] in TABLE_COLUMNS]
    worst = 0.0
    log(f"(w) columns {TABLE_COLUMNS} (cut from {[c[0] for c in T1.COLUMNS]})")
    for label in ("Original", "NN-f", "NN-d"):
        got = [table[T1.COLUMNS[k][0]][label] for k in k_cols]
        ref = [want[label][k] for k in k_cols]
        rel = [abs(g - w) / w for g, w in zip(got, ref)]
        worst = max(worst, max(rel))
        log(f"(w) {label:8s} {' '.join(f'{x:.3f}' for x in got)}  "
            f"(out/table-1/table-1.txt {' '.join(f'{x:.3f}' for x in ref)};"
            f" largest relative difference {max(rel):.3e})")
    if not (worst <= TABLE_RTOL and again == table):
        raise RuntimeError(f"(w) table 1: {table} against {want} (rtol "
                           f"{TABLE_RTOL}), cached rerun equal: "
                           f"{again == table}")


# (x): the real-data path on full-length stand-in cell-5 caches
# (tests/_r_study_standins.py: r1/ on Pr3 + Pr5, r1-bad/ on Pr3 + Pr4)
X_RECOVER_TOL = 1e-4  # recovered current (float32, the default) vs a g r
                      # (V - E), r by the exact propagator, of the range
X_ITERS = 400         # run_real_study(R1), cut from 16,000: one 400-update
                      # chunk, validated on Pr5
X_REPLAY = 100        # updates replayed after it from the captured update
X_PRED_RTOL = 1e-2    # --pred MAEs vs the JAX package's on the CPU
# tests/_r_pred_reference.py (JAX on the CPU, its measurements recovered in
# float64) on the same stand-in: predict_real_study(R1, out/r1).  The
# depth cut of (x): out/r2's replay (17.5 s, within 6.0e-5 of JAX's on the
# card, PERF.md) is left out
X_PRED_JAX = {"pr3": 0.08193854111296334, "pr5": 0.10295668579783995,
              "pr4": 0.053829042323877044}
X_OBJ_RTOL = 1e-2     # the four r0-bad objectives against the analytic one
X_FIT_RTOL = 1e-2     # each fitted p1-p4 vs the stand-in's generating ones
                      # (a CPU rehearsal at full size on float32
                      # measurements: 2.2e-3, both fits)
X_FIT_CAP = 600       # cmaes_onchip's generations (JAX's rule stops first)
X_FUSED_ITERS = 16    # cmaes_onchip over the fused objective: two chunks


def real_data_path(dev, rows) -> None:
    """(x) the real-data path on full-length stand-in caches, counters set
    to 0 just before and read just after, every call in the defaults a
    user gets (float32 recoveries): ``run_real_study(R1)`` at full width
    (5 x 200 NN-f, its 1,000-update pretrain, one 400-update chunk
    validated on Pr5 by the chained solve, then X_REPLAY updates replayed
    from the captured update); ``predict_real_study(R1)`` of the committed
    out/r1 against the JAX package's CPU MAEs; each protocol that these
    recovered (``recover_measurements`` of r1/ and r1-bad/) against the
    exact propagator's r-gate; the r0-bad fit
    (``scripts/train_r0_bad_torch.py``) at population 8 on the recovered
    r1-bad measurements: its four objectives, two fused evaluations (23 B3
    launches each, the second a graph replay), the host-loop CMA-ES over
    the analytic objective and ``cmaes_onchip`` (K2) over the analytic
    objective (both against the stand-in's generating p1-p4) and over the
    fused one (X_FUSED_ITERS generations, B3 inside the replayed chunks).
    Then B3 against its plain version on a Pr3 and a Pr4 sweep of r0-bad's
    lattice (the second with a y0 carry) and the replay against the eager
    objective, bit for bit."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _r_study_standins as RS
    import train_r0_bad_torch as T
    from ionflux_torch import protorec
    from ionflux_torch import rstudies as R
    from ionflux_torch import studies as S
    from ionflux_torch.fit.cmaes import _default_popsize, cmaes, cmaes_onchip
    from ionflux_torch.models import registry as REG
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.ops import hh_solve as H
    from ionflux_torch.ops import sym_eig as SE

    f32 = torch.float32
    b3 = H.fused_hh_pop_solve_ft
    t_phase = time.perf_counter()
    log(f"(x) the caches are STAND-INS written into {S.REFDIR}: a from "
        f"HH_CELL5_FIT (r1, plus 1e-3 noise) and from the reference r0-bad "
        f"fit (r1-bad); not the reference's files, not the paper's numbers")
    t = time.perf_counter()
    counts = RS.write_r_caches(S.REFDIR)
    log(f"(x) stand-in caches {counts} points in "
        f"{time.perf_counter() - t:.1f} s")
    if counts != {"r1": 213804, "r1-bad": 147336}:
        raise RuntimeError(f"(x) stand-in lattice {counts}")
    reset_counts()

    recoveries = []
    with tempfile.TemporaryDirectory() as tmp, \
            timed_calls(R, "recover_measurements", recoveries):
        # ---- run_real_study(R1) at full width ----------------------------
        chunks, vals, lines = [], [], []
        surface = R.load_reference_surface(R.R1)
        with tee_stdout(lines), timed_calls(R, "fit_chunk", chunks), \
                timed_calls(R, "simulate_long", vals):
            t = time.perf_counter()
            R.run_real_study(R.R1, os.path.join(tmp, "r1"), iters=X_ITERS,
                             surface=surface, device=dev)
            secs_run = time.perf_counter() - t
        maes = [float(ln.split("pr5 MAE")[1].split()[0]) for ln in lines
                if ln.startswith("Iter ")]
        if not (len(chunks) == X_ITERS // 400 and len(maes) == len(chunks)
                and np.isfinite(min(maes)) and "pretrain done" in lines):
            raise RuntimeError(f"(x) run_real_study: {lines[-3:]}")
        # the study's update, replayed from the captured graph
        _, args, _, kw = chunks[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        R.fit_chunk(*args, **dict(kw, iters=X_REPLAY))
        torch.cuda.synchronize()
        ms_it = (time.perf_counter() - t) * 1e3 / X_REPLAY
        n_pts = int(args[2].shape[0])
        log(f"(x) run_real_study(R1, iters={X_ITERS}): {secs_run:.1f} s on "
            f"{n_pts} points (the recovery of r1/ for its validator "
            f"{recoveries[0][0]:.1f} s; the chunk, with the warm-up and the "
            f"capture, {chunks[0][0]:.2f} s); {ms_it:.3f} ms per replayed "
            f"Adam update ({X_REPLAY} more); Pr5 validation "
            f"{[round(c[0], 2) for c in vals]} s a call; Pr5 MAEs {maes}, "
            f"kept {min(maes):.6f}")

        # ---- --pred replay of the committed JAX-trained checkpoint -------
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = R.predict_real_study(R.R1, os.path.join(ROOT, "out", "r1"),
                                   device=dev)
        secs = time.perf_counter() - t
    rel = {k: abs(got[k] - w) / w for k, w in X_PRED_JAX.items()}
    log(f"(x) predict_real_study(r1): {secs:.1f} s (its two recoveries "
        f"{[round(c[0], 1) for c in recoveries[1:]]} s); MAEs "
        f"{ {k: round(got[k], 6) for k in X_PRED_JAX} } against JAX on the "
        f"CPU {X_PRED_JAX}: largest relative difference "
        f"{max(rel.values()):.3e} (tol {X_PRED_RTOL})")
    if not max(rel.values()) <= X_PRED_RTOL:
        raise RuntimeError(f"(x) --pred r1: {got} vs {X_PRED_JAX}")

    # ---- the recoveries these made, against the exact r-gate -------------
    if len(recoveries) != 3:
        raise RuntimeError(f"(x) {len(recoveries)} recoveries, expected 3")
    meas = {}
    for secs, args, out, kw in recoveries[1:]:
        sub = os.path.basename(args[0])
        meas[sub] = out
        errs = RS.recovery_errors(args[0], out, args[1], args[2])
        for name, (tl, err) in errs.items():
            k = int(np.argmax(err))
            log(f"(x) recover_measurements {sub}/{name} float32: {tl.size} "
                f"points; |I - a g r (V - E)| with r exact: max "
                f"{err[k]:.3e} of the range at {tl[k]:.1f} ms (tol "
                f"{X_RECOVER_TOL})")
            if not err[k] <= X_RECOVER_TOL:
                raise RuntimeError(f"(x) recovery {sub}/{name}: {err[k]}")
    if sorted(meas) != ["r1", "r1-bad"]:
        raise RuntimeError(f"(x) recovered {sorted(meas)}")

    # ---- r0-bad on the card -------------------------------------------------
    m = {k: meas["r1-bad"][k] for k in ("pr3", "pr4")}
    pop = _default_popsize(len(T.P0))
    xs = T.P0[None] * (1.0 + R_SPREAD * np.random.RandomState(0).randn(
        pop, 4))
    xs[0] = T.P0
    objs = dict(lockstep=T.make_objective(m, pop, device=dev),
                analytic=T.make_objective_analytic(m, pop, device=dev),
                fused=T.make_objective_fused(m, pop, trips=HH_TRIPS,
                                             device=dev),
                native=T.make_objective_native(m))
    sse, secs = {}, {}
    for name, obj in objs.items():
        t = time.perf_counter()
        sse[name] = obj(xs[:1] if name == "native" else xs)
        secs[name] = time.perf_counter() - t
    n_first = b3.launches
    n_sweeps = sum(protorec.SWEEPS[f"{n}-cell5"][0] for n in ("pr3", "pr4"))
    t = time.perf_counter()
    f_replay = objs["fused"](xs)
    secs_replay = time.perf_counter() - t
    ref = sse["analytic"]
    rel = {k: float(np.max(np.abs(f - ref[:f.size]) / ref[:f.size]))
           for k, f in sse.items()}
    log(f"(x) r0-bad objectives at {pop} members (native: P0): SSE(P0) "
        f"{ {k: round(float(f[0]), 4) for k, f in sse.items()} }; seconds "
        f"{ {k: round(v, 3) for k, v in secs.items()} } (first calls), the "
        f"fused replay {secs_replay:.4f} s; relative to the analytic "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tol {X_OBJ_RTOL}); "
        f"B3 launches {n_first} + {b3.launches - n_first} (eager, replay)")
    if not (max(rel.values()) <= X_OBJ_RTOL and n_first == n_sweeps
            and b3.launches == 2 * n_sweeps):
        raise RuntimeError(f"(x) r0-bad objectives: {sse}, launches "
                           f"{b3.launches}")
    kw = dict(sigma0=T.P0 * 0.1, bounds=(T.P0 * 0.1, T.P0 * 10.0),
              max_unchanged_iterations=100, unchanged_threshold=1e-3)
    ana = objs["analytic"]
    t = time.perf_counter()
    fit_h = cmaes(ana, T.P0, **kw)
    secs_h = time.perf_counter() - t
    t = time.perf_counter()
    fit_o = cmaes_onchip(ana.device_fn, T.P0, max_iterations=X_FIT_CAP,
                         device=dev, **kw)
    secs_o = time.perf_counter() - t
    for label, fit, s_ in (("host cmaes", fit_h, secs_h),
                           ("cmaes_onchip", fit_o, secs_o)):
        ratio = fit.x / RS.R1BAD_TRUTH
        log(f"(x) r0-bad {label} over the analytic objective: "
            f"{fit.iterations} generations, {s_:.2f} s, best SSE "
            f"{fit.fx:.6f}; found / stand-in truth {ratio.tolist()} (tol "
            f"{X_FIT_RTOL})")
        if fit.hit_max_iterations or not np.all(np.abs(ratio - 1)
                                                <= X_FIT_RTOL):
            raise RuntimeError(f"(x) r0-bad {label}: {ratio}")

    # ---- cmaes_onchip over the fused objective (--fused --onchip) --------
    n0 = b3.launches
    t = time.perf_counter()
    fit_f = cmaes_onchip(objs["fused"].device_fn, T.P0,
                         max_iterations=X_FUSED_ITERS, device=dev, **kw)
    secs_f = time.perf_counter() - t
    n_f = b3.launches - n0
    want = n_sweeps * (1 + 8 * len(fit_f.history))
    log(f"(x) r0-bad cmaes_onchip over the fused objective: "
        f"{fit_f.iterations} generations (history "
        f"{[h[0] for h in fit_f.history]}), {secs_f:.2f} s with the capture; "
        f"B3 launches {n_f} ({n_sweeps} eager warm-up + {n_sweeps} x 8 x "
        f"{len(fit_f.history)} replayed, the frozen lookahead chunk "
        f"included; expected {want}); best SSE {fit_f.fx:.4f}")
    if (fit_f.iterations != X_FUSED_ITERS or n_f != want
            or not np.isfinite(fit_f.fx)):
        raise RuntimeError(f"(x) cmaes_onchip over the fused objective: "
                           f"{fit_f.iterations} iterations, {n_f} launches")
    launches = {"fused_hh_pop_solve_ft": b3.launches,
                "sym_eig": SE.sym_eig.launches}
    check_counts("(x) real-data path", launches)

    # ---- the fused replay against the eager objective, bit for bit -------
    f_eager = objs["fused"].device_fn(torch.tensor(xs, dtype=f32,
                                                   device=dev))
    f_eager = f_eager.cpu().numpy().astype(np.float64)
    same = np.array_equal(f_replay, f_eager)
    log(f"(x) fused objective: graph replay "
        f"{'bit-identical to' if same else 'DIFFERS from'} the eager "
        f"device_fn")
    if not same:
        raise RuntimeError("(x) the fused objective's graph and device_fn "
                           "differ")

    # ---- B3 against its plain version on r0-bad's lattice ----------------
    p8 = torch.tensor(np.concatenate([xs, np.tile(T.RGATE, (pop, 1))], 1),
                      dtype=f32, device=dev)
    errs, y0 = [], None
    for name in ("pr3", "pr4"):
        protos, _, n_sw, period = T._sweep_protos(f"{name}-cell5", dev)
        dt = float(protos.dt[0])
        idx, d = T._lattice(m, name)
        v_full = protorec.load_voltage(f"{name}-cell5")[0]
        ts_aug = torch.as_tensor(T._fused_lattice(idx, d, v_full, n_sw,
                                                  period, dt)[0][0],
                                 device=dev)
        kw = dict(proto_t0=0.0, proto_dt=dt, t_end=period * dt, rtol=1e-5,
                  atol=1e-7, trips=HH_TRIPS)
        ms_k, out_k = cuda_ms(lambda: H._hh_pop_solve(
            p8, protos.v[0], y0, plain=False, **kw), reps=3)
        ms_p, out_p = cuda_ms(lambda: H._hh_pop_solve(
            p8, protos.v[0], y0, plain=True, **kw), reps=1, warm=False)
        n_k, n_p = out_k[3].tolist(), out_p[3].tolist()
        ys = [F._dense_eval_ft(*o[:3], o[3][0], o[3][1], ts_aug,
                               lane_ok=o[4]) for o in (out_k, out_p)]
        errs.append(gate_diff(f"(x) B3 at {pop} lanes, {name} sweep 0 "
                              f"({ts_aug.numel()} outputs"
                              f"{', y0 carried' if y0 is not None else ''})",
                              *ys))
        if n_k[1] != n_p[1]:
            raise RuntimeError(f"(x) B3 {name}: n_valid {n_k} vs {n_p}")
        y0 = ys[0][:, -1, :].contiguous()
        in_bytes = (protos.v[0].numel() + p8.numel() + 2 * pop) * 4
        b_ms, b_by = trip_bound(n_k[1], pop, HH_RHS_OPS, in_bytes)
        log(f"(x) B3 {name} sweep 0: kernel {ms_k:.3f} ms ({n_k[1]} "
            f"executed trips, {ms_k * 1e3 / n_k[1]:.3f} us a trip), plain "
            f"{ms_p:.1f} ms; bound {b_ms:.5f} ms ({b_by})")
        if name == "pr3":
            b3_fields = dict(r0bad_ms=ms_k, r0bad_plain_ms=ms_p,
                             r0bad_n_valid=n_k[1], r0bad_bound_ms=b_ms,
                             r0bad_outputs=ts_aug.numel())
    for row in rows:
        if row["name"] in launches:
            n = launches[row["name"]]
            row.setdefault("launches_by_path", {
                "earlier phases": row["launches"]})["real-data path (x)"] = n
            row["launches"] += n
        if row["name"] == "fused_hh_pop_solve_ft":
            row.update(b3_fields)
            row["max_abs_err"] = max(row["max_abs_err"], *errs)
    log(f"(x) real-data phase: {time.perf_counter() - t_phase:.1f} s")


# (y): the r-study replay drivers on stand-ins
Y_TABLE2_RTOL = 1e-2  # table_2_torch's MAEs vs the JAX package's on the CPU
# tests/_r_replay_reference.py (JAX on the CPU, its measurements recovered
# in float64) on the same full-length stand-in: table 2 of out/r1, out/r2
# and HH_CELL5_FIT
Y_TABLE2_JAX = {
    "Original": [0.06333296958290326, 0.10470309030120514, 0.03179408836711117,
                 0.003240798101281684, 0.005441173600769743],
    "NN-f": [0.08193854111296334, 0.10295668579783995, 0.05888069511844905,
             0.04380078760932959, 0.08040300567418758],
    "NN-d": [0.08541850112214179, 0.12429834745250987, 0.034115939999692244,
             0.03505253467533, 0.047145267713559924],
}
Y_SHORT_RTOL = 1e-3   # each short-stand-in driver's MAEs against the
                      # recordings, card vs CPU, relative
Y_SUPP_TOL = CPU_ROW_EDGE_TOL   # the supplements' MAEs against the
                      # noiseless truth (0.01-0.06 nA), card vs CPU: of the
                      # case's current range, (v)'s rule for a row anywhere
                      # (two f32 adaptive solves straddle the AP stand-in's
                      # edges apart: 1.5e-3 relative, 4.6e-5 nA, on ap2hz)
# the supplements' cases in (y): the AP2Hz stand-in (the +20 mV activation,
# -100 mV deactivation and 300 ms activation-time-constant steps, 5-10 s
# each, are a depth cut)
Y_SUPP_CASES = ("ap2hz",)
Y_CPU_THREADS = 2     # each CPU process's torch threads, beside the card's
Y_SHORT_LIMIT_S = 600.0
# the drivers run on the short two-sweep stand-ins (the depth cut of (y)),
# card against CPU, in the groups the CPU runs as processes of their own
# beside the card's run (figure 4-s reads figure 4's caches, figure 6 the
# HH fit's of figures 4 and 5)
Y_GROUPS = (("figure_4_torch", "figure_4_s_torch", "figure_5_torch",
             "figure_6_torch"), ("table_s1_torch",),
            ("figure_supplements_torch",))
Y_SHORT = sum(Y_GROUPS, ())
# table S1's architectures on the short stand-ins: two of the twelve
# committed (5 x 200 and 5 x 10; the other ten are a depth cut)
Y_S1_ARCHS = ("s00", "s03")


def short_replay(device: str, ref: str, root: str, out: str,
                 names=Y_SHORT) -> dict:
    """The drivers ``names`` (of Y_SHORT) on ``device`` on the short two-sweep stand-ins
    of tests/_r_study_standins.py (protorec patched, PR4_N to 16 x the
    stand-in's Pr4 sweep so that "sweeps 1-3" is its sweep 1), the
    checkout ``ref`` named by studies.REFDIR, the drivers' out/ under
    ``root``, one --cached outdir ``out`` shared by all.  Returns {driver:
    its result}."""
    import importlib

    sys.path[:0] = [os.path.join(ROOT, "scripts"), os.path.join(ROOT, "tests")]
    import _r_study_standins as RS
    from ionflux_torch import protorec
    from ionflux_torch import studies as S

    mods = {n: importlib.import_module(n) for n in names}
    sweeps = {n: (v.size // p, p) for n, (v, p) in RS.SHORT.items()}
    z = [(50.0, 140.0, -1.0, 1.0, "C0"), (160.0, 280.0, -1.0, 1.0, "C1")]
    res = {}
    with contextlib.ExitStack() as st:
        for k, v in (("load_voltage", RS.short_voltage), ("SWEEPS", sweeps),
                     ("PR3_N", RS.SHORT["pr3-cell5"][0].size),
                     ("PR4_N", 16 * RS.SHORT["pr4-cell5"][1])):
            st.enter_context(mock.patch.object(protorec, k, v))
        st.enter_context(mock.patch.object(S, "REFDIR", ref))
        for m in mods.values():
            if hasattr(m, "ROOT"):
                st.enter_context(mock.patch.object(m, "ROOT", root))
            if hasattr(m, "zooms"):   # windows inside the stand-ins
                st.enter_context(mock.patch.object(m, "zooms", lambda: {
                    n: z for n in ("pr3", "pr4", "pr5", "sinewave", "aps")}))
        if "figure_supplements_torch" in mods:
            m = mods["figure_supplements_torch"]
            cases = m.cases
            st.enter_context(mock.patch.object(m, "cases", lambda dev: [
                c for c in cases(dev) if c[0] in Y_SUPP_CASES]))
        if "figure_4_s_torch" in mods:
            st.enter_context(mock.patch.object(
                mods["figure_4_s_torch"], "ZOOM",
                ((50, 140), (-1, 1), (-2, 2))))
        for name, m in mods.items():
            t = time.perf_counter()
            extra = ["--stored-pr4"] if name == "table_s1_torch" else []
            res[name] = m.main(["--device", device, "--outdir", out,
                                "--cached"] + extra)
            log(f"(y) {name} on the short stand-ins ({device}): "
                f"{time.perf_counter() - t:.1f} s")
    return res


def _short_main(device: str, ref: str, root: str, out: str, result: str,
                *names) -> None:
    """short_replay of ``names`` on ``device``, its results written as JSON
    to result: (y)'s short-stand-in runs, in processes of their own beside
    the full-length ones (the card's with TF32 off, the CPU's at
    Y_CPU_THREADS threads)."""
    sys.path.insert(0, ROOT)
    if device == "cpu":
        torch.set_num_threads(Y_CPU_THREADS)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    res = short_replay(device, ref, root, out, names)
    with open(result, "w") as fh:
        json.dump(res, fh)


def _leaves_of(x, path=""):
    """(path, float) of every number in a nested result."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves_of(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for k, v in enumerate(x):
            yield from _leaves_of(v, f"{path}/{k}")
    elif isinstance(x, (int, float, np.floating)) and not isinstance(x, bool):
        yield path, float(x)


def replay_standins(refdir: str) -> tuple[str, str]:
    """(y)'s stand-ins: the replay files (tests/_r_replay_standins.py) in the
    full-length checkout refdir (beside (x)'s caches), and a second
    checkout of the short stand-ins and a drivers' root (out/ of symlinks
    to the committed models, two of r1-tune's).  Returns (short checkout,
    root)."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _r_replay_standins as RR
    import _r_study_standins as RS
    from ionflux_torch import protorec

    RR.write_replay_files(refdir)
    short = tempfile.mkdtemp(prefix="ionflux-short-")
    sweeps = {n: (v.size // p, p) for n, (v, p) in RS.SHORT.items()}
    with mock.patch.object(protorec, "load_voltage", RS.short_voltage), \
            mock.patch.object(protorec, "SWEEPS", sweeps):
        RS.write_r_caches(short)
        RR.write_replay_files(short)
    os.makedirs(os.path.join(short, "test-protocols"))
    shutil.copy(os.path.join(refdir, "test-protocols", "ap2hz.csv"),
                os.path.join(short, "test-protocols", "ap2hz.csv"))
    root = tempfile.mkdtemp(prefix="ionflux-root-")
    os.makedirs(os.path.join(root, "out", "r1-tune"))
    for d in ("r1", "r2", "r1-bad", "s1", "s2") + tuple(
            f"r1-tune/{a}" for a in Y_S1_ARCHS):
        os.symlink(os.path.join(ROOT, "out", d), os.path.join(root, "out", d))
    return short, root


def r_replay_path(dev) -> None:
    """(y) the r-study replay drivers (no kernel: the chained solve and the
    device-paced odeint), on the stand-in checkout of (x) with the replay
    files of tests/_r_replay_standins.py: ``table_2_torch.main`` at full
    length in the default mode against the JAX package's CPU MAEs
    (Y_TABLE2_JAX, 1e-2 relative); ``figure_7_torch.main`` at full length
    on the recorded protocols (the a-trajectories' ranges, seconds); the
    other drivers (Y_SHORT) on the short two-sweep stand-ins, in processes
    of their own started with the phase, one on the card and Y_GROUPS on
    the CPU, each MAE card against CPU within 1e-3 relative (the
    supplements' within 1e-3 of the case's range)."""
    import tempfile

    from ionflux_torch import studies as S

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import figure_7_torch as F7
    import table_2_torch as T2

    t_phase = time.perf_counter()
    short, root = replay_standins(S.REFDIR)
    secs = time.perf_counter() - t_phase
    log(f"(y) stand-in replay files written ({secs:.1f} s): state dicts of "
        f"the committed models, traces of the HH fit; not the reference's "
        f"files, not the paper's numbers")
    tmp = tempfile.mkdtemp(prefix="ionflux-y-")
    # the short stand-ins: one process on the card, one on the CPU for
    # each of Y_GROUPS, all beside the full-length runs below
    runs = [(str(dev), "card", Y_SHORT)] + [
        ("cpu", f"cpu{k}", g) for k, g in enumerate(Y_GROUPS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import chip_smoke as C; C._short_main(*sys.argv[2:])", ROOT, d,
         short, root, os.path.join(tmp, name),
         os.path.join(tmp, f"{name}.json"), *names], cwd=ROOT,
        env=dict(os.environ, **({"CUDA_VISIBLE_DEVICES": ""} if d == "cpu"
                                else {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for d, name, names in runs]
    try:
        # ---- table 2 at full length --------------------------------------
        from ionflux_torch import eval as E
        from ionflux_torch import realdata as RD

        rec, long_, real = [], [], []
        t = time.perf_counter()
        with timed_calls(RD, "recover_measurements", rec), \
                timed_calls(E, "simulate_long", long_), \
                timed_calls(E, "solve_states_real", real):
            table = T2.main(["--device", str(dev), "--outdir",
                             os.path.join(tmp, "t2")])
        secs = time.perf_counter() - t
        log(f"(y) table 2's calls, seconds: recoveries "
            f"{[round(c[0], 1) for c in rec]}; simulate_long "
            f"{[(c[1][0], c[1][2], round(c[0], 1)) for c in long_]}; "
            f"solve_states_real "
            f"{[(c[1][0], c[1][2], round(c[0], 1)) for c in real]}")
        worst = max(abs(g - w) / w for label, ws in Y_TABLE2_JAX.items()
                    for g, w in zip(table[label], ws))
        for label, vals in table.items():
            want = " ".join(f"{x:.6f}" for x in Y_TABLE2_JAX[label])
            log(f"(y) table 2 {label:8s} "
                f"{' '.join(f'{x:.6f}' for x in vals)} (JAX on the CPU "
                f"{want})")
        log(f"(y) table_2_torch.main, full length: {secs:.1f} s; largest "
            f"relative difference from JAX {worst:.3e} (tol {Y_TABLE2_RTOL})")
        if not worst <= Y_TABLE2_RTOL:
            raise RuntimeError(f"(y) table 2: {table} vs {Y_TABLE2_JAX}")

        # ---- figure 7 at full length -------------------------------------
        t = time.perf_counter()
        traj = F7.main(["--device", str(dev), "--outdir",
                        os.path.join(tmp, "f7")])
        secs = time.perf_counter() - t
        from ionflux_torch import protorec

        for name, a in traj.items():
            n = protorec.load_voltage(f"{name}-cell5")[0].size
            if a.shape != (n,) or not np.isfinite(a).all():
                raise RuntimeError(f"(y) figure 7 {name}: {a.shape}")
        ranges = {k: (round(float(a.min()), 4), round(float(a.max()), 4))
                  for k, a in traj.items()}
        log(f"(y) figure_7_torch.main, full length: {secs:.1f} s; a ranges "
            f"{ranges}")

        # ---- the short stand-ins, card against CPU ------------------------
        t = time.perf_counter()
        logs = [p.communicate(timeout=Y_SHORT_LIMIT_S)[0] for p in procs]
        secs = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for (d, name, names), p, text in zip(runs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"(y) the {d} run of {names} failed:\n"
                               f"{text[-3000:]}")
        for line in text.splitlines():
            if "on the short stand-ins" in line:
                log(line.split("] ", 1)[-1])
        with open(os.path.join(tmp, f"{name}.json")) as fh:
            res.setdefault(name == "card", {}).update(json.load(fh))
    card, ref = res[True], res[False]
    got, want = dict(_leaves_of(card)), dict(_leaves_of(ref))
    if sorted(got) != sorted(want) or not got:
        raise RuntimeError("(y) card and CPU results differ in keys")
    log(f"(y) the short-stand-in drivers, a card process and "
        f"{len(Y_GROUPS)} CPU processes started with the phase: {secs:.1f} s "
        f"waited for them after the full-length runs; {len(got)} numbers; "
        f"table S1 rows {list(card['table_s1_torch']['rows'])}")
    # each number's error against its tolerance: relative for the MAEs
    # against the recordings, of the case's range for the supplements'
    scale, tol = {}, {}
    for k, w in want.items():
        case = k.split("/")[2]
        if k.startswith("/figure_supplements_torch/"):
            with np.load(os.path.join(tmp, "card", f"{case}-gt.npz")) as f:
                scale[k], tol[k] = float(np.ptp(f["y"])), Y_SUPP_TOL
        else:
            scale[k], tol[k] = max(abs(w), 1e-12), Y_SHORT_RTOL
    for name in Y_SHORT:
        ks = [k for k in want if k.startswith(f"/{name}/")]
        k = max(ks, key=lambda k: abs(got[k] - want[k]) / scale[k])
        err = abs(got[k] - want[k]) / scale[k]
        log(f"(y) {name}, card vs CPU: largest difference {err:.3e} "
            f"{'of the range' if 'supplements' in name else 'relative'} at "
            f"{k} (tol {tol[k]})")
        if not err <= tol[k]:
            raise RuntimeError(f"(y) card vs CPU: {k} {got[k]} vs "
                               f"{want[k]}")
    shutil.rmtree(tmp)
    shutil.rmtree(short)
    shutil.rmtree(root)
    log(f"(y) r-study replay phase: {time.perf_counter() - t_phase:.1f} s")


# (z): the sharded population path, two processes on the one card
Z_RANKS = 2
Z_TOL = 5e-3          # the gathered currents vs (c)'s unsharded launch
                      # (tests/test_parallel.py: each shard's own step clock)
Z_LIMIT_S = 300.0


def _z_rank() -> dict:
    """One rank of (z): ``simulate_population_sharded`` of (c)'s members on
    the deactivation family over the 'pop' axis, B1 counted."""
    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.models.registry import SYNTHETIC
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.parallel import global_mesh
    from ionflux_torch.utils.ckpt import params_from_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = global_mesh(("pop",))
    dev = mesh.device
    leaves = npz_leaves(os.path.join(ROOT, "out", "d1", "model.npz"))
    pop = params_from_leaves(population(leaves, P_POP, 0), "nnf", dev)
    deact = P.deactivation_family(0.1, device=dev)
    ts = deact[0].times()
    F.fused_nnf_popsweep_solve_ft.launches = 0
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    i = E.simulate_population_sharded("nnf", pop, deact, ts, SYNTHETIC,
                                      mesh=mesh, trips=TRIPS)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t
    i = i.cpu().numpy()
    import hashlib

    out = dict(rank=torch.distributed.get_rank(), device=str(dev),
               secs=secs, launches=F.fused_nnf_popsweep_solve_ft.launches,
               sha=hashlib.sha256(i.tobytes()).hexdigest(),
               backend=torch.distributed.get_backend())
    if out["rank"] == 0:
        out["i"] = i
    return out


def sharded_path(dev, rows, fwd) -> None:
    """(z) the sharded population path: ``simulate_population_sharded`` of
    (c)'s 64 perturbed d1 members on the deactivation family over Z_RANKS
    gloo processes on the one card (32 members a rank, one B1 launch each,
    no collective in the solve, the currents gathered through the host);
    each rank's shard against one process's ``simulate_population`` of the
    same members (bit for bit; comparison launches), the gathered currents
    against (c)'s unsharded launch (5e-3) and every rank's copy of them
    equal; and ``entry.dryrun_multichip(2)`` on the card, started with the
    sharded ranks.  B1's launches in the ranks join ``launches_by_path``."""
    import threading

    from ionflux_torch.entry import dryrun_multichip

    t_phase = time.perf_counter()
    # dryrun_multichip's two processes start with the sharded ranks: four
    # processes on the card, their start-up overlapped
    dry = {}

    def dryrun():
        try:
            dry["out"] = dryrun_multichip(2)
        except BaseException as exc:   # raised again by the main thread
            dry["error"] = exc
        dry["secs"] = time.perf_counter() - t_phase

    worker = threading.Thread(target=dryrun)
    worker.start()
    try:
        sharded_checks(dev, rows, fwd, t_phase)
    finally:
        worker.join()   # its own launcher kills its ranks at its limit
    if "error" in dry:
        raise dry["error"]
    log(f"(z) dryrun_multichip(2) on {dry['out']['device']}, beside the "
        f"sharded ranks: {dry['secs']:.1f} s from the phase's start, loss "
        f"{dry['out']['loss']:.4e}, pop losses "
        f"{dry['out']['pop_losses'].tolist()}, popsweep launches "
        f"{dry['out']['popsweep_launches']} (rank 0)")
    if (dry["out"]["popsweep_launches"] != 1
            or not dry["out"]["device"].startswith("cuda")):
        raise RuntimeError(f"(z) dryrun_multichip: {dry['out']['device']}, "
                           f"{dry['out']['popsweep_launches']} launches")
    log(f"(z) sharded population phase: {time.perf_counter() - t_phase:.1f} s")


def sharded_checks(dev, rows, fwd, t_phase: float) -> None:
    """(z)'s sharded ranks and their checks (``sharded_path``)."""
    import hashlib

    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.models.registry import SYNTHETIC
    from ionflux_torch.parallel import run_processes
    from ionflux_torch.utils.ckpt import params_from_leaves

    ranks = run_processes(_z_rank, Z_RANKS, timeout=Z_LIMIT_S)
    secs = time.perf_counter() - t_phase
    i = ranks[0]["i"]
    shas = {r["sha"] for r in ranks}
    per = P_POP // Z_RANKS
    launches = [r["launches"] for r in ranks]
    log(f"(z) {Z_RANKS} ranks ({ranks[0]['backend']}, "
        f"{[r['device'] for r in ranks]}): {secs:.1f} s with the spawn; "
        f"the sharded call {[round(r['secs'], 3) for r in ranks]} s a rank "
        f"(beside the dry run's ranks); "
        f"B1 launches {launches} a rank; currents {i.shape}, every rank's "
        f"copy {'equal' if len(shas) == 1 else 'DIFFERENT'}")
    if (len(shas) != 1 or hashlib.sha256(i.tobytes()).hexdigest() not in shas
            or launches != [1] * Z_RANKS or i.shape != (P_POP, 9, 100001)
            or not np.isfinite(i).all()):
        raise RuntimeError(f"(z) sharded ranks: {launches}, {shas}")
    leaves = npz_leaves(os.path.join(ROOT, "out", "d1", "model.npz"))
    pop = population(leaves, P_POP, 0)
    deact = P.deactivation_family(0.1, device=dev)
    ts = deact[0].times()
    for r in range(Z_RANKS):
        shard = [x[r * per:(r + 1) * per] for x in pop[:-8]] + pop[-8:]
        alone = E.simulate_population(
            "nnf", params_from_leaves(shard, "nnf", dev), deact, ts,
            SYNTHETIC, trips=TRIPS).cpu().numpy()
        same = np.array_equal(alone, i[r * per:(r + 1) * per])
        log(f"(z) rank {r}'s {per} members against one process's "
            f"simulate_population of them: "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError(f"(z) rank {r}'s shard differs")
    d = float(np.abs(i - fwd["i_pop"].cpu().numpy()).max())
    log(f"(z) gathered vs (c)'s unsharded launch: max |dI| {d:.3e} (tol "
        f"{Z_TOL}; each shard runs its own step clock)")
    if not d <= Z_TOL:
        raise RuntimeError(f"(z) sharded vs unsharded {d}")

    n = sum(launches)
    for row in rows:
        if row["name"] == "fused_nnf_popsweep_solve_ft":
            row.setdefault("launches_by_path", {
                "earlier phases": row["launches"]})[
                "sharded path (z), all ranks"] = n
            row["launches"] += n
            row["sharded_ms_per_rank"] = [r["secs"] * 1e3 for r in ranks]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ionflux_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    refdir = standin_reference()   # before studies is imported

    # ---- (a) device, build -------------------------------------------------
    card = device_line()
    log(f"(a) card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t = time.perf_counter()
    built = _build.build()
    log(f"(a) built {[os.path.relpath(p, ROOT) for p, _ in built.values()]} "
        f"in {time.perf_counter() - t:.1f} s")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    ptxas {name}:", line.strip())
        _build.load_library(name)

    rows = []
    fwd = forward_path(dev, rows)
    log(f"forward path done at {time.perf_counter() - t_start:.0f} s")
    while_probe_path(dev, rows, fwd)
    log(f"while/bf16/probe path done at {time.perf_counter() - t_start:.0f} "
        f"s")
    wide_check(dev)
    validation_path(dev, rows)
    log(f"validation path done at {time.perf_counter() - t_start:.0f} s")
    d3, d5 = d0_path(dev, rows)
    log(f"d0 path done at {time.perf_counter() - t_start:.0f} s")
    fit_path(dev, rows, d3, d5)
    log(f"fit path (r) done at {time.perf_counter() - t_start:.0f} s")
    training_path(dev, rows)
    log(f"training path done at {time.perf_counter() - t_start:.0f} s")
    surface_path(dev, rows)
    log(f"surface path (s) done at {time.perf_counter() - t_start:.0f} s")
    method_path(dev)
    log(f"solver methods (t) done at {time.perf_counter() - t_start:.0f} s")
    neural_ode_path(dev, rows)
    log(f"neural-ODE training (u) done at {time.perf_counter() - t_start:.0f}"
        f" s")
    s_study_path(dev)
    log(f"s-studies (v) done at {time.perf_counter() - t_start:.0f} s")
    replay_path(dev)
    log(f"d-study replay (w) done at {time.perf_counter() - t_start:.0f} s")
    real_data_path(dev, rows)
    log(f"real-data path (x) done at {time.perf_counter() - t_start:.0f} s")
    r_replay_path(dev)
    log(f"r-study replay (y) done at {time.perf_counter() - t_start:.0f} s")
    shutil.rmtree(refdir)
    sharded_path(dev, rows, fwd)
    log(f"sharded population path (z) done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ---- (e) results -------------------------------------------------------
    log(f"(e) every phase done at {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
