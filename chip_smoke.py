#!/usr/bin/env python3
"""Drive the PyTorch port (``dotsocp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --profile [DIR]  # also a torch.profiler window

Phases, each raising on failure:

1. Device: the card's name and power limit, and the HBM peak the bounds
   and shares use, by the card's full name
   (``dotsocp_tpu_torch.utils.profiling.hbm_peak_for``); TF32 off for
   matmuls.
2. Build: the hand-written kernels of ``dotsocp_tpu_torch/csrc/`` with nvcc,
   one process per source, in parallel; registers and spills per kernel,
   and the sweep kernel's shared memory a block.
3. Kernels against their plain PyTorch versions on the card, on seeded
   inputs, at 129^2 x 33 and 513^2 x 65 (2D) and 1025 x 33 (1D), within
   rtol 2e-5 / atol 2e-6 (the sGS sweep: one sweep, two in one call and
   two chained calls, one launch a sweep, its input phi unchanged, also on
   ``SWEEP_SHAPES``, grids its tiles and halos do not divide; the weighted
   q-step with
   love-heart barrier weights in 2D and seeded weights with walls in 1D;
   the single-step kernels z_step, q_step, q_step_w, beta_step and
   cone_project_diff and the phi-step rhs (phi_rhs, phi_rhs_w) with their
   inputs unchanged, q_step_w, cone_project_diff and the rhs bit-equal,
   and in 3D every q-step; the flat shift
   bit-equal at every axis stride; the kernels that take sd or E-derived
   scalars bit-equal with those read from memory, as the device driver's
   graphs launch them);
   a 4-iteration CA segment against 4 plain steps within rtol 2e-6 /
   atol 2e-6, unweighted and weighted (and weighted at 129^2 x 129); and
   4 ``run_one`` steps (the single-step kernels) against 4 ``_step_plain``
   steps at 17^2 x 7 within the same 2e-6, unweighted and weighted, the
   state handed to ``run_one`` unchanged.
3b. The same checks of every DIM = 3 kernel (C = 14; seeded weights with
   walls) at 17 x 33 x 65 x 9 (a different size on each axis), 33^3 x 17,
   the 3D scale level 129^3 x 33, and the levels of the 3D solves of
   phase 4f (65^3 x 33, 17^3 x 9), with the device memory peak of each;
   a 3D CA segment and 4 ``run_one`` steps against 4 plain steps at
   gaussian 17^3 x 9 within ``SEG_REL_3D`` of the largest entry.
4. The headline solve: DOTmark-4stitch 129^2 x 33, 3 levels, inPALM, tol
   1e-4, float32, through ``solve_dot(..., device="cuda")``: mass
   conservation, stop residuals, 470-574 iterations (522 is the anchor),
   every x-carry kernel launched, and phi_rhs once an iteration.
4b. The sGS path at the same size: ``sGS-inPALM``, levels 1-2 inPALM on the
   x-carry kernels, level 3 sGS on the sweep kernel and the single-step
   kernels (z_step, q_step, beta_step once an iteration); held to the JAX
   package's device driver's run of this configuration (``SGS_ANCHOR``).
4c. example2 65^2 x 17, 2 levels, tol 1e-4, float32: acc-sGS-ADMM, acc-ADMM
   and PALM, each within +-10% of its JAX float64 iteration count, with
   mass conservation and stop residuals; cone_project_diff once an
   iteration of every acc level.
4d. The weighted headline: love-heart 129^2 x 129, 3 levels, inPALM, tol
   1e-3, float32 (``demo_wdot2d.m``): within +-10% of the JAX package's
   12,718 iterations, mass conservation, stop residuals 1, 3, 6 below the
   requested tolerance on every level and below the level's own pyramid
   tolerance unless it stopped at maxit (as the JAX package's level 1
   does), no mass inside the (eroded) barrier, and one
   weighted q-step launch per iteration; and weighted acc-ADMM at
   33^2 x 9 against the JAX package's float32 count.
4e. ``solve_dot(..., opts={"profile": True})`` of the headline, each
   level's phase table printed; acc-ADMM's Nesterov branch (theta = 3) at
   example2 65^2 x 17, 2 levels, within +-10% of the JAX host driver's
   float64 count (``THETA3_ANCHOR``); ``profile_phases`` at 513^2 x 65 for
   inPALM, inPALM with love-heart weights (the weighted q_step kernel),
   sGS-inPALM and acc-ADMM.
4f. The 3D path, float32, tol 1e-4: gaussian 65^3 x 33, 3 levels, inPALM
   (``HEADLINE_3D_ANCHOR``, the x centre of mass on the geodesic 0.3, 0.5,
   0.7 within 5e-3, W2^2 printed); the demo default 33^3 x 17, 2 levels,
   gaussian and split8; split8 sGS-inPALM and gaussian acc-ADMM at
   17^3 x 9: each within +-10% of the JAX host driver's count, mass
   conservation, stop residuals, and the launches of each kernel per
   iteration or segment.
4g. The headline in float64 on the card, the plain route by dtype: exactly
   the float64 CPU anchor's 189 + 174 + 159 iterations, mass conservation,
   and no kernel launched.
4h. The refine tail (``opts["refine_tol"]``): the north star, the headline
   to KKT 1e-6 with a float64 tail under the port's
   ``refine_dct_split="auto"`` (``REFINE_ANCHOR``: the levels exactly
   189 + 174 + 159, the tail and the total within +-10% of the JAX
   package's; stop residuals below 1e-6, mass conservation, float64 rho,
   the CA kernels launched as often as in phase 4, so the tail launched
   none); dot1d gaussian 1025 x 33 to 1e-5, with float32 levels (stop
   residuals, mass, float64 rho; its count printed beside the JAX TPU
   count, as float32 rounding sets it in 1D) and with float64 levels
   (``DOT1D_F64_ANCHOR``, +-10%, no launch). Then
   the measurement behind "auto", printed on a JSON line of its own: one
   float64 tail iteration and one DCT solve under False, "ir" and "ir1" at
   129^2 x 33 and 513^2 x 65, the IR solves' error against the f64 solve,
   the north star under the other two modes, and a pure float64 solve to
   1e-6.
Every solve of phases 4-4h runs ``solve_dot``'s default ``driver="auto"``,
the device driver (CUDA-graph segments, ``algorithms/device_driver.py``).

5. Times at 513^2 x 65 with CUDA events: each kernel against its plain
   version (the weighted q-steps with love-heart weights), with its bytes
   and share of the card's HBM peak (the sweep against its one-pass bytes:
   phi, rhs read and the output written once), the phi-step, one CA
   iteration, one single-step iteration (``_step``) and one plain step, one
   sGS iteration, the sweep at 129^2 x 33; and one
   weighted CA iteration at 129^2 x 129. The same at the 3D scale level
   129^3 x 33 for every DIM = 3 kernel, and one CA, single-step, plain and
   sGS iteration there. Nothing about speed is asserted.
5b. The KKT battery's sums (``fused_step.kkt_sums``, one pass) against the
   plain battery at 513^2 x 65 (also weighted) and 129^2 x 33, 5 CA
   iterations into the level, with the device driver's scalars: every sum
   within 1e-5 of the plain one, both timed with CUDA events (20 launches,
   and 20 replays from a captured graph, as the check graph runs them),
   the bytes of the one pass and its bound, the device kernels a battery
   runs (torch.profiler); one JSON line ``kkt_battery``.
7. The device driver. 7a: from one state, 40 iterations replayed from its
   CUDA graphs against the same 40 run eagerly, then again after a
   rescale and after a sigma change, for the CA path at 129^2 x 33, the
   weighted CA path (love-heart 129^2 x 33), sGS-inPALM, acc-ADMM across
   an anchor restart, the 3D CA path at 17^3 x 9 and the float64 plain
   route: bit-equal, or within rtol 2e-5 / atol 2e-6 with the first tensor
   that differs printed; one CA iteration at 129^2 x 33 eager, replayed
   one iteration a graph, and as one 40-iteration graph. 7b: the headline,
   the north star, the sGS path, acc-ADMM 65^2 x 17, the weighted and the
   3D headline under ``driver="host"`` and ``driver="device"``: iterations,
   wall, per-kernel launches (the q-steps equal where the iterations are;
   the x-carry segments differ: the host driver cuts one more after each
   declined periodic rescale, the device driver one more at each chunk's
   end),
   host syncs (at most one a check in the device driver's loops, which run
   under ``torch.cuda.set_sync_debug_mode("error")``), with ``--profile``
   the device's busy share; the peak memory of 20 iterations at 513^2 x 65
   and 129^3 x 33 under each. 7c: a ``checkpoint_dir`` run cut by
   ``max_chunks=1`` and resumed ends with the uninterrupted run's
   iterations.

8. The fleet (``parallel/batch.py``). 8a: the batched x-carry kernels
   (``x_step_b``, ``qx_step_b``, ``cx_step_b``, ``cx_final_b``) on stacked
   seeded inputs with ragged per-instance sd and every third instance
   inactive, at B = 8 x 129^2 x 33, 32 x 65^2 x 17 and 3 x 17^3 x 9: each
   bit-equal per active instance to B launches of its single-instance
   kernel, the inactive instances and the ghost face slots untouched,
   within rtol 2e-5 / atol 2e-6 of its plain version; then each timed
   against its plain version and against B single-instance launches at the
   first two shapes. 8b: the fleet's finest level (fleet_bench's eight
   problems at 129^2 x 33), 40-iteration segments replayed from graphs
   bit-equal to eager, again after a per-instance rescale and a sigma
   change, a done instance frozen bit for bit; then one instance bit-equal
   to the single-instance device driver's segment from the same state.
   8c: that fleet (3 levels, tol 1e-4, inPALM, float32) through
   ``solve_fleet(mode="lockstep")``: every instance done, stop residuals
   below tol, mass conservation, the total iterations within +-10% of
   ``FLEET_ANCHOR`` (the JAX ``solve_batch`` on the CPU in float32; each
   instance's ``done_it`` printed against it), each rho within 1e-2 of
   ``mode="sequential"``'s (or, where the JAX package's own lockstep and
   single-instance solves differ by more, ``FLEET_REL_JAX``, within 1.1
   times that gap), at most one host sync a check (the loops under
   ``set_sync_debug_mode("error")``); the same fleet in float64 (the plain
   route) takes ``FLEET_ANCHOR_F64``'s ``done_it`` and iterations exactly
   and launches no kernel; the homogeneous fleet (8 x DOTmark) gives eight
   identical instances: the same done_it, rho within 1e-4 of its largest
   entry, bit-equal or not printed. 8d: instances/s of lockstep and
   sequential at B = 8 for ``demos/demo_batch.py``'s fleet at 33^2 x 9 and
   65^2 x 17 (2 levels), 129^2 x 33, 257^2 x 65 and 385^2 x 49 (3 levels),
   and 8c's at 129^2 x 33, one batched CA iteration against B single ones,
   peak memory of each, and the crossover in cells where lockstep stops
   winning on demo_batch's fleet (``parallel/batch.SATURATION_CELLS``).

9. User problems on the card, through the port's demos
   (``dotsocp_tpu_torch.demos``), each run counted from 0. 9a: the scale
   config, DOTmark-4stitch 513^2 x 65 from the committed data, 3 levels,
   inPALM, tol 1e-4, float32, ``driver="auto"``: mass conservation, stop
   residuals below 1e-4, the total within +-10% of the JAX package's 407
   (``SCALE_ANCHOR``); per-level counts, ``solve_dot``'s wall around a
   synchronize, the device busy share of a second, profiled solve, the
   peak memory, the launches. 9b: the maze (``demo_wdot2d --problem maze14
   --barrier maze14``, 129^2 x 129, 3 levels, tol 1e-3): no density in the
   eroded barrier, stop residuals 1, 3, 6 below the tolerance (a level
   short of its pyramid tolerance only at maxit where the JAX run stopped
   there too), the total within +-10% of ``MAZE_ANCHOR``, one
   ``qx_step_w`` an iteration; the same in float64 (the plain route, no
   launch) takes ``MAZE_F64_ANCHOR`` exactly. 9c: example5 129^2 x 33
   within +-10% of ``EXAMPLE5_ANCHOR``. 9d: every demo at its defaults
   prints ``Mass conservation: OK`` and a final KKT below its tolerance;
   ``demo_batch`` runs lockstep. Every kernel of this path (the x-carry
   kernels, ``qx_step_w``, the batched forms) launched at least once.

10. Multi-device (``opts={"mesh": ...}``, the sharded fleet), each rank a
   process spawned on this one card with ``backend="gloo"`` (NCCL refuses
   two ranks on one card) by ``dotsocp_tpu_torch.parallel.launch``: every
   rank has the world's deadline, and a rank that fails fails the phase.
   Its times are those of N ranks sharing one card over gloo, not a
   scaling figure. A world of 4 ranks: 10d, the comm layer on CUDA tensors
   (``shift`` along y and x, ``psum``, ``all_gather``, ``gather_blocks``)
   against one process's answers, exactly; 10a, the headline on a (y=2,
   x=2) mesh (the halo engine, plain PyTorch per rank, no kernel launched,
   as the JAX package under a mesh: inPALM's kernels all read
   neighbouring cells): identical ``DIST_RESULT`` records on every rank,
   the total within 470-574, mass conservation, stop residuals below the
   tolerance; wall and peak memory a rank; 10e, acc-ADMM at 129^2 x 33,
   one level, 100 iterations on the same mesh: identical records on every
   rank, cone_project_diff launched once an iteration on every rank and
   nothing else, and on a block of the rank's shape the kernel bit-equal
   to its plain version, within rtol 2e-5 / atol 2e-6 of ``proj_soc`` and
   its pads zero; 10f, the batch x spatial fleet (``solve_fleet(mode=
   "sharded")`` on a (batch=2, y=2) mesh: each batch row holds its
   instances' blocks on the halo engine): two instances at the scale
   config (DOTmark 4-stitch and example1, 513^2 x 65, 3 levels, tol 1e-4,
   float32) within +-10% of the shared iterations of the one-card lockstep
   fleet of the same two, run first, each rho within ``FLEET_GAP`` of it,
   every instance done with mass conservation and stop residuals below
   tol; four instances at 33^2 x 9, 2 levels, in float64, exactly the
   one-card lockstep run's iterations, done_it and chunk cuts, rho within
   1e-9; both with identical records on every rank, no piece captured as
   a graph and no kernel launched, and each rank's wall, peak memory and
   comm calls and bytes an iteration. A world of 2 ranks:
   10b, the scale config on a (y=2,) mesh within +-10% of the JAX 407, with
   the bytes the comm layer sent a rank per iteration; 10c, the
   fleet_bench fleet under ``solve_fleet(mode="sharded")``: the shared
   total within +-10% of ``FLEET_ANCHOR``, each instance's rho within
   ``FLEET_GAP`` of the one-process lockstep run's, the batched kernels
   launched on every rank; the same fleet in float64 exactly
   ``FLEET_ANCHOR_F64``'s; 10g, ``make_sharded_step`` over a ("batch",)
   mesh, fleet_bench's first 4 problems at 129^2 x 33 on the flat
   engine, 3 steps: each rank's gathered steps within 1e-5 of its own
   ``run_one`` of each instance (relative to each field's largest entry),
   and the rhs, z-, q- and beta-step kernels launched once a step for
   each of the rank's instances.

11. The solver cache (``opts["reuse_solvers"]``, default on, and
   ``opts["prewarm"]``; every phase starts with the cache empty). 11a: the
   headline twice from an empty cache: the second solve makes no capture
   and no eager run, takes the first's iterations (470-574) and its rho
   bit for bit; both walls and each level's wall split into build, prep,
   warm-ups, captures, loop and finish. 11b: two problems under one key,
   the second's solvers all taken from the cache and its result bit-equal
   to a ``reuse_solvers=False`` solve, with each level's E printed for
   both and differing at a level >= 2: example1 then DOTmark (inPALM,
   129^2 x 33), example3 then example4 (acc-ADMM, sGS-inPALM, 65^2 x 17),
   the love-heart densities then example1's on one love-heart weight
   (weighted inPALM, 65^2 x 33). 11c: the headline with ``prewarm`` from
   an empty cache: the solve itself captures nothing and runs nothing
   eagerly, bit-equal to 11a. 11d: the scale config twice: both walls and
   splits, bit-equal, the peak memory, the memory the cache holds and
   what is left after ``clear_solver_cache()``, the busy share of a warm
   solve. Phases 8c and 8d run the sequential fleet on the cache
   (instance 0 prewarmed), from an empty cache each.

12. The native oracle: the golden kernels (``dotsocp_tpu_torch/native``,
   CPU, float64) against the card at 129^2 x 33 through the shaped engine
   ``ops/engine.Ops3D``, which no solver runs (a solve asked for
   ``layout="3d"`` runs the flat engine): the shaped bfd, bfd_T and
   proj_soc in float64 within 1e-12; the sweep kernel's float32 output
   (two sweeps, D = 0.83) within rtol 2e-5 / atol 2e-6 of native.rb_sgs
   rounded; then the sweep and the cone projection on the shaped fields
   against their plain versions (the cone projection bit-equal).

The line before the last is a JSON object with one entry per kernel (its
launches on the main path: the sum over every solve and profile of phases
4-4e, 4g and 4h, each run with every count set to 0 just before and read just
after; its largest error against its plain version, its time and its
plain version's at 513^2 x 65, its bytes and the bound bytes / the HBM
peak; and under ``dim3`` the same for its DIM = 3 form at 129^3 x 33,
with its launches summed over the 3D solves of phase 4f; the batched
kernels' launches summed over the lockstep solves of phases 8c and 8d,
their times at B = 8 x 129^2 x 33, beside B single launches, and under
``b32_65x17`` at B = 32 x 65^2 x 17; every kernel's
``phase9_launches`` summed over phase 9's runs; phase 10's figures under
``multi_device``, phase 11's under ``solver_cache``, phase 12's under
``native_oracle``); the last line is
``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE_ANCHOR = 522
# the headline in float64: the JAX package and the port on the CPU both take
# 189 + 174 + 159 iterations (BASELINE.md:44)
HEADLINE_F64_ANCHOR = (189, 174, 159)
# DOTmark-4stitch 129^2 x 33, 3 levels, sGS-inPALM, tol 1e-4, float32:
# the JAX package's device driver (its "auto") on the CPU takes 214 + 189
# (levels 1-2, inPALM) + 1475 (level 3 converges), and the port's device
# driver on the CPU the same counts at the same check iterations. The JAX
# host driver's level 3 stops at maxit 6000 instead, short of the tolerance
# (stop residual 3.06e-4, mass error 2.708e-3 in float32): phase 7b's host
# run is held to those counts.
SGS_ANCHOR = (214, 189, 1475)
SGS_HOST_ANCHOR = (214, 189, 6000)
# example2 65^2 x 17, 2 levels, tol 1e-4: the JAX host driver in float64
# (acc-ADMM: tests/golden/dot2d_example2_65x17_l2_accadmm.npz)
VARIANT_ANCHORS = {"acc-sGS-ADMM": (1049, 2138), "acc-ADMM": (1049, 609),
                   "PALM": (809, 569)}
# love-heart 129^2 x 129, 3 levels, inPALM, tol 1e-3, float32: the JAX
# package's weighted headline took 12,718 iterations (BENCH_r05.json,
# wdot2d_iters). Its host driver on the CPU takes 10000 + 2409 + 69 =
# 12,478: level 1 stops at WDOT_MAXIT with stop residual 2.87e-4, short of
# its pyramid tolerance 2.5e-4 but below the requested 1e-3.
WDOT_ANCHOR = 12718
WDOT_MAXIT = 10000
# weighted acc-ADMM, love-heart 33^2 x 9, 1 level, tol 1e-3: 809 iterations
# in float32 with the JAX package's host driver on the CPU (the port's plain
# float32 path takes the same 809; float64 takes 144, the walls' 1e6 make
# this problem sensitive to the precision)
WDOT_ACC_ANCHOR = 809
# acc-ADMM's Nesterov branch, theta = 3, example2 65^2 x 17, 2 levels, tol
# 1e-4: the JAX package's host driver on the CPU in float64, and the port's
# plain float64 path with it
# (tests/test_torch_single_step.py::test_nesterov_anchor_matches_jax)
THETA3_ANCHOR = (1009, 649)
# relative bound of the weighted CA segment against plain steps at
# 129^2 x 129 after 4 iterations: the two plain paths on the CPU differ by
# 4.8e-7 of the largest entry there; the kernels add FMA contraction
SEG_REL_129 = 1e-5
RTOL, ATOL = 2e-5, 2e-6          # kernel vs plain (tests/test_pallas.py:108)
SEG_RTOL, SEG_ATOL = 2e-6, 2e-6  # CA segment vs plain steps (:202-204)
# the card's HBM peak in bytes/s, by its full name
# (dotsocp_tpu_torch.utils.profiling.hbm_peak_for; None for a card it does
# not know), set by check_device / card_peak
HBM_PEAK = None
DEVICE = "cuda"
# (nt, space) of the kernel checks, and of the timing level
CHECK_SHAPES = ((33, (129, 129)), (65, (513, 513)), (33, (1025,)))
SCALE = (65, 513)
# the sweep kernel's own checks beside CHECK_SHAPES and CHECK_SHAPES_3D:
# grids its tiles and 3-cell halos do not divide (axes of 3 to 5 cells,
# nt = 3 and 5, a 1D field below one 250-cell tile)
SWEEP_SHAPES = ((3, (5,)), (5, (200,)), (3, (4, 3)), (5, (3, 70)),
                (5, (515, 5)), (3, (5, 4, 3)), (5, (3, 17, 30)),
                (3, (20, 5, 61)))
# the largest |rb_sweep - plain sweep| per checked shape ("129x129x33")
SWEEP_ERRS = {}
# the 3D kernel checks: a different size on each axis (a swapped stride,
# size or spacing shows), the demo default 33^3 x 17, the 3D scale level
# 129^3 x 33 (one cone array 3.85 GB), which phase 5 also times, and the
# finest and coarsest levels the 3D solves of phase 4f run on
CHECK_SHAPES_3D = ((9, (17, 33, 65)), (17, (33, 33, 33)),
                   (33, (129, 129, 129)), (33, (65, 65, 65)),
                   (9, (17, 17, 17)))
# kernels that no solve of a path launches: the flat shift (on no solver
# path, as in the JAX package) and, in 3D, the weighted q-steps (the JAX
# package has no 3D weight model)
OFF_PATH = {"flat_shift"}
OFF_PATH_3D = OFF_PATH | {"qx_step_w", "q_step_w", "phi_rhs_w"}
SCALE_3D = (33, 129)
# gaussian 65^3 x 33, 3 levels, inPALM, tol 1e-4, float32: the JAX
# package's host driver on the CPU takes 1409 + 529 + 89 = 2027 iterations
HEADLINE_3D_ANCHOR = (1409, 529, 89)
# (n, nt, levels) of the 3D solves of phase 4f: the 3D headline, the demo
# default, the sGS-inPALM / acc-ADMM pair
HEADLINE_3D, DEMO_3D, VARIANT_3D = (65, 33, 3), (33, 17, 2), (17, 9, 2)
# 33^3 x 17, 2 levels, inPALM, tol 1e-4 (``demos/demo_dot3d.py``'s
# default): the JAX host driver on the CPU, float64 and float32 alike
DEMO_3D_ANCHORS = {"gaussian": (1449, 529), "split8": (689, 609)}
# 17^3 x 9, 2 levels, tol 1e-4: split8 with sGS-inPALM and gaussian with
# acc-ADMM, the JAX host driver on the CPU, float64 and float32 alike; both
# converge before maxit
VARIANT_3D_ANCHORS = {("sGS-inPALM", "split8"): (529, 1506),
                      ("acc-ADMM", "gaussian"): (1489, 1249)}
# relative bound of a 3D CA segment and of 3D run_one steps against plain
# steps at 17^3 x 9 after 4 iterations, as SEG_REL_129 in 2D
SEG_REL_3D = 1e-5
STEPS_3D = (17, 9)
# the north star (``bench.py:137-155``, BASELINE.json's metric): the headline
# to KKT 1e-6, float32 levels and a float64 tail. The JAX package took
# 189 + 174 + 159 float32 iterations and a 4,409-iteration tail, 4,931 in
# all, final KKT 9.98e-7 (BENCH_r05.json)
REFINE_OPTS = {"tol": 1e-4, "maxit": 6000, "refine_tol": 1e-6}
REFINE_ANCHOR = {"levels": (189, 174, 159), "tail": 4409, "total": 4931}
# dot1d (``bench.py:158-177``, ``demo_dot1d.m``): gaussian 1025 x 33, 3
# levels, to 1e-5 through the tail. The JAX package took 4,671 iterations on
# its TPU, final KKT 9.91e-6 (BENCH_r05.json). Its float32 levels stop at
# 5e-5, 7.1e-5 and 1e-4, at the float32 floor in 1D, so their counts follow
# the rounding: the same JAX solve takes 1489 + 1049 + 3000 + 609 = 6,147 on
# the CPU, the port's 7,707 there (PERF.md section 6). So the float32 run is
# held to its tolerance, mass and float64 rho, its count printed beside
# DOT1D_TPU_COUNT; the count is held on float64 levels, where both packages
# take 1329 + 389 + 114 + 1129 on the CPU (DOT1D_F64_ANCHOR), +-10% as the
# other anchors
DOT1D_OPTS = {"tol": 1e-4, "maxit": 3000, "refine_tol": 1e-5}
DOT1D_TPU_COUNT = 4671
DOT1D_F64_ANCHOR = (1329, 389, 114, 1129)
# (nt, n) of the f64 tail-iteration times behind refine_dct_split="auto",
# and the modes timed
REFINE_TIME_SHAPES = ((33, 129), (65, 513))
REFINE_MODES = (False, "ir", "ir1")
FUSED_CU = "dotsocp_tpu_torch/csrc/fused_step.cu"
SOURCES = {"x_step": FUSED_CU, "qx_step": FUSED_CU, "qx_step_w": FUSED_CU,
           "cx_step": FUSED_CU, "cx_final": FUSED_CU,
           "rb_sweep": "dotsocp_tpu_torch/csrc/sgs_sweep.cu",
           "z_step": FUSED_CU, "q_step": FUSED_CU, "q_step_w": FUSED_CU,
           "beta_step": FUSED_CU, "cone_project_diff": FUSED_CU,
           "flat_shift": "dotsocp_tpu_torch/csrc/flat_shift.cu",
           "phi_rhs": FUSED_CU, "phi_rhs_w": FUSED_CU}
REPLACES = {
    "x_step": "dotsocp_tpu/ops/pallas_kernels.py:812",
    "qx_step": "dotsocp_tpu/ops/pallas_kernels.py:860",
    # the weighted form of the same kernel (its weighted body at :899)
    "qx_step_w": ["dotsocp_tpu/ops/pallas_kernels.py:860",
                  "dotsocp_tpu/ops/pallas_kernels.py:899"],
    "cx_step": "dotsocp_tpu/ops/pallas_kernels.py:988",
    "cx_final": "dotsocp_tpu/ops/pallas_kernels.py:988",
    "rb_sweep": ["dotsocp_tpu/ops/pallas_kernels.py:71",
                 "dotsocp_tpu/ops/pallas_kernels.py:181"],
    "z_step": "dotsocp_tpu/ops/pallas_kernels.py:531",
    "q_step": "dotsocp_tpu/ops/pallas_kernels.py:587",
    # the weighted form of the same kernel (its weighted body at :632)
    "q_step_w": ["dotsocp_tpu/ops/pallas_kernels.py:587",
                 "dotsocp_tpu/ops/pallas_kernels.py:632"],
    "beta_step": "dotsocp_tpu/ops/pallas_kernels.py:750",
    "cone_project_diff": "dotsocp_tpu/ops/pallas_kernels.py:1094",
    "flat_shift": "dotsocp_tpu/ops/pallas_kernels.py:321",
    # no Pallas kernel: the JAX package's phi-step rhs, one XLA fusion
    "phi_rhs": "dotsocp_tpu/algorithms/core.py:207",
    "phi_rhs_w": "dotsocp_tpu/algorithms/core.py:207",
}


def log(msg=""):
    print(msg, flush=True)


def require(cond, msg):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


_T0 = time.monotonic()


def phase(n, title):
    """A phase's heading; every phase starts with the solver cache empty,
    so that the cache holds one phase's levels at most."""
    clear_cache()
    log(f"\n== phase {n}: {title} ({time.monotonic() - _T0:.1f} s in)")


def clear_cache():
    from dotsocp_tpu_torch.multilevel.solve import clear_solver_cache

    clear_solver_cache()


def cold_memory(torch):
    """The solver cache emptied and the peak-memory count restarted: what a
    peak measured from here holds is the measured run's alone."""
    clear_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


# -- phase 1 --------------------------------------------------------------------

def check_device(torch):
    from dotsocp_tpu_torch.ops.poisson import full_precision_matmul

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"count {torch.cuda.device_count()}")
    log("nvidia-smi name, power.limit:")
    log(smi)
    peak = card_peak(torch)
    log(f"HBM peak used for bounds and shares: "
        f"{'none known for this card' if peak is None else f'{peak / 1e12:g} TB/s'}"
        f" ({name})")
    full_precision_matmul()
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision is not 'highest'")
    return name, smi


def card_peak(torch):
    """The card's HBM peak in bytes/s by its full name (None if unknown);
    sets ``HBM_PEAK``."""
    global HBM_PEAK
    from dotsocp_tpu_torch.utils.profiling import hbm_peak_for

    HBM_PEAK = hbm_peak_for(torch.cuda.get_device_name(0))
    return HBM_PEAK


def share(nbytes, ms):
    """'NN% of P TB/s' for nbytes moved in ms (none for an unknown card)."""
    if HBM_PEAK is None:
        return "no HBM peak known"
    return (f"{100 * nbytes / (ms * 1e-3) / HBM_PEAK:.0f}% of "
            f"{HBM_PEAK / 1e12:g} TB/s")


def bound_ms(nbytes):
    return None if HBM_PEAK is None else 1e3 * nbytes / HBM_PEAK


# -- phase 2 --------------------------------------------------------------------

def register_report(ptxas_log):
    """(kernel<args>, registers, spill store bytes, spill load bytes) of
    every entry function in the compiler's ``-Xptxas -v`` report."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          m.group(1))
            name = m.group(1) if k is None else k.group(1)
            if k is not None and k.group(2):
                name += "<{}>".format(", ".join(
                    v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E", k.group(2))))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return rows


def build_kernels():
    """Build the kernels; print and return the register report, the
    DIM = 3 forms (C = 14) first."""
    from dotsocp_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.library()
    info = _build.build_info
    log(f"libraries {', '.join(info['paths'])} "
        f"({'cached' if info['cached'] else 'built in parallel'}) in "
        f"{time.monotonic() - t0:.2f} s")
    rows = register_report(info.get("log", ""))
    rows.sort(key=lambda r: ("<3" not in r[0] and "<14" not in r[0], r[0]))
    for name, regs, st, ld in rows:
        log(f"  {name:38s} {regs:3d} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    require(rows or info["cached"], "no register report from ptxas")
    lib = _build.library()
    smem = {d: (lib.dotsocp_rb_sweep_smem_bytes(d),
                lib.dotsocp_rb_sweep_blocks_per_sm(d)) for d in (1, 2, 3)}
    log("  rb_sweep_kernel<DIM> dynamic shared memory a block, blocks an "
        "SM: " + ", ".join(f"DIM {d} {b} B, {n}" for d, (b, n) in smem.items()))
    require(all(n >= 1 for _, n in smem.values()), "rb_sweep_kernel: a block "
            "does not fit an SM")
    return [dict(kernel=n, registers=r, spill_store_bytes=st,
                 spill_load_bytes=ld) for n, r, st, ld in rows] + [
        dict(kernel=f"rb_sweep_kernel<{d}>", smem_bytes=b, blocks_per_sm=n)
        for d, (b, n) in smem.items()]


# -- phase 3 --------------------------------------------------------------------

class Compare:
    """Kernel-vs-plain checks; keeps the largest error per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_abs = {}

    def __call__(self, name, got, want, rtol=RTOL, atol=ATOL, exact=False):
        """Largest |got - want|; held to rtol/atol, and to 0 if exact."""
        torch = self.torch
        got = got.float()
        want = want.float()
        require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
                f"against {tuple(want.shape)}")
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        diff = (got - want).abs()
        err = float(diff.max())
        excess = float((diff - (atol + rtol * want.abs())).max())
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), err)
        require(excess <= 0, f"{name}: max |kernel - plain| = {err:.3e} "
                f"exceeds rtol {rtol:g} / atol {atol:g}")
        require(not exact or err == 0.0, f"{name}: max |kernel - plain| = "
                f"{err:.3e}, not bit-equal")
        return err


def level_scalars(geom):
    """D, E, dScale as InitialScaling sets them on a first level."""
    import math

    D = math.sqrt(2.0) * math.sqrt(geom.h_mean)
    E = D / math.sqrt(2.0)
    return D, E, E * math.sqrt(2.0)


def random_inputs(torch, geom, seed, dev):
    import numpy as np

    from dotsocp_tpu_torch.ops.engine import OpsFlat
    from dotsocp_tpu_torch.ops.staggered import Staggered

    ops = OpsFlat(geom, torch.float32, dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, nt, S, C = geom.ndim_space, geom.nt, ops.S, geom.cone_cols

    def rand(*shape):
        if d == 3:  # gigabytes at 129^3 x 33: drawn on the card
            return torch.randn(shape, generator=gen, device=dev)
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def stag():  # ghost face slots exactly zero, as the solver keeps them
        return Staggered(rand(nt - 1, S), rand(d, nt, S) * ops.masks)

    return ops, dict(q=stag(), alpha=stag(), phi=rand(nt, S),
                     beta=rand(C, nt - 1, S), x=rand(C, nt - 1, S))


def check_kernels(torch, cmp, geom, seed):
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import diag_values

    ops, v = random_inputs(torch, geom, seed, torch.device(DEVICE))
    D, E, dscale = level_scalars(geom)
    sbf, sd, tau = E / D, E / dscale, 1.9
    d_in, d_bd = diag_values(D, E)
    dinv = (1.0 / d_in, 1.0 / d_bd)
    errs = {}
    errs["x_step"] = cmp("x_step", fs.x_step(ops, v["q"], v["beta"], sbf, sd),
                         fs.x_step_plain(ops, v["q"], v["beta"], sbf, sd))
    want_q, want_a = fs.qx_step_plain(ops, v["phi"], v["x"], v["alpha"], dinv,
                                      D, sbf, tau)
    q, a = fs.qx_step(ops, v["phi"], v["x"], v["alpha"].clone(), dinv, D,
                      sbf, tau)
    # the 3D q-steps round as their plain versions do
    exact = geom.ndim_space == 3
    errs["qx_step"] = max(cmp("qx_step", q.q0, want_q.q0, exact=exact),
                          cmp("qx_step", q.bs, want_q.bs, exact=exact),
                          cmp("qx_step", a.q0, want_a.q0, exact=exact),
                          cmp("qx_step", a.bs, want_a.bs, exact=exact))
    ghost = (q.bs * (1.0 - ops.masks)).abs().max()
    require(float(ghost) == 0.0, "qx_step wrote a non-zero ghost face slot")
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(
        check_weight(torch, geom, seed)), D, E)
    want_q, want_a = fs.qx_step_plain(ops, v["phi"], v["x"], v["alpha"],
                                      wdinv, D, sbf, tau)
    q, a = fs.qx_step(ops, v["phi"], v["x"], v["alpha"].clone(), wdinv, D,
                      sbf, tau)
    errs["qx_step_w"] = max(cmp("qx_step_w", q.q0, want_q.q0),
                            cmp("qx_step_w", q.bs, want_q.bs),
                            cmp("qx_step_w", a.q0, want_a.q0),
                            cmp("qx_step_w", a.bs, want_a.bs))
    ghost = (q.bs * (1.0 - ops.masks)).abs().max()
    require(float(ghost) == 0.0, "qx_step_w wrote a non-zero ghost face slot")
    for name, final in (("cx_step", False), ("cx_final", True)):
        want_b, want_x = fs.cx_step_plain(ops, v["beta"], v["x"], v["q"], sbf,
                                          sd, tau, final)
        fn = fs.cx_final if final else fs.cx_step
        b, x = fn(ops, v["beta"].clone(), v["x"].clone(), v["q"], sbf, sd,
                  tau)
        errs[name] = max(cmp(name, b, want_b), cmp(name, x, want_x))
    torch.cuda.synchronize()
    log(f"  {geom.space} x {geom.nt}: " + ", ".join(
        f"{k} {e:.2e}" for k, e in errs.items()))


def check_scalars_from_memory(torch, geom, seed):
    """Every kernel that takes sd or E-derived scalars, launched through
    its ``*_dev`` entry (sd, sbf, sbf / sqrt2 and the q-step's diagonal
    values read from float32 tensors on the card, as the device driver's
    graphs launch them) against the by-value entry with the same floats:
    bit-equal. The q-steps unweighted and weighted."""
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import (_INV_SQRT2, base_values,
                                              diag_values)

    ops, v = random_inputs(torch, geom, seed, torch.device(DEVICE))
    D, E, dscale = level_scalars(geom)
    sbf, sd, tau = E / D, E / dscale, 1.9
    d_in, d_bd = diag_values(D, E)
    dinv = (1.0 / d_in, 1.0 / d_bd)
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(
        check_weight(torch, geom, seed)), D, E)

    def on_card(*vals):  # each double rounded once to float32, on the card
        return torch.tensor(vals, dtype=torch.float64).to(
            DEVICE, torch.float32).unbind(0)

    sbf_t, sd_t, sv_t = on_card(sbf, sd, sbf * _INV_SQRT2)
    dinv_t = on_card(*dinv)
    wdinv_t = wdinv._replace(base=on_card(*base_values(D, E)))
    q, alpha, phi, beta, x = v["q"], v["alpha"], v["phi"], v["beta"], v["x"]
    pairs = {
        "x_step": lambda f, s_, *_: fs.x_step(ops, q, beta, f, s_),
        "z_step": lambda f, s_, *_: fs.z_step(ops, q, beta, f, s_),
        "beta_step": lambda f, s_, *_: fs.beta_step(ops, beta, x, q, f, s_,
                                                    tau),
        "cx_step": lambda f, s_, *_: fs.cx_step(ops, beta.clone(), x.clone(),
                                                q, f, s_, tau),
        "cx_final": lambda f, s_, *_: fs.cx_final(ops, beta.clone(),
                                                  x.clone(), q, f, s_, tau),
        "qx_step": lambda f, _, sv, d, w: fs.qx_step(
            ops, phi, x, alpha.clone(), d, D, f, tau, sv=sv),
        "qx_step_w": lambda f, _, sv, d, w: fs.qx_step(
            ops, phi, x, alpha.clone(), w, D, f, tau, sv=sv),
        "q_step": lambda f, _, sv, d, w: fs.q_step(
            ops, phi, x, beta, alpha, d, D, f, tau, sv=sv),
        "q_step_w": lambda f, _, sv, d, w: fs.q_step(
            ops, phi, x, beta, alpha, w, D, f, tau, sv=sv),
    }

    def blocks(out):
        out = out if isinstance(out, tuple) else (out,)
        return [b for t in out for b in (t.blocks() if hasattr(t, "blocks")
                                         else [t])]

    for name, run in pairs.items():
        by_value = run(sbf, sd, None, dinv, wdinv)
        from_memory = run(sbf_t, sd_t, sv_t, dinv_t, wdinv_t)
        same = all(torch.equal(a, b) for a, b in zip(blocks(by_value),
                                                    blocks(from_memory)))
        require(same, f"{name}: the scalars read from memory give another "
                f"result than the same scalars by value")
    log(f"  {geom.space} x {geom.nt}: {', '.join(pairs)} with their scalars "
        f"from memory bit-equal to the scalars by value")


def check_single_step_kernels(torch, cmp, geom, seed):
    """z_step, q_step, q_step_w, beta_step, cone_project_diff and the
    phi-step rhs (unweighted and weighted) against their plain versions on
    the inputs of ``check_kernels``; q_step_w, cone_project_diff and the
    rhs bit-equal (they round as their plain versions do), ghost face
    slots of the q-steps exactly zero, every input left as it was."""
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import diag_values

    ops, v = random_inputs(torch, geom, seed, torch.device(DEVICE))
    D, E, dscale = level_scalars(geom)
    sbf, sd, tau = E / D, E / dscale, 1.9
    d_in, d_bd = diag_values(D, E)
    wdinv = fs.weighted_dinv(ops, ops.weight_to_internal(
        check_weight(torch, geom, seed)), D, E)
    q, alpha, phi, beta, z = v["q"], v["alpha"], v["phi"], v["beta"], v["x"]
    inputs = (q.blocks() + alpha.blocks() + wdinv.w.blocks()
              + [phi, beta, z])
    before = [t.clone() for t in inputs]
    errs = {"z_step": cmp("z_step", fs.z_step(ops, q, beta, sbf, sd),
                          fs.z_step_plain(ops, q, beta, sbf, sd))}
    for name, dinv in (("q_step", (1.0 / d_in, 1.0 / d_bd)),
                       ("q_step_w", wdinv)):
        want = fs.q_step_plain(ops, phi, z, beta, alpha, dinv, D, sbf, tau)
        got = fs.q_step(ops, phi, z, beta, alpha, dinv, D, sbf, tau)
        exact = name == "q_step_w" or geom.ndim_space == 3
        errs[name] = max(cmp(name, g, w, exact=exact)
                         for g, w in zip(got[0].blocks() + got[1].blocks(),
                                         want[0].blocks() + want[1].blocks()))
        ghost = (got[0].bs * (1.0 - ops.masks)).abs().max()
        require(float(ghost) == 0.0, f"{name} wrote a non-zero ghost face "
                f"slot")
    errs["beta_step"] = cmp(
        "beta_step", fs.beta_step(ops, beta, z, q, sbf, sd, tau),
        fs.beta_step_plain(ops, beta, z, q, sbf, sd, tau))
    errs["cone_project_diff"] = cmp(
        "cone_project_diff", fs.cone_project_diff(z, beta),
        fs.cone_project_diff_plain(z, beta), exact=True)
    for name, w in (("phi_rhs", None), ("phi_rhs_w", wdinv.w)):
        got = fs.phi_rhs(ops, q, alpha, phi, D, w)
        want = fs.phi_rhs_plain(ops, q, alpha, phi, D, w)
        errs[name] = cmp(name, got, want, exact=True)
        require(torch.equal(got, want), f"{name}: not bit-equal")
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(inputs, before)),
            "a single-step kernel wrote one of its inputs")
    log(f"  {geom.space} x {geom.nt}: " + ", ".join(
        f"{k} {e:.2e}" for k, e in errs.items()) + "; inputs intact")


def check_weight(torch, geom, seed):
    """A shaped weight of the check shape: the love-heart barrier's in 2D;
    in 1D and 3D seeded weights in [0.5, 2] (the time block too) with about
    one face in eight at the wall weight (drawn on the card in 3D)."""
    import numpy as np

    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.ops.staggered import Staggered

    dev = torch.device(DEVICE)
    if geom.ndim_space == 2:
        ny, nx = geom.space
        return W.get_weight_by_barrier(nx, ny, geom.nt, W.barrier_love_heart(),
                                       dtype=torch.float32, device=dev)
    if geom.ndim_space == 3:
        gen = torch.Generator(device=dev).manual_seed(200 + seed)

        def block(shape, walls):
            w = 0.5 + 1.5 * torch.rand(shape, generator=gen, device=dev)
            if walls:
                wall = torch.rand(shape, generator=gen, device=dev) < 0.125
                w = torch.where(wall, torch.full_like(w, W.BARRIER_WEIGHT), w)
            return w

        return Staggered(block(geom.q0_shape, False),
                         tuple(block(geom.b_shape(a), True) for a in range(3)))
    rng = np.random.default_rng(200 + seed)
    q0 = rng.uniform(0.5, 2.0, geom.q0_shape)
    b = rng.uniform(0.5, 2.0, geom.b_shape(0))
    b[rng.random(b.shape) < 0.125] = W.BARRIER_WEIGHT
    f32 = dict(dtype=torch.float32, device=dev)
    return Staggered(torch.tensor(q0, **f32), (torch.tensor(b, **f32),))


def check_sweep(torch, cmp, geom, seed):
    """The sGS sweep kernel against the plain sweep, with d2 = D^2 of a
    first level: one sweep, two in one call, two chained calls, one launch
    a sweep; the input phi must come back unchanged. Keeps the largest
    |kernel - plain| of the shape in ``SWEEP_ERRS``."""
    import numpy as np

    from dotsocp_tpu_torch.ops import sgs_sweep
    from dotsocp_tpu_torch.ops.sgs import make_sgs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(100 + seed)

    def rand():
        return torch.from_numpy(
            rng.standard_normal(geom.phi_shape, dtype=np.float32)).to(dev)

    phi, rhs = rand(), rand()
    d2 = level_scalars(geom)[0] ** 2
    sgs = make_sgs(geom, dtype=torch.float32, device=dev)
    before = phi.clone()
    errs = []
    n0 = sgs_sweep.LAUNCHES["rb_sweep"]
    for its in (1, 2):
        got = sgs_sweep.rb_sweep(sgs, phi, rhs, d2, its)
        errs.append(cmp("rb_sweep", got, sgs.sweep(phi, rhs, its, d2=d2)))
    once = sgs_sweep.rb_sweep(sgs, phi, rhs, d2)
    twice = sgs_sweep.rb_sweep(sgs, once, rhs, d2)
    errs.append(cmp("rb_sweep", twice, sgs.sweep(phi, rhs, 2, d2=d2)))
    torch.cuda.synchronize()
    require(sgs_sweep.LAUNCHES["rb_sweep"] == n0 + 5, f"rb_sweep: "
            f"{sgs_sweep.LAUNCHES['rb_sweep'] - n0} launches for 5 sweeps")
    require(torch.equal(phi, before), "rb_sweep wrote its input phi")
    log(f"  {geom.space} x {geom.nt}: rb_sweep 1 sweep {errs[0]:.2e}, 2 in "
        f"one call {errs[1]:.2e}, 2 chained {errs[2]:.2e}; input intact")
    SWEEP_ERRS["x".join(map(str, geom.space)) + f"x{geom.nt}"] = max(errs)


def check_sweep_shapes(torch):
    """The sweep kernel on ``SWEEP_SHAPES``, its errors kept apart from the
    main check shapes'."""
    from dotsocp_tpu_torch.ops.geometry import Geometry

    cmp = Compare(torch)
    for seed, (nt, space) in enumerate(SWEEP_SHAPES):
        check_sweep(torch, cmp, Geometry(nt, space), 50 + seed)


def sweep_outputs(torch, path):
    """One and two sweeps of the sweep kernel on seeded inputs at 513^2 x
    65, 129^3 x 33, a ragged 3D grid and 1025 x 33, saved to ``path``; run
    from a checkout of another tree (with this file loaded by path) to hold
    two trees' kernels against each other on the card."""
    from dotsocp_tpu_torch.ops import sgs_sweep
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.sgs import make_sgs

    dev = torch.device(DEVICE)
    outs = {}
    for nt, space in ((SCALE[0], (SCALE[1],) * 2),
                      (SCALE_3D[0], (SCALE_3D[1],) * 3), (5, (3, 17, 30)),
                      (33, (1025,))):
        geom = Geometry(nt, space)
        gen = torch.Generator(device=dev).manual_seed(7)
        phi, rhs = (torch.randn(geom.phi_shape, generator=gen, device=dev)
                    for _ in range(2))
        sgs = make_sgs(geom, dtype=torch.float32, device=dev)
        d2 = level_scalars(geom)[0] ** 2
        key = "x".join(map(str, space)) + f"x{nt}"
        for its in (1, 2):
            outs[f"{key} its {its}"] = sgs_sweep.rb_sweep(
                sgs, phi, rhs, d2, its).cpu()
        del phi, rhs, sgs
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(outs, path)
    return outs


def compare_sweep_outputs(torch, path_a, path_b):
    """Per saved sweep: bit-equal, or the largest |a - b|."""
    a, b = torch.load(path_a), torch.load(path_b)
    for key in a:
        diff = float((a[key] - b[key]).abs().max())
        log(f"  {key}: {'bit-equal' if torch.equal(a[key], b[key]) else ''}"
            f" max |a - b| {diff:.3e}")


def check_shift(torch, cmp, geom, seed):
    """The flat shift kernel (TPU kernel 3) bit-equal to its plain version
    at every axis stride of the grid, both directions, on phi and on one
    plane of a cone array read in place."""
    from dotsocp_tpu_torch.ops import shift

    ops, v = random_inputs(torch, geom, 300 + seed, torch.device(DEVICE))
    plane = geom.cone_cols // 2
    for a, k in enumerate(ops.strides):
        for forward in (True, False):
            plain = ops._sfwd if forward else ops._sbwd
            cmp("flat_shift", shift.flat_shift(v["phi"], k, forward),
                plain(v["phi"], a), exact=True)
            cmp("flat_shift", shift.flat_shift(v["beta"], k, forward, plane),
                plain(v["beta"][plane], a), exact=True)
    torch.cuda.synchronize()
    log(f"  {geom.space} x {geom.nt}: flat_shift at strides {ops.strides}, "
        f"both directions, phi and cone plane {plane}: bit-equal")


def check_3d_kernels(torch):
    """Phase 3 in 3D: every DIM = 3 kernel against its plain version at
    each of ``CHECK_SHAPES_3D``, with the device memory peak of each."""
    from dotsocp_tpu_torch.ops.geometry import Geometry

    cmp = Compare(torch)
    peaks = {}
    for seed, (nt, space) in enumerate(CHECK_SHAPES_3D):
        geom = Geometry(nt, space)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        check_kernels(torch, cmp, geom, seed)
        check_single_step_kernels(torch, cmp, geom, seed)
        check_sweep(torch, cmp, geom, seed)
        check_shift(torch, cmp, geom, seed)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peaks["x".join(map(str, space)) + f"x{nt}"] = peak
        log(f"  {space} x {nt}: peak device memory {peak:.2f} GiB")
    torch.cuda.empty_cache()
    return dict(cmp.max_abs), peaks


def gaussian_3d_level(torch, n, nt, dev):
    """The finest level of gaussian n^3 x nt after InitialScaling."""
    from dotsocp_tpu_torch.models.examples import get_example_3d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    r0, r1 = get_example_3d("gaussian", n, n, n)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device=dev)
    initial_scaling(lv, scaling=True)
    return lv


def check_3d_steps(torch):
    """A 4-iteration CA segment and 4 ``run_one`` steps against 4 plain
    steps at gaussian 17^3 x 9, held to ``SEG_REL_3D`` of the largest
    entry; one launch of each single-step kernel a step, the state given
    to run_one intact."""
    from dotsocp_tpu_torch.ops import fused_step as fs

    lv = gaussian_3d_level(torch, *STEPS_3D, DEVICE)
    out = {}
    for name, run in (("CA segment", None), ("run_one", run_ones)):
        fs.reset_launches()
        err, _, scale = segment_vs_steps(torch, lv, 4, run)
        launches = dict(fs.LAUNCHES)
        log(f"  3D {name} (4 its) vs 4 plain steps at {STEPS_3D[0]}^3 x "
            f"{STEPS_3D[1]}: max abs "
            f"{err:.2e}, {err / scale:.2e} of the largest entry {scale:.3e} "
            f"(held to {SEG_REL_3D:g}); launches {launches}")
        require(err <= SEG_REL_3D * scale, f"3D {name}: max |kernels - "
                f"steps| = {err:.3e} exceeds {SEG_REL_3D:g} of {scale:.3e}")
        if run is None:
            require(launches["x_step"] == launches["cx_final"] == 1
                    and launches["qx_step"] == launches["phi_rhs"] == 4
                    and launches["cx_step"] == 3,
                    f"3D CA segment launched {launches}")
        else:
            require(launches["z_step"] == launches["q_step"]
                    == launches["beta_step"] == launches["phi_rhs"] == 4,
                    f"3D run_one launched {launches}, not each single-step "
                    f"kernel once a step")
        out[name] = dict(max_abs=err, rel=err / scale)
    return out


def headline_level(torch, dev):
    """The finest level of the headline problem after InitialScaling."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    lv = initialize(r0, r1, 33, dtype=torch.float32, device=dev)
    initial_scaling(lv, scaling=True)
    return lv


def weighted_level(torch, n, nt, dev):
    """The finest level of the love-heart problem n^2 x nt after
    InitialScaling."""
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    barrier = W.barrier_love_heart()
    r0, r1 = W.get_example_w2d("love-heart", n, n)
    r0, r1, mask = W.ensure_barrier_validity(r0, r1, barrier)
    weight = W.get_weight_by_barrier(n, n, nt, barrier, dtype=torch.float32,
                                     device=dev)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device=dev, weight=weight)
    initial_scaling(lv, scaling=True)
    return lv


def make_kernels(torch, lv):
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig

    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                      dtype=torch.float32, device=str(lv.phi.device))
    return Kernels(cfg, lv.weight)


def state_blocks(s):
    """Every tensor of a SolverState's iterate and c."""
    return [s.phi, s.z, s.beta, s.c] + s.q.blocks() + s.alpha.blocks()


def run_ones(kern, s, k):
    """k ``run_one`` steps from s, which must come back unchanged."""
    start = s.clone()
    out = s
    for _ in range(k):
        out = kern.run_one(out)
    require(all(a.equal(b) for a, b in zip(state_blocks(s),
                                            state_blocks(start))),
            "run_one changed the state it was given")
    return out


def segment_vs_steps(torch, lv, k, run=None):
    """Largest |run(kernels, state, k) - plain steps|, its excess over
    rtol/atol SEG_RTOL/SEG_ATOL, and the largest |plain step value|, after
    k iterations from the level's start; ``run`` is the CA segment unless
    given."""
    kern = make_kernels(torch, lv)
    s = kern.prep(lv.as_dict(), 1.0)
    plain = s.clone()
    for _ in range(k):
        plain = kern._step_plain(plain)
    if run is None:
        seg = kern.run_segment(s.clone(), k)
    else:
        seg = run(kern, s.clone(), k)
    pairs = [(getattr(seg, n), getattr(plain, n)) for n in ("phi", "z", "beta")]
    for n in ("q", "alpha"):
        pairs += list(zip(getattr(seg, n).blocks(), getattr(plain, n).blocks()))
    err = max(float((g - w).abs().max()) for g, w in pairs)
    excess = max(float(((g - w).abs() - (SEG_ATOL + SEG_RTOL * w.abs())).max())
                 for g, w in pairs)
    return err, excess, max(float(w.abs().max()) for _, w in pairs)


def check_segment(torch):
    """A 4-iteration CA segment (kernels) against 4 plain steps on the card,
    at 17^2 x 7 as tests/test_pallas.py:186-204 holds the Pallas segment.
    At 129^2 x 33 the gap is only reported: there the inverse Laplacian of
    the phi-step amplifies the ulp-level (z + beta) - beta reconstruction
    past 2e-6 within 4 iterations, between two plain paths on the CPU too."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    r0, r1 = get_example_2d("example2", 17, 17)
    lv = initialize(r0, r1, 7, dtype=torch.float32, device=DEVICE)
    initial_scaling(lv, scaling=True)
    err, excess, _ = segment_vs_steps(torch, lv, 4)
    log(f"  CA segment (4 its) vs 4 plain steps at 17^2 x 7: max abs {err:.2e}")
    require(excess <= 0, f"CA segment: max |segment - steps| = {err:.3e} "
            f"exceeds rtol {SEG_RTOL:g} / atol {SEG_ATOL:g}")
    err, _, _ = segment_vs_steps(torch, headline_level(torch, DEVICE), 4)
    log(f"  the same at 129^2 x 33 (reported, not held to 2e-6): max abs "
        f"{err:.2e}")
    err, excess, _ = segment_vs_steps(torch, weighted_level(torch, 17, 7,
                                                            DEVICE), 4)
    log(f"  weighted (love-heart) at 17^2 x 7: max abs {err:.2e}")
    require(excess <= 0, f"weighted CA segment: max |segment - steps| = "
            f"{err:.3e} exceeds rtol {SEG_RTOL:g} / atol {SEG_ATOL:g}")
    err, _, scale = segment_vs_steps(torch, weighted_level(torch, 129, 129,
                                                           DEVICE), 4)
    log(f"  weighted at 129^2 x 129: max abs {err:.2e}, {err / scale:.2e} of "
        f"the largest entry {scale:.3e} (held to {SEG_REL_129:g})")
    require(err <= SEG_REL_129 * scale, f"weighted CA segment at 129^2 x 129: "
            f"max |segment - steps| = {err:.3e} exceeds {SEG_REL_129:g} of "
            f"{scale:.3e}")


def check_run_one(torch):
    """4 ``run_one`` steps (the single-step kernels) against 4
    ``_step_plain`` steps on the card at 17^2 x 7, unweighted and weighted,
    as tests/test_pallas.py:91-114 holds the fused Pallas step; one launch
    of each single-step kernel a step, the state given to run_one intact."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.ops import fused_step as fs

    r0, r1 = get_example_2d("example2", 17, 17)
    lv = initialize(r0, r1, 7, dtype=torch.float32, device=DEVICE)
    initial_scaling(lv, scaling=True)
    for name, level in (("unweighted", lv),
                        ("weighted (love-heart)",
                         weighted_level(torch, 17, 7, DEVICE))):
        fs.reset_launches()
        err, excess, _ = segment_vs_steps(torch, level, 4, run_ones)
        launches = dict(fs.LAUNCHES)
        q_name = "q_step" if level.weight is None else "q_step_w"
        log(f"  run_one x 4 vs 4 plain steps, {name} at 17^2 x 7: max abs "
            f"{err:.2e}; launches z_step {launches['z_step']}, {q_name} "
            f"{launches[q_name]}, beta_step {launches['beta_step']}; input "
            f"state intact")
        require(excess <= 0, f"run_one ({name}): max |run_one - steps| = "
                f"{err:.3e} exceeds rtol {SEG_RTOL:g} / atol {SEG_ATOL:g}")
        rhs_name = "phi_rhs" if level.weight is None else "phi_rhs_w"
        require(launches["z_step"] == launches[q_name]
                == launches["beta_step"] == launches[rhs_name] == 4,
                f"run_one ({name}) launched {launches}, not the rhs and "
                f"each single-step kernel once a step")


# -- phase 4 --------------------------------------------------------------------

def reset_launch_counts():
    """Every kernel wrapper's launch count set to 0."""
    from dotsocp_tpu_torch.ops import fused_step, sgs_sweep, shift

    for module in (fused_step, sgs_sweep, shift):
        module.reset_launches()


def launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    from dotsocp_tpu_torch.ops import fused_step, sgs_sweep, shift

    return dict(fused_step.LAUNCHES, **sgs_sweep.LAUNCHES, **shift.LAUNCHES)


def add_counts(total, counts):
    """Adds one run's launch counts into ``total``; returns it."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    return total


def stop_residual(lv, weighted=False):
    """A level report's largest stop residual: KKT entries 1, 3, 6, 7, or
    1, 3, 6 for a weighted problem."""
    import numpy as np

    return float(np.max(lv["final_kkt"][[0, 2, 5] if weighted
                                        else [0, 2, 5, 6]]))


def headline_solve(torch):
    import numpy as np

    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    # warm-up: library load, cuBLAS handles, allocator pools
    w0, w1 = get_example_2d("example2", 17, 17)
    solve_dot(w0, w1, 9, 2, {"tol": 1e-3}, device=DEVICE, verbose=False)

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, 33, 3, {"tol": 1e-4}, "inPALM",
                          device=DEVICE, dtype=torch.float32, verbose=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()

    iters = [lv["iters"] for lv in out["levels"]]
    total = sum(iters)
    log(f"  iterations per level {iters}, total {total} (anchor "
        f"{HEADLINE_ANCHOR}, {100.0 * (total - HEADLINE_ANCHOR) / HEADLINE_ANCHOR:+.1f}%)")
    for lv in out["levels"]:
        log(f"  level {lv['level']} {lv['geom'].space} x {lv['geom'].nt}: "
            f"{lv['iters']} its, {lv['time']:.3f} s, final KKT "
            f"{np.array2string(lv['final_kkt'], precision=3)}")
    log(f"  mass_ok {out['mass_ok']}, wall {wall:.3f} s "
        f"(solve_dot total_time {out['total_time']:.3f} s)")
    log(f"  kernel launches {launches}")
    rho = out["rho"]
    require(tuple(rho.shape) == (33, 129, 129), f"rho shape {rho.shape}")
    require(bool(torch.isfinite(rho).all()), "non-finite density")
    require(out["mass_ok"], "mass conservation violated")
    for lv in out["levels"]:
        stop = stop_residual(lv)
        require(stop < 1e-4, f"level {lv['level']} stopped at KKT {stop:.3e}")
    require(470 <= total <= 574, f"total iterations {total} outside 470-574")
    for name in ("x_step", "qx_step", "cx_step", "cx_final"):
        require(launches[name] > 0, f"{name} was never launched on the main "
                f"path")
    require(launches["qx_step_w"] == 0, "the unweighted solve launched the "
            "weighted q-step")
    require(launches["phi_rhs"] == total, f"phi_rhs launched "
            f"{launches['phi_rhs']} times, not once per iteration ({total})")
    return launches, dict(iters=iters, total=total, wall_s=wall,
                          mass_ok=bool(out["mass_ok"]))


def headline_f64(torch):
    """Phase 4g: the headline in float64 on the card, which takes the plain
    route by dtype: exactly the float64 CPU anchor's 189 + 174 + 159
    iterations, mass conservation, stop residuals, and no kernel launched.
    Returns the launches (all 0) and the result."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, 33, 3, {"tol": 1e-4}, "inPALM",
                          device=DEVICE, dtype=torch.float64, verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    iters = [lv["iters"] for lv in out["levels"]]
    stops = [stop_residual(lv) for lv in out["levels"]]
    log(f"  inPALM DOTmark-4stitch 129^2 x 33, 3 levels, float64: iterations "
        f"{iters} ({sum(iters)}) in {wall:.3f} s, mass_ok {out['mass_ok']}, "
        f"stop residuals {[f'{x:.2e}' for x in stops]}; launches {launches}")
    rho = out["rho"]
    require(rho.dtype == torch.float64 and rho.is_cuda,
            f"float64 headline: rho {rho.dtype} on {rho.device}")
    require(bool(torch.isfinite(rho).all()), "float64 headline: non-finite "
            "density")
    require(tuple(iters) == HEADLINE_F64_ANCHOR, f"float64 headline: "
            f"iterations {iters}, not {list(HEADLINE_F64_ANCHOR)}")
    require(out["mass_ok"], "float64 headline: mass conservation violated")
    require(max(stops) < 1e-4, f"float64 headline: stop residuals {stops}")
    require(set(launches.values()) == {0}, f"float64 headline launched "
            f"kernels: {launches}")
    return launches, dict(iters=iters, total=sum(iters), wall_s=wall,
                          mass_ok=bool(out["mass_ok"]))


def refine_run(torch, r0, r1, nt, opts, dtype=None):
    """One 3-level solve on the card (float32 levels unless ``dtype``),
    every launch count set to 0 just before; returns (output, last history,
    launches, wall seconds, the tail's report or None)."""
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, hist = solve_dot(r0, r1, nt, 3, opts, "inPALM", device=DEVICE,
                             dtype=dtype or torch.float32, verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tail = out["levels"][-1] if out["levels"][-1].get("refine") else None
    return out, hist, launch_counts(), wall, tail


def refine_result(out, wall, tail):
    """The numbers phase 4h keeps of a refine run."""
    levels = [lv["iters"] for lv in out["levels"] if not lv.get("refine")]
    return dict(levels=levels, tail_iters=tail["iters"],
                total=sum(levels) + tail["iters"], wall_s=wall,
                tail_s=tail["time"], method=tail["method"],
                final_kkt=[float(x) for x in tail["final_kkt"]],
                mass_ok=bool(out["mass_ok"]))


def refine_solves(torch, headline_launches):
    """Phase 4h: the refine tail. The north-star run (the headline to KKT
    1e-6: float32 levels, a float64 tail under the port's "auto") against
    REFINE_ANCHOR, the CA launches equal to the phase-4 headline's (the
    tail launches nothing); dot1d 1025 x 33 to 1e-5 with float32 levels
    (tolerance, mass, float64 rho; its count beside DOT1D_TPU_COUNT) and
    with float64 levels (against DOT1D_F64_ANCHOR, no launch). Returns the
    launches of the three runs and their results."""
    import numpy as np

    from dotsocp_tpu_torch.models.examples import get_example_1d, get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import AUTO_DCT_SPLIT

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    out, hist, launches, wall, tail = refine_run(torch, r0, r1, 33,
                                                 REFINE_OPTS)
    res = refine_result(out, wall, tail)
    stop = max(res["final_kkt"][i] for i in (0, 2, 5, 6))
    log(f"  north star ('auto' = {AUTO_DCT_SPLIT!r}): levels {res['levels']}, "
        f"tail {res['tail_iters']} ({res['method']}), total {res['total']} "
        f"(anchor {REFINE_ANCHOR['tail']} / {REFINE_ANCHOR['total']}); wall "
        f"{wall:.3f} s, tail {res['tail_s']:.3f} s; final KKT "
        f"{np.array2string(np.asarray(res['final_kkt']), precision=3)}, "
        f"mass_ok {res['mass_ok']}; launches {launches}")
    require(tuple(res["levels"]) == REFINE_ANCHOR["levels"],
            f"north star: levels {res['levels']}, not "
            f"{list(REFINE_ANCHOR['levels'])}")
    for key in ("tail", "total"):
        got = res["tail_iters" if key == "tail" else "total"]
        require(abs(got - REFINE_ANCHOR[key]) <= 0.1 * REFINE_ANCHOR[key],
                f"north star: {key} {got} outside +-10% of "
                f"{REFINE_ANCHOR[key]}")
    require(stop < 1e-6, f"north star: stop residual {stop:.3e}")
    require(res["mass_ok"], "north star: mass conservation violated")
    rho = out["rho"]
    require(rho.dtype == torch.float64 and tuple(rho.shape) == (33, 129, 129)
            and bool(torch.isfinite(rho).all()),
            f"north star: rho {rho.dtype} {tuple(rho.shape)}")
    for name in ("x_step", "qx_step", "cx_step", "cx_final"):
        require(launches[name] == headline_launches[name],
                f"north star: {name} launched {launches[name]} times, the "
                f"headline {headline_launches[name]}: the tail launched it")

    d0, d1 = get_example_1d("gaussian", 1025)
    dot1d = {}
    for dtype in (torch.float32, torch.float64):
        out1, _, launches1, wall1, tail1 = refine_run(torch, d0, d1, 33,
                                                      DOT1D_OPTS, dtype)
        add_counts(launches, launches1)
        res1 = refine_result(out1, wall1, tail1)
        stop1 = max(res1["final_kkt"][i] for i in (0, 2, 5, 6))
        what = f"dot1d 1025 x 33, {str(dtype)[6:]} levels"
        if dtype == torch.float32:
            anchor, source = DOT1D_TPU_COUNT, "the JAX count on its TPU"
        else:
            anchor, source = sum(DOT1D_F64_ANCHOR), list(DOT1D_F64_ANCHOR)
        log(f"  {what}: levels {res1['levels']}, tail {res1['tail_iters']}, "
            f"total {res1['total']} ({anchor}: {source}); wall "
            f"{wall1:.3f} s, tail {res1['tail_s']:.3f} s; stop residual "
            f"{stop1:.3e}, mass_ok {res1['mass_ok']}; launches {launches1}")
        if dtype == torch.float64:
            require(abs(res1["total"] - anchor) <= 0.1 * anchor,
                    f"{what}: total {res1['total']} outside +-10% of "
                    f"{anchor}")
            require(sum(launches1.values()) == 0,
                    f"{what}: a kernel was launched: {launches1}")
        require(stop1 < 1e-5, f"{what}: stop residual {stop1:.3e}")
        require(res1["mass_ok"], f"{what}: mass conservation violated")
        require(out1["rho"].dtype == torch.float64,
                f"{what}: rho not float64")
        dot1d[str(dtype)[6:]] = res1
    return launches, dict(north_star=res, dot1d=dot1d["float32"],
                          dot1d_f64_levels=dot1d["float64"])


def refine_modes(torch):
    """The measurement behind the port's refine_dct_split="auto": one f64
    tail iteration (a 20-iteration segment of the plain route, CUDA events)
    and one DCT solve at REFINE_TIME_SHAPES under each mode, in turns
    (False, ir, ir1, ir1, ir, False); the IR solves' largest error against
    the card's f64 solve, relative to its largest entry; the whole north
    star under the two modes 'auto' does not pick, and a pure float64 solve
    to 1e-6. Nothing about speed is asserted."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.multilevel.solve import AUTO_DCT_SPLIT

    f64 = torch.float64
    result = {"tail_iter_ms": {}, "dct_ms": {}, "ir_rel_err": {}}
    for nt, n in REFINE_TIME_SHAPES:
        r0, r1 = get_example_2d("DOTmark_4stitch" if n == 129 else "example2",
                                n, n)
        lv = initialize(r0, r1, nt, dtype=f64, device=DEVICE)
        initial_scaling(lv, scaling=True)
        kerns = {m: Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                        device=DEVICE, dtype=f64,
                                        dct_split=m))
                 for m in REFINE_MODES}
        s0 = kerns[False].run_segment(kerns[False].prep(lv.as_dict(), 1.0), 5)
        rhs = kerns[False]._rhs(s0)
        exact = kerns[False]._poisson_solve(s0, rhs)
        it_ms = {m: [] for m in REFINE_MODES}
        dct_ms = {m: [] for m in REFINE_MODES}
        for m in REFINE_MODES + REFINE_MODES[::-1]:
            kern = kerns[m]
            state = {"s": s0.clone()}

            def segment():
                state["s"] = kern.run_segment(state["s"], 20)

            it_ms[m].append(event_ms(torch, segment, 3) / 20)
            dct_ms[m].append(event_ms(
                torch, lambda: kern._poisson_solve(s0, rhs), 10))
        shape = f"{n}^2x{nt}"
        result["tail_iter_ms"][shape] = {str(m): sum(v) / 2
                                         for m, v in it_ms.items()}
        result["dct_ms"][shape] = {str(m): sum(v) / 2
                                   for m, v in dct_ms.items()}
        span = float(exact.abs().max())
        result["ir_rel_err"][shape] = {
            m: float((kerns[m]._poisson_solve(s0, rhs) - exact).abs().max())
            / span for m in ("ir", "ir1")}
        log(f"  {shape} float64: one tail iteration (ms) "
            f"{result['tail_iter_ms'][shape]}, DCT solve (ms) "
            f"{result['dct_ms'][shape]}; IR error against the f64 solve "
            f"{result['ir_rel_err'][shape]}")
        del kerns, s0, rhs, exact, state
        torch.cuda.empty_cache()

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    runs = {}
    for mode in REFINE_MODES:
        if mode == AUTO_DCT_SPLIT:
            continue  # phase 4h's north-star run
        out, _, _, wall, tail = refine_run(
            torch, r0, r1, 33, dict(REFINE_OPTS, refine_dct_split=mode))
        runs[str(mode)] = refine_result(out, wall, tail)
        log(f"  north star under {mode!r}: tail {tail['iters']} "
            f"({tail['method']}), {tail['time']:.3f} s; wall {wall:.3f} s")
    out, hist, _, wall, _ = refine_run(
        torch, r0, r1, 33, {"tol": 1e-6, "maxit": 6000}, dtype=f64)
    pure = dict(levels=[lv["iters"] for lv in out["levels"]], wall_s=wall,
                final_kkt=[float(x) for x in hist["kkt"][-1]],
                mass_ok=bool(out["mass_ok"]))
    log(f"  pure float64 to 1e-6: levels {pure['levels']} "
        f"({sum(pure['levels'])}), wall {wall:.3f} s, mass_ok "
        f"{pure['mass_ok']}")
    result.update(north_star_by_mode=runs, pure_f64_1e6=pure,
                  auto=str(AUTO_DCT_SPLIT))
    return result


def solve_levels(torch, method, problem, n, nt, levels, **opts):
    """One float32 solve at tol 1e-4 (and ``opts``) on the card with every
    launch count set to 0 just before; returns (output, run history,
    launches, wall seconds)."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    r0, r1 = get_example_2d(problem, n, n)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, hist, _ = solve_dot(r0, r1, nt, levels, dict(opts, tol=1e-4), method,
                             device=DEVICE, dtype=torch.float32, verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    iters = [lv["iters"] for lv in out["levels"]]
    log(f"  {method} {problem} {n}^2 x {nt}, {levels} levels: iterations "
        f"{iters} in {wall:.3f} s; launches {launches}")
    rho = out["rho"]
    require(tuple(rho.shape) == (nt, n, n), f"{method}: rho shape {rho.shape}")
    require(bool(torch.isfinite(rho).all()), f"{method}: non-finite density")
    return out, hist, launches, wall


def sgs_solve(torch):
    """Phase 4b: the sGS-inPALM path at 129^2 x 33 against SGS_ANCHOR."""
    from dotsocp_tpu_torch.multilevel.level import mass_error

    out, _, launches, wall = solve_levels(torch, "sGS-inPALM",
                                          "DOTmark_4stitch", 129, 33, 3)
    iters = [lv["iters"] for lv in out["levels"]]
    total, want = sum(iters), sum(SGS_ANCHOR)
    err = float(mass_error(out["rho"]))
    stop = stop_residual(out["levels"][-1])
    log(f"  anchor {list(SGS_ANCHOR)} ({want}); total {total} "
        f"({100.0 * (total - want) / want:+.1f}%); mass error {err:.4e}, "
        f"mass_ok {out['mass_ok']}; level-3 stop residual {stop:.3e}")
    for lv in out["levels"][:-1]:
        require(lv["method"].startswith("Inexact Proximal ALM"),
                f"level {lv['level']} ran {lv['method']}, not inPALM")
        require(stop_residual(lv) < 1e-4, f"level {lv['level']} stopped at "
                f"KKT {stop_residual(lv):.3e}")
    require(abs(total - want) <= 0.1 * want,
            f"total iterations {total} not within 10% of {want}")
    require(out["mass_ok"], "mass conservation violated")
    require(stop < 1e-4, f"level 3 stopped at KKT {stop:.3e}")
    require(launches["rb_sweep"] == iters[-1],
            f"rb_sweep launched {launches['rb_sweep']} times, not once per "
            f"sGS iteration ({iters[-1]})")
    for name in ("z_step", "q_step", "beta_step"):
        require(launches[name] == iters[-1], f"{name} launched "
                f"{launches[name]} times, not once per sGS iteration "
                f"({iters[-1]})")
    for name in ("x_step", "qx_step", "cx_step", "cx_final"):
        require(launches[name] > 0, f"{name} never launched on levels 1-2")
    return launches, dict(iters=iters, total=total, wall_s=wall,
                          mass_error=err, mass_ok=bool(out["mass_ok"]),
                          stop=stop)


def variant_solves(torch):
    """Phase 4c: acc-sGS-ADMM, acc-ADMM and PALM at example2 65^2 x 17;
    returns the launches of the three solves and their results."""
    total_launches, results = {}, {}
    for method, anchor in VARIANT_ANCHORS.items():
        out, _, launches, wall = solve_levels(torch, method, "example2", 65,
                                              17, 2)
        iters = [lv["iters"] for lv in out["levels"]]
        total, want = sum(iters), sum(anchor)
        log(f"    anchor {list(anchor)} ({want}): "
            f"{100.0 * (total - want) / want:+.1f}%, mass_ok "
            f"{out['mass_ok']}, stop residuals "
            f"{[f'{stop_residual(lv):.2e}' for lv in out['levels']]}")
        require(out["mass_ok"], f"{method}: mass conservation violated")
        for lv in out["levels"]:
            require(stop_residual(lv) < 1e-4, f"{method} level {lv['level']} "
                    f"stopped at KKT {stop_residual(lv):.3e}")
        require(abs(total - want) <= 0.1 * want, f"{method}: total "
                f"iterations {total} not within 10% of {want}")
        if "sGS" in method:
            require(launches["rb_sweep"] == iters[-1],
                    f"{method}: rb_sweep launched {launches['rb_sweep']} "
                    f"times, not once per sGS iteration ({iters[-1]})")
        require(launches["cone_project_diff"] == acc_iterations(method, out),
                f"{method}: cone_project_diff launched "
                f"{launches['cone_project_diff']} times, not once per "
                f"iteration of its acc levels ({acc_iterations(method, out)})")
        results[method] = dict(iters=iters, wall_s=wall,
                               cone_launches=launches["cone_project_diff"])
        add_counts(total_launches, launches)
    return total_launches, results


def acc_iterations(method, out):
    """Iterations of a solve's levels that run an acc method (acc-sGS-ADMM's
    non-final levels run inPALM)."""
    return sum(lv["iters"] for lv in out["levels"]
               if lv["method"].startswith("Accelerated"))


def level_tols(tol, levels):
    """Each level's tolerance, coarse to fine (``solve_dot``'s pyramid for
    a 2D problem)."""
    factor = -1.0 if tol > 0.99e-3 else -0.5
    tols = [tol]
    for _ in range(levels - 1):
        tols.insert(0, max(tols[0] * 2.0 ** factor, 1e-4))
    return tols


def weighted_solve(torch, method, n, nt, levels, tol):
    """One float32 love-heart solve on the card with every launch count set
    to 0 just before; returns (output, launches, wall seconds, mask)."""
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    barrier = W.barrier_love_heart()
    r0, r1 = W.get_example_w2d("love-heart", n, n)
    r0, r1, mask = W.ensure_barrier_validity(r0, r1, barrier)
    weight = W.get_weight_by_barrier(n, n, nt, barrier, dtype=torch.float32,
                                     device=DEVICE)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, nt, levels, {"tol": tol}, method, weight,
                          barrier, device=DEVICE, dtype=torch.float32,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    rho = out["rho"]
    require(tuple(rho.shape) == (nt, n, n), f"{method}: rho shape {rho.shape}")
    require(bool(torch.isfinite(rho).all()), f"{method}: non-finite density")
    require(out["mass_ok"], f"weighted {method}: mass conservation violated")
    for lv, lev_tol in zip(out["levels"], level_tols(tol, levels)):
        stop = stop_residual(lv, weighted=True)
        require(stop < tol, f"weighted {method} level {lv['level']} stopped "
                f"at KKT {stop:.3e} (requested tolerance {tol:g})")
        require(stop < lev_tol or lv["iters"] == WDOT_MAXIT,
                f"weighted {method} level {lv['level']} stopped at KKT "
                f"{stop:.3e} after {lv['iters']} iterations (level tolerance "
                f"{lev_tol:g}, maxit {WDOT_MAXIT})")
    return out, launches, wall, mask


def weighted_solves(torch):
    """Phase 4d: the weighted headline and weighted acc-ADMM; returns the
    launches of the two solves and their results."""
    import numpy as np
    from scipy.ndimage import binary_erosion

    out, launches, wall, mask = weighted_solve(torch, "inPALM", 129, 129, 3,
                                               1e-3)
    iters = [lv["iters"] for lv in out["levels"]]
    total = sum(iters)
    interior = binary_erosion(mask, iterations=2)
    rho = out["rho"]
    leak = float(rho[:, torch.as_tensor(interior, device=rho.device)]
                 .abs().max())
    log(f"  inPALM love-heart 129^2 x 129, 3 levels: iterations {iters}, "
        f"total {total} (anchor {WDOT_ANCHOR}, "
        f"{100.0 * (total - WDOT_ANCHOR) / WDOT_ANCHOR:+.1f}%) in {wall:.3f} s")
    for lv in out["levels"]:
        log(f"  level {lv['level']} {lv['geom'].space} x {lv['geom'].nt}: "
            f"{lv['iters']} its, {lv['time']:.3f} s, final KKT "
            f"{np.array2string(lv['final_kkt'], precision=3)}")
    log(f"  mass_ok {out['mass_ok']}, max |rho| inside the eroded barrier "
        f"{leak:.3e}; kernel launches {launches}")
    require(abs(total - WDOT_ANCHOR) <= 0.1 * WDOT_ANCHOR,
            f"weighted headline: total iterations {total} not within 10% of "
            f"{WDOT_ANCHOR}")
    require(leak < 0.1, f"density {leak:.3e} inside the barrier")
    require(launches["qx_step_w"] == total, f"qx_step_w launched "
            f"{launches['qx_step_w']} times, not once per iteration ({total})")
    require(launches["qx_step"] == 0, "the weighted solve launched the "
            "unweighted q-step")
    for name in ("x_step", "cx_step", "cx_final"):
        require(launches[name] > 0, f"{name} never launched in the weighted "
                f"solve")
    headline = dict(iters=iters, total=total, wall_s=wall,
                    mass_ok=bool(out["mass_ok"]), barrier_max_rho=leak)

    out, acc_launches, acc_wall, _ = weighted_solve(torch, "acc-ADMM", 33, 9,
                                                    1, 1e-3)
    acc_iters = [lv["iters"] for lv in out["levels"]]
    log(f"  acc-ADMM love-heart 33^2 x 9: iterations {acc_iters} in "
        f"{acc_wall:.3f} s (anchor {WDOT_ACC_ANCHOR}, float32), stop "
        f"residual {stop_residual(out['levels'][0], weighted=True):.2e}; "
        f"cone_project_diff launches {acc_launches['cone_project_diff']}")
    require(abs(acc_iters[0] - WDOT_ACC_ANCHOR) <= 0.1 * WDOT_ACC_ANCHOR,
            f"weighted acc-ADMM: {acc_iters[0]} iterations not within 10% of "
            f"{WDOT_ACC_ANCHOR}")
    require(acc_launches["cone_project_diff"] == acc_iters[0],
            f"weighted acc-ADMM: cone_project_diff launched "
            f"{acc_launches['cone_project_diff']} times, not once per "
            f"iteration ({acc_iters[0]})")
    return add_counts(launches, acc_launches), dict(headline=headline,
                          acc_admm=dict(iters=acc_iters, wall_s=acc_wall))


# -- phase 4e -------------------------------------------------------------------

# the phases profile_phases reports for inPALM (tests/test_profiling.py)
INPALM_PHASES = ("phi_dct_solve", "cone_projection", "q_step", "multiplier",
                 "kkt_battery", "full_step_fused")


def check_phases(torch, phases, what):
    import math

    for name, row in phases.items():
        require(math.isfinite(row["ms"]) and row["ms"] >= 0.0,
                f"{what}: phase {name} took {row['ms']} ms")


def profile_solve(torch):
    """The headline with opts={"profile": True}: the phases of every level,
    each with a finite time; returns the launches of the solve and the
    tables."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot
    from dotsocp_tpu_torch.utils.profiling import format_table

    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    reset_launch_counts()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, 33, 3, {"tol": 1e-4, "profile": True},
                          "inPALM", device=DEVICE, dtype=torch.float32,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    iters = [lv["iters"] for lv in out["levels"]]
    log(f"  headline with profile: iterations {iters} in {wall:.3f} s")
    tables = {}
    for lv in out["levels"]:
        phases = lv["phases"]
        log(f"  level {lv['level']} {lv['geom'].space} x {lv['geom'].nt}:")
        for line in format_table(phases).splitlines():
            log("    " + line)
        require(set(INPALM_PHASES) <= set(phases), f"level {lv['level']}: "
                f"phases {sorted(phases)}, expected {INPALM_PHASES}")
        check_phases(torch, phases, f"level {lv['level']}")
        tables[lv["level"]] = phases
    require(470 <= sum(iters) <= 574, f"profiled headline: total iterations "
            f"{sum(iters)} outside 470-574")
    return launches, tables


def theta3_solve(torch):
    """acc-ADMM's Nesterov branch (theta = 3) at example2 65^2 x 17, 2
    levels, against ``THETA3_ANCHOR``; returns the launches of the solve and
    its result."""
    out, _, launches, wall = solve_levels(torch, "acc-ADMM", "example2", 65,
                                          17, 2, theta=3.0)
    iters = [lv["iters"] for lv in out["levels"]]
    total, want = sum(iters), sum(THETA3_ANCHOR)
    log(f"    anchor {list(THETA3_ANCHOR)} ({want}, float64): "
        f"{100.0 * (total - want) / want:+.1f}%, mass_ok {out['mass_ok']}, "
        f"stop residuals "
        f"{[f'{stop_residual(lv):.2e}' for lv in out['levels']]}")
    require(out["mass_ok"], "theta = 3: mass conservation violated")
    for lv in out["levels"]:
        require(lv["method"] == "Accelerated ADMM", f"theta = 3 level "
                f"{lv['level']} ran {lv['method']}")
        require(stop_residual(lv) < 1e-4, f"theta = 3 level {lv['level']} "
                f"stopped at KKT {stop_residual(lv):.3e}")
    require(abs(total - want) <= 0.1 * want, f"theta = 3: total iterations "
            f"{total} not within 10% of {want}")
    require(launches["cone_project_diff"] == total, f"theta = 3: "
            f"cone_project_diff launched {launches['cone_project_diff']} "
            f"times, not once per iteration ({total})")
    return launches, dict(iters=iters, wall_s=wall,
                          cone_launches=launches["cone_project_diff"])


def profile_scale(torch):
    """``profile_phases`` at 513^2 x 65 from each level's start: inPALM,
    inPALM with love-heart weights (its full step on the weighted q_step
    kernel), sGS-inPALM and acc-ADMM. Returns the launches of the four
    profiles and the tables."""
    from dotsocp_tpu_torch.algorithms.core import LevelConfig
    from dotsocp_tpu_torch.algorithms.variants import (AccADMMKernels,
                                                       SgsKernels)
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.utils.profiling import format_table, profile_phases

    nt, n = SCALE
    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device=DEVICE)
    initial_scaling(lv, scaling=True)

    def cfg(tau):
        return LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=tau,
                           dtype=torch.float32, device=DEVICE)

    def build(name):
        if name == "inPALM love-heart":
            wlv = weighted_level(torch, n, nt, DEVICE)
            return make_kernels(torch, wlv), wlv
        if name == "sGS-inPALM":
            return SgsKernels(cfg(1.9)), lv
        if name == "acc-ADMM":
            return AccADMMKernels(cfg(1.0)), lv
        return make_kernels(torch, lv), lv

    tables, total_launches = {}, {}
    for name in ("inPALM", "inPALM love-heart", "sGS-inPALM", "acc-ADMM"):
        kern, level = build(name)
        state = kern.prep(level.as_dict(), 1.0)
        reset_launch_counts()
        allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        phases = profile_phases(kern, state, iters=20)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
        launches = launch_counts()
        add_counts(total_launches, launches)
        if name == "inPALM love-heart":
            require(launches["q_step_w"] > 0 and launches["q_step"] == 0,
                    f"{name}: launches {launches}, expected the weighted "
                    f"q_step kernel")
        log(f"  {name} at {lv.geom.space} x {nt} ({allocs} cudaMalloc "
            f"calls of the caching allocator during the profile):")
        for line in format_table(phases).splitlines():
            log("    " + line)
        check_phases(torch, phases, name)
        tables[name] = phases
        del kern, level, state
        torch.cuda.empty_cache()
    return total_launches, tables


# -- phase 4f -------------------------------------------------------------------

def solve_3d(torch, method, problem, n, nt, levels):
    """One float32 3D solve at tol 1e-4 on the card with every launch count
    set to 0 just before; checks the shape, finiteness, mass conservation
    and every level's stop residuals; returns (output, launches, wall)."""
    from dotsocp_tpu_torch.models.examples import get_example_3d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    r0, r1 = get_example_3d(problem, n, n, n)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, nt, levels, {"tol": 1e-4}, method,
                          device=DEVICE, dtype=torch.float32, verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    iters = [lv["iters"] for lv in out["levels"]]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stops = [stop_residual(lv) for lv in out["levels"]]
    log(f"  {method} {problem} {n}^3 x {nt}, {levels} levels: iterations "
        f"{iters} ({sum(iters)}) in {wall:.3f} s, mass_ok {out['mass_ok']}, "
        f"stop residuals {[f'{x:.2e}' for x in stops]}, peak device memory "
        f"{peak:.2f} GiB; launches {launches}")
    rho = out["rho"]
    require(tuple(rho.shape) == (nt, n, n, n), f"{method}: rho shape "
            f"{tuple(rho.shape)}")
    require(bool(torch.isfinite(rho).all()), f"{method}: non-finite density")
    require(out["mass_ok"], f"3D {method} {problem}: mass conservation "
            f"violated")
    require(len(out["E"]) == 3 and "Ex" not in out, "3D output keys")
    for lv, stop in zip(out["levels"], stops):
        require(stop < 1e-4, f"3D {method} {problem} level {lv['level']} "
                f"stopped at KKT {stop:.3e}")
    return out, launches, wall, peak


def require_band(what, iters, anchor):
    total, want = sum(iters), sum(anchor)
    log(f"    anchor {list(anchor)} ({want}): "
        f"{100.0 * (total - want) / want:+.1f}%")
    require(abs(total - want) <= 0.1 * want, f"{what}: total iterations "
            f"{total} not within 10% of {want}")


def require_ca_launches(what, launches, total):
    """The x-carry kernels of inPALM levels: one qx_step an iteration, one
    x_step and one cx_final a segment, cx_step the rest."""
    require(launches["qx_step"] == total, f"{what}: qx_step launched "
            f"{launches['qx_step']} times, not once per iteration ({total})")
    require(launches["x_step"] == launches["cx_final"] > 0, f"{what}: x_step "
            f"{launches['x_step']} and cx_final {launches['cx_final']} "
            f"launches, not one each a segment")
    require(launches["cx_step"] == total - launches["cx_final"],
            f"{what}: cx_step launched {launches['cx_step']} times")


def solves_3d(torch):
    """Phase 4f: the 3D path through ``solve_dot``: the 3D headline, the
    demo default pair, sGS-inPALM and acc-ADMM; returns the launches summed
    over the five solves and their results."""
    import numpy as np

    from dotsocp_tpu_torch.utils.objective import (gaussian_w2_squared,
                                                   transport_cost)

    results, total_launches = {}, {}
    out, launches, wall, peak = solve_3d(torch, "inPALM", "gaussian",
                                         *HEADLINE_3D)
    iters = [lv["iters"] for lv in out["levels"]]
    require_band("3D headline", iters, HEADLINE_3D_ANCHOR)
    require_ca_launches("3D headline", launches, sum(iters))
    rho = out["rho"].double().cpu().numpy()
    x = np.linspace(0.0, 1.0, rho.shape[-1])
    com = [float((rho[t] * x).sum() / rho[t].sum())
           for t in (0, rho.shape[0] // 2, rho.shape[0] - 1)]
    w2 = transport_cost(out["rho"], out["E"])
    w2_exact = gaussian_w2_squared((0.3,) * 3, (0.7,) * 3, 0.12, 0.12)
    log(f"    x centre of mass at t = 0, mid, end: "
        f"{[f'{c:.5f}' for c in com]} (geodesic 0.3, 0.5, 0.7); W2^2 "
        f"{w2:.5f} (closed form of the continuous Gaussians {w2_exact:g}; "
        f"printed, not held)")
    require(np.allclose(com, [0.3, 0.5, 0.7], rtol=0.0, atol=5e-3),
            f"3D headline: centre of mass {com} off the geodesic")
    results["headline_65"] = dict(iters=iters, total=sum(iters), wall_s=wall,
                                  com_x=com, w2=w2, peak_gib=peak)
    add_counts(total_launches, launches)
    for problem, anchor in DEMO_3D_ANCHORS.items():
        out, launches, wall, _ = solve_3d(torch, "inPALM", problem, *DEMO_3D)
        iters = [lv["iters"] for lv in out["levels"]]
        require_band(f"3D demo {problem}", iters, anchor)
        require_ca_launches(f"3D demo {problem}", launches, sum(iters))
        add_counts(total_launches, launches)
        results[f"demo_{problem}_33"] = dict(iters=iters, wall_s=wall)
    for (method, problem), anchor in VARIANT_3D_ANCHORS.items():
        out, launches, wall, _ = solve_3d(torch, method, problem,
                                          *VARIANT_3D)
        iters = [lv["iters"] for lv in out["levels"]]
        require_band(f"3D {method}", iters, anchor)
        if method == "sGS-inPALM":
            require(out["levels"][0]["method"].startswith(
                        "Inexact Proximal ALM"),
                    f"3D sGS-inPALM level 1 ran {out['levels'][0]['method']}")
            require(launches["rb_sweep"] == iters[-1], f"3D sGS-inPALM: "
                    f"rb_sweep launched {launches['rb_sweep']} times, not "
                    f"once per sGS iteration ({iters[-1]})")
            for name in ("z_step", "q_step", "beta_step"):
                require(launches[name] == iters[-1], f"3D sGS-inPALM: {name} "
                        f"launched {launches[name]} times, not once per sGS "
                        f"iteration ({iters[-1]})")
            require_ca_launches("3D sGS-inPALM level 1", launches, iters[0])
        else:
            acc = acc_iterations(method, out)
            require(acc == sum(iters) and launches["cone_project_diff"] == acc,
                    f"3D acc-ADMM: cone_project_diff launched "
                    f"{launches['cone_project_diff']} times, not once per "
                    f"iteration ({acc})")
        add_counts(total_launches, launches)
        results[f"{method}_{problem}_17"] = dict(iters=iters, wall_s=wall)
    return total_launches, results


# -- phase 5 --------------------------------------------------------------------

def event_ms(torch, fn, n):
    """Mean milliseconds of fn over n back-to-back runs (after one warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def paired(torch, plain_fn, kernel_fn, n):
    """Times in the order plain, kernel, kernel, plain; means of each."""
    p1 = event_ms(torch, plain_fn, n)
    k1 = event_ms(torch, kernel_fn, n)
    k2 = event_ms(torch, kernel_fn, n)
    p2 = event_ms(torch, plain_fn, n)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_bytes(geom):
    """Bytes each kernel moves through HBM, each input read once and each
    output written once (f32)."""
    import math

    S = math.prod(geom.space)
    nt, d, C = geom.nt, geom.ndim_space, geom.cone_cols
    cells, faces = (nt - 1) * S, d * nt * S
    return {
        "x_step": 4 * (cells + faces + 2 * C * cells),
        "qx_step": 4 * (nt * S + C * cells + 3 * cells + 3 * faces),
        # and the weight, once: w0 (cells) and wb (faces)
        "qx_step_w": 4 * (nt * S + C * cells + 4 * cells + 4 * faces),
        "cx_step": 4 * (cells + faces + 4 * C * cells),
        "cx_final": 4 * (cells + faces + 4 * C * cells),
        # one symmetric sweep: phi, rhs read and out written once each
        "rb_sweep": 3 * 4 * geom.n_centered,
        # q0, bs, beta -> z
        "z_step": 4 * (cells + faces + 2 * C * cells),
        # phi, z, beta, alpha -> q', alpha' (weighted: and w, once)
        "q_step": 4 * (nt * S + 2 * C * cells + 3 * cells + 3 * faces),
        "q_step_w": 4 * (nt * S + 2 * C * cells + 4 * cells + 4 * faces),
        # q0', bs', beta, z -> beta'
        "beta_step": 4 * (cells + faces + 3 * C * cells),
        # z2, beta -> z
        "cone_project_diff": 4 * 3 * C * cells,
        # phi read once, its shift written once
        "flat_shift": 4 * 2 * nt * S,
    }


def rhs_bytes(geom):
    """Bytes of the phi-step rhs kernel: q and alpha (and the weight), each
    read once, c read and the rhs written (f32). Kept beside
    ``kernel_bytes``, whose dict the benchmark's roofline freezes."""
    import math

    S = math.prod(geom.space)
    nt, d = geom.nt, geom.ndim_space
    cells, faces = (nt - 1) * S, d * nt * S
    return {"phi_rhs": 4 * (2 * cells + 2 * faces + 2 * nt * S),
            "phi_rhs_w": 4 * (3 * cells + 3 * faces + 2 * nt * S)}


def all_bytes(geom):
    return dict(kernel_bytes(geom), **rhs_bytes(geom))


def time_scale(torch):
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.ops import fused_step as fs

    nt, n = SCALE
    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device=DEVICE)
    initial_scaling(lv, scaling=True)
    kern = make_kernels(torch, lv)
    s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), 5)
    wdinv = fs.weighted_dinv(kern.ops, kern.ops.weight_to_internal(
        W.get_weight_by_barrier(n, n, nt, W.barrier_love_heart(),
                                dtype=torch.float32, device=DEVICE)),
        s.D, s.E)
    reps = 20
    times, library = time_kernels(torch, kern, s, wdinv, reps)
    log_times(times, all_bytes(lv.geom), lv.geom, reps)
    dev_ms = time_dev_entries(torch, kern, s, reps)
    log("  the *_dev entries (scalars read from memory, as the device "
        "driver's graphs launch them): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in dev_ms.items()))
    log(f"  flat_shift library call (F.pad of a slice) "
        f"{library['flat_shift']:.3f} ms")
    x = kern._fresh_x(s)

    rhs = kern._rhs(s)
    dct_ms = event_ms(torch, lambda: kern._poisson_solve(s, rhs), reps)
    phi_ms = event_ms(torch, lambda: kern._poisson_solve(s, kern._rhs(s)), reps)
    log(f"  DCT solve {dct_ms:.3f} ms; phi-step (rhs + DCT) {phi_ms:.3f} ms")

    state = {"ca": s.replace(z=x.clone(), alpha=s.alpha.clone(),
                             beta=s.beta.clone()),
             "plain": s.clone(), "step": s.clone()}

    def ca_iter():
        state["ca"] = kern._step_fused_x(state["ca"], final=False)

    def step_iter():
        state["step"] = kern._step(state["step"])

    def plain_iter():
        state["plain"] = kern._step_plain(state["plain"])

    ca_ms, plain_it_ms = paired(torch, plain_iter, ca_iter, 10)
    step_ms, plain_it2_ms = paired(torch, plain_iter, step_iter, 10)
    log(f"  one iteration: CA kernels {ca_ms:.3f} ms, single-step kernels "
        f"(_step) {step_ms:.3f} ms, plain step {plain_it_ms:.3f} / "
        f"{plain_it2_ms:.3f} ms")
    return times, library, dict(dct_ms=dct_ms, phi_step_ms=phi_ms,
                                ca_iter_ms=ca_ms, step_iter_ms=step_ms,
                                plain_iter_ms=(plain_it_ms + plain_it2_ms) / 2,
                                dev_entry_ms=dev_ms)


# (nt, n) of the KKT battery's times: the scale config and the 129 cell's
KKT_SHAPES = ((65, 513), (33, 129))


def kkt_bytes(geom, weighted=False):
    """Bytes of the KKT battery's one pass (``fused_step.kkt_sums``): phi,
    q, z, alpha, beta and c (and the weight) each read once, f32; the sums
    written are a few hundred bytes."""
    import math

    S = math.prod(geom.space)
    nt, d, C = geom.nt, geom.ndim_space, geom.cone_cols
    cells, faces = (nt - 1) * S, d * nt * S
    n = 2 * nt * S + 2 * (cells + faces) + 2 * C * cells
    return 4 * (n + (cells + faces if weighted else 0))


def device_launches(torch, fn):
    """The CUDA kernels one call of fn runs, from a torch.profiler window
    (None where the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def graph_ms(torch, fn, n):
    """Mean milliseconds of fn replayed from a captured CUDA graph (as the
    device driver's check graph runs it), over n replays after an eager run
    and the capture."""
    from dotsocp_tpu_torch.algorithms.graphs import SegmentGraphs

    graphs = SegmentGraphs(DEVICE)
    try:
        with graphs.context():
            graphs.run("battery", fn)
            return event_ms(torch, lambda: graphs.run("battery", fn), n)
    finally:
        graphs.release()


def time_kkt(torch):
    """Phase 5b: the KKT battery's sums, one kernel pass (``kkt_sums``, as
    the device driver's check graph launches it: the state's scalars read
    from memory) against the plain battery (``_kkt_parts_plain``), at
    ``KKT_SHAPES`` and weighted (love-heart) at 513^2 x 65, on a state 5 CA
    iterations into the level; 20 launches a side, plain, kernel, kernel,
    plain, then 20 replays of each from a captured graph. Every sum within
    1e-5 of the plain one (the inner products of the sum of their terms'
    magnitudes); the kernel's share of the one-pass bound, the device
    kernels a battery runs (torch.profiler)."""
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize

    out = {}
    for (nt, n), weighted in [(sh, False) for sh in KKT_SHAPES] + [
            (KKT_SHAPES[0], True)]:
        r0, r1 = get_example_2d("example2", n, n)
        weight = (W.get_weight_by_barrier(n, n, nt, W.barrier_love_heart(),
                                          dtype=torch.float32, device=DEVICE)
                  if weighted else None)
        lv = initialize(r0, r1, nt, dtype=torch.float32, device=DEVICE,
                        weight=weight)
        initial_scaling(lv, scaling=True)
        kern = make_kernels(torch, lv)
        s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), 5)
        ev = kern.e_scalars(s.D, s.E)
        s = s.replace(ev=ev, E=ev.E, **{
            f: torch.full((), float(getattr(s, f)), dtype=torch.float32,
                          device=DEVICE) for f in ("sigma", "cScale",
                                                   "dScale")})
        require(kern.kkt_on_kernel(s), "the battery takes the plain route")
        got, want = kern._kkt_parts(s), kern._kkt_parts_plain(s)
        scale = dict(want, pri=s.q.map(torch.abs).dot(s.alpha.map(torch.abs)),
                     dual=torch.sum(s.c.abs() * s.phi.abs()))
        err = max(abs(float(got[k]) - float(want[k])) / float(scale[k])
                  for k in want)
        require(err <= 1e-5, f"battery sums {err:.2e} from the plain ones")
        k_ms, p_ms = paired(torch, lambda: kern._kkt_parts_plain(s),
                            lambda: kern._kkt_parts(s), 20)
        kg_ms = graph_ms(torch, lambda: kern._kkt_parts(s), 20)
        pg_ms = graph_ms(torch, lambda: kern._kkt_parts_plain(s), 20)
        nbytes = kkt_bytes(lv.geom, weighted)
        name = f"{n}^2 x {nt}" + (" weighted" if weighted else "")
        row = {"ms": k_ms, "plain_ms": p_ms, "graph_ms": kg_ms,
               "plain_graph_ms": pg_ms, "bytes": nbytes,
               "bound_ms": bound_ms(nbytes), "max_rel_err": err,
               "launches": device_launches(torch,
                                           lambda: kern._kkt_parts(s)),
               "plain_launches": device_launches(
                   torch, lambda: kern._kkt_parts_plain(s))}
        out[name] = row
        log(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (from a "
            f"graph {kg_ms:.4f} and {pg_ms:.4f} ms), "
            f"{nbytes / 1e9:.3f} GB ({share(nbytes, k_ms)}; bound "
            f"{row['bound_ms']} ms), {row['launches']} vs "
            f"{row['plain_launches']} device kernels, sums within "
            f"{err:.2e}")
        del s, kern, lv, got, want
        torch.cuda.empty_cache()
    return out


def time_dev_entries(torch, kern, s, reps):
    """Each kernel that takes E-derived scalars, launched through its
    ``*_dev`` entry with the scalars in memory (``Kernels.e_scalars``, as
    the device driver's state holds them): {name: ms}."""
    from dotsocp_tpu_torch.ops import fused_step as fs

    ops = kern.ops
    ev = kern.e_scalars(s.D, s.E)
    sd = torch.full((), s.E / s.dScale, dtype=torch.float32, device=DEVICE)
    sbf, sv, tau = ev.sbf, ev.sv, kern.cfg.tau
    x = kern._fresh_x(s)
    work = {"alpha": s.alpha.clone(), "beta": s.beta.clone(), "x": x.clone()}
    runs = {
        "x_step": lambda: fs.x_step(ops, s.q, s.beta, sbf, sd),
        "qx_step": lambda: fs.qx_step(ops, s.phi, x, work["alpha"], ev.dinv,
                                      s.D, sbf, tau, sv=sv),
        "cx_step": lambda: fs.cx_step(ops, work["beta"], work["x"], s.q, sbf,
                                      sd, tau),
        "cx_final": lambda: fs.cx_final(ops, work["beta"], work["x"], s.q,
                                        sbf, sd, tau),
        "z_step": lambda: fs.z_step(ops, s.q, s.beta, sbf, sd),
        "q_step": lambda: fs.q_step(ops, s.phi, s.z, s.beta, s.alpha,
                                    ev.dinv, s.D, sbf, tau, sv=sv),
        "beta_step": lambda: fs.beta_step(ops, s.beta, s.z, s.q, sbf, sd,
                                          tau),
    }
    return {name: event_ms(torch, run, reps) for name, run in runs.items()}


def time_weighted_iteration(torch):
    """One weighted CA iteration (the kernels) against one plain weighted
    step at the weighted headline's finest level, 129^2 x 129."""
    lv = weighted_level(torch, 129, 129, DEVICE)
    kern = make_kernels(torch, lv)
    s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), 5)
    state = {"ca": s.replace(z=kern._fresh_x(s), alpha=s.alpha.clone(),
                             beta=s.beta.clone()),
             "plain": s.clone()}

    def ca_iter():
        state["ca"] = kern._step_fused_x(state["ca"], final=False)

    def plain_iter():
        state["plain"] = kern._step_plain(state["plain"])

    ca_ms, plain_ms = paired(torch, plain_iter, ca_iter, 10)
    log(f"  one weighted iteration at 129^2 x 129: CA kernels {ca_ms:.3f} ms, "
        f"plain step {plain_ms:.3f} ms")
    return dict(weighted_ca_iter_129_ms=ca_ms,
                weighted_plain_iter_129_ms=plain_ms)


def time_sweep(torch):
    """The sweep kernel against the plain sweep at 513^2 x 65 on a state of
    the sGS-inPALM kernels, one sGS iteration (the sweep kernel and the
    single-step kernels) against one with the plain post-phi passes, and
    the sweep at the sGS path's 129^2 x 33 on seeded inputs."""
    from dotsocp_tpu_torch.algorithms.core import LevelConfig
    from dotsocp_tpu_torch.algorithms.variants import SgsKernels
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.ops.sgs_sweep import rb_sweep

    nt, n = SCALE
    r0, r1 = get_example_2d("example2", n, n)
    lv = initialize(r0, r1, nt, dtype=torch.float32, device=DEVICE)
    initial_scaling(lv, scaling=True)
    kern = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                  dtype=torch.float32, device=DEVICE))
    s = kern.run_segment(kern.prep(lv.as_dict(), 0.1), 5)
    phi = kern.ops.phi_from_internal(s.phi)
    rhs = kern.ops.phi_from_internal(kern._rhs(s))
    d2 = s.D * s.D
    reps = 20
    k_ms, p_ms = paired(torch, lambda: kern.sgs.sweep(phi, rhs, 1, d2=d2),
                        lambda: rb_sweep(kern.sgs, phi, rhs, d2), reps)
    nbytes = kernel_bytes(lv.geom)["rb_sweep"]
    gbs = nbytes / (k_ms * 1e-3) / 1e9
    log(f"  rb_sweep  kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  "
        f"{nbytes / 1e9:.2f} GB (one pass) -> {gbs:7.1f} GB/s "
        f"({share(nbytes, k_ms)})")
    state = {"s": s, "p": s.clone()}

    def sgs_iter():
        state["s"] = kern._step(state["s"])

    def sgs_iter_plain_post():
        st = state["p"]
        state["p"] = kern._step_from_phi(st, kern._sweep(st, kern._rhs(st)),
                                         plain=True)

    it_ms, plain_post_ms = paired(torch, sgs_iter_plain_post, sgs_iter, 10)
    log(f"  one sGS-inPALM iteration: sweep kernel + single-step kernels "
        f"{it_ms:.3f} ms, sweep kernel + plain post-phi passes "
        f"{plain_post_ms:.3f} ms")
    del state, kern, s, phi, rhs
    # the sGS path's finest level (phase 4b), where t is cut into chunks
    small_ms, small_plain_ms = sweep_ms(torch, 33, (129, 129))
    return (k_ms, p_ms), dict(sweep_gbs=gbs, sgs_iter_ms=it_ms,
                              sgs_iter_plain_post_ms=plain_post_ms,
                              sweep_129x33_ms=small_ms,
                              sweep_129x33_plain_ms=small_plain_ms)


def time_kernels(torch, kern, s, wdinv, reps):
    """Each step kernel against its plain version on the state ``s`` of
    ``kern``'s level (weighted q-steps and rhs with ``wdinv``), the cone
    projection, the phi-step rhs and the flat shift at the first axis's stride; {name: (kernel ms,
    plain ms)}, and the shift's library call (one ``F.pad`` of a slice)."""
    import torch.nn.functional as F

    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops import shift

    ops = kern.ops
    sbf, sd, tau = s.E / s.D, s.E / s.dScale, kern.cfg.tau
    dinv = kern._diag_inv(s)
    x = kern._fresh_x(s)
    work = {"alpha": s.alpha.clone(), "beta": s.beta.clone(), "x": x.clone()}
    times = {}
    times["x_step"] = paired(
        torch, lambda: fs.x_step_plain(ops, s.q, s.beta, sbf, sd),
        lambda: fs.x_step(ops, s.q, s.beta, sbf, sd), reps)
    for name, d in (("qx_step", dinv), ("qx_step_w", wdinv)):
        times[name] = paired(
            torch, lambda: fs.qx_step_plain(ops, s.phi, x, s.alpha, d, s.D,
                                            sbf, tau),
            lambda: fs.qx_step(ops, s.phi, x, work["alpha"], d, s.D, sbf,
                               tau), reps)
    for name, final in (("cx_step", False), ("cx_final", True)):
        fn = fs.cx_final if final else fs.cx_step
        times[name] = paired(
            torch, lambda: fs.cx_step_plain(ops, s.beta, x, s.q, sbf, sd, tau,
                                            final),
            lambda: fn(ops, work["beta"], work["x"], s.q, sbf, sd, tau), reps)
    del work, x
    # the single-step kernels: fresh outputs, so no work copies
    times["z_step"] = paired(
        torch, lambda: fs.z_step_plain(ops, s.q, s.beta, sbf, sd),
        lambda: fs.z_step(ops, s.q, s.beta, sbf, sd), reps)
    for name, d in (("q_step", dinv), ("q_step_w", wdinv)):
        times[name] = paired(
            torch, lambda: fs.q_step_plain(ops, s.phi, s.z, s.beta, s.alpha,
                                           d, s.D, sbf, tau),
            lambda: fs.q_step(ops, s.phi, s.z, s.beta, s.alpha, d, s.D, sbf,
                              tau), reps)
    times["beta_step"] = paired(
        torch, lambda: fs.beta_step_plain(ops, s.beta, s.z, s.q, sbf, sd, tau),
        lambda: fs.beta_step(ops, s.beta, s.z, s.q, sbf, sd, tau), reps)
    z2 = ops.bfd(s.q, sbf, sd)
    times["cone_project_diff"] = paired(
        torch, lambda: fs.cone_project_diff_plain(z2, s.beta),
        lambda: fs.cone_project_diff(z2, s.beta), reps)
    del z2
    for name, w in (("phi_rhs", None), ("phi_rhs_w", wdinv.w)):
        times[name] = paired(
            torch, lambda: fs.phi_rhs_plain(ops, s.q, s.alpha, s.c, s.D, w),
            lambda: fs.phi_rhs(ops, s.q, s.alpha, s.c, s.D, w), reps)
    k = ops.strides[0]
    times["flat_shift"] = paired(
        torch, lambda: ops._sfwd(s.phi, 0),
        lambda: shift.flat_shift(s.phi, k, True), reps)
    library = {"flat_shift": event_ms(
        torch, lambda: F.pad(s.phi[..., : ops.S - k], (k, 0)), reps)}
    return times, library


def log_times(times, nbytes, geom, reps):
    log(f"  {geom.space} x {geom.nt} f32, means of {reps} launches (plain, "
        f"kernel, kernel, plain):")
    for name, (k_ms, p_ms) in times.items():
        gbs = nbytes[name] / (k_ms * 1e-3) / 1e9
        bound = bound_ms(nbytes[name])
        log(f"  {name:17s} kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  "
            f"{nbytes[name] / 1e9:.2f} GB -> {gbs:7.1f} GB/s "
            f"({share(nbytes[name], k_ms)}; bound "
            f"{'-' if bound is None else f'{bound:.3f}'} ms)")


def sweep_ms(torch, nt, space, reps=50):
    """(kernel ms, plain ms) of one sweep on seeded inputs of the shape
    (nt, *space), the kernel's times between two of the plain version's."""
    from dotsocp_tpu_torch.ops import sgs_sweep
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.sgs import make_sgs

    geom = Geometry(nt, space)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    phi, rhs = (torch.randn(geom.phi_shape, generator=gen, device=DEVICE)
                for _ in range(2))
    sgs = make_sgs(geom, dtype=torch.float32, device=DEVICE)
    d2 = level_scalars(geom)[0] ** 2
    times = paired(torch, lambda: sgs.sweep(phi, rhs, 1, d2=d2),
                   lambda: sgs_sweep.rb_sweep(sgs, phi, rhs, d2), reps)
    log(f"  rb_sweep at {space} x {nt}: kernel {times[0]:.4f} ms, plain "
        f"{times[1]:.4f} ms")
    return times


def time_sweep_3d(torch, lv=None, reps=10):
    """The sweep kernel against the plain sweep at the 3D scale level
    129^3 x 33 (gaussian) on a state of the sGS-inPALM kernels, and one
    sGS-inPALM iteration; returns ((kernel ms, plain ms), iteration ms)."""
    from dotsocp_tpu_torch.algorithms.core import LevelConfig
    from dotsocp_tpu_torch.algorithms.variants import SgsKernels
    from dotsocp_tpu_torch.ops.sgs_sweep import rb_sweep

    if lv is None:
        lv = gaussian_3d_level(torch, SCALE_3D[1], SCALE_3D[0], DEVICE)
    sk = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                dtype=torch.float32, device=DEVICE))
    s = sk.run_segment(sk.prep(lv.as_dict(), 0.1), 5)
    phi = sk.ops.phi_from_internal(s.phi)
    rhs = sk.ops.phi_from_internal(sk._rhs(s))
    d2 = s.D * s.D
    times = paired(torch, lambda: sk.sgs.sweep(phi, rhs, 1, d2=d2),
                   lambda: rb_sweep(sk.sgs, phi, rhs, d2), reps)
    del phi, rhs
    state = {"sgs": s}

    def sgs_iter():
        state["sgs"] = sk._step(state["sgs"])

    del s
    sgs_ms = event_ms(torch, sgs_iter, reps)
    del state, sk
    torch.cuda.empty_cache()
    log(f"  rb_sweep at {lv.geom.space} x {lv.geom.nt}: kernel "
        f"{times[0]:8.3f} ms  plain {times[1]:8.3f} ms; one sGS-inPALM "
        f"iteration {sgs_ms:.3f} ms")
    return times, sgs_ms


def time_scale_3d(torch):
    """Phase 5 in 3D, at the 3D scale level 129^3 x 33 (gaussian): every
    DIM = 3 kernel against its plain version (the weighted q-steps with
    seeded walls), the sweep kernel, and one CA, one single-step and one
    sGS iteration against one plain step; at most two level states live
    at a time."""
    from dotsocp_tpu_torch.ops import fused_step as fs

    nt, n = SCALE_3D
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lv = gaussian_3d_level(torch, n, nt, DEVICE)
    kern = make_kernels(torch, lv)
    s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), 5)
    wdinv = fs.weighted_dinv(kern.ops, kern.ops.weight_to_internal(
        check_weight(torch, lv.geom, 0)), s.D, s.E)
    reps = 10
    times, library = time_kernels(torch, kern, s, wdinv, reps)
    del wdinv
    torch.cuda.empty_cache()
    nbytes = all_bytes(lv.geom)
    state = {"ca": s.replace(z=kern._fresh_x(s), alpha=s.alpha.clone(),
                             beta=s.beta.clone())}

    def ca_iter():
        state["ca"] = kern._step_fused_x(state["ca"], final=False)

    def step_iter():
        state["step"] = kern._step(state["step"])

    def plain_iter():
        state["plain"] = kern._step_plain(state["plain"])

    ca_ms = event_ms(torch, ca_iter, reps)
    del state["ca"]
    state["step"] = s.clone()
    step_ms = event_ms(torch, step_iter, reps)
    del state["step"]
    state["plain"] = s.clone()
    plain_ms = event_ms(torch, plain_iter, reps)
    del state["plain"]
    rhs = kern._rhs(s)
    dct_ms = event_ms(torch, lambda: kern._poisson_solve(s, rhs), reps)
    del rhs, kern, s
    torch.cuda.empty_cache()

    times["rb_sweep"], sgs_ms = time_sweep_3d(torch, lv, reps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    log_times(times, nbytes, lv.geom, reps)
    log(f"  flat_shift library call (F.pad of a slice) "
        f"{library['flat_shift']:.3f} ms")
    log(f"  one iteration at {lv.geom.space} x {nt}: CA kernels {ca_ms:.3f} "
        f"ms, single-step kernels (_step) {step_ms:.3f} ms, plain step "
        f"{plain_ms:.3f} ms, sGS-inPALM (sweep + single-step kernels) "
        f"{sgs_ms:.3f} ms; DCT solve {dct_ms:.3f} ms; peak device memory "
        f"{peak:.2f} GiB")
    return times, library, dict(ca_iter_ms=ca_ms, step_iter_ms=step_ms,
                                plain_iter_ms=plain_ms, sgs_iter_ms=sgs_ms,
                                dct_ms=dct_ms, peak_gib=peak)


def busy_share(torch, what, window, trace_path):
    """Device busy share of ``window()`` (which ends in a synchronize):
    kernel time from torch.profiler, wall time from an unprofiled run of
    the same window. Writes a chrome trace to ``trace_path`` if given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    window()
    t0 = time.monotonic()
    window()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=12))
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    busy = 100 * busy_us / 1e6 / wall
    log(f"  {what}: wall {1e3 * wall:.3f} ms unprofiled, kernels "
        f"{busy_us / 1e3:.3f} ms -> device busy {busy:.0f}%, idle "
        f"{100 - busy:.0f}%")
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return dict(wall_ms=1e3 * wall, kernel_ms=busy_us / 1e3, busy_pct=busy)


def profile_window(torch, trace_dir):
    """Device busy share over 20 CA iterations at the headline finest level,
    and over 20 float64 tail iterations there (the plain route, the port's
    'auto' DCT); with ``trace_dir``, a chrome trace of each."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.multilevel.solve import AUTO_DCT_SPLIT

    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    lv = headline_level(torch, torch.device(DEVICE))
    kern = make_kernels(torch, lv)
    s = kern.run_segment(kern.prep(lv.as_dict(), 1.0), 20)
    state = {"s": s.replace(z=kern._fresh_x(s))}

    def window():
        for _ in range(20):
            state["s"] = kern._step_fused_x(state["s"], final=False)
        torch.cuda.synchronize()

    ca = busy_share(torch, "20 CA iterations at 129^2 x 33", window,
                    trace_dir and os.path.join(trace_dir,
                                               "ca_iterations_trace.json"))
    kern64 = Kernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                 dtype=torch.float64, device=DEVICE,
                                 dct_split=AUTO_DCT_SPLIT))
    tail = {"s": kern64.run_segment(kern64.prep(lv.as_dict(), 1.0), 20)}

    def tail_window():
        tail["s"] = kern64.run_segment(tail["s"], 20)
        torch.cuda.synchronize()

    f64 = busy_share(torch, "20 float64 tail iterations at 129^2 x 33",
                     tail_window,
                     trace_dir and os.path.join(trace_dir,
                                                "f64_tail_trace.json"))
    print(json.dumps({"busy": {"ca_129x33": ca, "f64_tail_129x33": f64}}),
          flush=True)


# -- phase 7: the device driver --------------------------------------------------

# iterations of each replay-against-eager segment (phase 7a)
SEG_REPLAY = 40
REPLAY_CASES = ("CA 129^2 x 33", "weighted CA 129^2 x 33",
                "sGS-inPALM 129^2 x 33", "acc-ADMM 129^2 x 33",
                "3D CA 17^3 x 9", "float64 plain route 129^2 x 33")
# the solves phase 7b runs under both drivers: (problem, n, nt, levels,
# method, opts); weighted and 3D by name
DRIVER_SOLVES = {
    "headline": ("DOTmark_4stitch", 129, 33, 3, "inPALM", {"tol": 1e-4}),
    "north star": ("DOTmark_4stitch", 129, 33, 3, "inPALM", REFINE_OPTS),
    "sGS path": ("DOTmark_4stitch", 129, 33, 3, "sGS-inPALM", {"tol": 1e-4}),
    "acc-ADMM 65^2 x 17": ("example2", 65, 17, 2, "acc-ADMM", {"tol": 1e-4}),
    "weighted headline": ("love-heart", 129, 129, 3, "inPALM", {"tol": 1e-3}),
    "3D headline": ("gaussian", 65, 33, 3, "inPALM", {"tol": 1e-4}),
}
# the peak device memory of a few iterations at the largest levels
MEMORY_SOLVES = {"513^2 x 65": ("example2", 513, 65),
                 "129^3 x 33": ("gaussian", 129, 33)}
RESUME = ("example2", 65, 17, {"tol": 1e-4, "chunk_iters": 100})


def driver_case(torch, name):
    """(make, var, counter) of a device driver for phase 7a's ``name``: the
    headline's finest level (love-heart 129^2 x 33 weighted, gaussian
    17^3 x 9 in 3D); acc-ADMM's counter puts an anchor restart in the
    middle of the first segment."""
    import dataclasses

    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.algorithms.device_driver import (AccDeviceDriver,
                                                            DeviceDriver)
    from dotsocp_tpu_torch.algorithms.device_sgs import SgsDeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.algorithms.variants import (AccADMMKernels,
                                                       SgsKernels)

    if name.startswith("weighted"):
        lv = weighted_level(torch, 129, 33, DEVICE)
    elif name.startswith("3D"):
        lv = gaussian_3d_level(torch, 17, 9, DEVICE)
    else:
        lv = headline_level(torch, DEVICE)
    dtype = torch.float64 if name.startswith("float64") else torch.float32
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9, dtype=dtype,
                      device=DEVICE)
    o = SolveOptions()
    if name.startswith("acc-ADMM"):
        kern = AccADMMKernels(dataclasses.replace(cfg, tau=1.0))
        return (lambda: AccDeviceDriver(kern, o), lv.as_dict(),
                kern.restart - SEG_REPLAY // 2)
    if name.startswith("sGS"):
        kern = SgsKernels(cfg)
        return lambda: SgsDeviceDriver(kern, o), lv.as_dict(), None
    kern = Kernels(cfg, lv.weight)
    return lambda: DeviceDriver(kern, o), lv.as_dict(), None


def graph_replays(torch):
    """Phase 7a: for each of ``REPLAY_CASES``, a 40-iteration segment
    replayed from the device driver's CUDA graphs against the same segment
    run eagerly, then again after a rescale and after a sigma change:
    bit-equal, or (printing the first tensor that differs and the largest
    gap) within rtol 2e-5 / atol 2e-6. Then the per-iteration wall time of
    the CA iteration at 129^2 x 33 eager, replayed one iteration a graph,
    and replayed as one 40-iteration graph."""
    from dotsocp_tpu_torch.algorithms.device_driver import replay_against_eager

    results = {}
    for name in REPLAY_CASES:
        make, var, counter = driver_case(torch, name)
        rows = replay_against_eager(make, var, SEG_REPLAY, counter)
        torch.cuda.synchronize()
        results[name] = {}
        for what, gap, first, scale in rows:
            log(f"  {name}, {SEG_REPLAY} iterations {what}: " + (
                "graphs bit-equal to eager" if first is None else
                f"tensor {first} differs first, largest gap {gap:.3e} "
                f"(largest entry {scale:.3e})"))
            require(first is None or gap <= 2e-6 + 2e-5 * scale,
                    f"{name} {what}: replay differs from eager by {gap:.3e}")
            results[name][what] = dict(bit_equal=first is None, gap=gap,
                                       first_tensor=first)
        torch.cuda.empty_cache()
    results["ca_iteration_ms"] = graph_design_times(torch)
    return results


def graph_design_times(torch):
    """Wall time of one CA iteration at 129^2 x 33 (40 iterations ending in
    a synchronize, best of three): eager, one one-iteration graph replayed
    40 times, and one graph of 40 iterations replayed once."""
    make, var, _ = driver_case(torch, "CA 129^2 x 33")
    d = make()
    d.prepare(var)

    def ca():
        d._ca_iteration(False)

    def block():
        for _ in range(SEG_REPLAY):
            d._ca_iteration(False)

    runs = {
        "eager": lambda: [ca() for _ in range(SEG_REPLAY)],
        "one_iteration_graph": lambda: [d.graphs.run("ca_iteration", ca)
                                        for _ in range(SEG_REPLAY)],
        "graph_of_40": lambda: d.graphs.run("ca_block", block),
    }
    out = {}
    with d._on_stream():
        d._ca_prologue()
        for name, fn in runs.items():
            best = float("inf")
            for _ in range(4):  # the first run warms up / captures
                torch.cuda.synchronize()
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                best = min(best, time.monotonic() - t0)
            out[name] = 1e3 * best / SEG_REPLAY
    log(f"  one CA iteration at 129^2 x 33 (ms, wall over {SEG_REPLAY}): "
        f"{out}")
    return out


def _solve_pair_inputs(torch, name):
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d, get_example_3d

    problem, n, nt, levels, method, opts = DRIVER_SOLVES[name]
    if problem == "love-heart":
        barrier = W.barrier_love_heart()
        r0, r1 = W.get_example_w2d(problem, n, n)
        r0, r1, _ = W.ensure_barrier_validity(r0, r1, barrier)
        weight = W.get_weight_by_barrier(n, n, nt, barrier,
                                         dtype=torch.float32, device=DEVICE)
        return (r0, r1, nt, levels, opts, method, weight, barrier)
    if problem == "gaussian":
        r0, r1 = get_example_3d(problem, n, n, n)
    else:
        r0, r1 = get_example_2d(problem, n, n)
    return (r0, r1, nt, levels, opts, method, None, None)


def driver_solve(torch, name, driver, profile):
    """One solve of ``DRIVER_SOLVES[name]`` under ``driver``: iterations,
    wall, launches (counted from 0), the host syncs of the whole solve
    (torch.cuda.set_sync_debug_mode("warn"); the device driver's loops run
    under "error" but for the one read of a check, which its stats count)
    and, with ``profile``, the device busy share of a second, profiled run
    (kernel time over the unprofiled wall)."""
    import warnings

    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    r0, r1, nt, levels, opts, method, weight, barrier = \
        _solve_pair_inputs(torch, name)
    opts = dict(opts, driver=driver)

    def run():
        return solve_dot(r0, r1, nt, levels, opts, method, weight, barrier,
                         device=DEVICE, dtype=torch.float32, verbose=False)

    reset_launch_counts()
    torch.cuda.synchronize()
    DeviceDriver.sync_debug = "error"
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.monotonic()
            out, _, _ = run()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            torch.cuda.set_sync_debug_mode(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        DeviceDriver.sync_debug = None
    launches = launch_counts()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    levels_ = out["levels"]
    checks = loop_syncs = declined = cuts = 0
    for lv in levels_:
        st = lv.get("driver")
        if st is None or lv.get("refine"):
            # the float64 tail launches no kernel: its segments count for
            # nothing in the launches compared below
            if st is not None:
                checks += st["checks"]
                loop_syncs += st["syncs"]
            continue
        checks += st["checks"]
        loop_syncs += st["syncs"]
        declined += st["ratio_evals"] - max(st["stage"] - 3, 0)
        cuts += st["chunk_cuts"]
        require(st["syncs"] <= st["checks"], f"{name} ({driver}) level "
                f"{lv['level']}: {st['syncs']} syncs in the loop for "
                f"{st['checks']} checks")
    res = dict(iters=[lv["iters"] for lv in levels_], wall_s=wall,
               launches={k: v for k, v in launches.items() if v},
               solve_syncs=syncs + loop_syncs, mass_ok=bool(out["mass_ok"]))
    if driver == "device":
        res.update(loop_syncs=loop_syncs, checks=checks,
                   syncs_per_check=loop_syncs / max(checks, 1),
                   declined_rescales=declined, chunk_cuts=cuts)
    if profile:
        def synced():
            run()
            torch.cuda.synchronize()

        kernel_ms, busy = device_busy(torch, synced, wall)
        res.update(kernel_ms=kernel_ms, busy_pct=busy)
    log(f"  {name}, {driver} driver: iterations {res['iters']}, wall "
        f"{wall:.3f} s, host syncs {res['solve_syncs']}"
        + (f" (loops {loop_syncs} for {checks} checks, "
           f"{res['syncs_per_check']:.3f} a check; declined periodic "
           f"rescales {declined}, segments cut at a chunk's end {cuts})"
           if driver == "device" else "")
        + (f", device busy {res['busy_pct']:.0f}%" if profile else "")
        + f"; launches {res['launches']}")
    return res


def driver_pairs(torch, profile):
    """Phase 7b: each of ``DRIVER_SOLVES`` under the host and the device
    driver; the same iterations where phase 4h holds exact counts (the
    north star's levels), and where the iterations agree, the same q-step
    launches (one an iteration) under both; the x-carry segments differ:
    the host driver cuts one more after a periodic rescale the ratio test
    declines, the device driver (as the JAX one) one more at a chunk's
    end, and the two then meet their checks at other points, so only the
    declined rescales and the chunk cuts are printed beside the x_step
    counts; one host sync at most a check in the device driver's loops. Then the peak device memory of
    a few iterations at 513^2 x 65 and 129^3 x 33 under each driver."""
    results = {}
    for name in DRIVER_SOLVES:
        pair = {drv: driver_solve(torch, name, drv, profile)
                for drv in ("host", "device")}
        host, dev = pair["host"], pair["device"]
        if host["iters"] == dev["iters"]:
            # one q-step a CA iteration and one x_step / cx_final a segment
            # under both drivers; the segments differ (see the docstring)
            hl, dl = host["launches"], dev["launches"]
            for q in ("qx_step", "qx_step_w"):
                require(hl.get(q, 0) == dl.get(q, 0), f"{name}: {q} "
                        f"{dl.get(q, 0)} (device) against {hl.get(q, 0)} "
                        f"(host)")
            for ls in (hl, dl):
                require(ls.get("x_step", 0) == ls.get("cx_final", 0)
                        and ls.get("cx_step", 0) + ls.get("cx_final", 0)
                        == ls.get("qx_step", 0) + ls.get("qx_step_w", 0),
                        f"{name}: x-carry launches {ls} are not one segment "
                        f"structure")
        if name == "north star":
            require(tuple(dev["iters"][:3]) == REFINE_ANCHOR["levels"],
                    f"north star (device): levels {dev['iters'][:3]}")
        if name == "sGS path":
            require(tuple(host["iters"]) == SGS_HOST_ANCHOR,
                    f"sGS path (host): iterations {host['iters']}, not "
                    f"{list(SGS_HOST_ANCHOR)}")
        results[name] = pair
        torch.cuda.empty_cache()
    results["peak_gib"] = driver_memory(torch)
    return results


def driver_memory(torch):
    """Peak device memory (GiB) of 20 iterations of one level at each of
    ``MEMORY_SOLVES`` under each driver."""
    from dotsocp_tpu_torch.models.examples import get_example_2d, get_example_3d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    out = {}
    for name, (problem, n, nt) in MEMORY_SOLVES.items():
        r0, r1 = (get_example_3d(problem, n, n, n) if problem == "gaussian"
                  else get_example_2d(problem, n, n))
        out[name] = {}
        for driver in ("host", "device"):
            cold_memory(torch)
            solve_dot(r0, r1, nt, 1, {"tol": 1e-4, "maxit": 20,
                                      "driver": driver},
                      "inPALM", device=DEVICE, verbose=False)
            torch.cuda.synchronize()
            out[name][driver] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  peak device memory, 20 inPALM iterations at {name}: "
            f"{out[name]} GiB")
    return out


def resume_check(torch):
    """Phase 7c: example2 65^2 x 17, one level, chunk_iters 100: a
    checkpoint_dir run cut by max_chunks=1, then resumed, ends with the
    uninterrupted run's iterations."""
    import shutil

    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    problem, n, nt, opts = RESUME
    r0, r1 = get_example_2d(problem, n, n)
    ck = os.path.join(ROOT, "build", "checkpoint_smoke")
    shutil.rmtree(ck, ignore_errors=True)

    def run(**kw):
        out, _, _ = solve_dot(r0, r1, nt, 1, dict(opts, **kw), "inPALM",
                              device=DEVICE, verbose=False)
        return out["levels"][0]["iters"]

    try:
        full = run()
        cut = run(checkpoint_dir=ck, max_chunks=1)
        resumed = run(checkpoint_dir=ck)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    log(f"  {problem} {n}^2 x {nt}, chunks of {opts['chunk_iters']}: "
        f"uninterrupted {full} iterations; cut after one chunk at {cut}, "
        f"resumed to {resumed}")
    require(cut == opts["chunk_iters"] < full, f"the cut run stopped at {cut}")
    require(resumed == full, f"resumed run took {resumed} iterations, the "
            f"uninterrupted {full}")
    return dict(full=full, cut=cut, resumed=resumed)


# -- phase 8: the fleet ---------------------------------------------------------

# The lockstep fleet's kernels: the batched forms of TPU kernels 7-10
# (under the JAX package's jax.vmap), one launch for B instances
BATCHED = {"x_step_b": "x_step", "qx_step_b": "qx_step",
           "cx_step_b": "cx_step", "cx_final_b": "cx_final"}
# (B, nt, space) of the batched kernel checks; the first two are also timed
BATCH_SHAPES = ((8, 33, (129, 129)), (32, 17, (65, 65)), (3, 9, (17, 17, 17)))
# The fleet of scripts/fleet_bench.py (eight different problems at
# 129^2 x 33, 3 levels, tol 1e-4, inPALM). FLEET_ANCHOR is the JAX
# package's solve_batch on the CPU at this configuration in float32 (JAX
# 0.9.0, x64 off as fleet_bench runs; ``python tests/test_torch_batch.py
# --fleet-anchor``): the total iterations are held to +-10% of it, each
# instance's done_it printed against it. Per instance, float32 counts turn
# on sigma-table decisions at a threshold: example2's level 2 applies a
# factor at iteration 414 in JAX and not in the port (CPU and card), and
# its level 3 then stops at 464 in JAX, 529 in the port on the CPU (PERF.md
# section 6). FLEET_ANCHOR_F64 is the same JAX run in float64 (x64 on,
# ``--fleet-anchor --f64``): the port's float64 fleet on the card (the
# plain route by dtype) is held to it exactly, instance by instance.
FLEET = (129, 33, 3, 1e-4)
FLEET_ANCHOR = {"done_it": (79, 464, 99, 144, 314, 159, 214, 89),
                "iters": 2282}
FLEET_ANCHOR_F64 = {"done_it": (79, 414, 99, 144, 264, 159, 189, 89),
                    "iters": 2232}
# each instance's rho gap, relative, between the JAX package's solve_batch
# and its solve_dot (device driver) of the instance alone, float32 on the
# CPU (``--fleet-anchor --rel``): the lockstep fleet's documented
# deviations (rescales at the cadence, no E2 feedback) move DOTmark's rho
# by 1.4e-2 in the reference itself, so each instance is held to 1e-2 or,
# where the reference's own gap is larger, to 1.1 times that gap
FLEET_REL_JAX = (6.178e-04, 2.224e-04, 2.481e-03, 6.515e-03, 3.209e-04,
                 1.402e-02, 1.997e-04, 1.626e-04)
# the crossover's fleet: demos/demo_batch.py's (example2 shifted, seeded),
# B = 8 at (n, nt, levels); phase 8c's fleet is reported beside it
CROSSOVER = ((33, 9, 2), (65, 17, 2), (129, 33, 3), (257, 65, 3),
             (385, 49, 3))
FLEET_B = 8


def batch_inputs(torch, geom, B, seed, dev):
    """Seeded stacked inputs of the batched kernels: per-instance sd in
    [0.5, 2) (ragged, as instances rescale on their own) and every third
    instance inactive."""
    import numpy as np

    from dotsocp_tpu_torch.ops.engine import OpsFlat
    from dotsocp_tpu_torch.ops.staggered import Staggered

    ops = OpsFlat(geom, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, nt, S, C = geom.ndim_space, geom.nt, ops.S, geom.cone_cols

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def stag():
        return Staggered(rand(B, nt - 1, S), rand(B, d, nt, S) * ops.masks)

    rng = np.random.default_rng(seed)
    sd = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).to(dev)
    active = torch.tensor([b % 3 != 1 for b in range(B)], device=dev)
    return ops, dict(q=stag(), alpha=stag(), q_out=stag(), phi=rand(B, nt, S),
                     beta=rand(B, C, nt - 1, S), x=rand(B, C, nt - 1, S),
                     sd=sd, active=active)


def check_batched(torch, cmp, B, nt, space, seed):
    """Phase 8a at one shape: each batched kernel against B launches of
    its single-instance kernel (bit-equal per active instance, sd by
    value), an inactive instance left bit-equal, q' ghost face slots
    exactly zero, and against its plain version (rtol 2e-5 / atol 2e-6)."""
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import diag_values
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.staggered import Staggered

    geom = Geometry(nt, space)
    ops, v = batch_inputs(torch, geom, B, seed, torch.device(DEVICE))
    D, E, _ = level_scalars(geom)
    sbf, tau = E / D, 1.9
    dinv = tuple(1.0 / x for x in diag_values(D, E))
    sd, active = v["sd"], v["active"]
    live = [b for b in range(B) if bool(active[b])]
    sds = sd.tolist()

    def at(st, b):
        return Staggered(st.q0[b], st.bs[b])

    def same(a, b):
        return bool(torch.equal(a, b))

    x = fs.x_step_batched(ops, v["q"], v["beta"], sbf, sd, active,
                          v["x"].clone())
    cmp("x_step_b", x, fs.x_step_batched_plain(ops, v["q"], v["beta"], sbf,
                                               sd, active, v["x"]))
    require(all(same(x[b], fs.x_step(ops, at(v["q"], b), v["beta"][b], sbf,
                                      sds[b])) for b in live),
            f"x_step_b differs from x_step at {space} x {nt}, B {B}")
    frozen = all(same(x[b], v["x"][b]) for b in range(B) if b not in live)
    alpha = Staggered(v["alpha"].q0.clone(), v["alpha"].bs.clone())
    q_out = Staggered(v["q_out"].q0.clone(), v["q_out"].bs.clone())
    q, a = fs.qx_step_batched(ops, v["phi"], v["x"], alpha, q_out, dinv, D,
                              sbf, tau, active)
    wq, wa = fs.qx_step_batched_plain(ops, v["phi"], v["x"], v["alpha"],
                                      v["q_out"], dinv, D, sbf, tau, active)
    exact = geom.ndim_space == 3
    for got, want in ((q.q0, wq.q0), (q.bs, wq.bs), (a.q0, wa.q0),
                      (a.bs, wa.bs)):
        cmp("qx_step_b", got, want, exact=exact)
    for b in live:
        sq, sa = fs.qx_step(ops, v["phi"][b], v["x"][b],
                            Staggered(v["alpha"].q0[b].clone(),
                                      v["alpha"].bs[b].clone()),
                            dinv, D, sbf, tau)
        require(all(same(g, w) for g, w in ((q.q0[b], sq.q0),
                                            (q.bs[b], sq.bs),
                                            (a.q0[b], sa.q0),
                                            (a.bs[b], sa.bs))),
                f"qx_step_b differs from qx_step at {space} x {nt}, B {B}, "
                f"instance {b}")
    frozen &= all(same(q.q0[b], v["q_out"].q0[b])
                  and same(q.bs[b], v["q_out"].bs[b])
                  and same(a.q0[b], v["alpha"].q0[b])
                  and same(a.bs[b], v["alpha"].bs[b])
                  for b in range(B) if b not in live)
    ghost = (q.bs[live] * (1.0 - ops.masks)).abs().max()
    require(float(ghost) == 0.0, "qx_step_b wrote a non-zero ghost face "
            "slot")
    for name, final in (("cx_step_b", False), ("cx_final_b", True)):
        fn = fs.cx_final_batched if final else fs.cx_step_batched
        single = fs.cx_final if final else fs.cx_step
        bb, xx = fn(ops, v["beta"].clone(), v["x"].clone(), v["q"], sbf, sd,
                    tau, active)
        wb, wx = fs.cx_step_batched_plain(ops, v["beta"], v["x"], v["q"], sbf,
                                          sd, tau, active, final)
        cmp(name, bb, wb)
        cmp(name, xx, wx)
        for b in live:
            sb, sx = single(ops, v["beta"][b].clone(), v["x"][b].clone(),
                            at(v["q"], b), sbf, sds[b], tau)
            require(same(bb[b], sb) and same(xx[b], sx),
                    f"{name} differs from {BATCHED[name]} at {space} x {nt}, "
                    f"B {B}, instance {b}")
        frozen &= all(same(bb[b], v["beta"][b]) and same(xx[b], v["x"][b])
                      for b in range(B) if b not in live)
    torch.cuda.synchronize()
    require(frozen, f"a batched kernel wrote an inactive instance at {space} "
            f"x {nt}, B {B}")
    log(f"  B {B} x {space} x {nt}: every batched kernel bit-equal to its "
        f"single-instance kernel on the {len(live)} active instances, the "
        f"{B - len(live)} inactive ones untouched; against the plain "
        f"versions " + ", ".join(f"{k} {cmp.max_abs[k]:.2e}" for k in BATCHED))


def batched_bytes(geom, B):
    """Bytes each batched kernel moves for B instances: B times the
    single kernel's, plus sd (4 B) and the mask (1 B) an instance."""
    nb = kernel_bytes(geom)
    return {k: B * nb[single] + B * (1 + (4 if k != "qx_step_b" else 0))
            for k, single in BATCHED.items()}


def time_batched(torch, B, nt, space, seed):
    """Each batched kernel (all instances active) against its plain version
    and against B launches of its single-instance kernel, means of 20
    (plain, kernel, kernel, plain); {name: (kernel ms, plain ms, B single
    launches ms)}."""
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.engine import diag_values
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.staggered import Staggered

    geom = Geometry(nt, space)
    ops, v = batch_inputs(torch, geom, B, seed, torch.device(DEVICE))
    v["active"].fill_(True)
    D, E, _ = level_scalars(geom)
    sbf, tau = E / D, 1.9
    dinv = tuple(1.0 / x for x in diag_values(D, E))
    sd, act = v["sd"], v["active"]
    sds = sd.tolist()
    q, phi, beta, x = v["q"], v["phi"], v["beta"], v["x"]
    work = {"alpha": Staggered(v["alpha"].q0.clone(), v["alpha"].bs.clone()),
            "q": v["q_out"], "beta": beta.clone(), "x": x.clone(),
            "xo": x.clone()}
    qs = [Staggered(q.q0[b], q.bs[b]) for b in range(B)]
    alphas = [Staggered(work["alpha"].q0[b], work["alpha"].bs[b])
              for b in range(B)]
    reps = 20
    out = {}

    def trio(plain, kernel, singles):
        k_ms, p_ms = paired(torch, plain, kernel, reps)
        return k_ms, p_ms, event_ms(torch, singles, reps)

    out["x_step_b"] = trio(
        lambda: fs.x_step_batched_plain(ops, q, beta, sbf, sd, act, x),
        lambda: fs.x_step_batched(ops, q, beta, sbf, sd, act, work["xo"]),
        lambda: [fs.x_step(ops, qs[b], beta[b], sbf, sds[b])
                 for b in range(B)])
    out["qx_step_b"] = trio(
        lambda: fs.qx_step_batched_plain(ops, phi, x, v["alpha"], v["q_out"],
                                         dinv, D, sbf, tau, act),
        lambda: fs.qx_step_batched(ops, phi, x, work["alpha"], work["q"],
                                   dinv, D, sbf, tau, act),
        lambda: [fs.qx_step(ops, phi[b], x[b], alphas[b], dinv, D, sbf, tau)
                 for b in range(B)])
    for name, final in (("cx_step_b", False), ("cx_final_b", True)):
        fn = fs.cx_final_batched if final else fs.cx_step_batched
        single = fs.cx_final if final else fs.cx_step
        out[name] = trio(
            lambda: fs.cx_step_batched_plain(ops, beta, x, q, sbf, sd, tau,
                                             act, final),
            lambda: fn(ops, work["beta"], work["x"], q, sbf, sd, tau, act),
            lambda: [single(ops, work["beta"][b], work["x"][b], qs[b], sbf,
                            sds[b], tau) for b in range(B)])
    nbytes = batched_bytes(geom, B)
    log(f"  B {B} x {space} x {nt} f32, means of {reps} launches (plain, "
        f"kernel, kernel, plain), and {B} single-instance launches:")
    for name, (k_ms, p_ms, s_ms) in out.items():
        bound = bound_ms(nbytes[name])
        log(f"  {name:11s} batched {k_ms:8.3f} ms  plain {p_ms:8.3f} ms  "
            f"{B} singles {s_ms:8.3f} ms  {nbytes[name] / 1e9:.3f} GB "
            f"({share(nbytes[name], k_ms)}; bound "
            f"{'-' if bound is None else f'{bound:.3f}'} ms)")
    return out, nbytes


def batched_kernels(torch):
    """Phase 8a: the batched kernels at ``BATCH_SHAPES``, then their times
    at the first two."""
    cmp = Compare(torch)
    for seed, (B, nt, space) in enumerate(BATCH_SHAPES):
        check_batched(torch, cmp, B, nt, space, 100 + seed)
        torch.cuda.empty_cache()
    times = {}
    for seed, (B, nt, space) in enumerate(BATCH_SHAPES[:2]):
        times[(B, nt, space)] = time_batched(torch, B, nt, space, 200 + seed)
        torch.cuda.empty_cache()
    return dict(cmp.max_abs), times


def fleet_problems(n):
    """The eight problems of ``scripts/fleet_bench.py:make_fleet`` from the
    port's generators (example1-4, circle, DOTmark-4stitch, two gaussian
    pairs)."""
    import numpy as np

    from dotsocp_tpu_torch.models.examples import (_gaussian2d, _normalize,
                                                   get_example_2d)

    probs = ["example1", "example2", "example3", "example4", "circle",
             "DOTmark_4stitch"]
    pairs = [get_example_2d(p, n, n) for p in probs]
    for a, b, s in (((0.3, 0.3), (0.7, 0.7), 0.08),
                    ((0.2, 0.5), (0.8, 0.5), 0.12)):
        pairs.append((_normalize(_gaussian2d(n, n, a[0], a[1], s)),
                      _normalize(_gaussian2d(n, n, b[0], b[1], s))))
    return (np.stack([np.asarray(a) for a, _ in pairs]),
            np.stack([np.asarray(b) for _, b in pairs]))


def demo_fleet(n, B=FLEET_B):
    """``demos/demo_batch.py``'s fleet: example2 with seeded shifts."""
    import numpy as np

    from dotsocp_tpu_torch.models.examples import get_example_2d

    rng = np.random.default_rng(0)
    base0, base1 = get_example_2d("example2", n, n)
    r0s, r1s = [], []
    for _ in range(B):
        shift = int(rng.integers(0, n // 4))
        r0s.append(np.roll(base0, shift, axis=1))
        r1s.append(np.roll(base1, -shift, axis=0))
    return np.stack(r0s), np.stack(r1s)


def fleet_level(torch, r0, r1, nt):
    """(kernels, levels, batched state) of one level of the fleet (r0, r1)
    after InitialScaling, sigma 1."""
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.parallel.batch import stack_states

    lvs = []
    for a, b in zip(r0, r1):
        lv = initialize(a, b, nt, dtype=torch.float32, device=DEVICE)
        initial_scaling(lv, scaling=True)
        lvs.append(lv)
    kern = make_kernels(torch, lvs[0])
    return kern, lvs, stack_states([kern.prep(lv.as_dict(), 1.0)
                                    for lv in lvs])


def fleet_replays(torch):
    """Phase 8b: 40-iteration segments of the fleet's finest level replayed
    from graphs against the same segments eager, after a per-instance
    rescale and a sigma change, instance 1 frozen (done); then instance 2
    against the single-instance device driver from the same state. Every
    one bit-equal."""
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.parallel.batch import (BatchedDeviceDriver,
                                                  replay_against_eager)

    n, nt, _, _ = FLEET
    r0, r1 = fleet_problems(n)
    kern, lvs, bstate = fleet_level(torch, r0, r1, nt)
    o = SolveOptions()
    single = DeviceDriver(kern, o)
    single.prepare(lvs[2].as_dict())
    rows = replay_against_eager(lambda: BatchedDeviceDriver(kern, o), bstate,
                                SEG_REPLAY, inactive=(1,), instance_b=2,
                                single=single)
    torch.cuda.synchronize()
    out = {}
    for i, (what, gap, first, extra) in enumerate(rows):
        frozen = extra if i < 3 else None
        log(f"  {FLEET_B} x {n}^2 x {nt}, {SEG_REPLAY} iterations {what}: "
            + ("bit-equal" if first is None else
               f"{first} differs first, largest gap {gap:.3e}")
            + ("" if frozen is None else
               f"; the done instance {'frozen' if frozen else 'CHANGED'}"))
        require(first is None, f"fleet {what}: not bit-equal (gap {gap:.3e})")
        require(frozen in (None, True), f"fleet {what}: the done instance "
                f"changed")
        out[what] = dict(bit_equal=first is None, gap=gap, frozen=frozen)
    del single, bstate
    torch.cuda.empty_cache()
    return out


def lockstep(torch, r0, r1, nt, levels, tol, method="inPALM", dtype=None):
    """One ``solve_fleet(mode="lockstep")`` (float32 unless ``dtype``) with
    its loops under ``set_sync_debug_mode("error")``
    (the one record read a check allowed): (result, wall s, launches
    counted from 0, peak GiB)."""
    from dotsocp_tpu_torch.parallel.batch import (BatchedDeviceDriver,
                                                  solve_fleet)

    reset_launch_counts()
    cold_memory(torch)
    BatchedDeviceDriver.sync_debug = "error"
    try:
        t0 = time.monotonic()
        out = solve_fleet(r0, r1, nt, {"tol": tol, "maxit": 3000},
                          method, dtype=dtype or torch.float32,
                          level_n=levels, mode="lockstep", verbose=False,
                          device=DEVICE)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        BatchedDeviceDriver.sync_debug = None
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for lv in out["levels"]:
        st = lv["driver"]
        require(st["syncs"] <= st["checks"], f"lockstep level {lv['level']}: "
                f"{st['syncs']} host syncs in the loop for {st['checks']} "
                f"checks")
    return out, wall, launch_counts(), peak


def sequential(torch, r0, r1, nt, levels, tol):
    """One ``solve_fleet(mode="sequential")`` from an empty solver cache
    (instance 0 prewarms the levels, the others replay them): (result,
    wall s, peak GiB, the cache's GiB after it)."""
    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    cold_memory(torch)
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = solve_fleet(r0, r1, nt, {"tol": tol, "maxit": 3000},
                      "inPALM", dtype=torch.float32, level_n=levels,
                      mode="sequential", verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    held = (torch.cuda.memory_allocated() - base) / 2 ** 30
    return out, wall, torch.cuda.max_memory_allocated() / 2 ** 30, held


def fleet_solves(torch):
    """Phase 8c: the fleet_bench fleet under ``mode="lockstep"`` against
    FLEET_ANCHOR and against ``mode="sequential"``; the homogeneous fleet
    (8 x DOTmark)."""
    import numpy as np

    from dotsocp_tpu_torch.multilevel.level import mass_error

    n, nt, levels, tol = FLEET
    r0, r1 = fleet_problems(n)
    # warm-up: libraries, cuBLAS on the loop's stream, allocator pools
    lockstep(torch, r0[:2, ::8, ::8], r1[:2, ::8, ::8], 9, 1, 1e-3)
    out, wall, launches, peak = lockstep(torch, r0, r1, nt, levels, tol)
    done_it = [int(v) for v in out["done_it"]]
    stops = out["kkt"][:, [0, 2, 5, 6]].max(axis=1)
    masses = [mass_error(out["rho"][b]) for b in range(FLEET_B)]
    log(f"  lockstep: iterations per level "
        f"{[lv['iters'] for lv in out['levels']]}, total {out['iters']} "
        f"(anchor {FLEET_ANCHOR['iters']}), done_it {done_it} (anchor "
        f"{list(FLEET_ANCHOR['done_it'])}), wall {wall:.3f} s, "
        f"{FLEET_B / wall:.3f} instances/s, peak {peak:.3f} GiB")
    log(f"  stop residuals {np.array2string(stops, precision=2)}, mass "
        f"errors {np.array2string(np.array(masses), precision=2)}")
    syncs = [(lv["driver"]["syncs"], lv["driver"]["checks"])
             for lv in out["levels"]]
    log(f"  loop host syncs / checks per level {syncs}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require(tuple(out["rho"].shape) == (FLEET_B, nt, n, n),
            f"rho shape {tuple(out['rho'].shape)}")
    require(bool(torch.isfinite(out["rho"]).all()), "non-finite density")
    require(bool(out["done"].all()), f"not every instance done: "
            f"{out['done']}")
    require(bool((stops < tol).all()), f"stop residuals {stops}")
    require(all(m <= 1e-2 for m in masses), f"mass errors {masses}")
    dev = [100.0 * (got - want) / want
           for got, want in zip(done_it, FLEET_ANCHOR["done_it"])]
    total_dev = 100.0 * (out["iters"] / FLEET_ANCHOR["iters"] - 1.0)
    log(f"  done_it against FLEET_ANCHOR, per instance: "
        f"{', '.join(f'{v:+.1f}%' for v in dev)}; total {total_dev:+.1f}%")
    require(abs(out["iters"] - FLEET_ANCHOR["iters"])
            <= 0.1 * FLEET_ANCHOR["iters"], f"iters {out['iters']} not "
            f"within 10% of {FLEET_ANCHOR['iters']}")
    for k in BATCHED:
        require(launches[k] > 0, f"{k} was launched no time in the fleet "
                f"solve")
    for k in BATCHED.values():
        require(launches[k] == 0, f"the lockstep fleet launched the "
                f"single-instance {k}")
    seq, seq_wall, seq_peak, seq_held = sequential(torch, r0, r1, nt, levels,
                                                   tol)
    rel = [float(torch.linalg.norm(out["rho"][b] - seq["rho"][b])
                 / torch.linalg.norm(seq["rho"][b])) for b in range(FLEET_B)]
    log(f"  sequential (the solver cache, instance 0 prewarmed): "
        f"final-level iterations "
        f"{[int(v) for v in seq['done_it']]}, total {seq['iters']}, wall "
        f"{seq_wall:.3f} s, {FLEET_B / seq_wall:.3f} instances/s, peak "
        f"{seq_peak:.3f} GiB, the cache {seq_held:.3f} GiB after it; rho "
        f"against lockstep, relative {', '.join(f'{v:.2e}' for v in rel)}")
    bound = [max(1e-2, 1.1 * r) for r in FLEET_REL_JAX]
    log(f"  bound per instance (1e-2, or 1.1 x the JAX package's own gap "
        f"{', '.join(f'{v:.2e}' for v in FLEET_REL_JAX)}): "
        f"{', '.join(f'{v:.2e}' for v in bound)}")
    require(all(r < b for r, b in zip(rel, bound)), f"lockstep rho differs "
            f"from sequential by {rel}, bounds {bound}")
    # the homogeneous fleet: eight copies of the headline problem
    h0 = np.repeat(r0[5:6], FLEET_B, axis=0)
    h1 = np.repeat(r1[5:6], FLEET_B, axis=0)
    hom, hom_wall, hom_launches, _ = lockstep(torch, h0, h1, nt, levels, tol)
    add_counts(launches, hom_launches)
    bit_equal = all(bool(torch.equal(hom["rho"][b], hom["rho"][0]))
                    for b in range(FLEET_B))
    spread = max(float((hom["rho"][b] - hom["rho"][0]).abs().max())
                 for b in range(FLEET_B))
    log(f"  homogeneous fleet ({FLEET_B} x DOTmark): done_it "
        f"{[int(v) for v in hom['done_it']]}, total {hom['iters']}, wall "
        f"{hom_wall:.3f} s; the eight rho bit-equal: {bit_equal} (largest "
        f"gap {spread:.3e})")
    require(len(set(int(v) for v in hom["done_it"])) == 1 and
            bool(hom["done"].all()), f"homogeneous fleet: done_it "
            f"{hom['done_it']}")
    # the kernels are bit-equal per instance; cuBLAS's products over the
    # stack may round an instance's rows by their place in it, so the
    # eight are held to the solve's own tolerance, 1e-4 of the largest
    # entry, and their bit-equality printed
    require(spread <= tol * float(hom["rho"][0].abs().max()),
            f"homogeneous fleet: instances differ by {spread:.3e}")
    # the same fleet in float64 (the plain route by dtype: no kernel)
    f64, f64_wall, f64_launches, _ = lockstep(torch, r0, r1, nt, levels, tol,
                                              dtype=torch.float64)
    f64_done_it = [int(v) for v in f64["done_it"]]
    log(f"  float64 lockstep: done_it {f64_done_it}, total {f64['iters']} "
        f"(FLEET_ANCHOR_F64 {FLEET_ANCHOR_F64}), wall {f64_wall:.3f} s, "
        f"launches {sum(f64_launches.values())}")
    require(bool(f64["done"].all()), f"float64 fleet: not every instance "
            f"done: {f64['done']}")
    require(f64_done_it == list(FLEET_ANCHOR_F64["done_it"])
            and f64["iters"] == FLEET_ANCHOR_F64["iters"],
            f"float64 fleet: done_it {f64_done_it}, iters {f64['iters']}, "
            f"not FLEET_ANCHOR_F64's {FLEET_ANCHOR_F64}")
    require(sum(f64_launches.values()) == 0, f"the float64 fleet launched "
            f"{f64_launches}")
    del f64
    res = dict(done_it=done_it, iters=out["iters"], done_it_dev_pct=dev,
               f64_done_it=f64_done_it, f64_wall_s=f64_wall,
               level_iters=[lv["iters"] for lv in out["levels"]],
               wall_s=wall, instances_per_s=FLEET_B / wall, peak_gib=peak,
               syncs_checks=syncs, seq_wall_s=seq_wall,
               seq_instances_per_s=FLEET_B / seq_wall, seq_peak_gib=seq_peak,
               seq_cache_gib=seq_held,
               seq_done_it=[int(v) for v in seq["done_it"]],
               seq_iters=seq["iters"], rho_rel_vs_seq=rel,
               rho_rel_bound=bound,
               homogeneous=dict(done_it=[int(v) for v in hom["done_it"]],
                                wall_s=hom_wall, bit_equal=bit_equal,
                                gap=spread))
    del out, seq, hom
    torch.cuda.empty_cache()
    return launches, res


def iteration_times(torch, r0, r1, nt):
    """One batched CA iteration of the fleet's finest level (replayed from
    its graph) against B single-instance CA iterations (each replayed from
    its driver's graph), ms from CUDA events."""
    from dotsocp_tpu_torch.algorithms.device_driver import DeviceDriver
    from dotsocp_tpu_torch.algorithms.driver import SolveOptions
    from dotsocp_tpu_torch.parallel.batch import BatchedDeviceDriver

    kern, lvs, bstate = fleet_level(torch, r0, r1, nt)
    o = SolveOptions()
    d = BatchedDeviceDriver(kern, o)
    d.prepare(bstate)
    singles = []
    for lv in lvs:
        s = DeviceDriver(kern, o)
        s.prepare(lv.as_dict())
        singles.append(s)

    def batched():
        d.graphs.run("ca_iteration", lambda: d._ca_iteration(False))

    def each():
        for s in singles:
            s.graphs.run("ca_iteration", lambda s=s: s._ca_iteration(False))

    with d._on_stream():
        d._ca_prologue()
        for s in singles:
            s._ca_prologue()
        batched()  # the eager first use; event_ms's warm-up captures
        each()
        b_ms = event_ms(torch, batched, 20)
        s_ms = event_ms(torch, each, 20)
    del d, singles, bstate
    torch.cuda.empty_cache()
    return b_ms, s_ms


def crossover(torch, fleet):
    """Phase 8d: instances/s of lockstep and sequential at B = 8 for
    demo_batch's fleet at ``CROSSOVER`` and the fleet_bench fleet at
    129^2 x 33 (phase 8c's walls), one batched CA iteration against B
    single ones, peak memory of each mode; the crossover in cells where
    lockstep stops winning, on demo_batch's fleet."""
    import math

    from dotsocp_tpu_torch.parallel.batch import SATURATION_CELLS

    rows = []
    for i, (n, nt, levels) in enumerate(CROSSOVER):
        r0, r1 = demo_fleet(n)
        if i == 0:  # warm-up: the loop's first use of the batched path
            lockstep(torch, r0, r1, nt, levels, 1e-4)
        lk, lk_wall, lk_launches, lk_peak = lockstep(torch, r0, r1, nt,
                                                     levels, 1e-4)
        sq, sq_wall, sq_peak, sq_held = sequential(torch, r0, r1, nt,
                                                   levels, 1e-4)
        b_ms, s_ms = iteration_times(torch, r0, r1, nt)
        require(bool(lk["done"].all()) and bool(sq["done"].all()),
                f"crossover {n}^2 x {nt}: not every instance done")
        rows.append(dict(n=n, nt=nt, levels=levels,
                         cells=(nt - 1) * n * n, lockstep_s=lk_wall,
                         sequential_s=sq_wall, lockstep_iters=lk["iters"],
                         sequential_iters=sq["iters"],
                         lockstep_peak_gib=lk_peak,
                         sequential_peak_gib=sq_peak,
                         sequential_cache_gib=sq_held,
                         batched_iter_ms=b_ms, singles_iter_ms=s_ms,
                         launches=lk_launches))
        torch.cuda.empty_cache()
    n, nt, levels, _ = FLEET
    r0, r1 = fleet_problems(n)
    b_ms, s_ms = iteration_times(torch, r0, r1, nt)
    bench = dict(n=n, nt=nt, levels=levels, cells=(nt - 1) * n * n,
                 fleet="fleet_bench", lockstep_s=fleet["wall_s"],
                 sequential_s=fleet["seq_wall_s"],
                 lockstep_iters=fleet["iters"],
                 sequential_iters=fleet["seq_iters"],
                 lockstep_peak_gib=fleet["peak_gib"],
                 sequential_peak_gib=fleet["seq_peak_gib"],
                 batched_iter_ms=b_ms, singles_iter_ms=s_ms)
    for r in rows + [bench]:
        r.setdefault("fleet", "demo_batch")
        r["lockstep_inst_s"] = FLEET_B / r["lockstep_s"]
        r["sequential_inst_s"] = FLEET_B / r["sequential_s"]
        log(f"  {r['fleet']} {r['n']}^2 x {r['nt']} ({r['levels']} levels, "
            f"{r['cells']} cells): lockstep {r['lockstep_inst_s']:.3f} "
            f"instances/s ({r['lockstep_iters']} its, peak "
            f"{r['lockstep_peak_gib']:.3f} GiB), sequential "
            f"{r['sequential_inst_s']:.3f} ({r['sequential_iters']} its, peak "
            f"{r['sequential_peak_gib']:.3f} GiB); one CA iteration batched "
            f"{r['batched_iter_ms']:.3f} ms against {FLEET_B} single "
            f"{r['singles_iter_ms']:.3f} ms")
    # the crossover: where the lockstep / sequential rate ratio crosses 1,
    # log-linear in cells between the two measured sizes around it (or
    # through the two largest, extrapolated, where lockstep wins at all)
    ratio = [(r["cells"], r["lockstep_inst_s"] / r["sequential_inst_s"])
             for r in rows]
    pair = next(((a, b) for a, b in zip(ratio, ratio[1:])
                 if a[1] >= 1.0 > b[1]), None)
    extrapolated = pair is None
    (c0, q0), (c1, q1) = pair or ratio[-2:]
    t = math.log(q0) / (math.log(q0) - math.log(q1))
    cross = math.exp(math.log(c0) + t * (math.log(c1) - math.log(c0)))
    how = "extrapolated from" if extrapolated else "between"
    log(f"  lockstep / sequential instances/s by cells {ratio}; crossover "
        f"{cross:.0f} cells ({how} {c0} and {c1}); the port's "
        f"SATURATION_CELLS {SATURATION_CELLS}")
    return dict(rows=rows + [bench], crossover_cells=cross,
                extrapolated=extrapolated)


# -- phase 9: user problems on the card ------------------------------------------

# 9a, the scale config (``bench.py:180-185``): DOTmark-4stitch 513^2 x 65, 3
# levels (129^2 x 17 -> 257^2 x 33 -> 513^2 x 65), inPALM, tol 1e-4,
# float32, through demo_dot2d; the JAX package took 407 iterations on its
# TPU (BENCH_r05.json scale_513_iters), an iteration count and no time
SCALE_CONFIG = (513, 65, 3, 1e-4)   # (n, nt, levels, tol)
SCALE_ANCHOR = 407
# 9b, the maze at demo_wdot2d's defaults (129^2 x 129, 3 levels, tol 1e-3,
# inPALM, maxit 10000): the JAX package on the CPU in float32, its default
# driver (``python tests/test_torch_images.py --anchors``); level 2 stops at
# maxit with stop residual 5.16e-4, short of its pyramid tolerance 5e-4
MAZE_ARGV = ["--problem", "maze14", "--barrier", "maze14"]
MAZE_ANCHOR = (6209, 10000, 1529)
# the same in float64 (x64 on), which the card's float64 plain route takes
# exactly: the 1e6 walls make the float32 counts follow the rounding
MAZE_F64_ANCHOR = (609, 289, 79)
# 9c, example5 at demo_dot2d's defaults (129^2 x 33, 3 levels, tol 1e-4):
# the JAX package on the CPU in float32, as MAZE_ANCHOR
EXAMPLE5_ARGV = ["--problem", "example5"]
EXAMPLE5_ANCHOR = (464, 339, 264)
# 9d, every demo at its defaults: (module, argv, tolerance, weighted);
# demo_dot1d's default is float64 (the plain route: no launch)
DEMOS = (("demo_dot1d", [], 1e-5, False),
         ("demo_dot2d", [], 1e-4, False),
         ("demo_dot3d", [], 1e-4, False),
         ("demo_wdot2d", [], 1e-3, True),
         ("demo_batch", [], 1e-4, False))
# the kernels phase 9's solves run: the x-carry path, its weighted q-step
# (the maze, love-heart) and its batched forms (demo_batch's lockstep fleet)
PHASE9_KERNELS = ("x_step", "qx_step", "qx_step_w", "cx_step", "cx_final",
                  "x_step_b", "qx_step_b", "cx_step_b", "cx_final_b")


def device_busy(torch, run, wall):
    """The card's kernel time over a second, profiled ``run()`` (which ends
    in a synchronize), against the unprofiled ``wall``: (kernel ms, busy
    %). Sums the raw device events: a whole solve records hundreds of
    thousands of kernels, which key_averages() takes minutes over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    busy_ns = sum(e.duration_ns()
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation())
    return busy_ns / 1e6, 100 * busy_ns / 1e9 / wall


def run_demo(torch, name, argv):
    """``dotsocp_tpu_torch.demos.<name>.main(argv)`` on the card with every
    launch count set to 0 just before: (result, wall s, launches, what it
    printed). Its report lines are logged."""
    import contextlib
    import importlib
    import io

    demo = importlib.import_module(f"dotsocp_tpu_torch.demos.{name}")
    argv = list(argv) + (["--cpu"] if DEVICE == "cpu" else [])
    buf = io.StringIO()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        result = demo.main(argv)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    printed = buf.getvalue()
    for line in printed.splitlines():
        if line.startswith(("Completed level", "Mass conservation", "mode:",
                            "W2^2", "converged:", "fleet time")):
            log(f"  | {line}")
    return result, wall, launches, printed


def demo_final_kkt(printed, weighted):
    """The largest stop residual of a demo's printed final KKT row (the
    fleet prints its largest over the instances)."""
    import numpy as np

    rest = printed.split("Final KKT:")[-1].lstrip()
    if not rest.startswith("["):
        return float(rest.split()[0])
    vals = np.array(rest[1:rest.index("]")].split(), float)
    return float(vals[[0, 2, 5] if weighted else [0, 2, 5, 6]].max())


def require_demo(what, printed, tol, weighted):
    require("Mass conservation: OK" in printed, f"{what}: mass conservation "
            f"not OK")
    stop = demo_final_kkt(printed, weighted)
    require(stop < tol, f"{what}: final KKT {stop:.3e} not below {tol:g}")
    return stop


def require_levels(what, out, tol, anchor, maxit, weighted):
    """Every level below ``tol``; below its own pyramid tolerance unless it
    stopped at ``maxit`` on a level where the JAX run did too; the total
    within +-10% of the anchor's."""
    iters = [lv["iters"] for lv in out["levels"]]
    for lv, lev_tol, want in zip(out["levels"],
                                 level_tols(tol, len(iters)), anchor):
        stop = stop_residual(lv, weighted)
        require(stop < tol, f"{what} level {lv['level']} stopped at KKT "
                f"{stop:.3e} (requested tolerance {tol:g})")
        require(stop < lev_tol or (lv["iters"] == maxit == want),
                f"{what} level {lv['level']} stopped at KKT {stop:.3e} after "
                f"{lv['iters']} iterations (level tolerance {lev_tol:g}; the "
                f"JAX run took {want})")
    total, ref = sum(iters), sum(anchor)
    log(f"  {what}: iterations {iters}, total {total} (anchor {list(anchor)}"
        f" = {ref}, {100.0 * (total - ref) / ref:+.1f}%)")
    require(abs(total - ref) <= 0.1 * ref, f"{what}: total iterations "
            f"{total} not within 10% of {ref}")
    return iters


def scale_config(torch):
    """9a: the scale config through demo_dot2d (its checks, per-level
    counts against the JAX anchor, peak memory, launches, the demo's wall
    with its report), then ``solve_dot`` on the same densities alone: its
    wall around a synchronize and the busy share of a second, profiled
    run."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    n, nt, levels, tol = SCALE_CONFIG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (out, _, _), demo_wall, launches, printed = run_demo(
        torch, "demo_dot2d", ["--nx", str(n), "--nt", str(nt), "--levels",
                              str(levels), "--tol", str(tol)])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rho = out["rho"]
    require(tuple(rho.shape) == (nt, n, n), f"rho shape {rho.shape}")
    require(bool(torch.isfinite(rho).all()), "non-finite density")
    require(out["mass_ok"], "scale config: mass conservation violated")
    require_demo("scale config", printed, tol, False)
    iters = [lv["iters"] for lv in out["levels"]]
    for lv in out["levels"]:
        stop = stop_residual(lv)
        require(stop < tol, f"scale config level {lv['level']} stopped at "
                f"KKT {stop:.3e}")
    total = sum(iters)
    for name in ("x_step", "qx_step", "cx_step", "cx_final"):
        require(launches[name] > 0, f"scale config: {name} never launched")
    require(launches["qx_step"] == total, f"scale config: qx_step launched "
            f"{launches['qx_step']} times for {total} iterations")
    del out, rho
    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)

    def solve():
        res = solve_dot(r0, r1, nt, levels, {"tol": tol, "maxit": 3000},
                        "inPALM", device=DEVICE, dtype=torch.float32,
                        verbose=False)
        torch.cuda.synchronize()
        return res

    torch.cuda.synchronize()
    t0 = time.monotonic()
    again, _, _ = solve()
    wall = time.monotonic() - t0
    require([lv["iters"] for lv in again["levels"]] == iters,
            f"scale config: solve_dot took {[lv['iters'] for lv in again['levels']]}"
            f" after the demo's {iters}")
    level_s = [round(lv["time"], 4) for lv in again["levels"]]
    del again
    kernel_ms, busy = device_busy(torch, solve, wall)
    log(f"  scale config {n}^2 x {nt}: iterations {iters}, total {total} "
        f"(anchor {SCALE_ANCHOR}, "
        f"{100.0 * (total - SCALE_ANCHOR) / SCALE_ANCHOR:+.1f}%); solve_dot "
        f"wall {wall:.3f} s (levels {level_s} s), device busy {busy:.0f}% "
        f"({kernel_ms:.1f} ms of kernels, profiled run); the demo with its "
        f"report {demo_wall:.3f} s; peak {peak:.3f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require(abs(total - SCALE_ANCHOR) <= 0.1 * SCALE_ANCHOR,
            f"scale config: total iterations {total} not within 10% of "
            f"{SCALE_ANCHOR}")
    return launches, dict(iters=iters, total=total, wall_s=wall,
                          level_s=level_s, demo_wall_s=demo_wall,
                          busy_pct=busy, kernel_ms=kernel_ms, peak_gib=peak,
                          mass_ok=True)


def maze_solve(torch):
    """9b: demo_wdot2d on the maze: the count against MAZE_ANCHOR, no
    density inside the eroded barrier, one weighted q-step a
    iteration."""
    from scipy.ndimage import binary_erosion

    from dotsocp_tpu_torch.models import wdot2d as W

    (out, _, _), wall, launches, printed = run_demo(torch, "demo_wdot2d",
                                                    MAZE_ARGV)
    require(out["mass_ok"], "maze: mass conservation violated")
    require_demo("maze", printed, 1e-3, True)
    iters = require_levels("maze 129^2 x 129", out, 1e-3, MAZE_ANCHOR,
                           WDOT_MAXIT, True)
    rho = out["rho"]
    n = rho.shape[-1]
    _, _, mask = W.ensure_barrier_validity(
        *W.get_example_w2d("maze14", n, n), W.barrier_maze14())
    interior = binary_erosion(mask, iterations=2)
    require(interior.any(), f"maze: no barrier node is two nodes inside the "
            f"walls at {n}^2")
    leak = float(rho[:, torch.as_tensor(interior, device=rho.device)]
                 .abs().amax(dim=1).max()) if interior.any() else 0.0
    log(f"  maze: wall {wall:.3f} s, max |rho| inside the eroded barrier "
        f"({int(interior.sum())} nodes) {leak:.3e}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require(leak < 0.1, f"maze: density {leak:.3e} inside the barrier")
    require(launches["qx_step_w"] == sum(iters), f"maze: qx_step_w launched "
            f"{launches['qx_step_w']} times for {sum(iters)} iterations")
    require(launches["qx_step"] == 0, "maze: the unweighted q-step launched")
    (out64, _, _), wall64, launches64, printed = run_demo(
        torch, "demo_wdot2d", MAZE_ARGV + ["--f64"])
    iters64 = [lv["iters"] for lv in out64["levels"]]
    log(f"  maze in float64 (the plain route): iterations {iters64} in "
        f"{wall64:.3f} s (anchor {list(MAZE_F64_ANCHOR)}), launches "
        f"{ {k: v for k, v in launches64.items() if v} }")
    require(out64["mass_ok"], "maze float64: mass conservation violated")
    require_demo("maze float64", printed, 1e-3, True)
    require(tuple(iters64) == MAZE_F64_ANCHOR, f"maze float64: iterations "
            f"{iters64}, not {list(MAZE_F64_ANCHOR)}")
    require(not any(launches64.values()), f"maze float64 launched "
            f"{launches64}")
    return launches, dict(iters=iters, total=sum(iters), wall_s=wall,
                          barrier_max_rho=leak, mass_ok=bool(out["mass_ok"]),
                          f64_iters=iters64, f64_wall_s=wall64)


def example5_solve(torch):
    """9c: demo_dot2d on example5 against EXAMPLE5_ANCHOR."""
    (out, _, _), wall, launches, printed = run_demo(torch, "demo_dot2d",
                                                    EXAMPLE5_ARGV)
    require(out["mass_ok"], "example5: mass conservation violated")
    require_demo("example5", printed, 1e-4, False)
    iters = require_levels("example5 129^2 x 33", out, 1e-4, EXAMPLE5_ANCHOR,
                           3000, False)
    log(f"  example5: wall {wall:.3f} s")
    return launches, dict(iters=iters, total=sum(iters), wall_s=wall,
                          mass_ok=bool(out["mass_ok"]))


def demo_defaults(torch):
    """9d: every demo at its defaults: mass conservation and a final KKT
    below its tolerance, as each prints them."""
    launches, results = {}, {}
    for name, argv, tol, weighted in DEMOS:
        result, wall, counts, printed = run_demo(torch, name, argv)
        stop = require_demo(name, printed, tol, weighted)
        out = result if name == "demo_batch" else result[0]
        iters = (out["iters"] if name == "demo_batch"
                 else [lv["iters"] for lv in out["levels"]])
        log(f"  {name} {' '.join(argv) or '(defaults)'}: {wall:.3f} s, "
            f"iterations {iters}, final stop residual {stop:.3e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if name == "demo_batch":
            require(out["mode"] == "lockstep", f"demo_batch ran "
                    f"{out['mode']}, not lockstep")
        results[name] = dict(wall_s=wall, iters=iters, stop=stop)
        add_counts(launches, counts)
        torch.cuda.empty_cache()
    return launches, results


def user_problems(torch):
    """Phase 9: the scale config, the maze, example5 and every demo, each
    counted from 0; returns the launches summed over its runs and the
    results. Fails if a kernel of this path was launched no time."""
    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    # warm-up: library load, cuBLAS handles, allocator pools
    w0, w1 = get_example_2d("example2", 17, 17)
    solve_dot(w0, w1, 9, 2, {"tol": 1e-3}, device=DEVICE, verbose=False)
    launches, results = {}, {}
    for key, run in (("scale_513x65", scale_config), ("maze", maze_solve),
                     ("example5", example5_solve),
                     ("demos", demo_defaults)):
        counts, results[key] = run(torch)
        add_counts(launches, counts)
        torch.cuda.empty_cache()
    log(f"  phase 9 launches "
        f"{ {k: launches.get(k, 0) for k in PHASE9_KERNELS} }")
    for k in PHASE9_KERNELS:
        require(launches.get(k, 0) > 0, f"{k} was launched no time in "
                f"phase 9")
    return launches, results



# -- phase 10: multi-device, ranks sharing the one card over gloo ---------------

DIST_LABEL = "N ranks sharing one card over gloo, not a scaling figure"
# a world's deadline: a rank that hangs in a collective ends the world
DIST_TIMEOUT = 600.0
# 10a: the headline (the total's band: the anchor 522 +-10%, the halo
# path's plain ops round otherwise than the kernels) on a (y=2, x=2) mesh;
# 10b: the scale config on a (y=2,) mesh
DIST_HEADLINE = ("DOTmark_4stitch", 129, 33, 3, 1e-4, ("y", "x"))
DIST_HEADLINE_BAND = (470, 574)
DIST_SCALE = ("DOTmark_4stitch",) + SCALE_CONFIG + (("y",),)
# 10e: acc-ADMM on the headline's finest grid, one level, 100 iterations
DIST_ACC = ("DOTmark_4stitch", 129, 33, 100)
# the one-process lockstep fleet against sequential solves differs by up to
# 1.4e-2 on rho (FLEET_REL_JAX, phase 8c): the sharded fleet is held to it
FLEET_GAP = 1.4e-2
# 10g: make_sharded_step over a ("batch",) mesh of the 2-rank world:
# (instances, steps) at FLEET's grid
DIST_SHARDED = (4, 3)
# 10f: the batch x spatial fleet on a (batch=2, y=2) mesh of the 4-rank
# world. At full width, two instances of fleet_problems at the scale
# config (513^2 x 65, 3 levels, tol 1e-4, float32): DOTmark 4-stitch and
# example1, held to the one-card lockstep fleet of the same two: the
# shared iterations +-10%, each rho within FLEET_GAP. (example2 does not
# converge there in float32: the one-card lockstep fleet of DOTmark and
# example2 takes 1529 + 1729 + 3000 iterations, example2 stopped at maxit
# short of tol; example1 takes 264 + 99 + 99 beside DOTmark; measured on
# an NVIDIA H100 80GB HBM3 at 700 W.) Exactly: four instances of
# fleet_problems at 33^2 x 9, 2 levels, float64, against the one-card
# lockstep run in float64: iterations, done_it and chunk cuts, rho 1e-9
BXS_AXES = ("batch", "y")
BXS_WIDE = (SCALE_CONFIG[0], SCALE_CONFIG[1], SCALE_CONFIG[2],
            SCALE_CONFIG[3], (5, 0))
BXS_EXACT = (33, 9, 2, 1e-4, (0, 1, 2, 3))


def _rank_solve(problem, n, nt, levels, tol, axis_names):
    """This rank's meshed solve_dot in float32 on the card (a warm-up solve
    on the same mesh first): its ``DIST_RESULT`` record, printed, and its
    own wall, peak memory, comm traffic and launches."""
    import numpy as np
    import torch

    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot
    from dotsocp_tpu_torch.parallel.distributed import print_record
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=axis_names)
    w0, w1 = get_example_2d("example2", 17, 17)
    solve_dot(w0, w1, 9, 1, {"tol": 1e-3, "mesh": mesh}, device=DEVICE,
              verbose=False)
    r0, r1 = get_example_2d(problem, n, n)
    reset_launch_counts()
    mesh.stats.update(calls=0, bytes=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, nt, levels, {"tol": tol, "mesh": mesh},
                          "inPALM", device=DEVICE, dtype=torch.float32,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rho = out["rho"]
    iters = [lv["iters"] for lv in out["levels"]]
    rec = {"mesh": dict(mesh.shape), "iters": iters,
           "stops": [stop_residual(lv) for lv in out["levels"]],
           "mass_ok": bool(out["mass_ok"]), "shape": list(rho.shape),
           "finite": bool(torch.isfinite(rho).all()),
           "rho_sum": float(rho.double().sum())}
    print_record(dict(rec, rank=mesh.rank))
    return rec, dict(wall_s=wall,
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                     comm_calls=mesh.stats["calls"],
                     comm_bytes=mesh.stats["bytes"],
                     comm_bytes_per_iter=mesh.stats["bytes"] / sum(iters),
                     launches={k: v for k, v in launch_counts().items()
                               if v},
                     level_s=[round(lv["time"], 4) for lv in out["levels"]],
                     rank=mesh.rank)


def _rank_comm_check():
    """10d: the comm layer on CUDA tensors over a (y, x) mesh against the
    answers one process computes from the whole field."""
    import torch

    from dotsocp_tpu_torch.parallel import comm
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=("y", "x"))
    ky, kx = mesh.shape["y"], mesh.shape["x"]
    cy, cx = mesh.coords["y"], mesh.coords["x"]
    ny, nx = 6 * ky, 8 * kx
    full = torch.randn(5, ny, nx, dtype=torch.float32, device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(10))
    rows, cols = slice(cy * 6, cy * 6 + 6), slice(cx * 8, cx * 8 + 8)
    block = full[:, rows, cols].contiguous()
    pad = torch.nn.functional.pad
    errs = {
        "shift_y": comm.shift(block, 1, mesh, "y", True)
        - pad(full[:, :-1], (0, 0, 1, 0))[:, rows, cols],
        "shift_x": comm.shift(block, 2, mesh, "x", False)
        - pad(full[:, :, 1:], (0, 1))[:, rows, cols],
        "all_gather": comm.all_gather(block, 1, mesh, "y") - full[:, :, cols],
        "gather_blocks": comm.gather_blocks(block, mesh, {"y": 1, "x": 2})
        - full,
    }
    out = {k: float(v.abs().max()) for k, v in errs.items()}
    # psum: every rank's block summed in rank order against the same sum
    # over the gathered blocks, and equal bits on every rank
    total = comm.psum(block.double().sum(), mesh)
    parts = [full[:, r * 6:r * 6 + 6, c * 8:c * 8 + 8].double().sum()
             for r in range(ky) for c in range(kx)]
    ref = parts[0]
    for p in parts[1:]:
        ref = ref + p
    out["psum"] = float((total - ref).abs())
    out["psum_bits"] = float(total)
    out["devices"] = [str(block.device), str(total.device)]
    return out


def _rank_acc(problem, n, nt, maxit):
    """10e: acc-ADMM on a (y, x) mesh of the world, one level at n^2 x nt,
    ``maxit`` iterations in float32, the cone projection kernel on the
    rank's block (the steps that read neighbouring cells run plain); then
    the kernel against its plain versions on a seeded block of the same
    shape, its pads zero as the halo layout holds them."""
    import torch

    from dotsocp_tpu_torch.models.examples import get_example_2d
    from dotsocp_tpu_torch.multilevel.solve import solve_dot
    from dotsocp_tpu_torch.ops import fused_step as fs
    from dotsocp_tpu_torch.ops.cone import proj_soc
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.halo_engine import OpsHalo
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=("y", "x"))
    r0, r1 = get_example_2d(problem, n, n)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, nt, 1,
                          {"tol": 1e-4, "maxit": maxit, "mesh": mesh},
                          "acc-ADMM", device=DEVICE, dtype=torch.float32,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    rho = out["rho"]
    rec = {"mesh": dict(mesh.shape), "iters": out["levels"][0]["iters"],
           "stop": stop_residual(out["levels"][0]),
           "finite": bool(torch.isfinite(rho).all()),
           "rho_sum": float(rho.double().sum())}
    # the kernel on a block of the path's shape, against the plain
    # version it is bit-equal to and the solver's plain projection
    oh = OpsHalo(Geometry(nt, (n, n)), torch.float32, DEVICE, mesh)
    gen = torch.Generator(DEVICE).manual_seed(12)
    C = oh.geom.cone_cols
    z2, beta = (oh.z_to_internal(torch.randn(
        C, nt - 1, n, n, generator=gen, device=DEVICE)) for _ in range(2))
    real = oh.z_to_internal(torch.ones(C, nt - 1, n, n, device=DEVICE))
    got = fs.cone_project_diff(z2, beta)
    ref = proj_soc(z2 - beta)
    tol = 2e-6 + 2e-5 * ref.abs()
    return rec, dict(
        wall_s=wall, launches=launches, rank=mesh.rank,
        block=list(z2.shape),
        exact=bool(torch.equal(got, fs.cone_project_diff_plain(z2, beta))),
        max_abs_err=float((got - ref).abs().max()),
        within=bool(((got - ref).abs() <= tol).all()),
        pads_max=float((got * (1.0 - real)).abs().max()))


def _rank_fleet_bxs(r0, r1, nt, levels, tol, dtype_name):
    """10f: this rank's part of ``solve_fleet(mode="sharded")`` on a
    (batch, y) mesh of the world, each batch row holding its instances'
    blocks on the halo engine: the record every rank must share, rho, and
    this rank's wall, peak memory, comm traffic and launches."""
    import torch

    from dotsocp_tpu_torch.parallel.batch import solve_fleet
    from dotsocp_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(axis_names=BXS_AXES)
    reset_launch_counts()
    mesh.stats.update(calls=0, bytes=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = solve_fleet(r0, r1, nt, {"tol": tol, "maxit": 3000}, "inPALM",
                      dtype=getattr(torch, dtype_name), level_n=levels,
                      mode="sharded", mesh=mesh, verbose=False,
                      device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rec = dict(mesh=dict(mesh.shape), mode=out["mode"], iters=out["iters"],
               done=[bool(v) for v in out["done"]],
               done_it=[int(v) for v in out["done_it"]],
               kkt=out["kkt"].tolist(),
               chunk_cuts=[lv["driver"]["chunk_cuts"]
                           for lv in out["levels"]],
               checks=[lv["driver"]["checks"] for lv in out["levels"]],
               graph_kinds=[lv["driver"]["graph_kinds"]
                            for lv in out["levels"]],
               level_iters=[lv["iters"] for lv in out["levels"]])
    return rec, out["rho"].cpu().numpy(), dict(
        rank=mesh.rank, coords=mesh.coords, wall_s=wall,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        comm_calls=mesh.stats["calls"], comm_bytes=mesh.stats["bytes"],
        comm_calls_per_iter=mesh.stats["calls"] / out["iters"],
        comm_bytes_per_iter=mesh.stats["bytes"] / out["iters"],
        level_s=[round(lv["time"], 4) for lv in out["levels"]],
        launches={k: v for k, v in launch_counts().items() if v})


def _world_a(headline, acc, bxs):
    """The 4-rank world: 10d, then 10a, 10e and 10f (full width in float32,
    then the exactness run in float64)."""
    return (_rank_comm_check(), _rank_solve(*headline), _rank_acc(*acc),
            [_rank_fleet_bxs(*args) for args in bxs])


def _bxs_fleets():
    """10f's two fleets as (r0, r1, nt, levels, tol, dtype name)."""
    out = []
    for (n, nt, levels, tol, pick), dtype in ((BXS_WIDE, "float32"),
                                              (BXS_EXACT, "float64")):
        r0, r1 = fleet_problems(n)
        out.append((r0[list(pick)], r1[list(pick)], nt, levels, tol, dtype))
    return out


def _bxs_check(torch, ranks, fleets, locks):
    """10f's checks on the 4-rank world's results against the one-card
    lockstep runs ``locks`` (result, wall s) of the same fleets."""
    import numpy as np

    from dotsocp_tpu_torch.multilevel.level import check_mass_conservation

    res = {}
    for i, ((r0, _, nt, levels, tol, dtype), (lock, lock_wall)) in \
            enumerate(zip(fleets, locks)):
        recs = [r[3][i][0] for r in ranks]
        rhos = [r[3][i][1] for r in ranks]
        own = [r[3][i][2] for r in ranks]
        require(all(rec == recs[0] for rec in recs), f"10f {dtype}: the "
                f"ranks' records differ: {recs}")
        require(all(np.array_equal(x, rhos[0]) for x in rhos),
                f"10f {dtype}: the ranks' rho differ")
        rec, rho = recs[0], rhos[0]
        B, n = r0.shape[0], r0.shape[1]
        lock_rho = lock["rho"].cpu().numpy()
        lock_cuts = [lv["driver"]["chunk_cuts"] for lv in lock["levels"]]
        mass = [bool(check_mass_conservation(torch.as_tensor(x)))
                for x in rho]
        stops = [max(k[j] for j in (0, 2, 5, 6)) for k in rec["kkt"]]
        rel = [float(np.linalg.norm(rho[b] - lock_rho[b])
                     / np.linalg.norm(lock_rho[b])) for b in range(B)]
        gap = float(np.abs(rho - lock_rho).max())
        log(f"  10f fleet {B} x {n}^2 x {nt} {dtype} on a {rec['mesh']} "
            f"mesh ({DIST_LABEL}): done_it {rec['done_it']}, shared "
            f"{rec['iters']} (levels {rec['level_iters']}; one card "
            f"{lock['iters']}, done_it {[int(v) for v in lock['done_it']]}, "
            f"wall {lock_wall:.3f} s), chunk cuts {rec['chunk_cuts']} (one "
            f"card {lock_cuts}), stop residuals "
            f"{[f'{v:.2e}' for v in stops]}, mass_ok {mass}, rho against "
            f"the one-card run: relative {[f'{v:.2e}' for v in rel]}, "
            f"largest {gap:.2e}")
        for o in own:
            log(f"    rank {o['rank']} {o['coords']}: wall "
                f"{o['wall_s']:.3f} s (levels {o['level_s']} s), peak "
                f"{o['peak_gib']:.3f} GiB, comm {o['comm_calls']} calls "
                f"{o['comm_bytes'] / 1e9:.3f} GB sent "
                f"({o['comm_calls_per_iter']:.2f} calls, "
                f"{o['comm_bytes_per_iter'] / 1e6:.3f} MB an iteration), "
                f"launches {o['launches']}")
        require(rec["mode"] == "sharded" and all(rec["done"]) and all(mass)
                and all(v < tol for v in stops), f"10f {dtype}: done "
                f"{rec['done']}, mass_ok {mass}, stops {stops}")
        require(tuple(rho.shape) == (B, nt, n, n)
                and bool(np.isfinite(rho).all()), f"10f {dtype}: rho "
                f"{rho.shape}")
        # no piece was captured (they hold collectives), and no kernel that
        # reads neighbouring cells ran on the blocks
        require(all(kinds == [] for kinds in rec["graph_kinds"]),
                f"10f {dtype}: graphs captured {rec['graph_kinds']}")
        require(all(not o["launches"] for o in own), f"10f {dtype}: "
                f"launches {[o['launches'] for o in own]}")
        if dtype == "float32":
            require(abs(rec["iters"] - lock["iters"])
                    <= 0.1 * lock["iters"], f"10f: shared iterations "
                    f"{rec['iters']} not within 10% of the one-card "
                    f"{lock['iters']}")
            require(all(v <= FLEET_GAP for v in rel), f"10f: rho gaps {rel}")
        else:
            require(rec["iters"] == lock["iters"]
                    and rec["done_it"] == [int(v) for v in lock["done_it"]]
                    and rec["chunk_cuts"] == lock_cuts, f"10f float64: "
                    f"{rec['iters']} / {rec['done_it']} / "
                    f"{rec['chunk_cuts']}, not the one-card "
                    f"{lock['iters']} / {lock['done_it']} / {lock_cuts}")
            require(gap <= 1e-9, f"10f float64: rho {gap:.2e} from the "
                    f"one-card run")
        res[f"fleet_{dtype}"] = dict(
            B=B, n=n, nt=nt, levels=levels, mesh=rec["mesh"],
            iters=rec["iters"], level_iters=rec["level_iters"],
            done_it=rec["done_it"], chunk_cuts=rec["chunk_cuts"],
            lockstep_iters=lock["iters"],
            lockstep_done_it=[int(v) for v in lock["done_it"]],
            lockstep_wall_s=lock_wall, rho_rel_vs_lockstep=rel,
            rho_max_abs_vs_lockstep=gap, stops=stops, ranks=own)
    return res


def _rank_fleet(n, nt, levels, tol, dtype_name):
    """10c: this rank's part of ``solve_fleet(mode="sharded")`` over the
    whole world, with the launches this rank made."""
    import torch

    from dotsocp_tpu_torch.parallel.batch import solve_fleet

    r0, r1 = fleet_problems(n)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = solve_fleet(r0, r1, nt, {"tol": tol, "maxit": 3000}, "inPALM",
                      dtype=getattr(torch, dtype_name), level_n=levels,
                      mode="sharded", verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return dict(mode=out["mode"], iters=out["iters"],
                done=[bool(v) for v in out["done"]],
                done_it=[int(v) for v in out["done_it"]],
                kkt=out["kkt"].tolist(), rho=out["rho"].float().cpu().numpy(),
                launches={k: v for k, v in launch_counts().items() if v},
                wall_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _sharded_state(torch, B):
    """(the flat engine's kernels, the stacked float32 state) of the finest
    level of fleet_bench's first B problems after InitialScaling, sigma 1,
    on the card."""
    from dotsocp_tpu_torch.algorithms.core import Kernels, LevelConfig
    from dotsocp_tpu_torch.multilevel.level import initial_scaling, initialize
    from dotsocp_tpu_torch.parallel.batch import stack_states

    n, nt = FLEET[:2]
    r0, r1 = fleet_problems(n)
    lvs = []
    for a, b in zip(r0[:B], r1[:B]):
        lv = initialize(a, b, nt, dtype=torch.float32, device=DEVICE)
        initial_scaling(lv, scaling=True)
        lvs.append(lv)
    kern = Kernels(LevelConfig(geom=lvs[0].geom, D=lvs[0].D, E=lvs[0].E,
                               device=DEVICE, dtype=torch.float32))
    return kern, stack_states([kern.prep(lv.as_dict(), 1.0) for lv in lvs])


def _rank_sharded(B, steps):
    """10g on one rank: ``make_sharded_step`` over the world's ("batch",)
    mesh, ``steps`` steps of B instances, against this rank's own
    ``run_one`` steps of each instance alone. Returns the largest gap a
    field relative to its largest entry, whether every field is
    bit-equal, and the launches of the sharded steps."""
    import torch

    from dotsocp_tpu_torch.algorithms.core import instance
    from dotsocp_tpu_torch.parallel.sharding import (make_mesh,
                                                     make_sharded_step)

    kern, state = _sharded_state(torch, B)
    step = make_sharded_step(kern, make_mesh(axis_names=("batch",)))
    reset_launch_counts()
    got = state
    for _ in range(steps):
        got = step(got)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    # an instance's scalars are 0-d tensors, its E-derived ones beside them
    ev = kern.e_scalars(state.D, state.E)
    pairs, gaps, equal = [], {}, True
    for b in range(B):
        want = instance(state, b).replace(ev=ev, E=ev.E)
        for _ in range(steps):
            want = kern.run_one(want)
        mine = instance(got, b)
        pairs += [(f, getattr(mine, f), getattr(want, f))
                  for f in ("phi", "z", "beta")]
        pairs += [(f"q[{i}]", a, w) for i, (a, w) in
                  enumerate(zip(mine.q.blocks(), want.q.blocks()))]
    for f, a, w in pairs:
        equal = equal and bool(torch.equal(a, w))
        gap = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        gaps[f] = max(gaps.get(f, 0.0), gap)
    return dict(gaps=gaps, bit_equal=equal, launches=launches)


def _sharded_check(ranks, world):
    """10g's checks: each rank's gathered steps within 1e-5 of its own
    ``run_one`` of each instance (relative to each field's largest
    entry), and the inPALM step's kernels (the rhs, z-, q- and
    beta-step) launched once a step for each of the rank's instances."""
    B, steps = DIST_SHARDED
    mine = B // world * steps
    for r, rec in enumerate(ranks):
        log(f"  10g sharded step, rank {r} of a ('batch',) mesh of {world} "
            f"({DIST_LABEL}), {B} x {FLEET[0]}^2 x {FLEET[1]}, {steps} "
            f"steps against run_one: bit-equal {rec['bit_equal']}, largest "
            f"gap relative to each field's largest entry "
            f"{ {k: f'{v:.2e}' for k, v in rec['gaps'].items()} }, "
            f"launches {rec['launches']}")
        require(max(rec["gaps"].values()) <= 1e-5, f"10g rank {r}: the "
                f"sharded step differs from run_one by {rec['gaps']}")
        for k in ("phi_rhs", "z_step", "q_step", "beta_step"):
            require(rec["launches"].get(k, 0) == mine, f"10g rank {r}: {k} "
                    f"launched {rec['launches'].get(k, 0)} times, not "
                    f"{mine}")
    return ranks


def _world_b(scale, sharded):
    """The 2-rank world: 10b, then 10c in float32 and in float64, then
    10g."""
    fleet = FLEET
    return (_rank_solve(*scale), _rank_fleet(*fleet, "float32"),
            _rank_fleet(*fleet, "float64"), _rank_sharded(*sharded))


def multi_device(torch):
    """Phase 10 (see the module docstring): two spawned worlds on this card.
    Returns the figures phase 10 keeps."""
    import numpy as np

    from dotsocp_tpu_torch.parallel.launch import run_world

    label = DIST_LABEL
    res = {"label": label}
    # the one-process lockstep fleet that 10c's rho is held to, before the
    # ranks take the card
    n, nt, levels, tol = FLEET
    r0, r1 = fleet_problems(n)
    lock, lock_wall, _, _ = lockstep(torch, r0, r1, nt, levels, tol)
    lock_rho = lock["rho"].float().cpu().numpy()
    del lock
    # 10f's one-card lockstep fleets, before the ranks take the card
    bxs = _bxs_fleets()
    bxs_locks = []
    for f0, f1, f_nt, f_levels, f_tol, f_dtype in bxs:
        out, wall, _, _ = lockstep(torch, f0, f1, f_nt, f_levels, f_tol,
                                   dtype=getattr(torch, f_dtype))
        bxs_locks.append((dict(out, rho=out["rho"].cpu()), wall))
        del out
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    ranks = run_world(_world_a, 4, (DIST_HEADLINE, DIST_ACC, bxs),
                      backend="gloo", device=DEVICE, timeout=DIST_TIMEOUT)
    world_a_s = time.monotonic() - t0
    # 10d
    for r, (comm_errs, *_) in enumerate(ranks):
        log(f"  10d rank {r}: comm layer against one process on "
            f"{comm_errs['devices']}: "
            f"{ {k: v for k, v in comm_errs.items() if k not in ('devices', 'psum_bits')} }")
        for k in ("shift_y", "shift_x", "all_gather", "gather_blocks",
                  "psum"):
            require(comm_errs[k] == 0.0, f"10d rank {r}: {k} differs by "
                    f"{comm_errs[k]}")
        require(comm_errs["devices"] == ["cuda:0", "cuda:0"],
                f"10d rank {r}: tensors on {comm_errs['devices']}")
    require(len({r[0]["psum_bits"] for r in ranks}) == 1,
            "10d: psum differs between ranks")
    res["comm_check"] = ranks[0][0]
    # 10a
    recs = [r[1][0] for r in ranks]
    own = [r[1][1] for r in ranks]
    require(all(rec == recs[0] for rec in recs), f"10a: the ranks' records "
            f"differ: {recs}")
    rec = recs[0]
    total = sum(rec["iters"])
    log(f"  10a headline on a {rec['mesh']} mesh ({label}): iterations "
        f"{rec['iters']}, total {total} (band {DIST_HEADLINE_BAND}, anchor "
        f"{HEADLINE_ANCHOR}), stop residuals "
        f"{[f'{v:.2e}' for v in rec['stops']]}, mass_ok {rec['mass_ok']}")
    for o in own:
        log(f"    rank {o['rank']}: wall {o['wall_s']:.3f} s (levels "
            f"{o['level_s']} s), peak {o['peak_gib']:.3f} GiB, comm "
            f"{o['comm_calls']} calls {o['comm_bytes'] / 1e6:.2f} MB sent "
            f"({o['comm_bytes_per_iter'] / 1e3:.2f} kB an iteration), "
            f"launches {o['launches']}")
    require(DIST_HEADLINE_BAND[0] <= total <= DIST_HEADLINE_BAND[1],
            f"10a: total iterations {total} outside {DIST_HEADLINE_BAND}")
    n_h, nt_h = DIST_HEADLINE[1:3]
    require(rec["mass_ok"] and rec["finite"]
            and rec["shape"] == [nt_h, n_h, n_h], f"10a: {rec}")
    require(all(v < DIST_HEADLINE[4] for v in rec["stops"]),
            f"10a stops {rec['stops']}")
    # every kernel inPALM runs reads neighbouring cells: under a mesh they
    # all run plain on the block (ROADMAP.md queue 6 item 10)
    require(all(not o["launches"] for o in own), "10a: a kernel that reads "
            "neighbouring cells was launched under the halo engine")
    res["headline"] = dict(rec, total=total, ranks=own,
                           world_s=world_a_s)
    # 10e
    recs = [r[2][0] for r in ranks]
    own = [r[2][1] for r in ranks]
    require(all(rec == recs[0] for rec in recs), f"10e: the ranks' records "
            f"differ: {recs}")
    rec = recs[0]
    log(f"  10e acc-ADMM on a {rec['mesh']} mesh ({label}), "
        f"{DIST_ACC[1]}^2 x {DIST_ACC[2]}, one level: {rec['iters']} "
        f"iterations, stop residual {rec['stop']:.2e}")
    for o in own:
        log(f"    rank {o['rank']}: wall {o['wall_s']:.3f} s, launches "
            f"{o['launches']}; cone_project_diff on its block "
            f"{o['block']}: bit-equal to its plain version {o['exact']}, "
            f"{o['max_abs_err']:.2e} from proj_soc, pads "
            f"{o['pads_max']:.1e}")
        require(o["launches"] == {"cone_project_diff": rec["iters"]},
                f"10e rank {o['rank']}: launches {o['launches']}, not "
                f"cone_project_diff once an iteration ({rec['iters']})")
        require(o["exact"] and o["within"] and o["pads_max"] == 0.0,
                f"10e rank {o['rank']}: cone_project_diff on the block: "
                f"{o}")
    require(rec["finite"] and rec["iters"] > 0, f"10e: {rec}")
    res["acc"] = dict(rec, ranks=own)
    # 10f
    res["batch_spatial"] = _bxs_check(torch, ranks, bxs, bxs_locks)
    res["world_a_s"] = world_a_s

    t0 = time.monotonic()
    stol = DIST_SCALE[4]
    ranks = run_world(_world_b, 2, (DIST_SCALE, DIST_SHARDED),
                      backend="gloo", device=DEVICE, timeout=DIST_TIMEOUT)
    world_b_s = time.monotonic() - t0
    # 10b
    recs = [r[0][0] for r in ranks]
    own = [r[0][1] for r in ranks]
    require(recs[0] == recs[1], f"10b: the ranks' records differ: {recs}")
    rec = recs[0]
    total = sum(rec["iters"])
    log(f"  10b scale config on a {rec['mesh']} mesh ({label}): iterations "
        f"{rec['iters']}, total {total} (anchor {SCALE_ANCHOR}, "
        f"{100.0 * (total - SCALE_ANCHOR) / SCALE_ANCHOR:+.1f}%), stop "
        f"residuals {[f'{v:.2e}' for v in rec['stops']]}, mass_ok "
        f"{rec['mass_ok']}")
    for o in own:
        log(f"    rank {o['rank']}: wall {o['wall_s']:.3f} s (levels "
            f"{o['level_s']} s), peak {o['peak_gib']:.3f} GiB, comm "
            f"{o['comm_calls']} calls {o['comm_bytes'] / 1e9:.3f} GB sent "
            f"({o['comm_bytes_per_iter'] / 1e6:.2f} MB an iteration)")
    require(abs(total - SCALE_ANCHOR) <= 0.1 * SCALE_ANCHOR,
            f"10b: total {total} not within 10% of {SCALE_ANCHOR}")
    require(rec["mass_ok"] and rec["finite"] and all(
        v < stol for v in rec["stops"]), f"10b: {rec}")
    res["scale"] = dict(rec, total=total, ranks=own, world_s=world_b_s)
    # 10c
    for which, anchor in (("float32", FLEET_ANCHOR),
                          ("float64", FLEET_ANCHOR_F64)):
        i = 1 if which == "float32" else 2
        got = [r[i] for r in ranks]
        for key in ("iters", "done", "done_it", "kkt", "mode"):
            require(got[0][key] == got[1][key], f"10c {which}: the ranks' "
                    f"{key} differ")
        require(np.array_equal(got[0]["rho"], got[1]["rho"]),
                f"10c {which}: the ranks' rho differ")
        g = got[0]
        log(f"  10c fleet {which} sharded over 2 ranks ({label}): done_it "
            f"{g['done_it']}, total {g['iters']} (anchor {anchor['iters']}, "
            f"{100.0 * (g['iters'] / anchor['iters'] - 1.0):+.1f}%), walls "
            f"{[round(x['wall_s'], 3) for x in got]} s, peaks "
            f"{[round(x['peak_gib'], 3) for x in got]} GiB, launches per "
            f"rank {[x['launches'] for x in got]}")
        require(g["mode"] == "sharded" and all(g["done"]),
                f"10c {which}: {g['mode']}, done {g['done']}")
        require(all(max(k[j] for j in (0, 2, 5, 6)) < tol for k in g["kkt"]),
                f"10c {which}: stop residuals above {tol}")
        entry = dict(done_it=g["done_it"], iters=g["iters"],
                     walls_s=[x["wall_s"] for x in got],
                     peaks_gib=[x["peak_gib"] for x in got],
                     launches=[x["launches"] for x in got])
        if which == "float32":
            require(abs(g["iters"] - anchor["iters"]) <= 0.1 * anchor["iters"],
                    f"10c: iters {g['iters']} not within 10% of "
                    f"{anchor['iters']}")
            rel = [float(np.linalg.norm(g["rho"][b] - lock_rho[b])
                         / np.linalg.norm(lock_rho[b]))
                   for b in range(FLEET_B)]
            log(f"    rho against the one-process lockstep run (wall "
                f"{lock_wall:.3f} s), relative "
                f"{', '.join(f'{v:.2e}' for v in rel)} (bound {FLEET_GAP})")
            require(all(v <= FLEET_GAP for v in rel), f"10c: rho gaps {rel}")
            for x in got:
                for k in BATCHED:
                    require(x["launches"].get(k, 0) > 0, f"10c: {k} was "
                            f"launched no time on a rank")
            entry.update(rho_rel_vs_lockstep=rel, lockstep_wall_s=lock_wall)
        else:
            require(g["done_it"] == list(anchor["done_it"])
                    and g["iters"] == anchor["iters"], f"10c float64: "
                    f"done_it {g['done_it']}, iters {g['iters']}, not "
                    f"{anchor}")
            require(all(not x["launches"] for x in got),
                    "10c float64: a kernel was launched")
        res[f"fleet_{which}"] = entry
    # 10g
    res["sharded_step"] = _sharded_check([r[3] for r in ranks], 2)
    res["world_b_s"] = world_b_s
    return res

# -- phase 11: the solver cache ------------------------------------------------

# 11b: (method, first problem, second problem, n, nt, levels), each pair
# solved under one key, the second against a reuse_solvers=False solve;
# pairs whose level-2 E differ (the E2 feedback clamps example1's and
# example2's to the same value)
CACHE_PAIRS = (("inPALM", "example1", "DOTmark_4stitch", 129, 33, 3),
               ("acc-ADMM", "example3", "example4", 65, 17, 2),
               ("sGS-inPALM", "example3", "example4", 65, 17, 2))
# 11b, weighted: the love-heart weight and barrier with the love-heart
# densities, then example1's, inPALM (n, nt, levels, tol)
CACHE_WEIGHTED = (65, 33, 2, 1e-3)
# the split of a level's wall, in seconds on the host's clock: the solver's
# build (or cache lookup), prepare (the state to the card), the first eager
# runs, the captures, the rest of the loop, finish (the one read back)
SPLIT = ("build", "prep", "warmups", "captures", "loop", "finish")


def graph_counts(out) -> dict:
    """Captures, eager runs and replays summed over a solve's levels."""
    return {k: sum(lv["driver"][k] for lv in out["levels"])
            for k in ("captures", "eager_runs", "replays")}


def wall_split(out) -> list:
    """Each level's wall split into ``SPLIT`` (seconds)."""
    rows = []
    for lv in out["levels"]:
        d = lv["driver"]
        rows.append(dict(level=lv["level"], build=lv["build_s"],
                         prep=d["prepare_s"], warmups=d["eager_s"],
                         captures=d["capture_s"],
                         loop=lv["time"] - d["eager_s"] - d["capture_s"],
                         finish=d["finish_s"]))
    return rows


def log_split(what, wall, rows):
    log(f"  {what}: wall {wall:.3f} s")
    for r in rows:
        log(f"    level {r['level']}: " + ", ".join(
            f"{k} {r[k] * 1e3:.1f}" for k in SPLIT) + " ms")


def cache_solve(torch, r0, r1, nt, levels, opts, method="inPALM",
                weight=None, barrier=None):
    """One float32 ``solve_dot`` on the card, launches counted from 0:
    (output, wall s, graph counts)."""
    from dotsocp_tpu_torch.multilevel.solve import solve_dot

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out, _, _ = solve_dot(r0, r1, nt, levels, opts, method, weight, barrier,
                          device=DEVICE, dtype=torch.float32, verbose=False)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0, graph_counts(out)


def iterations(out) -> list:
    return [lv["iters"] for lv in out["levels"]]


def first_difference(torch, a, b):
    """None where two solves' rho and level iterations are equal, else what
    differs first."""
    if iterations(a) != iterations(b):
        return f"iterations {iterations(a)} against {iterations(b)}"
    if not torch.equal(a["rho"], b["rho"]):
        gap = float((a["rho"] - b["rho"]).abs().max())
        return f"rho differs by {gap:.3e}"
    return None


def cache_headline(torch):
    """11a: the headline twice from an empty cache; the second solve
    captures nothing, runs nothing eagerly, and is bit-equal to the
    first."""
    from dotsocp_tpu_torch.models.examples import get_example_2d

    clear_cache()
    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    runs = [cache_solve(torch, r0, r1, 33, 3, {"tol": 1e-4})
            for _ in range(2)]
    (first, wall1, c1), (second, wall2, c2) = runs
    log_split(f"first solve (cache empty; {c1})", wall1, wall_split(first))
    log_split(f"second solve (cache warm; {c2})", wall2, wall_split(second))
    total = sum(iterations(second))
    require(470 <= total <= 574, f"11a: total iterations {total} outside "
            f"470-574")
    require(c2["captures"] == 0 and c2["eager_runs"] == 0, f"11a: the "
            f"second headline solve made {c2}")
    diff = first_difference(torch, first, second)
    require(diff is None, f"11a: the second solve is not the first: {diff}")
    return first, dict(iters=iterations(second), wall_first_s=wall1,
                       wall_second_s=wall2, counts_first=c1,
                       counts_second=c2, split_first=wall_split(first),
                       split_second=wall_split(second))


def cache_pair(torch, what, first, second, solve):
    """One 11b pair: ``solve(problem, opts)`` runs ``first`` then
    ``second`` with the cache from empty, then ``second`` without it; the
    cached result bit-equal to the fresh one, the second problem's solvers
    all cache hits, and E differing at a level >= 2."""
    from dotsocp_tpu_torch.multilevel import solve as S

    clear_cache()
    a, _, _ = solve(first, {})
    entries = len(S._SOLVER_CACHE)
    b, wall, counts = solve(second, {})
    require(len(S._SOLVER_CACHE) == entries, f"11b {what}: the second "
            f"problem built {len(S._SOLVER_CACHE) - entries} solvers anew")
    fresh, fresh_wall, _ = solve(second, {"reuse_solvers": False})
    Es = [[lv["E"] for lv in o["levels"]] for o in (a, b)]
    log(f"  {what}: E per level {first} {Es[0]}, {second} {Es[1]}; "
        f"{second} iterations {iterations(b)} cached in {wall:.3f} s "
        f"({counts}), {iterations(fresh)} fresh in {fresh_wall:.3f} s")
    require(any(ea != eb for ea, eb in zip(Es[0][1:], Es[1][1:])),
            f"11b {what}: E is the same at every level >= 2, so the pair "
            f"proves nothing")
    diff = first_difference(torch, b, fresh)
    require(diff is None, f"11b {what}: cached {second} against fresh: "
            f"{diff}")
    return dict(E_first=Es[0], E_second=Es[1], iters=iterations(b),
                wall_cached_s=wall, wall_fresh_s=fresh_wall, counts=counts)


def cache_pairs(torch):
    """11b: two problems under one key, for inPALM (129^2 x 33), acc-ADMM
    and sGS-inPALM (65^2 x 17), and weighted inPALM on one love-heart
    weight."""
    from dotsocp_tpu_torch.models import wdot2d as W
    from dotsocp_tpu_torch.models.examples import get_example_2d

    out = {}
    for method, p1, p2, n, nt, levels in CACHE_PAIRS:
        def solve(problem, opts, method=method, n=n, nt=nt, levels=levels):
            r0, r1 = get_example_2d(problem, n, n)
            return cache_solve(torch, r0, r1, nt, levels,
                               dict(opts, tol=1e-4), method)

        out[method] = cache_pair(torch, f"{method} {n}^2 x {nt}", p1, p2,
                                 solve)
    n, nt, levels, tol = CACHE_WEIGHTED
    barrier = W.barrier_love_heart()
    weight = W.get_weight_by_barrier(n, n, nt, barrier, dtype=torch.float32,
                                     device=DEVICE)

    def solve_w(problem, opts):
        r0, r1 = W.get_example_w2d(problem, n, n)
        r0, r1, _ = W.ensure_barrier_validity(r0, r1, barrier)
        return cache_solve(torch, r0, r1, nt, levels, dict(opts, tol=tol),
                           "inPALM", weight, barrier)

    out["weighted inPALM"] = cache_pair(
        torch, f"weighted inPALM love-heart {n}^2 x {nt}", "love-heart",
        "example1", solve_w)
    return out


def cache_prewarm(torch, headline):
    """11c: the headline with prewarm from an empty cache: the solve itself
    captures nothing and runs nothing eagerly, bit-equal to 11a's."""
    from dotsocp_tpu_torch.models.examples import get_example_2d

    clear_cache()
    r0, r1 = get_example_2d("DOTmark_4stitch", 129, 129)
    out, wall, counts = cache_solve(torch, r0, r1, 33, 3,
                                    {"tol": 1e-4, "prewarm": True})
    log_split(f"prewarmed solve (the prewarm inside the wall; {counts})",
              wall, wall_split(out))
    require(counts["captures"] == 0 and counts["eager_runs"] == 0,
            f"11c: the prewarmed solve made {counts}")
    diff = first_difference(torch, out, headline)
    require(diff is None, f"11c: the prewarmed solve is not 11a's: {diff}")
    return dict(wall_s=wall, counts=counts, split=wall_split(out))


def cache_scale(torch):
    """11d: the scale config twice from an empty cache: both walls and
    splits, the peak memory, the memory the cache holds after them and
    after ``clear_solver_cache()``, and the device's busy share in a third,
    profiled solve from the warm cache, against the second's wall."""
    from dotsocp_tpu_torch.models.examples import get_example_2d

    n, nt, levels, tol = SCALE_CONFIG
    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)
    cold_memory(torch)
    base = torch.cuda.memory_allocated()
    opts = {"tol": tol, "maxit": 3000}
    (first, wall1, c1), (second, wall2, c2) = [
        cache_solve(torch, r0, r1, nt, levels, opts) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    held = (torch.cuda.memory_allocated() - base) / 2 ** 30
    log_split(f"scale config, first solve (cache empty; {c1})", wall1,
              wall_split(first))
    log_split(f"scale config, second solve (cache warm; {c2})", wall2,
              wall_split(second))
    total = sum(iterations(second))
    require(abs(total - SCALE_ANCHOR) <= 0.1 * SCALE_ANCHOR, f"11d: total "
            f"iterations {total} not within 10% of {SCALE_ANCHOR}")
    require(c2["captures"] == 0 and c2["eager_runs"] == 0, f"11d: the "
            f"second solve made {c2}")
    diff = first_difference(torch, first, second)
    require(diff is None, f"11d: the second solve is not the first: {diff}")
    iters = iterations(second)
    splits = [wall_split(first), wall_split(second)]
    del first, second
    kernel_ms, busy = device_busy(
        torch, lambda: cache_solve(torch, r0, r1, nt, levels, opts), wall2)
    clear_cache()
    after = (torch.cuda.memory_allocated() - base) / 2 ** 30
    log(f"  scale config {n}^2 x {nt}: iterations {iters}, walls "
        f"{wall1:.3f} / {wall2:.3f} s; peak {peak:.3f} GiB; the cache holds "
        f"{held:.3f} GiB, {after:.3f} GiB after clear_solver_cache(); a "
        f"warm solve's device busy {busy:.0f}% ({kernel_ms:.1f} ms of "
        f"kernels, profiled run)")
    return dict(iters=iters, wall_first_s=wall1, wall_second_s=wall2,
                split_first=splits[0], split_second=splits[1],
                counts_first=c1, counts_second=c2, peak_gib=peak,
                cache_gib=held, after_clear_gib=after, busy_pct=busy,
                kernel_ms=kernel_ms)


def solver_cache(torch):
    """Phase 11: 11a-11d."""
    t0 = time.monotonic()
    log("  11a: the headline twice")
    headline, res = cache_headline(torch)
    out = {"headline": res}
    log("  11b: two problems under one key")
    out["pairs"] = cache_pairs(torch)
    log("  11c: prewarm")
    out["prewarm"] = cache_prewarm(torch, headline)
    del headline
    log("  11d: the scale config twice")
    out["scale"] = cache_scale(torch)
    out["seconds"] = time.monotonic() - t0
    log(f"  phase 11 took {out['seconds']:.1f} s")
    return out


# -- phase 12: the native oracle ------------------------------------------

# the oracle's grid, and its sweep's D and sweeps
ORACLE = (33, 129)
ORACLE_D, ORACLE_ITS = 0.83, 2


def native_oracle(torch):
    """Phase 12: the native golden kernels (CPU, float64) against the card. On
    seeded inputs at 129^2 x 33: the shaped bfd, bfd_T and the plain
    proj_soc in float64 on the card within 1e-12; the sweep kernel's
    float32 output (two sweeps, D = 0.83, tests/test_native.py:59-66)
    within rtol 2e-5 / atol 2e-6 of native.rb_sgs in float64, rounded.
    Then the sweep and the cone projection against their plain versions on
    the shaped fields: the sweep within the same tolerance, the cone
    projection bit-equal. Returns {kernel: largest error}."""
    import numpy as np

    from dotsocp_tpu_torch import native
    from dotsocp_tpu_torch.ops.cone import proj_soc
    from dotsocp_tpu_torch.ops.engine import Ops3D
    from dotsocp_tpu_torch.ops.fused_step import (cone_project_diff,
                                                  cone_project_diff_plain)
    from dotsocp_tpu_torch.ops.geometry import Geometry
    from dotsocp_tpu_torch.ops.sgs import make_sgs
    from dotsocp_tpu_torch.ops.sgs_sweep import rb_sweep
    from dotsocp_tpu_torch.ops.staggered import Staggered

    nt, n = ORACLE
    geom = Geometry(nt, (n, n))
    rng = np.random.default_rng(12)
    cpu = {"q0": rng.standard_normal(geom.q0_shape),
           "by": rng.standard_normal(geom.b_shape(0)),
           "bx": rng.standard_normal(geom.b_shape(1)),
           "x": rng.standard_normal(geom.z_shape),
           "phi": rng.standard_normal(geom.phi_shape),
           "rhs": rng.standard_normal(geom.phi_shape)}
    cpu = {k: torch.tensor(v, dtype=torch.float64) for k, v in cpu.items()}
    dev = {k: v.to(DEVICE) for k, v in cpu.items()}
    ops = Ops3D(geom, torch.float64, DEVICE)
    q = Staggered(dev["q0"], (dev["by"], dev["bx"]))
    errs = {}

    def gap(name, got, want, tol):
        err = float((got.cpu() - want).abs().max())
        errs[name] = err
        require(err <= tol, f"12 {name}: {err:.3e} from the native kernel "
                f"(tolerance {tol:g})")

    sbf, sd = 0.63, 1.7
    gap("bfd", ops.bfd(q, sbf, sd),
        native.bfd2d(cpu["q0"], cpu["by"], cpu["bx"], nt, n, n, sbf, sd),
        1e-12)
    for name, a, b in zip(("bfd_T.q0", "bfd_T.by", "bfd_T.bx"),
                          ops.bfd_T(dev["x"], sbf).blocks(),
                          native.bfd_conj2d(cpu["x"], nt, n, n, sbf)):
        gap(name, a, b, 1e-12)
    gap("proj_soc", proj_soc(dev["x"]), native.proj_soc(cpu["x"]), 1e-12)
    d2 = ORACLE_D * ORACLE_D
    sgs = make_sgs(geom, dtype=torch.float32, device=DEVICE)
    phi32, rhs32 = dev["phi"].float(), dev["rhs"].float()
    swept = rb_sweep(sgs, phi32, rhs32, d2, its=ORACLE_ITS)
    gold = native.rb_sgs(cpu["phi"], cpu["rhs"], d2, its=ORACLE_ITS).float()
    excess = float(((swept.cpu() - gold).abs()
                    - (ATOL + RTOL * gold.abs())).max())
    errs["rb_sweep vs native"] = float((swept.cpu() - gold).abs().max())
    require(excess <= 0, f"12: the sweep kernel "
            f"{errs['rb_sweep vs native']:.3e} from native.rb_sgs beyond "
            f"rtol {RTOL:g} / atol {ATOL:g}")
    cmp = Compare(torch)
    cmp("rb_sweep", swept, sgs.sweep(phi32, rhs32, ORACLE_ITS, d2=d2))
    z2 = dev["x"].float()
    beta = (0.3 * dev["x"].flip(0)).float().contiguous()
    cmp("cone_project_diff", cone_project_diff(z2, beta),
        cone_project_diff_plain(z2, beta), exact=True)
    errs.update(cmp.max_abs)
    log(f"  against native (float64, CPU): "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="add a torch.profiler window (phase 6); with DIR, "
                         "write its chrome trace there")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs the port's CUDA kernels and needs a card")
    sys.path.insert(0, ROOT)
    import dotsocp_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.monotonic()
    phase(1, "device")
    device_name, card = check_device(torch)
    phase(2, "build")
    registers = build_kernels()
    phase(3, "kernels against their plain versions")
    from dotsocp_tpu_torch.ops.geometry import Geometry

    cmp = Compare(torch)
    for seed, (nt, space) in enumerate(CHECK_SHAPES):
        check_kernels(torch, cmp, Geometry(nt, space), seed)
        check_scalars_from_memory(torch, Geometry(nt, space), seed)
        check_single_step_kernels(torch, cmp, Geometry(nt, space), seed)
        check_sweep(torch, cmp, Geometry(nt, space), seed)
        check_shift(torch, cmp, Geometry(nt, space), seed)
        torch.cuda.empty_cache()
    kernel_err = dict(cmp.max_abs)
    check_sweep_shapes(torch)
    check_segment(torch)
    check_run_one(torch)
    phase("3b", "the DIM = 3 kernels at 17 x 33 x 65 x 9, 33^3 x 17, "
          "129^3 x 33, 65^3 x 33 and 17^3 x 9; 3D CA segment and run_one at "
          "17^3 x 9")
    kernel_err_3d, peaks_3d = check_3d_kernels(torch)
    steps_3d = check_3d_steps(torch)
    # the main path's launches: each solve and profile below counts from 0
    # and hands back what it read
    launches = {}
    phase(4, "headline solve")
    run_launches, headline = headline_solve(torch)
    headline_launches = dict(run_launches)
    add_counts(launches, run_launches)
    phase("4b", "the sGS path: sGS-inPALM at 129^2 x 33")
    run_launches, sgs_path = sgs_solve(torch)
    add_counts(launches, run_launches)
    phase("4c", "acc-sGS-ADMM, acc-ADMM, PALM at 65^2 x 17")
    run_launches, variants = variant_solves(torch)
    add_counts(launches, run_launches)
    phase("4d", "the weighted headline: love-heart 129^2 x 129; weighted "
          "acc-ADMM at 33^2 x 9")
    run_launches, weighted = weighted_solves(torch)
    add_counts(launches, run_launches)
    phase("4e", "profile: the headline with opts profile; acc-ADMM theta = 3 "
          "at 65^2 x 17; profile_phases at 513^2 x 65")
    run_launches, profiled = profile_solve(torch)
    add_counts(launches, run_launches)
    run_launches, variants["acc-ADMM theta=3"] = theta3_solve(torch)
    add_counts(launches, run_launches)
    run_launches, profiles = profile_scale(torch)
    add_counts(launches, run_launches)
    phase("4f", "the 3D path: gaussian 65^3 x 33 (3 levels), the demo "
          "default 33^3 x 17 (gaussian, split8), sGS-inPALM and acc-ADMM at "
          "17^3 x 9")
    launches_3d, solves3d = solves_3d(torch)
    phase("4g", "the headline in float64 on the card (the plain route)")
    run_launches, headline64 = headline_f64(torch)
    add_counts(launches, run_launches)
    phase("4h", "the refine tail: the north star (the headline to KKT 1e-6) "
          "and dot1d 1025 x 33 to 1e-5; the times behind 'auto'")
    run_launches, refine = refine_solves(torch, headline_launches)
    add_counts(launches, run_launches)
    refine_auto = refine_modes(torch)
    print(json.dumps({"refine_dct_split_auto": refine_auto}), flush=True)
    log(f"  main-path launches, 2D {launches}; 3D {launches_3d}")
    for k in REPLACES:
        require(k in OFF_PATH or launches[k] > 0, f"{k} was launched no time "
                f"on the 2D main path")
        require(k in OFF_PATH_3D or launches_3d[k] > 0, f"{k} was launched "
                f"no time on the 3D path")
    phase(5, "times at 513^2 x 65 and at 129^3 x 33")
    times, library, others = time_scale(torch)
    times["rb_sweep"], sweep_others = time_sweep(torch)
    others.update(sweep_others)
    others.update(time_weighted_iteration(torch))
    times_3d, library_3d, others_3d = time_scale_3d(torch)
    phase("5b", "the KKT battery's sums at 513^2 x 65 and 129^2 x 33")
    print(json.dumps({"kkt_battery": time_kkt(torch)}), flush=True)
    if args.profile is not None:
        phase(6, "profiler window")
        profile_window(torch, args.profile)
    phase("7a", "the device driver: CUDA-graph replays against eager runs")
    device_driver = {"replays": graph_replays(torch)}
    phase("7b", "the host and the device driver on the same solves")
    device_driver["pairs"] = driver_pairs(torch, args.profile is not None)
    phase("7c", "the device driver: a resume from a checkpoint")
    device_driver["resume"] = resume_check(torch)
    phase("8a", "the fleet: the batched kernels against B single-instance "
          "launches and their plain versions")
    batched_err, batched_times = batched_kernels(torch)
    phase("8b", "the fleet: lockstep segments replayed from graphs against "
          "eager, an instance against the single-instance driver")
    fleet = {"replays": fleet_replays(torch)}
    phase("8c", "the fleet: fleet_bench's eight problems at 129^2 x 33 "
          "under lockstep and sequential; the homogeneous fleet")
    fleet_launches, fleet["solve"] = fleet_solves(torch)
    phase("8d", "the fleet: lockstep against sequential at 33^2 x 9, "
          "65^2 x 17 and 129^2 x 33")
    fleet["crossover"] = crossover(torch, fleet["solve"])
    for row in fleet["crossover"]["rows"]:
        add_counts(fleet_launches, row.pop("launches", {}))
    log(f"  fleet launches (phases 8c, 8d) "
        f"{ {k: fleet_launches[k] for k in BATCHED} }")
    phase(9, "user problems on the card: the scale config (DOTmark 513^2 x "
          "65), the maze, example5, every demo at its defaults")
    launches_9, user = user_problems(torch)
    phase(10, "multi-device: the comm layer, the headline on a (y=2, x=2) "
          "mesh, acc-ADMM on it, the batch x spatial fleet on a (batch=2, "
          "y=2) mesh, the scale config on a (y=2,) mesh, the fleet sharded "
          "over 2 ranks, the sharded step on a (batch=2,) mesh; "
          + DIST_LABEL)
    multi = multi_device(torch)
    phase(11, "the solver cache: the headline twice, two problems under one "
          "key, prewarm, the scale config twice")
    cache = solver_cache(torch)
    phase(12, "the native oracle: the shaped engine's operators and the "
          "sweep kernel against the golden kernels")
    log(f"  card (name, power limit): {card}")
    oracle = dict(native_oracle(torch), card=card)
    log(f"\nall phases passed in {time.monotonic() - t_start:.1f} s")

    nbytes = all_bytes(Geometry(SCALE[0], (SCALE[1], SCALE[1])))
    nbytes_3d = all_bytes(Geometry(SCALE_3D[0], (SCALE_3D[1],) * 3))
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": SOURCES[k],
        "replaces": REPLACES[k],
        "launches": launches[k],
        "max_abs_err": kernel_err[k],
        "ms": times[k][0],
        "plain_ms": times[k][1],
        "bytes": nbytes[k],
        "bound_ms": bound_ms(nbytes[k]),
        "bound_by": "bytes",
        # one PyTorch call computes only the shift (F.pad of a slice)
        "library_ms": library.get(k),
        # summed over phase 9's solves, each counted from 0
        "phase9_launches": launches_9.get(k, 0),
        # the DIM = 3 form at the 3D scale level; its launches on the 3D
        # path (phase 4f), its error over the 3D check shapes
        "dim3": {
            "shape": [SCALE_3D[0]] + [SCALE_3D[1]] * 3,
            "launches": launches_3d[k],
            "max_abs_err": kernel_err_3d[k],
            "ms": times_3d[k][0],
            "plain_ms": times_3d[k][1],
            "bytes": nbytes_3d[k],
            "bound_ms": bound_ms(nbytes_3d[k]),
            "library_ms": library_3d.get(k),
        },
    } for k in REPLACES]
    (b8, b8_nt, b8_space), (b32, b32_nt, b32_space) = BATCH_SHAPES[:2]
    t8, bytes8 = batched_times[(b8, b8_nt, b8_space)]
    t32, bytes32 = batched_times[(b32, b32_nt, b32_space)]
    kernels += [{
        "name": k,
        "route": "cuda",
        "source": FUSED_CU,
        "replaces": REPLACES[single],
        # summed over the lockstep solves of phases 8c and 8d
        "launches": fleet_launches[k],
        "max_abs_err": batched_err[k],
        # B = 8 x 129^2 x 33
        "ms": t8[k][0],
        "plain_ms": t8[k][1],
        "bytes": bytes8[k],
        "bound_ms": bound_ms(bytes8[k]),
        "bound_by": "bytes",
        "library_ms": None,
        "phase9_launches": launches_9.get(k, 0),
        "singles_ms": t8[k][2],
        "b32_65x17": {"ms": t32[k][0], "plain_ms": t32[k][1],
                      "singles_ms": t32[k][2], "bytes": bytes32[k],
                      "bound_ms": bound_ms(bytes32[k])},
    } for k, single in BATCHED.items()]
    print(json.dumps({"kernels": kernels, "headline": headline,
                      "sgs_path": sgs_path, "variants": variants,
                      "weighted": weighted, "profile_headline": profiled,
                      "profile_513x65": profiles, "scale_513x65": others,
                      "registers": registers, "peak_gib_3d": peaks_3d,
                      "steps_3d": steps_3d, "solves_3d": solves3d,
                      "scale_129x3x33": others_3d,
                      "headline_f64": headline64, "refine": refine,
                      "hbm_peak": HBM_PEAK,
                      "sweep_max_abs_by_shape": SWEEP_ERRS,
                      "device_driver": device_driver, "fleet": fleet,
                      "user_problems": user, "multi_device": multi,
                      "solver_cache": cache, "native_oracle": oracle}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
