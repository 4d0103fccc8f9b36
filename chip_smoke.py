#!/usr/bin/env python3
"""Smoke run of calibr8_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of a checkout)

Phases, in order; any failure exits non-zero without the result lines:

 1. device: the card's name and power limit (nvidia-smi), the torch and
    CUDA versions, the build of the nine CUDA libraries (twelve launch
    counters: 3c on the multigrid levels, 3c per part and 1c count apart)
    from calibr8_tpu_torch/csrc with nvcc (one process per source, all in
    parallel), with ptxas's register and spill report, and the two
    multigrid meshes refined on the host.
 2. each kernel against its plain PyTorch version, in float32 and
    float64, at the shapes of the full-width problems, in states with
    plastic and elastic elements: the slice-1 kernels at cube n=32,
    small_J2, mixed u/p (196,608 elements, 143,748 dofs); the analytic
    kernel's displacement-only rows at cube n=32 isotropic_elastic (nde
    12, 107,811 dofs), with the EBE kernel at nde 12 and both ELL kernels
    at 3D ndpn 3 on its Jacobians; the implicit
    assembly at cube n=32 small_hill, hyper_J2 and hypo_hill (mixed u/p),
    at notch2D h=0.004 small_hill_plane_stress, hyper_J2_plane_stress and
    hypo_hill_plane_stress (displacement only) and small_hill_plane_strain,
    hyper_J2_plane_strain and hypo_hill_plane_strain (mixed u/p), the
    finite-deformation cases with x != x_prev (every implicit library
    launches the team kernel, c8::implicit_team_kernel; the records of
    the four implicit libraries carry the instance's ptxas registers,
    stack frame and spill bytes and a bound that also counts the
    operations this run's data needs, implicit_cost.FLOPS at PEAK_FLOPS,
    with the time at the card's rate without FMA beside it);
    the eigensolver libraries (implicit_eig.cu, implicit_barlat.cu) at cube
    n=32 small_hosford, hypo_hosford and hypo_barlat (eig_deck); the
    hybrid's library (implicit_hybrid.cu) at notch2D h=0.004
    hybrid_hyper_J2_plane_stress (hybrid_deck), and at notch2D h=0.032
    with a network at the kernel's cap (HYBRID_CAP_NET: its layers in the
    per-thread slab of shared memory); the eigensolver twins with the
    elements whose principal stresses nearly coincide counted and each
    element's J held to its conditioning (EIG_J_EPS); the EBE and both
    ELL kernels held once more
    at notch2D's shapes (nde = 6, ndpn = 2, and nde = 9, ndpn = 3).
    The transposed ELL kernel (3b) is also held, with the whole transposed
    operator, at the bench deck's shapes.  The multigrid level apply
    (kernel 3c: the ell_spmv kernel's (m, m) instances, and ell_spmv_T's
    the same way) is held on the level matrices that make_state builds:
    the cube MG deck's fine pressure block (m = 1, 35,937 nodes) and its
    level 1 (m = 3 and m = 1, 4,913 nodes), the notch2D MG deck's level 1
    (m = 2).
    Each record: max error relative to max|plain|, the kernel's time per
    call (CUDA events around back-to-back calls), the plain version's, a
    one-call PyTorch yardstick where one exists, the least time the card
    could take (bound), and for the implicit kernel the histogram of
    local Newton iterations.  The ELL records (3a, 3b, 3c, 3c per part)
    and the EBE's add device_ms, the kernel's device time per call
    (torch.profiler over the same back-to-back loop), and the CSR mv's
    library_device_ms, which split a call's wall into card and host; 3a
    and 3c record that two calls give the same y bit for bit.  Then (2b)
    the domain-decomposed solver's kernels at 8 parts (DistContext,
    float32 and float64): the element-level entry of the assembly (kernel 1c, assembly_elems: the
    five libraries reading pre-gathered element columns) on the elements
    the parts gather, at cube n=32 small_J2, isotropic_elastic, hyper_J2
    (x_prev), small_hosford and hypo_barlat and notch2D h=0.004 small_J2,
    small_hill_plane_stress and the hybrid, against its plain version
    under the same rules and against the single-device entry on the same
    elements, bit for bit; and 3c per part (part_ell_spmv: every part's
    local ELL matrix in one launch of ell_spmv.cu's (m, m) instance) on the
    Jacobians it gives at ndpn 4 (cube n=32, the (4, 4) instance), 3 and 2
    (notch2D), with the torch.sparse CSR mv of the same block-diagonal
    matrix.  Then kernel 4, the inverse-trig / float64
    loop probe (csrc/probe.cu): its own entry point, probe.run, with its
    launches counted, against numpy, then against its plain version.
 3. the goldens of tests/decks.py on the card in float64 (cube_elastic,
    notch2D_small_J2, the small-strain Hill family's three, the hyper_J2
    family's five, the hypo_hill family's three, notch_small_hosford and
    notch_hypo_barlat), and the notch deck once more through GMRES on the
    ELL operator.
 4. the full-width primal solves (float64, GMRES + block Gauss-Seidel)
    through Problem(...).solve_primal(): the bench deck (cube n=32,
    small_J2) with the assembled ELL matrix as the Krylov operator and
    once more, for 1 load step, with the matrix-free EBE operator; cube
    n=32 small_hill, hyper_J2, hypo_hill, small_hosford and hypo_barlat
    and cube n=8 hypo_hosford (mixed u/p, 2 load steps; the eigensolver
    decks with the pull tilted, eig_deck); cube n=32 isotropic_elastic
    (displacement only, 2 load steps);
    notch2D h=0.004 small_hill_plane_stress, hyper_J2_plane_stress and
    the hybrid ('mechanics_plane_stress', 2 load steps).  Each run's launch counts
    are set to 0 just before it and read just after; J is held at rel
    1e-6 to its reference.  Then (4b) the multigrid decks, GMRES with
    the recursive geometric multigrid: cube n=4 refined 3 times (196,608
    tets, small_J2 at the bench deck's constants, mixed u/p: u and p
    chains) with `preconditioner reuse` none and step, and notch2D
    h=0.032 refined 3 times (139,008 triangles, small_hill_plane_stress,
    and hypo_hill_plane_stress with Q at 30 degrees);
    every linear solve must reach its tolerance, J within rel 1e-6 of
    calibr8_tpu's (J_REF_MG_*), 3a and 3c launched.  Then (4c) the
    domain-decomposed solver through its entry points (DistContext,
    DistPrimal.run): the bench deck and hyper_deck(32) at 8 parts with
    Newton converged to an absolute 1e-11 (converged_deck: at the decks'
    own tolerance J is set only to ~1e-5), J within rel 1e-6 of
    calibr8_tpu's and within 1e-9 of the port's single-device J at the
    same tolerance, with the per-part element, owned and ghost counts,
    Newton and Krylov counts and times; calibr8_tpu's dry-run deck
    (notch2D h=0.015) at 5 parts, x within 1e-10 (of max|x|) of the
    port's single-device solve; each must launch assembly_elems and
    ell_spmv_part.
 5. the adjoint (float64), through AdjointObjective's value and
    gradient: (a) against finite differences, log10 error drop > 6: the
    notch2D small_J2 8-step deck, the hyper_J2_plane_stress and
    hypo_hill_plane_stress twin cases on notch2D h=0.12, small_hosford
    on cube n=3 and the hybrid on its twin case, notch2D h=0.3 (Y and two network
    weights; fd_decks); (b) the bench deck, (c) cube n=32 small_hill,
    (d) cube n=32 hyper_J2, hypo_hill, small_hosford and
    isotropic_elastic (adjoint_deck), dJ/dp held at 1e-5 to
    calibr8_tpu's (G_REF_*), every adjoint relative residual <= 0.5,
    ell_spmv_T launched, and the hybrid (Y and its 13 network weights) on
    hybrid_mg_deck (notch2D h=0.032 refined 3 times, multigrid), the same
    way with every transposed solve at its tolerance; (e) dJ/dp of the
    cube MG deck with the multigrid transposed solves
    (Adjoint(mg_factory=...)), reuse none and step, every transposed
    solve at its tolerance, within 1e-5 of calibr8_tpu's G_REF_MG, step
    equal to none to 1e-9.  Launch counts as in phase 4.  (f) the
    domain-decomposed adjoint: calibr8_tpu's large dist test deck
    (dist_adjoint_deck, notch2D h=0.0145, GMRES at 1e-13) through
    DistPrimal and DistAdjoint at 8 parts, dJ/dp within 1e-8 of
    max|dJ/dp| of calibr8_tpu's single-device G_REF_DIST; then the dist
    overhead record (bench.py:1096-1150's figure: seconds per GMRES
    iteration of the dist ELL apply at 1 and 8 parts against the
    single-device one, cube n=32, no limit).  (g) the CLI,
    `primal` and `inverse` (the gradient check), in this process on the
    two last models' twin cases (cli_decks), exit code 0 and drop > 6.
    (h) FEMU recovery (tests/test_calibration_recovery.py's configurations,
    small_hill_plane_stress at Y 2, S 10, D 2 with unit Hill ratios): a
    synthetic calibration at full width (phase_femu_full_width: notch2D
    h=0.032 refined 3 times, 139,008 triangles, GMRES with the geometric
    multigrid; the forward solve at the truth writes load.dat through the
    `reaction mismatch` QoI, attach_synthetic; then run_inverse, L-BFGS-B,
    over Y and D of the `calibration` QoI's AdjointObjective from Y 2.5, D
    2.8): Y and D within rel 5e-3 of the truth, J and dJ/dp at the start
    within 1e-6 / 1e-5 of calibr8_tpu's (J_REF_FEMU / G_REF_FEMU, from
    chip_reference.py femu), every transposed solve at its tolerance, with
    evaluations, seconds per evaluation (primal and adjoint), Newton and
    Krylov counts, launches per evaluation and peak memory; the reference
    configuration (phase_femu_reference: notch2D h=0.15, 4 steps, Y / S / D
    from 2.6 / 7 / 3) with L-BFGS-B and trust-constr, each to rel 1e-3;
    and the CLI round trip (phase_femu_cli: `primal` with write synthetic,
    `perturb`, `inverse` with fields file and an iteration limit,
    `objective`), exit code 0 at every step.
 6. the aggregation AMG (phase_amg; after the other adjoint phases, so
    that the first sweep's warm-up falls outside it): (a) the
    bench deck with `preconditioner: amg` (amg_bench_deck: cube n=32,
    mixed u/p, the u chain's levels at m = 6, the p chain at m = 1), J
    and dJ/dp through AdjointObjective, every forward and transposed
    solve at its tolerance, J within rel 1e-6 and dJ/dp within 1e-5 of
    max of calibr8_tpu's AMG run (J_REF_AMG, G_REF_AMG), with the
    hierarchy's setup, level sizes and widths and the seconds per Krylov
    iteration; (c) kernel 3c's (6, 6) instance (and (1, 1)) on (a)'s
    level-1 and level-2 operators at 1e-14 in float64, with the level
    records' timings, bound and CSR mv; (b) notch2D h=0.004
    small_hill_plane_stress with `multigrid` on the unrefined mesh
    (amg_plane_stress_deck), every solve at its tolerance, J within rel
    1e-6 of J_REF_AMG_PLANE_STRESS; (d) DistAMG at 8 parts on the bench
    deck converged to 1e-11 against the port's single-device AMG run: x
    and J within 1e-9, then DistAdjoint's dJ/dp (GMRES at 1e-12 in both)
    within 1e-8 of max.
 7. the jitted step solver (phase_jitted, solve/jit_newton.py: Newton
    and GMRES with no host read inside a chunk, replayed from CUDA graphs)
    on bench.py's calibration decks at n=10 (jit_bench_decks: notch2D
    h=0.01, small_hill_plane_stress, GMRES(200) + block GS): (a) the
    synthetic primal through JitStepSolver and the host StepSolver, J of
    each within 1e-6 of calibr8_tpu's run of the same route (J_REF_JIT,
    J_REF_JIT_HOST), with per step and
    route the Newton and Krylov counts, ms per Newton and Krylov
    iteration, graph replays and host reads (the synchronizing calls
    counted by PyTorch's sync debug mode); (b) the captured step against
    the uncaptured make_jit_step (x 1e-12, path equal), and the launches
    of kernels 1b and 3a equal to the graphs' recorded launches times
    their replays; (c) bench.py's calibration (L-BFGS-B over Y, D from
    2.5, 2.8): J and dJ/dp at the start within 1e-6 / 1e-5 of
    calibr8_tpu's (J_REF_JIT_START, G_REF_JIT), Y and D within 5e-3 of the
    truth, evaluations, failed forward solves, seconds per evaluation
    (primal and sweep), peak memory; (d) three experiments (x1, x1.05,
    x0.95) through run_batch, each equal to its own run to 1e-12.
 8. one JSON line listing every ported kernel (launches: the sum over
    the runs of phases 4, 4b, 4c, 5b-5f, 5h, 6 and 7; the probe's from its own run;
    implicit_assembly's entry also each instance's launches and figures,
    kernels.model_launches), the card's name and power limit, and the
    `ok` line last.

The script imports nothing of JAX or of calibr8_tpu.  Kernel builds go to
calibr8_tpu_torch/_build/.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores; 67 TFLOP/s float64 on the tensor cores (34
# outside them) -- the larger rate is taken so that the bound stays a
# lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
DEVICE = "cuda"

# J of the full-width deck from calibr8_tpu (the JAX reference) on an
# 8-core CPU: bench.build_problem(32, "f64") then solve_primal(); the two
# step contributions were 9.090906938095302e-04 and
# 1.0606065519543038e-03.
J_REF_N32 = 1.96969724576383405e-03
J_REF_N32_STEP1 = 9.090906938095302e-04

# J of the two full-width Hill decks (hill_deck(32), plane_stress_deck(0.004)
# below) from calibr8_tpu (JAX 0.9.0) on the 8-core CPU of the machine
# with the card: chip_reference.py.  Steps 9.255407500138226e-04 and
# 9.446702154425757e-04 (413 s); 2.13479613797512e-03 and
# 4.944628172944518e-03 (832 s).
J_REF_HILL_N32 = 1.8702109654563982e-03
J_REF_PLANE_STRESS_H004 = 7.079424310919638e-03

# dJ/dp of the two full-width adjoint decks (adjoint_deck("bench"),
# adjoint_deck("hill") below), canonical coordinates, from calibr8_tpu (JAX
# 0.9.0) on the 8-core CPU of the machine with the card: chip_reference.py
# adjoint, AdjointObjective.gradient with the default LinearCfg (GMRES +
# block Gauss-Seidel on the EBE operator, tol 1e-8, 600 iterations), at the
# decks' parameters.  Its adjoint relative residuals: steps 2, 1
# 8.91e-05, 4.53e-05 (bench, primal 223 s, adjoint 104 s) and 4.82e-03,
# 2.46e-03 (hill, 391 s, 89 s).
G_REF_N32 = {
    "body/E": -0.00035812580149246847, "body/nu": -0.00039393833293960046,
    "body/K": 5.50962830303721e-05, "body/Y": 0.0003030289456029175,
}
# J of the full-width hyper decks (hyper_deck(32): the adjoint reference's
# primal; hyper_plane_stress_deck(0.004)) and dJ/dp of adjoint_deck("hyper"),
# from calibr8_tpu (JAX 0.9.0) on the 8-core CPU of the machine with the
# card: chip_reference.py adjoint / chip_reference.py hyper_plane_stress.
# The cube deck's J is that of the adjoint reference's primal (334 s; its
# adjoint 141 s, relative residuals 1.15e-04 and 3.78e-05 for steps 2, 1);
# the plane-stress deck's steps 2.1442278319457808e-03 and
# 4.6276746386353165e-03 (774 s).
J_REF_HYPER_N32 = 2.172376682414853e-03
J_REF_HYPER_PLANE_STRESS_H004 = 6.771902470581097e-03
G_REF_HYPER = {
    "body/E": -0.0003494897100992006, "body/nu": -0.0003841267499682554,
    "body/Y": 0.00029616368222581046, "body/K": 5.332581850217601e-05,
}

# J of the full-width hypo_hill deck (hypo_deck(32): the adjoint reference's
# primal) and dJ/dp of adjoint_deck("hypo"), from calibr8_tpu (JAX 0.9.0) on
# the 8-core CPU of the machine with the card: chip_reference.py adjoint DIR
# hypo (primal 786 s, adjoint 166 s; relative residuals 6.08e-03 and
# 2.26e-03 for steps 2, 1).
J_REF_HYPO_N32 = 0.002044705152243181
G_REF_HYPO = {
    "body/E": -0.0003293698264366727, "body/nu": -0.0003325404416503844,
    "body/Y": 0.0003233898209323374, "body/R00": 2.8847572187406513e-10,
    "body/R11": 0.0003352276827072121, "body/R01": 1.6663068691711854e-09,
    "body/S": 5.991462541557953e-06, "body/D": 5.850828646630918e-06,
}

# J of the eigensolver decks (eig_deck: cube n=32 small_hosford, the
# adjoint reference's primal; hypo_barlat at n=32; hypo_hosford at n=8)
# and dJ/dp of adjoint_deck("hosford"), from calibr8_tpu (JAX 0.9.0) on
# the 8-core CPU of the machine with the card, as parallel processes of
# one call: chip_reference.py adjoint DIR hosford (primal 471 s, adjoint
# 98 s; relative residuals 5.75e-04 and 4.07e-04 for steps 2, 1),
# chip_reference.py barlat (1007 s; steps 8.665313580777104e-04,
# 1.2386848040370894e-03) and hypo_hosford8 (48 s; steps
# 7.125418014962784e-04, 7.762901229207415e-04).
J_REF_HOSFORD_N32 = 0.001914482788125576
J_REF_BARLAT_N32 = 0.0021052161621148
J_REF_HYPO_HOSFORD_N8 = 0.0014888319244170199
G_REF_HOSFORD = {
    "body/E": -0.000323270603727111, "body/nu": -0.00035603151665554813,
    "body/Y": 0.00023196715048189365, "body/a": 1.617009380979451e-05,
    "body/K": 7.663403403798524e-05, "body/S": 1.467065778951039e-05,
    "body/D": 1.4033585450567617e-05,
}

# J of the isotropic_elastic deck (iso_deck(32): the adjoint reference's
# primal) and dJ/dp of adjoint_deck("iso"), from calibr8_tpu (JAX 0.9.0) on the
# 8-core CPU of the machine with the card: chip_reference.py adjoint DIR iso
# (primal 67 s, adjoint 51 s; relative residuals 9.68e-10 in both steps).
# dJ/dE is zero up to rounding: under displacement boundary conditions the
# linear elastic displacement field does not depend on E.
J_REF_ISO_N32 = 0.005000000128234676
G_REF_ISO = {"body/E": -2.564684941140295e-11, "body/nu": -0.0010000000177759975}
# J of hybrid_deck(0.004), from calibr8_tpu the same way: chip_reference.py
# hybrid at HYBRID_PULL (74 s).
J_REF_HYBRID_H004 = 0.0014999279775072998
# dJ/dp of adjoint_deck("hybrid") (hybrid_mg_deck, multigrid; Y and the 13
# network weights; nn_12, the output bias, cancels in NN(a) - NN(0)), from
# calibr8_tpu with Adjoint(mg_factory=...): chip_reference.py mg DIR
# hybrid_adjoint (primal 214 s, 10 linear solves of 36-49 iterations;
# adjoint 76 s, transposed solves of 47 and 44 iterations, relres 6.2e-10
# and 2.4e-10; J 1.4997026228318674e-03).  On hybrid_deck(0.004) under
# block Gauss-Seidel the transposed solves stop at their 600-iteration cap
# (relres 0.227, 0.191), in both packages.
G_REF_HYBRID = {
    "body/Y": -4.102338279316368e-06, "body/nn_0": -1.5425852512113833e-09,
    "body/nn_1": -8.902006223857135e-11, "body/nn_2": -1.7968419078709217e-09,
    "body/nn_3": -3.963441913445649e-10, "body/nn_4": 7.157337620787115e-10,
    "body/nn_5": 4.117375504722184e-11, "body/nn_6": 8.332567695836473e-10,
    "body/nn_7": 1.8327283704188456e-10, "body/nn_8": -1.5447860621171965e-09,
    "body/nn_9": -8.904754603731068e-11, "body/nn_10": -1.7990619543928965e-09,
    "body/nn_11": -3.964321216842618e-10, "body/nn_12": 0.0,
}

# J of hypo_mg_notch_deck() from calibr8_tpu (JAX 0.9.0) on the 8-core CPU of
# the machine with the card: chip_reference.py mg DIR hypo_notch (523 s;
# steps 9.999089119281147e-04, 2.1745553106699744e-03; 8 + 15 Newton
# iterations, Krylov iterations per solve 37 39 38 39 39 39 38 37 | 35 24
# 18 17 17 16 18 20 18 19 20 21 21 21 23, every relres <= 1e-7).
J_REF_HYPO_MG_NOTCH = 3.1744642225980894e-03

# the active parameters of the hyper_J2_plane_stress and hypo_hill_plane_stress
# finite-difference checks
FD_HYPER_ACTIVE = {"E": [800.0, 1200.0], "Y": [5.0, 15.0], "S": [2.5, 7.5], "K": [25.0, 75.0]}
FD_HYPO_ACTIVE = {"E": [800.0, 1200.0], "Y": [8.0, 12.0], "S": [4.0, 6.0], "R11": [1.0, 1.2]}
# small_hosford's: wide ranges, so that the unit step in canonical
# coordinates leaves the linear range (at E [800, 1200], Y [8, 12], a
# [6, 10], K [40, 60] the quotients' error starts at 1e-7 and the drop
# stays at 5.5 on the CPU; at these ranges 7.2)
FD_HOSFORD_ACTIVE = {"E": [500.0, 1500.0], "Y": [5.0, 15.0], "a": [4.0, 12.0], "K": [0.0, 100.0]}
# the hybrid's (Y and two network weights, on its twin case): Y wide, so
# that the forward quotients' curvature term, ~4e-5 h, stands well above
# J's rounding (~1e-17 over h) down to h = 1e-6; PERF.md has the sweep
FD_HYBRID_ACTIVE = {"Y": [2.0, 18.0], "nn_0": [-1.0, 1.0], "nn_1": [-1.0, 1.0]}

G_REF_HILL_N32 = {
    "body/E": -0.0003692167601930235, "body/nu": -0.00037353152717606325,
    "body/Y": 0.0003619588017463349, "body/R00": 1.0362846637154069e-06,
    "body/R11": 0.0003764461621321883, "body/R01": 1.0438138211788746e-09,
    "body/S": 7.283840090641543e-06, "body/D": 7.094191925924717e-06,
}

# J of the multigrid decks (mg_cube_deck("none"), mg_cube_deck("step"),
# mg_notch_deck()) and dJ/dp of adjoint_deck("mg") (with Adjoint(mg_factory=
# ...) and the default LinearCfg) from calibr8_tpu (JAX 0.9.0) on the 8-core
# CPU of the machine with the card: chip_reference.py mg, the four decks as
# parallel processes (640 s).  Every linear solve of calibr8_tpu reached its
# tolerance: Krylov iterations per solve, load step 1 | 2,
#   cube none  17 30 | 30 45          (solve 389.7 s; steps 9.090909310879755e-04,
#                                      1.0606060622828921e-03)
#   cube step  17 38 | 30 48          (377.2 s)
#   notch      37 18 15 14 14 13 13 12 13 13 13 13 | 10 19 18 17 17 16 16 15 15 14 13 13
#                                     (12 + 12 Newton iterations, 309.4 s; steps
#                                      2.1342881372587103e-03, 4.9433022092596444e-03)
#   adjoint    primal as cube none; transposed solves 51 (step 2), 49 (step 1),
#              relres 8.9e-10, 6.7e-10 (primal 382.9 s, adjoint 230.7 s)
# J and dJ/dp (rows: element sets; columns: E, nu, K, Y, cte, delta_T) of
# dist_adjoint_deck() from calibr8_tpu's single-device primal and Adjoint
# (JAX 0.9.0, float64, on an 8-core CPU): chip_reference.py dist.  Its
# DistPrimal / DistAdjoint at 8 parts on 8 host devices gave J
# 1.818654304812413e-04 and dJ/dp within 9.0e-14 of max|dJ/dp| of these.
# One elastic load step: dJ/dE is rounding, K, Y, cte and delta_T are 0.
J_REF_DIST = 1.8186543048123732e-04
G_REF_DIST = [[-7.754591196146773e-19, -0.00037479841926580157, 0.0, 0.0, 0.0, 0.0]]

# J and dJ/dp of the bench deck with `preconditioner: amg` (amg_bench_deck,
# adjoint_deck("amg"), the CLI's default LinearCfg for the adjoint) and J of
# amg_plane_stress_deck() from calibr8_tpu's aggregation AMG (JAX 0.9.0,
# float64) on the 8-core CPU of the machine with the card, its smoothers on
# the port's LMAX_ITERS power iterations (with its own 10 both decks' first
# GMRES solve stalls, relres 0.79 / 0.82, and its Newton raises):
# chip_reference.py amg, the two decks as parallel processes.  Every solve
# reached its tolerance: Krylov iterations per solve, load step 1 | 2,
#   bench         27 52 | 41 65 (primal 384.9 s); transposed 77 (step 2),
#                 74 (step 1), relres 8.8e-10, 7.2e-10 (adjoint 254.8 s)
#   plane stress  21 53 42 38 37 34 36 32 33 33 32 33 | 32 76 74 73 70 63 62
#                 54 56 58 57 58 (12 + 12 Newton iterations, 498.3 s)
J_REF_AMG = 1.9696967423158762e-03
G_REF_AMG = {"body/E": -0.0003581267377678041, "body/nu": -0.0003939393982806668,
             "body/K": 5.509642610785999e-05, "body/Y": 0.00030303035713161587}
J_REF_AMG_PLANE_STRESS = 7.079422260392816e-03

J_REF_MG_CUBE = 1.9696969933708677e-03
J_REF_MG_CUBE_STEP = 1.9696969932754167e-03
J_REF_MG_NOTCH = 7.077590346518355e-03
G_REF_MG = {
    "body/E": -0.00035812671960819785, "body/nu": -0.0003939393928018927,
    "body/K": 5.509641796434722e-05, "body/Y": 0.0003030303095637189,
}

LR_TOL = {
    "nonlinear max iters": 500,
    "nonlinear absolute tol": 1e-12,
    "nonlinear relative tol": 1e-12,
}


def _deck(mesh, model, materials, bcs, num_steps, gtype="mechanics"):
    """tests/decks.py make_deck"""
    return {
        "discretization": {"builtin mesh": mesh, "num steps": num_steps, "step size": 1.0},
        "residuals": {
            "global residual": {
                "type": gtype,
                "nonlinear max iters": 40,
                "nonlinear absolute tol": 1e-8,
                "nonlinear relative tol": 1e-8,
            },
            "local residual": {"type": model, **LR_TOL, "materials": {"body": materials}},
        },
        "dirichlet bcs": bcs,
        "quantity of interest": {"type": "average displacement"},
    }


UNIT_R = {"R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0, "R02": 1.0, "R12": 1.0}
VOCE_MAT = {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0}
HILL2D = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0,
          "R00": 1.0, "R11": 1.1, "R22": 0.95, "R01": 1.05}


def bcs_3d(pull):
    return {"expression": {
        "bc 1": [0, 0, "xmin", "0.0"],
        "bc 2": [0, 1, "ymin", "0.0"],
        "bc 3": [0, 2, "zmin", "0.0"],
        "bc 4": [0, 1, "ymax", f"{pull} * t"],
    }}


def bcs_2d(pull):
    return {"expression": {
        "bc 1": [0, 0, "xmin", "0.0"],
        "bc 2": [0, 1, "ymin", "0.0"],
        "bc 3": [0, 1, "ymax", f"{pull} * t"],
    }}


def hill_deck(n: int) -> dict:
    """The bench deck (bench.py:106-147) with small_hill: the twin cases'
    Voce constants with HILL2D's ratios and R02 = R12 = 1
    (calibr8_tpu/models/twin_cases.py:15-16)."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "small_hill"
    lr["materials"] = {"body": {**HILL2D, "R02": 1.0, "R12": 1.0}}
    return deck


# the hyper_J2 twin cases' constants (calibr8_tpu/models/twin_cases.py:57-64
# and :156-163)
HYPER_MAT = {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0,
             "S": 0.0, "D": 0.0, "A": 0.0, "n": 0.0}
HYPER_PS_MAT = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0,
                "A": 0.0, "n": 0.0, "K": 50.0}


def hyper_deck(n: int) -> dict:
    """The bench deck (bench.py:106-147) with hyper_J2 at its twin case's
    constants."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hyper_J2"
    lr["materials"] = {"body": dict(HYPER_MAT)}
    return deck


ADJOINT_ACTIVE = {
    "bench": ("E", "nu", "K", "Y"),
    "hill": ("E", "nu", "Y", "S", "D", "R00", "R11", "R01"),
    "hyper": ("E", "nu", "K", "Y"),
    "mg": ("E", "nu", "K", "Y"),
    "amg": ("E", "nu", "K", "Y"),
    "hypo": ("E", "nu", "Y", "S", "D", "R00", "R11", "R01"),
    "hosford": ("E", "nu", "Y", "a", "K", "S", "D"),
    "iso": ("E", "nu"),
    # Y and every network weight (nn_0 .. nn_12 for [1, 4, 1])
    "hybrid": ("Y",) + tuple(f"nn_{i}" for i in range(13)),
}


def adjoint_deck(name: str) -> dict:
    """The full-width deck `name` (the bench deck, hill_deck(32),
    hyper_deck(32), hypo_deck(32), eig_deck("small_hosford", 32),
    iso_deck(32), hybrid_mg_deck() or, for "mg", mg_cube_deck(), for "amg",
    amg_bench_deck()) with an
    `inverse` sublist: the parameters of ADJOINT_ACTIVE[name] active over
    [0.8, 1.2] times their values (the network's initial weights for the
    hybrid's nn_<i>)."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = {"bench": lambda: bench_deck(32), "hill": lambda: hill_deck(32),
            "hyper": lambda: hyper_deck(32), "mg": mg_cube_deck, "amg": amg_bench_deck,
            "hypo": lambda: hypo_deck(32),
            "hosford": lambda: eig_deck("small_hosford", 32),
            "iso": lambda: iso_deck(32), "hybrid": hybrid_mg_deck}[name]()
    mats = dict(deck["residuals"]["local residual"]["materials"]["body"])
    if name == "hybrid":
        mats.update(hybrid_weights())
    deck["inverse"] = {"materials": {"body": {
        k: [0.8 * mats[k], 1.2 * mats[k]] for k in ADJOINT_ACTIVE[name]}}}
    return deck


def plane_stress_deck(h: float) -> dict:
    """The small_hill_plane_stress twin case (calibr8_tpu/models/
    twin_cases.py:123-130, case_deck) on notch2D of size h, 2 load steps.
    At h = 0.004 GMRES with block Gauss-Seidel leaves a relative residual
    of 0.54 after the default 200 iterations, and calibr8_tpu's Newton
    (like the port's) stops on it; the deck allows 1000 (five restart
    cycles of 200)."""
    deck = _deck({"type": "notch2D", "h": h}, "small_hill_plane_stress", HILL2D, bcs_2d(0.01), 2,
                 gtype="mechanics_plane_stress")
    deck["linear algebra"] = {"method": "gmres", "tolerance": 1e-6, "maximum iterations": 1000}
    return deck


def hill_plane_strain_deck(h: float) -> dict:
    """The small_hill_plane_strain twin case (calibr8_tpu/models/
    twin_cases.py:131-138, mixed u/p) on notch2D of size h, 2 load steps:
    the kernel phase's shapes of implicit_assembly.cu's model 1."""
    return _deck({"type": "notch2D", "h": h}, "small_hill_plane_strain", HILL2D, bcs_2d(0.01), 2)


def hyper_plane_strain_deck(h: float) -> dict:
    """The hyper_J2_plane_strain twin case (calibr8_tpu/models/twin_cases.py:
    147-155, mixed u/p) on notch2D of size h, 2 load steps: the kernel
    phase's plane-strain shapes (nde 9, ndpn 3)."""
    return _deck({"type": "notch2D", "h": h}, "hyper_J2_plane_strain",
                 {"E": 1000.0, "nu": 0.25, "K": 50.0, "Y": 10.0, "Y_inf": 15.0, "delta": 2.0},
                 bcs_2d(0.01), 2)


def hyper_plane_stress_deck(h: float) -> dict:
    """plane_stress_deck(h) with hyper_J2_plane_stress at its twin case's
    constants (calibr8_tpu/models/twin_cases.py:156-163)."""
    deck = plane_stress_deck(h)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hyper_J2_plane_stress"
    lr["materials"] = {"body": dict(HYPER_PS_MAT)}
    return deck


# the hypo_hill twin cases' constants (calibr8_tpu/models/twin_cases.py:75-82
# and :166-173): unit ratios in 3D; HILL2D with Q a 30-degree rotation in
# plane stress
HYPO_MAT = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0, **UNIT_R}
HYPO_PS_MAT = {**HILL2D, "Q00": 0.8660254037844387, "Q01": -0.5, "Q10": 0.5,
               "Q11": 0.8660254037844387}


def hypo_deck(n: int) -> dict:
    """The bench deck (bench.py:106-147) with hypo_hill at its twin case's
    constants."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hypo_hill"
    lr["materials"] = {"body": dict(HYPO_MAT)}
    return deck


def hypo_plane_strain_deck(h: float) -> dict:
    """The hypo_hill_plane_strain twin case (calibr8_tpu/models/twin_cases.py:
    140-146, mixed u/p) on notch2D of size h, 2 load steps: the kernel
    phase's plane-strain shapes."""
    return _deck({"type": "notch2D", "h": h}, "hypo_hill_plane_strain", HILL2D, bcs_2d(0.01), 2)


def hypo_plane_stress_deck(h: float) -> dict:
    """plane_stress_deck(h) with hypo_hill_plane_stress at its twin case's
    constants (Q a 30-degree rotation)."""
    deck = plane_stress_deck(h)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hypo_hill_plane_stress"
    lr["materials"] = {"body": dict(HYPO_PS_MAT)}
    return deck


# the eigensolver twin cases' constants (calibr8_tpu/models/twin_cases.py:82-113)
HOSFORD_MAT = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "a": 8.0, "K": 50.0, "S": 5.0, "D": 2.0}
EIG_MATS = {
    "small_hosford": HOSFORD_MAT,
    "hypo_hosford": {**HOSFORD_MAT, "K": 0.0},
    "hypo_barlat": {
        **HOSFORD_MAT,
        "sp_01": 1.0, "sp_02": 1.05, "sp_10": 0.95, "sp_12": 1.1, "sp_20": 0.9, "sp_21": 1.02,
        "sp_33": 1.04, "sp_44": 0.97, "sp_55": 1.06,
        "dp_01": 0.98, "dp_02": 1.03, "dp_10": 1.07, "dp_12": 0.92, "dp_20": 1.01, "dp_21": 0.96,
        "dp_33": 1.08, "dp_44": 1.02, "dp_55": 0.94,
    },
}


def eig_deck(model: str, n: int) -> dict:
    """The bench deck (bench.py:106-147) on cube n with an eigensolver twin
    (`small_hosford`, `hypo_hosford`, `hypo_barlat`) at its twin case's
    constants, the pull on ymax tilted across x (0.02 t (0.5 + x)).  Under
    the bench deck's uniform pull every element is in uniaxial tension,
    where two principal stresses are equal: calibr8_tpu's local Newton of
    the two Hosford twins then stalls at ||C|| ~ 1e-9 (its eigenvector
    tangents are undefined there) and its primal stops at the first
    plastic step; the tilt makes the field non-uniform (PERF.md)."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    deck["dirichlet bcs"]["expression"]["bc 4"] = [0, 1, "ymax", "0.02 * t * (0.5 + x)"]
    lr = deck["residuals"]["local residual"]
    lr["type"] = model
    lr["materials"] = {"body": dict(EIG_MATS[model])}
    return deck


# the isotropic_elastic and hybrid twin cases' constants
# (calibr8_tpu/models/twin_cases.py:116-122, :175-181, case_deck :216-222)
ISO_MAT = {"E": 1000.0, "nu": 0.25}
HYBRID_MAT = {"E": 1000.0, "nu": 0.25, "Y": 10.0}
HYBRID_NET = {"activation function": "sigmoid", "topology": [1, 4, 1], "input scale": 1.0,
              "output scale": 10.0}


def iso_deck(n: int) -> dict:
    """The bench deck (bench.py:106-147) on cube n with isotropic_elastic
    at its twin case's constants, displacement only ('mixed formulation:
    false')."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    deck["residuals"]["global residual"]["mixed formulation"] = False
    lr = deck["residuals"]["local residual"]
    lr["type"] = "isotropic_elastic"
    lr["materials"] = {"body": dict(ISO_MAT)}
    return deck


# the hybrid deck's pull on ymax (the twin case's is 0.01)
HYBRID_PULL = 0.0025


def hybrid_deck(h: float) -> dict:
    """plane_stress_deck(h) with hybrid_hyper_J2_plane_stress at its twin
    case's constants and network (sigmoid, [1, 4, 1], output scale 10;
    the weights are the network's initial ones), the pull HYBRID_PULL.
    The network's hardening saturates (about +5 over Y), so the notch
    tip's strain concentrates as the mesh refines: at the twin case's
    pull of 0.01 calibr8_tpu's own primal stops in load step 1 ("local
    solve diverged") from notch2D h=0.02 down to 0.004, and at 0.005 its
    Newton stalls in step 2 at h=0.02 (PERF.md)."""
    deck = plane_stress_deck(h)
    deck["dirichlet bcs"] = bcs_2d(HYBRID_PULL)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hybrid_hyper_J2_plane_stress"
    lr["materials"] = {"body": dict(HYBRID_MAT)}
    lr["embedded model"] = copy.deepcopy(HYBRID_NET)
    return deck


def hybrid_mg_deck() -> dict:
    """The hybrid's gradient deck: hybrid_deck's model, constants, network
    and pull on mg_notch_deck()'s mesh (notch2D h=0.032 refined 3 times,
    139,008 triangles), GMRES with the recursive geometric multigrid.
    Under block Gauss-Seidel the adjoint's transposed solves stop at their
    600-iteration cap, in both packages, at relres 0.2 on notch2D h=0.004
    and 1.5e-3 on h=0.01 (PERF.md); the multigrid cycle takes them to
    the adjoint's tolerance."""
    deck = mg_notch_deck()
    deck["dirichlet bcs"] = bcs_2d(HYBRID_PULL)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hybrid_hyper_J2_plane_stress"
    lr["materials"] = {"body": dict(HYBRID_MAT)}
    lr["embedded model"] = copy.deepcopy(HYBRID_NET)
    return deck


def hybrid_weights():
    """{nn_<i>: initial weight} of HYBRID_NET (the port's FFNN, whose
    initial weights equal calibr8_tpu's)."""
    from calibr8_tpu_torch.models.nn import FFNN

    w = FFNN(HYBRID_NET["activation function"], HYBRID_NET["topology"]).init_params
    return {f"nn_{i}": float(v) for i, v in enumerate(w)}


J2_MAT = {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0, "cte": 0.0, "delta_T": 0.0}


def dist_adjoint_deck() -> dict:
    """calibr8_tpu's large domain-decomposed test deck
    (tests/test_dist.py:154-188): notch2D h=0.0145 (>= 10k elements),
    small_J2, 1 load step, GMRES at 1e-13 with 9,000 iterations so that
    both the single-device and the dist solves converge."""
    deck = _deck({"type": "notch2D", "h": 0.0145}, "small_J2", J2_MAT, bcs_2d(0.001), 1)
    deck["linear algebra"] = {"method": "gmres", "tolerance": 1e-13, "maximum iterations": 9000}
    return deck


def dryrun_deck() -> dict:
    """The deck of calibr8_tpu's multi-device dry run
    (__graft_entry__.py:29-65,97-130): notch2D h=0.015, small_J2, 2 load
    steps, Newton at 15 iterations, the default linear algebra."""
    deck = _deck({"type": "notch2D", "h": 0.015}, "small_J2", J2_MAT, bcs_2d(0.001), 2)
    deck["residuals"]["global residual"]["nonlinear max iters"] = 15
    deck["residuals"]["local residual"]["nonlinear max iters"] = 200
    return deck


def mg_cube_deck(reuse: str = "none") -> dict:
    """The bench deck on cube n=4 refined 3 times (196,608 tets, the
    bench's scale; nodes 125 / 729 / 4,913 / 35,937 down the chain),
    GMRES with the recursive geometric multigrid (u and p chains), the
    hierarchy rebuilt per solve (`none`) or once per load step (`step`)."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(4)
    deck["discretization"]["builtin mesh"]["refinements"] = 3
    deck["linear algebra"] = {"method": "gmres", "preconditioner": "multigrid",
                              "preconditioner reuse": reuse}
    return deck


def mg_notch_deck() -> dict:
    """The small_hill_plane_stress twin case (plane_stress_deck) on
    notch2D h=0.032 refined 3 times (2,172 x 64 = 139,008 triangles),
    displacement only, GMRES with the recursive geometric multigrid and
    the default 200-iteration cap."""
    deck = plane_stress_deck(0.032)
    deck["discretization"]["builtin mesh"]["refinements"] = 3
    deck["linear algebra"] = {"method": "gmres", "preconditioner": "multigrid"}
    return deck


def hypo_mg_notch_deck() -> dict:
    """mg_notch_deck() with hypo_hill_plane_stress at its twin case's
    constants (Q a 30-degree rotation) and half the pull (0.005): at the
    twin case's 0.01, over 2 steps or 4 half steps, the local Newton of
    elements at the notch tip diverges in load step 2 or 3, in both
    packages (PERF.md has the runs)."""
    deck = mg_notch_deck()
    deck["dirichlet bcs"] = bcs_2d(0.005)
    lr = deck["residuals"]["local residual"]
    lr["type"] = "hypo_hill_plane_stress"
    lr["materials"] = {"body": dict(HYPO_PS_MAT)}
    return deck


def amg_bench_deck(n: int = 32) -> dict:
    """The bench deck (cube n tets, small_J2, mixed u/p, 2 load steps) with
    `preconditioner: amg`: GMRES with the aggregation AMG (solve/amg.py;
    rigid-mode levels at m = 6, the pressure chain at m = 1) and the
    default linear settings (1e-6, 200 iterations)."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(n)
    deck["linear algebra"] = {"method": "gmres", "preconditioner": "amg"}
    return deck


def amg_plane_stress_deck() -> dict:
    """plane_stress_deck(0.004) (notch2D h=0.004, 139,877 triangles,
    small_hill_plane_stress, displacement only, m = 3) with `preconditioner:
    multigrid` on its unrefined mesh: the aggregation AMG (calibr8_tpu
    problem.py:189-199), the 1000-iteration cap kept."""
    deck = plane_stress_deck(0.004)
    deck["linear algebra"]["preconditioner"] = "multigrid"
    return deck


# name -> (deck, golden QoI, rel tol)   (tests/decks.py PRIMAL_REGRESSIONS)
GOLDENS = {
    "cube_elastic": (
        _deck(
            {"type": "cube", "n": 2}, "elastic",
            {"E": 1000.0, "nu": 0.25, "cte": 1e-3, "delta_T": 10.0},
            {"expression": {
                "bc 1": [0, 0, "xmin", "0.0"],
                "bc 2": [0, 1, "ymin", "0.0"],
                "bc 3": [0, 2, "zmin", "0.0"],
            }},
            1,
        ),
        5.00000000000000184e-3, 1e-6,
    ),
    "notch2D_small_J2": (
        _deck(
            {"type": "notch2D", "h": 0.12}, "small_J2",
            {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0, "cte": 0.0, "delta_T": 0.0},
            {"expression": {
                "bc 1": [0, 0, "xmin", "0.0"],
                "bc 2": [0, 1, "ymin", "0.0"],
                "bc 3": [0, 1, "ymax", "0.001 * t"],
            }},
            8,
        ),
        6.51333502442964264e-03, 1e-8,
    ),
    "notch2D_small_J2_plane_strain": (
        _deck({"type": "notch2D", "h": 0.12}, "small_hill_plane_strain",
              {**VOCE_MAT, "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}, bcs_2d(0.005), 4),
        6.54378838333382e-03, 1e-8,
    ),
    "notch2D_small_J2_plane_stress": (
        _deck({"type": "notch2D", "h": 0.12}, "small_hill_plane_stress",
              {**VOCE_MAT, "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}, bcs_2d(0.005), 4,
              gtype="mechanics_plane_stress"),
        1.14781780968678e-02, 1e-8,
    ),
    "notch_small_J2": (
        _deck({"type": "notch3D", "h": 0.15, "lz": 0.1, "nz": 1}, "small_hill",
              {**VOCE_MAT, **UNIT_R}, bcs_3d(0.001), 4),
        1.42045746802104e-04, 1e-8,
    ),
    "cube_hyper_J2": (
        _deck({"type": "cube", "n": 2}, "hyper_J2", HYPER_MAT, bcs_3d(0.01), 10),
        1.57817536611772440e-2, 1e-4,
    ),
    "cube_hyperelasticity": (
        _deck({"type": "cube", "n": 2}, "hyper_J2", {**HYPER_MAT, "Y": 100000.0},
              bcs_3d(0.001), 4),
        8.34720846455980019e-4, 1e-4,
    ),
    "cube_hyperelasticity_traction": (
        {**_deck({"type": "cube", "n": 2}, "hyper_J2", {**HYPER_MAT, "Y": 100000.0},
                 {"expression": {
                     "bc 1": [0, 0, "ymin", "0.0"],
                     "bc 2": [0, 1, "ymin", "0.0"],
                     "bc 3": [0, 2, "ymin", "0.0"],
                 }}, 4),
         "traction bcs": {"bc 1": [0, "ymax", "0.", "0.1 * t", "0."]}},
        1.64544766180509e-04, 1e-7,
    ),
    "notch2D_hyper_J2_plane_strain": (
        _deck({"type": "notch2D", "h": 0.12}, "hyper_J2_plane_strain",
              {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0, "Y_inf": 0.0, "delta": 0.0},
              bcs_2d(0.001), 8),
        6.52601761728928e-03, 1e-8,
    ),
    "notch2D_hyper_J2_plane_stress": (
        _deck({"type": "notch2D", "h": 0.12}, "hyper_J2_plane_stress",
              {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0, "A": 0.0, "n": 0.0,
               "K": 0.0}, bcs_2d(0.005), 5, gtype="mechanics_plane_stress"),
        1.74207846258545e-02, 1e-8,
    ),
    "notch2D_hypo_J2_plane_strain": (
        _deck({"type": "notch2D", "h": 0.12}, "hypo_hill_plane_strain",
              {**VOCE_MAT, "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}, bcs_2d(0.005), 4),
        6.83687469110848e-03, 1e-8,
    ),
    "notch2D_hypo_J2_plane_stress": (
        _deck({"type": "notch2D", "h": 0.12}, "hypo_hill_plane_stress",
              {**VOCE_MAT, "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0, "Q00": 1.0, "Q01": 0.0,
               "Q10": 0.0, "Q11": 1.0}, bcs_2d(0.005), 4, gtype="mechanics_plane_stress"),
        1.18591896701766e-02, 1e-8,
    ),
    "notch_hypo_J2": (
        _deck({"type": "notch3D", "h": 0.15, "lz": 0.1, "nz": 1}, "hypo_hill",
              {**VOCE_MAT, **UNIT_R}, bcs_3d(0.005), 4),
        7.28241826014197e-04, 1e-8,
    ),
    "notch_small_hosford": (
        _deck({"type": "notch3D", "h": 0.15, "lz": 0.1, "nz": 1}, "small_hosford",
              {"E": 1000.0, "nu": 0.25, "Y": 2.0, "a": 100.0, "K": 0.0, "S": 10.0, "D": 2.0},
              bcs_3d(0.001), 4),
        1.39554129894319e-04, 1e-8,
    ),
    "notch_hypo_barlat": (
        _deck({"type": "notch3D", "h": 0.15, "lz": 0.1, "nz": 1}, "hypo_barlat", {
            "E": 70e3, "nu": 0.3, "Y": 200.0, "a": 8.0, "K": 0.0, "S": 200.0, "D": 20.0,
            "sp_01": 1.241024, "sp_02": 1.078271, "sp_10": 1.216463, "sp_12": 1.223867,
            "sp_20": 1.093105, "sp_21": 0.889161, "sp_33": 0.501909, "sp_44": 0.557173,
            "sp_55": 1.349094,
            "dp_01": 0.775366, "dp_02": 0.922743, "dp_10": 0.765487, "dp_12": 0.793356,
            "dp_20": 0.918689, "dp_21": 1.027625, "dp_33": 1.115833, "dp_44": 1.112273,
            "dp_55": 0.589787}, bcs_3d(0.01), 4),
        1.31426770394029e-03, 1e-8,
    ),
}

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    # kernel 1a: the line carries the bench deck's small_J2 figures and, in
    # its `isotropic_elastic` entry, the displacement-only rows' at cube n=32
    "fused_assembly": ("calibr8_tpu_torch/csrc/fused_assembly.cu",
                       "calibr8_tpu/fem/pallas_assembly.py:496"),
    # the kernels line carries its figures at cube n=32 hyper_J2 and, in
    # its `hypo_hill` entry, at cube n=32 hypo_hill (the Hill twins' and
    # the plane twins' are in the phase-2 records)
    "implicit_assembly": ("calibr8_tpu_torch/csrc/implicit_assembly.cu",
                          "calibr8_tpu/fem/pallas_assembly.py:496"),
    # kernel 1b's eigensolver twins: the line carries cube n=32
    # small_hosford's figures and, in entries named by model, each Hosford
    # twin's launches, figures, bounds and ptxas report; implicit_barlat's,
    # cube n=32 hypo_barlat's
    "implicit_eig": ("calibr8_tpu_torch/csrc/implicit_eig.cu",
                     "calibr8_tpu/fem/pallas_assembly.py:496"),
    "implicit_barlat": ("calibr8_tpu_torch/csrc/implicit_barlat.cu",
                        "calibr8_tpu/fem/pallas_assembly.py:496"),
    # kernel 1b's hybrid (the embedded network): notch2D h=0.004
    "implicit_hybrid": ("calibr8_tpu_torch/csrc/implicit_hybrid.cu",
                        "calibr8_tpu/fem/pallas_assembly.py:496"),
    "ebe_matvec": ("calibr8_tpu_torch/csrc/ebe_matvec.cu",
                   "calibr8_tpu/fem/pallas_matvec.py:49"),
    "ell_spmv": ("calibr8_tpu_torch/csrc/ell_spmv.cu",
                 "calibr8_tpu/solve/ellpack.py:491"),
    "ell_spmv_T": ("calibr8_tpu_torch/csrc/ell_spmv_T.cu",
                   "calibr8_tpu/solve/ellpack.py:456"),
    # kernel 3c: the multigrid level apply (LevelEllOperator,
    # ellpack.py:322-409) through the same pallas_call as 3a; the kernels
    # line carries the cube MG deck's fine pressure block (LEVEL_TIMED),
    # the other levels and the transposed instance are in the phase-2
    # records
    "ell_spmv_level": ("calibr8_tpu_torch/csrc/ell_spmv.cu",
                       "calibr8_tpu/solve/ellpack.py:491"),
    # kernel 4: the inverse-trig / float64-loop probe; the kernels line
    # carries its float64 trig record, launches from the probe's own run
    # (calibr8_tpu_torch.probe.run), not a solver path
    "probe": ("calibr8_tpu_torch/csrc/probe.cu",
              "scripts/probe_mosaic_trig.py:51 and scripts/probe_mosaic_f64.py:64"),
    # kernel 1c: the element-level entry of the assembly (null edofs_T, the
    # kernels read pre-gathered element columns; c8_element.cuh elem_dof),
    # launched by the domain-decomposed solver; the line carries cube n=32
    # small_J2's figures (fused_assembly.cu) and, in entries named by case,
    # those of the other four libraries, launches from the dist phases
    "assembly_elems": ("calibr8_tpu_torch/csrc/fused_assembly.cu",
                       "calibr8_tpu/fem/pallas_assembly.py:529-543"),
    # kernel 3c per part: every part's local ELL matrix in one launch of
    # ell_spmv.cu's (m, m) instance; the line carries cube n=32's (4, 4),
    # ndpn 3 and 2 in entries named by case
    "ell_spmv_part": ("calibr8_tpu_torch/csrc/ell_spmv.cu",
                      "calibr8_tpu/solve/ellpack.py:491 via calibr8_tpu/parallel/dist.py:462"),
}
LEVEL_TIMED = "cube MG fine p block (m=1, 35937 nodes)"
ISO_TIMED = "cube n=32 isotropic_elastic"
HYBRID_TIMED = "notch2D h=0.004 hybrid_hyper_J2_plane_stress"
LIMITS = {"float64": 1e-12, "float32": 1e-5}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, rounds: int = 3) -> float:
    """Time of one call: CUDA events around `reps` back-to-back calls,
    divided by `reps`; the median of `rounds` such means.  Back to back,
    the card's queue stays full, so the host's launch overhead does not
    count unless it is longer than the call itself."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return sorted(means)[len(means) // 2]


def device_ms(fn, reps: int, kernel: str | None = None, flush=None) -> float:
    """Device time of one call: under torch.profiler, over `reps`
    back-to-back calls (each after `flush()` where one is given), the
    device time of the kernels whose name holds `kernel` over the launches
    of them that the profile recorded (on the card a profile of 5 launches
    of a 40 ms kernel has held only 1), else of every kernel the calls ran
    over `reps`.  Where the profiler shows no device time at all and no
    flush is given, CUDA events around the replay of a CUDA graph that
    holds the `reps` calls; raises where it shows device time but none of
    a kernel named like `kernel`.  Beside time_ms it splits a call's wall
    into the card's share and the host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    named = [e for e in events if kernel is None or kernel in e.key]
    us = sum(e.self_device_time_total for e in named)
    if us > 0:
        return us / 1e3 / (reps if kernel is None else sum(e.count for e in named))
    if events or flush is not None:
        raise RuntimeError(f"no kernel named like {kernel!r} in the profile of the call: "
                           f"{sorted({e.key for e in events})}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


_NOFMA_RATES = {}


def nofma_rate(dtype) -> float:
    """The card's float64 or float32 operations per second without FMA
    contraction (implicit_cost.nofma_rates: the highest SM clock that
    nvidia-smi reads), read once."""
    if not _NOFMA_RATES:
        from calibr8_tpu_torch.implicit_cost import nofma_rates

        _NOFMA_RATES.update(nofma_rates())
    return _NOFMA_RATES[dtype]


def add_counts(a: dict, b: dict) -> dict:
    """The sum of two launch-count dicts (launch_counts()), key by key;
    a model's key is there only where a run launched it."""
    return {k: a.get(k, 0) + b.get(k, 0) for k in a.keys() | b.keys()}


def launch_counts() -> dict:
    """kernels.launches, with the assembly libraries' launches by model
    (kernels.model_launches) under "<counter>/<model>"."""
    from calibr8_tpu_torch import kernels

    return {**kernels.launches,
            **{f"{c}/{m}": n for (c, m), n in kernels.model_launches.items()}}


def bound(nbytes: float, flops: float, dtype_name: str):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rel_err(a, b):
    d = (a.double() - b.double()).abs().max().item()
    s = b.double().abs().max().item()
    return d / max(s, 1e-300), d


def representative_state(prob, seed=0):
    """bench.py:150-179's deformed state (active plasticity), with a
    random nodal pressure so the pressure terms are exercised too (none
    when the residual is displacement only)."""
    disc = prob.disc
    d = disc.spec.dim
    rng = np.random.default_rng(seed)
    c = disc.mesh.coords
    u = np.stack([(-0.004 if i != 1 else 0.02) * c[:, i] for i in range(d)], axis=1)
    u = u + 1e-4 * rng.standard_normal((disc.n_nodes, d))
    p = rng.standard_normal(disc.n_nodes)
    parts = [u.reshape(-1), p] if disc.spec.mixed else [u.reshape(-1)]
    x = torch.tensor(np.concatenate(parts), dtype=disc.dtype, device=disc.device)
    xi_prev = torch.zeros(disc.n_elem, prob.model.nxi(), dtype=disc.dtype, device=disc.device)
    return x, xi_prev


def phase_kernels(mesh, results):
    """Phase 2, slice-1 kernels: each against its plain version at the
    bench deck's shapes, f32 and f64."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec, ebe_matvec_plain
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.profile_primal import bench_deck
    from calibr8_tpu_torch.solve.ellpack import (
        assemble_ell_T, build_ell_maps, ell_spmv, ell_spmv_plain,
    )

    ok = True
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[1]
        w = 4 if dtype == torch.float32 else 8
        prob = Problem(load_deck(bench_deck(32)), mesh=mesh, device=DEVICE, dtype=dtype)
        disc = prob.disc
        E, nde, n_dofs, d = disc.n_elem, disc.spec.ndofs_elem, disc.n_dofs, disc.spec.dim
        x, xi_prev = representative_state(prob)
        lim = LIMITS[dn]

        # -- kernel 1: fused assembly --
        good, out_k = check_fused(prob, x, xi_prev, results, ("fused_assembly", dn))
        ok &= good
        J_T = out_k[1]

        # -- kernel 2: EBE matvec --
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        v = torch.randn(n_dofs, generator=gen, device=DEVICE, dtype=dtype)
        yk = ebe_matvec(J_T, v, disc.edofs_T, n_dofs)
        yp = ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs)
        torch.cuda.synchronize()
        err, aerr = rel_err(yk, yp)
        ms = time_ms(lambda: ebe_matvec(J_T, v, disc.edofs_T, n_dofs), 30)
        dms = device_ms(lambda: ebe_matvec(J_T, v, disc.edofs_T, n_dofs), 30, "ebe_matvec_kernel")
        pms = time_ms(lambda: ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs), 10)
        J_ef = J_T.permute(2, 0, 1).contiguous()
        idx = disc.edofs

        def lib_ebe():
            ye = torch.bmm(J_ef, v[idx].unsqueeze(-1)).squeeze(-1)
            return torch.zeros(n_dofs, dtype=dtype, device=DEVICE).index_add_(
                0, idx.reshape(-1), ye.reshape(-1))

        lms = time_ms(lib_ebe, 10)
        ldms = device_ms(lib_ebe, 10)
        err_lib = rel_err(lib_ebe(), yp)[0]
        del J_ef
        nbytes = nde * nde * E * w + nde * E * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * nde * nde * E, dn)
        rec = dict(kernel="ebe_matvec", dtype=dn, rel_err=err, max_abs_err=aerr, ms=ms,
                   device_ms=dms, plain_ms=pms, library_ms=lms, library_device_ms=ldms,
                   library_rel_err=err_lib,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if not err <= lim:
            log(f"FAIL ebe_matvec {dn}: rel err {err:.3e} (limit {lim:.0e})")
            ok = False
        results[("ebe_matvec", dn)] = rec

        # -- kernel 3: ELL SpMV --
        A_T = assemble_ell_T(J_T, disc)
        nbr_T = build_ell_maps(disc)["nbr_T"]
        K = A_T.shape[0]
        ndpn = disc.ndpn
        N = disc.n_nodes
        yk = ell_spmv(A_T, nbr_T, v, d)
        yp = ell_spmv_plain(A_T, nbr_T, v, d)
        torch.cuda.synchronize()
        err, aerr = rel_err(yk, yp)
        err_vs_ebe = rel_err(yk, ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs))[0]
        # two calls give the same y bit for bit (no atomics)
        repeat = torch.equal(yk, ell_spmv(A_T, nbr_T, v, d))
        ms = time_ms(lambda: ell_spmv(A_T, nbr_T, v, d), 30)
        dms = device_ms(lambda: ell_spmv(A_T, nbr_T, v, d), 30, "ell_spmv_kernel")
        pms = time_ms(lambda: ell_spmv_plain(A_T, nbr_T, v, d), 10)
        # the same matrix as torch.sparse CSR (built once, not timed)
        csr, nnz_slots = ell_csr(A_T, nbr_T, d, n_dofs)
        lms = time_ms(lambda: torch.mv(csr, v), 30)
        ldms = device_ms(lambda: torch.mv(csr, v), 30)
        err_lib = rel_err(torch.mv(csr, v), yp)[0]
        del csr
        # the A_T blocks of the filled slots (the kernel skips the pad
        # slots'), all of nbr_T and x read once, y written once
        nbytes = nnz_slots * ndpn * ndpn * w + K * N * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * ndpn * ndpn * nnz_slots, dn)
        rec = dict(kernel="ell_spmv", dtype=dn, rel_err=err, max_abs_err=aerr,
                   rel_err_vs_ebe=err_vs_ebe, K=K, filled_slots=nnz_slots, ms=ms,
                   device_ms=dms, plain_ms=pms, library_ms=lms, library_device_ms=ldms,
                   library_rel_err=err_lib, bound_ms=b_ms, bound_by=b_by, limit=lim,
                   repeatable=repeat)
        log(json.dumps(rec))
        if not (err <= lim and repeat):
            log(f"FAIL ell_spmv {dn}: rel err {err:.3e} (limit {lim:.0e}), two calls equal "
                f"{repeat}")
            ok = False
        results[("ell_spmv", dn)] = rec

        # -- kernel 3b: ELL SpMV transposed, and the transposed operator --
        bc_dofs = prob.dbcs.arrays(1.0, 1)[0]
        ok &= check_ell_spmv_T("cube n=32 small_J2", disc, J_T, out_k[1].diagonal(0, 0, 1),
                               bc_dofs, results)
        del prob, disc, J_T, A_T, out_k
        torch.cuda.empty_cache()
    return ok


def elem_inputs(prob, x, x_prev, xi_prev, ctx=None):
    """The arrays the assembly kernels read, in the element-level entry's
    form (assembly_elems' keyword arguments): the Disc's elements gathered
    (ctx None), or the elements of every part of DistContext ctx as the
    dist assembly gathers them, pads included (their local state the
    model's initial one)."""
    disc, bm = prob.disc, prob.assembler.bmodel
    if ctx is None:
        return dict(x_eT=x[disc.edofs].T, xp_eT=None if x_prev is None else x_prev[disc.edofs].T,
                    xi_prev_T=xi_prev.T, gN_T=disc.gN_T, detJ=disc.detJ, h=disc.h,
                    params_all=prob.params0, es_ids=disc.es_ids32)
    init = torch.as_tensor(prob.model.init_xi(), dtype=disc.dtype, device=disc.device)
    xid = ctx.to_dist_elem(xi_prev, fill=init)
    return dict(x_eT=ctx._gather_eT(ctx.to_dist(x)),
                xp_eT=None if x_prev is None else ctx._gather_eT(ctx.to_dist(x_prev)),
                xi_prev_T=xid.reshape(-1, bm.nxi).T, gN_T=ctx.gN_T, detJ=ctx.detJ, h=ctx.h,
                params_all=prob.params0, es_ids=ctx.es32)


def equal_single_device(ctx, out_e, out_s):
    """The element-level entry's outputs on the parts' real elements
    against the single-device entry's on the same elements: (bit for bit
    equal, max |difference| of R, J, xi)."""
    cols = ctx._emask_t
    elems = ctx._esel_t[cols]
    pairs = [(a[..., cols], b[..., elems]) for a, b in zip(out_e, out_s)]
    # NaN lanes (the float32 eigensolver twins') equal where both are NaN
    same = all(bool(((a == b) | (a.isnan() & b.isnan())).all()) for a, b in pairs)
    diff = max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in pairs[:3])
    return same, diff


def check_fused(prob, x, xi_prev, results, key, ctx=None):
    """Kernel 1a (the analytic fused assembly) against its plain version on
    prob's Disc and state, in prob's dtype: errors of R, J and xi over
    max|plain|, path mismatches, time, the plain version's and the bound.
    With a DistContext ctx, the element-level entry (kernel 1c,
    assembly_elems) on the elements of its parts instead, and against the
    single-device entry on the same elements, bit for bit.
    Returns (ok, the kernel's outputs)."""
    from calibr8_tpu_torch.fem.fused_assembly import (
        assembly_elems, assembly_elems_plain, fused_assembly, fused_assembly_plain,
    )

    disc, bm, P = prob.disc, prob.assembler.bmodel, prob.params0
    dn = str(disc.dtype).split(".")[1]
    w = 4 if disc.dtype == torch.float32 else 8
    nde, n_dofs = disc.spec.ndofs_elem, disc.n_dofs
    npe, d, nxi = disc.spec.npe, disc.spec.dim, bm.nxi
    lim = LIMITS[dn]
    if ctx is None:
        E = disc.n_elem

        def kern():
            return fused_assembly(disc, bm, x, xi_prev, P)

        def plain():
            return fused_assembly_plain(disc, bm, x, xi_prev, P)
    else:
        el = elem_inputs(prob, x, None, xi_prev, ctx)
        E = el["x_eT"].shape[1]

        def kern():
            return assembly_elems(disc.spec, bm, **el)

        def plain():
            return assembly_elems_plain(disc.spec, bm, **el)
    out_k = kern()
    out_p = plain()
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("R", "J", "xi"), out_k[:3], out_p[:3]):
        errs[name] = rel_err(a, b)
    path_mism = int((out_k[3] != out_p[3]).sum())
    n_plastic = int(out_p[3].sum())
    worst = max(e[0] for e in errs.values())
    ms = time_ms(kern, 20)
    pms = time_ms(plain, 2, rounds=1)
    # bytes: every input the function needs read once, every output
    # written once (the element-level entry reads the gathered element
    # columns instead of x and edofs_T); h only for the mixed rows'
    # stabilization, xi_prev not for the elastic models, whose local solve
    # sets xi = 0 without it
    reads_xi_prev = bm.name not in ("elastic", "isotropic_elastic")
    nbytes = ((nde * E * w if ctx is not None else n_dofs * w + nde * E * 4)
              + reads_xi_prev * E * nxi * w + npe * d * E * w
              + (1 + disc.spec.mixed) * E * w + P.numel() * w + E * 4 + nde * E * w
              + nde * nde * E * w + nxi * E * w + 2 * E * 4)
    # counted operations: only the Jacobian contraction of the d*d
    # tangents with grad_N (2 flops per multiply-add), a lower bound
    flops = 2.0 * E * nde * npe * d * d
    b_ms, b_by = bound(nbytes, flops, dn)
    good = (worst <= lim and not path_mism
            and all(bool(torch.isfinite(t).all()) for t in out_k[:3]))
    extra = {}
    if ctx is not None:
        def single():
            return fused_assembly(disc, bm, x, xi_prev, P)

        same, diff = equal_single_device(ctx, out_k, single())
        # the single-device entry's time on the same elements, in this call
        extra = dict(parts=ctx.part.n_parts, equal_single_device=same, single_device_diff=diff,
                     single_device_ms=time_ms(single, 20))
        good = good and same
    rec = dict(kernel="fused_assembly" if ctx is None else "assembly_elems", model=bm.name,
               mixed=disc.spec.mixed, nde=nde, dtype=dn, rel_err={k: v[0] for k, v in errs.items()},
               max_abs_err=max(e[1] for e in errs.values()), path_mismatch=path_mism,
               plastic=n_plastic, elements=E, **extra, ms=ms, plain_ms=pms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, limit=lim, ok=good)
    log(json.dumps(rec))
    if not good:
        log(f"FAIL {rec['kernel']} {bm.name} {dn}: rel err {worst:.3e} (limit {lim:.0e}), "
            f"path mismatches {path_mism}, {extra}")
    results[key] = rec
    return good, out_k


def phase_isotropic(mesh, results):
    """Phase 2, kernel 1a's displacement-only rows: the analytic kernel
    with isotropic_elastic at cube n=32 (iso_deck: nde 12, 107,811 dofs)
    against its plain version, float32 and float64, at the bench state;
    then the EBE kernel at nde 12 and both ELL kernels at 3D ndpn 3 on the
    Jacobians it gives (check_operators_at)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    ok = True
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[1]
        prob = Problem(load_deck(iso_deck(32)), mesh=mesh, device=DEVICE, dtype=dtype)
        x, xi_prev = representative_state(prob)
        good, out_k = check_fused(prob, x, xi_prev, results,
                                  ("fused_assembly", ISO_TIMED, dn))
        ok &= good
        ok &= check_operators_at(ISO_TIMED, prob.disc, out_k[1], prob.dbcs.arrays(1.0, 1)[0],
                                 results)
        del prob, out_k
        torch.cuda.empty_cache()
    return ok


def ell_csr(A_T, nbr_T, d: int, n_dofs: int, transpose: bool = False):
    """(torch.sparse CSR of A, or of A^T, from the node-block ELL matrix;
    the number of filled slots)."""
    K, ndpn, _, N = A_T.shape
    nb = nbr_T.long()
    valid = nb < N  # (K, N)
    node = torch.arange(N, device=A_T.device)

    def dof(nodes, j):
        return nodes * d + j if j < d else N * d + nodes

    rows, cols, vals = [], [], []
    for i in range(ndpn):
        for j in range(ndpn):
            rows.append(dof(node[None, :].expand(K, N)[valid], i))
            cols.append(dof(nb[valid], j))
            vals.append(A_T[:, i, j, :][valid])
    rc = [torch.cat(rows), torch.cat(cols)]
    if transpose:
        rc.reverse()
    coo = torch.sparse_coo_tensor(torch.stack(rc), torch.cat(vals), (n_dofs, n_dofs)).coalesce()
    return coo.to_sparse_csr(), int(valid.sum())


def check_ell_spmv_T(label, disc, J_T, diag_e, bc_dofs, results):
    """Kernel 3b against its plain version on disc's shapes (time, bound,
    the torch.sparse CSR mv of A^T as the library yardstick), and the whole
    transposed operator EllOperator(transpose=True), Dirichlet rows
    included, against the forward operator assembled from the transposed
    element blocks.  diag_e (E, nde): the element Jacobians' diagonals."""
    from calibr8_tpu_torch.solve.ellpack import (
        EllOperator, assemble_ell_T, build_ell_maps, ell_spmv_T, ell_spmv_T_plain,
    )

    dn = str(disc.dtype).split(".")[1]
    w = 4 if disc.dtype == torch.float32 else 8
    lim = LIMITS[dn]
    n_dofs, d = disc.n_dofs, disc.spec.dim
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    v = torch.randn(n_dofs, generator=gen, device=DEVICE, dtype=disc.dtype)
    A_T = assemble_ell_T(J_T, disc)
    maps = build_ell_maps(disc)
    nbr_T, tr_T = maps["nbr_T"], maps["tr_T"]
    K, ndpn, _, N = A_T.shape
    yk = ell_spmv_T(A_T, nbr_T, tr_T, v, d)
    yp = ell_spmv_T_plain(A_T, nbr_T, v, d)
    torch.cuda.synchronize()
    err, aerr = rel_err(yk, yp)
    # two calls give the same y bit for bit (a gather, no atomics)
    repeat = torch.equal(yk, ell_spmv_T(A_T, nbr_T, tr_T, v, d))
    ms = time_ms(lambda: ell_spmv_T(A_T, nbr_T, tr_T, v, d), 30)
    dms = device_ms(lambda: ell_spmv_T(A_T, nbr_T, tr_T, v, d), 30, "ell_spmv_T_kernel")
    pms = time_ms(lambda: ell_spmv_T_plain(A_T, nbr_T, v, d), 10)
    csr, nnz_slots = ell_csr(A_T, nbr_T, d, n_dofs, transpose=True)
    lms = time_ms(lambda: torch.mv(csr, v), 30)
    ldms = device_ms(lambda: torch.mv(csr, v), 30)
    err_lib = rel_err(torch.mv(csr, v), yp)[0]
    del csr
    # the A_T blocks of the filled slots (the kernel skips the pad slots'
    # blocks), all of nbr_T and x read once, y written once; tr_T is the
    # gather's overhead, not the function's work
    nbytes = nnz_slots * ndpn * ndpn * w + K * N * 4 + 2 * n_dofs * w
    b_ms, b_by = bound(nbytes, 2.0 * ndpn * ndpn * nnz_slots, dn)
    diag = torch.zeros(n_dofs, dtype=disc.dtype, device=DEVICE).index_add_(
        0, disc.edofs.reshape(-1), diag_e.reshape(-1))
    op_err = rel_err(EllOperator(disc, J_T, diag, bc_dofs, transpose=True)(v),
                     EllOperator(disc, J_T.transpose(0, 1).contiguous(), diag, bc_dofs)(v))[0]
    good = err <= lim and op_err <= lim and repeat
    rec = dict(kernel="ell_spmv_T", case=label, dtype=dn, rel_err=err, max_abs_err=aerr,
               operator_rel_err=op_err, K=K, ndpn=ndpn, filled_slots=nnz_slots, ms=ms,
               device_ms=dms, plain_ms=pms, library_ms=lms, library_device_ms=ldms,
               library_rel_err=err_lib, bound_ms=b_ms, bound_by=b_by, limit=lim,
               repeatable=repeat, ok=good)
    log(json.dumps(rec))
    if not good:
        log(f"FAIL ell_spmv_T {label} {dn}: rel err {err:.3e}, operator {op_err:.3e} "
            f"(limit {lim:.0e}), two calls equal {repeat}")
    results[("ell_spmv_T", label, dn)] = rec
    return good


def partial_yield_state(disc, nxi, scale, seed=0, noise=None):
    """tests/test_torch_implicit.py's state: u_y = scale y^2, u_x =
    -0.3 scale x plus noise of standard deviation `noise` (0.02 scale by
    default; partial yield), a random nodal pressure for mixed specs, and a
    small previous plastic strain (the finite-deformation twins add their
    initial state to it and read it with x_prev, see implicit_inputs)."""
    d = disc.spec.dim
    rng = np.random.default_rng(seed)
    c = disc.mesh.coords
    u = np.zeros((disc.n_nodes, d))
    u[:, 1] = scale * c[:, 1] ** 2
    u[:, 0] = -0.3 * scale * c[:, 0]
    u = u + (0.02 * scale if noise is None else noise) * rng.standard_normal(u.shape)
    parts = [u.reshape(-1)]
    if disc.spec.mixed:
        parts.append(0.5 * rng.standard_normal(disc.n_nodes))
    x = torch.tensor(np.concatenate(parts), dtype=disc.dtype, device=disc.device)
    xi_prev = torch.tensor(1e-4 * np.random.default_rng(seed + 1).standard_normal((disc.n_elem, nxi)),
                           dtype=disc.dtype, device=disc.device)
    return x, xi_prev


def implicit_inputs(prob, scale):
    """(x, x_prev, xi_prev) of the kernel phase on prob's Disc: the
    partly yielded state; for a finite-deformation twin x_prev is the
    same state at half the scale (another seed), and xi_prev is the
    initial state plus the small perturbation, alpha (the last slot) >= 0
    (tests/test_torch_hyper_assembly.py's inputs).  The finite-deformation
    states carry nodal noise of 1% of the median element size in float64
    (the default noise, 10% of an element at notch2D h=0.004, inverts
    elements) and none in float32: with that noise one ill-conditioned
    element (9 local iterations) has a J that differs by 1.2e-4 of max|J|
    between the two float32 versions, float32's reach there, where float64
    agrees to 3e-13 (PERF.md has the runs)."""
    disc, bm = prob.disc, prob.assembler.bmodel
    if not bm.finite_deformation:
        x, xi_prev = partial_yield_state(disc, bm.nxi, scale)
        return x, None, xi_prev
    noise = 0.01 * float(disc.h.double().median()) if disc.dtype == torch.float64 else 0.0
    x, xi_prev = partial_yield_state(disc, bm.nxi, scale, noise=noise)
    x_prev, _ = partial_yield_state(disc, bm.nxi, 0.5 * scale, seed=7, noise=noise)
    xi_prev = xi_prev + torch.as_tensor(prob.model.init_xi(), dtype=disc.dtype, device=disc.device)
    xi_prev[:, -1] = xi_prev[:, -1].abs()
    return x, x_prev, xi_prev


def gauss_flops(n: int, m: int) -> int:
    """Operations of c8::gauss_solve on an n x (n + m) system."""
    return sum(1 + (n + m - k - 1) + 2 * (n - 1) * (n + m - k - 1) for k in range(n))


F32_LOCAL_TOL = 1e-6
# the hyper_J2 family's local residual holds Ie ~ 1 and lambda_z ~ 1, where
# 1e-6 is ~16 float32 ulps: at 1e-6 up to 2% of its elements stop one
# iteration apart in the two versions (PERF.md has the runs); its float32
# check runs at bench.py's 1e-5, and so do the hypo_hill family's and
# hypo_hosford's and hypo_barlat's, and the hybrid's (the hyper plane-stress
# twin with its network).  small_hosford, small strain, takes the
# Hill family's 1e-6: its strain-unit residual carries a float32 error
# that the last local step at 1e-5 passes on to xi, and the two versions'
# R then differ by 3.4e-4 of max|R|; at 1e-6 by 2.7e-5 (PERF.md)
F32_LOCAL_TOL_FINITE = 1e-5
# at most this share of a check's elements may fail their local Newton
MAX_FAILED_SHARE = 1e-4
# Compared: the elements that took the same branch in both versions and
# converged; for the Hill family all of them at these limits.  For the
# finite-deformation twins, the elements whose two local Newtons took the
# same number of iterations are held to these limits, and the others to
# APART_FACTOR times the local tolerance abs_tol: each Newton stops once
# ||C|| < abs_tol, and where ||C|| lands within rounding of abs_tol one
# version takes one more step, which moves xi by up to
# abs_tol / sigma_min(dC/dxi), not by rounding.  Measured (PERF.md):
# 16 abs_tol in float64 (R, notch2D plane stress with nodal noise) and
# 24 abs_tol in float32 (R, the same twin on a smooth state).  At least
# `iters_agree` of the elements must take equal iteration counts.
IMPLICIT_LIMITS = {"float64": dict(xi=1e-12, R=1e-12, J=1e-11, iters_agree=0.9999),
                   "float32": dict(R=1e-4, J=1e-4, path_agree=0.999, iters_agree=0.99)}
APART_FACTOR = 100.0
# The eigensolver twins: near an equal pair of principal values (of the
# Hosford stress, or of either of Barlat's transformed stresses) the
# eigenvectors' tangents amplify rounding.  The column of (A - lam_j I)
# (A - lam_k I) that gives a vector is of size ~g |A|^2 for a relative gap
# g, so its rounding is eps / g of it and that of its tangent eps / g^2,
# and g^2 ~ 1 - |r| (r = det(B / p) / 2).  Measured (PERF.md): an
# element's J differs between the two versions by ~1e-17..2e-16 / (1 - |r|)
# of max|J| in float64.  So each element's J is held to max(the limit
# above, EIG_J_EPS eps / (1 - |r|)), 1 - |r| the least of both versions'
# final states and the first guess, and xi and R to the limits above; the
# elements where that bound is above the limit are counted
# ("ill_conditioned"), and so are those with 1 - |r| <= CLIP_SENSITIVE,
# where the clip of r at 1 - 1e-14 turns on rounding.  In float32 the
# clip's bound rounds to 1: a local Newton iterate whose two principal
# values round equal has r = 1, where acos' is infinite, and its lane turns
# NaN.  Which iterates land there is decided by rounding, so the two
# versions' non-finite lanes differ; they are counted, left out of the
# errors, and must stay under EIG_NONFINITE_SHARE of the elements (float64
# has none: its bound keeps acos' finite).
EIG_J_EPS = 10.0
CLIP_SENSITIVE = 1e-12
EIG_NONFINITE_SHARE = 1e-3


def worst_elements(bm, out_k, out_p, el, spec, iters, iters_p, n=5):
    """The n elements with the largest |J_kernel - J_plain| (over max|J|):
    that error, 1 - |r| in each version, the local counts, the path and
    the condition number of dC/dxi at the plain version's state; `el` the
    element arrays of elem_inputs."""
    from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics
    from calibr8_tpu_torch.models.batched import jvp_columns

    Jk, Jp = out_k[1], out_p[1]
    fin = torch.isfinite(Jk).all(0).all(0) & torch.isfinite(Jp).all(0).all(0)
    err = torch.where(fin, (Jk - Jp).abs().amax((0, 1)), torch.zeros_like(Jk[0, 0]))
    err = err / Jp[..., fin].abs().max()
    idx = err.topk(n).indices
    gN = el["gN_T"][..., idx]
    gu = elem_kinematics(spec, el["x_eT"][:, idx], gN)
    gup = None if el["xp_eT"] is None else elem_kinematics(spec, el["xp_eT"][:, idx], gN)
    parT = el["params_all"][el["es_ids"][idx].long()].T
    xiT, xipT, path = out_p[2][:, idx], el["xi_prev_T"][:, idx], out_p[3][idx]
    _, cols = jvp_columns(lambda z: bm.residual(z, xipT, gu, parT, path, gup), xiT)
    cond = torch.linalg.cond(cols.permute(2, 1, 0).double())
    omr = [eig_one_minus_r(bm, o[2][:, idx], gu, parT) for o in (out_k, out_p)]
    return [dict(elem=int(e), J_err=float(err[e]), one_minus_r=(float(omr[0][i]), float(omr[1][i])),
                 iters=(int(iters[e]), int(iters_p[e])), path=int(path[i]), cond=float(cond[i]))
            for i, e in enumerate(idx.tolist())]


def eig_one_minus_r(bm, xiT, gu, parT):
    """min over the eigendecompositions an eigensolver twin's residual
    runs of 1 - |det(B / p) / 2| (before the clip), per element."""
    from calibr8_tpu_torch.models import batched as tb

    def one(A):
        Bm = tb.t_sub_diag(A, tb.t_trace(A) / 3.0)
        p = torch.sqrt(tb.usum(tb.usum(Bm * Bm, 0), 0) / 6.0 + 1e-24)
        return 1.0 - (tb.t_det(Bm / p) / 2.0).abs()

    if bm.name == "small_hosford":
        return one(bm.dev_cauchy(xiT, gu, parT))
    TC = tb.t_voigt_to_sym(xiT[:6], 3)
    if bm.name == "hypo_hosford":
        return one(TC)
    flat = tb.t_flatten_stress(TC)
    return torch.minimum(*(one(tb.t_unflatten_stress(tb.t_barlat_L_apply(
        tuple(parT[k0 + k] for k in range(9)), flat))) for k0 in (7, 16)))


def compare_implicit(spec, bm, out_k, out_p, iters, iters_p, el):
    """The implicit assembly's outputs out_k (R, J, xi, path, fail) and
    local counts `iters` held against out_p and iters_p, another version's
    on the same elements (`el`, elem_inputs' arrays), to IMPLICIT_LIMITS:
    the elements on the same branch that converged in both compared, the
    finite-deformation and eigensolver twins' elements whose local counts
    differ to APART_FACTOR abs_tol, the eigensolver twins' J per element to
    its conditioning bound (EIG_J_EPS) and their non-finite lanes counted
    (EIG_NONFINITE_SHARE); failed elements under MAX_FAILED_SHARE.
    Returns (ok, record)."""
    from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics

    dn = str(out_p[0].dtype).split(".")[1]
    E = iters.shape[0]
    eig = getattr(bm, "freeze_path", False)
    same_path = out_k[3] == out_p[3]
    agree = float(same_path.double().mean())
    same_iters = iters == iters_p
    iters_agree = float(same_iters.double().mean())
    # A failed element's state is the cap's last iterate, which the
    # primal's Newton never uses (it backtracks on nfail > 0).
    converged = (out_k[4] == 0) & (out_p[4] == 0)
    compared = same_path & converged
    # the twins with tolerance-stopped Newtons of many iterations: the
    # finite-deformation ones and the eigensolver ones (30, line search)
    split = bm.finite_deformation or eig
    apart = compared & ~same_iters if split else torch.zeros_like(compared)
    compared = compared & ~apart
    apart_lim = APART_FACTOR * bm.abs_tol
    # a non-finite output lane is counted, never masked
    nonfinite = [~torch.isfinite(t.reshape(-1, E)).all(0) for t in (*out_k[:3], *out_p[:3])]
    nf_k = nonfinite[0] | nonfinite[1] | nonfinite[2]
    nf_p = nonfinite[3] | nonfinite[4] | nonfinite[5]
    eig_rec = {}
    jlim = None
    if eig:
        gu = elem_kinematics(spec, el["x_eT"], el["gN_T"])
        gup = None if el["xp_eT"] is None else elem_kinematics(spec, el["xp_eT"], el["gN_T"])
        parT = el["params_all"][el["es_ids"].long()].T
        xi0 = bm.first_guess(el["xi_prev_T"], gu, parT, gup)
        omr = torch.fmin(torch.fmin(eig_one_minus_r(bm, out_k[2], gu, parT),
                                    eig_one_minus_r(bm, out_p[2], gu, parT)),
                         eig_one_minus_r(bm, xi0, gu, parT))
        compared = compared & ~nf_k & ~nf_p
        apart = apart & ~nf_k & ~nf_p
        jlim = torch.clamp(EIG_J_EPS * torch.finfo(out_p[0].dtype).eps / omr,
                           min=IMPLICIT_LIMITS[dn]["J"])
        eig_rec = dict(ill_conditioned=int((jlim > IMPLICIT_LIMITS[dn]["J"]).sum()),
                       clip_sensitive=int((omr <= CLIP_SENSITIVE).sum()),
                       min_one_minus_r=float(omr.min()),
                       nonfinite_both=int((nf_k & nf_p).sum()))

    def errors(mask):
        return {name: rel_err(a[..., mask], b[..., mask]) if bool(mask.any()) else (0.0, 0.0)
                for name, a, b in zip(("R", "J", "xi"), out_k[:3], out_p[:3])}

    errs, apart_err = errors(compared), errors(apart)
    fails = (int(out_k[4].sum()), int(out_p[4].sum()))
    lim = IMPLICIT_LIMITS[dn]
    if dn == "float64":
        keys = ("xi", "R", "J")
        ok = agree == 1.0 and bool(torch.equal(out_k[4], out_p[4]))
    else:
        keys = ("R", "J")
        ok = agree >= lim["path_agree"]
    if eig:
        # J element by element against its conditioning bound (against
        # max(APART_FACTOR abs_tol, that bound) where the counts differ)
        Jmax = out_p[1][..., compared | apart].abs().max()
        ratios = []
        for mask, floor in ((compared, lim["J"]), (apart, apart_lim)):
            Jk, Jp = out_k[1][..., mask], out_p[1][..., mask]
            r = (Jk - Jp).abs().amax((0, 1)) / Jmax / torch.clamp(jlim[mask], min=floor)
            ratios.append(float(r.max()) if r.numel() else 0.0)
        eig_rec["J_err_over_limit_max"] = ratios[0]
        eig_rec["J_err_over_limit_max_apart"] = ratios[1]
        ok = ok and max(ratios) <= 1.0
        ok = ok and all(errs[k][0] <= lim[k] for k in keys if k != "J")
        ok = ok and all(apart_err[k][0] <= apart_lim for k in keys if k != "J")
        ok = ok and int((nf_k | nf_p).sum()) <= EIG_NONFINITE_SHARE * E
        ok = ok and (dn == "float32" or not bool((nf_k | nf_p).any()))
    else:
        ok = ok and all(errs[k][0] <= lim[k] and apart_err[k][0] <= apart_lim for k in keys)
    ok = ok and (not split or iters_agree >= lim["iters_agree"])
    ok = ok and max(fails) <= MAX_FAILED_SHARE * E
    if not eig:
        ok = ok and all(bool(torch.isfinite(t[..., converged]).all()) for t in out_k[:3])
    return ok, dict(rel_err={k: v[0] for k, v in errs.items()},
                    max_abs_err=max(e[1] for e in (*errs.values(), *apart_err.values())),
                    nonfinite=(int(nf_k.sum()), int(nf_p.sum())), **eig_rec,
                    path_agree=agree, plastic=int(out_p[3].sum()), elements=E,
                    fail_kernel_plain=fails, compared=int(compared.sum()),
                    iters_agree=iters_agree, iters_apart=int(apart.sum()),
                    rel_err_iters_apart={k: v[0] for k, v in apart_err.items()},
                    limits=dict(lim, apart=apart_lim if split else None))


def check_implicit(label, prob, scale, results, ctx=None):
    """The implicit assembly against its plain version on prob's Disc, in
    prob's dtype; records (and returns) the check.  With a DistContext
    ctx, the element-level entry (kernel 1c, assembly_elems) on the
    elements of its parts instead, and against the single-device entry
    on the same elements, bit for bit."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.fem.fused_assembly import (
        IMPLICIT_LIB, assembly_elems, assembly_elems_plain, fused_assembly_plain,
        implicit_assembly,
    )
    from calibr8_tpu_torch.implicit_cost import FLOPS, ptxas_usage, team_flops
    from calibr8_tpu_torch.implicit_cost import HYBRID_NET as HYBRID_NET_COUNTED
    from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics
    from calibr8_tpu_torch.models.batched import implicit_newton

    disc, bm = prob.disc, prob.assembler.bmodel
    kname = ("assembly_elems" if ctx is not None
             else IMPLICIT_LIB.get(bm.name, ("implicit_assembly",))[0])
    eig = getattr(bm, "freeze_path", False)
    dn = str(disc.dtype).split(".")[1]
    w = 4 if disc.dtype == torch.float32 else 8
    spec = disc.spec
    nde, npe, d, nxi = spec.ndofs_elem, spec.npe, spec.dim, bm.nxi
    x, x_prev, xi_prev = implicit_inputs(prob, scale)
    P = prob.params0
    el = elem_inputs(prob, x, x_prev, xi_prev, ctx)
    E = el["x_eT"].shape[1]

    def kern(iters=None):
        if ctx is None:
            return implicit_assembly(disc, bm, x, xi_prev, P, newton_iters=iters, x_prev=x_prev)
        return assembly_elems(spec, bm, **el, newton_iters=iters)

    def plain(iters=None):
        if ctx is None:
            return fused_assembly_plain(disc, bm, x, xi_prev, P, x_prev=x_prev,
                                        newton_iters=iters)
        return assembly_elems_plain(spec, bm, **el, newton_iters=iters)

    iters = torch.zeros(E, dtype=torch.int32, device=DEVICE)
    iters_p = torch.zeros_like(iters)
    out_k = kern(iters)
    out_p = plain(iters_p)
    torch.cuda.synchronize()
    hist = torch.bincount(iters.long(), minlength=bm.newton_iters + 1).tolist()
    ok, cmp = compare_implicit(spec, bm, out_k, out_p, iters, iters_p, el)
    extra = {}
    if ctx is not None:
        def single():
            return implicit_assembly(disc, bm, x, xi_prev, P, x_prev=x_prev)

        same, diff = equal_single_device(ctx, out_k, single())
        # the single-device entry's time on the same elements, in this call
        extra = dict(parts=ctx.part.n_parts, equal_single_device=same, single_device_diff=diff,
                     single_device_ms=time_ms(single, 10))
        ok = ok and same
    ms = time_ms(kern, 10)
    if bm.name in FLOPS and ctx is None:
        # the team kernel's device time per call (its wall is `ms`)
        extra["device_ms"] = device_ms(kern, 5, "implicit_team_kernel")
    pms = time_ms(plain, 1, rounds=1)
    # bytes: every input read once (x_prev too where the twin reads it, h
    # only for the mixed rows' stabilization; the element-level entry reads
    # the gathered element columns instead of x and edofs_T), every output
    # written once
    n_x = 1 if x_prev is None else 2
    nbytes = ((n_x * nde * E * w if ctx is not None else n_x * disc.n_dofs * w + nde * E * 4)
              + E * nxi * w + npe * d * E * w + (1 + spec.mixed) * E * w + P.numel() * w
              + E * 4 + nde * E * w + nde * nde * E * w + nxi * E * w + 2 * E * 4)
    lib = IMPLICIT_LIB.get(bm.name, ("implicit_assembly",))[0]
    team = {}
    if bm.name in FLOPS:
        # the four libraries of kernel 1b: the operations of
        # c8::implicit_element (implicit_cost.FLOPS, counted on the host)
        # that this run's data needs: A + B per local Newton update and, for
        # the line search, T per trial up to the accepted one (the plain
        # local Newton's count on the same inputs); at PEAK_FLOPS, and, as a
        # figure beside the bound, at the card's rate without FMA.  The
        # hybrid's row holds for the network it was counted at only.
        if bm.name == "hybrid_hyper_J2_plane_stress":
            m = prob.model
            net = {"activation function": m.nn.activation, "topology": list(m.nn.topology),
                   "input scale": m.nn_input_scale, "output scale": m.nn_output_scale}
            if net != HYBRID_NET_COUNTED:
                raise RuntimeError(f"implicit_cost.FLOPS counts the hybrid at "
                                   f"{HYBRID_NET_COUNTED}, this deck's network is {net}")
        trials = 0
        if eig:
            gu = elem_kinematics(spec, el["x_eT"], el["gN_T"])
            gup = None if x_prev is None else elem_kinematics(spec, el["xp_eT"], el["gN_T"])
            n_trials = torch.zeros(E, dtype=torch.int32, device=DEVICE)
            implicit_newton(bm, el["xi_prev_T"], gu, P[el["es_ids"].long()].T, gup,
                            trials=n_trials)
            trials = int(n_trials.sum())
        flops = team_flops(bm.name, hist, trials)
        b_ms, b_by = bound(nbytes, flops, dn)
        team = dict(bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3, flops=flops,
                    flops_ms=flops / PEAK_FLOPS[dn] * 1e3, line_search_trials=trials,
                    flops_nofma_ms=flops / nofma_rate(disc.dtype) * 1e3,
                    ptxas=ptxas_usage(kernels.build_log(lib)).get(f"{dn} {bm.name}"))
    else:
        # operations counted from c8_implicit.cuh, a lower bound: the small
        # solves (one per Newton update this run's data needed, one for the
        # condensation), the condensed rows K and the contraction with
        # grad_N; the dual arithmetic of the residual evaluations is not
        # counted
        ng = d * d
        flops = (sum(i * n for i, n in enumerate(hist)) * gauss_flops(nxi, 1)
                 + E * (gauss_flops(nxi, ng) + 2 * nde * ng * nxi + 2 * nde * npe * d * d))
        b_ms, b_by = bound(nbytes, flops, dn)
    worst = []
    if eig:
        worst = worst_elements(bm, out_k, out_p, el, spec, iters, iters_p)
    rec = dict(kernel=kname, case=label, dtype=dn, **extra, **cmp, worst_J=worst,
               newton_iters_hist=hist, ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, **team, ok=ok)
    log(json.dumps(rec))
    if not ok:
        log(f"FAIL {kname} {label} {dn}")
    results[(kname, label, dn)] = rec
    return ok, out_k[1]


def check_operators_at(label, disc, J_T, bc_dofs, results):
    """The EBE and both ELL kernels against their plain versions on disc's
    shapes (notch2D: displacement only, nde = 6, ndpn = 2, or mixed u/p,
    nde = 9, ndpn = 3), each with its bound and library time; 3b with its
    transposed operator too, as at n=32."""
    from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec, ebe_matvec_plain
    from calibr8_tpu_torch.solve.ellpack import (
        assemble_ell_T, build_ell_maps, ell_spmv, ell_spmv_plain,
    )

    dn = str(disc.dtype).split(".")[1]
    lim = LIMITS[dn]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    v = torch.randn(disc.n_dofs, generator=gen, device=DEVICE, dtype=disc.dtype)
    A_T = assemble_ell_T(J_T, disc)
    nbr_T = build_ell_maps(disc)["nbr_T"]
    d = disc.spec.dim
    w = 4 if disc.dtype == torch.float32 else 8
    K, ndpn, _, N = A_T.shape
    nde, E, n_dofs = disc.spec.ndofs_elem, disc.n_elem, disc.n_dofs
    csr, nnz_slots = ell_csr(A_T, nbr_T, d, n_dofs)
    idx = disc.edofs
    J_ef = J_T.permute(2, 0, 1).contiguous()

    def lib_ebe():
        ye = torch.bmm(J_ef, v[idx].unsqueeze(-1)).squeeze(-1)
        return torch.zeros(n_dofs, dtype=disc.dtype, device=DEVICE).index_add_(
            0, idx.reshape(-1), ye.reshape(-1))

    ok = True
    for name, fk, fp, fl, nbytes, flops in (
        ("ebe_matvec", lambda: ebe_matvec(J_T, v, disc.edofs_T, n_dofs),
         lambda: ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs), lib_ebe,
         nde * nde * E * w + nde * E * 4 + 2 * n_dofs * w, 2.0 * nde * nde * E),
        # ELL bytes: the A_T blocks of the filled slots only, as for 3b
        ("ell_spmv", lambda: ell_spmv(A_T, nbr_T, v, d), lambda: ell_spmv_plain(A_T, nbr_T, v, d),
         lambda: torch.mv(csr, v), nnz_slots * ndpn * ndpn * w + K * N * 4 + 2 * n_dofs * w,
         2.0 * ndpn * ndpn * nnz_slots),
    ):
        yp = fp()
        err, aerr = rel_err(fk(), yp)
        good = err <= lim
        b_ms, b_by = bound(nbytes, flops, dn)
        rec = dict(kernel=name, case=label, dtype=dn, rel_err=err, max_abs_err=aerr,
                   ms=time_ms(fk, 30), device_ms=device_ms(fk, 30, f"{name}_kernel"),
                   plain_ms=time_ms(fp, 10), library_ms=time_ms(fl, 10),
                   library_device_ms=device_ms(fl, 10), library_rel_err=rel_err(fl(), yp)[0],
                   bound_ms=b_ms, bound_by=b_by, ndpn=ndpn, limit=lim, ok=good)
        ok &= good
        log(json.dumps(rec))
        results[(name, label, dn)] = rec
    del A_T, csr, J_ef
    return ok & check_ell_spmv_T(label, disc, J_T, J_T.diagonal(0, 0, 1), bc_dofs, results)


def IMPLICIT_CASES(meshes):
    """(label, deck, mesh, deformation scale) of the implicit kernel's
    checks: the full-width decks of the Hill, hyper_J2, hypo_hill and
    eigensolver families."""
    return (
        ("cube n=32 small_hill", hill_deck(32), meshes["cube32"], 0.02),
        ("notch2D h=0.004 small_hill_plane_stress", plane_stress_deck(0.004), meshes["notch004"],
         0.01),
        ("notch2D h=0.004 small_hill_plane_strain", hill_plane_strain_deck(0.004),
         meshes["notch004"], 0.02),
        ("cube n=32 hyper_J2", hyper_deck(32), meshes["cube32"], 0.02),
        ("notch2D h=0.004 hyper_J2_plane_strain", hyper_plane_strain_deck(0.004),
         meshes["notch004"], 0.02),
        ("notch2D h=0.004 hyper_J2_plane_stress", hyper_plane_stress_deck(0.004),
         meshes["notch004"], 0.01),
        ("cube n=32 hypo_hill", hypo_deck(32), meshes["cube32"], 0.02),
        ("notch2D h=0.004 hypo_hill_plane_strain", hypo_plane_strain_deck(0.004),
         meshes["notch004"], 0.02),
        ("notch2D h=0.004 hypo_hill_plane_stress", hypo_plane_stress_deck(0.004),
         meshes["notch004"], 0.01),
        ("cube n=32 small_hosford", eig_deck("small_hosford", 32), meshes["cube32"], 0.02),
        ("cube n=32 hypo_hosford", eig_deck("hypo_hosford", 32), meshes["cube32"], 0.02),
        ("cube n=32 hypo_barlat", eig_deck("hypo_barlat", 32), meshes["cube32"], 0.02),
        (HYBRID_TIMED, hybrid_deck(0.004), meshes["notch004"], 0.01),
    )


# the cases whose shapes also check the EBE and ELL kernels: ndpn 2
# (displacement only) and ndpn 3 (2D mixed u/p)
OPERATOR_CASES = ("notch2D h=0.004 small_hill_plane_stress", "notch2D h=0.004 hyper_J2_plane_strain")


def deck_in(deck, dtype):
    """A copy of deck for the kernel checks in `dtype`: in float32 the
    implicit twins' local tolerance is raised.  float32 cannot reach the
    decks' local tolerance of 1e-12: converged plastic lanes then flip
    branch on rounding noise until the 16-iteration cap, and the two
    versions end in different states.  At 1e-6 they converge; a lane whose
    ||C|| lands within rounding of the tolerance stops one iteration apart
    in the two, a difference of one step below 1e-6 (at bench.py's float32
    1e-5 that step can exceed this check's limit; PERF.md has the runs)."""
    deck_t = copy.deepcopy(deck)
    if dtype == torch.float32:
        lr = deck_t["residuals"]["local residual"]
        lr["nonlinear absolute tol"] = (F32_LOCAL_TOL_FINITE
                                        if lr["type"].startswith(("hyper", "hypo", "hybrid"))
                                        else F32_LOCAL_TOL)
    return deck_t


def phase_implicit(meshes, results):
    """Phase 2, implicit assembly: the full-width Hill and hyper_J2 decks'
    shapes, float32 and float64, and the EBE / ELL kernels at the notch2D
    shapes (ndpn 2 and 3)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    ok = True
    for label, deck, mesh, scale in IMPLICIT_CASES(meshes):
        for dtype in (torch.float32, torch.float64):
            prob = Problem(load_deck(deck_in(deck, dtype)), mesh=mesh, device=DEVICE, dtype=dtype)
            good, J_T = check_implicit(label, prob, scale, results)
            ok &= good
            if label in OPERATOR_CASES:
                ok &= check_operators_at(label, prob.disc, J_T, prob.dbcs.arrays(1.0, 1)[0],
                                         results)
            del prob, J_T
            torch.cuda.empty_cache()
    return ok and check_hybrid_cap()


# the hybrid's network at the kernel's cap (c8_hybrid.cuh: NN_MAX_HIDDEN
# hidden layers of NN_MAX_WIDTH units), whose layers the kernel keeps in a
# per-thread slab of shared memory; no deck runs such a network, so phase 2
# holds the kernel against its plain version on one, on notch2D h=0.032
HYBRID_CAP_NET = {"activation function": "tanh", "topology": [1, 16, 16, 16, 16, 1],
                  "input scale": 1.0, "output scale": 10.0}


def check_hybrid_cap() -> bool:
    """implicit_hybrid.cu at HYBRID_CAP_NET against its plain version
    (compare_implicit's limits), float32 and float64; logged, not in the
    kernels line."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.fem.fused_assembly import fused_assembly_plain, implicit_assembly
    from calibr8_tpu_torch.problem import Problem

    deck = hybrid_deck(0.032)
    deck["residuals"]["local residual"]["embedded model"] = copy.deepcopy(HYBRID_CAP_NET)
    ok = True
    for dtype in (torch.float32, torch.float64):
        prob = Problem(load_deck(deck_in(deck, dtype)), device=DEVICE, dtype=dtype)
        disc, bm = prob.disc, prob.assembler.bmodel
        x, x_prev, xi_prev = implicit_inputs(prob, 0.01)
        iters = torch.zeros(disc.n_elem, dtype=torch.int32, device=disc.device)
        iters_p = torch.zeros_like(iters)
        out_k = implicit_assembly(disc, bm, x, xi_prev, prob.params0, newton_iters=iters,
                                  x_prev=x_prev)
        out_p = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0, x_prev=x_prev,
                                     newton_iters=iters_p)
        good, cmp = compare_implicit(disc.spec, bm, out_k, out_p, iters, iters_p,
                                     elem_inputs(prob, x, x_prev, xi_prev))
        log(json.dumps(dict(kernel="implicit_hybrid",
                            case=f"notch2D h=0.032 hybrid, network {HYBRID_CAP_NET['topology']}",
                            dtype=str(dtype).split(".")[1], **cmp, ok=good)))
        ok &= good
    return ok


def phase_goldens():
    """Phase 3: goldens on the card in float64."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    cases = [(n, d, g, t) for n, (d, g, t) in GOLDENS.items()]
    notch, gold, tol = GOLDENS["notch2D_small_J2"]
    gm = copy.deepcopy(notch)
    gm["linear algebra"] = {"method": "gmres", "tolerance": 1e-12, "maximum iterations": 400}
    cases.append(("notch2D_small_J2_gmres_ell", gm, gold, tol))
    ok = True
    for name, deck, gold, tol in cases:
        t0 = time.perf_counter()
        prob = Problem(load_deck(copy.deepcopy(deck)), device=DEVICE, dtype=torch.float64)
        J = prob.solve_primal().J
        rel = abs(J - gold) / abs(gold)
        good = rel <= tol
        ok &= good
        log(json.dumps(dict(golden=name, J=J, expected=gold, rel_err=rel, tol=tol,
                            seconds=time.perf_counter() - t0, ok=good)))
    return ok


def phase_full_width(label, deck, mesh, operator, J_ref, needed):
    """Phase 4: one full-width primal solve through the port's entry
    points, float64, with the Krylov operator `operator` ("auto": the
    assembled ELL matrix; "ebe": the matrix-free element-by-element
    apply).  Returns (ok, launch counts of this run alone): ok needs J
    within rel 1e-6 of J_ref and every kernel of `needed` launched."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE, dtype=torch.float64)
    cfg = prob.step_solver.cfg
    cfg.linear = dataclasses.replace(cfg.linear, operator=operator)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = prob.solve_primal()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    J = traj.J
    rel = abs(J - J_ref) / abs(J_ref)
    steps = [dict(step=i + 1, newton_iterations=info["iterations"] - 1,
                  krylov_iterations=info["krylov_iters"], seconds=info["seconds"],
                  J_step=traj.qoi_values[i])
             for i, info in enumerate(traj.newton_info)]
    summ = timers.summary()
    rec = dict(full_width=label, operator=operator, n_elem=prob.disc.n_elem,
               n_dofs=prob.disc.n_dofs, J=J, J_ref=J_ref, rel_err=rel, steps=steps,
               setup_s=setup_s, solve_s=solve_s,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    ok = rel <= 1e-6 and all(counts[k] > 0 for k in needed)
    if not ok:
        log(f"FAIL full width {label} ({operator}): J rel err {rel:.3e} (limit 1e-6), "
            f"launches {counts}")
    return ok, counts


def full_width_runs(meshes):
    """(label, deck, mesh, operator, J reference, kernels the run must
    launch) of phase 4; the EBE run of the bench deck takes 1 load step."""
    from calibr8_tpu_torch.mesh import generators
    from calibr8_tpu_torch.profile_primal import bench_deck

    ebe_deck = bench_deck(32)
    ebe_deck["discretization"]["num steps"] = 1
    return [
        ("cube n=32 small_J2 mixed u/p, 2 steps", bench_deck(32), meshes["cube32"], "auto",
         J_REF_N32, ["fused_assembly", "ell_spmv"]),
        ("cube n=32 small_J2 mixed u/p, 1 step", ebe_deck, meshes["cube32"], "ebe",
         J_REF_N32_STEP1, ["fused_assembly", "ebe_matvec"]),
        ("cube n=32 small_hill mixed u/p, 2 steps", hill_deck(32), meshes["cube32"], "auto",
         J_REF_HILL_N32, ["implicit_assembly", "ell_spmv"]),
        ("notch2D h=0.004 small_hill_plane_stress, 2 steps", plane_stress_deck(0.004),
         meshes["notch004"], "auto", J_REF_PLANE_STRESS_H004, ["implicit_assembly", "ell_spmv"]),
        ("cube n=32 hyper_J2 mixed u/p, 2 steps", hyper_deck(32), meshes["cube32"], "auto",
         J_REF_HYPER_N32, ["implicit_assembly", "ell_spmv"]),
        ("notch2D h=0.004 hyper_J2_plane_stress, 2 steps", hyper_plane_stress_deck(0.004),
         meshes["notch004"], "auto", J_REF_HYPER_PLANE_STRESS_H004,
         ["implicit_assembly", "ell_spmv"]),
        ("cube n=32 hypo_hill mixed u/p, 2 steps", hypo_deck(32), meshes["cube32"], "auto",
         J_REF_HYPO_N32, ["implicit_assembly", "ell_spmv"]),
        ("cube n=32 small_hosford mixed u/p, 2 steps", eig_deck("small_hosford", 32),
         meshes["cube32"], "auto", J_REF_HOSFORD_N32, ["implicit_eig", "ell_spmv"]),
        ("cube n=32 hypo_barlat mixed u/p, 2 steps", eig_deck("hypo_barlat", 32),
         meshes["cube32"], "auto", J_REF_BARLAT_N32, ["implicit_barlat", "ell_spmv"]),
        # 2,916 dofs: solved dense, so no Krylov operator
        ("cube n=8 hypo_hosford mixed u/p, 2 steps", eig_deck("hypo_hosford", 8),
         generators.cube(8), "auto", J_REF_HYPO_HOSFORD_N8, ["implicit_eig"]),
        ("cube n=32 isotropic_elastic displacement only, 2 steps", iso_deck(32),
         meshes["cube32"], "auto", J_REF_ISO_N32, ["fused_assembly", "ell_spmv"]),
        ("notch2D h=0.004 hybrid_hyper_J2_plane_stress, 2 steps", hybrid_deck(0.004),
         meshes["notch004"], "auto", J_REF_HYBRID_H004, ["implicit_hybrid", "ell_spmv"]),
    ]


def mg_runs(meshes):
    """(label, deck, mesh, calibr8_tpu's J, kernels the run must launch) of
    phase 4b: the cube MG deck with the hierarchy rebuilt per solve and
    once per load step, and the notch2D MG deck."""
    return [
        ("cube n=4 refinements 3 small_J2, reuse none", mg_cube_deck("none"), meshes["mg_cube"],
         J_REF_MG_CUBE, ["fused_assembly", "ell_spmv", "ell_spmv_level"]),
        ("cube n=4 refinements 3 small_J2, reuse step", mg_cube_deck("step"), meshes["mg_cube"],
         J_REF_MG_CUBE_STEP, ["fused_assembly", "ell_spmv", "ell_spmv_level"]),
        ("notch2D h=0.032 refinements 3 small_hill_plane_stress", mg_notch_deck(),
         meshes["mg_notch"], J_REF_MG_NOTCH, ["implicit_assembly", "ell_spmv", "ell_spmv_level"]),
        ("notch2D h=0.032 refinements 3 hypo_hill_plane_stress", hypo_mg_notch_deck(),
         meshes["mg_notch"], J_REF_HYPO_MG_NOTCH,
         ["implicit_assembly", "ell_spmv", "ell_spmv_level"]),
    ]


def adjoint_objective(deck, mesh=None, linear_cfg=None):
    """The CLI's `pdeco` objective on the card: (problem, adjoint,
    objective, x0 at the deck's parameters)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    spec = load_deck(copy.deepcopy(deck))
    prob = Problem(spec, mesh=mesh, device=DEVICE, dtype=torch.float64)
    adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, linear_cfg or LinearCfg(),
                  mg_factory=prob.mg_factory)
    active = ActiveParams.from_inverse_spec(spec.inverse, prob.disc.elem_set_names,
                                            prob.model.param_names)
    obj = AdjointObjective(prob, adj, active)
    return prob, adj, obj, active.to_canonical(active.extract(prob.params0))


# the finite-difference checks of phase 5a: label -> (deck with its
# `inverse` sublist); each log10 error drop must exceed 6
def fd_decks():
    notch = copy.deepcopy(GOLDENS["notch2D_small_J2"][0])
    notch["inverse"] = {"materials": {"body": {"E": [800.0, 1200.0], "K": [50.0, 150.0],
                                               "Y": [5.0, 15.0]}}}
    hyper = _deck({"type": "notch2D", "h": 0.12}, "hyper_J2_plane_stress", HYPER_PS_MAT,
                  bcs_2d(0.02), 2, gtype="mechanics_plane_stress")
    hyper["inverse"] = {"materials": {"body": FD_HYPER_ACTIVE}}
    hypo = _deck({"type": "notch2D", "h": 0.12}, "hypo_hill_plane_stress", HYPO_PS_MAT,
                 bcs_2d(0.01), 2, gtype="mechanics_plane_stress")
    hypo["inverse"] = {"materials": {"body": FD_HYPO_ACTIVE}}
    # the hypo deck's Newton at the decks' 1e-8 leaves an error in J that
    # varies smoothly with the parameters: the quotients then level off
    # 1.7e-6 (relative) from dJ/dp for h from 1e-4 to 1e-8 and the drop
    # stays near 5.2 (on the CPU, both packages' gradients alike); at 1e-12
    # it is 7.6 (PERF.md has the runs)
    hypo["residuals"]["global residual"].update({"nonlinear absolute tol": 1e-12,
                                                 "nonlinear relative tol": 1e-12})
    # the eigensolver twins are 3D: small_hosford's check runs on the cube
    # n=3 eig_deck (dense), its Newton at 1e-12 as the hypo deck's
    hosford = eig_deck("small_hosford", 3)
    hosford["inverse"] = {"materials": {"body": FD_HOSFORD_ACTIVE}}
    hosford["residuals"]["global residual"].update({"nonlinear absolute tol": 1e-12,
                                                    "nonlinear relative tol": 1e-12})
    # the hybrid on its twin case (hybrid_twin_deck).  On tests/test_nn_models.py's
    # deck (notch2D h=0.2, 3 steps, Y = 2) J's rounding (~1e-16) meets the
    # quotients' curvature term near h = 1e-6 at every range and pull
    # swept, so its drop is 6 give or take the luck of one quotient
    # (PERF.md)
    return {"notch2D h=0.12 small_J2, 8 steps": notch,
            "notch2D h=0.12 hyper_J2_plane_stress, 2 steps": hyper,
            "notch2D h=0.12 hypo_hill_plane_stress (Q at 30 degrees), 2 steps": hypo,
            "cube n=3 small_hosford, 2 steps": hosford,
            "notch2D h=0.3 hybrid_hyper_J2_plane_stress (twin case), 2 steps":
                hybrid_twin_deck()}


def phase_adjoint_fd(label, deck):
    """Phase 5a: an adjoint deck on the card, the adjoint gradient against
    finite differences, log10 error drop > 6: the notch2D small_J2 8-step
    deck (tests/test_adjoint_gradient.py:55-69) and the hyper_J2_plane_stress
    twin case on the same mesh (fd_decks).

    The quotients at h <= 1e-5 need J to repeat to ~1e-17 between
    nearby parameter points, as it does on the CPU.  On the card the
    atomic adds of index_add_ (the residual's scatter) sum in a new order
    in every solve, and J then varies by ~3e-15, which caps the drop near
    6; so this phase runs with PyTorch's deterministic algorithms, and
    the record lists the operations that had none."""
    import warnings

    from calibr8_tpu_torch.opt.objective import fd_gradient_check

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, _, obj, x0 = adjoint_objective(deck)
            g = obj.gradient(x0)
            drop, errs = fd_gradient_check(obj.value, g, x0, num_steps=11)
    finally:
        torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message).split(".")[0] for w in caught
                               if "deterministic" in str(w.message)})
    ok = bool(np.all(np.isfinite(g)) and np.any(g != 0.0) and drop > 6.0)
    log(json.dumps(dict(adjoint_fd=label, names=obj.active.names,
                        grad=[float(v) for v in g], log10_drop=float(drop),
                        errors=[float(e) for e in errs], limit=6.0,
                        nondeterministic_ops=nondeterministic,
                        seconds=time.perf_counter() - t0, ok=ok)))
    return ok


def phase_adjoint_full_width(name, mesh, g_ref, at_tol=False):
    """Phase 5b/5c: dJ/dp of a full-width deck through the objective's
    entry points (value: the primal; gradient: the backward sweep, whose
    transposed solves run GMRES + block Gauss-Seidel, or the deck's
    multigrid, on the ELL operator, i.e. ell_spmv_T), float64, held at
    1e-5 (max-norm relative) to calibr8_tpu's gradient g_ref; with at_tol
    every transposed solve must reach the adjoint's tolerance, else relres
    <= 0.5 (block GS stops at its cap on these decks, as calibr8_tpu's
    does).  Launch counts are set to 0 just before and read just after.
    Returns (ok, counts)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob, adj, obj, x0 = adjoint_objective(adjoint_deck(name), mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    J = obj.value(x0)
    torch.cuda.synchronize()
    primal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = obj.gradient(x0)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = launch_counts()
    names = obj.active.names
    ref = np.asarray([g_ref[k] for k in names])
    rel = float(np.abs(g - ref).max() / np.abs(ref).max())
    steps = [dict(step=s["step"], relres=s["relres"], krylov_iterations=s["krylov_iters"])
             for s in adj.step_info]
    summ = timers.summary()
    rec = dict(adjoint=name, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs, names=names,
               grad=[float(v) for v in g], grad_ref=ref.tolist(), rel_err=rel, limit=1e-5, J=J,
               relres_limit=adj.linear_cfg.tol if at_tol else 0.5, setup_s=setup_s, primal_s=primal_s, sweep_s=sweep_s, steps=steps,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()
                       if k.startswith("adjoint/")},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    relres_lim = adj.linear_cfg.tol if at_tol else 0.5
    ok = (rel <= 1e-5 and bool(np.all(np.isfinite(g)))
          and all(np.isfinite(s["relres"]) and s["relres"] <= relres_lim for s in steps)
          and counts["ell_spmv_T"] > 0)
    if not ok:
        log(f"FAIL adjoint {name}: gradient rel err {rel:.3e} (limit 1e-5), steps {steps}, "
            f"launches {counts}")
    return ok, counts


def hybrid_twin_deck() -> dict:
    """The hybrid's twin case (calibr8_tpu/models/twin_cases.py:175,
    case_deck): notch2D h=0.3, 2 load steps, pull 0.01, with the `inverse`
    sublist FD_HYBRID_ACTIVE."""
    deck = _deck({"type": "notch2D", "h": 0.3}, "hybrid_hyper_J2_plane_stress",
                 dict(HYBRID_MAT), bcs_2d(0.01), 2, gtype="mechanics_plane_stress")
    deck["residuals"]["local residual"]["embedded model"] = copy.deepcopy(HYBRID_NET)
    deck["inverse"] = {"materials": {"body": dict(FD_HYBRID_ACTIVE)}}
    return deck


def cli_decks() -> dict:
    """The two last models' twin cases (calibr8_tpu/models/twin_cases.py:116,
    175, case_deck): isotropic_elastic on cube n=2 ('mixed formulation:
    false', E and nu active) and hybrid_twin_deck(), each with 'check
    gradient' and 'iteration limit: 0' for the `inverse` CLI."""
    iso = _deck({"type": "cube", "n": 2}, "isotropic_elastic", dict(ISO_MAT), bcs_3d(0.02), 2)
    iso["residuals"]["global residual"]["mixed formulation"] = False
    iso["inverse"] = {"materials": {"body": {"E": [800.0, 1200.0], "nu": [0.2, 0.3]}}}
    hybrid = hybrid_twin_deck()
    for deck in (iso, hybrid):
        deck["inverse"].update({"check gradient": True, "iteration limit": 0})
    return {"cube n=2 isotropic_elastic": iso, "notch2D h=0.3 hybrid_hyper_J2_plane_stress": hybrid}


def phase_cli():
    """Phase 5f: the user's entry points for the two last models, in this
    process: `python -m calibr8_tpu_torch primal DECK` and `inverse DECK`
    (the gradient check) on each of cli_decks(), written as deck files
    (JSON text, which the YAML reader takes) to a temporary directory, on
    the card (the CLI's default device).  ok
    needs exit code 0, a finite J and a log10 error drop > 6; the
    gradient check runs with PyTorch's deterministic algorithms, as phase
    5a does."""
    import contextlib
    import io
    import tempfile

    from calibr8_tpu_torch.cli.main import main as cli_main

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for label, deck in cli_decks().items():
            path = os.path.join(tmp, label.split()[-1] + ".yaml")
            with open(path, "w") as f:
                f.write(json.dumps({"cli": deck}))
            rec = dict(cli=label)
            for cmd in ("primal", "inverse"):
                out = io.StringIO()
                t0 = time.perf_counter()
                if cmd == "inverse":
                    torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    with contextlib.redirect_stdout(out):
                        rc = cli_main([cmd, path])
                finally:
                    torch.use_deterministic_algorithms(False)
                key = "J: " if cmd == "primal" else "gradient check: log10 error drop = "
                vals = [float(ln[len(key):]) for ln in out.getvalue().splitlines()
                        if ln.startswith(key)]
                value = vals[0] if len(vals) == 1 else float("nan")
                rec[cmd] = dict(rc=rc, value=value, seconds=time.perf_counter() - t0)
                ok &= rc == 0 and bool(np.isfinite(value)) and (cmd == "primal" or value > 6.0)
            log(json.dumps(rec))
    if not ok:
        log("FAIL cli: see the records above")
    return ok


# -- phase 5h: FEMU recovery (tests/test_calibration_recovery.py) ------------

FEMU_TRUTH = {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0,
              "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}
# the load plane: the y reaction at the nodes on y = 1
FEMU_PLANE = {"coordinate index": 1, "coordinate value": 1.0, "coordinate tolerance": 1e-6,
              "reaction force component": 1}
FEMU_FULL_ACTIVE = {"materials": {"body": {"Y": [1.0, 3.0], "D": [1.0, 4.0]}}}
FEMU_REF_ACTIVE = {"materials": {"body": {"Y": [1.0, 3.0], "S": [5.0, 15.0], "D": [1.0, 4.0]}}}
# calibr8_tpu's J and canonical dJ/d(Y, D) at the full-width start point,
# each package on its own synthetic data (chip_reference.py femu: JAX 0.9.0
# on the card machine's CPU)
J_REF_FEMU = 0.9603403541073696
G_REF_FEMU = {"body/Y": 2.4011173272817823, "body/D": 1.2145664536077236}


def femu_deck(mesh, materials, qoi, num_steps, pull) -> dict:
    """tests/test_calibration_recovery.py _base_deck: small_hill_plane_stress
    under 'mechanics_plane_stress', pulled at y = 1 by `pull` t."""
    return {
        "discretization": {"builtin mesh": dict(mesh), "num steps": num_steps, "step size": 1.0},
        "residuals": {
            "global residual": {"type": "mechanics_plane_stress", "nonlinear max iters": 30,
                                "nonlinear absolute tol": 1e-8, "nonlinear relative tol": 1e-8},
            "local residual": {"type": "small_hill_plane_stress", **LR_TOL,
                               "materials": {"body": dict(materials)}},
        },
        "dirichlet bcs": bcs_2d(pull),
        "quantity of interest": qoi,
    }


def femu_decks(load_file, mesh, start, num_steps=2, pull=0.005):
    """(synthetic deck, calibration deck): the forward solve at FEMU_TRUTH
    whose `reaction mismatch` QoI writes load_file, and the calibration
    QoI (balance factor 4.22, weights 3.98e7) reading it, from `start`."""
    syn = femu_deck(mesh, FEMU_TRUTH, {"type": "reaction mismatch", **FEMU_PLANE,
                                       "load out file": load_file}, num_steps, pull)
    cal = femu_deck(mesh, {**FEMU_TRUTH, **start},
                    {"type": "calibration", "balance factor": 4.22, **FEMU_PLANE,
                     "displacement weights": [3.98e7, 3.98e7], "load input file": load_file},
                    num_steps, pull)
    return syn, cal


def femu_full_decks(load_file):
    """Phase 5h(a): femu_decks on mg_notch_deck()'s mesh and solver (notch2D
    h=0.032 refined 3 times, GMRES with the recursive geometric
    multigrid), from Y 2.5, D 2.8 (test_femu_recovery_fast)."""
    syn, cal = femu_decks(load_file, {"type": "notch2D", "h": 0.032, "refinements": 3},
                          {"Y": 2.5, "D": 2.8})
    for d in (syn, cal):
        d["linear algebra"] = {"method": "gmres", "preconditioner": "multigrid"}
    return syn, cal


def jit_bench_decks(load_file, solver="jitted"):
    """bench.py's run_calibration decks at its default n=10, float64:
    femu_decks on notch2D h=0.01 (22,445 triangles, 22,838 dofs) from Y
    2.5, D 2.8, the default linear algebra (GMRES(200) + block GS at 1e-6),
    with `solver: jitted` in both global residuals (solver None: the host
    StepSolver)."""
    syn, cal = femu_decks(load_file, {"type": "notch2D", "h": 0.01}, {"Y": 2.5, "D": 2.8})
    if solver is not None:
        for d in (syn, cal):
            d["residuals"]["global residual"]["solver"] = solver
    return syn, cal


class FemuRecorder:
    """An AdjointObjective with each evaluation's record: the primal's and
    the sweep's seconds, each load step's Newton and Krylov iterations, and
    each transposed solve's Krylov iterations and relative residual."""

    def __init__(self, obj, adj):
        self.obj = obj
        self.adj = adj
        self.evals = []

    def value_and_gradient(self, x):
        x = np.asarray(x, dtype=np.float64)
        cached = self.obj._cache_x is not None and np.array_equal(self.obj._cache_x, x)
        t0 = time.perf_counter()
        J = self.obj.value(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = self.obj.gradient(x)
        torch.cuda.synchronize()
        info = [] if cached else self.obj._cache_traj.newton_info
        self.evals.append(dict(
            J=J, primal_s=t1 - t0, adjoint_s=time.perf_counter() - t1, cached_primal=cached,
            newton=[i["iterations"] - 1 for i in info],
            krylov=[int(sum(i["krylov_iters"])) for i in info],
            adjoint_krylov=[s["krylov_iters"] for s in self.adj.step_info],
            adjoint_relres=[s["relres"] for s in self.adj.step_info]))
        return J, g

    def gradient(self, x):
        return self.value_and_gradient(x)[1]

    def summary(self) -> dict:
        ev = self.evals
        n = len(ev)
        primal = [e["primal_s"] for e in ev if not e["cached_primal"]]
        return dict(evaluations=n, primal_solves=len(primal),
                    primal_s_per_eval=sum(primal) / max(len(primal), 1),
                    adjoint_s_per_eval=sum(e["adjoint_s"] for e in ev) / n,
                    newton_iterations=sum(sum(e["newton"]) for e in ev),
                    krylov_iterations=sum(sum(e["krylov"]) for e in ev),
                    adjoint_krylov_iterations=sum(sum(e["adjoint_krylov"]) for e in ev),
                    max_adjoint_relres=max(r for e in ev for r in e["adjoint_relres"]))


def femu_recovered(res) -> dict:
    """{parameter: (recovered value, relative error against FEMU_TRUTH)}."""
    out = {}
    for name, v in zip(res.names, res.params):
        p = name.split("/")[-1]
        out[p] = (float(v), abs(float(v) - FEMU_TRUTH[p]) / FEMU_TRUTH[p])
    return out


def phase_femu_full_width(mesh, j_ref, g_ref):
    """Phase 5h(a): a synthetic calibration at full width, through the
    port's entry points: the forward solve at FEMU_TRUTH (its `reaction
    mismatch` QoI writes load.dat), attach_synthetic, then run_inverse
    (scipy L-BFGS-B, gtol 1e-12, at most 60 iterations) over Y in [1, 3]
    and D in [1, 4] of the calibration QoI's AdjointObjective from Y 2.5,
    D 2.8, on `mesh` (mg_notch_deck's, 139,008 triangles) with the
    multigrid transposed solves.  ok needs Y and D within rel 5e-3 of the
    truth, J and the canonical dJ/dp at the start within rel 1e-6 and 1e-5
    (max-norm) of calibr8_tpu's j_ref / g_ref ({name: dJ/dp}), every
    transposed solve at its tolerance, and implicit_assembly, ell_spmv,
    ell_spmv_T and ell_spmv_level launched.  A diverged forward solve inside the
    optimizer is run_inverse's penalty (counted as failed_forward_solves).
    Returns (ok, launch counts)."""
    import tempfile

    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.io.synthetic import attach_synthetic
    from calibr8_tpu_torch.opt.drivers import run_inverse
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    mesh = copy.copy(mesh)  # the refinement chain, fields of its own
    mesh.fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        syn_deck, cal_deck = femu_full_decks(os.path.join(tmp, "load.dat"))
        t0 = time.perf_counter()
        syn = Problem(load_deck(syn_deck), mesh=mesh, device=DEVICE, dtype=torch.float64)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        traj = syn.solve_primal()
        torch.cuda.synchronize()
        synthetic_s = time.perf_counter() - t0
        attach_synthetic(mesh, syn.disc, traj)
        syn_steps = mg_solve_records(traj)
        syn_counts = launch_counts()
        cal = Problem(load_deck(cal_deck), mesh=mesh, device=DEVICE, dtype=torch.float64)
        adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg(), mg_factory=cal.mg_factory)
        active = ActiveParams.from_inverse_spec(FEMU_FULL_ACTIVE, cal.disc.elem_set_names,
                                                cal.model.param_names)
        obj = FemuRecorder(AdjointObjective(cal, adj, active), adj)
        x0 = active.to_canonical(active.extract(cal.params0))
        t0 = time.perf_counter()
        J0, g0 = obj.value_and_gradient(x0)
        res = run_inverse(obj, active, x0=x0, max_iters=60, gtol=1e-12)
        torch.cuda.synchronize()
        calibration_s = time.perf_counter() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec_params = femu_recovered(res)
    summ = obj.summary()
    n = summ["evaluations"]
    ref = np.asarray([g_ref[k] for k in res.names])
    j_rel = abs(J0 - j_ref) / abs(j_ref)
    g_rel = float(np.abs(g0 - ref).max() / np.abs(ref).max())
    rec = dict(femu="notch2D h=0.032 refinements 3 small_hill_plane_stress",
               n_elem=cal.disc.n_elem, n_dofs=cal.disc.n_dofs, names=res.names,
               recovered={k: v[0] for k, v in rec_params.items()},
               rel_err={k: v[1] for k, v in rec_params.items()}, limit=5e-3,
               J0=J0, grad0=[float(v) for v in g0], J_ref=j_ref, grad_ref=ref.tolist(),
               J0_rel_err=j_rel,
               grad0_rel_err=g_rel, J=res.J, success=res.success, message=res.message,
               failed_forward_solves=res.n_failed, setup_s=setup_s, synthetic_s=synthetic_s,
               synthetic_steps=syn_steps, calibration_s=calibration_s, **summ,
               adjoint_tol=adj.linear_cfg.tol,
               launches_per_eval={k: (v - syn_counts.get(k, 0)) / n for k, v in counts.items()},
               launches=counts, synthetic_launches=syn_counts,
               peak_mem_gb=peak_gb)
    log(json.dumps(rec))
    log(json.dumps(dict(femu_evals=obj.evals)))
    ok = (all(v[1] < 5e-3 for v in rec_params.values())
          and j_rel <= 1e-6 and g_rel <= 1e-5
          and summ["max_adjoint_relres"] <= adj.linear_cfg.tol
          and all(counts.get(k, 0) > 0
                  for k in ("implicit_assembly", "ell_spmv", "ell_spmv_T", "ell_spmv_level")))
    if not ok:
        log("FAIL femu full width: see the record above")
    return ok, counts


def phase_femu_reference():
    """Phase 5h(b): calibr8_tpu's slow test_femu_parameter_recovery through
    the port: notch2D h=0.15, 4 load steps at pull 0.003 t, Y / S / D from
    2.6 / 7 / 3 within FEMU_REF_ACTIVE, gtol 1e-10, with scipy L-BFGS-B (at
    most 150 iterations) and trust-constr (500), each from its own
    objective on the same synthetic data.  ok needs Y, S and D within rel
    1e-3 of the truth for both.  Returns (ok, launch counts)."""
    import tempfile

    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.io.synthetic import attach_synthetic
    from calibr8_tpu_torch.opt.drivers import run_inverse
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    ok = True
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        syn_deck, cal_deck = femu_decks(os.path.join(tmp, "load.dat"),
                                        {"type": "notch2D", "h": 0.15},
                                        {"Y": 2.6, "S": 7.0, "D": 3.0}, num_steps=4, pull=0.003)
        t0 = time.perf_counter()
        syn = Problem(load_deck(syn_deck), device=DEVICE, dtype=torch.float64)
        attach_synthetic(syn.mesh, syn.disc, syn.solve_primal())
        torch.cuda.synchronize()
        rec = dict(femu_reference="notch2D h=0.15 4 steps small_hill_plane_stress",
                   n_elem=syn.disc.n_elem, n_dofs=syn.disc.n_dofs,
                   synthetic_s=time.perf_counter() - t0, limit=1e-3)
        for method, max_iters in (("L-BFGS-B", 150), ("trust-constr", 500)):
            cal = Problem(load_deck(copy.deepcopy(cal_deck)), mesh=syn.mesh, device=DEVICE,
                          dtype=torch.float64)
            adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg())
            active = ActiveParams.from_inverse_spec(FEMU_REF_ACTIVE, cal.disc.elem_set_names,
                                                    cal.model.param_names)
            obj = AdjointObjective(cal, adj, active)
            x0 = active.to_canonical(active.extract(cal.params0))
            t0 = time.perf_counter()
            res = run_inverse(obj, active, x0=x0, method=method, max_iters=max_iters, gtol=1e-10,
                              out_file=os.path.join(tmp, "calibrated_params.txt"))
            torch.cuda.synchronize()
            got = femu_recovered(res)
            rec[method] = dict(recovered={k: v[0] for k, v in got.items()},
                               rel_err={k: v[1] for k, v in got.items()}, J=res.J,
                               evaluations=res.n_evals, failed_forward_solves=res.n_failed,
                               success=res.success, message=res.message,
                               seconds=time.perf_counter() - t0)
            ok &= all(v[1] < 1e-3 for v in got.values())
    counts = launch_counts()
    rec["launches"] = counts
    log(json.dumps(rec))
    ok &= counts.get("implicit_assembly", 0) > 0
    if not ok:
        log("FAIL femu reference configuration: see the record above")
    return ok, counts


def phase_femu_cli():
    """Phase 5h(c): the FEMU path through the CLI, in this process, on the
    card (the CLI's default device), in a temporary directory: `primal`
    (write synthetic; the reaction mismatch QoI writes load.dat) at the
    truth on test_femu_recovery_fast's deck (notch2D h=0.25, 2 steps),
    `perturb` at sigma 0, `inverse` (fields file, iteration limit 60,
    gradient tolerance 1e-12) from Y 2.5, D 2.8, and `objective`.  ok needs
    exit code 0 at every step, calibrated_params.txt within rel 5e-3 of the
    truth, and gradient.dat within 1e-10 of max|g| of the AdjointObjective's
    gradient at the deck's parameters (the card's index_add_ sums are not
    repeatable bit for bit).  Returns (ok, launch counts)."""
    import contextlib
    import io
    import tempfile

    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.cli.main import main as cli_main
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.io.synthetic import load_fields
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    cwd = os.getcwd()
    rec, ok = dict(femu_cli="notch2D h=0.25 2 steps small_hill_plane_stress"), True
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fwd, cal = femu_decks("load.dat", {"type": "notch2D", "h": 0.25},
                                  {"Y": 2.5, "D": 2.8})
            fwd["problem"] = {"name": "fwd", "write synthetic": True}
            cal["discretization"]["fields file"] = "meas.npz"
            cal["inverse"] = {**FEMU_FULL_ACTIVE, "iteration limit": 60,
                              "gradient tolerance": 1e-12}
            for name, deck in (("fwd", fwd), ("cal", cal)):
                with open(f"{name}.yaml", "w") as f:
                    f.write(json.dumps({name: deck}))
            for argv in (["primal", "fwd.yaml"],
                         ["perturb", "fwd_synthetic.npz", "--sigma", "0", "--out", "meas.npz"],
                         ["inverse", "cal.yaml"], ["objective", "cal.yaml"]):
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli_main(argv)
                torch.cuda.synchronize()
                rec[argv[0]] = dict(rc=rc, seconds=time.perf_counter() - t0,
                                    last_line=out.getvalue().strip().splitlines()[-1])
                ok &= rc == 0
            with open("calibrated_params.txt") as f:
                got = {k: float(v) for k, v in (ln.split(": ") for ln in f.read().splitlines())}
            g = np.loadtxt("gradient.dat", ndmin=1)
            counts = launch_counts()
            prob = Problem(load_deck(copy.deepcopy(cal)), device=DEVICE, dtype=torch.float64)
            load_fields(prob.mesh, "meas.npz")
            active = ActiveParams.from_inverse_spec(cal["inverse"], prob.disc.elem_set_names,
                                                    prob.model.param_names)
            obj = AdjointObjective(prob, Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg()),
                                   active)
            g_ref = obj.gradient(active.to_canonical(active.extract(prob.params0)))
        finally:
            os.chdir(cwd)
    rel = {k: abs(v - FEMU_TRUTH[k]) / FEMU_TRUTH[k] for k, v in got.items()}
    g_err = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
    rec.update(recovered=got, rel_err=rel, limit=5e-3, gradient=g.tolist(),
               gradient_ref=g_ref.tolist(), gradient_err=g_err, gradient_limit=1e-10,
               launches=counts)
    log(json.dumps(rec))
    ok &= (sorted(got) == ["D", "Y"] and all(r < 5e-3 for r in rel.values()) and g_err <= 1e-10
           and counts.get("implicit_assembly", 0) > 0)
    if not ok:
        log("FAIL femu cli: see the record above")
    return ok, counts


def check_level_apply(label, A_T, nbr_T, tr_T, m, results, limits=LIMITS):
    """Kernel 3c (the multigrid level apply, LevelEllOperator) against its
    plain version on one level's assembled matrix A_T (K, m, m, n), in
    float64 and (the same matrix rounded) float32, forward, with the
    ell_spmv_T kernel's level instance (through the level's transposed
    slot map tr_T; not where tr_T is None) held the same way; each with
    its time, bound (the filled slots' blocks, nbr_T and the vectors) and
    the torch.sparse CSR mv of the same matrix; both directions also give
    the same y bit for bit in two calls.  `limits`: of max|plain|, by
    dtype name."""
    from calibr8_tpu_torch.solve.ellpack import (
        ell_spmv_T, ell_spmv_T_plain, level_ell_spmv, level_ell_spmv_plain,
    )

    K, _, _, n = A_T.shape
    ok = True
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        w = 4 if dtype == torch.float32 else 8
        lim = limits[dn]
        A = A_T.to(dtype).contiguous()
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        v = torch.randn(n * m, generator=gen, device=DEVICE, dtype=dtype)
        rec = dict(kernel="ell_spmv_level", case=label, dtype=dn, m=m, nodes=n, K=K, limit=lim)
        directions = [("forward", lambda: level_ell_spmv(A, nbr_T, v, m),
                       lambda: level_ell_spmv_plain(A, nbr_T, v, m), "ell_spmv_kernel")]
        if tr_T is not None:
            directions.append(("transposed", lambda: ell_spmv_T(A, nbr_T, tr_T, v, m),
                               lambda: ell_spmv_T_plain(A, nbr_T, v, m), "ell_spmv_T_kernel"))
        for direction, fk, fp, kname in directions:
            yp = fp()
            yk = fk()
            err, aerr = rel_err(yk, yp)
            csr, nnz_slots = ell_csr(A, nbr_T, m, n * m, transpose=direction == "transposed")
            lms = time_ms(lambda: torch.mv(csr, v), 30)
            ldms = device_ms(lambda: torch.mv(csr, v), 30)
            err_lib = rel_err(torch.mv(csr, v), yp)[0]
            del csr
            nbytes = nnz_slots * m * m * w + K * n * 4 + 2 * n * m * w
            b_ms, b_by = bound(nbytes, 2.0 * m * m * nnz_slots, dn)
            good = err <= lim
            r = dict(rel_err=err, max_abs_err=aerr, ms=time_ms(fk, 50),
                     device_ms=device_ms(fk, 50, kname), plain_ms=time_ms(fp, 10), library_ms=lms,
                     library_device_ms=ldms, library_rel_err=err_lib, bound_ms=b_ms,
                     bound_by=b_by, filled_slots=nnz_slots)
            # two calls give the same y bit for bit (no atomics)
            r["repeatable"] = torch.equal(yk, fk())
            good = good and r["repeatable"]
            ok &= good
            rec[direction] = dict(r, ok=good)
        log(json.dumps(rec))
        if not all(rec[d[0]]["ok"] for d in directions):
            log(f"FAIL ell_spmv_level {label} {dn}")
        results[("ell_spmv_level", label, dn)] = rec
    return ok


def phase_level_kernels(meshes, results):
    """Phase 2, kernel 3c: the level matrices of the recursive multigrid
    at the MG decks' shapes, taken from the preconditioner state that
    make_state builds from an assembled Jacobian (a deformed, partly
    plastic state): on the cube MG deck the fine pressure block (m = 1,
    35,937 nodes) and level 1 of both chains (m = 3 and m = 1, 4,913
    nodes); on the notch2D MG deck level 1 (m = 2)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.ellpack import EllOperator, build_ell_maps

    ok = True
    for name, deck, mesh, scale in (("cube MG", mg_cube_deck(), meshes["mg_cube"], 0.02),
                                    ("notch2D MG", mg_notch_deck(), meshes["mg_notch"], 0.01)):
        prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE,
                       dtype=torch.float64)
        disc, mg = prob.disc, prob.mg_factory
        x, x_prev, xi_prev = implicit_inputs(prob, scale)
        _, J_T, diag, _, _, _ = prob.assembler.assemble(x, xi_prev, prob.params0, x_prev=x_prev)
        bc_dofs = prob.dbcs.arrays(1.0, 1)[0]
        st = mg.make_state(J_T, diag, bc_dofs, EllOperator(disc, J_T, diag, bc_dofs))
        lv = mg._pairs[0]["maps"]
        n1 = mg._pairs[0]["n_parent_nodes"]
        cases = [(f"{name} level 1 u (m={disc.spec.dim}, {n1} nodes)",
                  st["u"]["levels"][0]["A_T"], lv, disc.spec.dim)]
        if disc.spec.mixed:
            cases += [(f"{name} level 1 p (m=1, {n1} nodes)", st["p"]["levels"][0]["A_T"], lv, 1),
                      (f"{name} fine p block (m=1, {disc.n_nodes} nodes)", st["p_ell_A_T"],
                       build_ell_maps(disc), 1)]
        for label, A_T, maps, m in cases:
            ok &= check_level_apply(label, A_T, maps["nbr_T"], maps["tr_T"], m, results)
        del prob, disc, mg, st, J_T
        torch.cuda.empty_cache()
    return ok


# the domain-decomposed solver's phases: 8 parts, as calibr8_tpu's tests
# (tests/conftest.py's 8 host devices)
DIST_PARTS = 8


def notch_j2_deck(h: float) -> dict:
    """notch2D at h, small_J2 (2D mixed u/p, ndpn 3), 2 load steps."""
    return _deck({"type": "notch2D", "h": h}, "small_J2", J2_MAT, bcs_2d(0.001), 2)


F32, F64 = torch.float32, torch.float64


def DIST_KERNEL_CASES(meshes):
    """(label, deck, mesh, deformation scale or None for the analytic twins'
    bench state, the dtypes of the element-level entry's check, whether 3c
    per part is held on its Jacobians) of phase 2b: every assembly library
    at the shapes of a full-width deck, the part apply at ndpn 4, 3 and 2.
    notch2D h=0.004 small_J2 gives 3c's ndpn-3 Jacobians in float64 (3c's
    float32 check takes them rounded, as check_level_apply does): its
    float32 state is beyond the float32 limit of check_fused, since grad_u
    from nodal displacements of ~0.02 that differ by ~1e-4 across an
    element keeps ~2.3 fewer digits than the displacements (kernel and
    plain version, in either entry, 3.0e-5 of max|J| apart; PERF.md has
    the run)."""
    return (
        ("cube n=32 small_J2", bench_deck_32(), meshes["cube32"], None, (F32, F64), True),
        ("cube n=32 isotropic_elastic", iso_deck(32), meshes["cube32"], None, (F32, F64), False),
        ("cube n=32 hyper_J2", hyper_deck(32), meshes["cube32"], 0.02, (F32, F64), False),
        ("cube n=32 small_hosford", eig_deck("small_hosford", 32), meshes["cube32"], 0.02,
         (F32, F64), False),
        ("cube n=32 hypo_barlat", eig_deck("hypo_barlat", 32), meshes["cube32"], 0.02, (F32, F64),
         False),
        ("notch2D h=0.004 small_J2", notch_j2_deck(0.004), meshes["notch004"], None, (F64,), True),
        ("notch2D h=0.004 small_hill_plane_stress", plane_stress_deck(0.004), meshes["notch004"],
         0.01, (F32, F64), True),
        (HYBRID_TIMED, hybrid_deck(0.004), meshes["notch004"], 0.01, (F32, F64), False),
    )


def bench_deck_32():
    from calibr8_tpu_torch.profile_primal import bench_deck

    return bench_deck(32)


def check_part_apply(label, ctx, J_T, results):
    """Kernel 3c per part (part_ell_spmv: every part's local ELL matrix in
    one launch) against its plain version on the parts' matrices of the
    element Jacobians J_T, in J_T's dtype, with its time, bound (the
    filled slots' blocks, nbr_T and the vectors) and the torch.sparse CSR
    mv of the same block-diagonal matrix."""
    from calibr8_tpu_torch.solve.ellpack import part_ell_spmv, part_ell_spmv_plain

    dn = str(J_T.dtype).split(".")[1]
    w = 4 if J_T.dtype == torch.float32 else 8
    lim = LIMITS[dn]
    A_T = ctx.ell_assemble(J_T)
    K, m, _, PN = A_T.shape
    nbr_T = ctx.nbr_T
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    x = torch.randn(ctx.part.n_parts, ctx.part.N_loc, m, generator=gen, device=DEVICE,
                    dtype=J_T.dtype)
    yp = part_ell_spmv_plain(A_T, nbr_T, x, m)
    err, aerr = rel_err(part_ell_spmv(A_T, nbr_T, x, m), yp)
    csr, nnz_slots = ell_csr(A_T, nbr_T, m, PN * m)
    xf = x.reshape(-1)
    lms = time_ms(lambda: torch.mv(csr, xf), 30)
    ldms = device_ms(lambda: torch.mv(csr, xf), 30)
    err_lib = rel_err(torch.mv(csr, xf).view_as(yp), yp)[0]
    del csr
    nbytes = nnz_slots * m * m * w + K * PN * 4 + 2 * PN * m * w
    b_ms, b_by = bound(nbytes, 2.0 * m * m * nnz_slots, dn)
    good = err <= lim
    rec = dict(kernel="ell_spmv_part", case=label, dtype=dn, parts=ctx.part.n_parts, m=m, K=K,
               nodes=PN, filled_slots=nnz_slots, rel_err=err, max_abs_err=aerr,
               ms=time_ms(lambda: part_ell_spmv(A_T, nbr_T, x, m), 30),
               device_ms=device_ms(lambda: part_ell_spmv(A_T, nbr_T, x, m), 30, "ell_spmv_kernel"),
               plain_ms=time_ms(lambda: part_ell_spmv_plain(A_T, nbr_T, x, m), 10),
               library_ms=lms, library_device_ms=ldms, library_rel_err=err_lib, bound_ms=b_ms,
               bound_by=b_by, limit=lim, ok=good)
    log(json.dumps(rec))
    if not good:
        log(f"FAIL ell_spmv_part {label} {dn}: rel err {err:.3e} (limit {lim:.0e})")
    results[("ell_spmv_part", label, dn)] = rec
    return good


def phase_dist_kernels(meshes, results):
    """Phase 2, the domain-decomposed solver's kernels at DIST_PARTS parts,
    float32 and float64: the element-level entry (kernel 1c,
    assembly_elems) of each assembly library on the elements the
    DistContext gathers, against its plain version under check_fused /
    check_implicit's rules and against the single-device entry on the
    same elements, bit for bit; 3c per part on the Jacobians it gives at
    ndpn 4, 3 and 2."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.parallel.dist import DistContext
    from calibr8_tpu_torch.problem import Problem

    ok = True
    for label, deck, mesh, scale, dtypes, part_apply in DIST_KERNEL_CASES(meshes):
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            deck_t = copy.deepcopy(deck) if scale is None else deck_in(deck, dtype)
            prob = Problem(load_deck(deck_t), mesh=mesh, device=DEVICE, dtype=dtype)
            t0 = time.perf_counter()
            ctx = DistContext(prob, n_parts=DIST_PARTS)
            log(json.dumps(dict(dist_context=label, dtype=dn, setup_s=time.perf_counter() - t0,
                                **part_sizes(ctx))))
            if scale is None:
                x, xi_prev = representative_state(prob)
                good, out_k = check_fused(prob, x, xi_prev, results,
                                          ("assembly_elems", label, dn), ctx=ctx)
                J_T = out_k[1]
            else:
                good, J_T = check_implicit(label, prob, scale, results, ctx=ctx)
            ok &= good
            if part_apply:
                # in each dtype of 3c's check, from this dtype's Jacobians
                # where the entry ran in it, else rounded
                for dt in ((F32, F64) if dtypes == (F64,) else (dtype,)):
                    ok &= check_part_apply(label, ctx, J_T.to(dt).contiguous(), results)
            del prob, ctx, J_T
            torch.cuda.empty_cache()
    return ok


def part_sizes(ctx) -> dict:
    """Per-part element, owned-node and ghost-node counts of a DistContext."""
    part = ctx.part
    return dict(parts=part.n_parts, E_loc=part.E_loc, N_own=part.N_own, N_loc=part.N_loc,
                H=part.H, K_ell=part.K_ell,
                elements_per_part=(part.elems >= 0).sum(1).tolist(),
                owned_per_part=part.n_own.tolist(),
                ghosts_per_part=(part.local_nodes[:, part.N_own:] >= 0).sum(1).tolist())


# Newton's tolerances of the full-width dist runs.  At the decks' own (1e-8,
# absolute or relative to the first residual) a load step's J is set only
# to ~1e-5: the loosely solved linear systems (GMRES + block GS at its
# cap) make Newton converge linearly, and it stops just under the
# tolerance, so two correct solvers that take other Krylov paths land
# apart by that much (the dist path's J was 8.7e-6 from calibr8_tpu's on
# cube n=32 hyper_J2, 2.5e-7 on the bench deck).  Converged to an absolute
# 1e-11, the port's dist and single-device J agree to 4e-11 / 7e-11 and lie
# 7.2e-7 / 1.4e-7 from calibr8_tpu's (its own Newton error at the decks'
# tolerance; PERF.md has the runs).
DIST_NEWTON_ABS_TOL = 1e-11
DIST_SINGLE_LIMIT = 1e-9


def converged_deck(deck):
    """A copy of deck whose Newton stops at DIST_NEWTON_ABS_TOL, absolute
    only."""
    deck = copy.deepcopy(deck)
    gr = deck["residuals"]["global residual"]
    gr["nonlinear absolute tol"] = DIST_NEWTON_ABS_TOL
    gr["nonlinear relative tol"] = 1e-14
    gr["nonlinear max iters"] = 40
    return deck


def phase_dist_primal(label, deck, mesh, n_parts, J_ref, needed, single=None,
                      single_limit=None):
    """Phase dist: one DistPrimal run through the port's entry points
    (Problem, DistContext, DistPrimal.run) at n_parts parts, float64.
    Returns (ok, launch counts of the run alone, the problem, context and
    trajectory): ok needs J within rel 1e-6 of J_ref (when given), within
    rel `single_limit` of `single` (the port's single-device J of the same
    deck, recorded beside it) when that is given, and every kernel of
    `needed` launched."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.parallel.dist import DistContext, DistPrimal
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.utils import timers

    prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE, dtype=torch.float64)
    t0 = time.perf_counter()
    ctx = DistContext(prob, n_parts=n_parts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = DistPrimal(ctx).run()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    J = float(np.sum(traj["qoi_values"]))
    rel = abs(J - J_ref) / abs(J_ref) if J_ref is not None else None
    steps = [dict(step=i + 1, newton_iterations=info["iterations"] - 1,
                  krylov_iterations=info["krylov_iters"], resid_norm=info["resid_norm"],
                  seconds=info["seconds"], J_step=traj["qoi_values"][i])
             for i, info in enumerate(traj["newton_info"])]
    summ = timers.summary()
    rel_single = None if single is None else abs(J - single) / abs(single)
    rec = dict(dist=label, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs, **part_sizes(ctx),
               J=J, J_ref=J_ref, rel_err=rel, J_single_device=single,
               rel_err_single_device=rel_single, single_device_limit=single_limit,
               steps=steps, context_setup_s=setup_s, solve_s=solve_s,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    ok = ((rel is None or rel <= 1e-6) and (single_limit is None or rel_single <= single_limit)
          and all(counts[k] > 0 for k in needed))
    if not ok:
        log(f"FAIL dist {label}: J rel err {rel} (limit 1e-6), against the single-device J "
            f"{rel_single} (limit {single_limit}), launches {counts}")
    return ok, counts, prob, ctx, traj


def phase_dist_full_width(label, deck, mesh, J_ref, needed):
    """Phase dist: a full-width deck converged to DIST_NEWTON_ABS_TOL,
    first through the port's single-device Problem.solve_primal (a
    reference, not the main path: its launches are not counted), then
    through DistPrimal at DIST_PARTS parts, J within rel 1e-6 of
    calibr8_tpu's J_ref and within DIST_SINGLE_LIMIT of the single-device
    J.  Returns (ok, the dist run's launch counts, the single-device J)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    deck = converged_deck(deck)
    t0 = time.perf_counter()
    traj = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE,
                   dtype=torch.float64).solve_primal()
    torch.cuda.synchronize()
    log(json.dumps(dict(single_device=label.split(",")[0], newton_abs_tol=DIST_NEWTON_ABS_TOL,
                        J=traj.J, J_ref=J_ref, rel_err=abs(traj.J - J_ref) / abs(J_ref),
                        newton_iterations=[i["iterations"] - 1 for i in traj.newton_info],
                        resid_norm=[i["resid_norm"] for i in traj.newton_info],
                        seconds=time.perf_counter() - t0)))
    ok, counts, *_ = phase_dist_primal(label, deck, mesh, DIST_PARTS, J_ref, needed,
                                       single=traj.J, single_limit=DIST_SINGLE_LIMIT)
    return ok, counts, traj.J


def phase_dist_parity(meshes):
    """Phase dist: the dry run's deck (notch2D h=0.015, calibr8_tpu's
    dryrun_multichip) at 5 parts, a count that is not a power of two:
    DistPrimal's x within 1e-10 (max|x| scaled, as tests/test_dist.py
    holds calibr8_tpu) of the port's single-device solve."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    deck = dryrun_deck()
    t0 = time.perf_counter()
    traj0 = Problem(load_deck(copy.deepcopy(deck)), device=DEVICE,
                    dtype=torch.float64).solve_primal()
    single_s = time.perf_counter() - t0
    ok, counts, prob, ctx, traj = phase_dist_primal("notch2D h=0.015 small_J2 (dry run), 5 parts",
                                                    deck, None, 5, None,
                                                    ["assembly_elems", "ell_spmv_part"],
                                                    single=traj0.J)
    x0, x1 = traj0.x[-1], ctx.from_dist(traj["x"][-1])
    scale = float(x0.abs().max())
    err = float((x1 - x0).abs().max())
    good = err <= 1e-10 * max(scale, 1.0)
    log(json.dumps(dict(dist_parity="notch2D h=0.015, 5 parts", x_max_abs_err=err, x_max=scale,
                        limit=1e-10 * max(scale, 1.0), single_device_solve_s=single_s,
                        ok=good)))
    if not good:
        log(f"FAIL dist parity: max |x_dist - x_single| {err:.3e}")
    return ok and good, counts


def phase_dist_adjoint():
    """Phase dist adjoint: calibr8_tpu's large dist test deck
    (dist_adjoint_deck, notch2D h=0.0145 small_J2, GMRES at 1e-13) at
    DIST_PARTS parts through DistPrimal and DistAdjoint: J within rel 1e-6
    of calibr8_tpu's J_REF_DIST, dJ/dp within 1e-8 of max|dJ/dp| of its
    single-device G_REF_DIST, every transposed solve at relres <= 0.5."""
    from calibr8_tpu_torch.parallel.dist import DistAdjoint
    from calibr8_tpu_torch.utils import timers

    ok, counts, prob, ctx, traj = phase_dist_primal(
        "notch2D h=0.0145 small_J2 (adjoint deck)", dist_adjoint_deck(), None, DIST_PARTS,
        J_REF_DIST, ["assembly_elems", "ell_spmv_part"])
    from calibr8_tpu_torch import kernels

    timers.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    adj = DistAdjoint(ctx)
    grad, _ = adj.sweep(traj, prob.params0, prob.time_grid)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = launch_counts()
    g = grad.double().cpu().numpy()
    ref = np.asarray(G_REF_DIST)
    scale = float(np.abs(ref).max())
    err = float(np.abs(g - ref).max()) / scale
    good = err <= 1e-8 and ok
    summ = timers.summary()
    log(json.dumps(dict(dist_adjoint="notch2D h=0.0145 small_J2", parts=DIST_PARTS,
                        grad=g.tolist(), grad_ref=G_REF_DIST, rel_err=err, limit=1e-8,
                        steps=adj.step_info, sweep_s=sweep_s,
                        phases={k: dict(count=v["count"], total_s=v["total"])
                                for k, v in summ.items()},
                        launches=sweep_counts, ok=good)))
    if not good:
        log(f"FAIL dist adjoint: dJ/dp rel err {err:.3e} (limit 1e-8)")
    counts = {k: counts.get(k, 0) + v for k, v in sweep_counts.items()}
    return good, counts


def dist_overhead(mesh):
    """bench.py:1096-1150's figure: seconds per GMRES iteration of an
    unpreconditioned GMRES(30) cycle with no early exit (so every
    iteration does the same work but for the operator) with the
    single-device ELL operator, and with the dist per-part ELL apply and
    its halo exchange at 1 and DIST_PARTS parts, on the bench deck's
    Jacobians at its representative state.  A record, no limit; its
    launches are not the main path's."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.parallel.dist import DistContext
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.ellpack import EllOperator
    from calibr8_tpu_torch.solve.gmres import gmres_cycle

    prob = Problem(load_deck(bench_deck_32()), mesh=mesh, device=DEVICE, dtype=torch.float64)
    x, xi_prev = representative_state(prob)
    R, J_T, diag, _, _, _ = prob.assembler.assemble(x, xi_prev, prob.params0, x_prev=x)
    bc_dofs, bc_vals = prob.dbcs.arrays(1.0, 1)
    m = 30

    def per_iter(op, r):
        gmres_cycle(op, r, m, 0.0)
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            _, _, k = gmres_cycle(op, r, m, 0.0)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) / k
            best = t if best is None else min(best, t)
        return best

    rec = dict(dist_overhead="cube n=32 small_J2", gmres_restart=m,
               single_s_per_iter=per_iter(EllOperator(prob.disc, J_T, diag, bc_dofs), -R))
    for n_parts in (1, DIST_PARTS):
        ctx = DistContext(prob, n_parts=n_parts)
        Rd, J_d, diag_d, _, _, _ = ctx.assemble(ctx.to_dist(x), ctx.to_dist(x),
                                                ctx.to_dist_elem(xi_prev), prob.params0)
        bc_mask, _ = ctx.bc_dist(bc_dofs, bc_vals)
        A_T = ctx.ell_assemble(J_d)
        shape = Rd.shape

        def opd(v, ctx=ctx, A_T=A_T, bc_mask=bc_mask, diag_d=diag_d, shape=shape):
            vd = v.view(shape)
            return torch.where(bc_mask, diag_d * vd, ctx.ell_matvec(A_T, vd)).reshape(-1)

        t = per_iter(opd, -Rd.reshape(-1))
        rec[f"dist_{n_parts}_s_per_iter"] = t
        rec[f"dist_{n_parts}_over_single"] = t / rec["single_s_per_iter"]
        del ctx, J_d, A_T
    log(json.dumps(rec))
    del prob, J_T
    torch.cuda.empty_cache()
    return rec


def phase_probe(results):
    """Kernel 4: the probe's own entry point (calibr8_tpu_torch.probe.run)
    on the card, its launches counted from 0 and its results held to numpy
    (float32 trig within 2e-6, float64 within 4e-15, the three loop forms
    within 1e-12 of numpy's loop and of each other); then the kernel against
    its plain version on the card at the same limits, each with its time,
    its plain version's and its bound.  Returns (ok, launches of the
    probe's run)."""
    from calibr8_tpu_torch import kernels, probe

    dev = torch.device(DEVICE, torch.cuda.current_device())
    kernels.reset_launches()
    records, _ = probe.run(dev)
    torch.cuda.synchronize()
    launches = kernels.launches["probe"]
    ok = launches == 3
    for r in records:
        log(json.dumps(dict(r, launches=launches)))
        ok &= r["ok"]
    a_np, b_np = probe.trig_inputs()
    x = torch.tensor(probe.loop_input(), device=DEVICE)
    for dn, dt in (("float32", torch.float32), ("float64", torch.float64)):
        a = torch.tensor(a_np, dtype=dt, device=DEVICE)
        b = torch.tensor(b_np, dtype=dt, device=DEVICE)
        w = 4 if dt == torch.float32 else 8
        n = a.numel()
        # bytes: a and b read, five results written; operations: the five
        # functions, the square root and 1 - a^2, one each
        b_ms, b_by = bound(7 * n * w, 8 * n, dn)
        err = float((probe.trig(a, b).double() - probe.trig_plain(a, b).double()).abs().max())
        rec = dict(kernel="probe", case="trig", dtype=dn, max_abs_err=err,
                   max_abs_err_numpy=max(records[0 if dn == "float32" else 1]["max_abs_err"].values()),
                   ms=time_ms(lambda: probe.trig(a, b), 100),
                   plain_ms=time_ms(lambda: probe.trig_plain(a, b), 100), library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, limit=probe.LIMITS[dn],
                   ok=err <= probe.LIMITS[dn])
        log(json.dumps(rec))
        ok &= rec["ok"]
        results[("probe", "trig", dn)] = rec
    n = x.numel()
    # bytes: x and the trip counts read, three results written; operations:
    # 8 updates of 4 operations in each of the three forms
    b_ms, b_by = bound(n * (8 + 4 + 3 * 8), 3 * probe.LOOP_ITERS * 4 * n, "float64")
    got, want = probe.loop(x), probe.loop_plain(x)
    err = float((got - want).abs().max())
    rec = dict(kernel="probe", case="loop", dtype="float64", max_abs_err=err,
               forms_apart=float((got[1:] - got[0]).abs().max()),
               ms=time_ms(lambda: probe.loop(x), 100),
               plain_ms=time_ms(lambda: probe.loop_plain(x), 100), library_ms=None,
               bound_ms=b_ms, bound_by=b_by, limit=probe.LIMITS["loop"],
               ok=err <= probe.LIMITS["loop"])
    log(json.dumps(rec))
    ok &= rec["ok"]
    results[("probe", "loop", "float64")] = rec
    if not ok:
        log("FAIL probe: see the records above")
    return ok, launches


def mg_solve_records(traj):
    """Per load step: Newton iterations, and the Krylov iterations and
    final relative residual of each linear solve."""
    return [dict(step=i + 1, newton_iterations=info["iterations"] - 1,
                 krylov_iterations=info["krylov_iters"], relres=info["linear_relres"],
                 seconds=info["seconds"], J_step=traj.qoi_values[i])
            for i, info in enumerate(traj.newton_info)]


def phase_mg_primal(label, deck, mesh, J_ref, needed):
    """Phase 4b: a full-width multigrid primal solve (float64, GMRES + the
    recursive geometric multigrid) through Problem(...).solve_primal().
    Records the hierarchy's host setup, the per-step state build
    (`preconditioner reuse: step`), the per-solve cycle build, the solve
    wall, Newton and Krylov iterations and each solve's relative residual.
    ok needs J within rel 1e-6 of calibr8_tpu's J_ref, every linear solve
    at its tolerance (relres <= tol, not the iteration cap) and every
    kernel of `needed` launched.  Returns (ok, launch counts)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE, dtype=torch.float64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = prob.solve_primal()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    lin = prob.step_solver.cfg.linear
    rel = abs(traj.J - J_ref) / abs(J_ref)
    steps = mg_solve_records(traj)
    relres = [r for s in steps for r in s["relres"]]
    summ = timers.summary()
    iters = sum(k for st in steps for k in st["krylov_iterations"])
    rec = dict(mg_primal=label, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs,
               reuse=lin.precond_reuse, tol=lin.tol, max_iters=lin.max_iters, J=traj.J,
               J_ref=J_ref, rel_err=rel, steps=steps, setup_s=setup_s,
               hierarchy_setup_s=prob.mg_setup_s, solve_s=solve_s,
               s_per_krylov_iteration=krylov_rate(summ, iters),
               amg_hierarchy=(amg_hierarchy(prob) if hasattr(prob.mg_factory, "level_sizes")
                              else None),
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    ok = (rel <= 1e-6 and all(r <= lin.tol for r in relres)
          and all(counts[k] > 0 for k in needed))
    if not ok:
        log(f"FAIL mg primal {label}: J rel err {rel:.3e} (limit 1e-6), relres {relres} "
            f"(tol {lin.tol}), launches {counts}")
    return ok, counts


def phase_mg_adjoint(mesh, g_ref):
    """Phase 5e: dJ/dp of the cube MG deck (adjoint_deck("mg"), E, nu, K, Y
    active) through the objective's entry points, whose transposed solves
    run GMRES with the mirrored multigrid cycle (Adjoint(mg_factory=...)),
    float64: with `preconditioner reuse` none (the CLI's default LinearCfg)
    and step, on the same primal trajectory.  ok needs every transposed
    solve at its tolerance, dJ/dp within 1e-5 (max-norm relative) of
    calibr8_tpu's g_ref, `step` equal to `none` to 1e-9 of max|dJ/dp|, and
    ell_spmv_T and ell_spmv_level launched.  Returns (ok, launch counts)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.opt.objective import AdjointObjective
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob, adj, obj, x0 = adjoint_objective(adjoint_deck("mg"), mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    J = obj.value(x0)
    torch.cuda.synchronize()
    primal_s = time.perf_counter() - t0
    names = obj.active.names
    ref = np.asarray([g_ref[k] for k in names])
    rec = dict(mg_adjoint="cube n=4 refinements 3 small_J2", n_elem=prob.disc.n_elem,
               n_dofs=prob.disc.n_dofs, names=names, J=J, setup_s=setup_s, primal_s=primal_s,
               grad_ref=ref.tolist(), limit=1e-5)
    grads, ok = {}, True
    for reuse in ("none", "step"):
        if reuse == "step":
            adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg(precond_reuse="step"),
                          mg_factory=prob.mg_factory)
            obj2 = AdjointObjective(prob, adj, obj.active)
            obj2._cache_x, obj2._cache_traj = obj._cache_x, obj._cache_traj
        else:
            obj2 = obj
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = obj2.gradient(x0)
        torch.cuda.synchronize()
        grads[reuse] = g
        steps = [dict(step=s["step"], relres=s["relres"], krylov_iterations=s["krylov_iters"])
                 for s in adj.step_info]
        rel = float(np.abs(g - ref).max() / np.abs(ref).max())
        rec[reuse] = dict(grad=[float(v) for v in g], rel_err=rel, steps=steps,
                          sweep_s=time.perf_counter() - t0,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        ok &= (rel <= 1e-5 and bool(np.all(np.isfinite(g)))
               and all(s["relres"] <= adj.linear_cfg.tol for s in steps))
    diff = float(np.abs(grads["step"] - grads["none"]).max() / np.abs(grads["none"]).max())
    counts = launch_counts()
    summ = timers.summary()
    rec.update(step_vs_none=diff, step_vs_none_limit=1e-9, tol=adj.linear_cfg.tol,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               launches=counts)
    log(json.dumps(rec))
    ok &= diff <= 1e-9 and counts["ell_spmv_T"] > 0 and counts["ell_spmv_level"] > 0
    if not ok:
        log("FAIL mg adjoint: see the record above")
    return ok, counts


# -- phase 6: the aggregation AMG ------------------------------------------

AMG_LIMITS = {"float64": 1e-14, "float32": 1e-5}
AMG_DIST_LIMIT = 1e-9
AMG_DIST_GRAD_LIMIT = 1e-8


def amg_hierarchy(prob) -> dict:
    """The aggregation AMG's host setup: seconds, nodes per level (the fine
    mesh first) and each coarse level's ELL width K."""
    f = prob.mg_factory
    return dict(setup_s=prob.mg_setup_s, level_sizes=f.level_sizes,
                K=[lv.K for lv in f.levels], m=f.m)


def krylov_rate(summ, iterations) -> float | None:
    """Seconds per Krylov iteration of the primal's linear solves, the cycle
    builds (mg/make) taken out."""
    if not iterations:
        return None
    solve = summ.get("primal/linear_solve", {}).get("total", 0.0)
    make = summ.get("mg/make", {}).get("total", 0.0)
    return (solve - make) / iterations


def phase_amg_bench(mesh, j_ref, g_ref):
    """Phase 6(a): the bench deck with `preconditioner: amg` (cube n=32,
    196,608 tets, small_J2, mixed u/p: the u chain at m = 6, the p chain
    at m = 1), 2 load steps, through the objective's entry points: J (the
    primal), then dJ/dp (the adjoint, GMRES with the mirrored AMG cycle at
    the adjoint's 1e-8), float64.  ok needs every forward and transposed
    solve at its tolerance, J within rel 1e-6 of calibr8_tpu's j_ref,
    dJ/dp within 1e-5 of max of g_ref, and fused_assembly, ell_spmv,
    ell_spmv_T and ell_spmv_level launched.  Returns (ok, launch counts,
    the problem)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob, adj, obj, x0 = adjoint_objective(adjoint_deck("amg"), mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    J = obj.value(x0)
    torch.cuda.synchronize()
    primal_s = time.perf_counter() - t0
    summ_p = timers.summary()
    timers.reset()
    t0 = time.perf_counter()
    g = obj.gradient(x0)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = launch_counts()
    summ_a = timers.summary()
    lin = prob.step_solver.cfg.linear
    steps = mg_solve_records(obj._cache_traj)
    relres = [r for st in steps for r in st["relres"]]
    iters = sum(k for st in steps for k in st["krylov_iterations"])
    adj_steps = [dict(step=st["step"], relres=st["relres"], krylov_iterations=st["krylov_iters"])
                 for st in adj.step_info]
    names = obj.active.names
    ref = np.asarray([g_ref[k] for k in names])
    rel_g = float(np.abs(g - ref).max() / np.abs(ref).max())
    rel_j = abs(J - j_ref) / abs(j_ref)
    adj_iters = sum(st["krylov_iterations"] for st in adj_steps)
    krylov_a = summ_a.get("adjoint/krylov", {}).get("total", 0.0)
    make_a = summ_a.get("mg/make", {}).get("total", 0.0)
    rec = dict(amg="cube n=32 small_J2 (bench deck), preconditioner amg", n_elem=prob.disc.n_elem,
               n_dofs=prob.disc.n_dofs, hierarchy=amg_hierarchy(prob), setup_s=setup_s,
               tol=lin.tol, max_iters=lin.max_iters, J=J, J_ref=j_ref, rel_err=rel_j,
               J_limit=1e-6, steps=steps, primal_s=primal_s,
               s_per_krylov_iteration=krylov_rate(summ_p, iters), names=names,
               grad=[float(v) for v in g], grad_ref=ref.tolist(), grad_rel_err=rel_g,
               grad_limit=1e-5, adjoint_tol=adj.linear_cfg.tol, adjoint_steps=adj_steps,
               sweep_s=sweep_s,
               adjoint_s_per_krylov_iteration=(krylov_a - make_a) / adj_iters if adj_iters else None,
               phases={k: dict(count=v["count"], total_s=v["total"])
                       for k, v in {**summ_p, **{f"sweep {k}": v for k, v in summ_a.items()}}.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    ok = (rel_j <= 1e-6 and rel_g <= 1e-5 and bool(np.all(np.isfinite(g)))
          and all(r <= lin.tol for r in relres)
          and all(st["relres"] <= adj.linear_cfg.tol for st in adj_steps)
          and all(counts[k] > 0 for k in ("fused_assembly", "ell_spmv", "ell_spmv_T",
                                           "ell_spmv_level")))
    if not ok:
        log("FAIL amg bench deck: see the record above")
    return ok, counts, prob


def check_amg_levels(prob, results):
    """Phase 6(c): kernel 3c's (6, 6) instance (and (1, 1), the pressure
    chain's) against its plain version on the AMG levels that make()
    builds from the bench deck's assembled Jacobian at a deformed, partly
    plastic state: level 1 of both chains and level 2 of the u chain, at
    AMG_LIMITS (float64 1e-14), with check_level_apply's timings, bound and
    CSR mv.  Returns (ok, the records' labels)."""
    from calibr8_tpu_torch.solve.ellpack import EllOperator, assemble_ell_T_blocks
    from calibr8_tpu_torch.solve.mg import fine_u_setup

    disc, f = prob.disc, prob.mg_factory
    x, xi_prev = representative_state(prob)
    _, J_T, diag, _, _, _ = prob.assembler.assemble(x, xi_prev, prob.params0)
    bc_dofs = prob.dbcs.arrays(1.0, 1)[0]
    fu = fine_u_setup(disc, J_T, diag, bc_dofs, EllOperator(disc, J_T, diag, bc_dofs), f.uslots)
    A1 = f.level1_u(fu["J_mask"])
    ps = torch.as_tensor(f.pslots, device=J_T.device)
    n_u = disc.n_dofs_u
    mask_p = torch.where(fu["bc_mask"][n_u:], 0.0, 1.0).to(J_T.dtype)
    m_peT = mask_p[disc.conn].T
    lv1 = f.levels[0]
    A1p = assemble_ell_T_blocks(J_T[ps][:, ps] * m_peT[:, None] * m_peT[None, :], lv1.emap_t,
                                lv1.K, lv1.n, 1)
    cases = [(f"AMG level 1 u (m={f.m}, {lv1.n} nodes)", A1, lv1.nbr_T, f.m),
             (f"AMG level 1 p (m=1, {lv1.n} nodes)", A1p, lv1.nbr_T, 1)]
    if len(f.levels) > 1:
        lv2 = f.levels[1]
        cases.append((f"AMG level 2 u (m={f.m}, {lv2.n} nodes)", f._coarse_galerkin(A1, 1, f.m),
                      lv2.nbr_T, f.m))
    ok = True
    for label, A_T, nbr_T, m in cases:
        ok &= check_level_apply(label, A_T, nbr_T, None, m, results, limits=AMG_LIMITS)
    del J_T, fu
    torch.cuda.empty_cache()
    return ok, [c[0] for c in cases]


def phase_amg_dist(mesh):
    """Phase 6(d): the distributed AMG (parallel/dist_mg.py DistAMG) on the
    bench deck with `preconditioner: amg`, converged to
    DIST_NEWTON_ABS_TOL (converged_deck): the single-device primal, then
    DistPrimal at DIST_PARTS parts, x within AMG_DIST_LIMIT of max|x| and
    J within rel AMG_DIST_LIMIT of the single-device run's; then the
    adjoint, single device and DistAdjoint, both at GMRES 1e-12 (3
    restart cycles more), dJ/dp within AMG_DIST_GRAD_LIMIT of max of the
    single-device one, every transposed solve at its tolerance.
    ell_spmv_part, ell_spmv_level and assembly_elems must be launched in
    the dist runs.  Returns (ok, the dist runs' launch counts)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.parallel.dist import DistAdjoint
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint

    deck = converged_deck(amg_bench_deck())
    t0 = time.perf_counter()
    prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE, dtype=torch.float64)
    traj = prob.solve_primal()
    cfg = dataclasses.replace(prob.step_solver.cfg.linear, tol=1e-12, refine_iters=3)
    adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, cfg, mg_factory=prob.mg_factory)
    g_s, _ = adj.sweep(traj, prob.params0, prob.time_grid)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    ok, counts, dprob, ctx, dtraj = phase_dist_primal(
        "cube n=32 small_J2 (bench deck), preconditioner amg", deck, mesh, DIST_PARTS, None,
        ["assembly_elems", "ell_spmv_part", "ell_spmv_level"], single=traj.J,
        single_limit=AMG_DIST_LIMIT)
    x_s, x_d = traj.x[-1], ctx.from_dist(dtraj["x"][-1])
    x_err = float((x_d - x_s).abs().max() / x_s.abs().max())
    kernels.reset_launches()
    t0 = time.perf_counter()
    dadj = DistAdjoint(ctx, linear_cfg=cfg)
    g_d, _ = dadj.sweep(dtraj, dprob.params0, dprob.time_grid)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = launch_counts()
    g_s, g_d = g_s.double().cpu().numpy(), g_d.double().cpu().numpy()
    g_err = float(np.abs(g_d - g_s).max() / np.abs(g_s).max())
    good = (ok and x_err <= AMG_DIST_LIMIT and g_err <= AMG_DIST_GRAD_LIMIT
            and all(st["relres"] <= cfg.tol for st in dadj.step_info + adj.step_info)
            and sweep_counts["ell_spmv_part"] > 0 and sweep_counts["ell_spmv_level"] > 0)
    log(json.dumps(dict(amg_dist="cube n=32 small_J2 (bench deck), preconditioner amg",
                        parts=DIST_PARTS, newton_abs_tol=DIST_NEWTON_ABS_TOL,
                        x_rel_err=x_err, limit=AMG_DIST_LIMIT, J_single_device=traj.J,
                        single_device_s=single_s, adjoint_tol=cfg.tol,
                        single_device_adjoint_steps=adj.step_info,
                        dist_adjoint_steps=dadj.step_info, grad_single_device=g_s.tolist(),
                        grad_dist=g_d.tolist(), grad_rel_err=g_err,
                        grad_limit=AMG_DIST_GRAD_LIMIT, sweep_s=sweep_s,
                        launches=sweep_counts, ok=good)))
    if not good:
        log("FAIL amg dist: see the records above")
    return good, add_counts(counts, sweep_counts)


def phase_amg(meshes, results):
    """Phase 6, the aggregation AMG (solve/amg.py, parallel/dist_mg.py):
    (a) the bench deck with `preconditioner: amg`, primal and adjoint,
    against calibr8_tpu's AMG run (J_REF_AMG, G_REF_AMG); (b) notch2D
    h=0.004 small_hill_plane_stress with `multigrid` on its unrefined mesh
    (amg_plane_stress_deck), against J_REF_AMG_PLANE_STRESS; (c) kernel
    3c's (6, 6) instance on (a)'s levels; (d) DistAMG at 8 parts against
    the single-device AMG run.  Returns (ok, launch counts of (a), (b) and
    (d), the labels of (c)'s records)."""
    ok, counts, prob = phase_amg_bench(meshes["cube32"], J_REF_AMG, G_REF_AMG)
    log(f"phase amg (a), bench deck: {'ok' if ok else 'FAILED'}")
    if not ok:
        return False, counts, []
    good, labels = check_amg_levels(prob, results)
    log(f"phase amg (c), (6, 6) instance: {'ok' if good else 'FAILED'}")
    del prob
    torch.cuda.empty_cache()
    if not good:
        return False, counts, labels
    good, c = phase_mg_primal("notch2D h=0.004 small_hill_plane_stress, preconditioner "
                              "multigrid without refinements (AMG)", amg_plane_stress_deck(),
                              meshes["notch004"], J_REF_AMG_PLANE_STRESS,
                              ["implicit_assembly", "ell_spmv", "ell_spmv_level"])
    log(f"phase amg (b), plane stress: {'ok' if good else 'FAILED'}")
    counts = add_counts(counts, c)
    if not good:
        return False, counts, labels
    good, c = phase_amg_dist(meshes["cube32"])
    log(f"phase amg (d), DistAMG: {'ok' if good else 'FAILED'}")
    return good, add_counts(counts, c), labels


# calibr8_tpu's jitted run of bench.py's calibration decks (jit_bench_decks)
# at n=10, float64, on the 8-core CPU of the machine with the card
# (chip_reference.py jitted, JAX 0.9.0): the synthetic J (steps
# 1.535244304100571, 1.7920731328364805; 96 s), J and the canonical
# dJ/d(Y, D) at the calibration start, and its L-BFGS-B recovery (663 s)
J_REF_JIT = 3.3273174369370517
J_REF_JIT_START = 0.9581022153098492
G_REF_JIT = {"body/Y": 2.380332066912551, "body/D": 1.208792694142203}
CAL_REF_JIT = {"Y": 1.999999999997733, "D": 1.9999999999853706, "evaluations": 10}
# the same synthetic deck without `solver`, through calibr8_tpu's host
# StepSolver (chip_reference.py jitted_host; steps 1.5352449882917176,
# 1.7920671845182232; 74 s).  It lies 1.6e-6 from J_REF_JIT: the two
# Newton loops (Armijo cubic line search, fixed-budget halving) stop at
# the deck's 1e-8 on different iterates, every GMRES solve at its
# 200-iteration cap in both
J_REF_JIT_HOST = 3.3273121728099406
JIT_LIMITS = dict(J=1e-6, J_start=1e-6, grad_start=1e-5, recovered=5e-3, captured=1e-12,
                  batch=1e-12)
JIT_BATCH = (1.0, 1.05, 0.95)
JIT_LABEL = "notch2D h=0.01 small_hill_plane_stress"
# the __global__ kernel that each counter's wrapper launches, by its name
# in a torch.profiler trace; no other wrapper of these kernels (1b's other
# libraries, 3c's level and part applies) may launch in the profiled step
TRACE_KERNELS = {"implicit_assembly": "implicit_team_kernel", "ell_spmv": "ell_spmv_kernel",
                 "ell_spmv_T": "ell_spmv_T_kernel", "ebe_matvec": "ebe_matvec_kernel"}


def count_syncs(fn):
    """(fn(), the number of synchronizing CUDA calls it made), counted
    with PyTorch's sync debug mode (each .item(), float(), .cpu() of a
    device tensor warns once)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def route_steps(traj) -> list:
    """Per load step of a primal run: Newton iterations, Krylov iterations
    per linear solve, seconds, ms per Newton and per Krylov iteration, and
    (jitted) graph replays and host reads."""
    out = []
    for i, info in enumerate(traj.newton_info):
        newton, kry = info["iterations"] - 1, [int(k) for k in info["krylov_iters"]]
        s = info["seconds"]
        out.append(dict(step=i + 1, newton_iterations=newton, krylov_iterations=kry, seconds=s,
                        ms_per_newton=1e3 * s / max(newton, 1),
                        ms_per_krylov=1e3 * s / max(sum(kry), 1),
                        replays=info.get("replays", 0), host_reads=info.get("host_reads")))
    return out


def traced(fn):
    """fn() under torch.profiler (CUDA activity): (the card's busy ms,
    profile_primal.py's device_intervals; {kernel: device ms}; {counter:
    kernel events of its TRACE_KERNELS name}; all kernel events)."""
    import tempfile

    from calibr8_tpu_torch.profile_primal import device_intervals

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        busy_ms, by_name = device_intervals(path)
        with open(path) as f:
            names = [ev["name"] for ev in json.load(f)["traceEvents"]
                     if ev.get("ph") == "X" and ev.get("cat") == "kernel"]
    finally:
        os.remove(path)
    counts = {c: sum(k in n for n in names) for c, k in TRACE_KERNELS.items()}
    return busy_ms, by_name, counts, len(names)


def profile_step1(prob) -> dict:
    """Load step 1 of `prob` from its initial state, once plain (wall) and
    once under torch.profiler: the card's busy time, the idle share 1 -
    busy / wall, the device time of the eight longest kernels, and the
    launches of the profiled step counted twice: by the wrappers' counters
    (for a replayed graph, its capture's counts times its replays) and by
    the kernel events in the trace.  No counter outside TRACE_KERNELS may
    launch; `trace_match`: the two counts agree for every TRACE_KERNELS
    counter; `trace_within`: no trace count exceeds its counter's.  On the
    H100 a trace can miss some kernels' records, on either route (PERF.md),
    so a trace count is a lower bound of the launches."""
    from calibr8_tpu_torch import kernels

    x0, xi0, _ = prob.primal.initial_state()
    bc_dofs, bc_vals = prob.dbcs.arrays(prob.time_grid.time(1), 1)
    args = (x0, x0, xi0, prob.params0, bc_dofs, bc_vals, prob.disc.zero_x())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.step_solver.solve_at_step(*args, step=1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    busy_ms, by_name, counts, n_events = traced(
        lambda: prob.step_solver.solve_at_step(*args, step=1))
    counted = {k: v for k, v in kernels.launches.items() if v}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    own = set(counted) <= set(TRACE_KERNELS)
    match = own and all(counted.get(c, 0) == n for c, n in counts.items())
    within = own and all(n <= counted.get(c, 0) for c, n in counts.items())
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                device_ms_by_kernel=dict(top), launches_counted=counted,
                launches_traced=counts, kernel_events=n_events, trace_match=match,
                trace_within=within)


def check_captured_head(prob, traj):
    """The captured head graph of prob's JitStepSolver, replayed at load
    step 2's start (x and xi of step 1's solution, step 2's BCs), against
    the plain assembly (fused_assembly_plain, its element residuals and
    diagonals summed with index_add_) on the same inputs: b = -R with the
    Dirichlet rows and the diagonal to IMPLICIT_LIMITS' R (of the element
    residuals' max), the ELL matrix of J_T to its J, xi to its xi, path
    equal.  Returns (ok, record, the kernel's J_T at that state)."""
    from calibr8_tpu_torch.fem.bcs import apply_dbcs_residual
    from calibr8_tpu_torch.fem.fused_assembly import fused_assembly_plain
    from calibr8_tpu_torch.solve.ellpack import assemble_ell_T

    solver, disc, P = prob.step_solver, prob.disc, prob.params0
    prog = solver.prog
    x, xi_prev = traj.x[1], traj.xi[1]
    bc_dofs, bc_vals = prob.dbcs.arrays(prob.time_grid.time(2), 2)
    ext = disc.zero_x()
    prog.load(x, x, xi_prev, P, bc_dofs, bc_vals, ext)
    replays0 = solver.runner.replays[("head",)]
    solver.runner.run(("head",), prog.head)
    R_T, J_T, xi_T, path, fail = fused_assembly_plain(disc, prob.assembler.bmodel, x, xi_prev,
                                                      P, x_prev=x)
    idx = disc.edofs.reshape(-1)
    R = torch.zeros_like(x).index_add_(0, idx, R_T.T.reshape(-1))
    diag = torch.zeros_like(x).index_add_(0, idx, torch.diagonal(J_T, 0, 0, 1).reshape(-1))
    b = -apply_dbcs_residual(R - ext, diag, x, bc_dofs, bc_vals)
    r_max, j_max = float(R_T.abs().max()), float(J_T.abs().max())
    lim = IMPLICIT_LIMITS["float64"]
    errs = dict(
        b=float((prog.lin.b - b).abs().max()) / r_max,
        diag=float((prog.diag - diag).abs().max()) / j_max,
        J=rel_err(prog.lin.op.A_T, assemble_ell_T(J_T, disc))[0],
        xi=rel_err(prog.carry.xi, xi_T.T)[0])
    path_eq = bool(torch.equal(prog.carry.path, path.to(prog.carry.path.dtype)))
    ok = (errs["b"] <= lim["R"] and errs["diag"] <= lim["J"] and errs["J"] <= lim["J"]
          and errs["xi"] <= lim["xi"] and path_eq and int(fail.sum()) == 0
          and solver.runner.replays[("head",)] == replays0 + 1)
    rec = dict(rel_err=errs, path_equal=path_eq, plastic=int(path.sum()), elements=disc.n_elem,
               failed_plain=int(fail.sum()), limits=dict(b=lim["R"], diag=lim["J"], J=lim["J"],
                                                         xi=lim["xi"]), ok=ok)
    J_T_k = prob.assembler.assemble(x, xi_prev, P, x_prev=x)[1]
    return ok, rec, J_T_k


def phase_jitted(mesh):
    """Phase 7, the jitted step solver (solve/jit_newton.py) on bench.py's
    calibration decks at n=10 (jit_bench_decks: notch2D h=0.01, 22,445
    triangles, 22,838 dofs, small_hill_plane_stress, GMRES(200) + block
    GS), float64: (a) the synthetic primal through JitStepSolver and
    through the host StepSolver, each twice (the first jitted run warms up
    and captures), J within 1e-6 of calibr8_tpu's run of the same route
    (J_REF_JIT, J_REF_JIT_HOST; the host route's distance to J_REF_JIT is
    recorded), each route's synchronizing calls counted in a third run; (b) the
    captured step against the uncaptured make_jit_step on step 1's inputs
    (x within 1e-12 of max|x|, path equal), and the launches of (a)'s
    second jitted run equal to each graph's recorded launches times its
    replays, implicit_assembly's and ell_spmv's non-zero; (c) bench.py's
    calibration (L-BFGS-B from Y 2.5, D 2.8, 60 iterations, gtol 1e-12):
    J and dJ/dp at the start within 1e-6 / 1e-5 of calibr8_tpu's, Y and D
    within 5e-3 of the truth; (d) three experiments (params x1, x1.05,
    x0.95) through run_batch, each equal to its own run to 1e-12, the three
    x[-1] apart; (e) the path's kernels at this deck's shapes: the
    captured head against the plain assembly (check_captured_head), 1b
    (check_implicit), 3a, 3b and the EBE (check_operators_at) against
    their plain versions at the phase-2 limits.  Launches against the
    trace: load step 1 of each route under torch.profiler
    (profile_step1), its kernel events of 1b and 3a non-zero and none
    above its counters.  Recorded, no limit: that step's device busy share on
    each route, and one host-route evaluation at the calibration start.  Returns (ok, launch
    counts, {kernel: its (e) record})."""
    import tempfile

    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.io.synthetic import attach_synthetic
    from calibr8_tpu_torch.opt.drivers import run_inverse
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.jit_newton import JitStepSolver, JitTrajectory, make_jit_step
    from calibr8_tpu_torch.solve.linear import LinearCfg

    lim = JIT_LIMITS
    mesh = copy.copy(mesh)  # fields of its own
    mesh.fields = {}
    rec, counts, good = dict(phase="jitted, bench.py run_calibration decks, n=10"), {}, True
    with tempfile.TemporaryDirectory() as tmp:
        load_file = os.path.join(tmp, "load.dat")
        syn_deck, cal_deck = jit_bench_decks(load_file)
        host_deck, _ = jit_bench_decks(load_file, solver=None)
        routes = {}
        for route, deck in (("host", host_deck), ("jitted", syn_deck)):
            prob = Problem(load_deck(copy.deepcopy(deck)), mesh=mesh, device=DEVICE,
                           dtype=torch.float64)
            runs = []
            j_ref = J_REF_JIT if route == "jitted" else J_REF_JIT_HOST
            for _ in range(2):
                runner = getattr(prob.step_solver, "runner", None)
                replays0 = dict(runner.replays) if runner is not None else {}
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                traj = prob.solve_primal()
                torch.cuda.synchronize()
                runner = getattr(prob.step_solver, "runner", None)
                # each graph's replays in this run
                delta = ({k: v - replays0.get(k, 0) for k, v in runner.replays.items()}
                         if runner is not None else {})
                runs.append(dict(seconds=time.perf_counter() - t0, J=traj.J,
                                 replays={"/".join(map(str, k)): v for k, v in delta.items()},
                                 J_rel_err=abs(traj.J - j_ref) / abs(j_ref),
                                 J_rel_err_to_jitted_ref=abs(traj.J - J_REF_JIT) / abs(J_REF_JIT),
                                 steps=route_steps(traj), launches=launch_counts()))
            _, syncs = count_syncs(prob.solve_primal)
            routes[route] = dict(prob=prob, traj=traj)
            rec[route] = dict(runs=runs, syncs_per_step=syncs / len(traj.newton_info),
                              n_dofs=prob.disc.n_dofs, n_elem=prob.disc.n_elem)
            counts = add_counts(counts, runs[-1]["launches"])
            good &= all(r["J_rel_err"] <= lim["J"] for r in runs)
        # the card's busy share of load step 1 on each route (profile_primal.py's
        # measure: the kernel, memcpy and memset intervals of a torch.profiler
        # trace, against the unprofiled wall of the same step)
        for route, r in routes.items():
            rec[route]["step1_profile"] = profile_step1(r["prob"])
        # the trace against the counters, on each route: 1b and 3a in it,
        # no count above its counter's (a trace can miss a kernel's record,
        # never add one); on the jitted route every such kernel is a replay's
        for route in routes:
            prof = rec[route]["step1_profile"]
            good &= (prof["trace_within"] and prof["launches_traced"]["implicit_assembly"] > 0
                     and prof["launches_traced"]["ell_spmv"] > 0)
        # (b) the second jitted run launched through replays alone: each
        # counter equals its graphs' recorded launches times their replays
        jp = routes["jitted"]["prob"]
        assert isinstance(jp.step_solver, JitStepSolver)
        runner = jp.step_solver.runner
        from_replays = runner.launches_from(delta)
        c = rec["jitted"]["runs"][-1]["launches"]
        rec["graphs"] = {"/".join(map(str, k)): dict(launches=r.launches,
                                                     replays=runner.replays[k])
                         for k, r in runner.recorded.items()}
        rec["launches_from_replays"] = from_replays
        replay_ok = (from_replays.get("implicit_assembly", 0) > 0
                     and from_replays.get("ell_spmv", 0) > 0
                     and all(c[k] == from_replays.get(k, 0) for k in kernels.COUNTERS))
        rec["launches_match"] = replay_ok
        # (e) the path's kernels against their plain versions at this deck's
        # shapes: the captured head at load step 2's start against the plain
        # assembly, 1b on the phase-2 state, 3a and 3b (and the EBE) on the
        # kernel's Jacobian at that start
        head_ok, rec["captured_head"], J_T = check_captured_head(jp, routes["jitted"]["traj"])
        kr = {}
        k_ok, _ = check_implicit(JIT_LABEL, jp, 0.01, kr)
        k_ok &= check_operators_at(JIT_LABEL, jp.disc, J_T, jp.dbcs.arrays(1.0, 1)[0], kr)
        del J_T
        kernel_checks = {k[0]: v for k, v in kr.items()}
        rec["kernel_checks"] = {k: v["ok"] for k, v in kernel_checks.items()}
        good &= head_ok and k_ok
        # the captured step against the uncaptured one, on step 1's inputs
        cfg = jp.step_solver.cfg
        x0, xi0, _ = jp.primal.initial_state()
        bc_dofs, bc_vals = jp.dbcs.arrays(jp.time_grid.time(1), 1)
        ext = jp.disc.zero_x()
        xc, xic, pc, info = jp.step_solver.solve_at_step(x0, x0, xi0, jp.params0, bc_dofs,
                                                         bc_vals, ext, step=1)
        step = make_jit_step(jp.assembler, cfg.max_iters, cfg.abs_tol, cfg.rel_tol,
                             cfg.line_search.max_evals, cfg.linear)
        xu, xiu, pu, _, failed = step(x0, x0, xi0, jp.params0, bc_dofs, bc_vals, ext)
        x_err = float((xc - xu).abs().max() / xu.abs().max())
        xi_err = float((xic - xiu).abs().max() / xiu.abs().max())
        path_eq = bool(torch.equal(pc, pu))
        rec["captured_vs_uncaptured"] = dict(x_rel_err=x_err, xi_rel_err=xi_err,
                                            path_equal=path_eq, captured_step=info,
                                            uncaptured_failed=failed)
        good &= x_err <= lim["captured"] and path_eq and not failed and replay_ok
        attach_synthetic(mesh, routes["jitted"]["prob"].disc, routes["jitted"]["traj"])
        # (d) three experiments through run_batch
        run = JitTrajectory(jp.assembler, jp.time_grid, jp.dbcs, cfg.max_iters, cfg.abs_tol,
                            cfg.rel_tol, cfg.line_search.max_evals, cfg.linear)
        batch = torch.stack([f * jp.params0 for f in JIT_BATCH])
        t0 = time.perf_counter()
        xs_b = run.run_batch(batch)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        errs = []
        for i, p in enumerate(batch):
            xs = run(p)[0]
            errs.append(float((xs_b[0][i] - xs).abs().max() / xs.abs().max()))
        apart = [float((xs_b[0][i, -1] - xs_b[0][0, -1]).abs().max()) for i in (1, 2)]
        fails = bool(xs_b[4].any())
        rec["batch"] = dict(factors=JIT_BATCH, rel_err_to_own_run=errs, x_apart=apart,
                            failed=fails, seconds=batch_s,
                            replays=sum(run.runner.replays.values()))
        good &= max(errs) <= lim["batch"] and min(apart) > 0 and not fails
        # (c) the calibration
        cal = Problem(load_deck(cal_deck), mesh=mesh, device=DEVICE, dtype=torch.float64)
        adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg())
        active = ActiveParams.from_inverse_spec(FEMU_FULL_ACTIVE, cal.disc.elem_set_names,
                                                cal.model.param_names)
        obj = FemuRecorder(AdjointObjective(cal, adj, active), adj)
        x0c = active.to_canonical(active.extract(cal.params0))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        J0, g0 = obj.value_and_gradient(x0c)
        res = run_inverse(obj, active, x0=x0c, max_iters=60, gtol=1e-12)
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
        c = launch_counts()
        counts = add_counts(counts, c)
        # one evaluation at the start on the host route, for its seconds
        _, host_cal = jit_bench_decks(load_file, solver=None)
        cal_h = Problem(load_deck(host_cal), mesh=mesh, device=DEVICE, dtype=torch.float64)
        adj_h = Adjoint(cal_h.assembler, cal_h.qoi, cal_h.dbcs, LinearCfg())
        obj_h = FemuRecorder(AdjointObjective(cal_h, adj_h, ActiveParams.from_inverse_spec(
            FEMU_FULL_ACTIVE, cal_h.disc.elem_set_names, cal_h.model.param_names)), adj_h)
        obj_h.value_and_gradient(x0c)
    rec_params = femu_recovered(res)
    summ = obj.summary()
    gref = np.asarray([G_REF_JIT[k] for k in res.names])
    j_rel = abs(J0 - J_REF_JIT_START) / abs(J_REF_JIT_START)
    g_rel = float(np.abs(np.asarray(g0) - gref).max() / np.abs(gref).max())
    rec["calibration"] = dict(
        names=res.names, recovered={k: v[0] for k, v in rec_params.items()},
        rel_err={k: v[1] for k, v in rec_params.items()}, reference=CAL_REF_JIT, J0=J0,
        J0_rel_err=j_rel, grad0=[float(v) for v in g0], grad0_rel_err=g_rel, J=res.J,
        message=res.message, failed_forward_solves=res.n_failed, calibration_s=cal_s,
        seconds_per_evaluation=cal_s / max(summ["evaluations"], 1), **summ,
        launches=c, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        host_route_evaluation=obj_h.evals[0])
    good &= (j_rel <= lim["J_start"] and g_rel <= lim["grad_start"]
             and all(v[1] < lim["recovered"] for v in rec_params.values()))
    rec["limits"], rec["ok"] = lim, good
    log(json.dumps(rec))
    log(json.dumps(dict(jitted_calibration_evals=obj.evals)))
    if not good:
        log("FAIL jitted: see the record above")
    return good, counts, kernel_checks


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "calibr8_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout that holds calibr8_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.mesh import generators
    from calibr8_tpu_torch.problem import build_mesh

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    meshes = {"cube32": generators.cube(32), "notch004": generators.notch2d(0.004)}
    log(f"meshes cube n=32 ({meshes['cube32'].n_elems} elements), notch2D h=0.004 "
        f"({meshes['notch004'].n_elems} elements): {time.perf_counter() - t0:.1f} s")
    for key, deck in (("mg_cube", mg_cube_deck()), ("mg_notch", mg_notch_deck())):
        t0 = time.perf_counter()
        meshes[key] = build_mesh(load_deck(deck))
        log(f"mesh {key}: {deck['discretization']['builtin mesh']} -> "
            f"{meshes[key].n_elems} elements, {meshes[key].n_nodes} nodes, refined on the host "
            f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall ({json.dumps(built)})")
    for name in kernels.KERNELS:
        for line in kernels.build_log(name).splitlines():
            # the entry's mangled name says which instance the next lines are
            # (e.g. ...kernelIdNS_7HyperJ2E...: float64, HyperJ2)
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    results = {}
    ok = (phase_kernels(meshes["cube32"], results)
          and phase_isotropic(meshes["cube32"], results) and phase_implicit(meshes, results)
          and phase_level_kernels(meshes, results))
    log(f"phase kernels: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    ok = phase_dist_kernels(meshes, results)
    log(f"phase kernels, domain-decomposed (1c, 3c per part): {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    ok, probe_launches = phase_probe(results)
    log(f"phase probe (kernel 4): {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    ok = phase_goldens()
    log(f"phase goldens: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = {}
    for label, deck, mesh, operator, J_ref, needed in full_width_runs(meshes):
        ok, c = phase_full_width(label, deck, mesh, operator, J_ref, needed)
        log(f"phase full width, {label}, operator {operator}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = add_counts(counts, c)
    for label, deck, mesh, J_ref, needed in mg_runs(meshes):
        ok, c = phase_mg_primal(label, deck, mesh, J_ref, needed)
        log(f"phase multigrid primal, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = add_counts(counts, c)

    needed = ["assembly_elems", "ell_spmv_part"]
    for label, deck, J_ref in (
        ("cube n=32 small_J2 (bench deck), 8 parts", bench_deck_32(), J_REF_N32),
        ("cube n=32 hyper_J2, 8 parts", hyper_deck(32), J_REF_HYPER_N32),
    ):
        ok, c, single = phase_dist_full_width(label, deck, meshes["cube32"], J_ref, needed)
        log(f"phase dist, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = add_counts(counts, c)
    ok, c = phase_dist_parity(meshes)
    log(f"phase dist, 5 parts against the single-device solve: {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = add_counts(counts, c)

    for label, deck in fd_decks().items():
        ok = phase_adjoint_fd(label, deck)
        log(f"phase adjoint, finite differences, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
    for name, g_ref, mesh in (("bench", G_REF_N32, "cube32"), ("hill", G_REF_HILL_N32, "cube32"),
                              ("hyper", G_REF_HYPER, "cube32"), ("hypo", G_REF_HYPO, "cube32"),
                              ("hosford", G_REF_HOSFORD, "cube32"), ("iso", G_REF_ISO, "cube32"),
                              ("hybrid", G_REF_HYBRID, "mg_notch")):
        ok, c = phase_adjoint_full_width(name, meshes[mesh], g_ref, at_tol=name == "hybrid")
        log(f"phase adjoint, full width, {name}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = add_counts(counts, c)
    ok, c = phase_mg_adjoint(meshes["mg_cube"], G_REF_MG)
    log(f"phase multigrid adjoint: {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = add_counts(counts, c)
    ok, c = phase_dist_adjoint()
    log(f"phase dist adjoint: {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = add_counts(counts, c)
    dist_overhead(meshes["cube32"])
    log(f"dist overhead record ({time.perf_counter() - t_start:.0f} s)")
    ok = phase_cli()
    log(f"phase cli: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    for label, run in (
        ("full width", lambda: phase_femu_full_width(meshes["mg_notch"], J_REF_FEMU, G_REF_FEMU)),
        ("reference configuration", phase_femu_reference),
        ("cli round trip", phase_femu_cli),
    ):
        ok, c = run()
        log(f"phase femu, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = add_counts(counts, c)
    ok, c, amg_levels = phase_amg(meshes, results)
    log(f"phase amg: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = add_counts(counts, c)
    ok, c, jit_checks = phase_jitted(generators.notch2d(0.01))
    log(f"phase jitted: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = add_counts(counts, c)

    line = []
    timed = {"fused_assembly": ("fused_assembly", "float64"),
             "implicit_assembly": ("implicit_assembly", "cube n=32 hyper_J2", "float64"),
             "implicit_eig": ("implicit_eig", "cube n=32 small_hosford", "float64"),
             "implicit_barlat": ("implicit_barlat", "cube n=32 hypo_barlat", "float64"),
             "implicit_hybrid": ("implicit_hybrid", HYBRID_TIMED, "float64"),
             "ebe_matvec": ("ebe_matvec", "float64"), "ell_spmv": ("ell_spmv", "float64"),
             "ell_spmv_T": ("ell_spmv_T", "cube n=32 small_J2", "float64"),
             "ell_spmv_level": ("ell_spmv_level", LEVEL_TIMED, "float64"),
             "probe": ("probe", "trig", "float64"),
             "assembly_elems": ("assembly_elems", "cube n=32 small_J2", "float64"),
             "ell_spmv_part": ("ell_spmv_part", "cube n=32 small_J2", "float64")}
    counts["probe"] = probe_launches
    # device_ms: the ELL kernels' and the EBE's device time per call
    # (device_ms()); null for the kernels whose records do not take it
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def figures(r):
        return {k: r.get(k) if k == "device_ms" else r[k] for k in keys}

    for name, (src, repl) in KERNELS.items():
        r = results[timed[name]]
        if name == "ell_spmv_level":
            r = r["forward"]
        entry = dict(name=name, route="cuda", source=src, replaces=repl,
                     launches=counts[name], **figures(r))
        if name in ("implicit_assembly", "implicit_eig", "implicit_barlat", "implicit_hybrid"):
            # each instance's launches, figures, bounds by bytes and by
            # operations, and ptxas report (3D at cube n=32, the plane twins
            # and the hybrid at notch2D h=0.004) beside hyper_J2's
            # (implicit_assembly) or small_hosford's (implicit_eig)
            for key, h in results.items():
                if key[0] == name and key[2] == "float64":
                    model = key[1].split()[-1]
                    f32 = results[(name, key[1], "float32")]
                    entry[model] = dict(
                        launches=counts.get(f"{name}/{model}", 0), **figures(h),
                        **{k: h[k] for k in ("bytes_ms", "flops_ms", "flops_nofma_ms", "ptxas")},
                        float32={k: f32[k] for k in ("ms", "bound_ms", "bound_by", "ptxas")})
        if name == "fused_assembly":
            # the displacement-only rows (isotropic_elastic) beside small_J2's
            h = results[("fused_assembly", ISO_TIMED, "float64")]
            entry["isotropic_elastic"] = figures(h)
        if name == "assembly_elems":
            # the element-level entry of the other libraries beside small_J2's
            for key, h in results.items():
                if key[0] == "assembly_elems" and key[1:] != timed[name][1:] and \
                        key[2] == "float64":
                    entry[key[1]] = figures(h)
        if name == "ell_spmv_level":
            # the aggregation AMG's levels, the (6, 6) instance among them
            for case in amg_levels:
                entry[case] = figures(results[("ell_spmv_level", case, "float64")]["forward"])
        if name in jit_checks:
            # the jitted phase's check at the bench calibration deck's shapes
            entry[JIT_LABEL] = figures(jit_checks[name])
        if name == "ell_spmv_part":
            # ndpn 3 and 2 beside the 3D mixed (4, 4) instance's
            for case in ("notch2D h=0.004 small_J2", "notch2D h=0.004 small_hill_plane_stress"):
                h = results[("ell_spmv_part", case, "float64")]
                entry[case] = figures(h)
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
