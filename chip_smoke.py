#!/usr/bin/env python3
"""Smoke run of calibr8_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of a checkout)

Phases, in order; any failure exits non-zero without the result lines:

 1. device: the card's name and power limit (nvidia-smi), the torch and
    CUDA versions, the build of the five CUDA libraries from
    calibr8_tpu_torch/csrc with nvcc (one process per source, all in
    parallel), with ptxas's register and spill report, and the two
    multigrid meshes refined on the host.
 2. each kernel against its plain PyTorch version, in float32 and
    float64, at the shapes of the full-width problems, in states with
    plastic and elastic elements: the slice-1 kernels at cube n=32,
    small_J2, mixed u/p (196,608 elements, 143,748 dofs); the implicit
    assembly at cube n=32 small_hill and hyper_J2 (mixed u/p), at
    notch2D h=0.004 small_hill_plane_stress and hyper_J2_plane_stress
    (displacement only) and hyper_J2_plane_strain (mixed u/p), the hyper
    cases with x != x_prev; the EBE and both ELL kernels held once more
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
    local Newton iterations.
 3. the goldens of tests/decks.py on the card in float64 (cube_elastic,
    notch2D_small_J2, the small-strain Hill family's three and the
    hyper_J2 family's five), and the notch deck once more through GMRES
    on the ELL operator.
 4. the full-width primal solves (float64, GMRES + block Gauss-Seidel)
    through Problem(...).solve_primal(): the bench deck (cube n=32,
    small_J2) with the assembled ELL matrix as the Krylov operator and
    once more, for 1 load step, with the matrix-free EBE operator; cube
    n=32 small_hill and hyper_J2 (mixed u/p, 2 load steps); notch2D
    h=0.004 small_hill_plane_stress and hyper_J2_plane_stress
    ('mechanics_plane_stress', 2 load steps).  Each run's launch counts
    are set to 0 just before it and read just after; J is held at rel
    1e-6 to its reference.  Then (4b) the multigrid decks, GMRES with
    the recursive geometric multigrid: cube n=4 refined 3 times (196,608
    tets, small_J2 at the bench deck's constants, mixed u/p: u and p
    chains) with `preconditioner reuse` none and step, and notch2D
    h=0.032 refined 3 times (139,008 triangles, small_hill_plane_stress);
    every linear solve must reach its tolerance, J within rel 1e-6 of
    calibr8_tpu's (J_REF_MG_*), 3a and 3c launched.
 5. the adjoint (float64), through AdjointObjective's value and
    gradient: (a) against finite differences, log10 error drop > 6: the
    notch2D small_J2 8-step deck and the hyper_J2_plane_stress twin case
    on notch2D h=0.12 (fd_decks); (b) the bench deck, (c) cube n=32
    small_hill and (d) cube n=32 hyper_J2 (adjoint_deck), dJ/dp held at
    1e-5 to calibr8_tpu's (G_REF_*), every adjoint relative residual
    <= 0.5, ell_spmv_T launched; (e) dJ/dp of the cube MG deck with the
    multigrid transposed solves (Adjoint(mg_factory=...)), reuse none and
    step, every transposed solve at its tolerance, within 1e-5 of
    calibr8_tpu's G_REF_MG, step equal to none to 1e-9.  Launch counts as
    in phase 4.
 6. one JSON line listing every ported kernel (launches: the sum over
    the runs of phases 4, 4b and 5b-5e), the card's name and power limit,
    and the `ok` line last.

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

# the active parameters of the hyper_J2_plane_stress finite-difference check
FD_HYPER_ACTIVE = {"E": [800.0, 1200.0], "Y": [5.0, 15.0], "S": [2.5, 7.5], "K": [25.0, 75.0]}

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
}


def adjoint_deck(name: str) -> dict:
    """The full-width deck `name` (the bench deck, hill_deck(32),
    hyper_deck(32) or, for "mg", mg_cube_deck()) with an `inverse`
    sublist: the parameters of ADJOINT_ACTIVE[name] active over [0.8, 1.2]
    times their deck values."""
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = {"bench": lambda: bench_deck(32), "hill": lambda: hill_deck(32),
            "hyper": lambda: hyper_deck(32), "mg": mg_cube_deck}[name]()
    mats = deck["residuals"]["local residual"]["materials"]["body"]
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
}

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_assembly": ("calibr8_tpu_torch/csrc/fused_assembly.cu",
                       "calibr8_tpu/fem/pallas_assembly.py:496"),
    # the kernels line carries its figures at cube n=32 hyper_J2 (the
    # Hill twins' are in the phase-2 records)
    "implicit_assembly": ("calibr8_tpu_torch/csrc/implicit_assembly.cu",
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
}
LEVEL_TIMED = "cube MG fine p block (m=1, 35937 nodes)"
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
    random nodal pressure so the pressure terms are exercised too."""
    disc = prob.disc
    d = disc.spec.dim
    rng = np.random.default_rng(seed)
    c = disc.mesh.coords
    u = np.stack([(-0.004 if i != 1 else 0.02) * c[:, i] for i in range(d)], axis=1)
    u = u + 1e-4 * rng.standard_normal((disc.n_nodes, d))
    p = rng.standard_normal(disc.n_nodes)
    x = torch.tensor(np.concatenate([u.reshape(-1), p]), dtype=disc.dtype, device=disc.device)
    xi_prev = torch.zeros(disc.n_elem, prob.model.nxi(), dtype=disc.dtype, device=disc.device)
    return x, xi_prev


def phase_kernels(mesh, results):
    """Phase 2, slice-1 kernels: each against its plain version at the
    bench deck's shapes, f32 and f64."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec, ebe_matvec_plain
    from calibr8_tpu_torch.fem.fused_assembly import fused_assembly, fused_assembly_plain
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
        disc, bm = prob.disc, prob.assembler.bmodel
        E, nde, n_dofs, npe, d = disc.n_elem, disc.spec.ndofs_elem, disc.n_dofs, disc.spec.npe, disc.spec.dim
        nxi = bm.nxi
        x, xi_prev = representative_state(prob)
        P = prob.params0
        lim = LIMITS[dn]

        # -- kernel 1: fused assembly --
        out_k = fused_assembly(disc, bm, x, xi_prev, P)
        out_p = fused_assembly_plain(disc, bm, x, xi_prev, P)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("R", "J", "xi"), out_k[:3], out_p[:3]):
            errs[name] = rel_err(a, b)
        path_mism = int((out_k[3] != out_p[3]).sum())
        n_plastic = int(out_p[3].sum())
        worst = max(e[0] for e in errs.values())
        ms = time_ms(lambda: fused_assembly(disc, bm, x, xi_prev, P), 20)
        pms = time_ms(lambda: fused_assembly_plain(disc, bm, x, xi_prev, P), 2, rounds=1)
        nbytes = (n_dofs * w + nde * E * 4 + E * nxi * w + npe * d * E * w + 2 * E * w
                  + P.numel() * w + E * 4 + nde * E * w + nde * nde * E * w + nxi * E * w + 2 * E * 4)
        # counted operations: only the Jacobian contraction of the d*d
        # tangents with grad_N (2 flops per multiply-add), a lower bound
        flops = 2.0 * E * nde * npe * d * d
        b_ms, b_by = bound(nbytes, flops, dn)
        rec = dict(kernel="fused_assembly", dtype=dn, rel_err={k: v[0] for k, v in errs.items()},
                   max_abs_err=max(e[1] for e in errs.values()), path_mismatch=path_mism,
                   plastic=n_plastic, elements=E, ms=ms, plain_ms=pms, library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if worst > lim or path_mism or not all(bool(torch.isfinite(t).all()) for t in out_k[:3]):
            log(f"FAIL fused_assembly {dn}: rel err {worst:.3e} (limit {lim:.0e}), "
                f"path mismatches {path_mism}")
            ok = False
        results[("fused_assembly", dn)] = rec
        J_T = out_k[1]

        # -- kernel 2: EBE matvec --
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        v = torch.randn(n_dofs, generator=gen, device=DEVICE, dtype=dtype)
        yk = ebe_matvec(J_T, v, disc.edofs_T, n_dofs)
        yp = ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs)
        torch.cuda.synchronize()
        err, aerr = rel_err(yk, yp)
        ms = time_ms(lambda: ebe_matvec(J_T, v, disc.edofs_T, n_dofs), 30)
        pms = time_ms(lambda: ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs), 10)
        J_ef = J_T.permute(2, 0, 1).contiguous()
        idx = disc.edofs

        def lib_ebe():
            ye = torch.bmm(J_ef, v[idx].unsqueeze(-1)).squeeze(-1)
            return torch.zeros(n_dofs, dtype=dtype, device=DEVICE).index_add_(
                0, idx.reshape(-1), ye.reshape(-1))

        lms = time_ms(lib_ebe, 10)
        err_lib = rel_err(lib_ebe(), yp)[0]
        del J_ef
        nbytes = nde * nde * E * w + nde * E * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * nde * nde * E, dn)
        rec = dict(kernel="ebe_matvec", dtype=dn, rel_err=err, max_abs_err=aerr, ms=ms,
                   plain_ms=pms, library_ms=lms, library_rel_err=err_lib,
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
        ms = time_ms(lambda: ell_spmv(A_T, nbr_T, v, d), 30)
        pms = time_ms(lambda: ell_spmv_plain(A_T, nbr_T, v, d), 10)
        # the same matrix as torch.sparse CSR (built once, not timed)
        csr, nnz_slots = ell_csr(A_T, nbr_T, d, n_dofs)
        lms = time_ms(lambda: torch.mv(csr, v), 30)
        err_lib = rel_err(torch.mv(csr, v), yp)[0]
        del csr
        # the A_T blocks of the filled slots (the kernel skips the pad
        # slots'), all of nbr_T and x read once, y written once
        nbytes = nnz_slots * ndpn * ndpn * w + K * N * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * ndpn * ndpn * nnz_slots, dn)
        rec = dict(kernel="ell_spmv", dtype=dn, rel_err=err, max_abs_err=aerr,
                   rel_err_vs_ebe=err_vs_ebe, K=K, filled_slots=nnz_slots, ms=ms,
                   plain_ms=pms, library_ms=lms, library_rel_err=err_lib,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if not err <= lim:
            log(f"FAIL ell_spmv {dn}: rel err {err:.3e} (limit {lim:.0e})")
            ok = False
        results[("ell_spmv", dn)] = rec

        # -- kernel 3b: ELL SpMV transposed, and the transposed operator --
        bc_dofs = prob.dbcs.arrays(1.0, 1)[0]
        ok &= check_ell_spmv_T("cube n=32 small_J2", disc, J_T, out_k[1].diagonal(0, 0, 1),
                               bc_dofs, results)
        del prob, disc, J_T, A_T, out_k, out_p
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
    nbr_T = build_ell_maps(disc)["nbr_T"]
    K, ndpn, _, N = A_T.shape
    yk = ell_spmv_T(A_T, nbr_T, v, d)
    yp = ell_spmv_T_plain(A_T, nbr_T, v, d)
    torch.cuda.synchronize()
    err, aerr = rel_err(yk, yp)
    ms = time_ms(lambda: ell_spmv_T(A_T, nbr_T, v, d), 30)
    pms = time_ms(lambda: ell_spmv_T_plain(A_T, nbr_T, v, d), 10)
    csr, nnz_slots = ell_csr(A_T, nbr_T, d, n_dofs, transpose=True)
    lms = time_ms(lambda: torch.mv(csr, v), 30)
    err_lib = rel_err(torch.mv(csr, v), yp)[0]
    del csr
    # the A_T blocks of the filled slots (the kernel skips the pad slots'
    # blocks), all of nbr_T and x read once, y written once
    nbytes = nnz_slots * ndpn * ndpn * w + K * N * 4 + 2 * n_dofs * w
    b_ms, b_by = bound(nbytes, 2.0 * ndpn * ndpn * nnz_slots, dn)
    diag = torch.zeros(n_dofs, dtype=disc.dtype, device=DEVICE).index_add_(
        0, disc.edofs.reshape(-1), diag_e.reshape(-1))
    op_err = rel_err(EllOperator(disc, J_T, diag, bc_dofs, transpose=True)(v),
                     EllOperator(disc, J_T.transpose(0, 1).contiguous(), diag, bc_dofs)(v))[0]
    good = err <= lim and op_err <= lim
    rec = dict(kernel="ell_spmv_T", case=label, dtype=dn, rel_err=err, max_abs_err=aerr,
               operator_rel_err=op_err, K=K, ndpn=ndpn, filled_slots=nnz_slots, ms=ms,
               plain_ms=pms, library_ms=lms, library_rel_err=err_lib, bound_ms=b_ms,
               bound_by=b_by, limit=lim, ok=good)
    log(json.dumps(rec))
    if not good:
        log(f"FAIL ell_spmv_T {label} {dn}: rel err {err:.3e}, operator {op_err:.3e} "
            f"(limit {lim:.0e})")
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
# check runs at bench.py's 1e-5
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


def check_implicit(label, prob, scale, results):
    """The implicit assembly against its plain version on prob's Disc, in
    prob's dtype; records (and returns) the check."""
    from calibr8_tpu_torch.fem.fused_assembly import fused_assembly_plain, implicit_assembly

    disc, bm = prob.disc, prob.assembler.bmodel
    dn = str(disc.dtype).split(".")[1]
    w = 4 if disc.dtype == torch.float32 else 8
    spec = disc.spec
    E, nde, npe, d, nxi = disc.n_elem, spec.ndofs_elem, spec.npe, spec.dim, bm.nxi
    x, x_prev, xi_prev = implicit_inputs(prob, scale)
    P = prob.params0
    iters = torch.zeros(E, dtype=torch.int32, device=DEVICE)
    iters_p = torch.zeros_like(iters)
    out_k = implicit_assembly(disc, bm, x, xi_prev, P, newton_iters=iters, x_prev=x_prev)
    out_p = fused_assembly_plain(disc, bm, x, xi_prev, P, x_prev=x_prev, newton_iters=iters_p)
    torch.cuda.synchronize()
    hist = torch.bincount(iters.long(), minlength=bm.newton_iters + 1).tolist()
    same_path = out_k[3] == out_p[3]
    agree = float(same_path.double().mean())
    same_iters = iters == iters_p
    iters_agree = float(same_iters.double().mean())
    # A failed element's state is the cap's last iterate, which the
    # primal's Newton never uses (it backtracks on nfail > 0).
    converged = (out_k[4] == 0) & (out_p[4] == 0)
    compared = same_path & converged
    split = bm.finite_deformation
    apart = compared & ~same_iters if split else torch.zeros_like(compared)
    compared = compared & ~apart
    apart_lim = APART_FACTOR * bm.abs_tol

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
    ok = ok and all(errs[k][0] <= lim[k] and apart_err[k][0] <= apart_lim for k in keys)
    ok = ok and (not split or iters_agree >= lim["iters_agree"])
    ok = ok and max(fails) <= MAX_FAILED_SHARE * E
    ok = ok and all(bool(torch.isfinite(t[..., converged]).all()) for t in out_k[:3])
    ms = time_ms(lambda: implicit_assembly(disc, bm, x, xi_prev, P, x_prev=x_prev), 10)
    pms = time_ms(lambda: fused_assembly_plain(disc, bm, x, xi_prev, P, x_prev=x_prev), 1,
                  rounds=1)
    # bytes: every input read once (x_prev too where the twin reads it),
    # every output written once
    nbytes = ((1 if x_prev is None else 2) * disc.n_dofs * w + nde * E * 4 + E * nxi * w
              + npe * d * E * w + 2 * E * w + P.numel() * w + E * 4 + nde * E * w
              + nde * nde * E * w + nxi * E * w + 2 * E * 4)
    # operations counted from c8_implicit.cuh, a lower bound: the small
    # solves (one per Newton update this run's data needed, one for the
    # condensation), the condensed rows K and the contraction with grad_N;
    # the dual arithmetic of the residual evaluations is not counted
    ng = d * d
    flops = (sum(i * n for i, n in enumerate(hist)) * gauss_flops(nxi, 1)
             + E * (gauss_flops(nxi, ng) + 2 * nde * ng * nxi + 2 * nde * npe * d * d))
    b_ms, b_by = bound(nbytes, flops, dn)
    rec = dict(kernel="implicit_assembly", case=label, dtype=dn,
               rel_err={k: v[0] for k, v in errs.items()},
               max_abs_err=max(e[1] for e in (*errs.values(), *apart_err.values())),
               path_agree=agree, plastic=int(out_p[3].sum()), elements=E, fail_kernel_plain=fails,
               compared=int(compared.sum()), iters_agree=iters_agree,
               iters_apart=int(apart.sum()),
               rel_err_iters_apart={k: v[0] for k, v in apart_err.items()},
               newton_iters_hist=hist, ms=ms, plain_ms=pms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, limits=dict(lim, apart=apart_lim if split else None), ok=ok)
    log(json.dumps(rec))
    if not ok:
        log(f"FAIL implicit_assembly {label} {dn}")
    results[("implicit_assembly", label, dn)] = rec
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
        ok &= good
        b_ms, b_by = bound(nbytes, flops, dn)
        rec = dict(kernel=name, case=label, dtype=dn, rel_err=err, max_abs_err=aerr,
                   ms=time_ms(fk, 30), plain_ms=time_ms(fp, 10), library_ms=time_ms(fl, 10),
                   library_rel_err=rel_err(fl(), yp)[0], bound_ms=b_ms, bound_by=b_by,
                   ndpn=ndpn, limit=lim, ok=good)
        log(json.dumps(rec))
        results[(name, label, dn)] = rec
    del A_T, csr, J_ef
    return ok & check_ell_spmv_T(label, disc, J_T, J_T.diagonal(0, 0, 1), bc_dofs, results)


def IMPLICIT_CASES(meshes):
    """(label, deck, mesh, deformation scale) of the implicit kernel's
    checks: the full-width decks of the Hill and hyper_J2 families."""
    return (
        ("cube n=32 small_hill", hill_deck(32), meshes["cube32"], 0.02),
        ("notch2D h=0.004 small_hill_plane_stress", plane_stress_deck(0.004), meshes["notch004"],
         0.01),
        ("cube n=32 hyper_J2", hyper_deck(32), meshes["cube32"], 0.02),
        ("notch2D h=0.004 hyper_J2_plane_strain", hyper_plane_strain_deck(0.004),
         meshes["notch004"], 0.02),
        ("notch2D h=0.004 hyper_J2_plane_stress", hyper_plane_stress_deck(0.004),
         meshes["notch004"], 0.01),
    )


# the cases whose shapes also check the EBE and ELL kernels: ndpn 2
# (displacement only) and ndpn 3 (2D mixed u/p)
OPERATOR_CASES = ("notch2D h=0.004 small_hill_plane_stress", "notch2D h=0.004 hyper_J2_plane_strain")


def phase_implicit(meshes, results):
    """Phase 2, implicit assembly: the full-width Hill and hyper_J2 decks'
    shapes, float32 and float64, and the EBE / ELL kernels at the notch2D
    shapes (ndpn 2 and 3)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    ok = True
    for label, deck, mesh, scale in IMPLICIT_CASES(meshes):
        for dtype in (torch.float32, torch.float64):
            deck_t = copy.deepcopy(deck)
            if dtype == torch.float32:
                # float32 cannot reach the decks' local tolerance of 1e-12:
                # converged plastic lanes then flip branch on rounding
                # noise until the 16-iteration cap, and the two versions
                # end in different states.  At 1e-6 they converge; a lane
                # whose ||C|| lands within rounding of the tolerance stops
                # one iteration apart in the two, a difference of one
                # step below 1e-6 (at bench.py's float32 1e-5 that step
                # can exceed this check's limit; PERF.md has the runs).
                lr = deck_t["residuals"]["local residual"]
                lr["nonlinear absolute tol"] = (F32_LOCAL_TOL_FINITE if lr["type"].startswith("hyper")
                                                else F32_LOCAL_TOL)
            prob = Problem(load_deck(deck_t), mesh=mesh, device=DEVICE, dtype=dtype)
            good, J_T = check_implicit(label, prob, scale, results)
            ok &= good
            if label in OPERATOR_CASES:
                ok &= check_operators_at(label, prob.disc, J_T, prob.dbcs.arrays(1.0, 1)[0],
                                         results)
            del prob, J_T
            torch.cuda.empty_cache()
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
    counts = dict(kernels.launches)
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
    return {"notch2D h=0.12 small_J2, 8 steps": notch,
            "notch2D h=0.12 hyper_J2_plane_stress, 2 steps": hyper}


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


def phase_adjoint_full_width(name, mesh, g_ref):
    """Phase 5b/5c: dJ/dp of a full-width deck through the objective's
    entry points (value: the primal; gradient: the backward sweep, whose
    transposed solves run GMRES + block Gauss-Seidel on the ELL operator,
    i.e. ell_spmv_T), float64, held at 1e-5 (max-norm relative) to
    calibr8_tpu's gradient g_ref.  Launch counts are set to 0 just before
    and read just after.  Returns (ok, counts)."""
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
    counts = dict(kernels.launches)
    names = obj.active.names
    ref = np.asarray([g_ref[k] for k in names])
    rel = float(np.abs(g - ref).max() / np.abs(ref).max())
    steps = [dict(step=s["step"], relres=s["relres"], krylov_iterations=s["krylov_iters"])
             for s in adj.step_info]
    summ = timers.summary()
    rec = dict(adjoint=name, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs, names=names,
               grad=[float(v) for v in g], grad_ref=ref.tolist(), rel_err=rel, limit=1e-5, J=J,
               setup_s=setup_s, primal_s=primal_s, sweep_s=sweep_s, steps=steps,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()
                       if k.startswith("adjoint/")},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    ok = (rel <= 1e-5 and bool(np.all(np.isfinite(g)))
          and all(np.isfinite(s["relres"]) and s["relres"] <= 0.5 for s in steps)
          and counts["ell_spmv_T"] > 0)
    if not ok:
        log(f"FAIL adjoint {name}: gradient rel err {rel:.3e} (limit 1e-5), steps {steps}, "
            f"launches {counts}")
    return ok, counts


def check_level_apply(label, A_T, nbr_T, m, results):
    """Kernel 3c (the multigrid level apply, LevelEllOperator) against its
    plain version on one level's assembled matrix A_T (K, m, m, n), in
    float64 and (the same matrix rounded) float32, forward, with the
    ell_spmv_T kernel's level instance held the same way; each with its
    time, bound (the filled slots' blocks, nbr_T and the vectors) and the
    torch.sparse CSR mv of the same matrix."""
    from calibr8_tpu_torch.solve.ellpack import (
        ell_spmv_T, ell_spmv_T_plain, level_ell_spmv, level_ell_spmv_plain,
    )

    K, _, _, n = A_T.shape
    ok = True
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        w = 4 if dtype == torch.float32 else 8
        lim = LIMITS[dn]
        A = A_T.to(dtype).contiguous()
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        v = torch.randn(n * m, generator=gen, device=DEVICE, dtype=dtype)
        rec = dict(kernel="ell_spmv_level", case=label, dtype=dn, m=m, nodes=n, K=K, limit=lim)
        for direction, fk, fp in (
            ("forward", lambda: level_ell_spmv(A, nbr_T, v, m),
             lambda: level_ell_spmv_plain(A, nbr_T, v, m)),
            ("transposed", lambda: ell_spmv_T(A, nbr_T, v, m), lambda: ell_spmv_T_plain(A, nbr_T, v, m)),
        ):
            yp = fp()
            err, aerr = rel_err(fk(), yp)
            csr, nnz_slots = ell_csr(A, nbr_T, m, n * m, transpose=direction == "transposed")
            lms = time_ms(lambda: torch.mv(csr, v), 30)
            err_lib = rel_err(torch.mv(csr, v), yp)[0]
            del csr
            nbytes = nnz_slots * m * m * w + K * n * 4 + 2 * n * m * w
            b_ms, b_by = bound(nbytes, 2.0 * m * m * nnz_slots, dn)
            good = err <= lim
            ok &= good
            rec[direction] = dict(rel_err=err, max_abs_err=aerr, ms=time_ms(fk, 50),
                                  plain_ms=time_ms(fp, 10), library_ms=lms,
                                  library_rel_err=err_lib, bound_ms=b_ms, bound_by=b_by,
                                  filled_slots=nnz_slots, ok=good)
        log(json.dumps(rec))
        if not rec["forward"]["ok"] or not rec["transposed"]["ok"]:
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
        lv = mg._pairs[0]["maps"]["nbr_T"]
        n1 = mg._pairs[0]["n_parent_nodes"]
        cases = [(f"{name} level 1 u (m={disc.spec.dim}, {n1} nodes)",
                  st["u"]["levels"][0]["A_T"], lv, disc.spec.dim)]
        if disc.spec.mixed:
            cases += [(f"{name} level 1 p (m=1, {n1} nodes)", st["p"]["levels"][0]["A_T"], lv, 1),
                      (f"{name} fine p block (m=1, {disc.n_nodes} nodes)", st["p_ell_A_T"],
                       build_ell_maps(disc)["nbr_T"], 1)]
        for label, A_T, nbr_T, m in cases:
            ok &= check_level_apply(label, A_T, nbr_T, m, results)
        del prob, disc, mg, st, J_T
        torch.cuda.empty_cache()
    return ok


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
    counts = dict(kernels.launches)
    lin = prob.step_solver.cfg.linear
    rel = abs(traj.J - J_ref) / abs(J_ref)
    steps = mg_solve_records(traj)
    relres = [r for s in steps for r in s["relres"]]
    summ = timers.summary()
    rec = dict(mg_primal=label, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs,
               reuse=lin.precond_reuse, tol=lin.tol, max_iters=lin.max_iters, J=traj.J,
               J_ref=J_ref, rel_err=rel, steps=steps, setup_s=setup_s,
               hierarchy_setup_s=prob.mg_setup_s, solve_s=solve_s,
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
    counts = dict(kernels.launches)
    summ = timers.summary()
    rec.update(step_vs_none=diff, step_vs_none_limit=1e-9, tol=adj.linear_cfg.tol,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               launches=counts)
    log(json.dumps(rec))
    ok &= diff <= 1e-9 and counts["ell_spmv_T"] > 0 and counts["ell_spmv_level"] > 0
    if not ok:
        log("FAIL mg adjoint: see the record above")
    return ok, counts


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
    ok = (phase_kernels(meshes["cube32"], results) and phase_implicit(meshes, results)
          and phase_level_kernels(meshes, results))
    log(f"phase kernels: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
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
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
    for label, deck, mesh, J_ref, needed in mg_runs(meshes):
        ok, c = phase_mg_primal(label, deck, mesh, J_ref, needed)
        log(f"phase multigrid primal, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}

    for label, deck in fd_decks().items():
        ok = phase_adjoint_fd(label, deck)
        log(f"phase adjoint, finite differences, {label}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
    for name, g_ref in (("bench", G_REF_N32), ("hill", G_REF_HILL_N32), ("hyper", G_REF_HYPER)):
        ok, c = phase_adjoint_full_width(name, meshes["cube32"], g_ref)
        log(f"phase adjoint, full width, {name}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
    ok, c = phase_mg_adjoint(meshes["mg_cube"], G_REF_MG)
    log(f"phase multigrid adjoint: {'ok' if ok else 'FAILED'} "
        f"({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = {k: counts.get(k, 0) + v for k, v in c.items()}

    line = []
    timed = {"fused_assembly": ("fused_assembly", "float64"),
             "implicit_assembly": ("implicit_assembly", "cube n=32 hyper_J2", "float64"),
             "ebe_matvec": ("ebe_matvec", "float64"), "ell_spmv": ("ell_spmv", "float64"),
             "ell_spmv_T": ("ell_spmv_T", "cube n=32 small_J2", "float64"),
             "ell_spmv_level": ("ell_spmv_level", LEVEL_TIMED, "float64")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, (src, repl) in KERNELS.items():
        r = results[timed[name]]
        if name == "ell_spmv_level":
            r = r["forward"]
        line.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=counts[name], **{k: r[k] for k in keys}))
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
