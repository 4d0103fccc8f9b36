"""Problem wiring: deck -> mesh -> disc -> model -> solvers -> QoI.

The counterpart of calibr8_tpu's problem.py (reference State + driver
setup, state.{hpp,cpp}, main_primal.cpp:33-120).  A Problem lives on one
device: the card unless the caller asks for the CPU, which raises when
no CUDA device exists.  Decks that need a part this slice does not port
raise NotImplementedError naming it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from calibr8_tpu_torch.deck import ProblemSpec
from calibr8_tpu_torch.fem.bcs import DirichletBCs, DirichletSpec, FieldDirichletSpec, TractionBCs, TractionSpec
from calibr8_tpu_torch.fem.disc import Disc
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler
from calibr8_tpu_torch.mechanics.global_residual import MechanicsSpec
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.mesh.refine import uniform_refine
from calibr8_tpu_torch.models import create_local_model
from calibr8_tpu_torch.qoi import create_qoi
from calibr8_tpu_torch.solve.linear import LinearCfg
from calibr8_tpu_torch.solve.newton import LineSearchParams, NewtonCfg, StepSolver
from calibr8_tpu_torch.solve.primal import Primal, TimeGrid


def resolve_device(device=None) -> torch.device:
    """`None` means the card; it is an error when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to run "
            "the plain PyTorch versions of its kernels on the CPU"
        )
    return dev


def build_mesh(spec: ProblemSpec, mesh=None):
    if mesh is not None:
        return mesh
    d = spec.disc
    if "builtin mesh" not in d:
        raise NotImplementedError(
            "mesh files (.smb, .msh) are not ported yet: use a 'builtin mesh'"
        )
    bm = dict(d["builtin mesh"])
    kind = bm.pop("type")
    # 'refinements: L' solves on the L times uniformly refined mesh and
    # keeps the chain on it as the geometric multigrid hierarchy
    n_ref = int(bm.pop("refinements", 0))
    fn = {
        "cube": generators.cube,
        "square": generators.square,
        "notch2D": generators.notch2d,
        "notch3D": generators.notch3d,
    }[kind]
    m = fn(**bm)
    if n_ref:
        base, chain = m, []
        for _ in range(n_ref):
            chain.append(uniform_refine(m))
            m = chain[-1].fine
        m.refine_chain = chain
        m.refine_base = base
    return m


class Problem:
    """One fully wired forward problem (one 'experiment')."""

    def __init__(self, spec: ProblemSpec, mesh=None, device=None, dtype=torch.float64):
        self.spec = spec
        self.device = resolve_device(device)
        gr = spec.global_residual
        lr = spec.local_residual

        gr_type = gr.get("type", "mechanics")
        if gr_type not in ("mechanics", "mechanics_plane_stress"):
            raise NotImplementedError(f"global residual type {gr_type!r} is not ported yet")
        plane_stress = gr_type == "mechanics_plane_stress"
        if gr.get("solver") == "jitted":
            raise NotImplementedError("'solver: jitted' (solve/jit_newton.py) is not ported yet")
        la = spec.linear_algebra
        self.mesh = build_mesh(spec, mesh)
        dim = self.mesh.dim
        refine_chain = getattr(self.mesh, "refine_chain", None)
        refine_base = getattr(self.mesh, "refine_base", None)
        precond = la.get("preconditioner")
        if precond == "amg" or (precond == "multigrid" and not refine_chain):
            # calibr8_tpu runs these on its aggregation AMG
            raise NotImplementedError(
                f"preconditioner {precond!r}"
                + ("" if precond == "amg" else " on a mesh without 'refinements:'")
                + " needs the aggregation AMG (solve/amg.py's AMGPrecondFactory), which is "
                "not ported yet; geometric multigrid runs on a refined builtin mesh"
            )
        self.model = create_local_model(spec.model_name, dim)
        self.model.abs_tol = float(lr.get("nonlinear absolute tol", 1e-12))
        self.mech_spec = MechanicsSpec(
            dim=dim,
            mixed=(not plane_stress) and bool(gr.get("mixed formulation", True)),
            stab_multiplier=float(gr.get("stabilization multiplier", 1.0)),
            plane_stress=plane_stress,
            thickness=float(gr.get("thickness", 1.0)),
        )
        self.disc = Disc(self.mesh, self.mech_spec, self.device, dtype)
        self.mesh = self.disc.mesh

        # material parameters per elem set, model order, disc set order
        es_names, vals = spec.materials(self.model.param_names)
        expected = self.disc.elem_set_names
        if es_names and set(es_names) != set(expected):
            raise ValueError(f"materials sets {es_names} do not match mesh elem sets {expected}")
        if es_names:
            vals = vals[[es_names.index(n) for n in expected]]
        else:
            vals = np.zeros((len(expected), self.model.n_params))
        self.params0 = torch.as_tensor(vals, dtype=dtype, device=self.device)

        self.assembler = FusedAssembler(self.disc, self.model)
        newton_cfg = NewtonCfg(
            max_iters=int(gr.get("nonlinear max iters", 15)),
            abs_tol=float(gr.get("nonlinear absolute tol", 1e-8)),
            rel_tol=float(gr.get("nonlinear relative tol", 1e-8)),
            print_convergence=bool(gr.get("print convergence", False)),
            linear=LinearCfg(
                method=la["method"], tol=la["tolerance"], max_iters=la["maximum iterations"],
                precond_reuse=la.get("preconditioner reuse", "none"),
            ),
            line_search=_ls_params(gr.get("line search", {})),
        )
        self.step_solver = StepSolver(self.assembler, newton_cfg)

        # geometric multigrid on the refinement chain (calibr8_tpu
        # problem.py:187-206); its host setup time is kept for the record
        self.mg_factory = None
        self.mg_setup_s = 0.0
        if precond == "multigrid":
            from calibr8_tpu_torch.solve.mg import MGPrecondFactory

            t0 = time.perf_counter()
            self.mg_factory = MGPrecondFactory(self.disc, refine_chain, refine_base)
            self.mg_setup_s = time.perf_counter() - t0
            self.step_solver.mg_factory = self.mg_factory

        self.dbcs = DirichletBCs(
            self.disc,
            [DirichletSpec(*e) for e in spec.dirichlet_expression],
            field_specs=[FieldDirichletSpec(*e) for e in spec.dirichlet_field],
        )
        tr = spec.tractions
        self.tbcs = TractionBCs(self.disc, [TractionSpec(*e) for e in tr]) if tr else None

        qcfg = dict(spec.qoi)
        qtype = qcfg.pop("type", None)
        self.qoi = create_qoi(qtype, self.disc, qcfg) if qtype else None

        tf = spec.disc.get("time file")
        if tf:
            with open(tf) as f:
                times = np.asarray([float(line) for line in f if line.strip()])
            self.time_grid = TimeGrid(times=times)
        else:
            self.time_grid = TimeGrid.uniform(spec.num_steps, spec.step_size)

        self.primal = Primal(
            self.disc, self.assembler, self.step_solver, self.dbcs, self.tbcs, self.qoi,
            self.time_grid,
        )

    def solve_primal(self, params_all=None):
        params = self.params0 if params_all is None else params_all
        return self.primal.run(params)


def _ls_params(sub: dict) -> LineSearchParams:
    return LineSearchParams(
        c1=float(sub.get("sufficient decrease", 1.0e-4)),
        backtrack_min=float(sub.get("min backtrack factor", 0.5)),
        backtrack_max=float(sub.get("max backtrack factor", 0.9)),
        max_evals=int(sub.get("max evals", 4)),
    )
