"""The adjoint slice of the port against calibr8_tpu, float64 on the CPU:
the transposed ELL apply (kernel 3b's plain version), the QoI partials,
the GMRES route, the finite-difference check and the `inverse` CLI, and
the helpers the other adjoint files share.  The backward step and the
sweep on calibr8_tpu's own trajectory are in test_torch_adjoint_sweep.py,
dJ/dp end to end in test_torch_adjoint_e2e.py, the element blocks in
test_torch_adjoint_blocks.py and test_torch_adjoint_blocks_hill.py.

Tolerances: 3b and the QoI partials 1e-13 of max|.| (the same float64
products summed in another order); the GMRES route 1e-8 of the dense
route; the FD drop > 5.5 decades, as tests/test_adjoint_gradient.py asks
of calibr8_tpu."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.opt.objective import ActiveParams as JaxActive
from calibr8_tpu.opt.objective import AdjointObjective as JaxObjective
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve.adjoint import Adjoint as JaxAdjoint
from calibr8_tpu.solve.linear import LinearCfg as JaxLinearCfg
from calibr8_tpu_torch.cli.main import main as cli_main
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.assembly import dense_matrix
from calibr8_tpu_torch.fem.disc import Disc
from calibr8_tpu_torch.mechanics.global_residual import MechanicsSpec
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective, fd_gradient_check
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.adjoint import Adjoint, AdjointSolveError
from calibr8_tpu_torch.solve.ellpack import assemble_ell_T, build_ell_maps, ell_spmv_plain, ell_spmv_T_plain
from calibr8_tpu_torch.solve.linear import LinearCfg
from tests.decks import BCS_2D, CUBE, ELASTIC_MAT, J2_MAT, NOTCH2D, make_deck


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- kernel 3b's plain version ------------------------------------------------

OPERATOR_DISCS = {
    # mesh, dim, mixed -> ndpn
    "cube2_mixed_ndpn4": (lambda: generators.cube(2), True),
    "cube2_displacement_ndpn3": (lambda: generators.cube(2), False),
    "notch2D_mixed_ndpn3": (lambda: generators.notch2d(0.12), True),
    "notch2D_displacement_ndpn2": (lambda: generators.notch2d(0.12), False),
}


@pytest.mark.parametrize("case", list(OPERATOR_DISCS))
def test_ell_spmv_T_plain_is_the_transpose(case):
    """A^T x from the forward-assembled A_T equals the dense A^T x and the
    forward apply of the assembly of the transposed element blocks."""
    make_mesh, mixed = OPERATOR_DISCS[case]
    mesh = make_mesh()
    disc = Disc(mesh, MechanicsSpec(dim=mesh.dim, mixed=mixed), "cpu")
    rng = np.random.default_rng(21)
    nde = disc.spec.ndofs_elem
    J_T = torch.tensor(rng.standard_normal((nde, nde, disc.n_elem)))
    x = torch.tensor(rng.standard_normal(disc.n_dofs))
    nbr_T = build_ell_maps(disc)["nbr_T"]
    d = disc.spec.dim
    y = ell_spmv_T_plain(assemble_ell_T(J_T, disc), nbr_T, x, d)
    A = dense_matrix(J_T.permute(2, 0, 1), disc.edofs, disc.n_dofs)
    assert _rel(y, A.T @ x) <= 1e-13
    y_fwd = ell_spmv_plain(assemble_ell_T(J_T.transpose(0, 1).contiguous(), disc), nbr_T, x, d)
    assert _rel(y, y_fwd) <= 1e-13


# -- the notch2D small_J2 8-step adjoint deck (tests/test_adjoint_gradient.py) --

NOTCH_J2 = make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.001), 8)
NOTCH_J2_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "K": [50.0, 150.0], "Y": [5.0, 15.0]}}}


def _jax_side(deck, inverse):
    """calibr8_tpu's objective: its primal trajectory, its sweep's dJ/dp
    (n_sets, n_params) and the canonical gradient, at the deck's values."""
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    adj = JaxAdjoint(jp.assembler, jp.qoi, jp.dbcs, JaxLinearCfg())
    active = JaxActive.from_inverse_spec(inverse, jp.disc.elem_set_names, jp.model.param_names)
    obj = JaxObjective(jp, adj, active)
    x0 = active.to_canonical(active.extract(jp.params0))
    traj = obj._solve(x0)
    params_all = obj._params_all(x0)
    grad_all, _ = adj.sweep(traj, params_all, jp.time_grid)
    g = active.grad_to_canonical(active.extract_grad(np.asarray(grad_all)),
                                 active.extract(np.asarray(params_all)))
    return dict(jp=jp, adj=adj, traj=traj, params_all=params_all, grad_all=np.asarray(grad_all),
                g=g, x0=x0)


def _port_objective(deck, inverse, linear_cfg=None):
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    adj = Adjoint(tp.assembler, tp.qoi, tp.dbcs, linear_cfg or LinearCfg())
    active = ActiveParams.from_inverse_spec(inverse, tp.disc.elem_set_names, tp.model.param_names)
    return tp, adj, AdjointObjective(tp, adj, active)


def test_qoi_partials_match_jax():
    """dJ/dx, dJ/dxi and dJ/dp of the notch deck's QoI at a state made
    from a seed."""
    jp = JaxProblem(jax_load_deck(copy.deepcopy(NOTCH_J2)))
    tp = Problem(load_deck(copy.deepcopy(NOTCH_J2)), device="cpu")
    d = tp.disc
    rng = np.random.default_rng(5)
    args = (1e-3 * rng.standard_normal(d.n_dofs), 1e-3 * rng.standard_normal(d.n_dofs),
            1e-4 * rng.standard_normal((d.n_elem, tp.model.nxi())), np.asarray(jp.params0))
    ref = jp.qoi.partials(*(jnp.asarray(a) for a in args), ())
    got = tp.qoi.partials(*(torch.tensor(a) for a in args), ())
    for a, b in zip(got, ref):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= 1e-13


def test_gmres_route_matches_dense():
    """The transposed solves through GMRES + block Gauss-Seidel on the ELL
    operator (ell_spmv_T's plain version) give the dense route's dJ/dp,
    on the notch deck's load in 2 steps (2 elements yield in the last)."""
    deck = make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.004), 2)
    tp, adj, obj = _port_objective(deck, NOTCH_J2_INVERSE)
    x0 = obj.active.to_canonical(obj.active.extract(tp.params0))
    traj = obj._solve(x0)
    params_all = obj._params_all(x0)
    g_dense, _ = adj.sweep(traj, params_all, tp.time_grid)
    gm = Adjoint(tp.assembler, tp.qoi, tp.dbcs, LinearCfg(method="gmres", tol=1e-12))
    g_gmres, _ = gm.sweep(traj, params_all, tp.time_grid)
    assert all(s["krylov_iters"] > 0 for s in gm.step_info)
    assert int(traj.path[-1].sum()) > 0
    assert _rel(g_gmres, g_dense) <= 1e-8


# -- the finite-difference check and the CLI ----------------------------------

CUBE_TRACTION = make_deck(
    CUBE, "elastic", ELASTIC_MAT,
    {"expression": {"bc 1": [0, 0, "xmin", "0.0"], "bc 2": [0, 1, "ymin", "0.0"],
                    "bc 3": [0, 2, "zmin", "0.0"]}},
    1, **{"traction bcs": {"bc 1": [0, "ymax", "0.", "1.0 * t", "0."]}},
)
CUBE_TRACTION_INVERSE = {"materials": {"body": {"E": [500.0, 2000.0], "nu": [0.1, 0.4]}}}


def test_adjoint_solve_error_on_divergence():
    _, adj, _ = _port_objective(CUBE_TRACTION, CUBE_TRACTION_INVERSE)
    for rr in (float("nan"), 0.6):
        with pytest.raises(AdjointSolveError):
            adj._check_linear(rr, 3)
    adj._check_linear(0.4, 3)


def test_fd_gradient_check_elastic_traction():
    """test_adjoint_gradient_elastic's check on the port."""
    tp, _, obj = _port_objective(CUBE_TRACTION, CUBE_TRACTION_INVERSE)
    x0 = obj.active.to_canonical(obj.active.extract(tp.params0))
    drop, errs = fd_gradient_check(obj.value, obj.gradient(x0), x0)
    assert drop > 5.5, (drop, errs)


def _write_deck(tmp_path, **inverse):
    deck = copy.deepcopy(CUBE_TRACTION)
    deck["inverse"] = {**CUBE_TRACTION_INVERSE, **inverse}
    path = tmp_path / "inverse.yaml"
    path.write_text(yaml.safe_dump({"cube_inverse": deck}))
    return str(path)


def test_cli_inverse_check_gradient(tmp_path, capsys):
    deck = _write_deck(tmp_path, **{"check gradient": True, "iteration limit": 0})
    assert cli_main(["inverse", deck, "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("gradient check")]
    assert len(line) == 1 and float(line[0].split("=")[1]) > 5.5


def test_cli_inverse_two_problems_regression(tmp_path, capsys):
    """A `problems:` deck (two tractions, one shared active set): the
    summed objective's gradient check and the regression nested under
    `inverse:`, as in calibr8_tpu's 2prob decks."""
    half = copy.deepcopy(CUBE_TRACTION)
    half["traction bcs"]["bc 1"][3] = "0.5 * t"
    deck = {"problems": {"full": copy.deepcopy(CUBE_TRACTION), "half": half},
            "inverse": {**CUBE_TRACTION_INVERSE, "check gradient": True, "iteration limit": 0,
                        "regression": {"log10 drop expected": 7.5, "log10 drop tolerance": 2.0}}}
    path = tmp_path / "two.yaml"
    path.write_text(yaml.safe_dump({"two_problems": deck}))
    assert cli_main(["inverse", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    drop = float(next(ln for ln in out.splitlines() if ln.startswith("gradient check")).split("=")[1])
    assert drop > 5.5 and " PASS" in out.splitlines()


@pytest.mark.parametrize("inverse", [{"iteration limit": 5},
                                     {"objective type": "FEMU", "check gradient": False,
                                      "iteration limit": 3}],
                         ids=["iteration_limit", "femu"])
def test_cli_inverse_optimizer_not_ported(tmp_path, monkeypatch, capsys, inverse):
    """The optimizer of `inverse` (opt/drivers.py): L-BFGS-B after the
    gradient check with an `iteration limit`, and over the value-only
    FEMU objective (scipy's finite differences).  Each exits 0 and writes
    calibrated_params.txt, its values inside the bounds, its J no larger
    than the start's.  The test keeps its earlier name, from when
    `inverse` raised here for want of the optimizer."""
    deck = _write_deck(tmp_path, **{"check gradient": True, "iteration limit": 0, **inverse})
    monkeypatch.chdir(tmp_path)
    assert cli_main(["inverse", deck, "--device", "cpu"]) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("optimization done"))
    J = float(line.split("J = ")[1].split(",")[0])
    tp, _, obj = _port_objective(CUBE_TRACTION, CUBE_TRACTION_INVERSE)
    assert J <= obj.value(obj.active.to_canonical(obj.active.extract(tp.params0)))
    params = dict(ln.split(": ") for ln in (tmp_path / "calibrated_params.txt").read_text()
                  .splitlines())
    assert sorted(params) == ["E", "nu"]
    for name, (lo, hi) in CUBE_TRACTION_INVERSE["materials"]["body"].items():
        assert lo <= float(params[name]) <= hi
