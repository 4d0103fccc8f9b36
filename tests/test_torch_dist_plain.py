"""The plain versions of the domain-decomposed solver's two kernels, and
what it refuses, on the CPU (float64):

 - kernel 1c: assembly_elems (its plain version on CPU tensors) on the
   elements that DistContext gathers for its parts equals
   fused_assembly_plain on the same elements of the Disc, column for
   column, bit for bit (pads aside), for small_J2 on notch2D h=0.22 at 5
   parts (2D mixed u/p) and hyper_J2 on cube n=2 at 4 parts (3D, x_prev);
 - 3c per part: part_ell_spmv's plain version on the parts' joint node
   space equals level_ell_spmv_plain on each part's own local matrix;
 - a multigrid deck under DistContext builds the distributed aggregation
   AMG (parallel/dist_mg.py's DistAMG, a fresh AMGPrecondFactory where the
   deck's is the geometric one), and n_parts defaults to 1 on the CPU.

States made with numpy from a seed."""

import copy

import numpy as np
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import assembly_elems, fused_assembly_plain
from calibr8_tpu_torch.parallel.dist import DistContext
from calibr8_tpu_torch.parallel.dist_mg import DistAMG
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.amg import AMGPrecondFactory
from calibr8_tpu_torch.solve.ellpack import level_ell_spmv_plain, part_ell_spmv
from calibr8_tpu_torch.solve.mg import MGPrecondFactory
from tests.decks import BCS_2D, BCS_3D, CUBE, HYPER_MAT, J2_MAT, make_deck
from tests.test_torch_hyper_assembly import hyper_state, hyper_xi_prev

CASES = (
    (make_deck({"type": "notch2D", "h": 0.22}, "small_J2", J2_MAT, BCS_2D(0.001), 1), 5, 2),
    (make_deck(CUBE, "hyper_J2", HYPER_MAT, BCS_3D(0.01), 1), 4, 3),
)


def test_plain_element_entry_and_part_apply():
    for deck, n_parts, dim in CASES:
        prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
        disc, bm = prob.disc, prob.assembler.bmodel
        ctx = DistContext(prob, n_parts=n_parts)
        coords = disc.mesh.coords
        x = torch.tensor(hyper_state(coords, disc.n_nodes, dim, True, 0.02, seed=0))
        xp = torch.tensor(hyper_state(coords, disc.n_nodes, dim, True, 0.01, seed=2))
        xi_prev = torch.tensor(hyper_xi_prev(prob.model, disc.n_elem))
        xid = ctx.to_dist_elem(xi_prev)
        got = assembly_elems(disc.spec, bm, ctx._gather_eT(ctx.to_dist(x)),
                             ctx._gather_eT(ctx.to_dist(xp)), xid.reshape(-1, bm.nxi).T,
                             ctx.gN_T, ctx.detJ, ctx.h, prob.params0, ctx.es32)
        want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0, x_prev=xp)
        cols = ctx._emask_t
        elems = ctx._esel_t[cols]
        assert 0 < int(want[3].sum()) < disc.n_elem, "single-branch state"
        for g, w in zip(got, want):
            assert torch.equal(g[..., cols], w[..., elems]), bm.name

        # 3c per part on the element Jacobians just assembled
        A_T = ctx.ell_assemble(got[1])
        rng = np.random.default_rng(3)
        part, m = ctx.part, ctx.ndpn
        x_loc = torch.tensor(rng.standard_normal((n_parts, part.N_loc, m)))
        y = part_ell_spmv(A_T, ctx.nbr_T, x_loc, m)
        N = part.N_loc
        for p in range(n_parts):
            nbr_p = torch.tensor(np.ascontiguousarray(part.nbr_local[p].T), dtype=torch.int32)
            y_p = level_ell_spmv_plain(A_T[..., p * N:(p + 1) * N].contiguous(), nbr_p,
                                       x_loc[p].reshape(-1), m)
            assert torch.equal(y[p].reshape(-1), y_p), (bm.name, p)


def test_dist_refuses_multigrid_and_defaults_to_one_part():
    """A multigrid deck under DistContext builds DistAMG (the name is from
    when it raised for want of it); n_parts defaults to 1 on the CPU."""
    deck = make_deck({"type": "notch2D", "h": 0.3, "refinements": 1}, "small_J2", J2_MAT,
                     BCS_2D(0.001), 1)
    deck["linear algebra"] = {"preconditioner": "multigrid", "method": "gmres"}
    prob = Problem(load_deck(deck), device="cpu")
    assert isinstance(prob.mg_factory, MGPrecondFactory)
    # the geometric factory's deck gets a fresh aggregation hierarchy
    ctx = DistContext(prob, n_parts=2)
    assert isinstance(ctx._mg, DistAMG) and isinstance(ctx._mg.factory, AMGPrecondFactory)
    deck = make_deck({"type": "notch2D", "h": 0.3}, "small_J2", J2_MAT, BCS_2D(0.001), 1)
    ctx = DistContext(Problem(load_deck(deck), device="cpu"))
    assert ctx._mg is None
    assert ctx.part.n_parts == 1
    assert ctx.zeros().shape == (1, ctx.part.N_own, 3)
