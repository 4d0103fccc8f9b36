"""Domain-decomposed solves: parts of the mesh, halo exchange, Export-ADD.

The counterpart of calibr8_tpu's parallel/dist.py (the reference's
parallel story: one mesh part per MPI rank, ghost-overlap assembly,
Tpetra Import / Export halo maps, Export-ADD reductions;
source/calibr8/src/linear_alg.hpp:15-53, disc.cpp:293-321).

Layout.  calibr8_tpu puts one part on each JAX device and shards its
arrays over a 'parts' mesh axis.  The port holds every part of a
DistContext on the Problem's device, stacked on a leading part axis:
DOF vectors (P, N_own, ndpn), element state (P, E_loc, nxi) and path
(P, E_loc), which is calibr8_tpu's global view of its sharded arrays.
The element arrays the kernels read are the parts laid end to end:
element e of part p is column p * E_loc + e of gN_T (npe, d, P * E_loc),
of J_T (nde, nde, P * E_loc) and of the adjoint blocks; part p's local
node space [owned | ghost] is rows p * N_loc .. (p + 1) * N_loc - 1 of a
(P * N_loc, c) node matrix.

Halo exchange.  `_exchange(buf)` turns the (P, P, H, c) send buffer,
buf[k, j] = what part k sends to part j, into what each part receives,
out[j, k] = what j receives from k: calibr8_tpu's jax.lax.all_to_all
(dist.py:222,239), here a swap of the first two axes.  Everything else is
index arithmetic on the device: the Import (owned -> ghost copy,
`halo_gather`) adds the received rows into a zeroed local block whose
pads collide on a dummy trailing row (hence an add, not a copy), the
Export-ADD (`export_add`) adds the ghost rows' partial sums onto their
owners, again through a dummy row for the pads, and the element gather
and scatter are flat index maps built once on the host.  An exchange
across cards replaces `_exchange` alone.

Kernels.  The assembly runs the element-level entry of the fused
assembly (kernel 1c, fem/fused_assembly.py assembly_elems) once for the
elements of every part; the assembled Krylov operator applies every
part's local node-block ELL matrix in one launch (kernel 3c per part,
solve/ellpack.py part_ell_spmv), then the Export-ADD; the
element-by-element operator and the line search's slope run the EBE
kernel over the parts' joint local node space.  On the CPU each runs its
plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from calibr8_tpu_torch.fem.adjoint_blocks import adjoint_blocks_elems
from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec
from calibr8_tpu_torch.fem.fused_assembly import assembly_elems
from calibr8_tpu_torch.mechanics.global_residual import make_elem_residual
from calibr8_tpu_torch.parallel.partition import build_partition
from calibr8_tpu_torch.solve.adjoint import AdjointSolveError
from calibr8_tpu_torch.solve.ellpack import assemble_ell_T_blocks, part_ell_spmv
from calibr8_tpu_torch.solve.gmres import gmres_cycle, pcg
from calibr8_tpu_torch.solve.newton import NewtonCfg, StepSolver
from calibr8_tpu_torch.utils import timers
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_pivot, gauss_solve_T


def _exchange(buf):
    """(P, P, H, c) send buffer -> what each part receives: out[j, k] =
    buf[k, j] (calibr8_tpu's tiled all_to_all over the parts axis)."""
    return buf.transpose(0, 1)


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


class DistContext:
    """The parts of one Problem's mesh and the halo-exchange operators.
    `n_parts` defaults to the number of cards on the card and to 1 on the
    CPU; any count may be asked for on one device."""

    def __init__(self, prob, n_parts=None, pad_multiple=8):
        self.prob = prob
        disc = prob.disc
        self.disc = disc
        dev = disc.device
        self.device = dev
        if n_parts is None:
            n_parts = torch.cuda.device_count() if dev.type == "cuda" else 1
        part = build_partition(disc.mesh.conn, disc.mesh.coords, n_parts,
                               pad_multiple=pad_multiple)
        self.part = part
        self.dtype = disc.dtype
        self.ndpn = disc.ndpn
        self.npe = disc.spec.npe
        self.nde = disc.spec.ndofs_elem
        self.bmodel = prob.assembler.bmodel
        self.nxi = self.bmodel.nxi
        P, E, N_own, N_loc = n_parts, part.E_loc, part.N_own, part.N_loc
        npe, ndpn = self.npe, self.ndpn

        def dev_t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        # element selection (padding -> element 0 with zeroed geometry, h 1
        # and set 0, so that tau = h^2 / 2 mu never meets 0 / 0)
        emask = part.elems >= 0
        self._esel_t = dev_t(np.where(emask, part.elems, 0).reshape(-1))
        self._emask_t = dev_t(emask.reshape(-1), torch.bool)
        m = self._emask_t.to(self.dtype)
        self.gN_T = (disc.grad_N[self._esel_t] * m[:, None, None]).permute(1, 2, 0).contiguous()
        self.detJ = (disc.detJ[self._esel_t] * m).contiguous()
        self.h = torch.where(self._emask_t, disc.h[self._esel_t], 1.0).contiguous()
        self.es = torch.where(self._emask_t, disc.es_ids[self._esel_t], 0)  # (P * E,)
        self.es32 = self.es.to(torch.int32)

        # owned-node selection (padding -> node 0, masked to zero)
        omask = part.own_nodes >= 0
        self._osel_t = dev_t(np.where(omask, part.own_nodes, 0).reshape(-1))
        self.own_mask = dev_t(omask, torch.bool)  # (P, N_own)

        # flat index maps over the parts' joint node spaces
        p_ids = np.arange(P)[:, None, None]
        conn_g = p_ids * N_loc + part.conn_local  # (P, E, npe)
        self._conn_glob = dev_t(conn_g.reshape(-1))
        # element dofs, node-interleaved, in trailing layout: row a*ndpn+c
        # of column p*E+e is local dof (p*N_loc + conn[p, e, a])*ndpn + c
        idx = conn_g.reshape(P * E, npe)[:, :, None] * ndpn + np.arange(ndpn)
        self._idx_eT = dev_t(idx.reshape(P * E, npe * ndpn).T, torch.int32)
        self._send_glob = dev_t(p_ids * (N_own + 1) + part.send_slots)  # (P, P, H)
        self._recv_glob = dev_t(p_ids * (N_loc + 1) + part.recv_slots)

        # per-part local ELL maps, laid end to end (solve/ellpack.py
        # part_ell_spmv): neighbour ids offset by p * N_loc, pad P * N_loc
        K = part.K_ell
        PN = P * N_loc
        nbr = np.where(part.nbr_local >= N_loc, PN, part.nbr_local + p_ids * N_loc)
        self.nbr_T = dev_t(nbr.reshape(PN, K).T, torch.int32)  # (K, P * N_loc)
        # ELL slot of element entry (p, e, a, b): s * PN + p * N_loc + n for
        # calibr8_tpu's row-layout slot n * K + s, the pads' N_loc * K ->
        # the dummy trailing slot K * PN; (a, b, p, e) order
        li = part.ell_idx_local.astype(np.int64)
        ids = np.where(li >= N_loc * K, K * PN, (li % K) * PN + p_ids[..., None] * N_loc + li // K)
        self._ell_ids = dev_t(ids.transpose(2, 3, 0, 1).reshape(-1))
        self._elem_res = make_elem_residual(self.bmodel, disc.spec)

        # the distributed aggregation AMG where the deck asks for multigrid
        # (parallel/dist_mg.py, calibr8_tpu dist.py:102-115): the problem's
        # AMG factory, or a fresh one where the deck's is the geometric one
        self._mg = None
        if getattr(prob, "mg_factory", None) is not None:
            from calibr8_tpu_torch.parallel.dist_mg import DistAMG
            from calibr8_tpu_torch.solve.amg import AMGPrecondFactory

            f = prob.mg_factory
            self._mg = DistAMG(self, f if isinstance(f, AMGPrecondFactory) else None)

    # -- layout converters ------------------------------------------------
    def to_dist(self, x):
        """Flat (n_dofs,) -> (P, N_own, ndpn)."""
        X = self.disc.nodemat(torch.as_tensor(x, dtype=self.dtype, device=self.device))
        part = self.part
        Xd = X[self._osel_t].reshape(part.n_parts, part.N_own, self.ndpn)
        return Xd * self.own_mask[..., None]

    def from_dist(self, Xd):
        """(P, N_own, ndpn) -> flat (n_dofs,)."""
        return self.from_dist_device(Xd.detach())

    def from_dist_device(self, Xd):
        """The differentiable dist -> flat scatter (the QoI partials take
        their gradients through it): each node is owned once, the pads
        add zeros."""
        w = self.own_mask.reshape(-1, 1).to(Xd.dtype)
        X = torch.zeros(self.part.n_nodes, self.ndpn, dtype=Xd.dtype, device=Xd.device)
        X = X.index_add(0, self._osel_t, Xd.reshape(-1, self.ndpn) * w)
        return self.disc.nodemat_to_flat(X)

    def to_dist_elem(self, a, fill=0.0):
        """(n_elem, ...) -> (P, E_loc, ...), the pads set to `fill` (a
        scalar, or a row such as the initial local state)."""
        a = torch.as_tensor(a, device=self.device)
        out = a[self._esel_t].clone()
        out[~self._emask_t] = fill
        return out.reshape((self.part.n_parts, self.part.E_loc) + tuple(a.shape[1:]))

    def from_dist_elem(self, A):
        """(P, E_loc, ...) -> (n_elem, ...) in global element order."""
        return self.from_dist_elem_device(A.detach())

    def from_dist_elem_device(self, A):
        """The differentiable form of from_dist_elem: each element lies in
        one part, the pads add zeros."""
        flat = A.reshape((-1,) + tuple(A.shape[2:]))
        w = self._emask_t.to(A.dtype).reshape((-1,) + (1,) * (A.dim() - 2))
        out = torch.zeros((self.disc.n_elem,) + tuple(A.shape[2:]), dtype=A.dtype,
                          device=A.device)
        return out.index_add(0, self._esel_t, flat * w)

    def bc_dist(self, bc_dofs, bc_vals):
        """Flat DBC dof / value arrays -> (mask (P, N_own, ndpn) bool, values)."""
        n = self.disc.n_dofs
        m = torch.zeros(n, dtype=self.dtype, device=self.device)
        g = torch.zeros(n, dtype=self.dtype, device=self.device)
        m[bc_dofs] = 1.0
        g[bc_dofs] = torch.as_tensor(bc_vals, dtype=self.dtype, device=self.device)
        return self.to_dist(m) > 0.5, self.to_dist(g)

    def zeros(self):
        part = self.part
        return torch.zeros(part.n_parts, part.N_own, self.ndpn, dtype=self.dtype,
                           device=self.device)

    def init_xi_dist(self):
        """Initial local state for every (padded) local element."""
        part = self.part
        row = torch.as_tensor(self.prob.assembler.model.init_xi(), dtype=self.dtype,
                              device=self.device)
        return row.repeat(part.n_parts, part.E_loc, 1)

    # -- halo exchange and element maps -------------------------------------
    def halo_gather(self, Vd):
        """(P, N_own, c) owned values -> (P, N_loc, c) local [owned |
        ghost] values (the Tpetra Import)."""
        part = self.part
        P, N_own, N_loc, c = part.n_parts, part.N_own, part.N_loc, Vd.shape[-1]
        xp = torch.cat([Vd, Vd.new_zeros(P, 1, c)], dim=1).reshape(-1, c)
        out = _exchange(xp[self._send_glob])  # out[j, k]: what j receives from k
        x_loc = Vd.new_zeros(P, N_loc + 1, c)
        x_loc[:, :N_own] = Vd
        # an add, not a copy: every real ghost slot receives one value, the
        # pads' zeros collide on the dummy row N_loc
        x_loc.view(-1, c).index_add_(0, self._recv_glob.reshape(-1), out.reshape(-1, c))
        return x_loc[:, :N_loc].contiguous()

    def export_add(self, Y_loc):
        """(P, N_loc, c) local rows -> (P, N_own, c): the ghost rows'
        partial sums added onto their owners (the Export-ADD)."""
        part = self.part
        P, N_own, c = part.n_parts, part.N_own, Y_loc.shape[-1]
        yp = torch.cat([Y_loc, Y_loc.new_zeros(P, 1, c)], dim=1).reshape(-1, c)
        out = _exchange(yp[self._recv_glob])  # out[j, k]: k's ghost rows owned by j
        y_own = torch.cat([Y_loc[:, :N_own], Y_loc.new_zeros(P, 1, c)], dim=1)
        y_own.view(-1, c).index_add_(0, self._send_glob.reshape(-1), out.reshape(-1, c))
        return y_own[:, :N_own].contiguous()

    def _local_scatter(self, rows):
        """(P * E_loc * npe, c) element-node rows -> (P, N_loc, c) local sums."""
        part = self.part
        out = rows.new_zeros(part.n_parts * part.N_loc, rows.shape[-1])
        out.index_add_(0, self._conn_glob, rows)
        return out.view(part.n_parts, part.N_loc, rows.shape[-1])

    def _gather_eT(self, Vd):
        """(P, N_own, ndpn) -> element dofs (nde, P * E_loc), trailing."""
        return self.halo_gather(Vd).reshape(-1)[self._idx_eT]

    def gather_elem(self, Vd):
        """(P, N_own, ndpn) -> element dof values (P, E_loc, nde)."""
        return self._gather_eT(Vd).T.reshape(self.part.n_parts, self.part.E_loc, self.nde)

    def scatter_elem(self, rows):
        """(P, E_loc, nde) element values -> assembled (P, N_own, ndpn)."""
        return self.export_add(self._local_scatter(rows.reshape(-1, self.ndpn)))

    # -- device ops --------------------------------------------------------
    def assemble(self, Xd, Xd_prev, xi_prev, params):
        """Returns (R (P, N_own, ndpn), J_T (nde, nde, P * E_loc), diag,
        xi (P, E_loc, nxi), path (P, E_loc), nfail) through the
        element-level assembly kernel, one launch for every part."""
        part = self.part
        P, E, npe, ndpn = part.n_parts, part.E_loc, self.npe, self.ndpn
        R_T, J_T, xi_T, path, fail = assembly_elems(
            self.disc.spec, self.bmodel, self._gather_eT(Xd), self._gather_eT(Xd_prev),
            xi_prev.reshape(P * E, self.nxi).T, self.gN_T, self.detJ, self.h, params, self.es32,
        )
        # one scatter for the residual and the Jacobian diagonal together
        D = torch.diagonal(J_T, 0, 0, 1)  # (P * E, nde)
        rows = torch.cat([R_T.T.reshape(-1, ndpn), D.reshape(-1, ndpn)], dim=1)
        Y = self.export_add(self._local_scatter(rows))
        xi = xi_T.T.reshape(P, E, self.nxi).contiguous()
        return (Y[..., :ndpn].contiguous(), J_T, Y[..., ndpn:].contiguous(), xi,
                path.reshape(P, E), fail.sum())

    def matvec(self, J_T, Vd):
        """Element-by-element J v: one halo gather in, the EBE kernel over
        the parts' joint local node space, one Export-ADD out."""
        part = self.part
        n_loc = part.n_parts * part.N_loc * self.ndpn
        y = ebe_matvec(J_T, self.halo_gather(Vd).reshape(-1), self._idx_eT, n_loc)
        return self.export_add(y.view(part.n_parts, part.N_loc, self.ndpn))

    def node_blocks(self, J_T):
        """(P, N_own, ndpn, ndpn) node-diagonal blocks of the assembled
        operator (for the block Gauss-Seidel preconditioner)."""
        part = self.part
        npe, ndpn = self.npe, self.ndpn
        J5 = J_T.reshape(npe, ndpn, npe, ndpn, -1)
        self_blocks = torch.stack([J5[n, :, n] for n in range(npe)])  # (npe, ndpn, ndpn, PE)
        rows = self_blocks.permute(3, 0, 1, 2).reshape(-1, ndpn * ndpn)
        blocks = self.export_add(self._local_scatter(rows))
        return blocks.reshape(part.n_parts, part.N_own, ndpn, ndpn)

    def ell_assemble(self, J_T):
        """Every part's local node-block ELL matrix of the (possibly
        pre-swapped) element Jacobians, laid end to end: A_T (K, ndpn,
        ndpn, P * N_loc), one index_add_ into a dummy trailing slot that
        takes the pad elements' entries; once per Krylov solve."""
        part = self.part
        return assemble_ell_T_blocks(J_T, self._ell_ids, part.K_ell, part.n_parts * part.N_loc,
                                     self.ndpn)

    def ell_matvec(self, A_T, Vd):
        """The assembled per-part apply: one halo gather in, kernel 3c per
        part (one launch for every part), one Export-ADD out, which adds
        the ghost rows' partial sums onto their owners."""
        return self.export_add(part_ell_spmv(A_T, self.nbr_T, self.halo_gather(Vd), self.ndpn))

    def adjoint_blocks(self, Xd, XPd, xi, xi_prev, path, params):
        """All adjoint element blocks (fem/adjoint_blocks.py) for the
        elements of every part: {name: (rows, cols, P * E_loc)}."""
        nxi = self.nxi
        return adjoint_blocks_elems(
            self.bmodel, self.disc.spec, self._elem_res, self._gather_eT(Xd),
            self._gather_eT(XPd), xi.reshape(-1, nxi).T, xi_prev.reshape(-1, nxi).T,
            path.reshape(-1), self.gN_T, self.detJ, self.h, params[self.es].T,
        )

    # -- linear solve ------------------------------------------------------
    def dirichlet_blocks(self, blocks, diag, bc_mask):
        """Node blocks (P, N_own, ndpn, ndpn) with the Dirichlet rows
        replaced by diag times the identity's and identity blocks on the
        padded owned slots (calibr8_tpu dist.py:616-661): what the block
        preconditioners invert."""
        eye = torch.eye(self.ndpn, dtype=blocks.dtype, device=blocks.device)
        rowsel = bc_mask.to(blocks.dtype)[..., None]  # (P, N, ndpn, 1)
        blocks = blocks * (1.0 - rowsel) + rowsel * eye * diag[..., None]
        padsel = (~self.own_mask).to(blocks.dtype)[..., None, None]
        return blocks * (1.0 - padsel) + padsel * eye

    def make_precond(self, J_T, diag, bc_mask, transpose=False):
        """calibr8_tpu's block u/p Gauss-Seidel on the parts (dist.py:
        616-661): pivoted solves of the d x d node blocks, Dirichlet rows
        scaled by the assembled diagonal, identity blocks on the padded
        owned slots; transpose=True (J_T pre-swapped) applies the
        transpose of the forward preconditioner."""
        blocks = self.node_blocks(J_T)  # (P, N_own, ndpn, ndpn)
        if transpose:
            blocks = blocks.transpose(-1, -2)
        d = self.disc.spec.dim
        blocks = self.dirichlet_blocks(blocks, diag, bc_mask)
        Au = blocks[..., :d, :d]
        Au_inv = gauss_solve_pivot(Au, torch.eye(d, dtype=blocks.dtype,
                                                 device=blocks.device).expand(Au.shape))
        if self.disc.spec.mixed:
            Apu = blocks[..., d, :d]  # (P, N, d)
            app = blocks[..., d, d]
            app = torch.where(app.abs() > 1e-300, app, torch.ones_like(app))
        else:
            Apu = app = None

        def M(r):
            if transpose:
                if Apu is None:
                    return torch.einsum("pnji,pnj->pni", Au_inv, r[..., :d])
                zp = r[..., d] / app
                ru = r[..., :d] - Apu * zp[..., None]
                zu = torch.einsum("pnji,pnj->pni", Au_inv, ru)
                return torch.cat([zu, zp[..., None]], dim=-1)
            zu = torch.einsum("pnij,pnj->pni", Au_inv, r[..., :d])
            if Apu is None:
                return zu
            rp = r[..., d] - torch.einsum("pnj,pnj->pn", Apu, zu)
            return torch.cat([zu, (rp / app)[..., None]], dim=-1)

        return M

    def solve_linear(self, cfg, J_T, diag, b, bc_mask, transpose=False, return_iters=False):
        """Solve J x = b with Dirichlet rows diag * x_row = b_row, every
        vector (P, N_own, ndpn); transpose=True expects J_T's element row
        and column axes already swapped and switches the preconditioner to
        the transposed forward one (with a multigrid deck, DistAMG's
        mirrored cycle of the swapped blocks).  The operator is every part's ELL
        matrix (kernel 3c per part) or, with cfg.operator "ebe", the
        element Jacobians.  Returns (x, relres[, Krylov iterations])."""
        if cfg.operator != "ebe":
            A_T = self.ell_assemble(J_T)

            def apply(v):
                return self.ell_matvec(A_T, v)

        else:

            def apply(v):
                return self.matvec(J_T, v)

        def op(v):
            return torch.where(bc_mask, diag * v, apply(v))

        if self._mg is not None:
            M = self._mg.make(J_T, diag, bc_mask, op, transpose=transpose)
        else:
            M = self.make_precond(J_T, diag, bc_mask, transpose=transpose)
        x, relres, ki = _krylov(cfg, op, M, b)
        return (x, relres, ki) if return_iters else (x, relres)


def _krylov(cfg, op, M, b):
    """calibr8_tpu's dist Krylov loop (dist.py:716-786) on flattened
    vectors: PCG with max(refine_iters, 1) correction solves for method
    cg, else right-preconditioned GMRES(m) with its guarded manual
    restarts from the true residual (an in-cycle target of 0.1 atol, a
    full-length cycle after a no-progress one, a candidate kept only if it
    improves, two no-progress cycles end the solve).  Dot products run over
    the padded owned slots, which stay zero.  Returns (x, relres, Krylov
    iterations)."""
    shape = b.shape

    def opf(v):
        return op(v.view(shape)).reshape(-1)

    def Mf(v):
        return M(v.view(shape)).reshape(-1)

    bf = b.reshape(-1)
    norm_b = _norm(bf)
    safe_nb = norm_b if norm_b > 0 else 1.0
    method = "gmres" if cfg.method in ("auto", "dense") else cfg.method
    if method == "cg":
        x, _ = pcg(opf, bf, Mf, cfg.tol, cfg.max_iters)
        for _ in range(max(cfg.refine_iters, 1)):
            r = bf - opf(x)
            dx, _ = pcg(opf, r, Mf, cfg.tol, cfg.max_iters)
            if _norm(r) > cfg.tol * norm_b:
                x = x + dx
        return x.view(shape), _norm(bf - opf(x)) / safe_nb, 0
    if method != "gmres":
        raise NotImplementedError(f"linear algebra method {cfg.method!r} is not ported")

    restart = min(cfg.restart, bf.numel())
    n_outer = max(1, -(-cfg.max_iters // restart)) + max(cfg.refine_iters, 1)
    atol = cfg.tol * norm_b

    def opM(v):
        return opf(Mf(v))

    x = torch.zeros_like(bf)
    stag, ki = 0, 0
    for _ in range(n_outer):
        r = bf - opf(x)
        rn = _norm(r)
        cyc_atol = 0.0 if stag > 0 else 0.1 * atol
        dy, _, k_used = gmres_cycle(opM, r, restart, cyc_atol)
        ki += k_used
        cand = x + Mf(dy)
        rn_new = _norm(bf - opf(cand))
        better = np.isfinite(rn_new) and rn_new < rn
        if better:
            x = cand
        progress = better and rn_new <= 0.95 * rn
        stag = 0 if progress else stag + 1
        if min(rn_new, rn) <= atol or stag >= 2:
            break
    return x.view(shape), _norm(bf - opf(x)) / safe_nb, ki


class DistStepSolver(StepSolver):
    """The primal Newton + Armijo line search on the parts: the port's
    StepSolver with the assembly, the slope and the linear solve
    overridden and no multigrid state.  The `bc_dofs` / `bc_vals`
    arguments carry the (mask, values) dist arrays of bc_dist."""

    def __init__(self, ctx: DistContext, cfg: NewtonCfg):
        super().__init__(ctx.prob.assembler, cfg)
        self.ctx = ctx

    def _assemble(self, x, x_prev, xi_prev, params, bc_mask, bc_vals, ext_force):
        R, J_T, diag, xi, path, nfail = self.ctx.assemble(x, x_prev, xi_prev, params)
        R = torch.where(bc_mask, diag * (x - bc_vals), R - ext_force)
        return dict(xi=xi, path=path, nfail=int(nfail), R=R, J_T=J_T, diag=diag, norm=_norm(R))

    def _slope(self, J_T, diag, R, dx, bc_mask) -> float:
        Adx = torch.where(bc_mask, diag * dx, self.ctx.matvec(J_T, dx))
        return float(torch.sum(R * Adx))

    def _linear_solve(self, base, bc_mask):
        dx, relres, ki = self.ctx.solve_linear(self.cfg.linear, base["J_T"], base["diag"],
                                               -base["R"], bc_mask, return_iters=True)
        self.krylov_iters.append(ki)
        self.linear_relres.append(relres)
        return self._check_linear(dx, relres)

    def _maybe_build_mg_state(self, base, bc_mask):
        self._mg_state = None


class DistAdjoint:
    """The backward (in pseudo-time) adjoint sweep on the parts, with the
    math of solve/adjoint.py's Adjoint: the history vectors f / g are
    element arrays of the parts, the transposed condensed solve runs on
    pre-swapped element blocks with the forward per-part apply, and dJ/dp
    is a sum over element sets.  The QoI partials are torch.autograd
    gradients through the dist -> global scatters (calibr8_tpu dist.py:
    835-977).  After a sweep, `step_info` holds each step's relative
    residual and Krylov iteration count (backward order)."""

    def __init__(self, ctx: DistContext, qoi=None, linear_cfg=None):
        self.ctx = ctx
        self.qoi = qoi if qoi is not None else ctx.prob.qoi
        cfg = linear_cfg or ctx.prob.step_solver.cfg.linear
        self.linear_cfg = dataclasses.replace(
            cfg, tol=min(cfg.tol, 1e-8), refine_iters=max(cfg.refine_iters, 2)
        )
        self.step_info: list[dict] = []

    def _qoi_partials(self, Xd, XPd, xi, params, aux):
        if self.qoi is None:
            return torch.zeros_like(Xd), torch.zeros_like(xi), torch.zeros_like(params)
        ctx = self.ctx
        args = [a.detach().requires_grad_(True) for a in (Xd, xi, params)]
        with torch.enable_grad():
            J = self.qoi.evaluate(ctx.from_dist_device(args[0]), ctx.from_dist_device(XPd),
                                  ctx.from_dist_elem_device(args[1]), args[2], aux)
            grads = torch.autograd.grad(J, args, allow_unused=True)
        return tuple(torch.zeros_like(a) if g is None else g for a, g in zip(args, grads))

    def step(self, Xd, XPd, xi, xi_prev, path, params, f, g, bc_mask, aux=()):
        """One backward step: (z, phi, f_next, g_next, dgrad, relres, Krylov
        iterations); f (P, E_loc, nde), g and phi (P, E_loc, nxi)."""
        ctx = self.ctx
        P, E = ctx.part.n_parts, ctx.part.E_loc
        dev = ctx.device
        with timers.phase("adjoint/blocks", dev):
            B = ctx.adjoint_blocks(Xd, XPd, xi, xi_prev, path, params)
            dJ_dX, dJ_dxi, dJ_dp = self._qoi_partials(Xd, XPd, xi, params, aux)
            # RHS = -dJ/dx + scatter[ f + dxi_dx^T (g - dJ/dxi) ]
            g_modT = (g - dJ_dxi).reshape(P * E, -1).T  # (nxi, PE)
            rhs_eT = f.reshape(P * E, -1).T + torch.einsum("ije,ie->je", B["dxi_dx_T"], g_modT)
            rhs = -dJ_dX + ctx.scatter_elem(rhs_eT.T.reshape(P, E, -1))
            rhs = torch.where(bc_mask, 0.0, rhs)
            J_total_T = B["J_total_T"]
            diag = ctx.scatter_elem(torch.diagonal(J_total_T, 0, 0, 1).reshape(P, E, -1))
        with timers.phase("adjoint/krylov", dev):
            # transpose FIRST, then the Dirichlet rows (adjoint.cpp:133-145)
            z, relres, ki = ctx.solve_linear(
                self.linear_cfg, J_total_T.transpose(0, 1).contiguous(), diag, rhs, bc_mask,
                transpose=True, return_iters=True)
        with timers.phase("adjoint/post", dev):
            z_eT = ctx._gather_eT(z)  # (nde, PE)
            rhs_phiT = g_modT - torch.einsum("jie,je->ie", B["dR_dxi_T"], z_eT)
            phiT = gauss_solve_T(B["dC_dxi_T"].transpose(0, 1), rhs_phiT[:, None, :])[:, 0, :]
            f_next = -torch.einsum("ije,ie->je", B["dC_dxprev_T"], phiT).T.reshape(P, E, -1)
            g_next = -torch.einsum("ije,ie->je", B["dC_dxiprev_T"], phiT).T.reshape(P, E, -1)
            # parameter gradient: (dC/dp)^T phi + (dR/dp)^T z, summed per
            # element set, + dJ/dp
            grad_e = (torch.einsum("ipe,ie->ep", B["dC_dp_T"], phiT)
                      + torch.einsum("jpe,je->ep", B["dR_dp_T"], z_eT))
            grad = torch.zeros_like(params).index_add_(0, ctx.es, grad_e) + dJ_dp
        return z, phiT.T.reshape(P, E, -1), f_next, g_next, grad, relres, ki

    def sweep(self, traj, params_all, time_grid, dbcs=None):
        """traj is the dict of DistPrimal.run.  Returns (grad, {step: (z, phi)})."""
        ctx = self.ctx
        dbcs = dbcs or ctx.prob.dbcs
        P, E = ctx.part.n_parts, ctx.part.E_loc
        opts = dict(dtype=ctx.dtype, device=ctx.device)
        f = torch.zeros(P, E, ctx.nde, **opts)
        g = torch.zeros(P, E, ctx.nxi, **opts)
        grad = torch.zeros_like(params_all)
        zs = {}
        self.step_info = []
        for step in range(time_grid.num_steps, 0, -1):
            t = time_grid.time(step)
            bc_dofs, bc_vals = dbcs.arrays(t, step)
            bc_mask, _ = ctx.bc_dist(bc_dofs, torch.zeros_like(bc_vals))
            aux = (self.qoi.setup_step(step, t, time_grid.dt(step), time_grid.total_time)
                   if self.qoi is not None else ())
            with timers.phase("adjoint/step", ctx.device):
                z, phi, f, g, dgrad, relres, ki = self.step(
                    traj["x"][step], traj["x"][step - 1], traj["xi"][step], traj["xi"][step - 1],
                    traj["path"][step], params_all, f, g, bc_mask, aux,
                )
            if not np.isfinite(relres) or relres > 0.5:
                raise AdjointSolveError(
                    f"dist adjoint linear solve diverged at step {step} "
                    f"(relative residual {relres:.3e})"
                )
            self.step_info.append(dict(step=step, relres=relres, krylov_iters=ki))
            grad = grad + dgrad
            zs[step] = (z, phi)
        return grad, zs


class DistPrimal:
    """The load-stepping loop on the parts (solve/primal.py's Primal.run);
    the QoI is evaluated on the device-scattered global view."""

    def __init__(self, ctx: DistContext, cfg: NewtonCfg | None = None):
        self.ctx = ctx
        self.solver = DistStepSolver(ctx, cfg or ctx.prob.step_solver.cfg)

    def run(self, params_all=None, qoi_eval=True):
        """Returns dict(x, xi, path: per-step lists from step 0,
        qoi_values, newton_info: per step from step 1)."""
        ctx = self.ctx
        prob = ctx.prob
        params = prob.params0 if params_all is None else params_all
        tg = prob.time_grid
        x = ctx.zeros()
        xi = ctx.init_xi_dist()
        path = torch.zeros(ctx.part.n_parts, ctx.part.E_loc, dtype=torch.int32,
                           device=ctx.device)
        traj = dict(x=[x], xi=[xi], path=[path], qoi_values=[], newton_info=[])
        for step in range(1, tg.num_steps + 1):
            t = tg.time(step)
            bc_dofs, bc_vals = prob.dbcs.arrays(t, step)
            bc_mask, bc_g = ctx.bc_dist(bc_dofs, bc_vals)
            ext = ctx.to_dist(prob.tbcs.array(t)) if prob.tbcs is not None else ctx.zeros()
            x_new, xi_new, path_new, info = self.solver.solve_at_step(
                x, x, xi, params, bc_mask, bc_g, ext, step=step
            )
            J_step = 0.0
            if qoi_eval and prob.qoi is not None:
                aux = prob.qoi.setup_step(step, t, tg.dt(step), tg.total_time)
                J_step = float(prob.qoi.evaluate(
                    ctx.from_dist_device(x_new), ctx.from_dist_device(x),
                    ctx.from_dist_elem_device(xi_new), params, aux,
                ))
            traj["x"].append(x_new)
            traj["xi"].append(xi_new)
            traj["path"].append(path_new)
            traj["qoi_values"].append(J_step)
            traj["newton_info"].append(info)
            x, xi, path = x_new, xi_new, path_new
        return traj
