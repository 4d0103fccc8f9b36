"""The jitted step solver: Newton and GMRES with no host read inside a
chunk, replayed from CUDA graphs.

The counterpart of calibr8_tpu's solve/jit_newton.py, whose whole Newton
loop per load step is one XLA program (lax.while_loop, a fixed-budget
backtracking damping, calibr8_tpu's in-program linear solve), and whose
trajectory is a lax.scan over steps that experiments batch with
jax.vmap.  Here the step is cut into pieces whose tensor work reads
nothing back to the host:

  head        assemble at the carry's x (kernel 1b / 1c or 1a), the
              Dirichlet rows, ||R||, norm0, the conv / fail flags, b = -R
              and the linear solve's setup (the ELL operator and block
              GS, or the dense solve)
  cycle_head  a restart cycle's true residual and start
  chunk       `chunk` GMRES iterations, k static in each (3a, block GS)
  cycle_tail  the back substitution, the cycle's update and stagnation
  tail        the `ls_evals` trial assemblies and the damped update

and a host loop that reads one flag after each head (conv, fail), one
after each chunk (the cycle's `active`), one after each restart cycle but
the last, and the outputs once at the end.  All state lives in static
device buffers (`_StepProgram`).  On CPU tensors the pieces run as they
come (the tests' route).  On the card JitStepSolver and JitTrajectory
capture each piece once into a torch.cuda.CUDAGraph,
all from one memory pool, after a warm-up of every piece on a side
stream, and replay them; a capture or replay that fails raises.  The
ctypes-bound kernels bake their pointers and scalars into a graph, so
every input is copied into a static buffer before the replays, and
nothing a graph reads is reallocated.  A graph's kernel launches are
counted at each replay (kernels.recording / kernels.replayed).  A graph
also reads what the assembly kernels keep on the card between launches
(the assembler's const_state: the hybrid's network in constant memory),
so a replay raises once that has changed since the capture.

make_jit_step is the uncaptured step function; calibr8_tpu's jax.jit of
it is the captured one here.  JitTrajectory is calibr8_tpu's
make_jit_trajectory.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.fem.bcs import apply_dbcs_residual
from calibr8_tpu_torch.solve.gmres import EagerRunner
from calibr8_tpu_torch.solve.linear import LinearCfg, SyncFreeSolve


class _NewtonCarry(NamedTuple):
    """calibr8_tpu's carry as device buffers: x, xi, path, norm, norm0,
    and `status` (1 conv, 2 a failed local solve), which the host reads in
    place of it / done / failed."""

    x: torch.Tensor
    xi: torch.Tensor
    path: torch.Tensor
    norm: torch.Tensor
    norm0: torch.Tensor
    status: torch.Tensor


class _StepProgram:
    """make_jit_step's body over static buffers: inputs, carry, the linear
    solve's, and the Krylov count of each Newton iteration."""

    def __init__(self, assembler, max_iters, abs_tol, rel_tol, ls_evals, linear_cfg, params,
                 n_bc: int):
        disc = assembler.disc
        self.assembler, self.disc = assembler, disc
        self.max_iters, self.abs_tol, self.rel_tol = int(max_iters), float(abs_tol), float(rel_tol)
        self.ls_evals = int(ls_evals)
        n, E, nxi = disc.n_dofs, disc.n_elem, assembler.bmodel.nxi
        dev = disc.device
        z = dict(dtype=disc.dtype, device=dev)
        self.x_prev = torch.zeros(n, **z)
        self.xi_prev = torch.zeros(E, nxi, **z)
        self.params = torch.zeros(tuple(params.shape), **z)
        self.bc_dofs = torch.zeros(n_bc, dtype=torch.int64, device=dev)
        self.bc_vals = torch.zeros(n_bc, **z)
        self.ext = torch.zeros(n, **z)
        self.carry = _NewtonCarry(
            x=torch.zeros(n, **z), xi=torch.zeros(E, nxi, **z),
            path=torch.zeros(E, dtype=torch.int32, device=dev), norm=torch.zeros((), **z),
            norm0=torch.zeros((), **z), status=torch.zeros((), dtype=torch.int32, device=dev))
        self.diag = torch.zeros(n, **z)
        self.lin = SyncFreeSolve(linear_cfg, disc)
        self.ki_hist = torch.zeros(max(self.max_iters, 1), dtype=torch.int32, device=dev)
        self.it_dev = torch.zeros(1, dtype=torch.int64, device=dev)
        self.const = None

    def pin_const_state(self):
        """Note the assembler's kernel state on the card (before a capture,
        which bakes it in)."""
        self.const = self.assembler.const_state()

    def check_const_state(self):
        """Raise if the assembler's kernel state on the card is not the one
        pinned: a replay would read the other one."""
        if self.assembler.const_state() != self.const:
            raise RuntimeError(
                "the assembly kernels' state on the card (the hybrid's network in constant "
                "memory) is not the one this jitted step captured: another network's kernel "
                "launched since; build a new solver")

    def load(self, x0, x_prev, xi_prev, params, bc_dofs, bc_vals, ext):
        """Copy a step's inputs into the static buffers."""
        kernels.require(tuple(params.shape) == tuple(self.params.shape),
                        f"params has shape {tuple(params.shape)}, the captured step "
                        f"{tuple(self.params.shape)}")
        kernels.require(bc_dofs.shape == self.bc_dofs.shape,
                        f"{bc_dofs.numel()} Dirichlet dofs, the captured step "
                        f"{self.bc_dofs.numel()}")
        self.carry.x.copy_(x0)
        self.x_prev.copy_(x_prev)
        self.xi_prev.copy_(xi_prev)
        self.params.copy_(params)
        self.bc_dofs.copy_(bc_dofs)
        self.bc_vals.copy_(bc_vals)
        self.ext.copy_(ext)
        self.carry.norm0.fill_(float("nan"))
        self.ki_hist.zero_()
        self.it_dev.zero_()

    def _residual(self, x):
        R, J_T, diag, xi, path, nfail = self.assembler.assemble(x, self.xi_prev, self.params,
                                                                x_prev=self.x_prev)
        return R - self.ext, J_T, diag, xi, path, nfail

    def head(self):
        c = self.carry
        R, J_T, diag, xi, path, nfail = self._residual(c.x)
        R = apply_dbcs_residual(R, diag, c.x, self.bc_dofs, self.bc_vals)
        norm = torch.linalg.vector_norm(R)
        norm0 = torch.where(torch.isnan(c.norm0), norm, c.norm0)
        conv = (norm < self.abs_tol) | (norm / torch.clamp_min(norm0, 1e-300) < self.rel_tol)
        c.status.copy_(conv.to(torch.int32) + 2 * (nfail > 0).to(torch.int32))
        c.norm.copy_(norm)
        c.norm0.copy_(norm0)
        c.xi.copy_(xi)
        c.path.copy_(path)
        self.diag.copy_(diag)
        self.lin.b.copy_(-R)
        self.lin.setup(J_T, diag, self.bc_dofs)

    def tail(self):
        """The fixed budget of trials (each halves alpha where the merit
        grows or a local solve fails; the trial's Dirichlet rows take the
        base assembly's diag), then x + alpha dx."""
        c, dx = self.carry, self.lin.x
        phi0 = 0.5 * c.norm * c.norm
        alpha = torch.ones((), dtype=dx.dtype, device=dx.device)
        for _ in range(self.ls_evals):
            x_t = c.x + alpha * dx
            R_t, _, _, _, _, nfail_t = self._residual(x_t)
            R_t = apply_dbcs_residual(R_t, self.diag, x_t, self.bc_dofs, self.bc_vals)
            bad = (0.5 * torch.sum(R_t * R_t) > phi0) | (nfail_t > 0)
            alpha = torch.where(bad, alpha * 0.5, alpha)
        c.x.copy_(c.x + alpha * dx)
        self.ki_hist.index_copy_(0, self.it_dev, self.lin.ki.view(1))
        self.it_dev.add_(1)

    def warm_up(self):
        """Every piece once, as it comes (the warm-up before a capture)."""
        self.head()
        if self.lin.method == "gmres":
            self.lin.cycle_head()
            self.lin.cycle.step(self.lin._opM, 0)
            self.lin.cycle_tail()
        self.tail()

    def newton(self, runner):
        """calibr8_tpu's while_loop on the host: returns (failed, it)."""
        it, done, failed = 1, False, False
        while it <= self.max_iters:
            runner.run(("head",), self.head)
            s = runner.read(self.carry.status)
            if s & 1:
                done, failed = True, bool(s & 2)
                break
            self.lin.run(runner)
            runner.run(("tail",), self.tail)
            it += 1
            if s & 2:
                failed = True
                break
        return failed or not done, it

    def solve(self, runner, x0, x_prev, xi_prev, params, bc_dofs, bc_vals, ext):
        """One step: (x, xi, path, norm (0-d), failed, info)."""
        t0 = time.perf_counter()
        reads0, replays0 = runner.reads, runner.n_replays
        self.load(x0, x_prev, xi_prev, params, bc_dofs, bc_vals, ext)
        if self.max_iters < 1:
            # calibr8_tpu's carry before the loop: the assembly at x0
            runner.run(("head",), self.head)
            failed, it = True, 1
        else:
            failed, it = self.newton(runner)
        c = self.carry
        out = torch.cat([c.norm.view(1).double(), self.ki_hist.double()]).cpu()
        runner.reads += 1
        # a tail, so a linear solve, ran for every Newton iteration but the last head
        krylov = [int(v) for v in out[1:it]]
        info = dict(resid_norm=float(out[0]), iterations=it, krylov_iters=krylov,
                    replays=runner.n_replays - replays0,
                    host_reads=runner.reads - reads0, seconds=time.perf_counter() - t0)
        return c.x.clone(), c.xi.clone(), c.path.clone(), c.norm.clone(), failed, info


class GraphRunner:
    """Captures each piece of a _StepProgram into a CUDA graph at its first
    call, from one memory pool, and replays it after.

    Pool discipline: every buffer that one piece writes and another reads
    is allocated before any capture, or by the head, the first piece
    captured (the ELL matrix and preconditioner it builds); every other
    allocation inside a graph is a temporary of that graph.  So the pieces
    may be replayed in any order, never at once."""

    def __init__(self, prog: _StepProgram):
        dev = prog.disc.device
        self.prog, self.device = prog, dev
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.graphs: dict = {}
        self.recorded: dict = {}
        self.replays: dict = {}
        self.reads = 0
        self.n_replays = 0
        self.warmed = False

    def warm_up(self):
        """Run every piece once on the side stream (the kernels' first
        launches, cuBLAS's handles, the ELL maps' upload), so that no
        capture meets a first-use call."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.prog.warm_up()
        cur.wait_stream(self.stream)
        self.prog.pin_const_state()
        self.warmed = True

    def capture(self, key, fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream), kernels.recording() as rec:
            g.capture_begin(pool=self.pool)
            try:
                fn()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass
                raise
            g.capture_end()
        self.graphs[key], self.recorded[key], self.replays[key] = g, rec, 0

    def run(self, key, fn):
        if key not in self.graphs:
            self.capture(key, fn)
        self.graphs[key].replay()
        kernels.replayed(self.recorded[key])
        self.replays[key] += 1
        self.n_replays += 1

    def read(self, t):
        self.reads += 1
        return t.item()

    def launches_from(self, replays: dict) -> dict:
        """{counter: launches} that `replays` ({graph key: replays}, e.g.
        the difference of two snapshots of self.replays) made: each graph's
        recorded launches times its replays."""
        out: dict = {}
        for key, n in replays.items():
            for k, v in self.recorded[key].launches.items():
                out[k] = out.get(k, 0) + v * n
        return out


def _runner_for(prog):
    return GraphRunner(prog) if prog.disc.device.type == "cuda" else EagerRunner()


def _solve(prog, runner, *inputs):
    if isinstance(runner, GraphRunner):
        if not runner.warmed:
            prog.load(*inputs)
            runner.warm_up()
        prog.check_const_state()
    return prog.solve(runner, *inputs)


def make_jit_step(assembler, max_iters: int = 15, abs_tol: float = 1e-8, rel_tol: float = 1e-8,
                  ls_evals: int = 2, linear_cfg=None):
    """step(x0, x_prev, xi_prev, params, bc_dofs, bc_vals, ext) -> (x, xi,
    path, norm, failed): calibr8_tpu's make_jit_step, run uncaptured (its
    pieces as they come, on any device).  linear_cfg defaults to the dense
    solve, as calibr8_tpu's does."""
    linear_cfg = linear_cfg or LinearCfg(method="dense")
    progs: dict = {}

    def step(x0, x_prev, xi_prev, params, bc_dofs, bc_vals, ext):
        key = (tuple(params.shape), bc_dofs.numel())
        if key not in progs:
            progs[key] = _StepProgram(assembler, max_iters, abs_tol, rel_tol, ls_evals,
                                      linear_cfg, params, bc_dofs.numel())
        x, xi, path, norm, failed, _ = progs[key].solve(EagerRunner(), x0, x_prev, xi_prev,
                                                        params, bc_dofs, bc_vals, ext)
        return x, xi, path, norm, failed

    return step


class JitTrajectory:
    """calibr8_tpu's make_jit_trajectory: the load steps' BC values
    computed up front, then one step per load step, from zero x and the
    model's initial xi.  Calling it with params (n_sets, P) returns (xs,
    xis, paths, norms, fails) stacked over steps; on the card every step
    replays the captured pieces.  run_batch(params (B, n_sets, P)) runs
    one trajectory per experiment and stacks the outputs (calibr8_tpu's
    jax.vmap(run))."""

    def __init__(self, assembler, time_grid, dbcs, max_iters: int = 15, abs_tol: float = 1e-8,
                 rel_tol: float = 1e-8, ls_evals: int = 2, linear_cfg=None):
        disc = assembler.disc
        self.assembler, self.disc = assembler, disc
        self.cfg = (max_iters, abs_tol, rel_tol, ls_evals, linear_cfg or LinearCfg(method="dense"))
        self.bc_dofs, _ = dbcs.arrays(0.0)
        self.bc_vals = torch.stack([
            torch.as_tensor(dbcs.values(time_grid.time(s), s), dtype=disc.dtype,
                            device=disc.device)
            for s in range(1, time_grid.num_steps + 1)])
        self.prog = None
        self.runner = None

    def __call__(self, params):
        disc = self.disc
        if self.prog is None:
            self.prog = _StepProgram(self.assembler, *self.cfg, params, self.bc_dofs.numel())
            self.runner = _runner_for(self.prog)
        x = disc.zero_x()
        init = torch.as_tensor(self.assembler.model.init_xi(), dtype=disc.dtype,
                               device=disc.device)
        xi = init[None, :].repeat(disc.n_elem, 1)
        ext = disc.zero_x()
        outs = []
        for bc_v in self.bc_vals:
            x_new, xi_new, path, norm, failed, _ = _solve(
                self.prog, self.runner, x, x, xi, params, self.bc_dofs, bc_v, ext)
            outs.append((x_new, xi_new, path, norm, torch.tensor(failed)))
            x, xi = x_new, xi_new
        return tuple(torch.stack(t) for t in zip(*outs))

    def run_batch(self, params_batch):
        runs = [self(p) for p in params_batch]
        return tuple(torch.stack(t) for t in zip(*runs))


class JitStepSolver:
    """The step solver of a `global residual: {solver: jitted}` deck, with
    StepSolver's solve_at_step contract: the fixed-budget damping of
    make_jit_step (`line search: max evals` trials), no convergence
    prints, no multigrid (Problem refuses such a deck), and a failed step
    raises NewtonSolveError.  On the card the step is captured once, at
    the first call, and replayed after; `runner` holds its graphs and
    their replay counts.  info: resid_norm, iterations (as StepSolver's),
    krylov_iters, replays, host_reads, seconds."""

    def __init__(self, assembler, cfg):
        self.assembler = assembler
        self.cfg = cfg
        self.mg_factory = None
        self.prog = None
        self.runner = None

    def solve_at_step(self, x, x_prev, xi_prev, params, bc_dofs, bc_vals, ext_force,
                      step: int = 0):
        from calibr8_tpu_torch.solve.newton import NewtonSolveError

        cfg = self.cfg
        if self.prog is None:
            self.prog = _StepProgram(self.assembler, cfg.max_iters, cfg.abs_tol, cfg.rel_tol,
                                     cfg.line_search.max_evals, cfg.linear, params,
                                     bc_dofs.numel())
            self.runner = _runner_for(self.prog)
        x_new, xi, path, norm, failed, info = _solve(self.prog, self.runner, x, x_prev, xi_prev,
                                                     params, bc_dofs, bc_vals, ext_force)
        if failed:
            raise NewtonSolveError(
                f"jitted primal step {step} failed "
                f"(|R| = {info['resid_norm']:.3e} after {cfg.max_iters} iters)")
        return x_new, xi, path, info
