"""The new CUDA element code built for the host with g++ and held against
the port's plain versions on this CPU, float64, without FMA contraction
(-ffp-contract=off, as the kernel libraries are built with -fmad=false):

 - csrc/c8_hybrid.cuh's network through the hybrid's sigma_yield on
   Dual<double, 1> (NN(in_scale alpha) on duals, NN(0) on plain T, the
   element's constant ElemConst), for
   every activation and two topologies, at weights and alpha made with
   numpy from a seed, against BatchedHybridHyperJ2PlaneStress._sigma_yield
   under torch.func.jvp: value and tangent to 1e-13 of their max;
 - c8::implicit_element with the hybrid over every element of its twin
   case's notch2D h=0.3 (the state of tests/test_torch_hybrid_assembly.py,
   some elements plastic), and c8::assemble_element's displacement-only
   rows with IsotropicElastic on cube n=2 (3D) and notch2D h=0.3 (2D),
   against fused_assembly_plain: path and fail equal, local counts equal,
   xi, R and J to 1e-13 of their max.

The element code is __host__ __device__ (C8_HD is `inline` off nvcc), so
this is the source the kernels run, compiled for the host: the only check
the two kernels get before the card.  Skips where no g++ is found."""

import copy
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import _quad_array, fused_assembly_plain, row_thickness
from calibr8_tpu_torch.models import HybridHyperJ2PlaneStress
from calibr8_tpu_torch.models.batched import BatchedHybridHyperJ2PlaneStress
from calibr8_tpu_torch.models.nn import ACTIVATION_CODE
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, BCS_3D, make_deck
from tests.test_torch_hybrid_adjoint import NET, hybrid_deck

CSRC = Path(__file__).resolve().parents[1] / "calibr8_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "c8_hybrid.cuh"
#include "c8_implicit.cuh"

template <typename T>
static std::vector<T> rd(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}

template <typename T>
static void wr(FILE* o, const std::vector<T>& v) { fwrite(v.data(), sizeof(T), v.size(), o); }

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  // mode: 0 sigma_yield, 1 hybrid element, 2 / 3 isotropic element in 2D / 3D
  std::vector<int> hdr = rd<int>(f, 11);
  const int mode = hdr[0], E = hdr[1], n_dofs = hdr[2], n_par = hdr[3], npts = hdr[4],
            nxi = hdr[5], nde = hdr[6], D = hdr[7], act = hdr[8], n_layers = hdr[9],
            stride = hdr[10];
  std::vector<int> widths = rd<int>(f, n_layers + 1);
  std::vector<double> sc = rd<double>(f, 6);  // stab_half thick abs_tol fail_tol in out
  c8::Net& nt = c8::c8_net_host;
  nt.act = act;
  nt.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) nt.width[l] = widths[l];
  nt.stride = stride;
  nt.in_scale = sc[4];
  nt.out_scale = sc[5];
  std::vector<double> params = rd<double>(f, n_par);
  FILE* o = fopen(argv[2], "wb");
  if (mode == 0) {
    std::vector<double> a = rd<double>(f, E), da = rd<double>(f, E), out(2 * E);
    for (int e = 0; e < E; ++e) {
      c8::Dual<double, 1> al(a[e]);
      al.d[0] = da[e];
      typedef c8::HybridHyperJ2PlaneStress<double> M;
      M::ElemConst kc;
      M::elem_const(params.data() + e * stride, kc);
      const c8::Dual<double, 1> y = M::sigma_yield(al, params.data() + e * stride, kc);
      out[2 * e] = y.v;
      out[2 * e + 1] = y.d[0];
    }
    wr(o, out);
    fclose(o);
    return 0;
  }
  const int npe = D + 1;
  std::vector<double> x = rd<double>(f, n_dofs), xp = rd<double>(f, n_dofs);
  std::vector<int> edofs = rd<int>(f, (size_t)nde * E);
  std::vector<double> xip = rd<double>(f, (size_t)E * nxi), gN = rd<double>(f, (size_t)npe * D * E);
  std::vector<double> detJ = rd<double>(f, E), h = rd<double>(f, E);
  std::vector<int> es = rd<int>(f, E);
  std::vector<double> quad = rd<double>(f, npts * npe + npts + npe * npe);
  c8::Quad<double> q;
  for (int a = 0; a < 4; ++a) {
    q.w1[a] = 0;
    for (int b = 0; b < 4; ++b) q.N1[a][b] = q.mass[a][b] = 0;
  }
  for (int a = 0; a < npts; ++a)
    for (int n = 0; n < npe; ++n) q.N1[a][n] = quad[a * npe + n];
  for (int a = 0; a < npts; ++a) q.w1[a] = quad[npts * npe + a];
  for (int n = 0; n < npe; ++n)
    for (int m = 0; m < npe; ++m) q.mass[n][m] = quad[npts * npe + npts + n * npe + m];
  q.npts = npts;
  std::vector<double> R((size_t)nde * E), J((size_t)nde * nde * E), xi((size_t)nxi * E);
  std::vector<int> path(E), fail(E), iters(E);
  const double meas0 = D == 2 ? 0.5 : 1.0 / 6.0;
  for (int e = 0; e < E; ++e) {
    if (mode == 1)
      c8::implicit_element<double, c8::HybridHyperJ2PlaneStress>(
          e, E, x.data(), xp.data(), edofs.data(), xip.data(), gN.data(), detJ.data(), h.data(),
          params.data(), es.data(), q, meas0, sc[0], sc[1], sc[2], sc[3], R.data(), J.data(),
          xi.data(), path.data(), fail.data(), iters.data());
    else if (mode == 2)
      c8::assemble_element<double, 2, c8::IsotropicElastic>(
          e, E, x.data(), edofs.data(), xip.data(), gN.data(), detJ.data(), h.data(),
          params.data(), es.data(), q, meas0, sc[0], sc[2], sc[1], R.data(), J.data(),
          xi.data(), path.data(), fail.data());
    else
      c8::assemble_element<double, 3, c8::IsotropicElastic>(
          e, E, x.data(), edofs.data(), xip.data(), gN.data(), detJ.data(), h.data(),
          params.data(), es.data(), q, meas0, sc[0], sc[2], sc[1], R.data(), J.data(),
          xi.data(), path.data(), fail.data());
  }
  wr(o, R);
  wr(o, J);
  wr(o, xi);
  wr(o, path);
  wr(o, fail);
  wr(o, iters);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_hybrid.cuh and c8_element.cuh")
    d = tmp_path_factory.mktemp("hybrid_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(CSRC), str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)

    def run(name, header, widths, scalars, params, *arrays):
        inp, out = d / f"{name}.in", d / f"{name}.out"
        with open(inp, "wb") as fh:
            fh.write(np.asarray(header, np.int32).tobytes())
            fh.write(np.asarray(widths, np.int32).tobytes())
            fh.write(np.asarray(scalars, np.float64).tobytes())
            fh.write(np.asarray(params, np.float64).tobytes())
            for a in arrays:
                fh.write(np.ascontiguousarray(a).tobytes())
        subprocess.run([str(exe), str(inp), str(out)], check=True, timeout=120)
        return out.read_bytes()

    return run


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("activation", sorted(ACTIVATION_CODE))
def test_network_on_duals_matches_plain(harness, activation):
    rng = np.random.default_rng(6)
    for topo in ([1, 4, 1], [1, 16, 7, 3, 5, 2]):
        cfg = {"embedded model": {**NET, "activation function": activation, "topology": topo,
                                  "input scale": 1.5, "output scale": 10.0}}
        model = HybridHyperJ2PlaneStress(2, config=cfg)
        model.abs_tol = 1e-12
        bm = BatchedHybridHyperJ2PlaneStress(model)
        E, stride = 64, len(model.param_names)
        params = np.tile(model.default_params(), (E, 1))
        params[:, :3] = [1000.0, 0.25, 10.0]
        params[:, 3:] += 0.5 * rng.standard_normal((E, stride - 3))
        alpha, dalpha = 0.3 * rng.random(E), rng.standard_normal(E)
        parT = torch.tensor(params.T)
        val, tan = torch.func.jvp(lambda a: bm._sigma_yield(a, parT), (torch.tensor(alpha),),
                                  (torch.tensor(dalpha),))
        header = [0, E, 0, params.size, 0, 0, 0, 2, ACTIVATION_CODE[activation], len(topo) - 1,
                  stride]
        got = np.frombuffer(harness(f"sy_{activation}_{len(topo)}", header, topo,
                                    [0, 1, 0, 0, 1.5, 10.0], params, alpha, dalpha),
                            np.float64).reshape(E, 2)
        assert _close(got[:, 0], val.numpy(), 1e-13), (activation, topo)
        assert _close(got[:, 1], tan.numpy(), 1e-13), (activation, topo)


def _element_inputs(prob, x, x_prev, xi_prev):
    disc = prob.disc
    quad, npts = _quad_array(disc.spec.dim)
    return npts, [np.asarray(list(quad))], (
        x.numpy(), x_prev.numpy(), disc.edofs_T.numpy(), xi_prev.numpy(), disc.gN_T.numpy(),
        disc.detJ.numpy(), disc.h.numpy(), disc.es_ids32.numpy())


def _check_element(harness, name, prob, x, x_prev, xi_prev, mode, net=None):
    disc, bm = prob.disc, prob.assembler.bmodel
    E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
    npts, quad, arrays = _element_inputs(prob, x, x_prev, xi_prev)
    params = prob.params0.numpy()
    act, topo, scales = net if net else (0, [1, 1, 1], (1.0, 1.0))
    header = [mode, E, disc.n_dofs, params.size, npts, nxi, nde, disc.spec.dim, act,
              len(topo) - 1, params.shape[1]]
    scalars = [disc.spec.stab_multiplier * 0.5, row_thickness(disc.spec), bm.abs_tol,
               max(bm.abs_tol * 10.0, 1e-30), *scales]
    buf = harness(name, header, topo, scalars, params, *arrays, *quad)
    sizes = [nde * E, nde * nde * E, nxi * E]
    f64 = np.frombuffer(buf[:8 * sum(sizes)], np.float64)
    R, J, xi = np.split(f64, np.cumsum(sizes)[:-1])
    path, fail, iters = np.frombuffer(buf[8 * sum(sizes):], np.int32).reshape(3, E)
    iters_p = torch.zeros(E, dtype=torch.int32)
    want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0, x_prev=x_prev,
                                newton_iters=iters_p if mode == 1 else None)
    np.testing.assert_array_equal(path, want[3].numpy())
    np.testing.assert_array_equal(fail, want[4].numpy())
    if mode == 1:
        np.testing.assert_array_equal(iters, iters_p.numpy())
    for got, w, label in ((xi, want[2], "xi"), (R, want[0], "R"), (J, want[1], "J")):
        assert _close(got, w.numpy().reshape(-1), 1e-13), (name, label)
    return want


def test_elements_on_host_match_plain(harness):
    from tests.test_torch_hyper_assembly import hyper_state, hyper_xi_prev

    # the hybrid's twin case, the state of tests/test_torch_hybrid_assembly.py
    deck = hybrid_deck({"type": "notch2D", "h": 0.3}, {"E": 1000.0, "nu": 0.25, "Y": 10.0},
                       0.01, 1)
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    disc, model = prob.disc, prob.model
    coords = disc.mesh.coords
    x = torch.tensor(hyper_state(coords, disc.n_nodes, 2, False, 0.04, seed=0))
    x_prev = torch.tensor(hyper_state(coords, disc.n_nodes, 2, False, 0.02, seed=2))
    xi_prev = torch.tensor(hyper_xi_prev(model, disc.n_elem))
    net = (ACTIVATION_CODE[model.nn.activation], model.nn.topology,
           (model.nn_input_scale, model.nn_output_scale))
    want = _check_element(harness, "hybrid", prob, x, x_prev, xi_prev, 1, net)
    assert 0 < int(want[3].sum()) < disc.n_elem, "single-branch state"

    for mode, mesh, bcs in ((2, {"type": "notch2D", "h": 0.3}, BCS_2D(0.01)),
                            (3, {"type": "cube", "n": 2}, BCS_3D(0.02))):
        deck = make_deck(mesh, "isotropic_elastic", {"E": 1000.0, "nu": 0.25}, bcs, 1)
        deck["residuals"]["global residual"]["mixed formulation"] = False
        prob = Problem(load_deck(deck), device="cpu")
        disc = prob.disc
        rng = np.random.default_rng(mode)
        x = torch.tensor(1e-2 * rng.standard_normal(disc.n_dofs))
        xi_prev = torch.zeros(disc.n_elem, 1, dtype=torch.float64)
        _check_element(harness, f"iso{mode}", prob, x, x, xi_prev, mode)
