"""The element-level entry of the assembly kernels (kernel 1c: a null
edofs_T, x holding the pre-gathered (nde, E) element columns;
csrc/c8_element.cuh elem_dof) built for the host with g++ and held
against the single-device entry (x gathered through edofs_T) on the same
elements, float64, without FMA contraction (-ffp-contract=off, as the
kernel libraries are built with -fmad=false):

 - c8::assemble_element with SmallJ2 on notch2D h=0.3 (2D mixed u/p);
 - c8::implicit_element with HyperJ2 on cube n=2 (3D mixed u/p, x_prev
   read as x is),

each element's R, J, xi, path and fail bit for bit equal between the two
entries (only the read differs), and the single-device entry within
1e-12 of the plain version (fused_assembly_plain) as a check that the
harness runs the kernels' arithmetic.  States from numpy with a seed,
some elements plastic.  Skips where no g++ is found."""

import copy
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import _quad_array, fused_assembly_plain
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, BCS_3D, CUBE, HYPER_MAT, J2_MAT, make_deck
from tests.test_torch_hyper_assembly import hyper_state, hyper_xi_prev

CSRC = Path(__file__).resolve().parents[1] / "calibr8_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
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
  // mode: 0 SmallJ2 in 2D (assemble_element), 1 HyperJ2 in 3D (implicit_element)
  std::vector<int> hdr = rd<int>(f, 7);
  const int mode = hdr[0], E = hdr[1], n_dofs = hdr[2], n_par = hdr[3], npts = hdr[4],
            nxi = hdr[5], nde = hdr[6];
  const int D = mode == 0 ? 2 : 3, npe = D + 1;
  std::vector<double> sc = rd<double>(f, 4);  // stab_half thick abs_tol fail_tol
  std::vector<double> params = rd<double>(f, n_par);
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
  // the element columns of x and x_prev, gathered as the domain-decomposed
  // solver gathers its parts' elements
  std::vector<double> xe((size_t)nde * E), xpe((size_t)nde * E);
  for (size_t k = 0; k < xe.size(); ++k) {
    xe[k] = x[edofs[k]];
    xpe[k] = xp[edofs[k]];
  }
  const double meas0 = D == 2 ? 0.5 : 1.0 / 6.0;
  FILE* o = fopen(argv[2], "wb");
  for (int entry = 0; entry < 2; ++entry) {
    const double* xx = entry == 0 ? x.data() : xe.data();
    const double* xxp = entry == 0 ? xp.data() : xpe.data();
    const int* ed = entry == 0 ? edofs.data() : nullptr;
    std::vector<double> R((size_t)nde * E), J((size_t)nde * nde * E), xi((size_t)nxi * E);
    std::vector<int> path(E), fail(E);
    for (int e = 0; e < E; ++e) {
      if (mode == 0)
        c8::assemble_element<double, 2, c8::SmallJ2>(
            e, E, xx, ed, xip.data(), gN.data(), detJ.data(), h.data(), params.data(),
            es.data(), q, meas0, sc[0], sc[2], sc[1], R.data(), J.data(), xi.data(),
            path.data(), fail.data());
      else
        c8::implicit_element<double, c8::HyperJ2>(
            e, E, xx, xxp, ed, xip.data(), gN.data(), detJ.data(), h.data(), params.data(),
            es.data(), q, meas0, sc[0], sc[1], sc[2], sc[3], R.data(), J.data(), xi.data(),
            path.data(), fail.data(), nullptr);
    }
    wr(o, R);
    wr(o, J);
    wr(o, xi);
    wr(o, path);
    wr(o, fail);
  }
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_element.cuh and c8_implicit.cuh")
    d = tmp_path_factory.mktemp("elem_entry_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(CSRC), str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)

    def run(name, header, scalars, *arrays):
        inp, out = d / f"{name}.in", d / f"{name}.out"
        with open(inp, "wb") as fh:
            fh.write(np.asarray(header, np.int32).tobytes())
            fh.write(np.asarray(scalars, np.float64).tobytes())
            for a in arrays:
                fh.write(np.ascontiguousarray(a).tobytes())
        subprocess.run([str(exe), str(inp), str(out)], check=True, timeout=120)
        return out.read_bytes()

    return run


CASES = {
    # (mode, deck, state: (dim, deformation scale of x and x_prev))
    "small_J2 notch2D h=0.3": (0, make_deck({"type": "notch2D", "h": 0.3}, "small_J2", J2_MAT,
                                            BCS_2D(0.01), 1), (2, 0.02, 0.01)),
    "hyper_J2 cube n=2": (1, make_deck(CUBE, "hyper_J2", HYPER_MAT, BCS_3D(0.01), 1),
                          (3, 0.02, 0.01)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_element_entry_equals_single_device_entry(harness, case):
    mode, deck, (dim, scale, scale_prev) = CASES[case]
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    disc, bm = prob.disc, prob.assembler.bmodel
    coords = disc.mesh.coords
    x = torch.tensor(hyper_state(coords, disc.n_nodes, dim, True, scale, seed=0))
    x_prev = torch.tensor(hyper_state(coords, disc.n_nodes, dim, True, scale_prev, seed=2))
    xi_prev = torch.tensor(hyper_xi_prev(prob.model, disc.n_elem)) if mode else \
        torch.zeros(disc.n_elem, bm.nxi, dtype=torch.float64)
    E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
    quad, npts = _quad_array(dim)
    params = prob.params0.numpy()
    header = [mode, E, disc.n_dofs, params.size, npts, nxi, nde]
    scalars = [disc.spec.stab_multiplier * 0.5, disc.spec.thickness, bm.abs_tol,
               max(bm.abs_tol * 10.0, 1e-30)]
    buf = harness(case.replace(" ", "_"), header, scalars, params, x.numpy(), x_prev.numpy(),
                  disc.edofs_T.numpy(), xi_prev.numpy(), disc.gN_T.numpy(), disc.detJ.numpy(),
                  disc.h.numpy(), disc.es_ids32.numpy(), np.asarray(list(quad)))
    n_f64 = nde * E + nde * nde * E + nxi * E
    per_entry = 8 * n_f64 + 4 * 2 * E
    assert len(buf) == 2 * per_entry
    single, elems = buf[:per_entry], buf[per_entry:]
    # bit for bit: the same arithmetic, only the read differs
    assert single == elems, case
    f64 = np.frombuffer(single[:8 * n_f64], np.float64)
    R, J, xi = np.split(f64, [nde * E, nde * E + nde * nde * E])
    path, fail = np.frombuffer(single[8 * n_f64:], np.int32).reshape(2, E)
    want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0, x_prev=x_prev)
    np.testing.assert_array_equal(path, want[3].numpy())
    np.testing.assert_array_equal(fail, want[4].numpy())
    assert 0 < int(path.sum()) < E, "single-branch state"
    for got, w, label in ((xi, want[2], "xi"), (R, want[0], "R"), (J, want[1], "J")):
        w = w.numpy().reshape(-1)
        assert np.abs(got - w).max() <= 1e-12 * np.abs(w).max(), (case, label)
