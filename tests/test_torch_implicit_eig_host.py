"""Kernel 1b's eigensolver library (csrc/implicit_eig.cu: small_hosford,
hypo_hosford) built for the host with g++ and checked on this CPU,
float64, without FMA contraction (-ffp-contract=off, as the kernel
libraries are built with -fmad=false):

 - the Hosford yield surface with its tangents taken through the stress's
   six voigt components (c8_eig.cuh yield_inner: Dual<double, 6> inside,
   its 7 x 6 Jacobian contracted with the outer tangents), against the
   surface run on the outer Dual<double, 16> itself, for both twins'
   surfaces (c8_hosford.cuh HosfordOnDev, HosfordOnTC) on random symmetric
   stresses whose principal values are apart: values bit for bit, tangents
   to 1e-13 of their max; and the stresses the two residuals build
   (small_dev_stress, voigt_to_sym) symmetric bit for bit in value and in
   every tangent, which the contraction needs;
 - the operations per element of both instances, counted by
   c8::implicit_element on tests/test_torch_implicit_team_host.py's
   counting scalar on the twin cases' states, against
   calibr8_tpu_torch/implicit_cost.py FLOPS (A, B, T) as that file checks
   the other instances;
 - the team body (c8::implicit_team_element) at G = 1, 4 and the kernels'
   G (c8::implicit_team_lanes, float64 and float32), its lanes
   std::threads at a std::barrier, against c8::implicit_element bit for
   bit, and implicit_element against fused_assembly_plain: path, fail and
   local counts equal, xi and R to 1e-12, J to 1e-11 of their max, at cube
   n=2 on the twin states (tests/test_torch_implicit_team_host.py's) at
   two scales, the larger one with every element plastic and the line
   search cutting steps.

The three harnesses build side by side (~10 s); skips where no g++ is
found."""

import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.fem.fused_assembly import fused_assembly_plain
from calibr8_tpu_torch.implicit_cost import FLOPS
from tests.test_torch_implicit_team_host import (
    CSRC, CUBE2, HOSFORD_MODELS, _close, _outputs, _run, build_harness, plain_trials,
    twin_state,
)

# the surfaces' parameters: the twin cases' E, nu, Y, a (the rest unread)
PAR = np.array([1000.0, 0.25, 10.0, 8.0, 50.0, 5.0, 2.0])
NOUT = 16  # the condensation's seeds

YIELD = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "c8_hosford.cuh"

typedef c8::Dual<double, 16> D;

// phi and n of surface Y at A, on the outer duals and through the six
// components; writes both (value, 16 tangents) for phi then n[0..5]
template <typename Y>
static void both(const D A[3][3], const double* par, FILE* o) {
  D n0[6], n1[6];
  const D p0 = Y::eval(A, par, n0);
  const D p1 = c8::yield_inner<Y>(A, par, c8::SoloLane(), n1);
  for (const D* v : {&p0, &p1}) {
    const D* n = v == &p0 ? n0 : n1;
    for (int r = 0; r < 7; ++r) {
      const D& x = r == 0 ? *v : n[r - 1];
      fwrite(&x.v, sizeof(double), 1, o);
      fwrite(x.d, sizeof(double), 16, o);
    }
  }
}

// entries of a 3x3 of duals that are not symmetric bit for bit
static int asymmetric(const D a[3][3]) {
  int bad = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      bad += a[i][j].v != a[j][i].v;
      for (int k = 0; k < 16; ++k) bad += a[i][j].d[k] != a[j][i].d[k];
    }
  return bad;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int ns;
  if (fread(&ns, sizeof(int), 1, f) != 1) return 2;
  std::vector<double> par(7), a(ns * 6), t(ns * 6 * 16), xs(ns * 7 * 17), gs(ns * 9 * 17);
  if (fread(par.data(), 8, 7, f) != 7 || fread(a.data(), 8, a.size(), f) != a.size() ||
      fread(t.data(), 8, t.size(), f) != t.size() || fread(xs.data(), 8, xs.size(), f) != xs.size() ||
      fread(gs.data(), 8, gs.size(), f) != gs.size())
    return 2;
  FILE* o = fopen(argv[2], "wb");
  int bad = 0;
  for (int s = 0; s < ns; ++s) {
    D v[6];
    for (int c = 0; c < 6; ++c) {
      v[c] = D(a[s * 6 + c]);
      for (int k = 0; k < 16; ++k) v[c].d[k] = t[(s * 6 + c) * 16 + k];
    }
    D A[3][3];
    c8::voigt_to_sym<3>(v, A);
    both<c8::HosfordOnDev<double>>(A, par.data(), o);
    both<c8::HosfordOnTC<double>>(A, par.data(), o);
    // the residuals' stresses from seeded xi and grad_u
    D xi[7], gu[3][3], s3[3][3], tc[3][3];
    for (int k = 0; k < 7; ++k) {
      xi[k] = D(xs[(s * 7 + k) * 17]);
      for (int m = 0; m < 16; ++m) xi[k].d[m] = xs[(s * 7 + k) * 17 + 1 + m];
    }
    for (int i = 0; i < 9; ++i) {
      gu[i / 3][i % 3] = D(gs[(s * 9 + i) * 17]);
      for (int m = 0; m < 16; ++m) gu[i / 3][i % 3].d[m] = gs[(s * 9 + i) * 17 + 1 + m];
    }
    c8::SmallHosford<double>::stress(xi, gu, par.data(), s3);
    c8::voigt_to_sym<3>(xi, tc);
    bad += asymmetric(s3) + asymmetric(tc);
  }
  fwrite(&bad, sizeof(int), 1, o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def eig_harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harnesses of csrc/c8_eig.cuh and c8_implicit.cuh")
    d = tmp_path_factory.mktemp("eig_host")
    (d / "yield.cpp").write_text(YIELD)
    t0 = time.perf_counter()
    yproc = subprocess.Popen([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-I", str(CSRC),
                              str(d / "yield.cpp"), "-o", str(d / "yield")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # the team harness and the counting one of the Hosford twins only
    run = build_harness(d, {"team": ("-DC8_HOSFORD_TWINS",),
                            "count": ("-DC8_COUNT", "-DC8_HOSFORD_TWINS")})
    out = yproc.communicate(timeout=300)[0]
    assert yproc.returncode == 0, out.decode()[-4000:]
    print(f"eig host harnesses built in {time.perf_counter() - t0:.1f} s")
    return d, run


def symmetric_stresses(rng, n):
    """n random symmetric stresses of size ~Y, each with principal values
    at least 5% of their spread apart, as voigt rows [00, 11, 22, 01, 02, 12]."""
    out = []
    while len(out) < n:
        v = rng.uniform(-15.0, 15.0, 6)
        A = np.array([[v[0], v[3], v[4]], [v[3], v[1], v[5]], [v[4], v[5], v[2]]])
        lam = np.linalg.eigvalsh(A)
        if np.diff(lam).min() >= 0.05 * (lam[-1] - lam[0]):
            out.append(v)
    return np.array(out)


def test_hosford_inner_seeds_and_flops(eig_harness):
    d, run = eig_harness
    rng = np.random.default_rng(14)
    ns = 64
    a = symmetric_stresses(rng, ns)
    t = rng.standard_normal((ns, 6, NOUT))
    xs = np.concatenate([1e-3 * rng.standard_normal((ns, 7, 1)),
                         rng.standard_normal((ns, 7, NOUT))], axis=2)
    gs = np.concatenate([1e-2 * rng.standard_normal((ns, 9, 1)),
                         rng.standard_normal((ns, 9, NOUT))], axis=2)
    with open(d / "yield.in", "wb") as fh:
        fh.write(np.int32(ns).tobytes())
        for arr in (PAR, a, t, xs, gs):
            fh.write(np.ascontiguousarray(arr, np.float64).tobytes())
    subprocess.run([str(d / "yield"), str(d / "yield.in"), str(d / "yield.out")], check=True,
                   timeout=120)
    buf = (d / "yield.out").read_bytes()
    # (sample, surface, outer / inner, phi + n, value + tangents)
    res = np.frombuffer(buf[:-4], np.float64).reshape(ns, 2, 2, 7, 1 + NOUT)
    assert int(np.frombuffer(buf[-4:], np.int32)[0]) == 0, "an asymmetric stress"
    for k, surface in enumerate(("HosfordOnDev", "HosfordOnTC")):
        ref, got = res[:, k, 0], res[:, k, 1]
        np.testing.assert_array_equal(got[..., 0], ref[..., 0], err_msg=surface)
        for r, label in ((slice(0, 1), "phi"), (slice(1, 7), "n")):
            assert _close(got[:, r, 1:], ref[:, r, 1:], 1e-13), (surface, label)
        assert np.abs(ref[..., 1:]).max() > 0, surface

    # the operations per element, as the other instances' are checked
    for name in HOSFORD_MODELS:
        prob, x, x_prev, xi_prev = twin_state(name, CUBE2, 0.02)
        E = prob.disc.n_elem
        buf = _run(run, "count", name, prob, x, x_prev, xi_prev)
        ops = np.frombuffer(buf[:40 * E], np.int64).reshape(E, 5)
        iters = np.frombuffer(buf[40 * E:44 * E], np.int32).astype(np.int64)
        trial = np.frombuffer(buf[44 * E:], np.int64)
        assert len(set(iters.tolist())) >= 2, (name, "one local count: B is not determined")
        A, B, T = FLOPS[name]
        # implicit_element runs all four trials of every update
        np.testing.assert_array_equal(ops.sum(1), A + (B + 4 * T) * iters, err_msg=name)
        np.testing.assert_array_equal(trial, T, err_msg=name)


def test_hosford_team_body_matches_element_bitwise_and_plain(eig_harness):
    _, run = eig_harness
    for name in HOSFORD_MODELS:
        for scale in (0.02, 0.1):
            prob, x, x_prev, xi_prev = twin_state(name, CUBE2, scale)
            disc, bm = prob.disc, prob.assembler.bmodel
            E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
            buf = _run(run, "team", f"{name}_{scale}", prob, x, x_prev, xi_prev)
            ref, at = _outputs(buf, E, nde, nxi)
            iters_p = torch.zeros(E, dtype=torch.int32)
            want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0,
                                        x_prev=x_prev if bm.finite_deformation else None,
                                        newton_iters=iters_p)
            case = (name, scale)
            np.testing.assert_array_equal(ref[3], want[3].numpy(), err_msg=str(case))
            np.testing.assert_array_equal(ref[4], want[4].numpy(), err_msg=str(case))
            np.testing.assert_array_equal(ref[5], iters_p.numpy(), err_msg=str(case))
            for got, w, label, tol in zip(ref[:3], want[:3], ("R", "J", "xi"),
                                          (1e-12, 1e-11, 1e-12)):
                assert _close(got, w.numpy().reshape(-1), tol), (case, label)
            assert int(ref[3].sum()) > 0, (case, "no plastic element")
            shortened = 0
            lanes = []
            for _ in range(4):
                G = int(np.frombuffer(buf[at:at + 4], np.int32)[0])
                ballots, short = np.frombuffer(buf[at + 4:at + 20], np.int64).tolist()
                team, n = _outputs(buf[at + 20:], E, nde, nxi)
                at += 20 + n
                lanes.append(abs(G))
                for a, b, label in zip(team, ref, ("R", "J", "xi", "path", "fail", "iters")):
                    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (case, G, label)
                if G == 1:
                    # one lane's rounds are the sequential search's trials
                    assert ballots == int(plain_trials(prob, x, x_prev, xi_prev).sum()), case
                    shortened = short
            assert at == len(buf) and lanes[:2] == [1, 4], (case, lanes)
            if scale == 0.1:
                assert int(ref[3].sum()) == E and shortened > 0, (case, "no step cut")
