"""Kernel 1b's hybrid library (csrc/implicit_hybrid.cu: c8_hybrid.cuh's
network in c8_implicit.cuh's kernel) built for the host with g++ and
checked on this CPU, float64, without FMA contraction (-ffp-contract=off,
as the kernel libraries are built with -fmad=false):

 - the network on alpha's one live tangent slot (sigma_yield on
   Dual<double, 6> and Dual<double, 10>, the local Newton's and the
   condensation's scalars, the live slot anywhere) against the network on
   every slot (REF_NN below, the element code's earlier pass, on the whole
   dual): the value and the live slot bit for bit, every other slot zero;
   every activation and the topologies [1, 4, 1], [1, 8, 8, 1] and the cap
   [1, 16, 16, 16, 16, 1] (its layers in the per-thread slab), weights and
   alpha made with numpy from a seed; NN(0) formed once per element
   (ElemConst) bit for bit NN(0) on plain T; and the hybrid's operations
   per element, counted by c8::implicit_element on
   tests/test_torch_implicit_team_host.py's counting scalar on the twin
   state below, against calibr8_tpu_torch/implicit_cost.py FLOPS at the
   network it was counted at (HYBRID_NET, chip_smoke.py's);
 - the team body (c8::implicit_team_element) at G = 1, 4 and the kernels'
   G (c8::implicit_team_lanes, float64 and float32) bit for bit against
   c8::implicit_element, and implicit_element against
   fused_assembly_plain on the hybrid's twin case (notch2D h=0.3, the state
   of tests/test_torch_hybrid_host.py, some elements plastic): path, fail
   and local counts equal, xi, R and J to 1e-13 of their max.

A host build aborts where alpha has two live slots (c8_hybrid.cuh), so the
element runs here also check that no caller passes one.  The team and
counting harnesses are tests/test_torch_implicit_team_host.py's, built for
the hybrid alone; the three build side by side.  Skips where no g++ is
found."""

import copy
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import _quad_array, fused_assembly_plain, row_thickness
from calibr8_tpu_torch.implicit_cost import FLOPS, HYBRID_NET
from calibr8_tpu_torch.models import HybridHyperJ2PlaneStress
from calibr8_tpu_torch.models.batched import KERNEL_MODEL_ID
from calibr8_tpu_torch.models.nn import ACTIVATION_CODE
from calibr8_tpu_torch.problem import Problem
from tests.test_torch_hybrid_adjoint import NET, hybrid_deck
from tests.test_torch_hyper_assembly import hyper_state, hyper_xi_prev
from tests.test_torch_implicit_team_host import HARNESS as TEAM_HARNESS
from tests.test_torch_implicit_team_host import CSRC, _close, _outputs, build_harness

NAME = "hybrid_hyper_J2_plane_stress"
TOPOLOGIES = ([1, 4, 1], [1, 8, 8, 1], [1, 16, 16, 16, 16, 1])

NETWORK = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "c8_hybrid.cuh"

// the network on a whole dual, each layer's activations in two arrays of
// NN_MAX_WIDTH scalars (the element code's pass before the one-slot one)
template <typename T, typename S>
S REF_NN(const S& x, const T* w, const c8::Net& nt) {
  S buf[2][c8::NN_MAX_WIDTH];
  S* h = buf[0];
  S* g = buf[1];
  h[0] = x;
  int idx = 0;
  for (int l = 0; l < nt.n_layers; ++l) {
    const int c = nt.width[l], r = nt.width[l + 1];
    const bool last = l == nt.n_layers - 1;
    const T* W = w + idx;
    const T* b = w + idx + r * c;
    for (int i = 0; i < (last ? 1 : r); ++i) {
      S acc = W[i * c] * h[0] + b[i];
      for (int j = 1; j < c; ++j) acc = acc + W[i * c + j] * h[j];
      g[i] = last ? acc : c8::nn_act(nt.act, acc);
    }
    idx += r * c + r;
    S* t = h;
    h = g;
    g = t;
  }
  return h[0];
}

typedef c8::HybridHyperJ2PlaneStress<double> M;

// per sample: the one-slot sigma_yield and the whole-dual one, value and
// N tangents each
template <int N>
static void sample(const double* par, double a, double t, int slot, FILE* o) {
  const c8::Net& nt = c8::c8_net_host;
  c8::Dual<double, N> al(a);
  al.d[slot] = t;
  M::ElemConst kc;
  M::elem_const(par, kc);
  const c8::Dual<double, N> got = M::sigma_yield(al, par, kc);
  const c8::Dual<double, N> dnn =
      REF_NN<double, c8::Dual<double, N>>(nt.in_scale * al, par + M::NPAR, nt) -
      REF_NN<double, double>(0.0, par + M::NPAR, nt);
  const c8::Dual<double, N> ref = par[2] + nt.out_scale * dnn;
  fwrite(&got.v, 8, 1, o);
  fwrite(got.d, 8, N, o);
  fwrite(&ref.v, 8, 1, o);
  fwrite(ref.d, 8, N, o);
}

template <typename T>
static std::vector<T> rd(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  // samples, act, n_layers, stride, then the widths
  std::vector<int> hdr = rd<int>(f, 4);
  const int ns = hdr[0], stride = hdr[3];
  c8::Net& nt = c8::c8_net_host;
  nt.act = hdr[1];
  nt.n_layers = hdr[2];
  std::vector<int> widths = rd<int>(f, nt.n_layers + 1);
  for (int l = 0; l <= nt.n_layers; ++l) nt.width[l] = widths[l];
  nt.stride = stride;
  std::vector<double> sc = rd<double>(f, 2);
  nt.in_scale = sc[0];
  nt.out_scale = sc[1];
  std::vector<double> params = rd<double>(f, (size_t)ns * stride), a = rd<double>(f, ns),
                      t = rd<double>(f, ns);
  std::vector<int> s6 = rd<int>(f, ns), s10 = rd<int>(f, ns);
  FILE* o = fopen(argv[2], "wb");
  for (int e = 0; e < ns; ++e) {
    const double* par = params.data() + (size_t)e * stride;
    sample<6>(par, a[e], t[e], s6[e], o);
    sample<10>(par, a[e], t[e], s10[e], o);
    // NN(0) once per element, and on plain T as the earlier pass formed it
    M::ElemConst kc;
    M::elem_const(par, kc);
    const double n0 = REF_NN<double, double>(0.0, par + M::NPAR, nt);
    fwrite(&kc.n0, 8, 1, o);
    fwrite(&n0, 8, 1, o);
  }
  fclose(o);
  return 0;
}
"""


def _hybrid_harness():
    """tests/test_torch_implicit_team_host.py's team and counting harness
    for the hybrid alone: its network's description (act, n_layers, the
    widths, then in and out scales) read after the quadrature."""
    src = TEAM_HARNESS.replace('#include "c8_hosford.cuh"',
                               '#include "c8_hosford.cuh"\n#include "c8_hybrid.cuh"')
    read_net = """
  if (model == 12) {
    std::vector<int> nh = rd<int>(f, 2);
    c8::Net& nt = c8::c8_net_host;
    nt.act = nh[0];
    nt.n_layers = nh[1];
    std::vector<int> widths = rd<int>(f, nh[1] + 1);
    for (int l = 0; l <= nh[1]; ++l) nt.width[l] = widths[l];
    std::vector<double> sc = rd<double>(f, 3);
    nt.in_scale = sc[0];
    nt.out_scale = sc[1];
    nt.stride = (int)sc[2];
  }
"""
    anchor = "  in.quad = rd<double>(f, in.npts * npe + in.npts + npe * npe);\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, anchor + read_net)
    src, n = re.subn(r"  switch \(model\) \{.*?\n  \}\n",
                     "  switch (model) {\n    case 12: run<c8::HybridHyperJ2PlaneStress>(in, o); "
                     "break;\n    default: return 3;\n  }\n", src, flags=re.S)
    assert n == 1
    return src


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harnesses of csrc/c8_hybrid.cuh and c8_implicit.cuh")
    d = tmp_path_factory.mktemp("hybrid_team_host")
    (d / "network.cpp").write_text(NETWORK)
    nproc = subprocess.Popen([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-I", str(CSRC),
                              str(d / "network.cpp"), "-o", str(d / "network")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    run = build_harness(d, {"team": (), "count": ("-DC8_COUNT",)}, source=_hybrid_harness())
    out = nproc.communicate(timeout=300)[0]
    assert nproc.returncode == 0, out.decode()[-4000:]
    return d, run


def twin_state():
    """(prob, x, x_prev, xi_prev) of tests/test_torch_hybrid_host.py: the
    hybrid's twin case (notch2D h=0.3, the test decks' network, which is
    chip_smoke.py's) at tests/test_torch_hybrid_assembly.py's state."""
    deck = hybrid_deck({"type": "notch2D", "h": 0.3}, {"E": 1000.0, "nu": 0.25, "Y": 10.0},
                       0.01, 1)
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    disc, model = prob.disc, prob.model
    coords = disc.mesh.coords
    x = torch.tensor(hyper_state(coords, disc.n_nodes, 2, False, 0.04, seed=0))
    x_prev = torch.tensor(hyper_state(coords, disc.n_nodes, 2, False, 0.02, seed=2))
    xi_prev = torch.tensor(hyper_xi_prev(model, disc.n_elem))
    return prob, x, x_prev, xi_prev


def _run(run, mode, prob, x, x_prev, xi_prev):
    disc, bm, model = prob.disc, prob.assembler.bmodel, prob.model
    E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
    quad, npts = _quad_array(disc.spec.dim)
    params = prob.params0.numpy()
    header = [KERNEL_MODEL_ID[NAME], E, disc.n_dofs, params.size, npts, nxi, nde, disc.spec.dim]
    scalars = [disc.spec.stab_multiplier * 0.5, row_thickness(disc.spec), bm.abs_tol,
               max(bm.abs_tol * 10.0, 1e-30)]
    topo = model.nn.topology
    net_ints = np.asarray([ACTIVATION_CODE[model.nn.activation], len(topo) - 1, *topo], np.int32)
    net_dbl = np.asarray([model.nn_input_scale, model.nn_output_scale, params.shape[1]])
    return run(mode, NAME, header, scalars, params, x.numpy(), x_prev.numpy(),
               disc.edofs_T.numpy(), xi_prev.numpy(), disc.gN_T.numpy(), disc.detJ.numpy(),
               disc.h.numpy(), disc.es_ids32.numpy(), np.asarray(list(quad)), net_ints, net_dbl)


def test_network_on_one_slot_and_flops(harnesses):
    d, run = harnesses
    rng = np.random.default_rng(15)
    ns = 48
    for activation in sorted(ACTIVATION_CODE):
        for topo in TOPOLOGIES:
            cfg = {"embedded model": {**NET, "activation function": activation, "topology": topo,
                                      "input scale": 1.5, "output scale": 10.0}}
            model = HybridHyperJ2PlaneStress(2, config=cfg)
            stride = len(model.param_names)
            params = np.tile(model.default_params(), (ns, 1))
            params[:, :3] = [1000.0, 0.25, 10.0]
            params[:, 3:] += 0.5 * rng.standard_normal((ns, stride - 3))
            alpha, dalpha = 0.3 * rng.random(ns), rng.standard_normal(ns)
            s6, s10 = rng.integers(0, 6, ns), rng.integers(0, 10, ns)
            inp, out = d / "network.in", d / "network.out"
            with open(inp, "wb") as fh:
                fh.write(np.asarray([ns, ACTIVATION_CODE[activation], len(topo) - 1, stride],
                                    np.int32).tobytes())
                fh.write(np.asarray(topo, np.int32).tobytes())
                for arr in ([1.5, 10.0], params, alpha, dalpha):
                    fh.write(np.ascontiguousarray(arr, np.float64).tobytes())
                for arr in (s6, s10):
                    fh.write(np.asarray(arr, np.int32).tobytes())
            subprocess.run([str(d / "network"), str(inp), str(out)], check=True, timeout=120)
            buf = np.frombuffer(out.read_bytes(), np.float64).reshape(ns, 2 * 7 + 2 * 11 + 2)
            case = (activation, topo)
            for N, lo, slots in ((6, 0, s6), (10, 14, s10)):
                got, ref = buf[:, lo:lo + N + 1], buf[:, lo + N + 1:lo + 2 * N + 2]
                live = np.arange(ns), 1 + slots
                np.testing.assert_array_equal(got[:, 0].view(np.int64), ref[:, 0].view(np.int64),
                                              err_msg=str((case, N, "value")))
                np.testing.assert_array_equal(got[live].view(np.int64), ref[live].view(np.int64),
                                              err_msg=str((case, N, "live slot")))
                dead = np.ones((ns, N + 1), bool)
                dead[:, 0] = False
                dead[live] = False
                # zero in the one-slot pass; a computed zero in the whole one
                assert (got[dead] == 0.0).all() and (ref[dead] == 0.0).all(), (case, N)
                assert np.abs(ref[live]).max() > 0, (case, N)
            np.testing.assert_array_equal(buf[:, -2].view(np.int64), buf[:, -1].view(np.int64),
                                          err_msg=str((case, "NN(0)")))

    # the operations per element, at the network FLOPS was counted at
    prob, x, x_prev, xi_prev = twin_state()
    nn = prob.model.nn
    assert {"activation function": nn.activation, "topology": list(nn.topology),
            "input scale": prob.model.nn_input_scale,
            "output scale": prob.model.nn_output_scale} == HYBRID_NET
    E = prob.disc.n_elem
    buf = _run(run, "count", prob, x, x_prev, xi_prev)
    ops = np.frombuffer(buf[:40 * E], np.int64).reshape(E, 5)
    iters = np.frombuffer(buf[40 * E:44 * E], np.int32).astype(np.int64)
    assert len(set(iters.tolist())) >= 2, "one local count: B is not determined"
    A, B, T = FLOPS[NAME]
    np.testing.assert_array_equal(ops.sum(1), A + (B + 4 * T) * iters)
    np.testing.assert_array_equal(np.frombuffer(buf[44 * E:], np.int64), T)


def test_team_body_matches_element_bitwise_and_plain(harnesses):
    _, run = harnesses
    prob, x, x_prev, xi_prev = twin_state()
    disc, bm = prob.disc, prob.assembler.bmodel
    E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
    buf = _run(run, "team", prob, x, x_prev, xi_prev)
    ref, at = _outputs(buf, E, nde, nxi)
    iters_p = torch.zeros(E, dtype=torch.int32)
    want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0, x_prev=x_prev,
                                newton_iters=iters_p)
    np.testing.assert_array_equal(ref[3], want[3].numpy())
    np.testing.assert_array_equal(ref[4], want[4].numpy())
    np.testing.assert_array_equal(ref[5], iters_p.numpy())
    for got, w, label in zip(ref[:3], want[:3], ("R", "J", "xi")):
        assert _close(got, w.numpy().reshape(-1), 1e-13), label
    assert 0 < int(ref[3].sum()) < E, "single-branch state"
    lanes = []
    for _ in range(4):
        G = int(np.frombuffer(buf[at:at + 4], np.int32)[0])
        team, n = _outputs(buf[at + 20:], E, nde, nxi)
        at += 20 + n
        lanes.append(abs(G))
        for a, b, label in zip(team, ref, ("R", "J", "xi", "path", "fail", "iters")):
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (G, label)
    assert at == len(buf) and lanes[:2] == [1, 4], lanes
