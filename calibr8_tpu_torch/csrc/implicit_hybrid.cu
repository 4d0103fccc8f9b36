// Fused element assembly in the implicit mode for
// hybrid_hyper_J2_plane_stress: the in-element local Newton, residual
// rows and implicitly condensed Jacobian of c8_implicit.cuh, with the
// model of c8_hybrid.cuh, whose hardening is an embedded feed-forward
// network.
//
// Replaces calibr8_tpu's Pallas kernel make_pallas_assemble
// (fem/pallas_assembly.py:157, pallas_call at :496) in its implicit mode
// (:363-400) with the displacement-only plane-stress rows (:299-314,
// 402-421) for BatchedHybridHyperJ2PlaneStress (models/batched.py:
// 1956-2011).  A library of its own, built beside the others without FMA
// contraction (kernels.EXTRA_FLAGS) as the implicit libraries are, so that
// its local Newton stops where the plain version's does.
//
// What bounds it on an H100: the stores, as for the other plane-stress
// instances (nde 6: 36 words of J per element), ~0.1 GB in float64 at
// notch2D h=0.004.  The arithmetic: up to 20 local Newton iterations of 6
// tangents and a condensation of 10, each residual running the network
// twice (NN(in_scale alpha) on duals, NN(0) on plain T), a few exp per
// hidden unit.  The library launches c8_implicit.cuh's team kernel at G =
// 1 (the model gives no TEAM_LANES), one thread per element; the network's
// activations sit in local memory (their widths are known at run time
// only).  A team of lanes for it is later work.
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py):
// c8_implicit_assembly's arguments (model 12), then the network: act
// (c8_hybrid.cuh NN_*), n_layers (weight layers), widths (n_layers + 1
// int32, the topology), in_scale, out_scale, par_stride (the parameter
// row's length, 3 + the weights').  A network outside the cap of
// c8_hybrid.cuh, or a stride that does not match it, returns
// cudaErrorInvalidValue without a launch.

#include "c8_hybrid.cuh"
#include "c8_implicit.cuh"

extern "C" int c8_implicit_hybrid_assembly(
    int device, int dtype, int model, int E, const void* x, const void* x_prev,
    const void* edofs_T, const void* xi_prev, const void* gN_T, const void* detJ, const void* h,
    const void* params, const void* es_ids, const double* quad, int npts, double stab_half,
    double thick, double abs_tol, double fail_tol, void* R_T, void* J_T, void* xi_T, void* path,
    void* fail, void* iters, void* stream, int act, int n_layers, const int* widths,
    double in_scale, double out_scale, int par_stride) {
  if (act < c8::NN_RELU || act > c8::NN_SOFTPLUS || n_layers < 2 ||
      n_layers > c8::NN_MAX_HIDDEN + 1 || widths[0] != 1 || widths[n_layers] < 1)
    return (int)cudaErrorInvalidValue;
  c8::Net nt;
  nt.act = act;
  nt.n_layers = n_layers;
  int n_w = 0;
  for (int l = 0; l <= n_layers; ++l) {
    nt.width[l] = widths[l];
    if (l > 0 && l < n_layers && (widths[l] < 1 || widths[l] > c8::NN_MAX_WIDTH))
      return (int)cudaErrorInvalidValue;
    if (l > 0) n_w += widths[l] * widths[l - 1] + widths[l];
  }
  nt.stride = par_stride;
  nt.in_scale = in_scale;
  nt.out_scale = out_scale;
  if (par_stride != c8::HybridHyperJ2PlaneStress<double>::NPAR + n_w)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // ordered before the launch on the same stream
  err = cudaMemcpyToSymbolAsync(c8::c8_net_dev, &nt, sizeof(nt), 0, cudaMemcpyHostToDevice,
                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return c8::implicit_team_entry<c8::HybridHyperJ2PlaneStress>(
      device, dtype, model - 12, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
      quad, npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, stream);
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
