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
// notch2D h=0.004; the operations its data needs (implicit_cost.FLOPS, at
// chip_smoke.py's [1, 4, 1] sigmoid network) are of the same order.  Up
// to 20 local Newton iterations of 6 tangents and a condensation of 10,
// each residual running the network once on alpha's value and its one live
// tangent; NN(0) once per element (c8_hybrid.cuh).  The library launches
// c8_implicit.cuh's team kernel at the model's TEAM_LANES (1 in both
// dtypes, from `python -m calibr8_tpu_torch.implicit_sweep` on the card),
// one thread per element.  A network of one hidden layer keeps no activation; a
// deeper one keeps its layers in a slab of shared memory per thread, which
// the entry asks the launch for (NN_SLAB_WORDS).
//
// The network's description goes to constant memory (c8_net_dev) only
// when it differs from the one this library wrote last on the card: the
// copy is ordered on the launch's stream before the launch, from a pinned
// host buffer that is rewritten only after the previous copy has read it.
// The description is the same for every launch of one network (its
// weights are read from the parameter row), so a solve copies it once.  It
// is not passed by value (__grid_constant__) because the kernel's entry,
// element bodies and residuals are the ones every implicit library shares.
// Not thread-safe, and launches of two networks on two streams at once
// would race (c8_hybrid.cuh).
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py):
// c8_implicit_assembly's arguments (model 12), then the network: act
// (c8_hybrid.cuh NN_*), n_layers (weight layers), widths (n_layers + 1
// int32, the topology), in_scale, out_scale, par_stride (the parameter
// row's length, 3 + the weights').  A network outside the cap of
// c8_hybrid.cuh, or a stride that does not match it, returns
// cudaErrorInvalidValue without a launch.

#include <cstring>

#include "c8_hybrid.cuh"
#include "c8_implicit.cuh"

namespace {

// per card: the description written last, and the pinned buffer it was
// copied from, with the event that marks the copy done
struct NetSlot {
  bool written = false;
  c8::Net last;
  c8::Net* pinned = nullptr;
  cudaEvent_t copied = nullptr;
};
constexpr int MAX_DEVICES = 64;
NetSlot slots[MAX_DEVICES];

// write nt to c8_net_dev on `stream` unless it is the one written last
cudaError_t put_net(int device, const c8::Net& nt, cudaStream_t stream) {
  NetSlot& s = slots[device];
  if (s.written && std::memcmp(&s.last, &nt, sizeof(nt)) == 0) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (!s.pinned) {
    err = cudaHostAlloc((void**)&s.pinned, sizeof(c8::Net), cudaHostAllocPortable);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&s.copied, cudaEventDisableTiming);
  } else {
    // the previous copy has read the buffer
    err = cudaEventSynchronize(s.copied);
  }
  s.written = false;
  if (err != cudaSuccess) return err;
  std::memcpy(s.pinned, &nt, sizeof(nt));
  err = cudaMemcpyToSymbolAsync(c8::c8_net_dev, s.pinned, sizeof(nt), 0, cudaMemcpyHostToDevice,
                                stream);
  if (err == cudaSuccess) err = cudaEventRecord(s.copied, stream);
  if (err != cudaSuccess) return err;
  s.last = nt;
  s.written = true;
  return cudaSuccess;
}

}  // namespace

extern "C" int c8_implicit_hybrid_assembly(
    int device, int dtype, int model, int E, const void* x, const void* x_prev,
    const void* edofs_T, const void* xi_prev, const void* gN_T, const void* detJ, const void* h,
    const void* params, const void* es_ids, const double* quad, int npts, double stab_half,
    double thick, double abs_tol, double fail_tol, void* R_T, void* J_T, void* xi_T, void* path,
    void* fail, void* iters, void* stream, int act, int n_layers, const int* widths,
    double in_scale, double out_scale, int par_stride) {
  if (act < c8::NN_RELU || act > c8::NN_SOFTPLUS || n_layers < 2 ||
      n_layers > c8::NN_MAX_HIDDEN + 1 || widths[0] != 1 || widths[n_layers] < 1 ||
      (dtype != 0 && dtype != 1) || device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  // zeroed: the description is compared as bytes
  c8::Net nt;
  std::memset(&nt, 0, sizeof(nt));
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
  // a deeper network's slab, after the team's words
  const int slab_words = n_layers > 2 ? c8::NN_SLAB_WORDS : 0;
  nt.slab_at =
      (int)(dtype == 0 ? c8::implicit_slab_at<float, c8::HybridHyperJ2PlaneStress<float>>()
                       : c8::implicit_slab_at<double, c8::HybridHyperJ2PlaneStress<double>>());
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = put_net(device, nt, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return c8::implicit_team_entry<c8::HybridHyperJ2PlaneStress>(
      device, dtype, model - 12, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
      quad, npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, stream,
      slab_words);
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
