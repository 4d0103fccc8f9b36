// Fused element assembly in the implicit mode for hypo_barlat, for
// calibr8_tpu's BatchedHypoBarlat (models/batched.py:1904-1953: Barlat
// Yld2004-18p on the unrotated stress, two linear transforms and two
// eigendecompositions per residual, t_barlat_L_apply / t_barlat_phi_n
// :1711-1765), in a library of its own so that its instances, the
// heaviest of the eigensolver family, build beside the Hosford ones.
// implicit_eig.cu says what it replaces and how it is built.
//
// What bounds it on an H100: the arithmetic.  Its stores are those of the
// other 3D twins (0.15 ms at cube n=32 in float64); its operations,
// counted on the host (implicit_cost.FLOPS), are ~1.4e5 per element plus
// ~1.6e4 per local Newton update (the residual's two eigendecompositions
// on 7 tangents) and ~1.3e3 per line-search trial on plain T, and the
// condensation carries 16 tangents through them and three polar factors,
// with 25 parameters.  One thread per element spilled 85 KB in float64.
// The library launches c8_implicit.cuh's team kernel at G = 2 (HypoBarlat's
// TEAM_LANES, from implicit_sweep.py on the card): each lane carries 8 of
// the 16 tangents and runs two of the line search's four trials; its
// outputs are implicit_element's, and the earlier thread-per-element
// kernel's, bit for bit.
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py),
// the same as c8_implicit_assembly's; model: 11 hypo_barlat (3D, mixed
// u/p, reads x_prev).

#include "c8_hosford.cuh"
#include "c8_implicit.cuh"

extern "C" int c8_implicit_barlat_assembly(int device, int dtype, int model, int E, const void* x,
                                           const void* x_prev, const void* edofs_T,
                                           const void* xi_prev, const void* gN_T,
                                           const void* detJ, const void* h, const void* params,
                                           const void* es_ids, const double* quad, int npts,
                                           double stab_half, double thick, double abs_tol,
                                           double fail_tol, void* R_T, void* J_T, void* xi_T,
                                           void* path, void* fail, void* iters, void* stream) {
  return c8::implicit_team_entry<c8::HypoBarlat>(
      device, dtype, model - 11, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
      quad, npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, stream);
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
