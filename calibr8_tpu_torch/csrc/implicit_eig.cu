// Fused element assembly in the implicit mode for the eigensolver twins:
// in-element local Newton with the frozen branch and the line search,
// residual rows, and the implicitly condensed Jacobian.
//
// Replaces calibr8_tpu's Pallas kernel make_pallas_assemble
// (fem/pallas_assembly.py:157, pallas_call at :496) in its implicit mode
// (:363-400, local Newton models/batched.py:561-671 with freeze_path and
// its line search, :585-586, 603, 607, 621-647, 667) for small_hosford,
// hypo_hosford and hypo_barlat (batched.py:1768-1953): the symmetric 3x3
// eigendecomposition t_eig_sym33 (:1618-1667) and the Hosford and Barlat
// Yld2004-18p yield surfaces (:1670-1765).  The element code and the
// kernel are c8_implicit.cuh's, as for implicit_assembly.cu, the models
// c8_hosford.cuh, the eigensolver and yield surfaces c8_eig.cuh.  The two
// Hosford twins are this library, hypo_barlat is implicit_barlat.cu: each
// a library of its own so that nvcc builds the three beside each other
// (the eigensolver instances are the build's long pole).  Built without
// FMA contraction (kernels.EXTRA_FLAGS), as implicit_assembly.cu is.
//
// What bounds it on an H100: the stores, 2 KB of J_T per element in
// float64 against ~0.5 KB of inputs, ~0.5 GB at cube n=32 (0.15 ms at
// 3.35 TB/s).  The arithmetic is far larger than the Hill twins': every
// residual evaluation runs one eigendecomposition (two for Barlat: one
// per linear transform), each three 3x3 products, acos, cos and the
// eigenvector selects, under up to 30 local Newton iterations of 7
// tangents plus 4 line-search trials on plain T, and the condensation
// carries 16 tangents through them (and, for the hypo twins, through
// three polar factors of 6 iterations).  The library launches
// c8_implicit.cuh's team kernel at G = 1 (the two models give no
// TEAM_LANES): one thread per element, whose duals spill to local memory
// (ptxas reports it).  A team of lanes for these twins is later work.
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py),
// the same as c8_implicit_assembly's; model: 9 small_hosford, 10
// hypo_hosford (3D, mixed u/p; hypo_hosford reads x_prev).

#include "c8_hosford.cuh"
#include "c8_implicit.cuh"

extern "C" int c8_implicit_eig_assembly(int device, int dtype, int model, int E, const void* x,
                                        const void* x_prev, const void* edofs_T,
                                        const void* xi_prev, const void* gN_T, const void* detJ,
                                        const void* h, const void* params, const void* es_ids,
                                        const double* quad, int npts, double stab_half,
                                        double thick, double abs_tol, double fail_tol,
                                        void* R_T, void* J_T, void* xi_T, void* path, void* fail,
                                        void* iters, void* stream) {
  return c8::implicit_team_entry<c8::SmallHosford, c8::HypoHosford>(
      device, dtype, model - 9, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
      quad, npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, stream);
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
