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
// What bounds it on an H100: the arithmetic.  Its stores are those of the
// other 3D twins (2 KB of J_T per element in float64, 0.15 ms at cube n=32
// at 3.35 TB/s); its operations, counted on the host (implicit_cost.FLOPS,
// none on a tangent slot that no seed reaches), are ~1.4e4 (small_hosford)
// and ~6.0e4 (hypo_hosford) per element plus ~5.2e3 per local Newton
// update and ~6e2 per line-search trial.  Every
// residual runs one eigendecomposition (three 3x3 products, acos, cos, the
// eigenvector selects, some 25 divides) and six |x|^e, under up to 30
// local Newton iterations and 4 line-search trials on plain T, and f64
// divides and functions are long instruction sequences on the card.
//
// The design: the yield surface is a function of the symmetric stress
// alone, so it runs on the stress's six voigt components (c8_eig.cuh
// yield_inner: Dual<T, 6>, its 7 x 6 Jacobian contracted with the outer
// tangents) instead of the residual's 7 (Newton) or 16 (condensation)
// tangents: the eigensolver's scalar is 7 words, not 17, which cuts
// small_hosford's spills about threefold (ptxas -v).  For hypo_hosford
// the stress is xi's own six seeds, so each outer tangent is one inner
// column times 1 plus zeros: exact (implicit_sweep.py found the outputs of
// the kernel before this design bit for bit at cube n=32); its cost is the
// polar factors of the unrotated rate under 16 tangents, 7 of them zero
// (the precompute hook), as hypo_hill's.  Both twins launch c8_implicit.cuh's team kernel
// at G = 2 in float64 (each lane carrying half the tangents and half the
// inner seeds, which meet in the team's scratch, and two of the four
// line-search trials) and G = 1 in float32 (TEAM_LANES, from
// implicit_sweep.py on the card; PERF.md): more lanes repeat the
// eigensolver's primal values, which cost more than the split tangents
// save.
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
