// Fused element assembly in the implicit mode: in-element local Newton,
// residual rows, and the implicitly condensed Jacobian.
//
// Replaces calibr8_tpu's Pallas kernel make_pallas_assemble
// (fem/pallas_assembly.py:157, pallas_call at :496) in its implicit mode
// (:363-400, local Newton models/batched.py:561-671) for the small-strain
// Hill family, the finite-deformation J2 family and the hypo_hill family
// (batched.py:677-822, 1028-1157, 1290-1393: the polar rotation, and the
// precompute / residual_aux hoist of the unrotated rate, :594-603), with
// the displacement-only plane-stress rows (:299-314, :402-421).  For the
// finite-deformation twins that includes the `finite` branch (:235): the
// PK1 rows sigma cof(F) and the plane-stress z-stretch pullback
// (:299-310), the stabilization (tau / det F) cof^T cof grad_p
// (:309-315), the pressure columns through cof(F) and cof^T cof / det F
// (:423-451), and the x_prev input (:552-557, 588-589) from which
// grad_u_prev is formed.  The element code and the kernel are
// c8_implicit.cuh, the models c8_hill.cuh, c8_hyper.cuh and c8_hypo.cuh.
// The library is built without FMA contraction (kernels.EXTRA_FLAGS), so
// that each operation rounds as the plain version's do.
//
// What bounds it on an H100: the arithmetic.  J_T is nde^2 words per
// element (16*16*8 = 2 KB for the 3D twins in float64) against ~0.4-0.5 KB
// of inputs, ~0.5 GB at 196,608 elements (0.15 ms at 3.35 TB/s); the
// operations of one element, counted on the host (implicit_cost.FLOPS),
// are ~1.1e4 + 1.8e3 per local Newton update for small_hill, ~2.8e4 +
// 4.7e3 for hyper_J2 (each residual pushes the trial state through two
// 3x3 products, a 3x3 inverse, log and exp) and ~9.6e4 + 1.4e3 for
// hypo_hill (whose condensation carries 16 tangents through three polar
// factors of 6 iterations each), and float64 divides and functions are
// long instruction sequences.  The library launches c8_implicit.cuh's
// team kernel: G lanes per element (the model's TEAM_LANES, set from
// `python -m calibr8_tpu_torch.implicit_sweep` on the card), each lane
// carrying ceil(N / G) of the N tangents, the element's rows staged in
// shared memory and stored in the trailing layout (a warp's stores of one
// J entry are consecutive).  hypo_hill takes G = 4 in float64, where one
// thread spilled 44 KB; hypo_hill_plane_strain G = 2 in float32; the other
// instances G = 1, one thread per element (the lanes' repeated primal
// values cost them more than the split tangents save).  It reads the dofs
// straight from the flat x through edofs_T.  The team kernel gives
// implicit_element's outputs bit for bit at every G
// (tests/test_torch_implicit_team_host.py on the host, implicit_sweep.py
// on the card, where --alt also holds the earlier thread-per-element
// kernel to them).
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py).

#include "c8_implicit.cuh"

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; model: 0
// small_hill (3D, mixed), 1 small_hill_plane_strain (2D, mixed), 2
// small_hill_plane_stress (2D, displacement only), 3 hyper_J2 (3D,
// mixed), 4 hyper_J2_plane_strain (2D, mixed), 5 hyper_J2_plane_stress
// (2D, displacement only), 6 hypo_hill (3D, mixed), 7
// hypo_hill_plane_strain (2D, mixed), 8 hypo_hill_plane_stress (2D,
// displacement only); x_prev, the previous step's solution (n_dofs,), is
// read by models 3-8 only; fail_tol = max(10 abs_tol,
// 1e-30); iters may be null.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int c8_implicit_assembly(int device, int dtype, int model, int E, const void* x,
                                    const void* x_prev, const void* edofs_T,
                                    const void* xi_prev, const void* gN_T, const void* detJ,
                                    const void* h, const void* params, const void* es_ids,
                                    const double* quad, int npts, double stab_half,
                                    double thick, double abs_tol, double fail_tol, void* R_T,
                                    void* J_T, void* xi_T, void* path, void* fail, void* iters,
                                    void* stream) {
  return c8::implicit_team_entry<c8::SmallHill, c8::SmallHillPlaneStrain, c8::SmallHillPlaneStress,
                            c8::HyperJ2, c8::HyperJ2PlaneStrain, c8::HyperJ2PlaneStress,
                            c8::HypoHill, c8::HypoHillPlaneStrain, c8::HypoHillPlaneStress>(
      device, dtype, model, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad,
      npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, stream);
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
