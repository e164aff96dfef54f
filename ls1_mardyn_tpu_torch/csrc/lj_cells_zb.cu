// LJ-12-6 cell forces on the dense RMM cell layout, for Hopper (sm_90a),
// with the Gram form of r^2 as an option.
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_zb (body _lj_zb_kernel).  Same function as
// lj_cells.cu: double-sided forces on every slot of the cell-local layout
// r[nz, ny, P, nx*cap] (planes x, y, z, valid; P >= 4, so the RMM state's
// 8-plane tensor is read in place), u6 (6*U incl. shift6) and the virial,
// both halved per pair.
//
// What defines the TPU kernel is the z band: one program owns a z plane
// and holds its three neighbouring z planes whole in VMEM, so each j row
// is fetched from HBM 3 times and not 9.  On this card the fetches are
// not what bounds a cell kernel (staging is ~8% of K1's instructions,
// PERF.md), and the band is not carried over as a staging scheme.  The
// kernel runs on the warp skeleton of lj_warp.cuh (a warp a 32-slot i
// chunk, box-culled and ballot-compacted j slots, neighbour rows shared
// through L1) in its band order: the warps of a block take consecutive
// y rows of one x cell and z plane, and blocks run along x (1.2% faster
// than K1's block of consecutive x cells on K1's state, PERF.md).
//
// gram = 1 forms r^2 = (|r_j|^2 + |r_i|^2) - (r_i.r_j + r_i.r_j), as the
// TPU kernel's gram mode does on its matrix unit, here in the kernel's
// own round-to-nearest arithmetic (no FMA, no library call), in the
// order of the plain version (ops/cuda_lj_variants.py: _gram_reference),
// so both take the same side of the cutoff for every pair; the force
// r_i * sum_j fac - sum_j fac * r_j is summed as sum_j fac * (r_i - r_j).
// The coordinates are local to the i cell (r_j gets its image shift;
// |r| <= 2 cell edges), so the cancellation in r^2 stays near
// ulp(|r_i|^2 + |r_j|^2).  Empty slots are masked on the validity plane
// before any Gram term counts: two sentinel slots (y ~ 1e3 * slot) would
// cancel to anything.  The Gram r^2 can come out below the true
// distance, so its box cull keeps a margin; the argument is in
// lj_warp.cuh.
//
// The kernel takes any cap up to the wrappers' 1024: the warp skeleton
// stages through a fixed 4 KB (Gram form 8 KB) of shared memory a block
// in f32, twice that in f64.

#include "lj_warp.cuh"

namespace {

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, int gram,
           void* stream) {
  const ljk::LocalNbr<T> nbr{(const T*)r, nx, ny, nz, cap, planes, 0,
                             T(clx), T(cly), T(clz)};
  return ljw::launch_warp<T, false, true, true>(
      r, planes, f, part, nx, ny, nz, cap, nbr, eps24, sig2, shift6, rc2, macro,
      0, gram, stream);
}

}  // namespace

extern "C" {

int lj_cells_zb_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap, true);
}

int lj_cells_zb_f32(const void* r, void* f, void* part, int nx, int ny, int nz,
                    int cap, int planes, double clx, double cly, double clz,
                    double eps24, double sig2, double shift6, double rc2,
                    int macro, int gram, void* stream) {
  return launch<float>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                       sig2, shift6, rc2, macro, gram, stream);
}

int lj_cells_zb_f64(const void* r, void* f, void* part, int nx, int ny, int nz,
                    int cap, int planes, double clx, double cly, double clz,
                    double eps24, double sig2, double shift6, double rc2,
                    int macro, int gram, void* stream) {
  return launch<double>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz,
                        eps24, sig2, shift6, rc2, macro, gram, stream);
}

}  // extern "C"
