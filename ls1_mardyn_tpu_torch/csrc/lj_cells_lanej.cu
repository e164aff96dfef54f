// LJ-12-6 row forces from an explicit j view in cell-local coordinates,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_lanej (body _lj_lanej_kernel).  Same function as
// lj_cells_row.cu in cell-local mode: double-sided forces on every slot
// of r_i[nz, ny, 4, nx*cap] against the 9 neighbour rows of a j view
// r_j[nz, ny, 4, (nx+2)*cap] that carries one periodic halo cell per
// side in x; the neighbour cell at offset (dx, dy, dz) is shifted by
// whole cell edges.  u6 (6*U incl. shift6) and the virial are halved per
// pair.
//
// What defines the TPU kernel is its layout: j on the lanes, i on the
// sublanes, and with `defer` the reductions over j done once per tile
// rather than once per neighbour row.  On this card the kernel runs on
// the warp skeleton of lj_warp.cuh (a warp a 32-slot i chunk; the j slots
// of its 27 neighbour cells box-culled, ballot-compacted and walked by
// every i lane, so no i force is reduced across lanes), with the
// neighbour functor of K4 (lj_cells_row.cu) at hx = 1, local mode and no
// y or z halo rows.  `defer` chose where the TPU kernel reduced across
// lanes, i.e. only the order of the sums; here there is no such
// reduction, and both values run the same code and give bit-identical
// results.  The skeleton stages through a fixed 4 KB of shared memory a
// block (f32; 8 KB in f64), so the kernel takes every cap the wrappers
// take (<= 1024).
//
// What bounds it, and the rounding (r^2 formed without FMA from
// r_i - (r_j + shift), as the plain version lj_cell_forces_row_reference
// forms it): lj_warp.cuh.

#include "lj_warp.cuh"

namespace {

template <typename T>
int launch(const void* ri, const void* rj, void* f, void* part, int nx, int ny,
           int nz, int cap, double ux, double uy, double uz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  // hx = 1, local mode, no z or y halo rows
  const ljw::RowNbr<T> nbr{(const T*)rj, nx, ny, nz, cap, 1, 1, 0, 0,
                           T(ux), T(uy), T(uz)};
  return ljw::launch_warp<T, false, false, false>(
      ri, 4, f, part, nx, ny, nz, cap, nbr, eps24, sig2, shift6, rc2, macro, 0, 0,
      stream);
}

}  // namespace

extern "C" {

int lj_cells_lanej_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap);
}

// `defer` is taken and changes nothing (see above).
int lj_cells_lanej_f32(const void* ri, const void* rj, void* f, void* part,
                       int nx, int ny, int nz, int cap, double ux, double uy,
                       double uz, double eps24, double sig2, double shift6,
                       double rc2, int macro, int defer, void* stream) {
  (void)defer;
  return launch<float>(ri, rj, f, part, nx, ny, nz, cap, ux, uy, uz, eps24, sig2,
                       shift6, rc2, macro, stream);
}

int lj_cells_lanej_f64(const void* ri, const void* rj, void* f, void* part,
                       int nx, int ny, int nz, int cap, double ux, double uy,
                       double uz, double eps24, double sig2, double shift6,
                       double rc2, int macro, int defer, void* stream) {
  (void)defer;
  return launch<double>(ri, rj, f, part, nx, ny, nz, cap, ux, uy, uz, eps24,
                        sig2, shift6, rc2, macro, stream);
}

}  // extern "C"
