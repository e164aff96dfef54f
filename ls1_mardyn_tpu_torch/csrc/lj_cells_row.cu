// LJ-12-6 row forces from an explicit j view with halos, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas (body _lj_row_kernel): double-sided 1CLJ forces
// of every slot of r_i[nz, ny, 4, nx*cap] against a SEPARATE j view
// r_j[nz(+2), ny(+2), 4, (nx+2*hx)*cap] that carries hx halo cells per
// side in x (the innermost is the periodic image) and, with z_halo /
// y_halo, one explicit halo row per side in z / y -- which is what lets
// a decomposed caller feed it exchanged rows.  Two coordinate modes:
//   * local: cell-local coordinates; the neighbour cell at offset
//     (dx, dy, dz) is shifted by (dx*clx, dy*cly, dz*clz);
//   * absolute: the caller pre-shifted the x halo cells by -+Lx; the
//     kernel adds -+by / -+bz to a j row whose row index wrapped, and
//     nothing where the row is an explicit halo row.
// In both, dr = r_i - (r_j + shift) with the shift added first and
// rounded once, as the plain PyTorch version forms it: at a box of 174
// sigma an f32 coordinate has an ulp of 1.5e-5, and any other order
// would move pairs across the cutoff.
// The TPU kernel pairs an i slot with its whole (tx+2*hx)-cell tile
// window; this kernel takes the +-1-cell window (the caller guarantees a
// cell edge >= rc, so no pair is lost).  Its identity-matmul transposes,
// selector matmuls and the plane-3 scalar packing are not reproduced.
//
// The kernel skeleton (a warp a 32-slot i chunk, box-culled and
// ballot-compacted j slots), its design, what bounded the block skeleton
// before it, and the neighbour functor of the j view (RowNbr, shared with
// K7's lj_cells_lanej.cu) are lj_warp.cuh's.  The window is +-1 cell for
// any hx: the halo cells beyond the first are never read.

#include "lj_warp.cuh"

namespace {

template <typename T>
int launch(const void* ri, const void* rj, void* f, void* part, int nx, int ny,
           int nz, int cap, int hx, int local, int zhalo, int yhalo, double ux,
           double uy, double uz, double eps24, double sig2, double shift6,
           double rc2, int macro, void* stream) {
  const ljw::RowNbr<T> nbr{(const T*)rj, nx, ny, nz, cap, hx, local, zhalo,
                           yhalo, T(ux), T(uy), T(uz)};
  return ljw::launch_warp<T, false, false, false>(
      ri, 4, f, part, nx, ny, nz, cap, nbr, eps24, sig2, shift6, rc2, macro, 0, 0,
      stream);
}

}  // namespace

extern "C" {

int lj_cells_row_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap);
}

int lj_cells_row_f32(const void* ri, const void* rj, void* f, void* part, int nx,
                     int ny, int nz, int cap, int hx, int local, int zhalo,
                     int yhalo, double ux, double uy, double uz, double eps24,
                     double sig2, double shift6, double rc2, int macro,
                     void* stream) {
  return launch<float>(ri, rj, f, part, nx, ny, nz, cap, hx, local, zhalo, yhalo,
                       ux, uy, uz, eps24, sig2, shift6, rc2, macro, stream);
}

int lj_cells_row_f64(const void* ri, const void* rj, void* f, void* part, int nx,
                     int ny, int nz, int cap, int hx, int local, int zhalo,
                     int yhalo, double ux, double uy, double uz, double eps24,
                     double sig2, double shift6, double rc2, int macro,
                     void* stream) {
  return launch<double>(ri, rj, f, part, nx, ny, nz, cap, hx, local, zhalo,
                        yhalo, ux, uy, uz, eps24, sig2, shift6, rc2, macro,
                        stream);
}

}  // extern "C"
