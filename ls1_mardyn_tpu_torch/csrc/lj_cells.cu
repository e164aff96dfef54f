// LJ-12-6 cell forces on the dense RMM cell layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_cwn3l (body _lj_cwn3l_kernel).  Same contract:
// forces on every slot of the cell-local layout r[nz, ny, P, nx*cap]
// (planes x, y, z, valid; P >= 4 is the plane count of the parent
// tensor, so the RMM state's 8-plane tensor is read in place), plus the
// LJ energy sum u6 (6*U incl. shift6) and the virial sum over pairs.
// The j source is r itself: every neighbour cell is found by a periodic
// wrap of the cell index, shifted by its cell offset times the cell edge.
//
// The kernel skeleton (a warp a 32-slot i chunk, box-culled and
// ballot-compacted j slots), its design and what bounded the block
// skeleton before it are lj_warp.cuh's.  The TPU kernel's halo-padded j
// view, phase-stacked j copies and the plane-3 scalar packing are layout
// tricks of the TPU and are not reproduced.

#include "lj_warp.cuh"

namespace {

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  const ljk::LocalNbr<T> nbr{(const T*)r, nx, ny, nz, cap, planes, 0,
                             T(clx), T(cly), T(clz)};
  return ljw::launch_warp<T, false, false, false>(
      r, planes, f, part, nx, ny, nz, cap, nbr, eps24, sig2, shift6, rc2, macro,
      0, 0, stream);
}

}  // namespace

extern "C" {

int lj_cells_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap);
}

int lj_cells_f32(const void* r, void* f, void* part, int nx, int ny, int nz,
                 int cap, int planes, double clx, double cly, double clz,
                 double eps24, double sig2, double shift6, double rc2, int macro,
                 void* stream) {
  return launch<float>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                       sig2, shift6, rc2, macro, stream);
}

int lj_cells_f64(const void* r, void* f, void* part, int nx, int ny, int nz,
                 int cap, int planes, double clx, double cly, double clz,
                 double eps24, double sig2, double shift6, double rc2, int macro,
                 void* stream) {
  return launch<double>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                        sig2, shift6, rc2, macro, stream);
}

}  // extern "C"
