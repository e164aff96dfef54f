// LJ-12-6 cell-window forces on the cell-local layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_cw (body _lj_cw_kernel): 1CLJ forces of every
// slot of r_i[nz, ny, Pi, nx*cap] (planes x, y, z, valid in cell-local
// coordinates) against the 27 neighbour cells of a j source
// r_j[nzj, ny, Pj, nx*cap], plus u6 (6*U incl. shift6) and the virial.
// Two branches, chosen by the wrapper (ops/cuda_lj.py: cw_half_shell)
// from the inputs alone:
//   * the half shell: where the j source is r_i itself, with no z halo,
//     every axis at least 3 cells and no per-slot virial, each pair
//     inside the cutoff is evaluated once, by Newton's third law: the
//     wrapper launches K1's kernel (lj_cells.cu, lj_warp.cuh's
//     half_shell), which takes exactly these inputs.  The reaction goes
//     to j by atomics (f zeroed by the wrapper, its last bits vary from
//     run to run); u6 and the virial are counted once per pair;
//   * the double-sided walk, this file's kernel: every other call, each
//     pair evaluated from both sides, u6 and the virial halved per pair;
//     deterministic.  An explicit j source or z halo rows keep it (no
//     reaction may land on a halo row), as do ny or nz of 1 or 2 (two
//     offsets reach one row, and both count) and Vi (planes 3-5 hold
//     per-slot virials).
// What the double-sided walk adds to lj_cells.cu's contract:
//   * VI: three more output planes with the per-slot per-axis virial
//     0.5 * sum_j f_a * dr_a (FullMolecule::Vi);
//   * z_halo: the j source carries two explicit z halo rows (nzj = nz+2);
//     neighbour row dz is row z+dz+1, no wrap in z.  The cell offset
//     dz*clz still applies: the coordinates are cell-local;
//   * the domain nx >= 3 with ny, nz down to 1: with <= 2 rows on an
//     axis two offsets reach the same row through different periodic
//     images, and both count.
// The TPU kernel's j view carries a 1+3-cell x halo and four
// phase-shifted copies so that every window read is lane-aligned; here a
// warp computes its neighbour cell's address itself (ljk::LocalNbr), x
// and y wrap in the index, and no halo or copy is stored.
//
// The kernel skeleton (a warp a 32-slot i chunk, box-culled and
// ballot-compacted j slots), its design and what bounded the block
// skeleton before it are lj_warp.cuh's.

#include "lj_warp.cuh"

namespace {

template <typename T>
int launch(const void* ri, const void* rj, void* f, void* part, int nx, int ny,
           int nz, int cap, int pi, int pj, int zhalo, double clx, double cly,
           double clz, double eps24, double sig2, double shift6, double rc2,
           int macro, int vi, void* stream) {
  const ljk::LocalNbr<T> nbr{(const T*)rj, nx, ny, nz, cap, pj, zhalo,
                             T(clx), T(cly), T(clz)};
  return ljw::launch_warp<T, true, false, false>(
      ri, pi, f, part, nx, ny, nz, cap, nbr, eps24, sig2, shift6, rc2, macro, vi,
      0, stream);
}

}  // namespace

extern "C" {

int lj_cells_cw_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap);
}

int lj_cells_cw_f32(const void* ri, const void* rj, void* f, void* part, int nx,
                    int ny, int nz, int cap, int pi, int pj, int zhalo,
                    double clx, double cly, double clz, double eps24,
                    double sig2, double shift6, double rc2, int macro, int vi,
                    void* stream) {
  return launch<float>(ri, rj, f, part, nx, ny, nz, cap, pi, pj, zhalo, clx, cly,
                       clz, eps24, sig2, shift6, rc2, macro, vi, stream);
}

int lj_cells_cw_f64(const void* ri, const void* rj, void* f, void* part, int nx,
                    int ny, int nz, int cap, int pi, int pj, int zhalo,
                    double clx, double cly, double clz, double eps24,
                    double sig2, double shift6, double rc2, int macro, int vi,
                    void* stream) {
  return launch<double>(ri, rj, f, part, nx, ny, nz, cap, pi, pj, zhalo, clx,
                        cly, clz, eps24, sig2, shift6, rc2, macro, vi, stream);
}

}  // extern "C"
