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
// The TPU kernel's halo-padded j view, phase-stacked j copies and the
// plane-3 scalar packing are layout tricks of the TPU and are not
// reproduced.
//
// Each pair inside the cutoff is evaluated ONCE, by Newton's third law,
// as the TPU kernel does: a cell meets its own slots with j > i and the
// 13 forward neighbour cells (dz > 0, or dz = 0 and dy > 0, or dz = dy =
// 0 and dx = +1), and the reaction -F_ij goes to the j slot.  u6 and the
// virial are counted once per pair (not halved), one row of part a warp.
// Needs nx, ny, nz >= 3.
//
// The kernel is lj_warp.cuh's half_shell, on the warp skeleton: a warp
// owns a 32-slot i chunk (i compaction, the half-warp split for n_i <=
// 16) and stages the valid j slots of its 14 cells that lie within rc of
// the bounding box of its valid i slots (the exact box cull) into a
// 64-entry ring, 32 at a time; own-cell slots at or below the warp's
// first valid i are culled while staging.  A full round passes its j
// entries and their reactions through the lanes by shuffles, so no two
// lanes add to one sum, and ends with each reaction added to f by a
// global atomic reduction; the last, partial round is walked skewed with
// shared atomics and flushed; the i forces reach f by atomics at the
// warp's end.  f is zeroed by the wrapper, and the order of the sums
// varies from run to run: f agrees with the plain version to rounding
// and is not bitwise reproducible.  The wrappers of K8 (the TPU's
// half-shell variant) and of K3, where K3 takes the half shell, launch
// this kernel too.
//
// Measured and dropped (H100, PERF.md): summing the reactions of a
// cell's warps per block in shared memory where a block is one cell (cap
// 128, the RMM engine's grid on the benchmark's argon state), with one
// global atomic a nonzero slot sum at the block's end: 7.99 ms against
// 6.55 by the warps' own flushes, because Hopper has no native
// shared-memory float atomic (ATOMS.CAST.SPIN, a compare-and-swap loop,
// where the global reduction REDG.E.ADD.F32 is native); staggering the
// warps' cell order did not help (8.17).  Leaving the entry's w out of
// the rotation in rounds of forward cells only (six shuffles a step, the
// entry read back from the ring) was slower (6.68): two instances of
// each unrolled round.
//
// What bounds it (H100, PERF.md): the walk, at half the j iterations of
// the full shell it replaced (629 against 1,236 a warp on the argon
// state, 151 against 283 on the first round's dense state), each about
// 1.4 times the cost of a full-shell iteration: 6.41-6.46 ms against
// 8.91-8.98 on the argon state, 2.51-2.53 against 3.08-3.11 on the dense
// one.  The reactions' three shuffles a step cost ~2% and the global
// atomics ~1.5% (measured without them); the rest is the pair term with
// its reaction, the entries' shuffles, and eight resident blocks an SM
// (61 registers, f32) against the full shell's nine (56).
//
// Rounding: r^2 is formed without FMA from r_i - (r_j + shift), as the
// plain version (lj_cell_forces_reference, the half shell) forms it, so
// both apply the cutoff to the same pairs.

#include "lj_warp.cuh"

namespace {

// Forces on every slot of r[nz, ny, P, nx*cap] into f[nz, ny, 3, nx*cap]
// (zeroed by the caller), each pair of the half shell once.
template <typename T, bool MACRO>
__global__ void __launch_bounds__(ljw::WARPS * 32)
    warp_cells_kernel_half(const T* __restrict__ r, int P, T* __restrict__ f,
                           T* __restrict__ part, ljk::Grid gd,
                           ljk::LocalNbr<T> nbr, ljk::LJ<T> lj) {
  ljw::half_shell<T, MACRO>(r, P, f, part, gd, nbr, lj);
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  return ljw::launch_half<T>(warp_cells_kernel_half<T, false>,
                             warp_cells_kernel_half<T, true>, r, f, part, nx, ny,
                             nz, cap, planes, clx, cly, clz, eps24, sig2, shift6,
                             rc2, macro, stream);
}

}  // namespace

extern "C" {

// rows of part: one a warp (ljw::half_parts)
int lj_cells_num_blocks(int nx, int ny, int nz, int cap) {
  return (int)ljw::half_parts(nx, ny, nz, cap);
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
