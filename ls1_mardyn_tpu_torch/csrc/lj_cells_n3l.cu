// LJ-12-6 cell forces by Newton's third law on the dense RMM cell layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_n3l (body _lj_n3l_kernel).  Same function: the
// forces on every slot of the cell-local layout r[nz, ny, P, nx*cap]
// (planes x, y, z, valid; P >= 4 is the plane count of the parent tensor,
// so the RMM state's 8-plane tensor is read in place), u6 (6*U incl.
// shift6) and the virial, each pair evaluated ONCE: u6 and the virial
// are not halved.
//
// Traversal: the half shell.  A cell meets its own slots with j > i and
// the 13 forward neighbour cells (dz > 0, or dz = 0 and dy > 0, or
// dz = dy = 0 and dx = +1), and adds the reaction -F_ij to the j slot.
// The TPU kernel takes 5 forward (dz, dy) rows with a double-sided own
// row and folds a per-row j accumulator (jacc) back in XLA; both cover
// every pair once.  Needs nx, ny, nz >= 3: with two cells on an axis the
// offsets +1 and -1 reach the same cell and the forward half is no half.
//
// The kernel is lj_warp.cuh's half_shell, the body of K1 (lj_cells.cu)
// too, under this kernel's own name: K1 replaces the TPU's production
// kernel, this one its half-shell variant behind the RMM engine's switch
// n3l.  On the warp skeleton: a warp owns a 32-slot i chunk (i
// compaction, the half-warp split for n_i <= 16) and stages the valid j
// slots of its 14 cells that lie within rc of the bounding box of its
// valid i slots into a 64-entry ring (ballot + popc), 32 at a time.
// What the half shell adds:
//   * the half shell in the pair test: an own-cell entry carries its slot
//     id, a forward-cell entry 2 * cap (above every slot id), so the test
//     j.w > me.w keeps j > i in the own cell and every forward pair (also
//     where several warps share the own cell).  Own-cell j slots at or
//     below the warp's first valid i slot are culled while staging;
//   * reactions by register rotation: in a full round of 32 entries each
//     lane holds one entry (of its half, with the split) and its reaction
//     sums in registers, meets its i, and passes both one lane on by
//     shuffles, so after 32 (16) steps every i has met every entry of its
//     half and no two lanes ever add to the same sum.  Then the lane that
//     holds an entry adds its reaction to f with global atomics (f32 and
//     f64 are native on sm_90), skipping a reaction that is exactly 0; the
//     warp's shared memory keeps the entry's offset in f beside it.  The
//     last, partial round is walked skewed: at step b the lane of rank l
//     in its half takes the half's entry of rank (l + b) mod m and adds
//     the reaction to the entry's sums in shared memory with atomics; then
//     one lane an entry adds them to f.  Nothing assumes that the lanes of
//     a warp run in lockstep.  The i forces go to f by atomics at the end
//     of the warp, so the wrapper zeroes f.  The rotation and the skewed
//     walk are shared with K10 (lj_packed.cu);
//   * u6 and the virial counted once per pair (block_macro, scale 1).
// The atomics make the order of the sums, and so the last bits of f, vary
// from run to run: f agrees with the plain version to rounding.
//
// What bounds it (H100, PERF.md): the walk -- half the j iterations of
// the full shell (151 a warp on the first round's dense state against
// 283; 629 against 1,236 on the benchmark's argon state) at ~1.4-1.5x
// the cost each (seven shuffles a step) -- plus the global atomics of
// the flushes.  Measured and dropped: the skewed walk for the full
// rounds too (~2.1x a full-shell iteration, 27% slower: its 16-byte
// entry load is no broadcast, and three shared atomics a step), and the
// rotation of the reactions alone with the entries loaded skewed (2%
// slower).
//
// Rounding: r^2 is formed without FMA from r_i - (r_j + shift), as the
// plain version (lj_cell_forces_n3l_reference, which is K1's
// lj_cell_forces_reference) forms it, so both apply the cutoff to the
// same pairs.

#include "lj_warp.cuh"

namespace {

// Forces on every slot of r[nz, ny, P, nx*cap] into f[nz, ny, 3, nx*cap]
// (zeroed by the caller), each pair of the half shell once.
template <typename T, bool MACRO>
__global__ void __launch_bounds__(ljw::WARPS * 32)
    n3l_kernel(const T* __restrict__ r, int P, T* __restrict__ f,
               T* __restrict__ part, ljk::Grid gd, ljk::LocalNbr<T> nbr,
               ljk::LJ<T> lj) {
  ljw::half_shell<T, MACRO>(r, P, f, part, gd, nbr, lj);
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  return ljw::launch_half<T>(n3l_kernel<T, false>, n3l_kernel<T, true>, r, f,
                             part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                             sig2, shift6, rc2, macro, stream);
}

}  // namespace

extern "C" {

// rows of part: one a warp (ljw::half_parts)
int lj_cells_n3l_num_blocks(int nx, int ny, int nz, int cap) {
  return (int)ljw::half_parts(nx, ny, nz, cap);
}

int lj_cells_n3l_f32(const void* r, void* f, void* part, int nx, int ny, int nz,
                     int cap, int planes, double clx, double cly, double clz,
                     double eps24, double sig2, double shift6, double rc2,
                     int macro, void* stream) {
  return launch<float>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                       sig2, shift6, rc2, macro, stream);
}

int lj_cells_n3l_f64(const void* r, void* f, void* part, int nx, int ny, int nz,
                     int cap, int planes, double clx, double cly, double clz,
                     double eps24, double sig2, double shift6, double rc2,
                     int macro, void* stream) {
  return launch<double>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz,
                        eps24, sig2, shift6, rc2, macro, stream);
}

}  // extern "C"
