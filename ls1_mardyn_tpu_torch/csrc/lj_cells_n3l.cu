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
// The kernel runs on the warp skeleton of lj_warp.cuh: a warp owns a
// 32-slot i chunk (i compaction, the half-warp split for n_i <= 16) and
// stages the valid j slots of its 14 cells that lie within rc of the
// bounding box of its valid i slots into a 64-entry ring (ballot + popc),
// 32 at a time.  What the half shell adds:
//   * the half shell in the pair test: an own-cell entry carries its slot
//     id, a forward-cell entry 2 * cap (above every slot id), so the test
//     j.w > me.w keeps j > i in the own cell and every forward pair, one
//     compare as K1's j.w != me.w (also for cap 64, where two warps share
//     the own cell).  Own-cell j slots at or below the warp's first valid
//     i slot are culled while staging;
//   * reactions by register rotation: in a full round of 32 entries each
//     lane holds one entry (of its half, with the split) and its reaction
//     sums in registers, meets its i, and passes both one lane on by
//     shuffles, so after 32 (16) steps every i has met every entry of its
//     half and no two lanes ever add to the same sum.  Then the lane that
//     holds an entry adds its reaction to f with global atomics (f32 and
//     f64 are native on sm_90), skipping a reaction that is exactly 0; the
//     ring keeps the entry's offset in f beside it.  The last, partial
//     round is walked skewed: at step b the lane of rank l in its half
//     takes the half's entry of rank (l + b) mod m and adds the reaction
//     to the entry's sums in shared memory with atomics; then one lane an
//     entry adds them to f.  Nothing assumes that the lanes of a warp run
//     in lockstep.  The i forces go to f by atomics at the end of the
//     warp, so the wrapper zeroes f.  The rotation, the skewed walk and
//     the flush are lj_warp.cuh's, shared with K10 (lj_packed.cu); the
//     pair test is this kernel's;
//   * u6 and the virial counted once per pair (block_macro, scale 1).
// The atomics make the order of the sums, and so the last bits of f, vary
// from run to run: f agrees with the plain version to rounding.
//
// What bounds it (H100, PERF.md): the walk, as for K1 -- half the j
// iterations (151 a warp on K1's main state, 283 by the full shell) at
// ~1.5x the cost each (seven shuffles a step) -- plus the global atomics
// of the flushes.  Measured and dropped: the skewed walk for the full
// rounds too (~2.1x a full-shell iteration, 27% slower: its 16-byte
// entry load is no broadcast, and three shared atomics a step), and the
// rotation of the reactions alone with the entries loaded skewed (2%
// slower).
//
// Rounding: r^2 is formed without FMA from r_i - (r_j + shift), as the
// plain version (lj_cell_forces_n3l_reference) forms it, so both apply
// the cutoff to the same pairs.

#include "lj_warp.cuh"

namespace {

using ljw::add_to;
using ljw::flush;
using ljw::FULL;
using ljw::J4;
using ljw::Reactions;
using ljw::RING;
using ljw::WARPS;

// The pair of i `me` and a staged j if it lies inside the cutoff and j
// is a later slot of the own cell or a slot of a forward cell: its terms
// added to `a` and the force on i returned in (px, py, pz).
template <typename T, bool MACRO>
__device__ __forceinline__ bool half_pair(const J4<T>& me, const J4<T>& j,
                                          const ljk::LJ<T>& lj, ljk::Acc<T>& a,
                                          T& px, T& py, T& pz) {
  const T ddx = me.x - j.x;
  const T ddy = me.y - j.y;
  const T ddz = me.z - j.z;
  const T dr2 = ljk::norm2(ddx, ddy, ddz);
  if (dr2 < lj.rc2 && j.w > me.w) {
    T fac, u6;
    ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, u6);
    px = fac * ddx;
    py = fac * ddy;
    pz = fac * ddz;
    a.fx += px;
    a.fy += py;
    a.fz += pz;
    if (MACRO) {
      a.u6 += u6 + lj.shift6;
      a.vir += fac * dr2;
    }
    return true;
  }
  return false;
}

// A full round by register rotation (ljw::rotate): the lane of rank l in
// its half starts with the half's entry of rank l and a zero reaction,
// meets its i at each step and passes entry and reaction to the lane
// below; every lane of the warp takes part in the shuffles, a lane
// without a valid i only passes them on.  Ends with each entry's
// reaction added to f by the lane that holds it.
template <typename T, bool MACRO, int WAYS>
__device__ __forceinline__ void walk_rotate(const J4<T>* ring,
                                            const Reactions<T>& re, int tail,
                                            bool live, const J4<T>& me,
                                            const ljk::LJ<T>& lj, ljk::Acc<T>& a,
                                            T* f, long long W) {
  constexpr int S = 32 / WAYS;
  const int lane = threadIdx.x & 31, h = lane / S, l = lane & (S - 1);
  J4<T> j = ring[(tail + l * WAYS + h) & (RING - 1)];
  T rx = T(0), ry = T(0), rz = T(0);
  ljw::rotate<T, S>(j, rx, ry, rz, [&](const J4<T>& jj, T& sx, T& sy, T& sz) {
    T px, py, pz;
    if (live && half_pair<T, MACRO>(me, jj, lj, a, px, py, pz)) {
      sx -= px;
      sy -= py;
      sz -= pz;
    }
  });
  const int e = (tail + ((l + S - 1) & (S - 1)) * WAYS + h) & (RING - 1);
  add_to(f + re.o[e], W, rx, ry, rz);
}

// The last, partial round (ljw::walk_skewed), split in two halves or not
template <typename T, bool MACRO>
__device__ __forceinline__ void walk_last(int ways, const J4<T>* ring,
                                          Reactions<T>& re, int tail, int n,
                                          const J4<T>& me, const ljk::LJ<T>& lj,
                                          ljk::Acc<T>& a) {
  const auto pair = [&](const J4<T>& j, int, T& px, T& py, T& pz) {
    return half_pair<T, MACRO>(me, j, lj, a, px, py, pz);
  };
  if (ways == 2)
    ljw::walk_skewed<T, 2>(ring, re, tail, n, pair);
  else
    ljw::walk_skewed<T, 1>(ring, re, tail, n, pair);
}

// Forces on every slot of r[nz, ny, P, nx*cap] into f[nz, ny, 3, nx*cap]
// (zeroed by the caller), each pair of the half shell once.
template <typename T, bool MACRO>
__global__ void __launch_bounds__(WARPS * 32)
    n3l_kernel(const T* __restrict__ r, int P, T* __restrict__ f,
               T* __restrict__ part, ljk::Grid gd, ljk::LocalNbr<T> nbr,
               ljk::LJ<T> lj) {
  __shared__ J4<T> rings[WARPS][RING];
  __shared__ Reactions<T> reacts[WARPS];
  const int lane = threadIdx.x & 31;
  J4<T>* ring = rings[threadIdx.x >> 5];
  Reactions<T>& re = reacts[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  const int nx = gd.nx, ny = gd.ny, nz = gd.nz, cap = gd.cap;
  const long long W = (long long)nx * cap;
  int cx, cy, cz, ch;
  ljk::Acc<T> acc;
  if (ljw::warp_cell<false>(gd, cx, cy, cz, ch)) {  // warp-uniform
    const int s = ch * 32 + lane;
    const T* p = r + ((long long)cz * ny + cy) * P * W + (long long)cx * cap + s;
    const bool vi = p[3 * W] > T(0.5);
    const unsigned vmask = __ballot_sync(FULL, vi);
    const int ni = __popc(vmask);
    const int rank = __popc(vmask & below);
    if (ni > 0) {  // warp-uniform
      const ljw::IChunk<T> c =
          ljw::i_chunk<T, false, 1>(p, W, s, vi, vmask, ni, rank, ring);
      const int smin = ch * 32 + c.first;  // the first valid i slot
      int head = 0, cnt = 0;  // ring write position; staged, not walked
      // m = 9*(dz+1) + 3*(dy+1) + (dx+1): 13 is the own cell, 14..26 the
      // forward half
      for (int m = 13; m < 27; ++m) {
        const int dz = m / 9 - 1, dy = (m / 3) % 3 - 1, dx = m % 3 - 1;
        const ljk::Stage<T> st = nbr(cx, cy, cz, dx, dy, dz);
        const bool self = m == 13;
        // offset in f of the cell's slot 0 (< 2^31, checked by the launch)
        const int ob = (int)(((long long)ljk::wrap(cz + dz, nz) * ny +
                              ljk::wrap(cy + dy, ny)) * 3 * W +
                             (long long)ljk::wrap(cx + dx, nx) * cap);
        for (int js = lane; js < cap; js += 32) {
          const T* pj = st.p + js;
          bool keep = pj[3 * st.stride] > T(0.5) && (!self || js > smin);
          T x = T(0), y = T(0), z = T(0);
          if (keep) {
            x = ljk::add_rn(pj[0], st.shx);
            y = ljk::add_rn(pj[st.stride], st.shy);
            z = ljk::add_rn(pj[2 * st.stride], st.shz);
            keep = c.boxdist2(x, y, z) < lj.rc2;
          }
          const unsigned km = __ballot_sync(FULL, keep);
          if (keep) {
            const int e = (head + __popc(km & below)) & (RING - 1);
            ring[e] = J4<T>{x, y, z, self ? T(js) : T(2 * cap)};
            re.x[e] = T(0);
            re.y[e] = T(0);
            re.z[e] = T(0);
            re.o[e] = ob + js;
          }
          head += __popc(km);
          cnt += __popc(km);
          __syncwarp();
          if (cnt >= 32) {
            if (c.ways == 2)
              walk_rotate<T, MACRO, 2>(ring, re, head - cnt, c.live, c.me, lj,
                                       acc, f, W);
            else
              walk_rotate<T, MACRO, 1>(ring, re, head - cnt, c.live, c.me, lj,
                                       acc, f, W);
            cnt -= 32;
            __syncwarp();
          }
        }
      }
      // the last round, partial
      if (c.live) walk_last<T, MACRO>(c.ways, ring, re, head - cnt, cnt, c.me, lj, acc);
      __syncwarp();
      flush(re, head - cnt, cnt, f, W);
      // the i forces: other warps add reactions to the same slots
      T* o = f + ((long long)cz * ny + cy) * 3 * W + (long long)cx * cap + s;
      const T fx = ljw::to_slot(acc.fx, c.ways, rank, vi);
      const T fy = ljw::to_slot(acc.fy, c.ways, rank, vi);
      const T fz = ljw::to_slot(acc.fz, c.ways, rank, vi);
      add_to(o, W, fx, fy, fz);
    }
  }
  if (MACRO) ljk::block_macro(acc.u6, acc.vir, part, T(1));
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  // the ring keeps j slot offsets in f as int
  if ((long long)nz * ny * 3 * nx * cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const ljk::Grid gd{nx, ny, nz, cap};
  const ljk::LocalNbr<T> nbr{(const T*)r, nx, ny, nz, cap, planes, 0,
                             T(clx), T(cly), T(clz)};
  const ljk::LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)ljw::num_blocks(nx, ny, nz, cap);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (macro) {
    n3l_kernel<T, true><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)r, planes, (T*)f, (T*)part, gd, nbr, lj);
  } else {
    n3l_kernel<T, false><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)r, planes, (T*)f, (T*)part, gd, nbr, lj);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lj_cells_n3l_num_blocks(int nx, int ny, int nz, int cap) {
  return ljw::num_blocks(nx, ny, nz, cap);
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
