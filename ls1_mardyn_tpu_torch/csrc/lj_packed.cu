// LJ-12-6 forces on occupancy-packed pencils, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_packed.py:
// lj_forces_packed (body _cwp_kernel).  Same contract: each (z, y) pencil
// (one x row of cells) stores its molecules contiguously in x-cell order,
// pos4[nz, ny, 4, Wp] = (x, y, z cell-local, cx = x-cell index as a
// float), cnt = meta[z, y, 0, 3] of them; tab[z, y, t, 0] is group t's
// base cell cb and meta[z, y, 0, 0..2] = (ng, e_lo, e_hi) the group count
// and the numbers of groups whose cell range sticks out of [0, nx) at
// the low and at the high end.  Output f[nz, ny, 3, Wp] in packed order
// (zeroed by the caller) and u6 (6*U incl. shift6) and the virial, each
// pair counted ONCE.
//
// Pairs (the TPU kernel's): groups of 32 packed i molecules over the 5
// Newton-3rd-law forward pencils (dz, dy) = (0,0) (0,1) (1,-1) (1,0)
// (1,1).  A group whose cells are [cf, cl] meets the j molecules of cells
// [cf-1, cl+1] (clipped to the pencil) of each forward pencil; in the own
// pencil a pair counts once, when j's lane is above i's.  The periodic x
// wrap is a second and a third pass for the edge groups: the first e_lo
// groups meet cell nx-1 one box length to the left (cbj = cb + nx), the
// last e_hi groups cells [0, cl+1-nx] one box length to the right (cbj =
// cb - nx); a group that wraps at both ends (small nx) takes both.
// Own-pencil pairs across the wrap are taken by the low-wrap pass only
// (in the high one j's lane is below i's).  Both sides are recentred on
// the group's base cell, x'' = x + (cx - cb) * clx (j: cbj), so no
// operand is an absolute coordinate, and the pencil shift goes to the i
// side: dy = (y_i - dy*cly) - y_j, dz likewise, r^2 without FMA, all as
// the plain version (ops/cuda_packed.py) and the JAX kernel form them,
// so every pair takes the same side of the cutoff in all three.  The 8
// phase-shifted j copies and 128-lane windows of the TPU kernel (PH, WIN,
// the woff columns of tab) are Mosaic alignment rules: each group finds
// its exact j lane ranges by binary searches of the forward pencils' cx
// planes, lanes 0..29 of the warp searching at once, so every state
// build_tables describes is computed whole, `feasible` or not.
//
// Design, on the pieces of lj_warp.cuh (K8's half shell): one warp a
// group, one lane an i (every lane of a group but a pencil's last holds
// one, so there is no i compaction and no half-warp split).
//   * box cull while staging: the warp forms the bounding box of its
//     live, recentred i; for each (pass, pencil) each lane loads one j
//     lane of the range, recentres it once and keeps it if boxdist2 < rc^2
//     against the box with the pencil's shift applied to its y and z
//     bounds.  Exact: the shifted bounds are rounded as the shifted i
//     coordinates are (rounding is monotone), and boxdist2 is rounded as
//     r^2 (the argument of lj_warp.cuh).  Kept lanes go to the warp's
//     64-entry ring (ballot + popc) with their offset in f and their
//     pencil's shift;
//   * the half shell in one compare: an own-pencil entry carries its lane
//     in w, a forward one Wp (above every lane); the pair counts when j.w
//     > i.w, and a lane past the count holds an i with w = Wp, which
//     meets no entry.  Own-pencil lanes at or below the group's first
//     lane are culled while staging;
//   * reactions by register rotation for each full round of 32 entries
//     (ljw::rotate): each lane holds one entry fixed, with its shift and
//     its reaction sums in registers, and the i rotate past it with their
//     force sums, 7 shuffles a step as K8.  K8 rotates the entries past
//     fixed i; here the i side carries the entry's pencil shift, which the
//     fixed lane applies to each passing i (two subtractions a step), so
//     the ring may mix pencils.  After the round the lane adds its
//     entry's reaction to f with one global atomic per axis, skipping
//     exact zeros.  The i and their sums keep rotating across rounds (a
//     round leaves each one lane lower); at the end one shuffle takes each
//     i's sums home and they go to f by atomics, since other groups'
//     reactions land on the same lanes;
//   * the last, partial round is walked skewed with shared atomics on the
//     entries' sums, then flushed (ljw::walk_skewed, ljw::flush);
//   * u6 and the virial: each pair once, block_macro at scale 1.
// The atomics make the order of the sums, and so the last bits of f, vary
// from run to run: f agrees with the plain version to rounding.
//
// What bounds it (H100, PERF.md): the walk, as K8's.  On the main state a
// group of 31.6 live i keeps 238.7 of the 430.7 j lanes of its ranges:
// 3.17e7 j iterations in 2.11 ms, 0.82x K8's time an iteration (every
// lane of a rotation holds an i; K8's warps hold 20.8 valid of 32).

#include "lj_warp.cuh"

namespace {

using ljk::add_rn;
using ljk::LJ;
using ljk::mul_rn;
using ljk::sub_rn;
using ljw::add_to;
using ljw::flush;
using ljw::FULL;
using ljw::J4;
using ljw::Reactions;
using ljw::RING;
using ljw::WARPS;

constexpr int GSZ = 32;    // molecules per group = lanes per warp
constexpr int NT = 16;     // tab ints per group
constexpr int NMETA = 8;   // meta ints per pencil

struct Pencils {
  int nx, ny, nz, Wp, gmax;
};

// Per warp, beside the ring: the i-side shift (dy*cly, dz*clz) of each
// entry's pencil.
template <typename T>
struct Shifts {
  T y[RING], z[RING];
};

// the forward pencil k: (dz, dy) of POFFS
__device__ __forceinline__ void pencil(int k, int& dz, int& dy) {
  dz = k < 2 ? 0 : 1;
  dy = k == 0 ? 0 : (k == 1 ? 1 : k - 3);
}

// first packed lane of pencil `cxp` (cnt live lanes) whose cell is >= c
template <typename T>
__device__ __forceinline__ int lower_bound(const T* __restrict__ cxp, int cnt,
                                           int c) {
  int lo = 0, hi = cnt;
  const T cf = T(c);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cxp[mid] < cf) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// i `me` shifted to an entry's pencil
template <typename T>
__device__ __forceinline__ J4<T> shifted(const J4<T>& me, T sy, T sz) {
  return J4<T>{me.x, sub_rn(me.y, sy), sub_rn(me.z, sz), me.w};
}

// The pair of i `me` (shifted to j's pencil) and a staged j if it lies
// inside the cutoff and j is a later lane of the own pencil or a lane of
// a forward one: u6 and the virial added to `a`, the force on i returned
// in (px, py, pz).
template <typename T, bool MACRO>
__device__ __forceinline__ bool packed_pair(const J4<T>& me, const J4<T>& j,
                                            const LJ<T>& lj, ljk::Acc<T>& a,
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
    if (MACRO) {
      a.u6 += u6 + lj.shift6;
      a.vir += fac * dr2;
    }
    return true;
  }
  return false;
}

template <typename T, bool MACRO>
__global__ void __launch_bounds__(WARPS * 32)
    packed_kernel(const T* __restrict__ pos, const int* __restrict__ tab,
                  const int* __restrict__ meta, T* __restrict__ f,
                  T* __restrict__ part, Pencils pc, T clx, T cly, T clz,
                  LJ<T> lj) {
  __shared__ J4<T> rings[WARPS][RING];
  __shared__ Reactions<T> reacts[WARPS];
  __shared__ Shifts<T> shifts[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  J4<T>* ring = rings[w];
  Reactions<T>& re = reacts[w];
  Shifts<T>& sh = shifts[w];
  const unsigned below = (1u << lane) - 1u;
  const int nx = pc.nx, ny = pc.ny, nz = pc.nz;
  const long long Wp = pc.Wp;
  const int pen = blockIdx.y;
  const int z = pen / ny, y = pen - z * ny;
  const int t = blockIdx.x * WARPS + w;
  const int* mt = meta + (long long)pen * NMETA;
  const int ng = mt[0], e_lo = mt[1], e_hi = mt[2], cnt = mt[3];
  ljk::Acc<T> acc;
  if (t < ng) {  // warp-uniform
    const T* pp = pos + (long long)pen * 4 * Wp;
    const int q0 = t * GSZ, q = q0 + lane;
    const bool live = q < cnt;
    const int cb = tab[((long long)pen * pc.gmax + t) * NT];
    const int cf = (int)pp[3 * Wp + q0];
    const int cl = (int)pp[3 * Wp + min(q0 + GSZ, cnt) - 1];
    // this lane's i, recentred on cb; past the count w = Wp: no pair
    J4<T> me{T(0), T(0), T(0), T(pc.Wp)};
    if (live)
      me = J4<T>{add_rn(pp[q], mul_rn(pp[3 * Wp + q] - T(cb), clx)), pp[Wp + q],
                 pp[2 * Wp + q], T(q)};
    // the bounding box of the live i (a lane past the count stands in
    // with lane 0)
    const T x0 = __shfl_sync(FULL, me.x, 0);
    const T y0 = __shfl_sync(FULL, me.y, 0);
    const T z0 = __shfl_sync(FULL, me.z, 0);
    const T lox = ljw::warp_min(live ? me.x : x0);
    const T hix = ljw::warp_max(live ? me.x : x0);
    const T loy = ljw::warp_min(live ? me.y : y0);
    const T hiy = ljw::warp_max(live ? me.y : y0);
    const T loz = ljw::warp_min(live ? me.z : z0);
    const T hiz = ljw::warp_max(live ? me.z : z0);
    const bool wlo = t < e_lo, whi = t >= ng - e_hi;
    // the exact j lane ranges, searched at once: lane 10*pass + 2*k (+1)
    // finds the first (end) lane of pass `pass` in forward pencil k
    int bound = 0;
    if (lane < 30) {
      const int pass = lane / 10;
      if (pass == 0 || (pass == 1 && wlo) || (pass == 2 && whi)) {
        int dz, dy;
        pencil((lane % 10) >> 1, dz, dy);
        const int jz = z + dz == nz ? 0 : z + dz;
        const int jy = y + dy == ny ? 0 : (y + dy < 0 ? ny - 1 : y + dy);
        const int pk = jz * ny + jy;
        // cells [ca, ce] of the pass
        const int ca = pass == 0 ? max(cf - 1, 0) : (pass == 1 ? nx - 1 : 0);
        const int ce = pass == 0 ? min(cl + 1, nx - 1)
                                 : (pass == 1 ? nx - 1 : cl + 1 - nx);
        bound = lower_bound(pos + ((long long)pk * 4 + 3) * Wp,
                            meta[(long long)pk * NMETA + 3],
                            (lane & 1) ? ce + 1 : ca);
      }
    }
    T fx = T(0), fy = T(0), fz = T(0);  // forces on the i this lane holds
    int head = 0, nst = 0, rounds = 0;   // ring write position; staged, not walked
    // pass 0: the main ranges; 1: the low wrap; 2: the high wrap
    for (int pass = 0; pass < 3; ++pass) {
      if ((pass == 1 && !wlo) || (pass == 2 && !whi)) continue;
      const int cbj = pass == 0 ? cb : (pass == 1 ? cb + nx : cb - nx);
      for (int k = 0; k < 5; ++k) {
        int dz, dy;
        pencil(k, dz, dy);
        const int jz = z + dz == nz ? 0 : z + dz;
        const int jy = y + dy == ny ? 0 : (y + dy < 0 ? ny - 1 : y + dy);
        const int pk = jz * ny + jy;
        const T* pj = pos + (long long)pk * 4 * Wp;
        // offset in f of the pencil's lane 0 (< 2^31, checked by the launch)
        const int ob = pk * 3 * pc.Wp;
        int j0 = __shfl_sync(FULL, bound, 10 * pass + 2 * k);
        const int j1 = __shfl_sync(FULL, bound, 10 * pass + 2 * k + 1);
        if (k == 0) j0 = max(j0, q0 + 1);  // own pencil: above the first i
        const T sy = T(dy) * cly, sz = T(dz) * clz;
        const T ly = sub_rn(loy, sy), hy = sub_rn(hiy, sy);
        const T lz = sub_rn(loz, sz), hz = sub_rn(hiz, sz);
        for (int jb = j0; jb < j1; jb += 32) {  // warp-uniform
          const int jl = jb + lane;
          bool keep = jl < j1;
          T x = T(0), yj = T(0), zj = T(0);
          if (keep) {
            x = add_rn(pj[jl], mul_rn(pj[3 * Wp + jl] - T(cbj), clx));
            yj = pj[Wp + jl];
            zj = pj[2 * Wp + jl];
            keep = ljk::norm2(ljw::gap(x, lox, hix), ljw::gap(yj, ly, hy),
                              ljw::gap(zj, lz, hz)) < lj.rc2;
          }
          const unsigned km = __ballot_sync(FULL, keep);
          if (keep) {
            const int e = (head + __popc(km & below)) & (RING - 1);
            ring[e] = J4<T>{x, yj, zj, k == 0 ? T(jl) : T(pc.Wp)};
            re.o[e] = ob + jl;
            sh.y[e] = sy;
            sh.z[e] = sz;
          }
          head += __popc(km);
          nst += __popc(km);
          __syncwarp();
          if (nst >= 32) {
            // a full round: the entry of this lane fixed, the i rotating
            const int e = (head - nst + lane) & (RING - 1);
            const J4<T> j = ring[e];
            const T ey = sh.y[e], ez = sh.z[e];
            T rx = T(0), ry = T(0), rz = T(0);
            ljw::rotate<T, 32>(me, fx, fy, fz,
                               [&](const J4<T>& i, T& sx, T& sy_, T& sz_) {
                                 T px, py, pz;
                                 if (packed_pair<T, MACRO>(shifted(i, ey, ez), j,
                                                           lj, acc, px, py, pz)) {
                                   sx += px;
                                   sy_ += py;
                                   sz_ += pz;
                                   rx -= px;
                                   ry -= py;
                                   rz -= pz;
                                 }
                               });
            add_to(f + re.o[e], Wp, rx, ry, rz);
            nst -= 32;
            ++rounds;
            __syncwarp();
          }
        }
      }
    }
    // the last round, partial
    const int tail = head - nst;
    if (lane < nst) {
      const int e = (tail + lane) & (RING - 1);
      re.x[e] = T(0);
      re.y[e] = T(0);
      re.z[e] = T(0);
    }
    __syncwarp();
    ljw::walk_skewed<T, 1>(ring, re, tail, nst,
                           [&](const J4<T>& j, int e, T& px, T& py, T& pz) {
                             if (packed_pair<T, MACRO>(shifted(me, sh.y[e], sh.z[e]),
                                                       j, lj, acc, px, py, pz)) {
                               fx += px;
                               fy += py;
                               fz += pz;
                               return true;
                             }
                             return false;
                           });
    __syncwarp();
    flush(re, tail, nst, f, Wp);
    // the i forces: this lane's i is held by lane + rounds
    const int src = (lane + rounds) & 31;
    fx = __shfl_sync(FULL, fx, src);
    fy = __shfl_sync(FULL, fy, src);
    fz = __shfl_sync(FULL, fz, src);
    if (live) add_to(f + (long long)pen * 3 * Wp + q, Wp, fx, fy, fz);
  }
  if (MACRO) ljk::block_macro(acc.u6, acc.vir, part, T(1));
}

template <typename T>
int launch(const void* pos, const void* tab, const void* meta, void* f,
           void* part, int nx, int ny, int nz, int Wp, int gmax, double clx,
           double cly, double clz, double eps24, double sig2, double shift6,
           double rc2, int macro, void* stream) {
  // the ring keeps j lane offsets in f as int
  if ((long long)nz * ny * 3 * Wp >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Pencils pc{nx, ny, nz, Wp, gmax};
  const LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const dim3 grid((unsigned)((gmax + WARPS - 1) / WARPS), (unsigned)(nz * ny));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (macro) {
    packed_kernel<T, true><<<grid, WARPS * 32, 0, st>>>(
        (const T*)pos, (const int*)tab, (const int*)meta, (T*)f, (T*)part, pc,
        T(clx), T(cly), T(clz), lj);
  } else {
    packed_kernel<T, false><<<grid, WARPS * 32, 0, st>>>(
        (const T*)pos, (const int*)tab, (const int*)meta, (T*)f, (T*)part, pc,
        T(clx), T(cly), T(clz), lj);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lj_packed_num_blocks(int nz, int ny, int gmax) {
  return ((gmax + WARPS - 1) / WARPS) * nz * ny;
}

int lj_packed_f32(const void* pos, const void* tab, const void* meta, void* f,
                  void* part, int nx, int ny, int nz, int Wp, int gmax,
                  double clx, double cly, double clz, double eps24, double sig2,
                  double shift6, double rc2, int macro, void* stream) {
  return launch<float>(pos, tab, meta, f, part, nx, ny, nz, Wp, gmax, clx, cly,
                       clz, eps24, sig2, shift6, rc2, macro, stream);
}

int lj_packed_f64(const void* pos, const void* tab, const void* meta, void* f,
                  void* part, int nx, int ny, int nz, int Wp, int gmax,
                  double clx, double cly, double clz, double eps24, double sig2,
                  double shift6, double rc2, int macro, void* stream) {
  return launch<double>(pos, tab, meta, f, part, nx, ny, nz, Wp, gmax, clx, cly,
                        clz, eps24, sig2, shift6, rc2, macro, stream);
}

}  // extern "C"
