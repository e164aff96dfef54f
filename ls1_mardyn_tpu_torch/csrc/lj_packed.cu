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
// and u6 (6*U incl. shift6) and the virial, each pair counted ONCE.
//
// Traversal (the TPU kernel's): groups of 32 packed i molecules, here one
// warp a group and one lane a molecule, over the 5 Newton-3rd-law forward
// pencils (dz, dy) = (0,0) (0,1) (1,-1) (1,0) (1,1).  In the own pencil a
// pair counts once by packed-lane order (j > i).  A group whose cells are
// [cf, cl] meets the j molecules of cells [cf-1, cl+1] (clipped to the
// pencil) of each forward pencil; the reaction -F_ij goes to the j lane.
// The periodic x wrap is a second pass for the edge groups: the first
// e_lo groups meet cell nx-1 one box length to the left, the last e_hi
// groups cell 0 one box length to the right.  Both sides are recentred on
// the group's base cell, x'' = x + (cx - cb) * clx, so no operand is an
// absolute coordinate.
//
// What the port does not carry over: the 8 phase-shifted j copies and the
// 128-lane aligned windows (PH, WIN, the woff columns of tab) are Mosaic
// alignment workarounds.  Each group finds its exact j lane range by a
// binary search of the forward pencil's cx plane, so the 128-lane window
// limit behind build_tables' `feasible` does not bind this kernel: every
// state it is given is computed whole.  A group that wraps at both ends
// (nx small against the group) takes both wrap passes.
//
// Reactions: a warp stages 32 j molecules at a time in shared memory,
// lane l walks them from slot l on (a skewed order, so the shared
// atomics of one step hit 32 different slots), then one global
// atomicAdd per j lane and axis (f64 atomics are native on sm_90).  The
// i forces go out by atomicAdd too, since other groups' reactions land
// on the same lanes; the wrapper zeroes f.  The order of the sums
// changes from run to run: agreement with the plain version is to
// rounding.
//
// What bounds it: arithmetic, with the i-side empty-slot tax of the dense
// kernels gone (every lane of a group but the last is a molecule) and
// the j side cut to the occupied lanes of the cell range.
//
// Rounding: x'' = x + (cx - cb)*clx, dy = (y_i - dy*cly) - y_j, r^2 without
// FMA, all as the plain version (ops/cuda_packed.py) forms them, so both
// take the same side of the cutoff for every pair.

#include "lj_pair.cuh"

namespace {

using ljk::add_rn;
using ljk::mul_rn;
using ljk::LJ;

constexpr int GSZ = 32;       // molecules per group = lanes per warp
constexpr int WARPS = 4;      // groups per block
constexpr int NT = 16;        // tab ints per group
constexpr int NMETA = 8;      // meta ints per pencil

struct Pencils {
  int nx, ny, nz, Wp, gmax;
};

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

template <typename T, bool MACRO>
__global__ void packed_kernel(const T* __restrict__ pos, const int* __restrict__ tab,
                              const int* __restrict__ meta, T* __restrict__ f,
                              T* __restrict__ part, Pencils pc, T clx, T cly,
                              T clz, LJ<T> lj) {
  __shared__ T sj[WARPS][3][GSZ];  // staged j: recentred x, y, z
  __shared__ T rf[WARPS][3][GSZ];  // reactions on the staged j
  const int nx = pc.nx, ny = pc.ny, nz = pc.nz;
  const long long Wp = pc.Wp;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pen = blockIdx.y;
  const int z = pen / ny, y = pen - z * ny;
  const int t = blockIdx.x * WARPS + w;
  const int* mt = meta + (long long)pen * NMETA;
  const int ng = mt[0], e_lo = mt[1], e_hi = mt[2], cnt = mt[3];
  const bool active = t < ng;  // warp-uniform

  T u6 = T(0), vir = T(0);
  if (active) {
    const T* pp = pos + (long long)pen * 4 * Wp;
    const int q = t * GSZ + lane;
    const bool live = q < cnt;
    const T xg = live ? pp[q] : T(0);
    const T yg = live ? pp[Wp + q] : T(0);
    const T zg = live ? pp[2 * Wp + q] : T(0);
    const T cxg = live ? pp[3 * Wp + q] : T(0);
    const int cb = tab[((long long)pen * pc.gmax + t) * NT];
    const int cf = (int)pp[3 * Wp + t * GSZ];
    const int cl = (int)pp[3 * Wp + min(t * GSZ + GSZ - 1, cnt - 1)];
    const T xi = add_rn(xg, mul_rn(cxg - T(cb), clx));
    T fx = T(0), fy = T(0), fz = T(0);
    // pass 0: the main ranges; 1: the low wrap; 2: the high wrap
    for (int pass = 0; pass < 3; ++pass) {
      if (pass == 1 && t >= e_lo) continue;
      if (pass == 2 && t < ng - e_hi) continue;
      const int cbj = pass == 0 ? cb : (pass == 1 ? cb + nx : cb - nx);
      for (int k = 0; k < 5; ++k) {
        const int dz = k < 2 ? 0 : 1;
        const int dy = k == 0 ? 0 : (k == 1 ? 1 : k - 3);
        const int jz = z + dz == nz ? 0 : z + dz;
        const int jy = y + dy == ny ? 0 : (y + dy < 0 ? ny - 1 : y + dy);
        const int pk = jz * ny + jy;
        const int cntk = meta[(long long)pk * NMETA + 3];
        const T* pj = pos + (long long)pk * 4 * Wp;
        int ca, ce;  // cells [ca, ce]
        if (pass == 0) {
          ca = max(cf - 1, 0);
          ce = min(cl + 1, nx - 1);
        } else if (pass == 1) {
          ca = ce = nx - 1;
        } else {
          ca = 0;
          ce = cl + 1 - nx;
        }
        int j0 = 0, j1 = 0;
        if (lane == 0) {
          j0 = lower_bound(pj + 3 * Wp, cntk, ca);
          j1 = lower_bound(pj + 3 * Wp, cntk, ce + 1);
        }
        j0 = __shfl_sync(0xffffffffu, j0, 0);
        j1 = __shfl_sync(0xffffffffu, j1, 0);
        const T ygs = yg - T(dy) * cly;
        const T zgs = zg - T(dz) * clz;
        for (int jb = j0; jb < j1; jb += GSZ) {
          const int jl = jb + lane;
          if (jl < j1) {
            sj[w][0][lane] = add_rn(pj[jl], mul_rn(pj[3 * Wp + jl] - T(cbj), clx));
            sj[w][1][lane] = pj[Wp + jl];
            sj[w][2][lane] = pj[2 * Wp + jl];
          }
          rf[w][0][lane] = T(0);
          rf[w][1][lane] = T(0);
          rf[w][2][lane] = T(0);
          __syncwarp();
          const int n = min(GSZ, j1 - jb);
          if (live) {
            for (int kk = 0; kk < GSZ; ++kk) {
              const int s = (lane + kk) & (GSZ - 1);
              if (s >= n) continue;
              if (k == 0 && jb + s <= q) continue;
              const T ddx = xi - sj[w][0][s];
              const T ddy = ygs - sj[w][1][s];
              const T ddz = zgs - sj[w][2][s];
              const T dr2 = ljk::norm2(ddx, ddy, ddz);
              if (dr2 < lj.rc2) {
                T fac, e;
                ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, e);
                const T px = fac * ddx, py = fac * ddy, pz = fac * ddz;
                fx += px;
                fy += py;
                fz += pz;
                atomicAdd(&rf[w][0][s], -px);
                atomicAdd(&rf[w][1][s], -py);
                atomicAdd(&rf[w][2][s], -pz);
                if (MACRO) {
                  u6 += e + lj.shift6;
                  vir += fac * dr2;
                }
              }
            }
          }
          __syncwarp();
          if (jl < j1) {
            T* o = f + (long long)pk * 3 * Wp + jl;
            atomicAdd(o, rf[w][0][lane]);
            atomicAdd(o + Wp, rf[w][1][lane]);
            atomicAdd(o + 2 * Wp, rf[w][2][lane]);
          }
          __syncwarp();
        }
      }
    }
    if (live) {
      T* o = f + (long long)pen * 3 * Wp + q;
      atomicAdd(o, fx);
      atomicAdd(o + Wp, fy);
      atomicAdd(o + 2 * Wp, fz);
    }
  }
  if (MACRO) ljk::block_macro(u6, vir, part, T(1));
}

template <typename T>
int launch(const void* pos, const void* tab, const void* meta, void* f,
           void* part, int nx, int ny, int nz, int Wp, int gmax, double clx,
           double cly, double clz, double eps24, double sig2, double shift6,
           double rc2, int macro, void* stream) {
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
