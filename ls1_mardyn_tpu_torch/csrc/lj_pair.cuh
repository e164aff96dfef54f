// Device code shared by the LJ-12-6 cell kernels: the pair term, the
// rounding helpers, the neighbour functor of the cell-local layouts
// (LocalNbr), the per-block reduction of u6 and the virial, and the
// block skeleton (cell decode, the 27-offset loop with its neighbour cell
// staged in shared memory, the pair loop of one i slot, the epilogue)
// with its launch.  A kernel source adds only what is its own: a
// neighbour functor that says where the j slots of the cell at offset
// (dx, dy, dz) lie and which image shift they get, and its extern "C"
// entry points.  The block skeleton carries K4 (lj_cells_row.cu); K1
// (lj_cells.cu) and K3 (lj_cells_cw.cu) run on the warp skeleton of
// lj_warp.cuh, which culls and compacts the j slots; the kernels with a
// traversal of their own (lj_cells_lanej.cu, lj_cells_n3l.cu,
// lj_cells_zb.cu, lj_packed.cu) use the pair term, the rounding helpers
// and the block reduction only.
//
// Every kernel built on the skeleton evaluates pairs from both sides (no
// Newton-3rd-law reaction writes, no atomics): the force on the i slot
// stays in registers and the result is deterministic; u6 and the virial
// are halved per pair, reduced per block into part[block, 2] and summed
// by the caller.
//
// What bounds these kernels on this card: arithmetic.  One cell of cap
// slots meets 27 neighbour cells of cap slots each, so a call evaluates
// 27 * cap^2 * n_cells pair lanes (5.6e9 at the grid (56,60,60), cap 32)
// at ~25 instructions each.  Each staged j slot (16 bytes in f32) feeds
// cap pair lanes, i.e. 0.5 byte of L1/L2 traffic per pair lane at cap
// 32, so the kernels sit far above the memory roof: issue rate and
// occupancy are what limit them.
//
// Design of the block skeleton (the first, plain one; see PERF.md for
// its times, and lj_warp.cuh for what the warp skeleton does instead):
//   * one block holds cpb = 128/cap cells (one cell for cap >= 128),
//     one thread per i slot, so a block is 128..cap threads;
//   * the 27 neighbour cells are visited in turn; each thread stages
//     its own slot of the neighbour cell in shared memory, with the
//     image shift folded into the coordinates once
//     (dr = r_i - (r_j + shift)), then every thread walks the cap
//     staged j slots from shared memory (a broadcast read);
//   * masks: valid_i, valid_j, j != i in the own cell, r^2 < rc^2.  The
//     kernels never rely on a far-away fill of empty slots;
//   * r^2 is rounded exactly as in the plain PyTorch versions (no FMA
//     contraction), so both apply the cutoff to the same pairs; IEEE
//     division for 1/r^2 (no fast-math build); the rest agrees with the
//     plain version to rounding.

#pragma once

#include <cuda_runtime.h>

namespace ljk {

// Round-to-nearest product and sum that the compiler may not contract
// into an FMA: r^2 is formed exactly as the plain PyTorch versions form
// it, ((dx*dx + dy*dy) + dz*dz), and a staged j coordinate is r_j + shift
// rounded once, so kernel and plain version take the same side of the
// cutoff for every pair.  (Unshifted LJ has a force step at rc; one pair
// flipping across it moved max|dF|/max|F| to 2e-4 at N=4.2M in f32.)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// ((x*x + y*y) + z*z), rounded as the plain versions round it
template <typename T>
__device__ __forceinline__ T norm2(T x, T y, T z) {
  return add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
}

// LJ-12-6 term of one pair inside the cutoff: the force factor fac
// (F_i = fac * (r_i - r_j)) and 6*U without shift6.  IEEE division.
template <typename T>
__device__ __forceinline__ void lj_term(T dr2, T eps24, T sig2, T& fac, T& u6) {
  const T inv = T(1) / dr2;
  T lj6 = sig2 * inv;
  lj6 = lj6 * lj6 * lj6;
  fac = eps24 * (lj6 * inv) * (T(2) * lj6 - T(1));
  u6 = eps24 * (lj6 * lj6 - lj6);
}

// sum over the warp into lane 0
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// sum over the warp into every lane
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c mod n for c in [-1, n] and any n >= 1 (a cell index plus an offset
// of -1, 0 or 1): no integer division.  With n <= 2 two offsets reach
// the same row through different periodic images; both count.
__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// Sums of one i slot: force, 6*U (incl. shift6), virial, and the
// per-axis virial f_a * dr_a (VI kernels only).
template <typename T>
struct Acc {
  T fx = T(0), fy = T(0), fz = T(0), u6 = T(0), vir = T(0);
  T vx = T(0), vy = T(0), vz = T(0);
};

// One i slot against the cap staged j slots of one neighbour cell
// (sx/sy/sz carry r_j + image shift, sv the validity).  self_k is the
// j slot to skip (the i slot itself in its own cell), or -1.
// Masks: valid_j, j != i, r^2 < rc^2.  IEEE division for 1/r^2.
template <typename T, bool MACRO, bool VI>
__device__ __forceinline__ void cell_pairs(T xi, T yi, T zi, const T* sx,
                                           const T* sy, const T* sz,
                                           const T* sv, int cap, int self_k,
                                           T eps24, T sig2, T shift6, T rc2,
                                           Acc<T>& a) {
  for (int k = 0; k < cap; ++k) {
    const T ddx = xi - sx[k];
    const T ddy = yi - sy[k];
    const T ddz = zi - sz[k];
    const T dr2 = norm2(ddx, ddy, ddz);
    const bool m = (sv[k] > T(0.5)) && (dr2 < rc2) && (k != self_k);
    if (m) {
      T fac, u6;
      lj_term(dr2, eps24, sig2, fac, u6);
      const T px = fac * ddx, py = fac * ddy, pz = fac * ddz;
      a.fx += px;
      a.fy += py;
      a.fz += pz;
      if (VI) {
        a.vx += px * ddx;
        a.vy += py * ddy;
        a.vz += pz * ddz;
      }
      if (MACRO) {
        a.u6 += u6 + shift6;
        a.vir += fac * dr2;
      }
    }
  }
}

// part[2*block] = sum over the block of scale*u6, part[2*block+1]
// likewise for the virial: scale 0.5 where each ordered pair was seen
// from both sides, 1 where each pair was evaluated once.  The block is
// blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z).  Every
// thread of the block must call it.
template <typename T>
__device__ __forceinline__ void block_macro(T u6, T vir, T* __restrict__ part,
                                            T scale = T(0.5)) {
  __shared__ T red[2][32];
  const int t = threadIdx.x;
  T a = warp_sum(scale * u6);
  T b = warp_sum(scale * vir);
  const int lane = t & 31, w = t >> 5, nw = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    red[0][w] = a;
    red[1][w] = b;
  }
  __syncthreads();
  if (t < 32) {
    a = t < nw ? red[0][t] : T(0);
    b = t < nw ? red[1][t] : T(0);
    a = warp_sum(a);
    b = warp_sum(b);
    if (t == 0) {
      const long long blk =
          blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
      part[2 * blk] = a;
      part[2 * blk + 1] = b;
    }
  }
}

// cells per block: 128 threads for cap <= 128, else one cell
__host__ __device__ inline int cells_per_block(int cap) {
  return cap >= 128 ? 1 : 128 / cap;
}

// Number of blocks of a launch (rows of the part[., 2] buffer).
inline int num_blocks(int nx, int ny, int nz, int cap) {
  const int cpb = cells_per_block(cap);
  const long long ncells = (long long)nx * ny * nz;
  return (int)((ncells + cpb - 1) / cpb);
}

struct Grid {
  int nx, ny, nz, cap, cpb;
};

template <typename T>
struct LJ {
  T eps24, sig2, shift6, rc2;
};

// What a neighbour functor returns for the cell at offset (dx, dy, dz)
// of cell (cx, cy, cz): the address of its slot 0 in plane x, the stride
// between the planes x, y, z, valid, and the image shift of its slots.
template <typename T>
struct Stage {
  const T* p;
  long long stride;
  T shx, shy, shz;
};

// The neighbour cells of the cell-local layouts r_j[nzj, ny, pj, nx*cap]
// (lj_cells.cu with r_j = r_i, lj_cells_cw.cu): x and y wrap in the
// index; z wraps too, or with zhalo the source carries one explicit halo
// row per side and neighbour row dz is row z+dz+1.  The shift is the
// cell offset times the cell edge.  With <= 2 rows on an axis two
// offsets reach the same row through different periodic images, and
// both count.
template <typename T>
struct LocalNbr {
  const T* rj;
  int nx, ny, nz, cap, pj, zhalo;
  T clx, cly, clz;
  __device__ __forceinline__ Stage<T> operator()(int cx, int cy, int cz, int dx,
                                                 int dy, int dz) const {
    const long long W = (long long)nx * cap;
    const int jx = wrap(cx + dx, nx);
    const int jy = wrap(cy + dy, ny);
    const int jz = zhalo ? cz + dz + 1 : wrap(cz + dz, nz);
    return {rj + ((long long)jz * ny + jy) * pj * W + (long long)jx * cap, W,
            T(dx) * clx, T(dy) * cly, T(dz) * clz};
  }
};

// Forces on every slot of r_i[nz, ny, pi, nx*cap] (planes x, y, z, valid;
// pi >= 4 is the plane count of the parent tensor) into f[nz, ny, 3 or 6,
// nx*cap]; with VI planes 3..5 hold 0.5 * sum_j f_a * dr_a.
template <typename T, bool MACRO, bool VI, typename Nbr>
__global__ void cell_forces_kernel(const T* __restrict__ ri, int pi,
                                   T* __restrict__ f, T* __restrict__ part,
                                   Grid gd, Nbr nbr, LJ<T> lj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sj = reinterpret_cast<T*>(smem_raw);  // [cpb][4][cap]

  const int nx = gd.nx, ny = gd.ny, cap = gd.cap;
  const int t = threadIdx.x;
  const int g = t / cap;
  const int s = t - g * cap;
  const long long ncells = (long long)nx * ny * gd.nz;
  const long long cell = (long long)blockIdx.x * gd.cpb + g;
  const bool active = cell < ncells;
  const long long W = (long long)nx * cap;
  int cx = 0, cy = 0, cz = 0;
  T xi = T(0), yi = T(0), zi = T(0);
  bool vi = false;
  if (active) {
    cx = (int)(cell % nx);
    const long long q = cell / nx;
    cy = (int)(q % ny);
    cz = (int)(q / ny);
    const T* p = ri + ((long long)cz * ny + cy) * pi * W + (long long)cx * cap + s;
    xi = p[0];
    yi = p[W];
    zi = p[2 * W];
    vi = p[3 * W] > T(0.5);
  }
  T* sx = sj + (long long)g * 4 * cap;
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sv = sz + cap;

  Acc<T> acc;
  for (int dz = -1; dz <= 1; ++dz) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (active) {
          const Stage<T> st = nbr(cx, cy, cz, dx, dy, dz);
          const T* p = st.p + s;
          sx[s] = add_rn(p[0], st.shx);
          sy[s] = add_rn(p[st.stride], st.shy);
          sz[s] = add_rn(p[2 * st.stride], st.shz);
          sv[s] = p[3 * st.stride];
        }
        __syncthreads();
        if (active && vi) {
          const bool self = (dx == 0) && (dy == 0) && (dz == 0);
          cell_pairs<T, MACRO, VI>(xi, yi, zi, sx, sy, sz, sv, cap,
                                   self ? s : -1, lj.eps24, lj.sig2, lj.shift6,
                                   lj.rc2, acc);
        }
        __syncthreads();
      }
    }
  }
  if (active) {
    const int po = VI ? 6 : 3;
    T* fo = f + ((long long)cz * ny + cy) * po * W + (long long)cx * cap + s;
    fo[0] = acc.fx;
    fo[W] = acc.fy;
    fo[2 * W] = acc.fz;
    if (VI) {
      fo[3 * W] = T(0.5) * acc.vx;
      fo[4 * W] = T(0.5) * acc.vy;
      fo[5 * W] = T(0.5) * acc.vz;
    }
  }
  if (MACRO) block_macro(acc.u6, acc.vir, part);
}

// Launch on `stream`; returns the cudaError_t of the launch.  HAS_VI
// says whether the kernel source offers the per-slot virial planes.
template <typename T, bool HAS_VI, typename Nbr>
int launch_cells(const void* ri, int pi, void* f, void* part, int nx, int ny,
                 int nz, int cap, Nbr nbr, double eps24, double sig2,
                 double shift6, double rc2, int macro, int vi, void* stream) {
  const Grid gd{nx, ny, nz, cap, cells_per_block(cap)};
  const LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)num_blocks(nx, ny, nz, cap);
  const int threads = gd.cpb * cap;
  const size_t smem = (size_t)gd.cpb * 4 * cap * sizeof(T);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LJK_LAUNCH(M, V)                                             \
  cell_forces_kernel<T, M, V, Nbr><<<blocks, threads, smem, st>>>(   \
      (const T*)ri, pi, (T*)f, (T*)part, gd, nbr, lj)
  if constexpr (HAS_VI) {
    if (vi) {
      if (macro) {
        LJK_LAUNCH(true, true);
      } else {
        LJK_LAUNCH(false, true);
      }
      return (int)cudaGetLastError();
    }
  }
  if (macro) {
    LJK_LAUNCH(true, false);
  } else {
    LJK_LAUNCH(false, false);
  }
#undef LJK_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace ljk
