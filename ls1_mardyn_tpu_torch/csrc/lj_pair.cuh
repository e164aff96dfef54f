// Device code shared by the LJ-12-6 cell kernels: the pair term, the
// rounding helpers, the neighbour functor of the cell-local layouts
// (LocalNbr) and the per-block reduction of u6 and the virial.  K1
// (lj_cells.cu, also launched as K8), K3 (lj_cells_cw.cu), K4
// (lj_cells_row.cu), K7 (lj_cells_lanej.cu) and K9 (lj_cells_zb.cu) run
// on the warp skeleton of lj_warp.cuh, which culls and compacts the j
// slots (K1 by its half shell); K10 (lj_packed.cu, packed
// pencils) has a kernel of its own built from its pieces.
//
// Rounding: r^2 is rounded exactly as in the plain PyTorch versions (no
// FMA contraction), so kernel and plain version apply the cutoff to the
// same pairs; IEEE division for 1/r^2 (no fast-math build); the rest
// agrees with the plain version to rounding.

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

struct Grid {
  int nx, ny, nz, cap;
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
// (lj_cells.cu and lj_cells_zb.cu with r_j = r_i, lj_cells_cw.cu): x and
// y wrap in the index; z wraps too, or with zhalo the source carries one
// explicit halo row per side and neighbour row dz is row z+dz+1.  The
// shift is the cell offset times the cell edge.  With <= 2 rows on an axis two
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

}  // namespace ljk
