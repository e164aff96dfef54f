// LJ-12-6 cell forces on the dense RMM cell layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_cwn3l (body _lj_cwn3l_kernel).  Same contract:
// forces on every slot of the cell-local layout r[nz, ny, P, nx*cap]
// (planes x, y, z, valid; P >= 4 is the plane count of the parent
// tensor, so the RMM state's 8-plane tensor is read in place), plus the
// LJ energy sum u6 (6*U incl. shift6) and the virial sum over pairs.
//
// What bounds it on this card: arithmetic.  One cell of cap slots
// meets 27 neighbour cells of cap slots each, so a call evaluates
// 27 * cap^2 * n_cells pair lanes (5.6e9 at the production grid
// (56,60,60), cap 32) at ~25 instructions each.  Each staged j slot
// (16 bytes in f32) feeds cap pair lanes, i.e. 0.5 byte of L1/L2
// traffic per pair lane at cap 32, so the kernel sits far above the
// memory roof: issue rate and occupancy are what limit it.
//
// Design (the first, plain one; see PERF.md for its time):
//   * one block holds cpb = 128/cap cells (one cell for cap >= 128),
//     one thread per i slot, so a block is 128..cap threads;
//   * the 27 neighbour cells are visited in turn; each thread stages
//     its own slot of the neighbour cell in shared memory, with the
//     periodic cell offset off*cell_len folded into the coordinates
//     once (dr = r_i - (r_j + off*cl)), then every thread walks the
//     cap staged j slots from shared memory (a broadcast read);
//   * pairs are evaluated from both sides (no Newton-3rd-law
//     reaction writes, no atomics): the i force stays in registers and
//     the result is deterministic; u6 and the virial are halved per
//     pair, reduced per block into part[block, 2] and summed by the
//     caller;
//   * masks: valid_i, valid_j, j != i in the own cell, r^2 < rc^2.
//     Empty slots also carry the y sentinel of the JAX layout, but the
//     validity mask makes the kernel correct with or without it;
//   * r^2 is rounded exactly as in the plain PyTorch version (no FMA
//     contraction), so both apply the cutoff to the same pairs; IEEE
//     division for 1/r^2 (no fast-math build); the rest agrees with the
//     plain version to rounding.
// The TPU kernel's halo-padded j view, phase-stacked j copies and the
// plane-3 scalar packing are layout tricks of the TPU and are not
// reproduced.

#include <cuda_runtime.h>

namespace {

// Round-to-nearest product and sum that the compiler may not contract
// into an FMA: r^2 is formed exactly as the plain PyTorch version forms
// it, ((dx*dx + dy*dy) + dz*dz), so both take the same side of the
// cutoff for every pair.  (Unshifted LJ has a force step at rc; one pair
// flipping across it moved max|dF|/max|F| to 2e-4 at N=4.2M in f32.)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

template <typename T, bool MACRO>
__global__ void lj_cells_kernel(const T* __restrict__ r, T* __restrict__ f,
                                T* __restrict__ part, int nx, int ny, int nz,
                                int cap, int cpb, int planes, T clx, T cly,
                                T clz, T eps24, T sig2, T shift6, T rc2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sj = reinterpret_cast<T*>(smem_raw);  // [cpb][4][cap]
  __shared__ T red[2][32];

  const int t = threadIdx.x;
  const int g = t / cap;
  const int s = t - g * cap;
  const long long ncells = (long long)nx * ny * nz;
  const long long cell = (long long)blockIdx.x * cpb + g;
  const bool active = cell < ncells;
  const long long W = (long long)nx * cap;
  int cx = 0, cy = 0, cz = 0;
  if (active) {
    cx = (int)(cell % nx);
    const long long q = cell / nx;
    cy = (int)(q % ny);
    cz = (int)(q / ny);
  }
  T xi = T(0), yi = T(0), zi = T(0);
  bool vi = false;
  if (active) {
    const T* ri = r + (long long)(cz * ny + cy) * planes * W + (long long)cx * cap + s;
    xi = ri[0];
    yi = ri[W];
    zi = ri[2 * W];
    vi = ri[3 * W] > T(0.5);
  }
  T* sx = sj + (long long)g * 4 * cap;
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sv = sz + cap;

  T fx = T(0), fy = T(0), fz = T(0), u6 = T(0), vir = T(0);
  for (int dz = -1; dz <= 1; ++dz) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (active) {
          const int jx = wrap(cx + dx, nx);
          const int jy = wrap(cy + dy, ny);
          const int jz = wrap(cz + dz, nz);
          const T* rj = r + (long long)(jz * ny + jy) * planes * W + (long long)jx * cap + s;
          sx[s] = add_rn(rj[0], T(dx) * clx);
          sy[s] = add_rn(rj[W], T(dy) * cly);
          sz[s] = add_rn(rj[2 * W], T(dz) * clz);
          sv[s] = rj[3 * W];
        }
        __syncthreads();
        if (active && vi) {
          const bool self = (dx == 0) && (dy == 0) && (dz == 0);
          for (int k = 0; k < cap; ++k) {
            const T ddx = xi - sx[k];
            const T ddy = yi - sy[k];
            const T ddz = zi - sz[k];
            const T dr2 = add_rn(add_rn(mul_rn(ddx, ddx), mul_rn(ddy, ddy)),
                                 mul_rn(ddz, ddz));
            const bool m = (sv[k] > T(0.5)) && (dr2 < rc2) && !(self && k == s);
            if (m) {
              const T inv = T(1) / dr2;
              T lj6 = sig2 * inv;
              lj6 = lj6 * lj6 * lj6;
              const T fac = eps24 * (lj6 * inv) * (T(2) * lj6 - T(1));
              fx += fac * ddx;
              fy += fac * ddy;
              fz += fac * ddz;
              if (MACRO) {
                u6 += eps24 * (lj6 * lj6 - lj6) + shift6;
                vir += fac * dr2;
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }
  if (active) {
    T* fo = f + (long long)(cz * ny + cy) * 3 * W + (long long)cx * cap + s;
    fo[0] = fx;
    fo[W] = fy;
    fo[2 * W] = fz;
  }
  if (MACRO) {
    // each ordered pair was seen from both sides: halve
    T a = warp_sum(T(0.5) * u6);
    T b = warp_sum(T(0.5) * vir);
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
        part[2 * (long long)blockIdx.x] = a;
        part[2 * (long long)blockIdx.x + 1] = b;
      }
    }
  }
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int planes, double clx, double cly, double clz, double eps24,
           double sig2, double shift6, double rc2, int macro, void* stream) {
  const int cpb = cap >= 128 ? 1 : 128 / cap;
  const long long ncells = (long long)nx * ny * nz;
  const unsigned blocks = (unsigned)((ncells + cpb - 1) / cpb);
  const int threads = cpb * cap;
  const size_t smem = (size_t)cpb * 4 * cap * sizeof(T);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (macro) {
    lj_cells_kernel<T, true><<<blocks, threads, smem, st>>>(
        (const T*)r, (T*)f, (T*)part, nx, ny, nz, cap, cpb, planes, T(clx), T(cly),
        T(clz), T(eps24), T(sig2), T(shift6), T(rc2));
  } else {
    lj_cells_kernel<T, false><<<blocks, threads, smem, st>>>(
        (const T*)r, (T*)f, (T*)part, nx, ny, nz, cap, cpb, planes, T(clx), T(cly),
        T(clz), T(eps24), T(sig2), T(shift6), T(rc2));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks of a launch (rows of the part[., 2] buffer).
int lj_cells_num_blocks(int nx, int ny, int nz, int cap) {
  const int cpb = cap >= 128 ? 1 : 128 / cap;
  const long long ncells = (long long)nx * ny * nz;
  return (int)((ncells + cpb - 1) / cpb);
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
