// z-banded LJ-12-6 cell forces on the dense RMM cell layout, for Hopper
// (sm_90a), with the Gram form of r^2 as an option.
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_zb (body _lj_zb_kernel).  Same function as
// lj_cells.cu: double-sided forces on every slot of the cell-local layout
// r[nz, ny, P, nx*cap] (planes x, y, z, valid; P >= 4, so the RMM state's
// 8-plane tensor is read in place), u6 (6*U incl. shift6) and the virial,
// both halved per pair.
//
// What defines the TPU kernel is the z band: one program owns a z plane
// and holds its three neighbouring z planes whole, so each j row is
// fetched 3 times and not 9.  Here a block owns a band of `by` y rows of
// one z plane over a segment of x cells and slides along x: it keeps
// three x columns of the j cells it needs (3 z planes x by+2 y rows, every
// slot) in shared memory and, per x step, loads ONE new column.  Every
// j cell is fetched from device memory once per band, for the 3 z planes
// x (by+2)/by rows it serves: 3.75 fetches at by = 8 (cap 32) instead of
// 27 (lj_cells.cu stages each neighbour cell for each i cell).
//
// gram = 1 forms r^2 = |r_i|^2 + |r_j|^2 - 2 r_i.r_j and
// F_i = r_i * sum_j fac - sum_j fac * r_j, as the TPU kernel's gram mode
// does on its matrix unit, here in the kernel's own arithmetic (no FMA,
// no library call).  The coordinates are local to the i cell (r_j gets
// its image shift; every |r| <= 2 cell edges), so the cancellation in
// |r_i|^2 + |r_j|^2 - 2 r_i.r_j stays near ulp(r^2).  Empty slots are
// masked on the validity plane before the Gram terms count: two sentinel
// slots (y ~ 1e3 * slot) would cancel to anything.
//
// What bounds it: arithmetic, as lj_pair.cuh (27 * cap^2 pair lanes per
// cell); the band cuts the staging traffic, not the pair work.
//
// Rounding: r_j + shift is rounded once and r^2 is formed without FMA,
// in the order of the plain version (ops/cuda_lj_variants.py), so both
// take the same side of the cutoff for every pair.

#include "lj_pair.cuh"

namespace {

using ljk::add_rn;
using ljk::mul_rn;
using ljk::sub_rn;
using ljk::LJ;

// x cells per block segment: enough blocks to fill the card at the main
// path's grid (60 z planes x 8 bands x 4 segments)
constexpr int SEG = 16;

struct Band {
  int nx, ny, nz, cap, by;
};

__host__ __device__ inline int band_rows(int cap) {
  return cap >= 256 ? 1 : 256 / cap;
}

// c mod n for any c >= -n (staging only: a band's rows reach y0 + by)
__device__ __forceinline__ int pmod(int c, int n) {
  const int m = c % n;
  return m < 0 ? m + n : m;
}

template <typename T, bool MACRO, bool GRAM>
__global__ void zb_kernel(const T* __restrict__ r, int P, T* __restrict__ f,
                          T* __restrict__ part, Band bd, T clx, T cly, T clz,
                          LJ<T> lj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [3 cols][3 z][by+2 y][4][cap]

  const int nx = bd.nx, ny = bd.ny, nz = bd.nz, cap = bd.cap, by = bd.by;
  const int R = by + 2;
  const int t = threadIdx.x;
  const int b = t / cap;
  const int s = t - b * cap;
  const int x0 = blockIdx.x * SEG;
  const int x1 = min(nx, x0 + SEG);
  const int y0 = blockIdx.y * by;
  const int z = blockIdx.z;
  const int y = y0 + b;
  const bool rowok = y < ny;
  const long long W = (long long)nx * cap;
  const int colsz = 3 * R * 4 * cap;

  // column xc (>= -1) of the band's j cells into ring slot (xc+3) % 3
  auto load_col = [&](int xc) {
    const int jx = pmod(xc, nx);
    T* dst = ring + ((xc + 3) % 3) * colsz;
    for (int e = t; e < 3 * R * cap; e += blockDim.x) {
      const int c = e / cap, k = e - c * cap;
      const int zz = c / R, rr = c - zz * R;
      const int jz = pmod(z + zz - 1, nz);
      const int jy = pmod(y0 + rr - 1, ny);
      const T* p = r + ((long long)jz * ny + jy) * P * W + (long long)jx * cap + k;
      T* d = dst + (long long)c * 4 * cap + k;
      d[0] = p[0];
      d[cap] = p[W];
      d[2 * cap] = p[2 * W];
      d[3 * cap] = p[3 * W];
    }
  };

  T u6 = T(0), vir = T(0);
  load_col(x0 - 1);
  load_col(x0);
  for (int x = x0; x < x1; ++x) {
    load_col(x + 1);
    __syncthreads();
    if (rowok) {
      const T* p = r + ((long long)z * ny + y) * P * W + (long long)x * cap + s;
      const T xi = p[0], yi = p[W], zi = p[2 * W];
      const bool vi = p[3 * W] > T(0.5);
      T fx = T(0), fy = T(0), fz = T(0);
      if (vi) {
        // gram: S0 = sum fac, (sx, sy, sz) = sum fac * r_j
        T s0 = T(0);
        const T si = GRAM ? ljk::norm2(xi, yi, zi) : T(0);
        for (int dz = -1; dz <= 1; ++dz) {
          for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
              const T* c = ring + ((x + dx + 3) % 3) * colsz +
                           (long long)((dz + 1) * R + b + dy + 1) * 4 * cap;
              const T shx = T(dx) * clx, shy = T(dy) * cly, shz = T(dz) * clz;
              const int self_k = (dx == 0 && dy == 0 && dz == 0) ? s : -1;
              for (int k = 0; k < cap; ++k) {
                const T xj = add_rn(c[k], shx);
                const T yj = add_rn(c[cap + k], shy);
                const T zj = add_rn(c[2 * cap + k], shz);
                T dr2, ddx = T(0), ddy = T(0), ddz = T(0);
                if (GRAM) {
                  const T sj = ljk::norm2(xj, yj, zj);
                  const T cr = add_rn(add_rn(mul_rn(xi, xj), mul_rn(yi, yj)),
                                      mul_rn(zi, zj));
                  dr2 = sub_rn(add_rn(sj, si), add_rn(cr, cr));
                } else {
                  ddx = xi - xj;
                  ddy = yi - yj;
                  ddz = zi - zj;
                  dr2 = ljk::norm2(ddx, ddy, ddz);
                }
                if (c[3 * cap + k] > T(0.5) && dr2 < lj.rc2 && k != self_k) {
                  T fac, e;
                  ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, e);
                  if (GRAM) {
                    s0 += fac;
                    fx += mul_rn(fac, xj);
                    fy += mul_rn(fac, yj);
                    fz += mul_rn(fac, zj);
                  } else {
                    fx += fac * ddx;
                    fy += fac * ddy;
                    fz += fac * ddz;
                  }
                  if (MACRO) {
                    u6 += e + lj.shift6;
                    vir += fac * dr2;
                  }
                }
              }
            }
          }
        }
        if (GRAM) {
          fx = sub_rn(mul_rn(xi, s0), fx);
          fy = sub_rn(mul_rn(yi, s0), fy);
          fz = sub_rn(mul_rn(zi, s0), fz);
        }
      }
      T* o = f + ((long long)z * ny + y) * 3 * W + (long long)x * cap + s;
      o[0] = fx;
      o[W] = fy;
      o[2 * W] = fz;
    }
    __syncthreads();
  }
  if (MACRO) ljk::block_macro(u6, vir, part);
}

size_t smem_bytes(int cap, size_t size) {
  return (size_t)3 * 3 * (band_rows(cap) + 2) * 4 * cap * size;
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int P, double clx, double cly, double clz, double eps24, double sig2,
           double shift6, double rc2, int macro, int gram, void* stream) {
  const Band bd{nx, ny, nz, cap, band_rows(cap)};
  const LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const dim3 grid((unsigned)((nx + SEG - 1) / SEG),
                  (unsigned)((ny + bd.by - 1) / bd.by), (unsigned)nz);
  const int threads = bd.by * cap;
  const size_t smem = smem_bytes(cap, sizeof(T));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define ZB_LAUNCH(M, G)                                                       \
  do {                                                                        \
    auto kern = zb_kernel<T, M, G>;                                           \
    cudaError_t err = cudaFuncSetAttribute(                                   \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (err != cudaSuccess) { /* too much shared memory: clear, report */    \
      cudaGetLastError();                                                     \
      return (int)err;                                                        \
    }                                                                         \
    kern<<<grid, threads, smem, st>>>((const T*)r, P, (T*)f, (T*)part, bd,    \
                                      T(clx), T(cly), T(clz), lj);            \
  } while (0)
  if (macro) {
    if (gram) ZB_LAUNCH(true, true); else ZB_LAUNCH(true, false);
  } else {
    if (gram) ZB_LAUNCH(false, true); else ZB_LAUNCH(false, false);
  }
#undef ZB_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lj_cells_zb_num_blocks(int nx, int ny, int nz, int cap) {
  return ((nx + SEG - 1) / SEG) * ((ny + band_rows(cap) - 1) / band_rows(cap)) *
         nz;
}

int lj_cells_zb_f32(const void* r, void* f, void* part, int nx, int ny, int nz,
                    int cap, int planes, double clx, double cly, double clz,
                    double eps24, double sig2, double shift6, double rc2,
                    int macro, int gram, void* stream) {
  return launch<float>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz, eps24,
                       sig2, shift6, rc2, macro, gram, stream);
}

int lj_cells_zb_f64(const void* r, void* f, void* part, int nx, int ny, int nz,
                    int cap, int planes, double clx, double cly, double clz,
                    double eps24, double sig2, double shift6, double rc2,
                    int macro, int gram, void* stream) {
  return launch<double>(r, f, part, nx, ny, nz, cap, planes, clx, cly, clz,
                        eps24, sig2, shift6, rc2, macro, gram, stream);
}

}  // extern "C"
