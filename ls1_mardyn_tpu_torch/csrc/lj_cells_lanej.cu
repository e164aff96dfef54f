// j-parallel LJ-12-6 row forces from an explicit j view, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_lj.py:
// lj_cell_forces_pallas_lanej (body _lj_lanej_kernel).  Same function as
// lj_cells_row.cu in cell-local mode: double-sided forces on every slot
// of r_i[nz, ny, 4, nx*cap] against the 9 neighbour rows of a j view
// r_j[nz, ny, 4, (nx+2)*cap] that carries one periodic halo cell per
// side in x; the neighbour cell at offset (dx, dy, dz) is shifted by
// whole cell edges.  u6 (6*U incl. shift6) and the virial are halved per
// pair.
//
// What defines the TPU kernel: j on lanes, i on sublanes, and with
// `defer` the reductions over j done once per tile rather than once per
// neighbour row.  Carried over as a j-parallel kernel: a block owns one
// i cell and stages its 27 neighbour cells in shared memory (image
// shift folded in, r_j + shift rounded once); each warp takes i slots in
// turn, and the 32 lanes of the warp hold j slots, each lane summing
// its share of the pair terms of that i.  The i force is then a sum
// across the warp (shuffles): with defer = 0 one reduction per
// neighbour row (9 per i slot, the TPU kernel's per-row lane sums), with
// defer = 1 one per i slot over all 27 cells.
//
// What bounds it: arithmetic (27 * cap^2 pair lanes per cell, as
// lj_pair.cuh), plus the shuffles of the reductions: 5 sums of 5
// shuffles per reduction.
//
// Rounding: r^2 is formed without FMA from r_i - (r_j + shift), as the
// plain version (lj_cell_forces_row_reference, local mode) forms it, so
// both apply the cutoff to the same pairs; the sums run in another order.

#include "lj_pair.cuh"

namespace {

using ljk::add_rn;
using ljk::LJ;
using ljk::warp_allsum;
using ljk::wrap;

constexpr int THREADS = 128;

struct RowView {
  int nx, ny, nz, cap;
};

template <typename T, bool MACRO, bool DEFER>
__global__ void lanej_kernel(const T* __restrict__ ri, const T* __restrict__ rj,
                             T* __restrict__ f, T* __restrict__ part,
                             RowView v, T ux, T uy, T uz, LJ<T> lj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [27][4][cap]

  const int nx = v.nx, ny = v.ny, nz = v.nz, cap = v.cap;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long cell = blockIdx.x;
  const int cx = (int)(cell % nx);
  const int cy = (int)((cell / nx) % ny);
  const int cz = (int)(cell / ((long long)nx * ny));
  const long long W = (long long)nx * cap;
  const long long Wj = (long long)(nx + 2) * cap;

  // the 27 neighbour cells, m = 9*(dz+1) + 3*(dy+1) + (dx+1)
  for (int e = t; e < 27 * cap; e += THREADS) {
    const int m = e / cap, k = e - m * cap;
    const int dz = m / 9 - 1, dy = (m / 3) % 3 - 1, dx = m % 3 - 1;
    const int jz = wrap(cz + dz, nz), jy = wrap(cy + dy, ny);
    const T* p = rj + ((long long)jz * ny + jy) * 4 * Wj +
                 (long long)(cx + 1 + dx) * cap + k;
    T* d = sm + (long long)m * 4 * cap + k;
    d[0] = add_rn(p[0], T(dx) * ux);
    d[cap] = add_rn(p[Wj], T(dy) * uy);
    d[2 * cap] = add_rn(p[2 * Wj], T(dz) * uz);
    d[3 * cap] = p[3 * Wj];
  }
  __syncthreads();

  T u6 = T(0), vir = T(0);  // lane 0's totals over its i slots
  const T* pi = ri + ((long long)cz * ny + cy) * 4 * W + (long long)cx * cap;
  T* fo = f + ((long long)cz * ny + cy) * 3 * W + (long long)cx * cap;
  for (int i = w; i < cap; i += THREADS / 32) {
    const T xi = pi[i], yi = pi[W + i], zi = pi[2 * W + i];
    T tx = T(0), ty = T(0), tz = T(0), tu = T(0), tv = T(0);
    if (pi[3 * W + i] > T(0.5)) {
      T ax = T(0), ay = T(0), az = T(0), au = T(0), av = T(0);
      for (int row = 0; row < 9; ++row) {
        for (int c = 0; c < 3; ++c) {
          const int m = 3 * row + c;
          const T* sj = sm + (long long)m * 4 * cap;
          const int self_k = m == 13 ? i : -1;
          for (int k = lane; k < cap; k += 32) {
            const T ddx = xi - sj[k];
            const T ddy = yi - sj[cap + k];
            const T ddz = zi - sj[2 * cap + k];
            const T dr2 = ljk::norm2(ddx, ddy, ddz);
            if (sj[3 * cap + k] > T(0.5) && dr2 < lj.rc2 && k != self_k) {
              T fac, e;
              ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, e);
              ax += fac * ddx;
              ay += fac * ddy;
              az += fac * ddz;
              if (MACRO) {
                au += e + lj.shift6;
                av += fac * dr2;
              }
            }
          }
        }
        if (!DEFER) {
          tx += warp_allsum(ax);
          ty += warp_allsum(ay);
          tz += warp_allsum(az);
          ax = ay = az = T(0);
          if (MACRO) {
            tu += warp_allsum(au);
            tv += warp_allsum(av);
            au = av = T(0);
          }
        }
      }
      if (DEFER) {
        tx = warp_allsum(ax);
        ty = warp_allsum(ay);
        tz = warp_allsum(az);
        if (MACRO) {
          tu = warp_allsum(au);
          tv = warp_allsum(av);
        }
      }
    }
    if (lane == 0) {
      fo[i] = tx;
      fo[W + i] = ty;
      fo[2 * W + i] = tz;
      u6 += tu;
      vir += tv;
    }
  }
  if (MACRO) ljk::block_macro(u6, vir, part);
}

template <typename T>
int launch(const void* ri, const void* rj, void* f, void* part, int nx, int ny,
           int nz, int cap, double ux, double uy, double uz, double eps24,
           double sig2, double shift6, double rc2, int macro, int defer,
           void* stream) {
  const RowView v{nx, ny, nz, cap};
  const LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)((long long)nx * ny * nz);
  const size_t smem = (size_t)27 * 4 * cap * sizeof(T);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LANEJ_LAUNCH(M, D)                                                    \
  do {                                                                        \
    auto kern = lanej_kernel<T, M, D>;                                        \
    cudaError_t err = cudaFuncSetAttribute(                                   \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (err != cudaSuccess) { /* too much shared memory: clear, report */    \
      cudaGetLastError();                                                     \
      return (int)err;                                                        \
    }                                                                         \
    kern<<<blocks, THREADS, smem, st>>>((const T*)ri, (const T*)rj, (T*)f,    \
                                        (T*)part, v, T(ux), T(uy), T(uz), lj);\
  } while (0)
  if (macro) {
    if (defer) LANEJ_LAUNCH(true, true); else LANEJ_LAUNCH(true, false);
  } else {
    if (defer) LANEJ_LAUNCH(false, true); else LANEJ_LAUNCH(false, false);
  }
#undef LANEJ_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lj_cells_lanej_num_blocks(int nx, int ny, int nz, int cap) {
  return nx * ny * nz;
}

int lj_cells_lanej_f32(const void* ri, const void* rj, void* f, void* part,
                       int nx, int ny, int nz, int cap, double ux, double uy,
                       double uz, double eps24, double sig2, double shift6,
                       double rc2, int macro, int defer, void* stream) {
  return launch<float>(ri, rj, f, part, nx, ny, nz, cap, ux, uy, uz, eps24, sig2,
                       shift6, rc2, macro, defer, stream);
}

int lj_cells_lanej_f64(const void* ri, const void* rj, void* f, void* part,
                       int nx, int ny, int nz, int cap, double ux, double uy,
                       double uz, double eps24, double sig2, double shift6,
                       double rc2, int macro, int defer, void* stream) {
  return launch<double>(ri, rj, f, part, nx, ny, nz, cap, ux, uy, uz, eps24,
                        sig2, shift6, rc2, macro, defer, stream);
}

}  // extern "C"
