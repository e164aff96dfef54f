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
// dz = dy = 0 and dx = +1), and writes the reaction -F_ij to the j slot.
// The TPU kernel takes 5 forward (dz, dy) rows with a double-sided own
// row and folds a per-row j accumulator (jacc) back in XLA; both cover
// every pair once.  Needs nx, ny, nz >= 3: with two cells on an axis the
// offsets +1 and -1 reach the same cell and the forward half is no half.
//
// Reactions: atomics, not a folded accumulator.  f64 atomicAdd is native
// on sm_90, so one skeleton serves f32 and f64; the wrapper zeroes the
// output and no scratch the size of the state is allocated or folded.
// Within a block the j reactions of one neighbour cell go to shared
// memory first: thread s walks the j slots from slot s on (a skewed
// order), so the threads of a warp add to different slots at each step
// and the shared atomics do not collide; then one global atomicAdd per
// j slot and axis.  The price is the order of the sums: it changes from
// run to run, so f agrees with the plain version to rounding, not bit for
// bit.
//
// What bounds it: arithmetic, as the double-sided kernels (lj_pair.cuh),
// with half their pair lanes (14 of 27 cells, the own cell halved) and
// three shared atomics per pair inside the cutoff.
//
// Design (the first, plain one; see PERF.md for its times): the block
// and staging of lj_pair.cuh (cpb = 128/cap cells, one thread per i
// slot), the neighbour cell staged with its image shift folded in
// (r_j + shift rounded once, as the plain version forms it) beside three
// reaction planes.

#include "lj_pair.cuh"

namespace {

using ljk::add_rn;
using ljk::Grid;
using ljk::LJ;
using ljk::wrap;

template <typename T, bool MACRO>
__global__ void n3l_kernel(const T* __restrict__ r, int P, T* __restrict__ f,
                           T* __restrict__ part, Grid gd, T clx, T cly, T clz,
                           LJ<T> lj) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [cpb][7][cap]

  const int nx = gd.nx, ny = gd.ny, nz = gd.nz, cap = gd.cap;
  const int t = threadIdx.x;
  const int g = t / cap;
  const int s = t - g * cap;
  const long long ncells = (long long)nx * ny * nz;
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
    const T* p = r + ((long long)cz * ny + cy) * P * W + (long long)cx * cap + s;
    xi = p[0];
    yi = p[W];
    zi = p[2 * W];
    vi = p[3 * W] > T(0.5);
  }
  T* sx = sm + (long long)g * 7 * cap;
  T* sy = sx + cap;
  T* sz = sy + cap;
  T* sv = sz + cap;
  T* rx = sv + cap;  // reactions on the staged j slots
  T* ry = rx + cap;
  T* rz = ry + cap;

  T fx = T(0), fy = T(0), fz = T(0), u6 = T(0), vir = T(0);
  // m = 9*(dz+1) + 3*(dy+1) + (dx+1): 13 is the own cell, 14..26 the
  // forward half
  for (int m = 13; m < 27; ++m) {
    const int dz = m / 9 - 1, dy = (m / 3) % 3 - 1, dx = m % 3 - 1;
    int jx = 0, jy = 0, jz = 0;
    if (active) {
      jx = wrap(cx + dx, nx);
      jy = wrap(cy + dy, ny);
      jz = wrap(cz + dz, nz);
      const T* p = r + ((long long)jz * ny + jy) * P * W + (long long)jx * cap + s;
      sx[s] = add_rn(p[0], T(dx) * clx);
      sy[s] = add_rn(p[W], T(dy) * cly);
      sz[s] = add_rn(p[2 * W], T(dz) * clz);
      sv[s] = p[3 * W];
      rx[s] = T(0);
      ry[s] = T(0);
      rz[s] = T(0);
    }
    __syncthreads();
    if (active && vi) {
      // own cell: j = s+1 .. cap-1; forward cells: all cap slots from s on
      const bool own = m == 13;
      const int n = own ? cap - 1 - s : cap;
      int k = own ? s + 1 : s;
      for (int kk = 0; kk < n; ++kk) {
        const T ddx = xi - sx[k];
        const T ddy = yi - sy[k];
        const T ddz = zi - sz[k];
        const T dr2 = ljk::norm2(ddx, ddy, ddz);
        if (sv[k] > T(0.5) && dr2 < lj.rc2) {
          T fac, e;
          ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, e);
          const T px = fac * ddx, py = fac * ddy, pz = fac * ddz;
          fx += px;
          fy += py;
          fz += pz;
          atomicAdd(rx + k, -px);
          atomicAdd(ry + k, -py);
          atomicAdd(rz + k, -pz);
          if (MACRO) {
            u6 += e + lj.shift6;
            vir += fac * dr2;
          }
        }
        if (++k == cap) k = 0;
      }
    }
    __syncthreads();
    if (active && sv[s] > T(0.5)) {
      T* o = f + ((long long)jz * ny + jy) * 3 * W + (long long)jx * cap + s;
      atomicAdd(o, rx[s]);
      atomicAdd(o + W, ry[s]);
      atomicAdd(o + 2 * W, rz[s]);
    }
    __syncthreads();
  }
  if (active && vi) {
    T* o = f + ((long long)cz * ny + cy) * 3 * W + (long long)cx * cap + s;
    atomicAdd(o, fx);
    atomicAdd(o + W, fy);
    atomicAdd(o + 2 * W, fz);
  }
  if (MACRO) ljk::block_macro(u6, vir, part, T(1));
}

template <typename T>
int launch(const void* r, void* f, void* part, int nx, int ny, int nz, int cap,
           int P, double clx, double cly, double clz, double eps24, double sig2,
           double shift6, double rc2, int macro, void* stream) {
  const Grid gd{nx, ny, nz, cap, ljk::cells_per_block(cap)};
  const LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)ljk::num_blocks(nx, ny, nz, cap);
  const int threads = gd.cpb * cap;
  const size_t smem = (size_t)gd.cpb * 7 * cap * sizeof(T);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (macro) {
    n3l_kernel<T, true><<<blocks, threads, smem, st>>>(
        (const T*)r, P, (T*)f, (T*)part, gd, T(clx), T(cly), T(clz), lj);
  } else {
    n3l_kernel<T, false><<<blocks, threads, smem, st>>>(
        (const T*)r, P, (T*)f, (T*)part, gd, T(clx), T(cly), T(clz), lj);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lj_cells_n3l_num_blocks(int nx, int ny, int nz, int cap) {
  return ljk::num_blocks(nx, ny, nz, cap);
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
