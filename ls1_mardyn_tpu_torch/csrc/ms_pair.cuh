// Device code shared by the rigid multi-site kernels K6 (ms_dense.cu,
// dense cap-padded rows) and K5 (ms_packed.cu, occupancy-packed rows):
// the seven interaction bodies of ls1's potforce.h in component form,
// the site-pair loop over one molecule pair, and the kernel skeleton.
// A kernel source adds only a row functor: where the i rows lie, which
// i tiles are live, the cell of an i slot, and for each of the 9
// (dz, dy) neighbour rows the j row, its j slot ranges, its image shift
// and the self-pair offset.
//
// The function (the TPU kernels' _pair_physics,
// ls1_mardyn_tpu/ops/pallas_multisite.py:61): for every occupied i slot
// and every j molecule of the neighbour cells (the i slot itself
// excluded), the COM separation drm = r_i - (r_j + image shift); LJ site
// pairs count where |drm|^2 < rc2_lj, electrostatic ones where
// |drm|^2 < rc2 (molecule-based cutoff, as ls1).  Per slot: F, torque
// M = sum site offset x f + the orientation torques, and
// Vi = 0.5 drm (.) f; per block the sums of u6, uX and myRF, halved
// because every pair is seen from both sides.
//
// The site pairs come as a "site-pair program" built on the host
// (ops/cuda_ms.py: MSMeta.terms): one row per (body, site a, site b)
// whose coupling mask is non-zero, with the plane bases of the site
// offsets and orientations and the offsets of its coupling constants in
// one flat table [13 tables][K][K][Sa][Sb] (MSMeta.flat_tables).  Both
// live in shared memory, loaded once per block; the constant of the
// component pair (ci, cj) is tab[c + (ci*K + cj) * stride].  The TPU
// kernel's one-hot component products and its trace-time alias pruning
// are not carried over; a site at the COM skips its offset.
//
// What bounds these kernels on this card: arithmetic throughput.  A call
// tests ~27 * (molecules per cell) candidates per molecule at ~12
// operations and evaluates the site program on the ~15% inside the
// cutoff (4 LJ site pairs and a quadrupole pair, ~250 operations, for
// the 2CLJQ model), with IEEE divisions and square roots.  Each staged j
// slot (P planes) feeds 128 i slots from shared memory, so device-memory
// traffic is a few bytes per pair and far below the memory roof.
//
// Design (the first, plain one; PERF.md has its times):
//   * one block = one tile of 128 consecutive i slots of one (z, y) row
//     (TI threads, one slot each); the block stages its i slots' planes
//     in shared memory, so the site program reads them by plane index;
//   * the tile's covering cell range [c_lo, c_hi] (a block min/max over
//     its valid slots) gives, per neighbour row, the j slot ranges of
//     cells c_lo-1 .. c_hi+1; they are staged through shared memory in
//     chunks of CH slots x P planes with the y/z image shift added once
//     (rounded, as the plain version adds it), and every thread walks
//     the chunk: the COM cutoff test first (most candidates fail it),
//     then the site program;
//   * |drm|^2 is formed exactly as the plain PyTorch versions form it,
//     ((dx*dx + dy*dy) + dz*dz) with no FMA contraction, so both put
//     every pair on the same side of the cutoff (unshifted charge terms
//     jump at rc); divisions, square roots and erfc are the IEEE /
//     libdevice ones (no fast-math build);
//   * double-sided evaluation, no atomics: the sums of an i slot stay in
//     registers, and the result is deterministic.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace msk {

constexpr int TI = 128;       // i slots per block
constexpr int CH = 64;        // j slots per staged chunk
constexpr int NOUT = 10;      // F, M, Vi, (zero)
constexpr int TERM_INTS = 10; // body, pi, pj, ei, ej, c0, c1, c2, stride, pad
constexpr int NO_SELF = INT_MIN / 2;

enum Body : int { LJ = 0, CC, CQ, CD, QC, QQ, QD, DC, DQ, DD };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int to_int(float a) { return __float2int_rn(a); }
__device__ __forceinline__ int to_int(double a) { return __double2int_rn(a); }

// c mod n for c in [-1, n] and any n >= 1 (a row index plus -1, 0, 1)
__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> operator+(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator-(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator-(V3<T> a) {
  return {-a.x, -a.y, -a.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator*(T s, V3<T> a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// -- the bodies (potforce.h in component form; ops/cellforce_lanes.py of
// the JAX package); inv = 1 / |dr|^2 --------------------------------------

// charge (role i) -- quadrupole (role j, orientation ej): f on the
// charge, m2 the torque on the quadrupole
template <typename T>
__device__ __forceinline__ void charge_quad(V3<T> dr, T inv, V3<T> ej, T qQ05,
                                            V3<T>& f, V3<T>& m2, T& u) {
  const T invd = sqrt(inv);
  const T costj = dot(ej, dr) * invd;
  const T qQ3 = qQ05 * invd * inv;
  u = qQ3 * (T(3) * costj * costj - T(1));
  const T pRij = T(-3) * u * inv;
  const T pTj = T(6) * costj * qQ3 * invd;
  const T fac = costj * pTj * invd - pRij;
  f = fac * dr - pTj * ej;
  m2 = pTj * cross(dr, ej);
}

// charge (role i) -- dipole (role j)
template <typename T>
__device__ __forceinline__ void charge_dip(V3<T> dr, T inv, V3<T> ej, T mqmy,
                                           V3<T>& f, V3<T>& m2, T& u) {
  const T invd = sqrt(inv);
  const T costj = dot(ej, dr) * invd;
  const T uic = mqmy * inv;
  u = uic * costj;
  const T pTj = uic * invd;
  const T fac = T(3) * u * inv;
  f = fac * dr - pTj * ej;
  m2 = pTj * cross(dr, ej);
}

// dipole -- dipole with the reaction field: f and m1 on i, rf the
// reaction-field term (-rffac cos gamma)
template <typename T>
__device__ __forceinline__ void dip_dip(V3<T> dr, T inv, V3<T> ei, V3<T> ej,
                                        T my2, T rffac, V3<T>& f, V3<T>& m1,
                                        T& u, T& rf) {
  const T invd = sqrt(inv);
  const T myfac = my2 * inv * invd;
  const T costi = dot(ei, dr) * invd;
  const T costj = dot(ej, dr) * invd;
  const T cosg = dot(ei, ej);
  u = myfac * (cosg - T(3) * costi * costj);
  rf = -rffac * cosg;
  const T pTi = -myfac * T(3) * costj * invd;
  const T pTj = -myfac * T(3) * costi * invd;
  const T pRij = T(-3) * u * inv;
  const T fac = -pRij + (costi * pTi + costj * pTj) * invd;
  f = fac * dr - pTi * ei - pTj * ej;
  m1 = (-pTi) * cross(ei, dr) + (rffac - myfac) * cross(ei, ej);
}

// dipole (role i, ei) -- quadrupole (role j, ej): f on the dipole, m1 the
// torque on the dipole, m2 on the quadrupole
template <typename T>
__device__ __forceinline__ void dip_quad(V3<T> dr, T inv, V3<T> ei, V3<T> ej,
                                         T myq15, V3<T>& f, V3<T>& m1,
                                         V3<T>& m2, T& u) {
  const T invd = sqrt(inv);
  const T myqfac = myq15 * inv * inv;
  const T costi = dot(ei, dr) * invd;
  const T costj = dot(ej, dr) * invd;
  const T cosg = dot(ei, ej);
  const T cos2tj = costj * costj;
  u = myqfac * (-costi * (T(5) * cos2tj - T(1)) + T(2) * cosg * costj);
  const T pRij = T(-4) * u * inv;
  const T pTi = myqfac * (T(-5) * cos2tj + T(1)) * invd;
  const T pTj = myqfac * T(2) * (T(-5) * costi * costj + cosg) * invd;
  const T pG = myqfac * T(2) * costj;
  const T fac = -pRij + (costi * pTi + costj * pTj) * invd;
  f = fac * dr - pTi * ei - pTj * ej;
  const V3<T> exj = cross(ei, ej);
  m1 = (-pTi) * cross(ei, dr) - pG * exj;
  m2 = (-pTj) * cross(ej, dr) + pG * exj;
}

// quadrupole -- quadrupole: f and m1 on i
template <typename T>
__device__ __forceinline__ void quad_quad(V3<T> dr, T inv, V3<T> ei, V3<T> ej,
                                          T q2075, V3<T>& f, V3<T>& m1, T& u) {
  const T invd = sqrt(inv);
  const T qfac = q2075 * inv * inv * invd;
  const T costi = dot(ei, dr) * invd;
  const T costj = dot(ej, dr) * invd;
  const T cosg = dot(ei, ej);
  const T cos2ti = costi * costi;
  const T cos2tj = costj * costj;
  const T term = cosg - T(5) * costi * costj;
  u = qfac * (T(1) - T(5) * (cos2ti + cos2tj) - T(15) * cos2ti * cos2tj +
              T(2) * term * term);
  const T pRij = T(-5) * u * inv;
  const T pTi = -qfac * T(10) *
                (costi + T(3) * costi * cos2tj + T(2) * costj * term) * invd;
  const T pTj = -qfac * T(10) *
                (costj + T(3) * cos2ti * costj + T(2) * costi * term) * invd;
  const T pG = qfac * T(4) * term;
  const T fac = -pRij + (costi * pTi + costj * pTj) * invd;
  f = fac * dr - pTi * ei - pTj * ej;
  m1 = (-pTi) * cross(ei, dr) - pG * cross(ei, ej);
}

// Sums of one i slot.
template <typename T>
struct Acc {
  V3<T> F{T(0), T(0), T(0)}, M{T(0), T(0), T(0)}, V{T(0), T(0), T(0)};
  T u6 = T(0), uX = T(0), rf = T(0);
};

// The physical constants of a launch.
template <typename T>
struct Phys {
  T rc2, rc2lj, alpha, tap;  // tap = 2 alpha / sqrt(pi)
  int K, nterms;
};

// Every term of the site-pair program for the ordered molecule pair
// (i, j): si points at the i slot's plane 0 in shared memory (plane
// stride TI), sj at the j slot's (plane stride CH); kk = ci*K + cj.
template <typename T>
__device__ __forceinline__ void molecule_pair(const T* si, const T* sj,
                                              V3<T> drm, bool mlj, bool mel,
                                              int kk, const int* terms,
                                              const T* tab, const Phys<T>& ph,
                                              Acc<T>& a) {
  for (int t = 0; t < ph.nterms; ++t) {
    const int* tm = terms + t * TERM_INTS;
    const int body = tm[0];
    if (body == LJ ? !mlj : !mel) continue;
    const int pi = tm[1], pj = tm[2];
    V3<T> di{T(0), T(0), T(0)};
    V3<T> dr = drm;
    if (pi >= 0) {
      di = {si[pi * TI], si[(pi + 1) * TI], si[(pi + 2) * TI]};
      dr = dr + di;
    }
    if (pj >= 0) dr = dr - V3<T>{sj[pj * CH], sj[(pj + 1) * CH], sj[(pj + 2) * CH]};
    const T inv = T(1) / dot(dr, dr);
    const T c0 = tab[tm[5] + kk * tm[8]];
    V3<T> ei{T(0), T(0), T(0)}, ej{T(0), T(0), T(0)};
    if (tm[3] >= 0) ei = {si[tm[3] * TI], si[(tm[3] + 1) * TI], si[(tm[3] + 2) * TI]};
    if (tm[4] >= 0) ej = {sj[tm[4] * CH], sj[(tm[4] + 1) * CH], sj[(tm[4] + 2) * CH]};
    V3<T> f{T(0), T(0), T(0)}, m{T(0), T(0), T(0)}, m2;
    T u = T(0);
    switch (body) {
      case LJ: {
        const T sig2 = tab[tm[6] + kk * tm[8]];
        const T sh6 = tab[tm[7] + kk * tm[8]];
        T lj6 = sig2 * inv;
        lj6 = lj6 * lj6 * lj6;
        const T lj12 = lj6 * lj6;
        const T lj12m6 = lj12 - lj6;
        a.u6 += c0 * lj12m6 + sh6;
        f = (c0 * (lj12 + lj12m6) * inv) * dr;
        break;
      }
      case CC: {
        const T invd = sqrt(inv);
        T fac;
        if (ph.alpha > T(0)) {
          const T dr2 = dot(dr, dr);
          const T e = exp(-(ph.alpha * ph.alpha) * dr2);
          u = c0 * erfc(ph.alpha * (dr2 * invd)) * invd;
          fac = (u + c0 * ph.tap * e) * inv;
        } else {
          u = c0 * invd;
          fac = u * inv;
        }
        f = fac * dr;
        break;
      }
      case CQ:
        charge_quad(dr, inv, ej, c0, f, m2, u);
        break;
      case CD:
        charge_dip(dr, inv, ej, c0, f, m2, u);
        break;
      case QC:  // dr = charge_j - quad_i; i gets -f and the quad torque
        charge_quad(-dr, inv, ei, c0, f, m, u);
        f = -f;
        break;
      case QQ:
        quad_quad(dr, inv, ei, ej, c0, f, m, u);
        break;
      case QD:  // dr = dip_j - quad_i; i gets -f and the quad torque
        dip_quad(-dr, inv, ej, ei, c0, f, m2, m, u);
        f = -f;
        break;
      case DC:  // dr = charge_j - dip_i; i gets -f and the dipole torque
        charge_dip(-dr, inv, ei, c0, f, m, u);
        f = -f;
        break;
      case DQ:
        dip_quad(dr, inv, ei, ej, c0, f, m, m2, u);
        break;
      default: {  // DD
        T rf;
        dip_dip(dr, inv, ei, ej, c0, tab[tm[6] + kk * tm[8]], f, m, u, rf);
        a.rf += rf;
        break;
      }
    }
    a.F = a.F + f;
    a.M = a.M + m;
    if (pi >= 0) a.M = a.M + cross(di, f);
    a.V = a.V + V3<T>{T(0.5) * drm.x * f.x, T(0.5) * drm.y * f.y,
                      T(0.5) * drm.z * f.z};
    a.uX += u;
  }
}

// What a row functor returns for neighbour row (dz, dy): the j row's
// plane 0, its plane stride, up to two j slot ranges [a0, a1) and
// [b0, b1), the image shift of its y and z, and the self-pair offset
// (j == i + self_off on the centre row; NO_SELF elsewhere).
template <typename T>
struct JRow {
  const T* p;
  long long stride;
  int a0, a1, b0, b1;
  T sy, sz;
  int self_off;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of a block: the flat tables, the i planes [P][TI], the j
// chunk [P][CH], then the program.
inline size_t smem_bytes(int P, int ntab, int nterms, size_t elem) {
  const size_t ntab_pad = (size_t)((ntab + 1) / 2 * 2);
  return (ntab_pad + (size_t)P * (TI + CH)) * elem +
         (size_t)nterms * TERM_INTS * sizeof(int);
}

// Forces of the i tile blockIdx.x of row (blockIdx.z, blockIdx.y):
// ri / out are [nz, ny, P | NOUT, W]; part[block][3] the halved sums.
template <typename T, typename Rows>
__global__ void __launch_bounds__(TI)
ms_kernel(const T* __restrict__ ri, T* __restrict__ out, T* __restrict__ part,
          const T* __restrict__ tab_g, const int* __restrict__ terms_g,
          int ntab, int P, Rows rows, Phys<T> ph) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_tab = reinterpret_cast<T*>(smem_raw);
  T* s_i = s_tab + (ntab + 1) / 2 * 2;
  T* s_j = s_i + (size_t)P * TI;
  int* s_terms = reinterpret_cast<int*>(s_j + (size_t)P * CH);
  __shared__ int s_lo, s_hi;
  __shared__ T red[3][TI / 32];

  const int t = threadIdx.x;
  const int tile = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  const long long blk = ((long long)z * gridDim.y + y) * gridDim.x + tile;
  const int W = rows.W;
  const long long row = (long long)z * rows.ny + y;
  const int s = tile * TI + t;
  T* o = out + row * NOUT * W + s;

  if (!rows.tile_live(z, y, tile)) {  // uniform over the block
    if (s < W)
      for (int p = 0; p < NOUT; ++p) o[(long long)p * W] = T(0);
    if (t < 3) part[3 * blk + t] = T(0);
    return;
  }
  for (int k = t; k < ntab; k += TI) s_tab[k] = tab_g[k];
  for (int k = t; k < ph.nterms * TERM_INTS; k += TI) s_terms[k] = terms_g[k];
  const T* pi_g = ri + row * P * W + s;
  for (int p = 0; p < P; ++p) s_i[p * TI + t] = s < W ? pi_g[(long long)p * W] : T(0);
  if (t == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  __syncthreads();
  const T* si = s_i + t;
  const bool vi = s < W && si[3 * TI] > T(0.5);
  if (vi) {
    const int c = rows.i_cell(si, s);
    atomicMin(&s_lo, c);
    atomicMax(&s_hi, c);
  }
  __syncthreads();
  const int c_lo = s_lo, c_hi = s_hi;
  const T xi = si[0], yi = si[TI], zi = si[2 * TI];
  const int ci = vi ? to_int(si[4 * TI]) : 0;

  Acc<T> a;
  if (c_lo <= c_hi) {  // uniform: the tile holds a valid slot
    for (int k = 0; k < 9; ++k) {
      const JRow<T> jr = rows.row(z, y, k / 3 - 1, k % 3 - 1, c_lo, c_hi);
      for (int r = 0; r < 2; ++r) {
        const int j0 = r ? jr.b0 : jr.a0, j1 = r ? jr.b1 : jr.a1;
        for (int base = j0; base < j1; base += CH) {
          const int n = min(CH, j1 - base);
          for (int e = t; e < P * CH; e += TI) {
            const int p = e / CH, q = e - p * CH;
            if (q < n) {
              T v = jr.p[(long long)p * jr.stride + base + q];
              if (p == 1) v = add_rn(v, jr.sy);
              if (p == 2) v = add_rn(v, jr.sz);
              s_j[e] = v;
            }
          }
          __syncthreads();
          if (vi) {
            for (int q = 0; q < n; ++q) {
              if (!(s_j[3 * CH + q] > T(0.5)) || base + q == s + jr.self_off) continue;
              const V3<T> drm{xi - s_j[q], yi - s_j[CH + q], zi - s_j[2 * CH + q]};
              const T com2 = add_rn(add_rn(mul_rn(drm.x, drm.x), mul_rn(drm.y, drm.y)),
                                    mul_rn(drm.z, drm.z));
              const bool mlj = com2 < ph.rc2lj, mel = com2 < ph.rc2;
              if (!(mlj || mel)) continue;
              const int kk = ci * ph.K + to_int(s_j[4 * CH + q]);
              molecule_pair(si, s_j + q, drm, mlj, mel, kk, s_terms, s_tab, ph, a);
            }
          }
          __syncthreads();
        }
      }
    }
  }
  if (s < W) {
    const T vals[NOUT] = {a.F.x, a.F.y, a.F.z, a.M.x, a.M.y,
                          a.M.z, a.V.x, a.V.y, a.V.z, T(0)};
    for (int p = 0; p < NOUT; ++p) o[(long long)p * W] = vals[p];
  }
  // block sums of the halved energies
  T u[3] = {warp_sum(T(0.5) * a.u6), warp_sum(T(0.5) * a.uX),
            warp_sum(T(0.5) * a.rf)};
  const int lane = t & 31, w = t >> 5;
  if (lane == 0)
    for (int c = 0; c < 3; ++c) red[c][w] = u[c];
  __syncthreads();
  if (t < 3) {
    T sum = T(0);
    for (int k = 0; k < TI / 32; ++k) sum += red[t][k];
    part[3 * blk + t] = sum;
  }
}

// Launch on `stream`; returns the cudaError_t of the launch.
template <typename T, typename Rows>
int launch(const void* ri, void* out, void* part, const void* tab,
           const void* terms, int ntab, int nterms, int P, Rows rows,
           int ntiles, int ny, int nz, double rc2, double rc2lj, double alpha,
           int K, void* stream) {
  const Phys<T> ph{T(rc2), T(rc2lj), T(alpha),
                   T(2.0 * alpha / 1.7724538509055160273), K, nterms};
  const size_t smem = smem_bytes(P, ntab, nterms, sizeof(T));
  auto kern = ms_kernel<T, Rows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ntiles, (unsigned)ny, (unsigned)nz);
  kern<<<grid, TI, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const T*)ri, (T*)out, (T*)part, (const T*)tab, (const int*)terms, ntab,
      P, rows, ph);
  return (int)cudaGetLastError();
}

}  // namespace msk
