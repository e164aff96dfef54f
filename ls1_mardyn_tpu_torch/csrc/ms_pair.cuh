// Device code shared by the rigid multi-site kernels K6 (ms_dense.cu,
// dense cap-padded rows) and K5 (ms_packed.cu, occupancy-packed rows):
// the seven interaction bodies of ls1's potforce.h in component form,
// the site-pair loop over one molecule pair, and the kernel skeleton.
// A kernel source adds only a row functor: where the i rows lie, which
// i tiles are live, the cell of an i slot, and for each of the 9
// (dz, dy) neighbour rows and a covering cell range [c_lo, c_hi] the j
// row, its j slot ranges for cells c_lo-1 .. c_hi+1, its image shift and
// the self-pair offset (and, for the half shell, where a j slot's
// reaction goes in the output).
//
// The function (the TPU kernels' _pair_physics,
// ls1_mardyn_tpu/ops/pallas_multisite.py:61): for every occupied i slot
// and every j molecule of the neighbour cells (the i slot itself
// excluded), the COM separation drm = r_i - (r_j + image shift); LJ site
// pairs count where |drm|^2 < rc2_lj, electrostatic ones where
// |drm|^2 < rc2 (molecule-based cutoff, as ls1).  Per slot: F, torque
// M = sum site offset x f + the orientation torques, and
// Vi = 0.5 drm (.) f; the sums of u6, uX and myRF.
//
// Two walks (the template flag HALF):
//   * the double-sided walk (K6, and K5 with explicit z halo rows): each
//     i slot meets all 9 neighbour rows, so every pair is evaluated from
//     both sides; the energy sums are halved, one partial row a block;
//   * the half shell (K5 without z halo rows, Newton's third law): each
//     in-cutoff molecule pair is evaluated once, from the i side; j gets
//     -F, the same 0.5 drm (.) f virial share as i, and its torque by the
//     pair's angular momentum balance, M_j = -(M_i + drm x F).  Each body
//     of potforce.h is a rotation-invariant pair energy, so its torques
//     sum to zero about any point: the balance equals the sum over the
//     terms of d_j x (-f) plus j's orientation torque (ls1's m2), and
//     costs 9 operations a pair and no registers in the term loop (the
//     per-term sum held 8 more there: 32 B of spills at 6 blocks an SM
//     and 8.17 ms against 7.37 on the benchmark's CO2 state, PERF.md).  The warp walks the forward rows
//     (dz, dy) = (0, +1), (+1, -1), (+1, 0), (+1, +1) whole, and the centre
//     row only for j after i in packed order plus the right wrap halo
//     (never the left one): with >= 3 cells or rows an axis that visits
//     every unordered pair once.  The energy sums are whole, one
//     partial row a warp.
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
// What bounds these kernels on this card: arithmetic throughput, and
// the latency of the shared-memory reads of the interpreted program.  A
// call tests ~27 * (molecules per cell) candidates per molecule at ~12
// operations and evaluates the site program on the ~15% inside the
// cutoff (4 LJ site pairs and a quadrupole pair, ~480 operations, for
// the 2CLJQ model).  Staged j slots feed 32 i slots each from shared
// memory, so device-memory traffic stays far below the memory roof.
// What costs is keeping the lanes of a warp busy on the site program
// (only ~15% of the candidates run it) and enough warps resident to hide
// the program's dependent shared-memory reads.
//
// Design (measured step by step on the H100, PERF.md "PR 5"):
//   * one block = one tile of TI = 128 consecutive i slots of one (z, y)
//     row (one slot a thread, 4 warps); the block stages its i slots'
//     planes and the program in shared memory, so the site program reads
//     them by plane index;
//   * warp windows: each warp takes the cells its valid slots cover,
//     [w_lo, w_hi], by a warp min/max, and walks on its own, with no block
//     barrier, the j slots of cells w_lo-1 .. w_hi+1 of the 9 neighbour
//     rows; a warp without a valid slot walks nothing.  (Staging the
//     block's window once for its 4 warps made every chunk cost the
//     slowest warp's time, and the narrower warp windows then bought
//     nothing.)
//   * staging: the warp copies its window in chunks of CH = 32 VALID j
//     slots (a ballot compacts away the empty slots of the dense rows;
//     each slot's row index rides along for the self-pair test), only
//     the planes the program reads, with the y/z image shift added once
//     (rounded, as the plain version adds it).  32 slots a chunk keep
//     the block at ~30 KB of shared memory, so registers, not shared
//     memory, set the blocks an SM holds;
//   * in-cutoff pair lists: each lane (i slot) runs the COM cutoff test
//     on every j of the chunk and appends the chunk index of each j
//     inside a cutoff to its own list in shared memory (s_list).  A warp
//     prefix sum of the list lengths flattens the 32 lists into one
//     sequence of (owner lane, j) pairs, in owner order; the warp
//     evaluates it 32 pairs at a time, each lane one pair (it finds the
//     owner by a binary search of the prefix), so every lane runs the
//     site program on a pair inside the cutoff;
//   * segmented reduction: the pairs of one owner are contiguous lanes of
//     a round, so a suffix scan of shuffles over the lanes of equal owner
//     leaves the owner's round total in the first lane of its run; the
//     owner lane fetches it by one shuffle and adds it to its F, M, Vi in
//     registers.  u6, uX and myRF go to the evaluating lane's sums (they
//     are only summed over the block or the warp).  The double-sided walk
//     has no atomics: every sum is taken in an order fixed by the inputs,
//     so its result is deterministic, and explicit halo rows reproduce
//     the wrapped result bit for bit;
//   * reactions (half shell): the lanes of a round that hold the same j
//     are grouped by __match_any_sync; the group's lowest lane gathers
//     the others' 9 sums by shuffles and adds them with plain adds to the
//     warp's reaction row [9][CH] of the chunk in shared memory (one
//     writer per j a round, no shared-memory atomics: on sm_90 a float
//     atomicAdd there is a compare-and-swap loop).  At the chunk's end
//     the warp adds its row to the output by global float atomics (a
//     native reduction), skipping zeros; the i sums reach the output the
//     same way at the end, so the output is zeroed before the launch and
//     its last bits vary from run to run;
//   * |drm|^2 is formed exactly as the plain PyTorch versions form it,
//     ((dx*dx + dy*dy) + dz*dz) with no FMA contraction, in the test and
//     again in the evaluation, so both put every pair on the same side of
//     the cutoff (unshifted charge terms jump at rc);
//   * site arithmetic: one reciprocal square root per site pair gives
//     invd = 1/|dr| and inv = invd^2 for every body, where the IEEE forms
//     took a division and a square root (inv = 1/r2 within 0.5 ulp, invd
//     = sqrt(inv) within 1).  In f32, rsqrtf (within 2 ulp) and one Newton
//     step on the residual 1 - r2 y^2 taken with an FMA: invd within ~1
//     ulp, inv within ~2.5.  rsqrtf alone biased the quadrupole energy
//     sum of the full-width 2CLJQ state (5.0e-4 of it against the plain
//     version, where the IEEE forms gave 2.5e-4 and the Newton step 1.7e-4;
//     that sum nearly cancels).  In f64, rsqrt (within 1 ulp), inv within
//     2.5.  exp and erfc of the screened charge pair are libdevice's; no
//     fast-math build;
//   * registers: __launch_bounds__ asks for 6 blocks an SM in f32 (ptxas:
//     80 registers, no spills, both walks); f64 takes what it needs.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace msk {

constexpr int TI = 128;       // i slots per block
constexpr int NW = TI / 32;   // warps per block
constexpr int CH = 32;        // j slots per chunk a warp stages
constexpr int LSTR = CH + 4;  // bytes per lane list (the pad spreads banks)
constexpr int MIN_BLOCKS_F32 = 6;  // f32 blocks an SM holds (<= 85 registers)
constexpr int NOUT = 10;      // F, M, Vi, (zero)
constexpr int TERM_INTS = 10; // body, pi, pj, ei, ej, c0, c1, c2, stride, pad
constexpr int NO_SELF = INT_MIN / 2;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CH <= 256, "list entries are bytes");

enum Body : int { LJ = 0, CC, CQ, CD, QC, QQ, QD, DC, DQ, DD };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int to_int(float a) { return __float2int_rn(a); }
__device__ __forceinline__ int to_int(double a) { return __double2int_rn(a); }
// rsqrtf (within 2 ulp) and one Newton step on the residual 1 - a y^2,
// taken with an FMA (see the design notes above)
__device__ __forceinline__ float rsq(float a) {
  const float y = rsqrtf(a);
  const float r = __fmaf_rn(-a * y, y, 1.0f);
  return __fmaf_rn(0.5f * y, r, y);
}
__device__ __forceinline__ double rsq(double a) { return rsqrt(a); }

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
// the JAX package); invd = 1 / |dr|, inv = invd^2 -------------------------

// charge (role i) -- quadrupole (role j, orientation ej): f on the
// charge, m2 the torque on the quadrupole
template <typename T>
__device__ __forceinline__ void charge_quad(V3<T> dr, T invd, T inv, V3<T> ej,
                                            T qQ05, V3<T>& f, V3<T>& m2, T& u) {
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
__device__ __forceinline__ void charge_dip(V3<T> dr, T invd, T inv, V3<T> ej,
                                           T mqmy, V3<T>& f, V3<T>& m2, T& u) {
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
__device__ __forceinline__ void dip_dip(V3<T> dr, T invd, T inv, V3<T> ei,
                                        V3<T> ej, T my2, T rffac, V3<T>& f,
                                        V3<T>& m1, T& u, T& rf) {
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
__device__ __forceinline__ void dip_quad(V3<T> dr, T invd, T inv, V3<T> ei,
                                         V3<T> ej, T myq15, V3<T>& f,
                                         V3<T>& m1, V3<T>& m2, T& u) {
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
__device__ __forceinline__ void quad_quad(V3<T> dr, T invd, T inv, V3<T> ei,
                                          V3<T> ej, T q2075, V3<T>& f,
                                          V3<T>& m1, T& u) {
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

// Sums of one molecule pair: F, M, Vi on i, (half shell) the torque Mj
// on j, and the unhalved energies.
template <typename T>
struct Acc {
  V3<T> F{T(0), T(0), T(0)}, M{T(0), T(0), T(0)}, V{T(0), T(0), T(0)};
  V3<T> Mj{T(0), T(0), T(0)};
  T u6 = T(0), uX = T(0), rf = T(0);
};

// The physical constants of a launch.
template <typename T>
struct Phys {
  T rc2, rc2lj, alpha, tap;  // tap = 2 alpha / sqrt(pi)
  int K, nterms;
};

// The COM separation of i (planes at si, stride TI) and j (at sj,
// stride CH) and its square, rounded as the plain versions round it.
template <typename T>
__device__ __forceinline__ T com_sep(const T* si, const T* sj, V3<T>& drm) {
  drm = {si[0] - sj[0], si[TI] - sj[CH], si[2 * TI] - sj[2 * CH]};
  return add_rn(add_rn(mul_rn(drm.x, drm.x), mul_rn(drm.y, drm.y)),
                mul_rn(drm.z, drm.z));
}

// Every term of the site-pair program for the ordered molecule pair
// (i, j): si points at the i slot's plane 0 in shared memory (plane
// stride TI), sj at the j slot's (plane stride CH); kk = ci*K + cj.
// With HALF also j's torque, by the pair's angular momentum balance.
template <bool HALF, typename T>
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
    const T r2 = dot(dr, dr);
    const T invd = rsq(r2);
    const T inv = invd * invd;
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
        T fac;
        if (ph.alpha > T(0)) {
          const T e = exp(-(ph.alpha * ph.alpha) * r2);
          u = c0 * erfc(ph.alpha * (r2 * invd)) * invd;
          fac = (u + c0 * ph.tap * e) * inv;
        } else {
          u = c0 * invd;
          fac = u * inv;
        }
        f = fac * dr;
        break;
      }
      case CQ:
        charge_quad(dr, invd, inv, ej, c0, f, m2, u);
        break;
      case CD:
        charge_dip(dr, invd, inv, ej, c0, f, m2, u);
        break;
      case QC:  // dr = charge_j - quad_i; i gets -f and the quad torque
        charge_quad(-dr, invd, inv, ei, c0, f, m, u);
        f = -f;
        break;
      case QQ:
        quad_quad(dr, invd, inv, ei, ej, c0, f, m, u);
        break;
      case QD:  // dr = dip_j - quad_i; i gets -f and the quad torque
        dip_quad(-dr, invd, inv, ej, ei, c0, f, m2, m, u);
        f = -f;
        break;
      case DC:  // dr = charge_j - dip_i; i gets -f and the dipole torque
        charge_dip(-dr, invd, inv, ei, c0, f, m, u);
        f = -f;
        break;
      case DQ:
        dip_quad(dr, invd, inv, ei, ej, c0, f, m, m2, u);
        break;
      default: {  // DD
        T rf;
        dip_dip(dr, invd, inv, ei, ej, c0, tab[tm[6] + kk * tm[8]], f, m, u, rf);
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
  if constexpr (HALF) a.Mj = -(a.M + cross(drm, a.F));  // j's torque
}

// What a row functor returns for neighbour row (dz, dy) and a covering
// cell range: the j row's plane 0, its plane stride, up to two j slot
// ranges [a0, a1) and [b0, b1) (cells c_lo-1 .. c_hi+1), the image shift
// of its y and z, and the self-pair offset (j == i + self_off on the
// centre row; NO_SELF elsewhere).  A slot of a range may be empty
// (valid plane 0).  A functor that takes the half shell also answers
// j_out(z, y, dz, dy, q): the output offset (plane 0) of j slot q of
// that row, where its reactions go.
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// The 9 per-slot sums of a pair as one array (the reduction's payload).
template <typename T>
__device__ __forceinline__ void unpack9(const Acc<T>& a, T* v) {
  v[0] = a.F.x; v[1] = a.F.y; v[2] = a.F.z;
  v[3] = a.M.x; v[4] = a.M.y; v[5] = a.M.z;
  v[6] = a.V.x; v[7] = a.V.y; v[8] = a.V.z;
}

// One warp's staged chunk of n valid j slots (row indices jidx) against
// its 32 i slots.  Test, list, then the flattened list 32 pairs at a
// time; own[9] are this lane's slot sums, e[3] its energy sums.  The
// double-sided walk skips jidx == self_j (the self pair); the half shell
// skips jidx <= self_j (j not after i on the centre row; INT_MIN
// elsewhere) and adds each pair's reaction to the warp's reaction row
// react[9][CH] of the chunk.
template <bool HALF, typename T>
__device__ __forceinline__ void warp_chunk(
    const T* s_i, const T* s_j, const int* jidx, unsigned char* s_list,
    const int* s_terms, const T* s_tab, const Phys<T>& ph, int n, int self_j,
    bool vi, T* own, T* e, T* react) {
  const int t = threadIdx.x, lane = t & 31, w0 = t - lane;
  unsigned char* mine = s_list + t * LSTR;
  int cnt = 0;
  if (vi) {
    const T* si = s_i + t;
    for (int q = 0; q < n; ++q) {
      if (HALF ? jidx[q] <= self_j : jidx[q] == self_j) continue;
      V3<T> drm;
      const T com2 = com_sep(si, s_j + q, drm);
      if (com2 < ph.rc2lj || com2 < ph.rc2) mine[cnt++] = (unsigned char)q;
    }
  }
  __syncwarp();  // the lists are read by other lanes
  // exclusive prefix of the list lengths over the warp, and the total
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - cnt;
  const int total = __shfl_sync(FULL, incl, 31);
  for (int r0 = 0; r0 < total; r0 += 32) {
    const int f = r0 + lane;
    // owner: the last lane whose list starts at or before f
    int o = 0, eo = 0;
    for (int st = 16; st > 0; st >>= 1) {
      const int ex = __shfl_sync(FULL, excl, o + st);
      if (ex <= f) {
        o += st;
        eo = ex;
      }
    }
    const bool act = f < total;
    T v[9];
    Acc<T> a;
    int q = 0;
    if (act) {
      q = s_list[(w0 + o) * LSTR + (f - eo)];
      const T* si = s_i + w0 + o;
      const T* sj = s_j + q;
      V3<T> drm;
      const T com2 = com_sep(si, sj, drm);
      const int kk = to_int(si[4 * TI]) * ph.K + to_int(sj[4 * CH]);
      molecule_pair<HALF>(si, sj, drm, com2 < ph.rc2lj, com2 < ph.rc2, kk,
                          s_terms, s_tab, ph, a);
      e[0] += a.u6;
      e[1] += a.uX;
      e[2] += a.rf;
    }
    if constexpr (HALF) {
      // j's reaction: -F, its torque, the same virial share
      T rj[9] = {-a.F.x, -a.F.y, -a.F.z, a.Mj.x, a.Mj.y, a.Mj.z,
                 a.V.x, a.V.y, a.V.z};
      // the lanes that hold the same j (an inactive lane is a group of
      // its own); the lowest gathers the others' sums
      const unsigned grp = __match_any_sync(FULL, act ? q : CH + lane);
      const bool lead = act && (grp & ((1u << lane) - 1u)) == 0u;
      unsigned rest = lead ? grp & (grp - 1u) : 0u;
      while (__any_sync(FULL, rest != 0u)) {
        const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const T x = __shfl_sync(FULL, rj[k], src);
          if (rest) rj[k] += x;
        }
        rest &= rest - 1u;
      }
      if (lead)
#pragma unroll
        for (int k = 0; k < 9; ++k) react[k * CH + q] += rj[k];
      __syncwarp();  // the next round's leader of this j reads the sum
    }
    unpack9(a, v);
    // suffix sums over the run of lanes of one owner (inactive: owner 32)
    const int ow = act ? o : 32;
    for (int st = 1; st < 32; st <<= 1) {
      const int on = __shfl_down_sync(FULL, ow, st);
      const bool add = lane + st < 32 && on == ow;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T x = __shfl_down_sync(FULL, v[k], st);
        if (add) v[k] += x;
      }
    }
    // this lane's run in the round starts at max(excl, r0) - r0
    const bool has = cnt > 0 && excl < r0 + 32 && incl > r0;
    const int head = has ? max(excl, r0) - r0 : 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T x = __shfl_sync(FULL, v[k], head);
      if (has) own[k] += x;
    }
  }
}

// Shared memory of a block: the flat tables, the i planes [P][TI], the
// warps' j chunks [NW][P][CH], the program, then the lane lists
// [TI][LSTR].
inline size_t smem_bytes(int P, int ntab, int nterms, size_t elem) {
  const size_t ntab_pad = (size_t)((ntab + 1) / 2 * 2);
  return (ntab_pad + (size_t)P * (TI + NW * CH)) * elem +
         (size_t)nterms * TERM_INTS * sizeof(int) + (size_t)TI * LSTR;
}

// Forces of the i tile blockIdx.x of row (blockIdx.z, blockIdx.y):
// ri / out are [nz, ny, P | NOUT, W].  The double-sided walk writes out
// and part[block][3], the halved energy sums; the half shell adds to out,
// which the caller zeroed, and writes part[block * NW + warp][3], the
// whole sums of each warp's pairs.
template <typename T, bool HALF, typename Rows>
__global__ void __launch_bounds__(TI, sizeof(T) == 4 ? MIN_BLOCKS_F32 : 1)
ms_kernel(const T* __restrict__ ri, T* __restrict__ out, T* __restrict__ part,
          const T* __restrict__ tab_g, const int* __restrict__ terms_g,
          int ntab, int P, Rows rows, Phys<T> ph) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_tab = reinterpret_cast<T*>(smem_raw);
  T* s_i = s_tab + (ntab + 1) / 2 * 2;
  T* s_j = s_i + (size_t)P * TI;
  int* s_terms = reinterpret_cast<int*>(s_j + (size_t)NW * P * CH);
  unsigned char* s_list =
      reinterpret_cast<unsigned char*>(s_terms + ph.nterms * TERM_INTS);
  __shared__ int s_jidx[NW][CH];
  __shared__ T red[3][NW];
  // the warps' reaction rows [9][CH] (half shell)
  __shared__ T s_react[HALF ? NW * 9 * CH : 1];

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tile = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  const long long blk = ((long long)z * gridDim.y + y) * gridDim.x + tile;
  const int W = rows.W;
  const long long row = (long long)z * rows.ny + y;
  const int s = tile * TI + t;
  T* o = out + row * NOUT * W + s;

  if (!rows.tile_live(z, y, tile)) {  // uniform over the block
    if constexpr (HALF) {
      if (t < 3 * NW) part[3 * NW * blk + t] = T(0);
    } else {
      if (s < W)
        for (int p = 0; p < NOUT; ++p) o[(long long)p * W] = T(0);
      if (t < 3) part[3 * blk + t] = T(0);
    }
    return;
  }
  for (int k = t; k < ntab; k += TI) s_tab[k] = tab_g[k];
  for (int k = t; k < ph.nterms * TERM_INTS; k += TI) s_terms[k] = terms_g[k];
  const T* pi_g = ri + row * P * W + s;
  for (int p = 0; p < P; ++p) s_i[p * TI + t] = s < W ? pi_g[(long long)p * W] : T(0);
  __syncthreads();
  // the j planes the test and the program read: x y z valid cid, and the
  // j site offsets and orientations of the terms
  int pj_end = 5;
  for (int k = 0; k < ph.nterms; ++k) {
    const int* tm = s_terms + k * TERM_INTS;
    pj_end = max(pj_end, max(tm[2], tm[4]) + 3);
  }
  const bool vi = s < W && s_i[3 * TI + t] > T(0.5);
  const int c = vi ? rows.i_cell(s_i + t, s) : 0;
  // the warp's covering cells
  const int w_lo = __reduce_min_sync(FULL, vi ? c : INT_MAX);
  const int w_hi = __reduce_max_sync(FULL, vi ? c : INT_MIN);

  T own[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T e[3] = {T(0), T(0), T(0)};
  T* s_jw = s_j + (size_t)w * P * CH;
  T* react = s_react + (HALF ? w * 9 * CH : 0);
  if (w_lo <= w_hi) {  // uniform over the warp: it holds a valid slot
    int s_first = 0;
    if constexpr (HALF) {
      s_first = __reduce_min_sync(FULL, vi ? s : INT_MAX);
#pragma unroll
      for (int k = 0; k < 9; ++k) react[k * CH + lane] = T(0);
    }
    // the half shell: the centre row (k = 4) and the forward rows 5..8
    for (int k = HALF ? 4 : 0; k < 9; ++k) {
      const int dz = k / 3 - 1, dy = k % 3 - 1;
      const JRow<T> jr = rows.row(z, y, dz, dy, w_lo, w_hi);
      for (int r = 0; r < 2; ++r) {
        const int j1 = r ? jr.b1 : jr.a1;
        int src = r ? jr.b0 : jr.a0;
        int self_j = s + jr.self_off;
        if constexpr (HALF) {
          // centre row: the row part after the warp's first i (the left
          // wrap halo lies before it), j after i; the right wrap halo whole
          const bool centre = jr.self_off != NO_SELF && r == 0;
          if (centre) src = max(src, s_first + jr.self_off + 1);
          self_j = centre ? s + jr.self_off : INT_MIN;
        }
        while (src < j1) {  // uniform over the warp
          // stage the next (up to) CH valid j slots from src on, compacted
          __syncwarp();  // the last chunk is read
          int n = 0;
          while (n < CH && src < j1) {
            const int q = src + lane;
            const bool ok = q < j1 && jr.p[3 * jr.stride + q] > T(0.5);
            const unsigned m = __ballot_sync(FULL, ok);
            const int rank = __popc(m & ((1u << lane) - 1));
            const int take = min(__popc(m), CH - n);
            if (ok && rank < take) {
              T* d = s_jw + n + rank;
              for (int p = 0; p < pj_end; ++p) {
                T v = jr.p[(long long)p * jr.stride + q];
                if (p == 1) v = add_rn(v, jr.sy);
                if (p == 2) v = add_rn(v, jr.sz);
                d[p * CH] = v;
              }
              s_jidx[w][n + rank] = q;
            }
            // the first valid slot that did not fit starts the next chunk
            const unsigned rest = __ballot_sync(FULL, ok && rank == take);
            src = rest ? src + __ffs(rest) - 1 : src + 32;
            n += take;
          }
          __syncwarp();
          warp_chunk<HALF>(s_i, s_jw, s_jidx[w], s_list, s_terms, s_tab, ph,
                           n, self_j, vi, own, e, react);
          if constexpr (HALF) {  // the chunk's reactions to the output
            if (lane < n) {
              T* oj = out + rows.j_out(z, y, dz, dy, s_jidx[w][lane]);
#pragma unroll
              for (int p = 0; p < 9; ++p) {
                const T v = react[p * CH + lane];
                if (v != T(0)) atomicAdd(oj + (long long)p * W, v);
                react[p * CH + lane] = T(0);
              }
            }
          }
        }
      }
    }
    if constexpr (HALF) {
      // the i sums, and this warp's row of part
#pragma unroll
      for (int p = 0; p < 9; ++p)
        if (own[p] != T(0)) atomicAdd(o + (long long)p * W, own[p]);
      const T u[3] = {warp_sum(e[0]), warp_sum(e[1]), warp_sum(e[2])};
      if (lane == 0)  // warp_sum leaves the total in lane 0
        for (int c2 = 0; c2 < 3; ++c2) part[3 * (NW * blk + w) + c2] = u[c2];
    }
  } else if constexpr (HALF) {
    if (lane < 3) part[3 * (NW * blk + w) + lane] = T(0);
  }
  if constexpr (!HALF) {
    if (s < W) {
#pragma unroll
      for (int p = 0; p < 9; ++p) o[(long long)p * W] = own[p];
      o[9LL * W] = T(0);
    }
    // block sums of the halved energies
    T u[3] = {warp_sum(T(0.5) * e[0]), warp_sum(T(0.5) * e[1]),
              warp_sum(T(0.5) * e[2])};
    if (lane == 0)
      for (int c2 = 0; c2 < 3; ++c2) red[c2][w] = u[c2];
    __syncthreads();
    if (t < 3) {
      T sum = T(0);
      for (int k = 0; k < NW; ++k) sum += red[t][k];
      part[3 * blk + t] = sum;
    }
  }
}

// Launch on `stream`; returns the cudaError_t of the launch.
template <typename T, bool HALF = false, typename Rows>
int launch(const void* ri, void* out, void* part, const void* tab,
           const void* terms, int ntab, int nterms, int P, Rows rows,
           int ntiles, int ny, int nz, double rc2, double rc2lj, double alpha,
           int K, void* stream) {
  const Phys<T> ph{T(rc2), T(rc2lj), T(alpha),
                   T(2.0 * alpha / 1.7724538509055160273), K, nterms};
  const size_t smem = smem_bytes(P, ntab, nterms, sizeof(T));
  auto kern = ms_kernel<T, HALF, Rows>;
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
