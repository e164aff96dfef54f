// Warp-level skeleton of the 1CLJ cell kernels K1 (lj_cells.cu), K3
// (lj_cells_cw.cu), K4 (lj_cells_row.cu), K7 (lj_cells_lanej.cu), K8
// (lj_cells_n3l.cu) and K9 (lj_cells_zb.cu): one warp owns 32 slots of
// one i cell, stages the j slots of its neighbour cells itself, keeps
// only those that can hold a pair inside the cutoff, and walks the kept
// slots.  The pair term, the rounding helpers, the neighbour functor of
// the cell-local layouts (ljk::LocalNbr) and the per-block reduction of
// u6 and the virial are lj_pair.cuh's; this header adds the neighbour
// functor of K4's and K7's j view (RowNbr).  A kernel source picks its
// neighbour functor (where the j slots of the cell at offset (dx, dy, dz)
// lie, and their image shift) and adds its extern "C" entry points.  K4,
// K7 and K9 walk all 27 neighbour cells and evaluate each pair from both
// sides (warp_cells_kernel), as K3 does where its inputs rule out the
// half shell.  K1 and K8 evaluate each pair once, by Newton's third law
// on the half shell: one kernel body, half_shell, at the end of this
// header, under two names; K3's wrapper launches K1's where its j source
// is its own layout, with no halo rows, three cells or more an axis and
// no Vi.  K10
// (lj_packed.cu, the half shell on packed pencils) has a kernel of its
// own built from the pieces here: warp_min/warp_max and gap for its box
// cull, the reactions' register rotation (rotate), the skewed last round
// (walk_skewed) and its flush.
//
// What bounded the block skeleton this replaced (one block of 128/cap
// cells, one thread an i slot, each neighbour cell staged in shared
// memory between two block barriers): dead pair lanes.  It ran every i
// slot against every one of the 27 * cap staged j slots, empty ones and
// ones no i of the cell can reach, and the LJ body was taken by some
// lane of nearly every warp iteration, so every lane paid the whole
// pair.  On K1's main state (grid (56,60,60), cap 32, 20.8 molecules a
// cell) 42% of the lanes were pairs of two occupied slots and 3.9% pairs
// inside the cutoff; on K3's (69,69,69), 12.8 a cell, 16% were occupied.
// The kernel was bound by instruction throughput on those lanes, behind
// 54 block barriers a block.
//
// Design:
//   * a warp is one 32-slot chunk of one i cell (cap 64: two warps a
//     cell); a block is WARPS warps of consecutive chunks, i.e. of
//     consecutive x cells (K9: consecutive y rows, warp_cell), so
//     neighbour rows are shared through L1.  No
//     block barrier until the block reduction at the end: a warp meets
//     its lanes at __syncwarp only;
//   * i compaction: the valid i slots of the chunk move to the low lanes
//     (through the warp's staging buffer).  With n_i <= 16 the warp runs
//     as two half-warps that hold the same i slots and take alternate
//     kept j slots; one shuffle adds the halves' force sums, in a fixed
//     order, so the result stays deterministic.  u6 and the virial need
//     no shuffle: the block reduction adds every lane;
//   * box culling while staging: the warp forms the bounding box of its
//     valid i slots; each lane loads one j slot, adds the image shift
//     (rounded once, as the plain version does), and keeps it if it is
//     valid and its box distance boxdist2 < rc^2.  Kept slots go to a
//     per-warp ring of RING entries, written contiguously after a ballot
//     and a popc prefix; whenever 32 are waiting the warp walks them;
//   * exactness of the cull: boxdist2 = norm2(gx, gy, gz) of the
//     per-axis gaps g = max(lo - x, x - hi, 0), formed with the same
//     round-to-nearest operations as r^2.  For an i in the box,
//     lo <= x_i <= hi, so x_i - x_j >= lo - x_j (and <= hi - x_j);
//     rounding to nearest is monotone and odd, so |fl(x_i - x_j)| >= g,
//     fl(dx^2) >= fl(g^2), and the two rounded sums keep the order:
//     fl(boxdist2) <= fl(r^2) for every i of the box.  A culled j
//     therefore held no pair inside the cutoff: no margin is needed and
//     no pair is dropped.  Nothing here depends on the size of the
//     coordinates, so the cull is as exact in K4's absolute mode;
//   * the own-cell pair of a slot with itself is skipped by slot id (the
//     fourth word of a staged entry), as in the plain version, not by
//     r^2 = 0;
//   * r^2 rounded as in the plain PyTorch versions (no FMA contraction),
//     IEEE division for 1/r^2; every output slot is written (0 where
//     invalid), since the wrapper allocates the forces with torch.empty.
//
// The Gram form (K9's gram mode, GRAM): r^2 = (s_j + s_i) - (c + c) with
// s = |r|^2 and c = r_i.r_j, each a norm2-ordered sum, in the order of
// the plain version, so both take the same side of the cutoff.  s_j is
// formed once, at staging, into a second J4 of the ring entry (J4 has
// no free word).  The force F_i = r_i * sum fac - sum fac * r_j is summed
// as sum fac * (r_i - r_j), the same function without the cancellation
// of its two terms: on dense f32 scenes that cancellation moves the
// plain version itself by ~1e-5 of max|F| with the order of its sums
// (PERF.md).  The Gram cull needs a margin, because the Gram r^2 is
// formed by cancellation and can come out below the true distance.
// With u the unit roundoff (2^-24 in f32, 2^-53 in f64), S = s_i + s_j
// exact, and gamma_3 = 3u to first order:
//   * |fl(s) - s| <= gamma_3 s (nonnegative terms) and
//     |fl(c) - c| <= gamma_3 sum |x_i x_j| <= gamma_3 S / 2;
//   * a = fl(s_j + s_i) is within 4u S of S; c + c is exact;
//   * fl(a - 2c) = (a - 2c)(1 + d), |d| <= u, |a - 2c| <= 2S (1 + 4u);
//   so |gram r^2 - r^2| <= (4 + 3 + 2) u S = 9u S to first order.  The
//   true r^2 of any i of the box is >= the exact box distance B*, and
//   the rounded B >= T keeps B* >= T (1 + u)^-5 (five roundings, each
//   monotone).  The cull keeps j iff B < T = fl(rc^2 + kappa *
//   fl(smax + s_j)), smax the largest fl(s_i) of the warp's valid i and
//   kappa = 64u (a power of two: the product is exact).  Since
//   fl(smax + s_j) >= S (1 - 4u) for every i of the box, a culled j has
//   B* >= rc^2 (1 - 6u) + kappa S (1 - 10u), so r^2 >= rc^2 (1 - 6u) and
//   S >= r^2 / 2 (|a - b|^2 <= 2 |a|^2 + 2 |b|^2), hence 6u rc^2 <= 13u S
//   and B* >= rc^2 + (64 - 13 - 1) u S; its Gram r^2 is then >= rc^2 +
//   41u S > rc^2 for every i of the box: no pair of the plain Gram
//   version is dropped.  At cell-local coordinates (S <= ~130 at
//   cell edge 2.9) the margin is <= 5e-4 in f32 against rc^2 = 6.25.
//
// What bounds it now (H100, PERF.md): the walk.  By the full shell, on
// the first round's dense state (cap 32) a warp walks 283 j iterations
// (864 before), on K3's 113; each costs ~14 SM cycles, about 40
// instructions at the full instruction rate, and the time follows the
// resident warps: the compiler's 56 registers (f32) beat budgets of
// 67-86 by 12%.  The walk of a full ring must unroll completely (WAYS a
// compile-time constant): a runtime stride or `#pragma unroll 1` cost
// 4-20%.  Testing a ring first and running the pair terms on the hits
// only (per-lane bit masks) was slower on both states.  By the half
// shell (K1, K8), half the j iterations at ~1.4x the cost each: on the
// benchmark's argon state (grid (36,36,36), cap 128, ~90 molecules a
// cell, rc 5.15) a warp walks 629 j iterations against 1,236 by the full
// shell, and K1 takes 6.41 ms against 8.91 (2.51 against 3.08 on the
// dense state); the reactions' three shuffles a step cost ~2% and the
// global atomics ~1.5%, the rest is the pair term, the entries'
// shuffles and the 61 registers (f32), eight blocks an SM against the
// full shell's nine.  On the general path's grid of the same state
// ((41,41,41), cap 128, ~61 a cell) K3's half shell walks 519 j
// iterations a warp against 1,016 and takes 6.05-6.07 ms (6.60 with u6
// and the virial) where the full shell takes 8.32-8.34 (11.79).

#pragma once

#include "lj_pair.cuh"

namespace ljw {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps a block (8 measured the same)
constexpr int RING = 64;  // staged j entries a warp: 32 walked + 31 waiting

// A staged slot: r_j + shift, and the slot id in the own cell (-1 in any
// other neighbour cell).
template <typename T>
struct alignas(4 * sizeof(T)) J4 {
  T x, y, z, w;
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(FULL, v, o);
    v = u < v ? u : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// distance of x from [lo, hi] along one axis, rounded as r^2's terms
template <typename T>
__device__ __forceinline__ T gap(T x, T lo, T hi) {
  const T a = ljk::sub_rn(lo, x);
  const T b = ljk::sub_rn(x, hi);
  return a > T(0) ? a : (b > T(0) ? b : T(0));
}

// Number of blocks of a launch (rows of the part[., 2] buffer), in K1's
// order or the band order (warp_cell).
inline int num_blocks(int nx, int ny, int nz, int cap, bool band = false) {
  const int nch = cap / 32;
  if (band && WARPS % nch == 0) {
    const int rows = WARPS / nch;
    return nx * ((ny + rows - 1) / rows) * nz;
  }
  const long long warps = (long long)nx * ny * nz * nch;
  return (int)((warps + WARPS - 1) / WARPS);
}

// The i cell (cx, cy, cz) and 32-slot chunk of this warp; false past the
// grid.  K1's order: a block is WARPS consecutive chunks, i.e. consecutive
// x cells of one row.  The band order (BAND, K9): a block is the chunks of
// WARPS / nch consecutive y rows of one x cell and z plane, and blocks run
// along x; where nch does not divide WARPS, K1's order.
template <bool BAND>
__device__ __forceinline__ bool warp_cell(const ljk::Grid& gd, int& cx, int& cy,
                                          int& cz, int& ch) {
  const int nch = gd.cap >> 5, w = threadIdx.x >> 5;
  if (BAND && WARPS % nch == 0) {
    const int rows = WARPS / nch, nyb = (gd.ny + rows - 1) / rows;
    cx = (int)(blockIdx.x % gd.nx);
    const int q = (int)(blockIdx.x / gd.nx);
    cy = (q % nyb) * rows + w / nch;
    cz = q / nyb;
    ch = w % nch;
    return cy < gd.ny && cz < gd.nz;
  }
  const long long gw = (long long)blockIdx.x * WARPS + w;
  const long long cell = gw / nch;
  cx = (int)(cell % gd.nx);
  const long long q = cell / gd.nx;
  cy = (int)(q % gd.ny);
  cz = (int)(q / gd.ny);
  ch = (int)(gw - cell * nch);
  return cell < (long long)gd.nx * gd.ny * gd.nz;
}

// The i side of a warp: its valid slots compacted to the low lanes (and
// to lanes 16.. when the warp is split), their bounding box, and the
// largest s_i of the Gram form.
template <typename T>
struct IChunk {
  J4<T> me;    // this lane's i: r_i and its slot id
  T si, smax;  // s_i of me and the largest s_i (Gram form; else 0)
  T lox, hix, loy, hiy, loz, hiz;
  int first;   // the lane of the first valid slot
  int ways;    // 2: two half-warps on alternate j slots (n_i <= 16)
  bool live;   // this lane holds a valid i

  // box distance of a staged j from the valid i, rounded as r^2
  __device__ __forceinline__ T boxdist2(T x, T y, T z) const {
    return ljk::norm2(gap(x, lox, hix), gap(y, loy, hiy), gap(z, loz, hiz));
  }
};

// The i chunk of the slots p[0], p[W], p[2 * W] (this lane's slot s, vi
// its validity, vmask the ballot of vi, ni = popc(vmask) > 0, rank the
// valid slots below this lane), compacted through the warp's ring (EW
// J4 words an entry).
template <typename T, bool GRAM, int EW>
__device__ __forceinline__ IChunk<T> i_chunk(const T* p, long long W, int s,
                                             bool vi, unsigned vmask, int ni,
                                             int rank, J4<T>* ring) {
  IChunk<T> c;
  const int lane = threadIdx.x & 31;
  const T xi = p[0], yi = p[W], zi = p[2 * W];
  // the bounding box of the valid i (an invalid lane stands in with the
  // first valid one)
  c.first = __ffs((int)vmask) - 1;
  const T x0 = __shfl_sync(FULL, xi, c.first);
  const T y0 = __shfl_sync(FULL, yi, c.first);
  const T z0 = __shfl_sync(FULL, zi, c.first);
  c.lox = warp_min(vi ? xi : x0);
  c.hix = warp_max(vi ? xi : x0);
  c.loy = warp_min(vi ? yi : y0);
  c.hiy = warp_max(vi ? yi : y0);
  c.loz = warp_min(vi ? zi : z0);
  c.hiz = warp_max(vi ? zi : z0);
  // the largest s_i of the valid i (Gram cull margin; s >= 0)
  c.smax = GRAM ? warp_max(vi ? ljk::norm2(xi, yi, zi) : T(0)) : T(0);
  // i compaction: valid slot of rank k -> lane k (and k + 16 when the
  // warp is split)
  if (vi) ring[EW * rank] = J4<T>{xi, yi, zi, T(s)};
  __syncwarp();
  c.ways = ni <= 16 ? 2 : 1;
  const int k = c.ways == 2 ? (lane & 15) : lane;
  c.live = k < ni;
  c.me = ring[EW * (c.live ? k : 0)];
  c.si = GRAM ? ljk::norm2(c.me.x, c.me.y, c.me.z) : T(0);
  __syncwarp();
  return c;
}

// The neighbour cells of K4's and K7's j view r_j[nz(+2), ny(+2), 4,
// (nx+2*hx)*cap] (hx halo cells per side in x; with zhalo / yhalo one
// explicit halo row per side in z / y).  local: cell-local coordinates,
// the cell at offset (dx, dy, dz) shifted by (dx*ux, dy*uy, dz*uz);
// otherwise absolute coordinates, the x halo pre-shifted by the caller,
// and -+uy / -+uz added to a j row whose row index wrapped.
template <typename T>
struct RowNbr {
  const T* rj;
  int nx, ny, nz, cap, hx, local, zhalo, yhalo;
  T ux, uy, uz;
  __device__ __forceinline__ ljk::Stage<T> operator()(int cx, int cy, int cz,
                                                      int dx, int dy,
                                                      int dz) const {
    const long long Wj = (long long)(nx + 2 * hx) * cap;
    const int nyj = yhalo ? ny + 2 : ny;
    const int zr = cz + dz, yr = cy + dy;
    const int jz = zhalo ? zr + 1 : ljk::wrap(zr, nz);
    const int jy = yhalo ? yr + 1 : ljk::wrap(yr, ny);
    const int jx = cx + hx + dx;
    // image shift in units of (ux, uy, uz): the cell edges in local
    // mode; (0, by, bz) where a row index wrapped in absolute mode
    int mx = dx, my = dy, mz = dz;
    if (!local) {
      mx = 0;
      my = yhalo ? 0 : (yr < 0 ? -1 : (yr >= ny ? 1 : 0));
      mz = zhalo ? 0 : (zr < 0 ? -1 : (zr >= nz ? 1 : 0));
    }
    return {rj + ((long long)jz * nyj + jy) * 4 * Wj + (long long)jx * cap, Wj,
            T(mx) * ux, T(my) * uy, T(mz) * uz};
  }
};

// A force sum of the slot of this lane: with the warp split, the two
// halves' partial sums added (the same total in both halves), then taken
// from compacted lane `rank`; 0 for an invalid slot.
template <typename T>
__device__ __forceinline__ T to_slot(T v, int ways, int rank, bool valid) {
  if (ways == 2) v += __shfl_xor_sync(FULL, v, 16);
  v = __shfl_sync(FULL, v, rank);
  return valid ? v : T(0);
}

// kappa of the Gram form's cull margin (see above): 64u, 2^-18 in f32
// and 2^-47 in f64
template <typename T>
__device__ __forceinline__ T gram_kappa() {
  if constexpr (sizeof(T) == 4) {
    return T(0x1p-18);
  } else {
    return T(0x1p-47);
  }
}

// The pair of i `me` (s_i = si in the Gram form) and a staged j (s_j =
// sj): its terms added to `a` if it lies inside the cutoff and is not
// the slot with itself.  The Gram form differs only in how r^2 is
// formed; the force is fac * (r_i - r_j) in both.
template <typename T, bool MACRO, bool VI, bool GRAM>
__device__ __forceinline__ void pair(const J4<T>& me, T si, const J4<T>& j, T sj,
                                     const ljk::LJ<T>& lj, ljk::Acc<T>& a) {
  using ljk::add_rn;
  using ljk::mul_rn;
  const T ddx = me.x - j.x;
  const T ddy = me.y - j.y;
  const T ddz = me.z - j.z;
  T dr2;
  if constexpr (GRAM) {
    const T c = add_rn(add_rn(mul_rn(me.x, j.x), mul_rn(me.y, j.y)),
                       mul_rn(me.z, j.z));
    dr2 = ljk::sub_rn(add_rn(sj, si), add_rn(c, c));
  } else {
    dr2 = ljk::norm2(ddx, ddy, ddz);
  }
  if (dr2 < lj.rc2 && j.w != me.w) {
    T fac, u6;
    ljk::lj_term(dr2, lj.eps24, lj.sig2, fac, u6);
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
      a.u6 += u6 + lj.shift6;
      a.vir += fac * dr2;
    }
  }
}

// J4 words of a ring entry: (x, y, z, w), and in the Gram form a second
// J4 whose x is s_j (a widened entry measured 8% faster than a parallel
// ring of s_j, PERF.md)
template <bool GRAM>
__host__ __device__ constexpr int entry_words() {
  return GRAM ? 2 : 1;
}

// One i `me` against the staged entries (tail + k) % RING of the ring for
// k = h, h + WAYS, ... < n (n <= 32), h the lane's half (0 unsplit).
// WAYS is a compile-time constant, so the walk of a full ring (n = 32)
// unrolls completely.
template <typename T, bool MACRO, bool VI, bool GRAM, int WAYS>
__device__ __forceinline__ void walk(const J4<T>* ring, int tail, int n,
                                     const J4<T>& me, T si, const ljk::LJ<T>& lj,
                                     ljk::Acc<T>& a) {
  constexpr int EW = entry_words<GRAM>();
  const int h = (threadIdx.x & 31) / (32 / WAYS);
  for (int b = 0; b < 32 / WAYS; ++b) {
    const int k = b * WAYS + h;
    if (k >= n) break;
    const int e = EW * ((tail + k) & (RING - 1));
    pair<T, MACRO, VI, GRAM>(me, si, ring[e], GRAM ? ring[e + 1].x : T(0), lj, a);
  }
}

// walk, split in two halves or not
template <typename T, bool MACRO, bool VI, bool GRAM>
__device__ __forceinline__ void walk_ways(int ways, const J4<T>* ring, int tail,
                                          int n, const J4<T>& me, T si,
                                          const ljk::LJ<T>& lj, ljk::Acc<T>& a) {
  if (ways == 2)
    walk<T, MACRO, VI, GRAM, 2>(ring, tail, n, me, si, lj, a);
  else
    walk<T, MACRO, VI, GRAM, 1>(ring, tail, n, me, si, lj, a);
}

// Forces on every slot of r_i[nz, ny, pi, nx*cap] (planes x, y, z, valid;
// pi >= 4 is the plane count of the parent tensor) into f[nz, ny, 3 or 6,
// nx*cap]; with VI planes 3..5 hold 0.5 * sum_j f_a * dr_a; GRAM takes
// the Gram form of r^2; BAND the band order of the warps (warp_cell).
// The j cells come from the neighbour functor (ljk::Stage).
template <typename T, bool MACRO, bool VI, bool GRAM, bool BAND, typename Nbr>
__global__ void __launch_bounds__(WARPS * 32)
    warp_cells_kernel(const T* __restrict__ ri, int pi, T* __restrict__ f,
                      T* __restrict__ part, ljk::Grid gd, Nbr nbr, ljk::LJ<T> lj) {
  constexpr int EW = entry_words<GRAM>();
  __shared__ J4<T> rings[WARPS][EW * RING];
  const int lane = threadIdx.x & 31;
  J4<T>* ring = rings[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  const int nx = gd.nx, ny = gd.ny, cap = gd.cap;
  const long long W = (long long)nx * cap;
  int cx, cy, cz, ch;
  ljk::Acc<T> acc;
  if (warp_cell<BAND>(gd, cx, cy, cz, ch)) {  // warp-uniform
    const int s = ch * 32 + lane;
    const T* p = ri + ((long long)cz * ny + cy) * pi * W + (long long)cx * cap + s;
    const bool vi = p[3 * W] > T(0.5);
    const unsigned vmask = __ballot_sync(FULL, vi);
    const int ni = __popc(vmask);
    const int rank = __popc(vmask & below);
    T* o = f + ((long long)cz * ny + cy) * (VI ? 6 : 3) * W + (long long)cx * cap + s;
    if (ni > 0) {  // warp-uniform
      const IChunk<T> c = i_chunk<T, GRAM, EW>(p, W, s, vi, vmask, ni, rank, ring);
      int head = 0, cnt = 0;  // ring write position; staged, not walked
      for (int dz = -1; dz <= 1; ++dz) {
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            const ljk::Stage<T> st = nbr(cx, cy, cz, dx, dy, dz);
            const bool self = (dx == 0) && (dy == 0) && (dz == 0);
            for (int js = lane; js < cap; js += 32) {
              const T* pj = st.p + js;
              bool keep = pj[3 * st.stride] > T(0.5);
              T x = T(0), y = T(0), z = T(0), sj = T(0);
              if (keep) {
                x = ljk::add_rn(pj[0], st.shx);
                y = ljk::add_rn(pj[st.stride], st.shy);
                z = ljk::add_rn(pj[2 * st.stride], st.shz);
                const T bd2 = c.boxdist2(x, y, z);
                if constexpr (GRAM) {
                  sj = ljk::norm2(x, y, z);
                  keep = bd2 < ljk::add_rn(
                                   lj.rc2, ljk::mul_rn(gram_kappa<T>(),
                                                       ljk::add_rn(c.smax, sj)));
                } else {
                  keep = bd2 < lj.rc2;
                }
              }
              const unsigned km = __ballot_sync(FULL, keep);
              if (keep) {
                const int e = EW * ((head + __popc(km & below)) & (RING - 1));
                ring[e] = J4<T>{x, y, z, self ? T(js) : T(-1)};
                if constexpr (GRAM) ring[e + 1].x = sj;
              }
              head += __popc(km);
              cnt += __popc(km);
              __syncwarp();
              if (cnt >= 32) {
                if (c.live)
                  walk_ways<T, MACRO, VI, GRAM>(c.ways, ring, head - cnt, 32,
                                                c.me, c.si, lj, acc);
                cnt -= 32;
                __syncwarp();
              }
            }
          }
        }
      }
      if (c.live)
        walk_ways<T, MACRO, VI, GRAM>(c.ways, ring, head - cnt, cnt, c.me, c.si,
                                      lj, acc);
      o[0] = to_slot(acc.fx, c.ways, rank, vi);
      o[W] = to_slot(acc.fy, c.ways, rank, vi);
      o[2 * W] = to_slot(acc.fz, c.ways, rank, vi);
      if (VI) {
        o[3 * W] = T(0.5) * to_slot(acc.vx, c.ways, rank, vi);
        o[4 * W] = T(0.5) * to_slot(acc.vy, c.ways, rank, vi);
        o[5 * W] = T(0.5) * to_slot(acc.vz, c.ways, rank, vi);
      }
    } else {
      for (int c = 0; c < (VI ? 6 : 3); ++c) o[c * W] = T(0);
    }
  }
  if (MACRO) ljk::block_macro(acc.u6, acc.vir, part);
}

// -- Newton's third law: the half shell of K1 (lj_cells.cu), K8
// (lj_cells_n3l.cu) and K10 (lj_packed.cu).  Each pair is evaluated once,
// by the i side; its reaction -F_ij goes to the j entry.  A ring entry's
// w tells the half shell: an own-cell (own-pencil) entry carries its slot
// (lane), a forward one a value above every i's, and the pair counts
// when j.w > i.w.  Reactions travel in one of two ways, and nothing
// assumes that the lanes of a warp run in lockstep:
//   * a full round of 32 entries by register rotation (rotate): each
//     lane holds one item and three sums, meets what its lane holds
//     fixed, and passes item and sums on to the lane below by shuffles,
//     so no two lanes ever add to the same sum.  K1 and K8 rotate the j
//     entries and their reactions past fixed i (walk_rotate); K10
//     rotates its i and their forces past fixed j entries, because its
//     i side carries the pencil's y/z shift (see lj_packed.cu);
//   * the last, partial round skewed (walk_skewed_to): the lane of rank
//     l takes the entry of rank (l + b) mod m at step b and hands the
//     reaction to a sink that adds it atomically (two lanes may take one
//     entry when m is below the lanes); K8 and K10 add it to the entry's
//     sums in shared memory (walk_skewed) and then one lane an entry adds
//     them to f (flush).
// What becomes of a round's reactions is the caller's sink (a lambda):
// in this form nvcc gives half_shell 61 registers in f32 and no spills;
// written with the sums passed in directly, 64 and spills, and K1 took
// 6.72 ms against 6.41-6.46 on the argon state (H100, PERF.md).
// Reactions and i forces reach f by global atomics (f32 and f64 reductions are
// native on sm_90: REDG.E.ADD), so the order of the sums varies from run
// to run.  Shared-memory float atomics are not native (a compare-and-swap
// loop, ATOMS.CAST.SPIN), which is why the skewed round alone uses them.

// Per warp, beside the ring of staged j: the reaction sums of each entry
// (the skewed round's) and the offset of its j slot in f (plane x; y and
// z one plane stride W apart), of type O.
template <typename T, typename O = int>
struct Reactions {
  T x[RING], y[RING], z[RING];
  O o[RING];
};

// (x, y, z) added to the slot at o (planes W apart), unless all are 0
template <typename T>
__device__ __forceinline__ void add_to(T* o, long long W, T x, T y, T z) {
  if (x != T(0) || y != T(0) || z != T(0)) {
    atomicAdd(o, x);
    atomicAdd(o + W, y);
    atomicAdd(o + 2 * W, z);
  }
}

// The pair of i `me` and a staged j if it lies inside the cutoff and j
// is a later slot of the own cell or a slot of a forward cell: its terms
// added to `a` and the force on i returned in (px, py, pz).
template <typename T, bool MACRO>
__device__ __forceinline__ bool half_pair(const J4<T>& me, const J4<T>& j,
                                          const ljk::LJ<T>& lj, ljk::Acc<T>& a,
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
    a.fx += px;
    a.fy += py;
    a.fz += pz;
    if (MACRO) {
      a.u6 += u6 + lj.shift6;
      a.vir += fac * dr2;
    }
    return true;
  }
  return false;
}

// The last, partial round, skewed: the entries (tail + k) % RING, k < n
// (n < 32), of the lane's half (k = h, h + WAYS, ...); the lane of rank l
// in its half takes the entry of rank (l + b) mod m of the half's m at
// step b.  pair(j, e, px, py, pz) evaluates the lane's i with entry j
// (ring slot e), adds the terms on i and returns the force on i if the
// pair counts; the reaction goes to sink(e, j, -px, -py, -pz), which
// adds it atomically.
template <typename T, int WAYS, typename Pair, typename Sink>
__device__ __forceinline__ void walk_skewed_to(const J4<T>* ring, int tail,
                                               int n, const Pair& pair,
                                               const Sink& sink) {
  constexpr int S = 32 / WAYS;
  const int lane = threadIdx.x & 31, h = lane / S, l = lane & (S - 1);
  const int m = (n - h + WAYS - 1) / WAYS;
  if (m <= 0) return;
  int q = l % m;
  for (int b = 0; b < S; ++b) {  // a compile-time bound: the loop unrolls
    if (b >= m) break;
    const int e = (tail + q * WAYS + h) & (RING - 1);
    const J4<T> j = ring[e];
    T px, py, pz;
    if (pair(j, e, px, py, pz)) sink(e, j, -px, -py, -pz);
    if (++q == m) q = 0;
  }
}

// walk_skewed_to with the reactions added to the entries' sums re by
// shared atomics
template <typename T, int WAYS, typename Pair, typename O>
__device__ __forceinline__ void walk_skewed(const J4<T>* ring,
                                            Reactions<T, O>& re, int tail, int n,
                                            const Pair& pair) {
  walk_skewed_to<T, WAYS>(ring, tail, n, pair,
                          [&](int e, const J4<T>&, T x, T y, T z) {
                            atomicAdd(re.x + e, x);
                            atomicAdd(re.y + e, y);
                            atomicAdd(re.z + e, z);
                          });
}

// The reactions of the entries (tail + k) % RING, k < n, added to f: one
// entry a lane.
template <typename T, typename O>
__device__ __forceinline__ void flush(const Reactions<T, O>& re, int tail, int n,
                                      T* f, long long W) {
  const int lane = threadIdx.x & 31;
  if (lane < n) {
    const int e = (tail + lane) & (RING - 1);
    add_to(f + re.o[e], W, re.x[e], re.y[e], re.z[e]);
  }
}

// A round by register rotation in halves of S lanes: step(v, sx, sy, sz)
// S times, and between two steps v and its sums passed on to the lane
// below (the lane of rank l in its half takes them from rank l + 1 mod
// S).  After the round the lane of rank l holds what rank l - 1 held.
template <typename T, int S, typename Step>
__device__ __forceinline__ void rotate(J4<T>& v, T& sx, T& sy, T& sz,
                                       const Step& step) {
  const int lane = threadIdx.x & 31;
  const int src = (lane & ~(S - 1)) | ((lane + 1) & (S - 1));
  for (int b = 0; b < S; ++b) {
    step(v, sx, sy, sz);
    if (b + 1 < S) {
      v.x = __shfl_sync(FULL, v.x, src);
      v.y = __shfl_sync(FULL, v.y, src);
      v.z = __shfl_sync(FULL, v.z, src);
      v.w = __shfl_sync(FULL, v.w, src);
      sx = __shfl_sync(FULL, sx, src);
      sy = __shfl_sync(FULL, sy, src);
      sz = __shfl_sync(FULL, sz, src);
    }
  }
}

// A full round of the half shell by register rotation (rotate): the lane
// of rank l in its half starts with the half's entry of rank l and a zero
// reaction, meets its i at each step and passes entry and reaction to the
// lane below; every lane of the warp takes part in the shuffles, a lane
// without a valid i only passes them on.  Ends with sink(e, j, rx, ry,
// rz) in every lane: the entry j it holds (ring slot e) and its reaction.
template <typename T, bool MACRO, int WAYS, typename Sink>
__device__ __forceinline__ void walk_rotate(const J4<T>* ring, int tail,
                                            bool live, const J4<T>& me,
                                            const ljk::LJ<T>& lj, ljk::Acc<T>& a,
                                            const Sink& sink) {
  constexpr int S = 32 / WAYS;
  const int lane = threadIdx.x & 31, h = lane / S, l = lane & (S - 1);
  J4<T> j = ring[(tail + l * WAYS + h) & (RING - 1)];
  T rx = T(0), ry = T(0), rz = T(0);
  rotate<T, S>(j, rx, ry, rz, [&](const J4<T>& jj, T& sx, T& sy, T& sz) {
    T px, py, pz;
    if (live && half_pair<T, MACRO>(me, jj, lj, a, px, py, pz)) {
      sx -= px;
      sy -= py;
      sz -= pz;
    }
  });
  sink((tail + ((l + S - 1) & (S - 1)) * WAYS + h) & (RING - 1), j, rx, ry, rz);
}

// walk_rotate of a full round, split in two halves or not
template <typename T, bool MACRO, typename Sink>
__device__ __forceinline__ void walk_round(int ways, const J4<T>* ring, int tail,
                                           bool live, const J4<T>& me,
                                           const ljk::LJ<T>& lj, ljk::Acc<T>& a,
                                           const Sink& sink) {
  if (ways == 2)
    walk_rotate<T, MACRO, 2>(ring, tail, live, me, lj, a, sink);
  else
    walk_rotate<T, MACRO, 1>(ring, tail, live, me, lj, a, sink);
}

// The last, partial round of the half shell (walk_skewed_to), split in
// two halves or not; the lanes with a valid i only
template <typename T, bool MACRO, typename Sink>
__device__ __forceinline__ void walk_last(int ways, const J4<T>* ring, int tail,
                                          int n, const J4<T>& me,
                                          const ljk::LJ<T>& lj, ljk::Acc<T>& a,
                                          const Sink& sink) {
  const auto pair = [&](const J4<T>& j, int, T& px, T& py, T& pz) {
    return half_pair<T, MACRO>(me, j, lj, a, px, py, pz);
  };
  if (ways == 2)
    walk_skewed_to<T, 2>(ring, tail, n, pair, sink);
  else
    walk_skewed_to<T, 1>(ring, tail, n, pair, sink);
}

// The sums of u6 and the virial over the warp into its row of part, the
// warp's index in the launch (lane 0 writes it).  Called inside the
// warp's own branch: no block barrier.
template <typename T>
__device__ __forceinline__ void warp_parts(T u6, T vir, T* __restrict__ part) {
  u6 = ljk::warp_sum(u6);
  vir = ljk::warp_sum(vir);
  if ((threadIdx.x & 31) == 0) {
    const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    part[2 * row] = u6;
    part[2 * row + 1] = vir;
  }
}

// Rows of the part[., 2] buffer of a half-shell launch: one a warp of
// the grid (num_blocks * WARPS less the warps past the grid).
inline long long half_parts(int nx, int ny, int nz, int cap) {
  return (long long)nx * ny * nz * (cap / 32);
}

// The half-shell kernel of K1 (lj_cells.cu, also K3's half-shell branch)
// and K8 (lj_cells_n3l.cu), one body under two names: forces on every
// slot of the cell-local layout
// r[nz, ny, P, nx*cap] (nbr its neighbour functor) into f[nz, ny, 3,
// nx*cap] (zeroed by the caller), each pair of the half shell once; u6
// and the virial counted once per pair.  A warp stages the valid j slots
// of the own cell above its first valid i slot and of the 13 forward
// cells (m = 9*(dz+1) + 3*(dy+1) + (dx+1) = 13 the own cell, 14..26 the
// forward half) that lie within rc of its i box; an own-cell entry
// carries its slot id, a forward one 2 * cap, so half_pair's test j.w >
// i.w keeps j > i in the own cell and every forward pair (also where
// several warps share the own cell).  Each full round's reactions go to
// f by global atomics from the lane that holds the entry at the round's
// end, the last round's through the warp's shared sums (flush), the i
// forces at the warp's end from the lane that holds each i to its slot
// (me.w).  With MACRO each warp writes its sums of u6 and the virial to
// its own row of part (half_parts rows), inside its own branch: a block
// reduction after the branch (block_macro, with its barrier) made nvcc
// guard every shuffle of the walk with a divergence check (BRA.DIV) and
// give the u6/virial instantiation 72 registers and spills, 8.40-8.49
// ms against 6.40-6.47 without u6/virial on the argon state; now 64
// registers, no spills and 7.07-7.10 ms (H100, PERF.md).
template <typename T, bool MACRO>
__device__ __forceinline__ void half_shell(const T* __restrict__ r, int P,
                                           T* __restrict__ f, T* __restrict__ part,
                                           const ljk::Grid& gd,
                                           const ljk::LocalNbr<T>& nbr,
                                           const ljk::LJ<T>& lj) {
  __shared__ J4<T> rings[WARPS][RING];
  __shared__ Reactions<T, long long> reacts[WARPS];
  const int lane = threadIdx.x & 31;
  J4<T>* ring = rings[threadIdx.x >> 5];
  Reactions<T, long long>& re = reacts[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1u;
  const int nx = gd.nx, ny = gd.ny, nz = gd.nz, cap = gd.cap;
  const long long W = (long long)nx * cap;
  int cx, cy, cz, ch;
  if (warp_cell<false>(gd, cx, cy, cz, ch)) {  // warp-uniform
    const int s = ch * 32 + lane;
    const T* p = r + ((long long)cz * ny + cy) * P * W + (long long)cx * cap + s;
    const bool vi = p[3 * W] > T(0.5);
    const unsigned vmask = __ballot_sync(FULL, vi);
    const int ni = __popc(vmask);
    if (ni > 0) {  // warp-uniform
      const IChunk<T> c =
          i_chunk<T, false, 1>(p, W, s, vi, vmask, ni, __popc(vmask & below), ring);
      ljk::Acc<T> acc;
      const int smin = ch * 32 + c.first;  // the first valid i slot
      // a full round's reactions: to f by global atomics
      const auto to_f = [&](int e, const J4<T>&, T x, T y, T z) {
        add_to(f + re.o[e], W, x, y, z);
      };
      int head = 0, cnt = 0;  // ring write position; staged, not walked
      for (int m = 13; m < 27; ++m) {
        const int dz = m / 9 - 1, dy = (m / 3) % 3 - 1, dx = m % 3 - 1;
        const ljk::Stage<T> st = nbr(cx, cy, cz, dx, dy, dz);
        const bool self = m == 13;
        // offset in f of the cell's slot 0
        const long long ob =
            ((long long)ljk::wrap(cz + dz, nz) * ny + ljk::wrap(cy + dy, ny)) * 3 *
                W +
            (long long)ljk::wrap(cx + dx, nx) * cap;
        for (int js = lane; js < cap; js += 32) {
          const T* pj = st.p + js;
          bool keep = pj[3 * st.stride] > T(0.5) && (!self || js > smin);
          T x = T(0), y = T(0), z = T(0);
          if (keep) {
            x = ljk::add_rn(pj[0], st.shx);
            y = ljk::add_rn(pj[st.stride], st.shy);
            z = ljk::add_rn(pj[2 * st.stride], st.shz);
            keep = c.boxdist2(x, y, z) < lj.rc2;
          }
          const unsigned km = __ballot_sync(FULL, keep);
          if (keep) {
            const int e = (head + __popc(km & below)) & (RING - 1);
            ring[e] = J4<T>{x, y, z, self ? T(js) : T(2 * cap)};
            re.x[e] = T(0);
            re.y[e] = T(0);
            re.z[e] = T(0);
            re.o[e] = ob + js;
          }
          head += __popc(km);
          cnt += __popc(km);
          __syncwarp();
          if (cnt >= 32) {
            walk_round<T, MACRO>(c.ways, ring, head - cnt, c.live, c.me, lj, acc,
                                 to_f);
            cnt -= 32;
            __syncwarp();
          }
        }
      }
      // the last round, partial
      if (c.live)
        walk_last<T, MACRO>(c.ways, ring, head - cnt, cnt, c.me, lj, acc,
                            [&](int e, const J4<T>&, T x, T y, T z) {
                              atomicAdd(re.x + e, x);
                              atomicAdd(re.y + e, y);
                              atomicAdd(re.z + e, z);
                            });
      __syncwarp();
      flush(re, head - cnt, cnt, f, W);
      // the i forces, from the lane that holds each i straight to its
      // slot (me.w): other warps add reactions to the same slots
      if (c.ways == 2) {
        acc.fx += __shfl_xor_sync(FULL, acc.fx, 16);
        acc.fy += __shfl_xor_sync(FULL, acc.fy, 16);
        acc.fz += __shfl_xor_sync(FULL, acc.fz, 16);
      }
      if (c.live && lane < 32 / c.ways)
        add_to(f + ((long long)cz * ny + cy) * 3 * W + (long long)cx * cap +
                   (int)c.me.w,
               W, acc.fx, acc.fy, acc.fz);
      if (MACRO) warp_parts(acc.u6, acc.vir, part);
    } else if (MACRO) {
      warp_parts(T(0), T(0), part);
    }
  }
}

// The signature of a half-shell kernel (a __global__ wrapper of
// half_shell)
template <typename T>
using HalfKernel = void (*)(const T*, int, T*, T*, ljk::Grid, ljk::LocalNbr<T>,
                            ljk::LJ<T>);

// Launch a half-shell kernel (fast: without u6/virial, full: with) on
// the planes r (P of them) on `stream`; returns the cudaError_t of the
// launch.
template <typename T>
int launch_half(HalfKernel<T> fast, HalfKernel<T> full, const void* r, void* f,
                void* part, int nx, int ny, int nz, int cap, int planes,
                double clx, double cly, double clz, double eps24, double sig2,
                double shift6, double rc2, int macro, void* stream) {
  const ljk::Grid gd{nx, ny, nz, cap};
  const ljk::LocalNbr<T> nbr{(const T*)r, nx, ny, nz, cap, planes, 0,
                             T(clx), T(cly), T(clz)};
  const ljk::LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)num_blocks(nx, ny, nz, cap);
  const HalfKernel<T> kern = macro ? full : fast;
  kern<<<blocks, WARPS * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const T*)r, planes, (T*)f, (T*)part, gd, nbr, lj);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the cudaError_t of the launch.  HAS_VI and
// HAS_GRAM say whether the kernel source offers the per-slot virial
// planes and the Gram form (vi and gram select them; never both); BAND
// the band order of the warps.
template <typename T, bool HAS_VI, bool HAS_GRAM, bool BAND, typename Nbr>
int launch_warp(const void* ri, int pi, void* f, void* part, int nx, int ny,
                int nz, int cap, Nbr nbr, double eps24, double sig2,
                double shift6, double rc2, int macro, int vi, int gram,
                void* stream) {
  const ljk::Grid gd{nx, ny, nz, cap};
  const ljk::LJ<T> lj{T(eps24), T(sig2), T(shift6), T(rc2)};
  const unsigned blocks = (unsigned)num_blocks(nx, ny, nz, cap, BAND);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LJW_LAUNCH(M, V, G)                                                \
  warp_cells_kernel<T, M, V, G, BAND, Nbr><<<blocks, WARPS * 32, 0, st>>>( \
      (const T*)ri, pi, (T*)f, (T*)part, gd, nbr, lj)
  if constexpr (HAS_VI) {
    if (vi) {
      if (macro) {
        LJW_LAUNCH(true, true, false);
      } else {
        LJW_LAUNCH(false, true, false);
      }
      return (int)cudaGetLastError();
    }
  }
  if constexpr (HAS_GRAM) {
    if (gram) {
      if (macro) {
        LJW_LAUNCH(true, false, true);
      } else {
        LJW_LAUNCH(false, false, true);
      }
      return (int)cudaGetLastError();
    }
  }
  if (macro) {
    LJW_LAUNCH(true, false, false);
  } else {
    LJW_LAUNCH(false, false, false);
  }
#undef LJW_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace ljw
