// One stage of the 3-stage nearest-neighbour shift-merge rebin, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_rebin.py:
// rebin_shift_pallas (body _rebin_kernel), whose output is bit-identical
// to RMMSimulation._rebin_shift (ls1_mardyn_tpu/ops/rmm.py).  The caller
// launches this kernel three times, out of place: the x stage, then y,
// then z.
//
// Data: in/out [nz, ny, 11, nx*cap], columns (x, y, z, valid, vx, vy,
// vz, mid, fx, fy, fz), cell-local coordinates.  For a stage along axis
// a, cell c keeps, in (source row, slot) order, the candidates of rows
// c-1 (ri 0), c (ri 1) and c+1 (ri 2) that belong to it after the hop
// d = floor(coord_a / cl_a): a molecule of row c-1 belongs when d == +1,
// of row c when d == 0, of row c+1 when d == -1.  The stage coordinate
// is moved by the hop (coord - roll*cl).  Slots past the kept count are
// refilled: zeros, and y = 1000*(1+slot) when the sentinel layout is on.
// Overflow latches (atomicOr on a device int) when a valid molecule
// hops more than one cell or a cell receives more than cap candidates;
// the caller then falls back to the global-sort rebin.
//
// What bounds it on this card: memory.  A stage reads 3 rows of 11
// columns per cell (the two neighbours' rows mostly from L2) and writes
// one, with no arithmetic to speak of: at least one read and one write
// of the 11-column stack per stage, 2 x 284 MB at the production grid
// (56,60,60), cap 32, f32.
//
// Design: one block per cell, one thread per slot.  A thread takes the
// candidate of its own slot from each of the three rows, so reads are
// coalesced along the slot axis.  The destination slot is the
// exclusive rank of `belong` in (row, slot) order: a warp ballot +
// popcount per row, then per-warp totals in shared memory for cap > 32.
// That order is the sort key slot + cap*row of the JAX version, so the
// result is bit-identical to it; floor(x / cl) uses IEEE division (no
// fast-math build).  The TPU kernel's power-of-two cap, 128-lane tiles
// and row chunking are Mosaic constraints and do not apply here.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 11;

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

template <typename T>
__global__ void rebin_stage_kernel(const T* __restrict__ in, T* __restrict__ out,
                                   int* __restrict__ overflow, int nx, int ny,
                                   int nz, int cap, int axis, T cl,
                                   int sentinel) {
  __shared__ int wcnt[3][32];
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int w = s >> 5;
  const int nw = cap >> 5;
  const long long cell = blockIdx.x;
  const int cx = (int)(cell % nx);
  const int cy = (int)((cell / nx) % ny);
  const int cz = (int)(cell / ((long long)nx * ny));
  const long long W = (long long)nx * cap;

  const T* src[3];
  bool belong[3];
  for (int ri = 0; ri < 3; ++ri) {
    const int roll = 1 - ri;  // row c - roll is presented to cell c
    int sx = cx, sy = cy, sz = cz;
    if (axis == 0) sx = wrap(cx - roll, nx);
    if (axis == 1) sy = wrap(cy - roll, ny);
    if (axis == 2) sz = wrap(cz - roll, nz);
    const T* p = in + (long long)(sz * ny + sy) * kCols * W + (long long)sx * cap + s;
    src[ri] = p;
    const bool valid = p[3 * W] > T(0.5);
    const int d = (int)floor(p[axis * W] / cl);
    belong[ri] = valid && (d == roll);
    if (ri == 1 && valid && (d > 1 || d < -1)) atomicOr(overflow, 1);
  }

  int lrank[3];
  for (int ri = 0; ri < 3; ++ri) {
    const unsigned m = __ballot_sync(0xffffffffu, belong[ri]);
    lrank[ri] = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) wcnt[ri][w] = __popc(m);
  }
  __syncthreads();

  T* o = out + (long long)(cz * ny + cy) * kCols * W + (long long)cx * cap;
  int base = 0;
  for (int ri = 0; ri < 3; ++ri) {
    int pre = 0, tot = 0;
    for (int q = 0; q < nw; ++q) {
      const int c = wcnt[ri][q];
      pre += q < w ? c : 0;
      tot += c;
    }
    if (belong[ri]) {
      const int dst = base + pre + lrank[ri];
      if (dst < cap) {
        const T shift = T(1 - ri) * cl;
        for (int col = 0; col < kCols; ++col) {
          const T v = src[ri][col * W];
          o[col * W + dst] = col == axis ? v - shift : v;
        }
      } else {
        atomicOr(overflow, 1);
      }
    }
    base += tot;
  }
  if (s >= base) {
    for (int col = 0; col < kCols; ++col) o[col * W + s] = T(0);
    if (sentinel) o[W + s] = T(1000) * (T(1) + T(s));
  }
}

template <typename T>
int launch(const void* in, void* out, void* overflow, int nx, int ny, int nz,
           int cap, int axis, double cl, int sentinel, void* stream) {
  const unsigned blocks = (unsigned)((long long)nx * ny * nz);
  rebin_stage_kernel<T><<<blocks, cap, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const T*)in, (T*)out, (int*)overflow, nx, ny, nz, cap, axis, T(cl), sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rebin_stage_f32(const void* in, void* out, void* overflow, int nx, int ny,
                    int nz, int cap, int axis, double cl, int sentinel,
                    void* stream) {
  return launch<float>(in, out, overflow, nx, ny, nz, cap, axis, cl, sentinel, stream);
}

int rebin_stage_f64(const void* in, void* out, void* overflow, int nx, int ny,
                    int nz, int cap, int axis, double cl, int sentinel,
                    void* stream) {
  return launch<double>(in, out, overflow, nx, ny, nz, cap, axis, cl, sentinel, stream);
}

}  // extern "C"
