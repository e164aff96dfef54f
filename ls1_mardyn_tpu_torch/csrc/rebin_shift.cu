// The nearest-neighbour shift-merge rebin in two passes over memory, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_rebin.py:
// rebin_shift_pallas (body _rebin_kernel), whose output is bit-identical
// to RMMSimulation._rebin_shift (ls1_mardyn_tpu/ops/rmm.py): three stages,
// x then y then z, each re-packing every cell's slots from its own row
// and its two neighbour rows along the stage axis.
//
// Data: in/out [nz, ny, 11, nx*cap], columns (x, y, z, valid, vx, vy,
// vz, mid, fx, fy, fz), cell-local coordinates.  A valid molecule of cell
// s hops h_a = floor(coord_a / cl_a) along each axis a.  A stage moves
// only its own axis's coordinate (coord - h_a * cl_a), so the three hops
// are known from the input, and after the three stages a cell c holds
// the molecules of the source cells c - h, h in {-1, 0, 1}^3, whose hop
// is exactly h, in the order (ri_z, ri_y, ri_x, source slot) with ri = 1
// - h: a stage keeps its candidates in (source row, slot) order, the row
// c - 1 (ri 0) first.  That order is the sort key slot + cap * row of the
// JAX version.  Slots past the count are refilled: zeros, and y =
// 1000 * (1 + slot) when the sentinel layout is on.
//
// Overflow latches (atomicOr on a device int) exactly when the three
// stages latch it: a valid molecule hops more than one cell on an axis,
// or a cell holds more than cap molecules after the x stage, after the y
// stage or at the end.  The x stage's count of cell c is the molecules of
// the 3 sources (cx - hx, cy, cz) with x-hop hx; the y stage's, those of
// the 9 sources (cx - hx, cy - hy, cz) with hops (hx, hy).  (While no
// stage overflows, every molecule reaches its cell, so these counts are
// the stages' own.)  With the flag set the caller discards the output
// (it falls back to the global rebin), so the output is defined only
// where the flag is clear; there it is bit-identical to the three
// stages'.  Any grid: with one or two cells on an axis, c - 1 and c + 1
// are the same row and each hop is taken from it on its own, as a stage
// takes it.
//
// Design, two passes:
//   pass 1 (hop_kernel), one thread a slot: reads valid and the three
//     coordinates (all four loads at once: loading the coordinates only
//     for a valid slot made two round trips and took 15% longer) and
//     writes one byte, the hop code (hx+1) | (hy+1) << 2 | (hz+1) << 4,
//     or NONE for an empty slot or a hop beyond one cell (which latches
//     overflow);
//   pass 2 (gather_kernel), one warp a destination cell: for each of its
//     27 source cells in (ri_z, ri_y, ri_x) order it loads the codes of
//     that cell's slots (6.5 MB at the production grid: served from L2),
//     ranks the slots whose code is h by ballot + popc and writes their
//     (source, slot) into the warp's slot map in shared memory, and counts
//     the x and y stages' candidates from the same codes.  Then each lane
//     takes destination slots lane, lane + 32, ...: it gathers the 11
//     columns of the slot's source once, shifts each hopped coordinate as
//     a stage would (coord - h * cl, rounded once), and writes the cell's
//     slots in order, with the fill past the count.
// floor(x / cl) uses IEEE division (no fast-math build).
//
// What bounds it on this card: memory.  The function must read and write
// the 11-column stack once (2 x 284 MB at the production grid (56,60,60),
// cap 32, f32).  Pass 1 reads the 4 columns it needs and writes a byte a
// slot; pass 2 reads the occupied slots' 11 columns and writes every
// slot.  Three out-of-place stages would move the whole stack in and out
// three times.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 11;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // destination cells a block (pass 2)
constexpr int MAXCAP = 1024;          // slots a cell (the wrapper's limit)
constexpr unsigned char NONE = 0xff;  // a slot that moves to no cell

__device__ __forceinline__ int wrap(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// the hop code of h = (hx, hy, hz); its low 2 bits are x's, low 4 x's
// and y's (NONE matches no hop in either)
__device__ __forceinline__ unsigned hop_code(int hx, int hy, int hz) {
  return (unsigned)((hx + 1) | ((hy + 1) << 2) | ((hz + 1) << 4));
}

template <typename T>
__global__ void hop_kernel(const T* __restrict__ in, unsigned char* __restrict__ code,
                           int* __restrict__ overflow, long long W, long long slots,
                           T clx, T cly, T clz) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const long long row = s / W;
  const T* p = in + row * kCols * W + (s - row * W);
  // the four loads issue together (an empty slot's coordinates are read
  // and not used)
  const T v = p[3 * W], x = p[0], y = p[W], z = p[2 * W];
  unsigned char c = NONE;
  if (v > T(0.5)) {
    const int hx = (int)floor(x / clx);
    const int hy = (int)floor(y / cly);
    const int hz = (int)floor(z / clz);
    if (hx < -1 || hx > 1 || hy < -1 || hy > 1 || hz < -1 || hz > 1)
      atomicOr(overflow, 1);
    else
      c = (unsigned char)hop_code(hx, hy, hz);
  }
  code[s] = c;
}

// ONE: cap == 32, one chunk of 32 slots a cell (the loads of the 27
// sources' codes then issue together)
template <typename T, bool ONE>
__global__ void __launch_bounds__(WARPS * 32)
    gather_kernel(const T* __restrict__ in, const unsigned char* __restrict__ code,
                  T* __restrict__ out, int* __restrict__ overflow, int nx, int ny,
                  int nz, int cap, T clx, T cly, T clz, int sentinel) {
  // per warp: destination slot -> source (k << 10 | slot), k the index of
  // the source cell in (ri_z, ri_y, ri_x) order
  __shared__ unsigned short maps[WARPS][MAXCAP];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned short* map = maps[threadIdx.x >> 5];
  const long long cell = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cell >= (long long)nx * ny * nz) return;  // warp-uniform; no block barrier
  const int cx = (int)(cell % nx);
  const int cy = (int)((cell / nx) % ny);
  const int cz = (int)(cell / ((long long)nx * ny));
  const long long W = (long long)nx * cap;
  const int nch = ONE ? 1 : cap >> 5;
  int n = 0, n_xy = 0, n_x = 0;  // the final, the y stage's, the x stage's count
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int hz = 1 - k / 9, hy = 1 - (k / 3) % 3, hx = 1 - k % 3;
    const unsigned want = hop_code(hx, hy, hz);
    const unsigned char* cs =
        code + ((long long)wrap(cz - hz, nz) * ny + wrap(cy - hy, ny)) * W +
        (long long)wrap(cx - hx, nx) * cap + lane;
    for (int ch = 0; ch < nch; ++ch) {
      const unsigned c = cs[32 * ch];
      const unsigned m = __ballot_sync(FULL, c == want);
      if (c == want) {
        const int d = n + __popc(m & below);
        if (d < cap) map[d] = (unsigned short)((k << 10) | (32 * ch + lane));
      }
      n += __popc(m);
      if (hz == 0) {  // the source row of the y stage's candidates
        n_xy += __popc(__ballot_sync(FULL, (c & 15u) == (want & 15u)));
        if (hy == 0) n_x += __popc(__ballot_sync(FULL, (c & 3u) == (want & 3u)));
      }
    }
  }
  if (lane == 0 && (n > cap || n_xy > cap || n_x > cap)) atomicOr(overflow, 1);
  __syncwarp();
  T* o = out + ((long long)cz * ny + cy) * kCols * W + (long long)cx * cap;
  for (int d = lane; d < cap; d += 32) {
    if (d < n) {
      const int e = map[d];
      const int k = e >> 10, s = e & 1023;
      const int hz = 1 - k / 9, hy = 1 - (k / 3) % 3, hx = 1 - k % 3;
      const T* p = in +
                   ((long long)wrap(cz - hz, nz) * ny + wrap(cy - hy, ny)) * kCols * W +
                   (long long)wrap(cx - hx, nx) * cap + s;
      T v[kCols];
#pragma unroll
      for (int col = 0; col < kCols; ++col) v[col] = p[col * W];
      v[0] = v[0] - T(hx) * clx;
      v[1] = v[1] - T(hy) * cly;
      v[2] = v[2] - T(hz) * clz;
#pragma unroll
      for (int col = 0; col < kCols; ++col) o[col * W + d] = v[col];
    } else {
#pragma unroll
      for (int col = 0; col < kCols; ++col) o[col * W + d] = T(0);
      if (sentinel) o[W + d] = T(1000) * (T(1) + T(d));
    }
  }
}

template <typename T>
int launch(const void* in, void* out, void* code, void* overflow, int nx, int ny,
           int nz, int cap, double clx, double cly, double clz, int sentinel,
           void* stream) {
  if (cap % 32 || cap < 32 || cap > MAXCAP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long W = (long long)nx * cap;
  const long long slots = (long long)nz * ny * W;
  const long long cells = (long long)nx * ny * nz;
  hop_kernel<T><<<(unsigned)((slots + 255) / 256), 256, 0, st>>>(
      (const T*)in, (unsigned char*)code, (int*)overflow, W, slots, T(clx),
      T(cly), T(clz));
  const unsigned blocks = (unsigned)((cells + WARPS - 1) / WARPS);
  if (cap == 32) {
    gather_kernel<T, true><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)in, (const unsigned char*)code, (T*)out, (int*)overflow, nx, ny,
        nz, cap, T(clx), T(cly), T(clz), sentinel);
  } else {
    gather_kernel<T, false><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)in, (const unsigned char*)code, (T*)out, (int*)overflow, nx, ny,
        nz, cap, T(clx), T(cly), T(clz), sentinel);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both passes on `stream`: the hop codes into code[nz*ny*nx*cap] (one
// byte a slot), then the gather into out; overflow (an int, zeroed by
// the caller) latches.
int rebin_shift_f32(const void* in, void* out, void* code, void* overflow, int nx,
                    int ny, int nz, int cap, double clx, double cly, double clz,
                    int sentinel, void* stream) {
  return launch<float>(in, out, code, overflow, nx, ny, nz, cap, clx, cly, clz,
                       sentinel, stream);
}

int rebin_shift_f64(const void* in, void* out, void* code, void* overflow, int nx,
                    int ny, int nz, int cap, double clx, double cly, double clz,
                    int sentinel, void* stream) {
  return launch<double>(in, out, code, overflow, nx, ny, nz, cap, clx, cly, clz,
                        sentinel, stream);
}

}  // extern "C"
