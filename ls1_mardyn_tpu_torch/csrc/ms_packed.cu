// Kernel K5: rigid multi-site molecule forces on occupancy-packed cell
// rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_ms_packed.py:
// multisite_cell_forces_packed (body _ms_packed_kernel).  Each (z, y)
// row holds its valid molecules packed in cell order, r_i[nz, ny, P, Wp],
// with the cell index in plane `cell_plane`; the j rows
// r_j[nzj, ny, P, Wjp] use the head-halo layout (right wrap halo at
// [0, occ_first), left wrap halo right-aligned at 2*cap, the row at
// +2*cap) and tbl[nzj, ny, nx+3] holds the packed cell starts
// (ops/cuda_ms_packed.py).  nzj = nz + 2 with z_halo (explicit halo
// rows, no z shift); y and otherwise z wrap with -+by / -+bz.
//
// A block is one 128-molecule i tile of a row; tiles at or beyond
// ceil(row count / 128) write zeros (on the half shell only their rows
// of part: the output was zeroed before the launch).  A warp's covering
// cells [c_lo, c_hi] (warp min/max of the cell plane over its valid slots)
// give, per neighbour row, the EXACT j range of cells c_lo-1 .. c_hi+1:
// [tbl[c_lo], tbl[c_hi+3]), or up to the row end plus the head range
// [0, tbl[nx+2]) (the right wrap halo) when c_hi >= nx-1.  The TPU
// kernel walks 128-aligned chunks and keeps its head walk apart from
// the main walk with nch2 <= base/JW, which needs cap <= JW; exact
// ranges need neither, so any cap works, and every image of a pair is
// visited once (a grid of >= 3 cells per axis with a cell edge >= rc
// leaves the cutoff alone to pick the one image that is near).  The
// self pair is j == i + 2*cap on the centre row.
//
// Without z halo rows the kernel takes the half shell (ms_pair.cuh): the
// centre row from the warp's first valid i slot on (j after i) plus the
// right wrap halo, and the four forward rows whole, each pair once with
// its reaction added to j's slot.  A j slot q of a row maps back to its
// packed slot: q - 2*cap in the row part, q itself in the right wrap
// halo (cell 0's first slots), q - 4*cap + tbl[nx+1] in the left wrap
// halo (the row's last slots).  With z halo rows the reactions would
// land on rows of another device, so that layout keeps the double-sided
// walk.
//
// The bodies, the skeleton, what bounds the kernel and its design are
// ms_pair.cuh's.

#include "ms_pair.cuh"

namespace {

template <typename T>
struct PackedRows {
  const T* rj;
  const int* tbl;
  int W, nx, ny, nz, cap, P, Wjp, cell_plane, zhalo;
  T by, bz;

  // live tiles: tile * 128 < this row's molecule count
  __device__ __forceinline__ bool tile_live(int z, int y, int tile) const {
    const int zt = zhalo ? z + 1 : z;
    const int cnt = tbl[((long long)zt * ny + y) * (nx + 3) + nx + 1] - 2 * cap;
    return tile * msk::TI < cnt;
  }

  __device__ __forceinline__ int i_cell(const T* si, int) const {
    return msk::to_int(si[cell_plane * msk::TI]);
  }

  __device__ __forceinline__ msk::JRow<T> row(int z, int y, int dz, int dy,
                                              int c_lo, int c_hi) const {
    const int zr = z + dz, yr = y + dy;
    const int zk = zhalo ? zr + 1 : msk::wrap(zr, nz);
    const int yk = msk::wrap(yr, ny);
    const T sz = zhalo ? T(0) : (zr < 0 ? -bz : (zr >= nz ? bz : T(0)));
    const T sy = yr < 0 ? -by : (yr >= ny ? by : T(0));
    const int* tb = tbl + ((long long)zk * ny + yk) * (nx + 3);
    const bool wrap_hi = c_hi >= nx - 1;
    return {rj + ((long long)zk * ny + yk) * P * Wjp, Wjp, tb[c_lo],
            wrap_hi ? tb[nx + 1] : tb[c_hi + 3], 0, wrap_hi ? tb[nx + 2] : 0,
            sy, sz, (dz == 0 && dy == 0) ? 2 * cap : msk::NO_SELF};
  }

  // the output offset (plane 0) of j slot q of neighbour row (dz, dy);
  // half shell only (no z halo rows)
  __device__ __forceinline__ long long j_out(int z, int y, int dz, int dy,
                                             int q) const {
    const long long jrow =
        (long long)msk::wrap(z + dz, nz) * ny + msk::wrap(y + dy, ny);
    int slot = q - 2 * cap;  // the row part
    if (q < cap)  // the right wrap halo: cell 0, the row's first slots
      slot = q;
    else if (q < 2 * cap)  // the left wrap halo: cell nx-1, its last slots
      slot = q - 4 * cap + tbl[jrow * (nx + 3) + nx + 1];
    return jrow * msk::NOUT * W + slot;
  }
};

template <typename T>
int run(const void* tbl, const void* ri, const void* rj, void* out, void* part,
        const void* tab, const void* terms, int nx, int ny, int nz, int cap,
        int P, int Wp, int Wjp, int cell_plane, int zhalo, double by, double bz,
        double rc2, double rc2lj, double alpha, int K, int ntab, int nterms,
        void* stream) {
  const PackedRows<T> rows{(const T*)rj, (const int*)tbl, Wp, nx, ny, nz, cap,
                           P, Wjp, cell_plane, zhalo, T(by), T(bz)};
  if (zhalo)
    return msk::launch<T, false>(ri, out, part, tab, terms, ntab, nterms, P,
                                 rows, Wp / msk::TI, ny, nz, rc2, rc2lj, alpha,
                                 K, stream);
  return msk::launch<T, true>(ri, out, part, tab, terms, ntab, nterms, P, rows,
                              Wp / msk::TI, ny, nz, rc2, rc2lj, alpha, K,
                              stream);
}

}  // namespace

extern "C" {

// rows of part: one a block (z halo rows), one a warp (the half shell)
int ms_packed_num_blocks(int Wp, int ny, int nz, int zhalo) {
  return Wp / msk::TI * ny * nz * (zhalo ? 1 : msk::NW);
}

int ms_packed_f32(const void* tbl, const void* ri, const void* rj, void* out,
                  void* part, const void* tab, const void* terms, int nx,
                  int ny, int nz, int cap, int P, int Wp, int Wjp,
                  int cell_plane, int zhalo, double by, double bz, double rc2,
                  double rc2lj, double alpha, int K, int ntab, int nterms,
                  void* stream) {
  return run<float>(tbl, ri, rj, out, part, tab, terms, nx, ny, nz, cap, P, Wp,
                    Wjp, cell_plane, zhalo, by, bz, rc2, rc2lj, alpha, K, ntab,
                    nterms, stream);
}

int ms_packed_f64(const void* tbl, const void* ri, const void* rj, void* out,
                  void* part, const void* tab, const void* terms, int nx,
                  int ny, int nz, int cap, int P, int Wp, int Wjp,
                  int cell_plane, int zhalo, double by, double bz, double rc2,
                  double rc2lj, double alpha, int K, int ntab, int nterms,
                  void* stream) {
  return run<double>(tbl, ri, rj, out, part, tab, terms, nx, ny, nz, cap, P,
                     Wp, Wjp, cell_plane, zhalo, by, bz, rc2, rc2lj, alpha, K,
                     ntab, nterms, stream);
}

}  // extern "C"
