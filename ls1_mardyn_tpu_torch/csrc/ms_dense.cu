// Kernel K6: rigid multi-site molecule forces on the dense cap-padded
// cell rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel ls1_mardyn_tpu/ops/pallas_multisite.py:
// multisite_cell_forces_pallas (body _ms_row_kernel): every slot of
// r_i[nz, ny, P, nx*cap] (absolute coordinates) against the slots of
// cells x-1..x+1 of the 9 (dz, dy) neighbour rows of the x-halo view
// r_j[nz(+2), ny(+2), P, (nx+2)*cap], whose halo cells the caller
// pre-shifted by -+Lx.  A neighbour row whose index wrapped gets -+by /
// -+bz; with z_halo / y_halo the view carries one explicit halo row per
// side (neighbour row r is view row r+1) and no shift is added.  The
// slot itself (view slot i + cap on the centre row) is excluded.
//
// The TPU kernel pairs a tx-cell i tile with its (tx+2)-cell window and
// chunks the window by jw lanes for cap > 128 (a VMEM device); here an
// i tile is 128 consecutive slots, a warp's window the cells its valid
// slots cover +-1, staged as chunks of 32 valid slots whatever the cap
// (the extra candidates of a window two cells wide are >= one cell edge
// >= rc away and fail the cutoff exactly).  The identity-matmul
// transposes, the one-hot component products and the plane-9 scalar
// lanes are not reproduced.
//
// The bodies, the skeleton, what bounds the kernel and its design are
// ms_pair.cuh's.

#include "ms_pair.cuh"

namespace {

template <typename T>
struct DenseRows {
  const T* rj;
  int W, nx, ny, nz, cap, P, zhalo, yhalo;
  T by, bz;

  __device__ __forceinline__ bool tile_live(int, int, int) const { return true; }

  __device__ __forceinline__ int i_cell(const T*, int s) const { return s / cap; }

  __device__ __forceinline__ msk::JRow<T> row(int z, int y, int dz, int dy,
                                              int c_lo, int c_hi) const {
    const long long Wj = (long long)(nx + 2) * cap;
    const int nyj = yhalo ? ny + 2 : ny;
    const int zr = z + dz, yr = y + dy;
    const int jz = zhalo ? zr + 1 : msk::wrap(zr, nz);
    const int jy = yhalo ? yr + 1 : msk::wrap(yr, ny);
    const T sz = zhalo ? T(0) : (zr < 0 ? -bz : (zr >= nz ? bz : T(0)));
    const T sy = yhalo ? T(0) : (yr < 0 ? -by : (yr >= ny ? by : T(0)));
    // view cell c + 1 holds cell c: cells c_lo-1 .. c_hi+1
    return {rj + ((long long)jz * nyj + jy) * P * Wj, Wj, c_lo * cap,
            (c_hi + 3) * cap, 0, 0, sy, sz,
            (dz == 0 && dy == 0) ? cap : msk::NO_SELF};
  }
};

template <typename T>
int run(const void* ri, const void* rj, void* out, void* part, const void* tab,
        const void* terms, int nx, int ny, int nz, int cap, int P, int zhalo,
        int yhalo, double by, double bz, double rc2, double rc2lj, double alpha,
        int K, int ntab, int nterms, void* stream) {
  const int W = nx * cap;
  const DenseRows<T> rows{(const T*)rj, W, nx, ny, nz, cap, P, zhalo, yhalo,
                          T(by), T(bz)};
  return msk::launch<T>(ri, out, part, tab, terms, ntab, nterms, P, rows,
                        (W + msk::TI - 1) / msk::TI, ny, nz, rc2, rc2lj, alpha,
                        K, stream);
}

}  // namespace

extern "C" {

int ms_dense_num_blocks(int nx, int ny, int nz, int cap) {
  return (nx * cap + msk::TI - 1) / msk::TI * ny * nz;
}

int ms_dense_f32(const void* ri, const void* rj, void* out, void* part,
                 const void* tab, const void* terms, int nx, int ny, int nz,
                 int cap, int P, int zhalo, int yhalo, double by, double bz,
                 double rc2, double rc2lj, double alpha, int K, int ntab,
                 int nterms, void* stream) {
  return run<float>(ri, rj, out, part, tab, terms, nx, ny, nz, cap, P, zhalo,
                    yhalo, by, bz, rc2, rc2lj, alpha, K, ntab, nterms, stream);
}

int ms_dense_f64(const void* ri, const void* rj, void* out, void* part,
                 const void* tab, const void* terms, int nx, int ny, int nz,
                 int cap, int P, int zhalo, int yhalo, double by, double bz,
                 double rc2, double rc2lj, double alpha, int K, int ntab,
                 int nterms, void* stream) {
  return run<double>(ri, rj, out, part, tab, terms, nx, ny, nz, cap, P, zhalo,
                     yhalo, by, bz, rc2, rc2lj, alpha, K, ntab, nterms, stream);
}

}  // extern "C"
