"""Kernels K1, K3 and K4: LJ-12-6 cell forces on the dense cell layout.

Each CUDA kernel replaces one TPU kernel of ls1_mardyn_tpu/ops/pallas_lj.py
and has its plain PyTorch version beside it: the CPU tests hold the
plain version against the JAX kernel, and chip_smoke.py holds the CUDA
kernel against the plain version on the card.

  K1 lj_cell_forces      csrc/lj_cells.cu      lj_cell_forces_pallas_cwn3l
  K3 lj_cell_forces_cw   csrc/lj_cells_cw.cu   lj_cell_forces_pallas_cw
  K4 lj_cell_forces_row  csrc/lj_cells_row.cu  lj_cell_forces_pallas

Layout: r4 [nz, ny, 4, nx*cap] holds (x, y, z, valid) with cap slots
per cell along the last axis (x-major cell rows).  In cell-local
coordinates periodic images are exact integer cell offsets:
dr = r_i - (r_j + off*cell_len) for the neighbour cell at offset off in
{-1,0,1}^3.  A wrapper takes the plain version only for a CPU tensor; a
CUDA tensor launches the kernel (built at first use) or raises.

K1, K3 and K4 run on the warp skeleton of csrc/lj_warp.cuh (a warp owns
32 slots of an i cell and walks only the j slots of its neighbour cells
that are valid and within the cutoff of its i slots' bounding box).  K1
evaluates each pair once, by Newton's third law (the half shell: the own
cell with j > i and the 13 forward cells), as the TPU kernel does, and
adds the reaction to j by atomics: its wrapper zeroes f, and the order
of the sums, so the last bits of f, varies from run to run.  K3 takes
the same half shell (K1's launch) wherever its inputs allow it
(cw_half_shell: the j source is r_i itself, no z halo, every axis >= 3
cells, no Vi); every other K3 call, and K4, walk all 27 neighbour cells
and evaluate each pair from both sides.  The launch_* functions are the
launches behind the wrappers, on checked inputs; they raise for a CPU
tensor unless the library was built for the CPU (tools/cuda_emu.py).
inside_pairs counts the pairs inside the cutoff that K1, K3, K4, K7,
K8, K9 or K10 evaluates (a launch with eps24 = 0 and shift6 = 1;
ordered pairs, unordered for K1, K8 and K10; K3's half shell counts
each pair once and reports twice that), exactly, for the kernels' bound
and its check against the plain version's count.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models import potentials
from ls1_mardyn_tpu_torch.ops import _build

# Sentinel scale for invalid slots (y_local = SENTINEL_SCALE*(1+slot)),
# the JAX package's layout rule (ops/pallas_lj.py: SENTINEL_SCALE).  The
# CUDA kernels mask on validity and do not rely on it; the RMM state
# (ops/rmm.py) keeps writing it so that it stays identical to the JAX
# package's, the general path's layout (ops/lj_path.py) does not.
SENTINEL_SCALE = 1e3


def sentinel_eligible(cell_len, rc2: float, cap: int) -> bool:
    """Sentinel layout is safe iff every same-slot neighbour-row
    sentinel pair stays outside the cutoff after f32 rounding of the
    cell-edge shift, and the smallest sentinel stays outside the cutoff
    of every real particle (ops/pallas_lj.py: sentinel_eligible)."""
    edge_lo = float(min(cell_len))
    edge_hi = float(max(cell_len))
    ulp = float(np.spacing(np.float32(SENTINEL_SCALE * (1 + cap))))
    gap = SENTINEL_SCALE - 2.0 * edge_hi
    return (edge_lo - 2.0 * ulp) ** 2 >= rc2 and gap > 0 and gap ** 2 > rc2


# pair lanes per chunk of the plain versions (bounds their temporaries)
_REF_CHUNK = 1 << 24


def _cells(r4, nx, cap):
    """[nzr, nyr, 4, nx*cap] -> positions [nzr,nyr,nx,cap,3], valid [..]."""
    g = r4.reshape(r4.shape[0], r4.shape[1], 4, nx, cap).permute(0, 1, 3, 4, 2)
    return g[..., :3], g[..., 3] > 0.5


def _reference(pos_i, val_i, j_cells, *, cap, eps24, sig2, shift6, rc2,
               compute_macro, compute_vi=False, count=False):
    """The pair sum all three plain versions share.  pos_i, val_i: the i
    cells [nz,ny,nx,cap,(3)].  j_cells(z0, z1, off) returns, for the i
    rows z0:z1 and the neighbour offset off = (dz, dy, dx), the
    neighbour cells' positions WITH the image shift added (r_j + shift,
    rounded once, as the CUDA kernels stage them) and their validity.
    All cap x cap slot pairs of every cell pair are evaluated from both
    sides; u6 and the virial are halved per pair.
    Returns (f [nz,ny,nx,cap,3], vi or None, u6, vir), or with `count`
    the number of ordered pairs inside the cutoff (an int)."""
    nz, ny, nx = pos_i.shape[:3]
    dtype, dev = pos_i.dtype, pos_i.device
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    f = torch.zeros((nz, ny, nx, cap, 3), dtype=dtype, device=dev)
    vip = torch.zeros_like(f) if compute_vi else None
    u6 = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)
    zc = max(1, min(nz, _REF_CHUNK // (ny * nx * cap * cap)))
    n_inside = 0
    for z0 in range(0, nz, zc):
        z1 = min(nz, z0 + zc)
        pi, vi = pos_i[z0:z1], val_i[z0:z1]
        fi = torch.zeros_like(pi)
        vii = torch.zeros_like(pi) if compute_vi else None
        for off in itertools.product((-1, 0, 1), repeat=3):
            pj, vj = j_cells(z0, z1, off)
            dr = pi[..., :, None, :] - pj[..., None, :, :]
            # rounded as the CUDA kernels round it: same cutoff decisions
            dr2 = dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1] \
                + dr[..., 2] * dr[..., 2]
            m = vi[..., :, None] & vj[..., None, :] & (dr2 < rc2)
            if off == (0, 0, 0):
                m = m & ~eye
            if count:
                n_inside += int(m.sum())
                continue
            # the pair function runs on the pairs inside the cutoff only
            idx = m.nonzero(as_tuple=True)
            drm = dr[idx]
            fp, u6p = potentials.lj(drm, dr2[idx], eps24, sig2)
            fi.index_put_(idx[:-1], fp, accumulate=True)
            if compute_vi:
                vii.index_put_(idx[:-1], fp * drm, accumulate=True)
            if compute_macro:
                u6 += (u6p + shift6).sum()
                vir += (fp * drm).sum()
        f[z0:z1] = fi
        if compute_vi:
            vip[z0:z1] = 0.5 * vii
    if count:
        return n_inside
    return f, vip, 0.5 * u6, 0.5 * vir


def _planes_out(f, nx, cap):
    """[nz,ny,nx,cap,3] -> [nz,ny,3,nx*cap]."""
    nz, ny = f.shape[:2]
    return f.permute(0, 1, 4, 2, 3).reshape(nz, ny, 3, nx * cap)


def _local_j_cells(pos_j, val_j, cell_len, nz, z_halo):
    """j_cells of the cell-local layouts: the neighbour cells by a
    periodic roll in y and x (and z, unless pos_j carries explicit z
    halo rows), shifted by off*cell_len."""
    dtype, dev = pos_j.dtype, pos_j.device
    cl = torch.tensor(cell_len, dtype=dtype, device=dev)

    def j_cells(z0, z1, off):
        dz, dy, dx = off
        zs = torch.arange(z0, z1, device=dev) + dz
        zj = zs + 1 if z_halo else torch.remainder(zs, nz)
        pj = torch.roll(pos_j.index_select(0, zj), (-dy, -dx), (1, 2))
        vj = torch.roll(val_j.index_select(0, zj), (-dy, -dx), (1, 2))
        shift = torch.tensor((dx, dy, dz), dtype=dtype, device=dev) * cl
        return pj + shift, vj

    return j_cells


# the 13 forward neighbour offsets (dz, dy, dx) of the half shell: dz > 0,
# or dz = 0 and dy > 0, or dz = dy = 0 and dx = +1
FORWARD = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
                if o > (0, 0, 0))


def lj_cell_forces_reference(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True,
    count=False
):
    """Plain PyTorch version of K1 (and of K8, which walks the same half
    shell): the own cell with j > i and the 13 forward neighbour cells,
    gathered with a periodic roll, all cap x cap slot pairs of each; each
    pair inside the cutoff once, its force added to the i slot and
    subtracted from the j slot with index_add_.  u6 and the virial are
    not halved.  Returns (f [nz,ny,3,nx*cap], u6, vir), or with `count`
    the number of (unordered) pairs inside the cutoff (an int)."""
    nx, ny, nz = dims
    dtype, dev = r4.dtype, r4.device
    pos, val = _cells(r4, nx, cap)
    j_cells = _local_j_cells(pos, val, cell_len, nz, False)
    f = torch.zeros((nz * ny * nx * cap, 3), dtype=dtype, device=dev)
    u6 = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)
    upper = torch.triu(torch.ones((cap, cap), dtype=torch.bool, device=dev), 1)
    zc = max(1, min(nz, _REF_CHUNK // (ny * nx * cap * cap)))
    n_inside = 0
    for z0 in range(0, nz, zc):
        z1 = min(nz, z0 + zc)
        pi, vi = pos[z0:z1], val[z0:z1]
        for off in ((0, 0, 0),) + FORWARD:
            dz, dy, dx = off
            pj, vj = j_cells(z0, z1, off)
            dr = pi[..., :, None, :] - pj[..., None, :, :]
            # rounded as the CUDA kernels round it: same cutoff decisions
            dr2 = dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1] \
                + dr[..., 2] * dr[..., 2]
            m = vi[..., :, None] & vj[..., None, :] & (dr2 < rc2)
            if off == (0, 0, 0):
                m = m & upper
            if count:
                n_inside += int(m.sum())
                continue
            z, y, x, si, sj = m.nonzero(as_tuple=True)
            drm = dr[z, y, x, si, sj]
            fp, u6p = potentials.lj(drm, dr2[z, y, x, si, sj], eps24, sig2)
            zi = z + z0
            ii = ((zi * ny + y) * nx + x) * cap + si
            jj = ((torch.remainder(zi + dz, nz) * ny + torch.remainder(y + dy, ny))
                  * nx + torch.remainder(x + dx, nx)) * cap + sj
            f.index_add_(0, ii, fp)
            f.index_add_(0, jj, -fp)
            if compute_macro:
                u6 += (u6p + shift6).sum()
                vir += (fp * drm).sum()
    if count:
        return n_inside
    return _planes_out(f.reshape(nz, ny, nx, cap, 3), nx, cap), u6, vir


def _check(r4, shape, cap, what="lj_cell_forces"):
    if r4.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {r4.dtype} (f32/f64 only)")
    if tuple(r4.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(r4.shape)} != {tuple(shape)}")
    if cap % 32 or not 32 <= cap <= 1024:
        raise ValueError(f"{what}: cap {cap} (multiple of 32, <= 1024)")


def _planes(r4, W):
    """Plane count P of the contiguous [nz,ny,P,W] tensor r4 is a
    leading-plane slice of; raises on any other layout."""
    if r4.is_contiguous():
        return r4.shape[2]
    s0, s1, s2, s3 = r4.stride()
    P = s1 // W
    if s3 != 1 or s2 != W or s1 != P * W or P < 4 or s0 != r4.shape[1] * s1:
        raise ValueError(
            "lj_cell_forces: r4 must be planes [:, :, :4, :] of a "
            f"contiguous [nz,ny,P,W] tensor (strides {r4.stride()})"
        )
    return P


_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument types of each library's <name>_f32 / <name>_f64 entry points,
# with those of the kernel variants of ops/cuda_lj_variants.py
_ARGTYPES = {
    "lj_cells": [_VP] * 3 + [_CI] * 5 + [_CD] * 7 + [_CI, _VP],
    "lj_cells_cw": [_VP] * 4 + [_CI] * 7 + [_CD] * 7 + [_CI, _CI, _VP],
    "lj_cells_row": [_VP] * 4 + [_CI] * 8 + [_CD] * 7 + [_CI, _VP],
    "lj_cells_lanej": [_VP] * 4 + [_CI] * 4 + [_CD] * 7 + [_CI, _CI, _VP],
    "lj_cells_n3l": [_VP] * 3 + [_CI] * 5 + [_CD] * 7 + [_CI, _VP],
    "lj_cells_zb": [_VP] * 3 + [_CI] * 5 + [_CD] * 7 + [_CI, _CI, _VP],
}


def type_lib(lib, name):
    """Set the argument and result types of a loaded csrc/<name>.cu
    library's entry points (once); returns it."""
    if not getattr(lib, "_typed", False):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = _CI
        nb = getattr(lib, name + "_num_blocks")
        nb.argtypes = [_CI] * 4
        nb.restype = _CI
        lib._typed = True
    return lib


def _lib(name):
    return type_lib(_build.load(name), name)


def _launch(name, r4, out_planes, dims, cap, args, compute_macro, zero=False,
            parts=False):
    """Allocate outputs (zeroed with `zero`, for kernels that add into
    them), launch csrc/<name>.cu on PyTorch's current stream, check the
    status; returns (f, u6, vir), or (f, part) with `parts` (the partial
    sums part[row] = (u6, vir); <name>_num_blocks gives the rows: one a
    block, or one a warp for the half-shell kernels).  `args(f, part)`
    gives the entry point's arguments before the stream."""
    nx, ny, nz = dims
    lib = _lib(name)
    f = (torch.zeros if zero else torch.empty)(
        (nz, ny, out_planes, nx * cap), dtype=r4.dtype, device=r4.device)
    nb = getattr(lib, name + "_num_blocks")(nx, ny, nz, cap)
    part = torch.empty((nb, 2), dtype=r4.dtype, device=r4.device)
    fn = getattr(lib, name + ("_f32" if r4.dtype == torch.float32 else "_f64"))
    _build.check(fn(*args(f, part), _build.stream_of(lib, r4, name)), name)
    if parts:
        return f, part
    if compute_macro:
        u6, vir = part.sum(0).unbind()
    else:
        u6 = vir = torch.zeros((), dtype=r4.dtype, device=r4.device)
    return f, u6, vir


def lj_cell_forces(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True
):
    """K1 wrapper.  r4 [nz, ny, 4, nx*cap] (may be the first 4 planes of
    the RMM state's 8-plane tensor).  Returns (f [nz,ny,3,nx*cap], u6,
    vir); u6 and vir are 0-d tensors, zero when compute_macro=False.
    Each pair inside the cutoff is evaluated once (the half shell) and
    its reaction added to j by atomics: f agrees with the plain version
    to rounding, and the order of its sums varies from run to run.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    nx, ny, nz = dims
    _check(r4, (nz, ny, 4, nx * cap), cap)
    if min(dims) < 3:
        raise ValueError(f"lj_cell_forces: dims {dims} need >= 3 cells per axis")
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, compute_macro=compute_macro)
    if r4.device.type == "cpu":
        return lj_cell_forces_reference(r4, **kw)
    if r4.device.type != "cuda":
        raise ValueError(f"lj_cell_forces: device {r4.device}")
    out = launch_lj_cells(r4, **kw)
    lj_cell_forces.launches += 1
    return out


lj_cell_forces.launches = 0


def launch_lj_cells(r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2,
                    compute_macro=True, parts=False):
    """The launch of csrc/lj_cells.cu behind lj_cell_forces, on checked
    inputs (f zeroed first: the kernel adds into it): (f, u6, vir), or
    (f, part) with `parts`."""
    nx, ny, nz = dims
    P = _planes(r4, nx * cap)
    return _launch(
        "lj_cells", r4, 3, dims, cap,
        lambda f, part: (
            r4.data_ptr(), f.data_ptr(), part.data_ptr(), nx, ny, nz, cap, P,
            *(float(c) for c in cell_len), float(eps24), float(sig2),
            float(shift6), float(rc2), int(bool(compute_macro))),
        compute_macro, zero=True, parts=parts)


# -- K3: cell-window kernel ---------------------------------------------------

def cw_half_shell(r_j, dims, z_halo=False, compute_vi=False):
    """Whether K3 takes the half shell on these inputs: the j source is
    r_i itself (r_j None), no z halo, every axis >= 3 cells (so no two
    offsets reach one row) and no per-slot virial.  Every other call
    walks the double-sided 27-cell window."""
    return r_j is None and not z_halo and min(dims) >= 3 and not compute_vi


def lj_cell_forces_cw_reference(
    r_i, r_j=None, *, dims, cap, cell_len, eps24, sig2, shift6, rc2,
    z_halo=False, compute_macro=True, compute_vi=False
):
    """Plain PyTorch version of K3 (see lj_cell_forces_cw): K1's plain
    version where K3 takes the half shell (cw_half_shell), so that both
    evaluate each pair from the same side and round it alike."""
    if cw_half_shell(r_j, dims, z_halo, compute_vi):
        return lj_cell_forces_reference(
            r_i, dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
            shift6=shift6, rc2=rc2, compute_macro=compute_macro)
    nx, ny, nz = dims
    pos_i, val_i = _cells(r_i, nx, cap)
    pos_j, val_j = (pos_i, val_i) if r_j is None else _cells(r_j, nx, cap)
    f, vi, u6, vir = _reference(
        pos_i, val_i, _local_j_cells(pos_j, val_j, cell_len, nz, z_halo),
        cap=cap, eps24=eps24, sig2=sig2, shift6=shift6, rc2=rc2,
        compute_macro=compute_macro, compute_vi=compute_vi)
    f = _planes_out(f, nx, cap)
    if compute_vi:
        f = torch.cat([f, _planes_out(vi, nx, cap)], dim=2)
    return f, u6, vir


def lj_cell_forces_cw(
    r_i, r_j=None, *, dims, cap, cell_len, eps24, sig2, shift6, rc2,
    z_halo=False, compute_macro=True, compute_vi=False
):
    """K3 wrapper: 1CLJ forces in cell-local coordinates over the 27
    neighbour cells (9 (dz,dy) rows x the cell's own x window), on any
    grid with nx >= 3 and a cell edge >= rc; ny and nz may be 1 or 2,
    where two offsets reach the same row through different periodic
    images and both count.  Where cw_half_shell holds, each pair inside
    the cutoff is evaluated once (K1's half shell, the reaction added to
    j by atomics: f agrees with the plain version to rounding and the
    order of its sums varies from run to run), and the call counts on
    `half_launches` too; every other call evaluates each pair from both
    sides (deterministic).

    r_i [nz, ny, 4, nx*cap]; r_j is the j source, r_i itself when None.
    With z_halo it is [nz+2, ny, 4, nx*cap] and carries one explicit z
    halo row per side: neighbour row dz is r_j[z+dz+1], no wrap in z.
    The TPU kernel's j view also stores a 1+3-cell periodic x halo
    ([.., (nx+4)*cap]); this kernel wraps x in its index instead, so the
    view has no x halo.
    Returns (f, u6, vir) with f [nz,ny,3,nx*cap], or [nz,ny,6,nx*cap]
    with compute_vi: planes 3..5 hold the per-slot per-axis virial
    0.5 * sum_j f_a * dr_a."""
    nx, ny, nz = dims
    what = "lj_cell_forces_cw"
    _check(r_i, (nz, ny, 4, nx * cap), cap, what)
    if r_j is None and z_halo:
        raise ValueError(f"{what}: z_halo needs an explicit j source")
    src = r_i if r_j is None else r_j
    if r_j is not None:
        _check(r_j, (nz + 2 if z_halo else nz, ny, 4, nx * cap), cap, what)
        if r_j.dtype != r_i.dtype or r_j.device != r_i.device:
            raise ValueError(f"{what}: r_i and r_j differ in dtype or device")
    if nx < 3:
        raise ValueError(f"{what}: dims {dims} need nx >= 3")
    if min(cell_len) ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {min(cell_len)} < cutoff")
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, z_halo=z_halo,
              compute_macro=compute_macro, compute_vi=compute_vi)
    if r_i.device.type == "cpu":
        return lj_cell_forces_cw_reference(r_i, r_j, **kw)
    if r_i.device.type != "cuda":
        raise ValueError(f"{what}: device {r_i.device}")
    out = launch_lj_cells_cw(r_i, r_j, **kw)
    lj_cell_forces_cw.launches += 1
    lj_cell_forces_cw.half_launches += cw_half_shell(r_j, dims, z_halo,
                                                     compute_vi)
    return out


lj_cell_forces_cw.launches = 0
lj_cell_forces_cw.half_launches = 0


def launch_lj_cells_cw(r_i, r_j=None, *, dims, cap, cell_len, eps24, sig2,
                       shift6, rc2, z_halo=False, compute_macro=True,
                       compute_vi=False, parts=False):
    """The launch of csrc/lj_cells_cw.cu behind lj_cell_forces_cw, on
    checked inputs: (f, u6, vir), or (f, part) with `parts`.  Where
    cw_half_shell holds, K1's launch (launch_lj_cells: the same inputs,
    the half shell)."""
    if cw_half_shell(r_j, dims, z_halo, compute_vi):
        return launch_lj_cells(
            r_i, dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
            shift6=shift6, rc2=rc2, compute_macro=compute_macro, parts=parts)
    nx, ny, nz = dims
    src = r_i if r_j is None else r_j
    Pi, Pj = _planes(r_i, nx * cap), _planes(src, nx * cap)
    return _launch(
        "lj_cells_cw", r_i, 6 if compute_vi else 3, dims, cap,
        lambda f, part: (
            r_i.data_ptr(), src.data_ptr(), f.data_ptr(), part.data_ptr(),
            nx, ny, nz, cap, Pi, Pj, int(bool(z_halo)),
            *(float(c) for c in cell_len), float(eps24), float(sig2),
            float(shift6), float(rc2), int(bool(compute_macro)),
            int(bool(compute_vi))),
        compute_macro, parts=parts)


def pairs_from_part(part, halved=True):
    """Pairs inside the cutoff counted by a launch with eps24 = 0 and
    shift6 = 1: a row's u6 is its count, halved where the kernel sees
    each pair from both sides (the ordered count is then twice it; exact
    in f32 below 2^24 pairs a row), and the rows are summed in f64.
    halved=False: K1, K8 and K10, each pair once, their unordered count.
    K3's half shell counts each pair once too: twice its count is the
    ordered count of K3's half-shell plain version."""
    total = float(part[:, 0].sum(dtype=torch.float64))
    return int(round(2.0 * total if halved else total))


def inside_pairs_reference(r_i, r_j=None, *, dims=None, cap=None, rc2,
                           cell_len=None, z_halo=False, compute_vi=False,
                           kernel="K3", **row):
    """Pairs inside the cutoff that the plain version of a kernel
    evaluates on these inputs, counted from its masks: ordered pairs of
    K3 (r_j, z_halo, compute_vi: twice the unordered count where
    cw_half_shell holds; K9's with r_j None), K4 (kernel="row", r_j its
    j view, `row` its box, hx, local_coords and y_halo), K7
    (kernel="lanej": K4's in local mode with one x halo cell, `row` its
    box) or K9's Gram form
    (kernel="zb_gram", whose r^2 is the Gram one); unordered pairs of K1
    and K8 (kernel="K1" or "n3l", r_j None; one plain version) and of K10
    (kernel="packed": r_i its pos4, `row` its tab, meta, nx, ny, nz, Wp
    and box)."""
    if kernel == "packed":
        from ls1_mardyn_tpu_torch.ops.cuda_packed import lj_forces_packed_reference

        return lj_forces_packed_reference(
            r_i, row.pop("tab"), row.pop("meta"), eps24=0.0, sig2=0.0,
            shift6=0.0, rc2=rc2, compute_macro=False, count=True, **row)
    nx, ny, nz = dims
    half = kernel in ("K1", "n3l") or (
        kernel == "K3" and cw_half_shell(r_j, dims, z_halo, compute_vi))
    if half:
        n = lj_cell_forces_reference(
            r_i, dims=dims, cap=cap, cell_len=cell_len, eps24=0.0, sig2=0.0,
            shift6=0.0, rc2=rc2, compute_macro=False, count=True)
        return n if kernel != "K3" else 2 * n
    pos_i, val_i = _cells(r_i, nx, cap)
    kw = dict(cap=cap, eps24=0.0, sig2=0.0, shift6=0.0, rc2=rc2,
              compute_macro=False, count=True)
    if kernel == "lanej":
        kernel, row = "row", dict(row, hx=1, local_coords=True)
    if kernel == "row":
        return _reference(pos_i, val_i, _row_j_cells(
            r_j, dims=dims, cap=cap, z_halo=z_halo, **row), **kw)
    pos_j, val_j = (pos_i, val_i) if r_j is None else _cells(r_j, nx, cap)
    j_cells = _local_j_cells(pos_j, val_j, cell_len, nz, z_halo)
    if kernel == "zb_gram":
        from ls1_mardyn_tpu_torch.ops.cuda_lj_variants import _gram_reference

        return _gram_reference(pos_i, val_i, j_cells, **kw)
    return _reference(pos_i, val_i, j_cells, **kw)


def inside_pairs(r_i, r_j=None, *, kernel="K3", **kw):
    """Pairs inside the cutoff that a kernel evaluates on these inputs:
    its launch with eps24 = 0 and shift6 = 1, counted by pairs_from_part
    (ordered pairs; unordered for K1, K8 and K10).  kernel: "K3" (r_j,
    z_halo, compute_vi), "K1" (r_j None), "row" (K4: r_j its j view, and
    its box, hx, local_coords, z_halo, y_halo), "lanej" (K7: r_j its j
    view, and its box), "n3l" (K8, r_j None), "zb" or "zb_gram" (K9
    plain or Gram, r_j None), "packed" (K10: r_i its pos4; kw its tab,
    meta, nx, ny, nz, Wp, box and rc2); kw: dims, cap, rc2 and cell_len
    (all but K4, K7 and K10), and the kernel's options.  A CPU tensor counts the plain
    version's pairs (inside_pairs_reference)."""
    if r_i.device.type == "cpu":
        return inside_pairs_reference(r_i, r_j, kernel=kernel, **kw)
    if kernel == "packed":
        from ls1_mardyn_tpu_torch.ops.cuda_packed import launch_lj_packed

        _, part = launch_lj_packed(r_i, kw.pop("tab"), kw.pop("meta"), eps24=0.0,
                                   sig2=0.0, shift6=1.0, parts=True, **kw)
        return pairs_from_part(part, halved=False)
    kw.update(eps24=0.0, sig2=0.0, shift6=1.0, parts=True)
    if kernel in ("K1", "n3l", "zb", "zb_gram"):
        if r_j is not None or kw.pop("z_halo", False):
            raise ValueError(f"inside_pairs: {kernel} reads its own j cells")
    from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V

    if kernel == "K1":
        _, part = launch_lj_cells(r_i, **kw)
        return pairs_from_part(part, halved=False)
    elif kernel in ("zb", "zb_gram"):
        _, part = V.launch_lj_cells_zb(r_i, gram=kernel == "zb_gram", **kw)
    elif kernel == "n3l":
        _, part = V.launch_lj_cells_n3l(r_i, **kw)
        return pairs_from_part(part, halved=False)
    elif kernel == "lanej":
        _, part = V.launch_lj_cells_lanej(r_i, r_j, **kw)
    elif kernel == "row":
        _, part = launch_lj_cells_row(r_i, r_j, **kw)
    else:
        _, part = launch_lj_cells_cw(r_i, r_j, **kw)
    return pairs_from_part(part)


# -- K4: row kernel on an explicit j view ---------------------------------------

def _row_units(dims, box, local_coords):
    """Image-shift units of K4: the cell edges in local mode, (0, by,
    bz) in absolute mode (the x halo is pre-shifted by the caller)."""
    if local_coords:
        return tuple(float(b) / d for b, d in zip(box, dims))
    return (0.0, float(box[1]), float(box[2]))


def _row_j_cells(r_j, *, dims, cap, box, hx=1, local_coords=False,
                 z_halo=False, y_halo=False):
    """j_cells of K4's j view r_j [nz(+2), ny(+2), 4, (nx+2*hx)*cap]:
    the neighbour cells of the +-1-cell window with their image shift
    (whole cell edges in local mode; -+by / -+bz where a row index
    wrapped in absolute mode, nothing for an explicit halo row)."""
    nx, ny, nz = dims
    dtype, dev = r_j.dtype, r_j.device
    pos_j, val_j = _cells(r_j, nx + 2 * hx, cap)
    units = torch.tensor(_row_units(dims, box, local_coords), dtype=dtype,
                         device=dev)
    ys = torch.arange(ny, device=dev)

    def rows(idx, d, n, halo):
        """Row indices into the j view and the image multiplier of each
        i row for neighbour offset d."""
        raw = idx + d
        if local_coords:
            mult = torch.full_like(raw, d)
        elif halo:
            mult = torch.zeros_like(raw)
        else:
            mult = (raw >= n).to(torch.long) - (raw < 0).to(torch.long)
        return (raw + 1 if halo else torch.remainder(raw, n)), mult

    def j_cells(z0, z1, off):
        dz, dy, dx = off
        zj, mz = rows(torch.arange(z0, z1, device=dev), dz, nz, z_halo)
        yj, my = rows(ys, dy, ny, y_halo)
        x0 = hx + dx
        pj = pos_j.index_select(0, zj).index_select(1, yj)[:, :, x0:x0 + nx]
        vj = val_j.index_select(0, zj).index_select(1, yj)[:, :, x0:x0 + nx]
        mult = torch.zeros((z1 - z0, ny, 1, 1, 3), dtype=dtype, device=dev)
        mult[..., 0] = dx if local_coords else 0
        mult[..., 1] = my.to(dtype)[None, :, None, None]
        mult[..., 2] = mz.to(dtype)[:, None, None, None]
        return pj + mult * units, vj

    return j_cells


def lj_cell_forces_row_reference(
    r_i, r_j, *, dims, cap, box, eps24, sig2, shift6, rc2, hx=1,
    local_coords=False, z_halo=False, y_halo=False, compute_macro=True,
    sentinel=False
):
    """Plain PyTorch version of K4 (see lj_cell_forces_row)."""
    nx = dims[0]
    pos_i, val_i = _cells(r_i, nx, cap)
    j_cells = _row_j_cells(r_j, dims=dims, cap=cap, box=box, hx=hx,
                           local_coords=local_coords, z_halo=z_halo,
                           y_halo=y_halo)
    f, _, u6, vir = _reference(
        pos_i, val_i, j_cells, cap=cap, eps24=eps24, sig2=sig2, shift6=shift6,
        rc2=rc2, compute_macro=compute_macro)
    return _planes_out(f, nx, cap), u6, vir


def lj_cell_forces_row(
    r_i, r_j, *, dims, cap, box, eps24, sig2, shift6, rc2, hx=1,
    local_coords=False, z_halo=False, y_halo=False, compute_macro=True,
    sentinel=False
):
    """K4 wrapper: double-sided 1CLJ forces of r_i [nz, ny, 4, nx*cap]
    against a separate j view r_j [nz(+2), ny(+2), 4, (nx+2*hx)*cap]
    with hx halo cells per side in x and, with z_halo / y_halo, one
    explicit halo row per side in z / y (what a decomposed caller feeds
    with exchanged rows).  The i slot meets the +-1-cell window.

    local_coords: cell-local coordinates, the x halo cells are plain
    periodic copies and the neighbour at (dx,dy,dz) is shifted by whole
    cell edges.  Otherwise absolute coordinates: the caller pre-shifted
    the x halo by -+Lx, and the kernel adds -+by, -+bz to a j row whose
    row index wrapped (nothing for an explicit halo row).
    `sentinel` says that invalid slots carry the far-away y fill; the
    kernel masks on the validity plane and ignores it.
    Returns (f [nz,ny,3,nx*cap], u6, vir)."""
    nx, ny, nz = dims
    what = "lj_cell_forces_row"
    _check(r_i, (nz, ny, 4, nx * cap), cap, what)
    _check(r_j, (nz + 2 * bool(z_halo), ny + 2 * bool(y_halo), 4,
                 (nx + 2 * hx) * cap), cap, what)
    if r_j.dtype != r_i.dtype or r_j.device != r_i.device:
        raise ValueError(f"{what}: r_i and r_j differ in dtype or device")
    if hx < 1:
        raise ValueError(f"{what}: hx {hx} (>= 1 halo cell per side)")
    edge = min(float(b) / d for b, d in zip(box, dims))
    if edge ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {edge} < cutoff")
    kw = dict(dims=dims, cap=cap, box=box, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, hx=hx, local_coords=local_coords,
              z_halo=z_halo, y_halo=y_halo, compute_macro=compute_macro)
    if r_i.device.type == "cpu":
        return lj_cell_forces_row_reference(r_i, r_j, **kw)
    if r_i.device.type != "cuda":
        raise ValueError(f"{what}: device {r_i.device}")
    if not (r_i.is_contiguous() and r_j.is_contiguous()):
        raise ValueError(f"{what}: r_i and r_j must be contiguous")
    out = launch_lj_cells_row(r_i, r_j, **kw)
    lj_cell_forces_row.launches += 1
    return out


lj_cell_forces_row.launches = 0


def launch_lj_cells_row(r_i, r_j, *, dims, cap, box, eps24, sig2, shift6, rc2,
                        hx=1, local_coords=False, z_halo=False, y_halo=False,
                        compute_macro=True, parts=False):
    """The launch of csrc/lj_cells_row.cu behind lj_cell_forces_row, on
    checked inputs: (f, u6, vir), or (f, part) with `parts`."""
    nx, ny, nz = dims
    units = _row_units(dims, box, local_coords)
    return _launch(
        "lj_cells_row", r_i, 3, dims, cap,
        lambda f, part: (
            r_i.data_ptr(), r_j.data_ptr(), f.data_ptr(), part.data_ptr(),
            nx, ny, nz, cap, hx, int(bool(local_coords)), int(bool(z_halo)),
            int(bool(y_halo)), *units, float(eps24), float(sig2),
            float(shift6), float(rc2), int(bool(compute_macro))),
        compute_macro, parts=parts)
