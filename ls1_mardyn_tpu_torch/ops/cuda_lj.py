"""Kernel K1: LJ-12-6 cell forces on the dense RMM layout.

The CUDA kernel (csrc/lj_cells.cu) replaces the TPU kernel
ls1_mardyn_tpu/ops/pallas_lj.py: lj_cell_forces_pallas_cwn3l.  Its
plain PyTorch version, `lj_cell_forces_reference`, sits beside it: the
CPU tests hold it against the JAX kernel, and chip_smoke.py holds the
CUDA kernel against it on the card.

Layout: r4 [nz, ny, 4, nx*cap] holds cell-local (x, y, z, valid) with
cap slots per cell along the last axis (x-major cell rows).  Periodic
images are exact integer cell offsets: dr = r_i - r_j - off*cell_len
for the neighbour cell at offset off in {-1,0,1}^3.
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
# CUDA kernel masks on validity and does not rely on it; the rebin keeps
# writing it so the state stays identical to the JAX package's.
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


# pair lanes per chunk of the plain version (bounds its temporaries)
_REF_CHUNK = 1 << 24


def lj_cell_forces_reference(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True
):
    """Plain PyTorch version of K1: for each of the 27 neighbour-cell
    offsets, gather the neighbour cells with a periodic roll and
    evaluate all cap x cap slot pairs.  Double-sided; u6 and the virial
    are halved per pair.  Returns (f [nz,ny,3,nx*cap], u6, vir)."""
    nx, ny, nz = dims
    dtype, dev = r4.dtype, r4.device
    g = r4.reshape(nz, ny, 4, nx, cap).permute(0, 1, 3, 4, 2)  # [nz,ny,nx,cap,4]
    pos = g[..., :3]
    val = g[..., 3] > 0.5
    cl = torch.tensor(cell_len, dtype=dtype, device=dev)
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    f = torch.zeros((nz, ny, nx, cap, 3), dtype=dtype, device=dev)
    u6 = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)
    zc = max(1, min(nz, _REF_CHUNK // (ny * nx * cap * cap)))
    for z0 in range(0, nz, zc):
        z1 = min(nz, z0 + zc)
        zs = torch.arange(z0, z1, device=dev)
        pi, vi = pos[z0:z1], val[z0:z1]
        fi = torch.zeros_like(pi)
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            zj = torch.remainder(zs + dz, nz)
            pj = torch.roll(pos.index_select(0, zj), (-dy, -dx), (1, 2))
            vj = torch.roll(val.index_select(0, zj), (-dy, -dx), (1, 2))
            off = torch.tensor((dx, dy, dz), dtype=dtype, device=dev) * cl
            dr = pi[..., :, None, :] - (pj + off)[..., None, :, :]
            # rounded as the CUDA kernel rounds it: same cutoff decisions
            dr2 = dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1] \
                + dr[..., 2] * dr[..., 2]
            m = vi[..., :, None] & vj[..., None, :] & (dr2 < rc2)
            if dx == dy == dz == 0:
                m = m & ~eye
            # the pair function runs on the pairs inside the cutoff only
            idx = m.nonzero(as_tuple=True)
            drm = dr[idx]
            fp, u6p = potentials.lj(drm, dr2[idx], eps24, sig2)
            fi.index_put_(idx[:-1], fp, accumulate=True)
            if compute_macro:
                u6 += (u6p + shift6).sum()
                vir += (fp * drm).sum()
        f[z0:z1] = fi
    f = f.permute(0, 1, 4, 2, 3).reshape(nz, ny, 3, nx * cap)
    return f, 0.5 * u6, 0.5 * vir


def _check(r4, dims, cap):
    nx, ny, nz = dims
    if r4.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lj_cell_forces: dtype {r4.dtype} (f32/f64 only)")
    if tuple(r4.shape) != (nz, ny, 4, nx * cap):
        raise ValueError(
            f"lj_cell_forces: r4 shape {tuple(r4.shape)} != "
            f"{(nz, ny, 4, nx * cap)}"
        )
    if min(dims) < 3:
        raise ValueError(f"lj_cell_forces: dims {dims} need >= 3 cells per axis")
    if cap % 32 or not 32 <= cap <= 1024:
        raise ValueError(f"lj_cell_forces: cap {cap} (multiple of 32, <= 1024)")


def _planes(r4, W):
    """Plane count P of the contiguous [nz,ny,P,W] tensor r4 is a
    leading-plane slice of; raises on any other layout."""
    s0, s1, s2, s3 = r4.stride()
    P = s1 // W
    if s3 != 1 or s2 != W or s1 != P * W or P < 4 or s0 != r4.shape[1] * s1:
        raise ValueError(
            "lj_cell_forces: r4 must be planes [:, :, :4, :] of a "
            f"contiguous [nz,ny,P,W] tensor (strides {r4.stride()})"
        )
    return P


def _lib():
    lib = _build.load("lj_cells")
    if not getattr(lib, "_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.lj_cells_f32, lib.lj_cells_f64):
            fn.argtypes = [vp, vp, vp] + [ci] * 5 + [cd] * 7 + [ci, vp]
            fn.restype = ci
        lib.lj_cells_num_blocks.argtypes = [ci] * 4
        lib.lj_cells_num_blocks.restype = ci
        lib._typed = True
    return lib


def lj_cell_forces(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True
):
    """K1 wrapper.  r4 [nz, ny, 4, nx*cap] (may be the first 4 planes of
    the RMM state's 8-plane tensor).  Returns (f [nz,ny,3,nx*cap], u6,
    vir); u6 and vir are 0-d tensors, zero when compute_macro=False.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    _check(r4, dims, cap)
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, compute_macro=compute_macro)
    if r4.device.type == "cpu":
        return lj_cell_forces_reference(r4, **kw)
    if r4.device.type != "cuda":
        raise ValueError(f"lj_cell_forces: device {r4.device}")
    nx, ny, nz = dims
    W = nx * cap
    P = _planes(r4, W)
    lib = _lib()
    f = torch.empty((nz, ny, 3, W), dtype=r4.dtype, device=r4.device)
    nb = lib.lj_cells_num_blocks(nx, ny, nz, cap)
    part = torch.empty((nb, 2), dtype=r4.dtype, device=r4.device)
    fn = lib.lj_cells_f32 if r4.dtype == torch.float32 else lib.lj_cells_f64
    stream = torch.cuda.current_stream(r4.device).cuda_stream
    status = fn(
        r4.data_ptr(), f.data_ptr(), part.data_ptr(), nx, ny, nz, cap, P,
        *(float(c) for c in cell_len), float(eps24), float(sig2),
        float(shift6), float(rc2), int(bool(compute_macro)), stream,
    )
    _build.check(status, "lj_cells")
    lj_cell_forces.launches += 1
    if compute_macro:
        u6, vir = part.sum(0).unbind()
    else:
        u6 = vir = torch.zeros((), dtype=r4.dtype, device=r4.device)
    return f, u6, vir


lj_cell_forces.launches = 0
