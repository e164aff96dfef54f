"""Kernel K2: the nearest-neighbour shift-merge rebin.

The CUDA kernel (csrc/rebin_shift.cu: a hop-code pass and a gather
pass, two launches a call) replaces the TPU kernel
ls1_mardyn_tpu/ops/pallas_rebin.py: rebin_shift_pallas, whose three
stages (x, y, z) it computes in two passes over memory.  Its plain
PyTorch version, `rebin_shift_reference`, is a line-for-line port of
ls1_mardyn_tpu/ops/rmm.py: RMMSimulation._rebin_shift (after its Kahan
fold, which stays with the caller).  All three are bit-identical, and so
is the overflow flag; where the flag is set the caller discards the
output, and the kernel's output there is not the stages' (a cell that
overflows keeps its first cap molecules in the final order).

Data: big [nz, ny, 11, nx*cap], columns (x, y, z, valid, vx, vy, vz,
mid, fx, fy, fz) in cell-local coordinates.
"""

from __future__ import annotations

import ctypes

import torch

from ls1_mardyn_tpu_torch.ops import _build
from ls1_mardyn_tpu_torch.ops.cuda_lj import SENTINEL_SCALE

NCOLS = 11
_BIG = 2**31 - 1


def rebin_shift_reference(big, *, dims, cap, cell_len, sentinel):
    """Plain PyTorch version of K2.  Per stage (x, then y, then z) every
    cell's slot row is re-packed from its 3 candidate rows (left
    neighbour, own, right neighbour, via torch.roll) by one stable
    3*cap-wide sort keyed by "belongs to this cell after the hop".
    Returns (out [nz,ny,11,nx*cap], overflow 0-d bool tensor); overflow
    latches |hop| > 1 (skin violated) and cell-full."""
    nx, ny, nz = dims
    dtype, dev = big.dtype, big.device

    def grid4(a):
        return a.reshape(nz, ny, nx, cap)

    cols = [grid4(big[:, :, c, :]) for c in range(NCOLS)]
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slot_iota = torch.arange(cap, dtype=torch.int32, device=dev).expand(
        nz, ny, nx, cap
    )
    # stage axes: coordinate column, cell length, roll axis
    for coord_c, cl_a, axis in ((0, cell_len[0], 2), (1, cell_len[1], 1),
                                (2, cell_len[2], 0)):
        cla = torch.tensor(float(cl_a), dtype=dtype, device=dev)
        valid = cols[3] > 0.5
        d = torch.floor(cols[coord_c] / cla).to(torch.int32)
        overflow = overflow | (valid & (d.abs() > 1)).any()
        keys = []
        payload = [[] for _ in cols]
        for ri, roll in enumerate((1, 0, -1)):
            # roll=+1 presents cell c-1's row to cell c: those
            # molecules belong here iff their hop d == +1
            dr = torch.roll(d, roll, axis) if roll else d
            vr = torch.roll(valid, roll, axis) if roll else valid
            belong = vr & (dr == roll)
            keys.append(torch.where(belong, slot_iota + cap * ri, _BIG))
            for ci, a in enumerate(cols):
                ar = torch.roll(a, roll, axis) if roll else a
                if ci == coord_c:
                    # hop adjusts the cell-local coordinate
                    ar = ar - torch.tensor(float(roll), dtype=dtype, device=dev) * cla
                payload[ci].append(ar)
        key = torch.cat(keys, dim=-1)  # [nz, ny, nx, 3cap]
        key_s, order = torch.sort(key, dim=-1, stable=True)
        # molecules beyond cap have nowhere to go: cell overflow
        overflow = overflow | (key_s[..., cap:] < _BIG).any()
        placed = key_s[..., :cap] < _BIG
        idx = order[..., :cap]
        cols = [torch.cat(pc, dim=-1).gather(-1, idx) for pc in payload]
        # clear dropped/empty slots (validity column drives the rest;
        # coordinate columns re-filled after the last stage)
        cols[3] = torch.where(placed, cols[3], 0.0)
    valid = cols[3] > 0.5
    if sentinel:
        ysent = SENTINEL_SCALE * (1.0 + slot_iota.to(dtype))
        cols[1] = torch.where(valid, cols[1], ysent)
        cols[0] = torch.where(valid, cols[0], 0.0)
        cols[2] = torch.where(valid, cols[2], 0.0)
    else:
        for c in (0, 1, 2):
            cols[c] = torch.where(valid, cols[c], 0.0)
    for c in range(4, NCOLS):
        cols[c] = torch.where(valid, cols[c], 0.0)
    out = torch.stack([c.reshape(nz, ny, nx * cap) for c in cols], dim=2)
    return out, overflow


def _lib():
    return type_lib(_build.load("rebin_shift"))


def type_lib(lib):
    """Set the argument and result types of a loaded csrc/rebin_shift.cu
    library's entry points (once); returns it."""
    if not getattr(lib, "_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.rebin_shift_f32, lib.rebin_shift_f64):
            fn.argtypes = [vp] * 4 + [ci] * 4 + [cd] * 3 + [ci, vp]
            fn.restype = ci
        lib._typed = True
    return lib


def rebin_shift(big, *, dims, cap, cell_len, sentinel):
    """K2 wrapper.  big [nz, ny, 11, nx*cap] contiguous, f32 or f64.
    Returns (out, overflow) as rebin_shift_reference does.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises.  `rebin_shift.launches`
    counts kernel launches, two per call (the hop pass and the gather
    pass)."""
    nx, ny, nz = dims
    if big.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rebin_shift: dtype {big.dtype} (f32/f64 only)")
    if tuple(big.shape) != (nz, ny, NCOLS, nx * cap):
        raise ValueError(
            f"rebin_shift: shape {tuple(big.shape)} != {(nz, ny, NCOLS, nx * cap)}"
        )
    if not big.is_contiguous():
        raise ValueError("rebin_shift: big must be contiguous")
    if cap % 32 or not 32 <= cap <= 1024:
        raise ValueError(f"rebin_shift: cap {cap} (multiple of 32, <= 1024)")
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, sentinel=sentinel)
    if big.device.type == "cpu":
        return rebin_shift_reference(big, **kw)
    if big.device.type != "cuda":
        raise ValueError(f"rebin_shift: device {big.device}")
    out = launch_rebin_shift(big, **kw)
    rebin_shift.launches += 2
    return out


rebin_shift.launches = 0


def launch_rebin_shift(big, *, dims, cap, cell_len, sentinel):
    """The launches of csrc/rebin_shift.cu behind rebin_shift, on checked
    inputs: (out, overflow 0-d bool tensor)."""
    nx, ny, nz = dims
    lib = _lib()
    fn = lib.rebin_shift_f32 if big.dtype == torch.float32 else lib.rebin_shift_f64
    ovf = torch.zeros((1,), dtype=torch.int32, device=big.device)
    out = torch.empty_like(big)
    code = torch.empty((nz, ny, nx * cap), dtype=torch.uint8, device=big.device)
    _build.check(fn(big.data_ptr(), out.data_ptr(), code.data_ptr(), ovf.data_ptr(),
                    nx, ny, nz, cap, *(float(c) for c in cell_len),
                    int(bool(sentinel)), _build.stream_of(lib, big, "rebin_shift")),
                 "rebin_shift")
    return out, ovf[0] != 0
