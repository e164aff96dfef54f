"""Kernels K7, K8 and K9: the LJ-12-6 kernel variants of the JAX RMM engine.

The JAX package keeps three more 1CLJ cell kernels behind switches of
its RMMSimulation (ls1_mardyn_tpu/ops/rmm.py: lanej, n3l, zb); each
computes the function of K1 with another traversal.  The port's RMM
engine runs K1 alone; each kernel here stands for one of the three as a
library function, with its plain PyTorch version beside it:

  K7 lj_cell_forces_lanej  csrc/lj_cells_lanej.cu  lj_cell_forces_pallas_lanej
  K8 lj_cell_forces_n3l    csrc/lj_cells.cu (K1)   lj_cell_forces_pallas_n3l
  K9 lj_cell_forces_zb     csrc/lj_cells_zb.cu     lj_cell_forces_pallas_zb

Layouts are ops/cuda_lj.py's (cell-local coordinates, cap slots per cell
along the last axis).  K8 and K9 read the RMM state's planes in place;
K7 takes the i planes and a j view with one x halo cell per side, as
the TPU kernel and K4 do.  Energies: K7 and K9 evaluate each pair from
both sides and halve u6 and the virial, K8 evaluates each pair once, as
K1 does.  A wrapper takes the plain version only for a CPU tensor; a
CUDA tensor launches the kernel (built at first use) or raises.  K7 and
K9 run on the warp skeleton of csrc/lj_warp.cuh, which takes any cap
the wrappers take, K7 with K4's neighbour functor.  The TPU's K8 is the
half-shell traversal that K1 now walks, so K8 launches K1's kernel
(ops/cuda_lj.launch_lj_cells), and K1's plain version is K8's.
launch_lj_cells_lanej and launch_lj_cells_zb are the launches of K7 and
K9 on checked inputs.
"""

from __future__ import annotations

import itertools

import torch

from ls1_mardyn_tpu_torch.ops.cuda_lj import (
    _REF_CHUNK,
    _cells,
    _check,
    _launch,
    _local_j_cells,
    _planes,
    _planes_out,
    _reference,
    _row_units,
    launch_lj_cells,
    lj_cell_forces_reference,
    lj_cell_forces_row_reference,
)

def _device_check(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: device {t.device}")


# -- K7: K4's function in cell-local mode -----------------------------------------

def lj_cell_forces_lanej(
    r_i, r_j, *, dims, cap, box, eps24, sig2, shift6, rc2, compute_macro=True,
    defer=True
):
    """K7 wrapper: double-sided 1CLJ forces of r_i [nz, ny, 4, nx*cap]
    (cell-local coordinates) against the 9 neighbour rows of the j view
    r_j [nz, ny, 4, (nx+2)*cap] with one periodic halo cell per side in
    x.  The function is K4's in local mode
    (lj_cell_forces_row_reference is its plain version).  `defer` chose
    where the TPU kernel reduced over its j lanes (once per tile, not per
    neighbour row), i.e. the order of the sums; the CUDA kernel has no
    such reduction, and both values give bit-identical results.
    Returns (f [nz,ny,3,nx*cap], u6, vir)."""
    nx, ny, nz = dims
    what = "lj_cell_forces_lanej"
    _check(r_i, (nz, ny, 4, nx * cap), cap, what)
    _check(r_j, (nz, ny, 4, (nx + 2) * cap), cap, what)
    if r_j.dtype != r_i.dtype or r_j.device != r_i.device:
        raise ValueError(f"{what}: r_i and r_j differ in dtype or device")
    units = _row_units(dims, box, True)
    if min(units) ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {min(units)} < cutoff")
    if r_i.device.type == "cpu":
        return lj_cell_forces_row_reference(
            r_i, r_j, dims=dims, cap=cap, box=box, eps24=eps24, sig2=sig2,
            shift6=shift6, rc2=rc2, local_coords=True,
            compute_macro=compute_macro)
    _device_check(r_i, what)
    if not (r_i.is_contiguous() and r_j.is_contiguous()):
        raise ValueError(f"{what}: r_i and r_j must be contiguous")
    out = launch_lj_cells_lanej(
        r_i, r_j, dims=dims, cap=cap, box=box, eps24=eps24, sig2=sig2,
        shift6=shift6, rc2=rc2, compute_macro=compute_macro, defer=defer)
    lj_cell_forces_lanej.launches += 1
    return out


lj_cell_forces_lanej.launches = 0


def launch_lj_cells_lanej(r_i, r_j, *, dims, cap, box, eps24, sig2, shift6,
                          rc2, compute_macro=True, defer=True, parts=False):
    """The launch of csrc/lj_cells_lanej.cu behind lj_cell_forces_lanej,
    on checked inputs: (f, u6, vir), or (f, part) with `parts`."""
    nx, ny, nz = dims
    units = _row_units(dims, box, True)
    return _launch(
        "lj_cells_lanej", r_i, 3, dims, cap,
        lambda f, part: (
            r_i.data_ptr(), r_j.data_ptr(), f.data_ptr(), part.data_ptr(),
            nx, ny, nz, cap, *units, float(eps24), float(sig2),
            float(shift6), float(rc2), int(bool(compute_macro)),
            int(bool(defer))),
        compute_macro, parts=parts)


# -- K8: Newton's third law, the half shell --------------------------------------

# the TPU's half-shell variant is K1's traversal: one kernel and one plain
# version serve both
lj_cell_forces_n3l_reference = lj_cell_forces_reference


def lj_cell_forces_n3l(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True
):
    """K8 wrapper: 1CLJ forces of the cell-local layout r4 [nz, ny, 4,
    nx*cap] (may be the first 4 planes of the RMM state's 8-plane
    tensor) by Newton's third law: each pair once, the reaction written
    to j, by K1's launch.  Needs nx, ny, nz >= 3 (with two cells on an
    axis the offsets +1 and -1 reach the same cell, and the forward half
    is no half).  Returns (f [nz,ny,3,nx*cap], u6, vir), u6 and vir
    counted once per pair (the totals of K1)."""
    nx, ny, nz = dims
    what = "lj_cell_forces_n3l"
    _check(r4, (nz, ny, 4, nx * cap), cap, what)
    if min(dims) < 3:
        raise ValueError(f"{what}: dims {dims} need >= 3 cells per axis")
    if min(cell_len) ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {min(cell_len)} < cutoff")
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, compute_macro=compute_macro)
    if r4.device.type == "cpu":
        return lj_cell_forces_n3l_reference(r4, **kw)
    _device_check(r4, what)
    out = launch_lj_cells(r4, **kw)
    lj_cell_forces_n3l.launches += 1
    return out


lj_cell_forces_n3l.launches = 0


# -- K9: z bands, and the Gram form ---------------------------------------------

def _norm2(a):
    """((x*x + y*y) + z*z) over the last axis, the kernels' order."""
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def _gram_reference(pos_i, val_i, j_cells, *, cap, eps24, sig2, shift6, rc2,
                    compute_macro, count=False):
    """The pair sum of K9's gram mode: r^2 = (|r_j|^2 + |r_i|^2) -
    (r_i.r_j + r_i.r_j) and F_i = r_i * sum_j fac - sum_j fac * r_j, in
    coordinates local to the i cell (j_cells adds the image shift).  The
    masks (validity, cutoff, j != i) come before any Gram term counts.
    With `count`, the number of ordered pairs inside the cutoff by the
    Gram r^2 (an int)."""
    nz, ny, nx = pos_i.shape[:3]
    dtype, dev = pos_i.dtype, pos_i.device
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    f = torch.zeros((nz, ny, nx, cap, 3), dtype=dtype, device=dev)
    u6 = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)
    zc = max(1, min(nz, _REF_CHUNK // (ny * nx * cap * cap)))
    n_inside = 0
    for z0 in range(0, nz, zc):
        z1 = min(nz, z0 + zc)
        pi, vi = pos_i[z0:z1], val_i[z0:z1]
        si = _norm2(pi)
        s0 = torch.zeros_like(si)
        sr = torch.zeros_like(pi)
        for off in itertools.product((-1, 0, 1), repeat=3):
            pj, vj = j_cells(z0, z1, off)
            cr = pi[..., :, None, 0] * pj[..., None, :, 0] \
                + pi[..., :, None, 1] * pj[..., None, :, 1] \
                + pi[..., :, None, 2] * pj[..., None, :, 2]
            dr2 = (_norm2(pj)[..., None, :] + si[..., :, None]) - (cr + cr)
            m = vi[..., :, None] & vj[..., None, :] & (dr2 < rc2)
            if off == (0, 0, 0):
                m = m & ~eye
            if count:
                n_inside += int(m.sum())
                continue
            idx = m.nonzero(as_tuple=True)
            d2 = dr2[idx]
            inv = 1.0 / d2
            lj6 = sig2 * inv
            lj6 = lj6 * lj6 * lj6
            lj12m6 = lj6 * lj6 - lj6
            fac = eps24 * (lj6 * lj6 + lj12m6) * inv
            s0.index_put_(idx[:-1], fac, accumulate=True)
            rj = pj[idx[0], idx[1], idx[2], idx[4]]
            sr.index_put_(idx[:-1], fac[:, None] * rj, accumulate=True)
            if compute_macro:
                u6 += (eps24 * lj12m6 + shift6).sum()
                vir += (fac * d2).sum()
        f[z0:z1] = pi * s0[..., None] - sr
    if count:
        return n_inside
    return f, 0.5 * u6, 0.5 * vir


def lj_cell_forces_zb_reference(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True,
    gram=False
):
    """Plain PyTorch version of K9 (see lj_cell_forces_zb): the
    double-sided pair sum of K3 (_reference), or with `gram` the Gram form
    of r^2 and of the force."""
    nx, ny, nz = dims
    pos, val = _cells(r4, nx, cap)
    j_cells = _local_j_cells(pos, val, cell_len, nz, False)
    kw = dict(cap=cap, eps24=eps24, sig2=sig2, shift6=shift6, rc2=rc2,
              compute_macro=compute_macro)
    if gram:
        f, u6, vir = _gram_reference(pos, val, j_cells, **kw)
    else:
        f, _, u6, vir = _reference(pos, val, j_cells, **kw)
    return _planes_out(f, nx, cap), u6, vir


def lj_cell_forces_zb(
    r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2, compute_macro=True,
    gram=False
):
    """K9 wrapper: K1's function (double-sided 1CLJ forces of the
    cell-local layout r4 [nz, ny, 4, nx*cap], which may be the first 4
    planes of the RMM state's 8-plane tensor; u6 and the virial halved
    per pair).  The TPU kernel walks it by z bands; the CUDA kernel runs
    on K1's warp skeleton.  With `gram`, r^2 and the force take the Gram
    form (see _gram_reference), masked on validity first, so the RMM
    state's sentinel fill never counts.
    Returns (f [nz,ny,3,nx*cap], u6, vir)."""
    nx, ny, nz = dims
    what = "lj_cell_forces_zb"
    _check(r4, (nz, ny, 4, nx * cap), cap, what)
    if min(cell_len) ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {min(cell_len)} < cutoff")
    kw = dict(dims=dims, cap=cap, cell_len=cell_len, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, compute_macro=compute_macro, gram=gram)
    if r4.device.type == "cpu":
        return lj_cell_forces_zb_reference(r4, **kw)
    _device_check(r4, what)
    out = launch_lj_cells_zb(r4, **kw)
    lj_cell_forces_zb.launches += 1
    return out


lj_cell_forces_zb.launches = 0


def launch_lj_cells_zb(r4, *, dims, cap, cell_len, eps24, sig2, shift6, rc2,
                       compute_macro=True, gram=False, parts=False):
    """The launch of csrc/lj_cells_zb.cu behind lj_cell_forces_zb, on
    checked inputs: (f, u6, vir), or (f, part) with `parts`."""
    nx, ny, nz = dims
    P = _planes(r4, nx * cap)
    return _launch(
        "lj_cells_zb", r4, 3, dims, cap,
        lambda f, part: (
            r4.data_ptr(), f.data_ptr(), part.data_ptr(), nx, ny, nz, cap, P,
            *(float(c) for c in cell_len), float(eps24), float(sig2),
            float(shift6), float(rc2), int(bool(compute_macro)),
            int(bool(gram))),
        compute_macro, parts=parts)
