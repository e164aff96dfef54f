"""Kernel K5: rigid multi-site molecule forces on occupancy-packed cell
rows (the counterpart of ls1_mardyn_tpu/ops/pallas_ms_packed.py).

  K5 multisite_cell_forces_packed   csrc/ms_packed.cu
     replaces multisite_cell_forces_packed (_ms_packed_kernel)

The dense kernel K6 pays cap slots per cell whatever the occupancy.
Here every (z, y) row of cells is COMPACTED: its valid molecules are
packed contiguously in cell order, with the cell index riding along as
an extra plane (`cell_plane`).  The j side is the same packed row plus
packed periodic-wrap halos in a fixed head region (the JAX layout,
kept exactly so that tables and rows compare bit for bit):

  r_j row = [right wrap halo (cell 0, +Lx) at [0, occ_first)
             | left wrap halo (cell nx-1, -Lx) right-aligned at 2*cap
             | the packed row verbatim at [2*cap, 2*cap + cnt)]

and the cell-start table tbl [nz(+2), ny, nx+3] int32 holds, per row,
tbl[c+1] = start(c) in j space for cells -1..nx-1, then end(nx-1) and
end(nx) (the right halo).  A molecule of cell c meets the j slots of
cells c-1..c+1 of the 9 neighbour rows: [tbl[c], tbl[c+3]), or for
c = nx-1 [tbl[nx-1], tbl[nx+1]) plus the head [0, tbl[nx+2]).  The
self pair is j == i + 2*cap on the centre row.  Physics and outputs are
K6's (ops/cuda_ms.py); the output is [nz, ny, 10, Wp].

Without explicit z halo rows (ms_half_shell) K5 evaluates each molecule
pair inside the cutoff once (Newton's third law): a molecule meets the
four forward rows (dz, dy) = (0, +1), (+1, -1), (+1, 0), (+1, +1) and,
in its own row, the molecules after it in packed order and the right
wrap halo (never the left one); j receives -F, the same virial share
and its torque from the pair's angular momentum balance,
M_j = -(M_i + drm x F) (every body is a rotation-invariant pair
energy).  With z halo rows the reactions would land on rows the caller
does not own, so that layout keeps the double-sided walk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from ls1_mardyn_tpu_torch.ops.cuda_ms import (
    NOUT,
    OFFS,
    _row_shift,
    check_planes,
    com_pairs,
    launch,
    pair_block,
    ref_lanes,
)
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from ls1_mardyn_tpu_torch.state import Macroscopic, MoleculeState

TI = 128  # i-tile width of the packed rows (Wp is a multiple)
# (dz, dy) of the rows the half shell walks: the centre row (j after i)
# and the four forward rows
HALF_ROWS = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
JW = 128  # j-row width quantum (the JAX layout's: rows compare bit for bit)


def pick_ms_grid_packed(r, box, cutoff, cap_min: int = 16,
                        headroom: float = 1.3):
    """Grid/cap choice for the packed kernel: the finest admissible grid
    (cell edge >= cutoff), which gives the narrowest j windows, and a cap
    that follows the measured max occupancy (8-quantized) -- it only
    sizes the binning slot table.

    Returns (dims, cap), or None below 3 cells on an axis (the wrap
    halos need 3)."""
    r = np.asarray(r, np.float64)
    box = np.asarray(box, np.float64)
    dims = tuple(int(np.floor(b / cutoff)) for b in box)
    if min(dims) < 3:
        return None
    idx = tuple(
        np.minimum((r[:, a] * (dims[a] / box[a])).astype(np.int64),
                   dims[a] - 1)
        for a in range(3)
    )
    lin = (idx[2] * dims[1] + idx[1]) * dims[0] + idx[0]
    occ = np.bincount(lin, minlength=int(np.prod(dims)))
    cap = max(cap_min,
              int(-(-np.ceil(headroom * occ.max()) // 8) * 8))
    return dims, cap


def live_plane_count(meta) -> int:
    """Number of leading planes the site-pair program can read given the
    coupling masks: trailing dipole/quadrupole plane blocks are dead
    when every coupling touching them is zero."""
    L = meta.layout
    m = meta.masks
    need_quad = any(np.any(m[k]) for k in ("cq", "qc", "qq", "qd", "dq"))
    need_dip = any(np.any(m[k]) for k in ("cd", "dc", "dd", "qd", "dq"))
    if need_quad:
        return 5 + 3 * (meta.NL + meta.NC) + 6 * (meta.ND + meta.NQ)
    if need_dip:
        return L["quad"]  # everything through dip_e
    return L["dip"]  # x y z w cid + lj + charge planes only


def site_planes_packed(meta, cell_plane: int, g9: torch.Tensor):
    """Site-offset plane columns rotated in PACKED slot order from the
    thin primary planes g9 [9, R, W] (x y z w cid q0..q3): the live
    category blocks in plane_layout order, each [R, W] column (dead
    trailing dip/quad blocks are never computed).  The rotation is the
    per-molecule one (ms_path.site_offsets_pp) op for op, so the planes
    equal a dense pack + gather bit for bit."""
    dtype, dev = g9.dtype, g9.device
    qv = g9[5:9].permute(1, 2, 0)[..., None, :]  # [R, W, 1, 4]
    okv = g9[3] > 0.5
    cid = torch.round(g9[4]).long().clamp(0, meta.K - 1)
    cols = []
    p = 5
    for key, ns in (("lj_pos", meta.NL), ("charge_pos", meta.NC),
                    ("dip_pos", meta.ND), ("dip_e", meta.ND),
                    ("quad_pos", meta.NQ), ("quad_e", meta.NQ)):
        if ns == 0:
            continue
        if p >= cell_plane:
            break  # dead trailing block (live_plane_count)
        tblv = torch.as_tensor(np.asarray(meta._geom[key]), dtype=dtype,
                               device=dev)  # [K, ns, 3]
        # the JAX version picks a component's geometry with a one-hot
        # einsum; a gather gives the same values exactly
        pos = tblv[0] if meta.K == 1 else tblv[cid]
        rot = qrotate(qv, pos)  # [R, W, ns, 3]
        rot = torch.where(okv[..., None, None], rot, 0.0)
        cols.extend(rot.reshape(*g9.shape[1:], 3 * ns).unbind(-1))
        p += 3 * ns
    return cols


def _head_table(occ, prefix, row_cnt, cap):
    """tbl [R, nx+3]: start(-1), starts of cells 0..nx-1, end(nx-1),
    end(nx) in the head-halo j space."""
    return torch.cat([(2 * cap - occ[:, -1])[:, None], 2 * cap + prefix,
                      (2 * cap + row_cnt)[:, None], occ[:, :1]],
                     dim=1).to(torch.int32)


def _j_rows(gi, occ, row_cnt, cap, Lx, Wjp):
    """The head-halo j rows [R, P, Wjp] of the packed rows gi [R, P, Wp]:
    the right wrap halo (the first occ_first slots, +Lx where valid),
    the left wrap halo (the last occ_last molecules, -Lx, right-aligned
    at 2*cap), then gi verbatim."""
    R, P, Wp = gi.shape
    dev = gi.device
    hpos = torch.arange(cap, device=dev)[None, :]
    occ_first, occ_last = occ[:, :1], occ[:, -1:]
    rvalid = hpos < occ_first
    right = torch.where(rvalid[:, None, :], gi[:, :, :cap], 0.0)
    lx, zero = gi.new_tensor(Lx), gi.new_tensor(0.0)
    right[:, 0] += torch.where(rvalid, lx, zero)
    lsrc = hpos - cap + row_cnt[:, None]
    lvalid = (hpos >= cap - occ_last) & (lsrc >= 0)
    lsafe = torch.clamp(lsrc, 0, Wp - 1)
    left = torch.where(lvalid[:, None, :],
                       torch.gather(gi, 2, lsafe[:, None, :].expand(R, P, cap)),
                       0.0)
    left[:, 0] += torch.where(lvalid, -lx, zero)
    gj = torch.zeros((R, P, Wjp), dtype=gi.dtype, device=dev)
    gj[:, :, :cap] = right
    gj[:, :, cap:2 * cap] = left
    gj[:, :, 2 * cap:2 * cap + Wp] = gi
    return gj


def _compact(filled, nx: int, cap: int):
    """The compaction of dense slot rows whose occupied slots are filled
    [R, W=nx*cap]: per-cell occupancy occ [R, nx] int32, its exclusive
    prefix, the row counts, and per packed position the dense slot it
    takes (src, clamped into the row) and whether it holds a molecule
    (ok).  The sort pushes empty slots to the tail and keeps cell order
    (slot order within a cell)."""
    R, W = filled.shape
    occ = filled.reshape(R, nx, cap).sum(-1).to(torch.int32)
    cs = torch.cumsum(occ, dim=1).to(torch.int32)
    row_pos = torch.arange(W, device=filled.device)
    src = torch.sort(torch.where(filled, row_pos, W), dim=-1).values
    return occ, cs - occ, cs[:, -1], torch.clamp(src, max=W - 1), src < W


def _finish_rows(gi, src, ok, occ, prefix, row_cnt, cap, Lx, cell_plane, Wjp):
    """Write the cell-index plane into the packed rows gi [R, P, Wp] and
    build the cell-start table and the head-halo j rows from them."""
    W = src.shape[1]
    gi[:, cell_plane, :W] = torch.where(ok, src // cap, 0).to(gi.dtype)
    return _head_table(occ, prefix, row_cnt, cap), \
        _j_rows(gi, occ, row_cnt, cap, Lx, Wjp)


def pack_dense_rows(g, nx: int, cap: int, Lx: float, cell_plane: int,
                    Wp: int, Wjp: int):
    """Compact dense slot-layout rows into the packed kernel's layout.

    g: [R, P, W=nx*cap] dense rows, plane-major (validity plane 3, slot
    order cell-major; the JAX version takes [R, W, P]).  Everything is
    derived from the validity plane, so rows received from a halo
    exchange pack exactly like local rows.  Returns (gi [R, P, Wp],
    gj [R, P, Wjp], tbl [R, nx+3] int32, prefix [R, nx] int32)."""
    R, P, W = g.shape
    occ, prefix, row_cnt, src, ok = _compact(g[:, 3] > 0.5, nx, cap)
    gi = torch.zeros((R, P, Wp), dtype=g.dtype, device=g.device)
    gi[:, :, :W] = torch.where(ok[:, None, :],
                               torch.gather(g, 2, src[:, None, :].expand(R, P, W)),
                               0.0)
    tbl, gj = _finish_rows(gi, src, ok, occ, prefix, row_cnt, cap, Lx,
                           cell_plane, Wjp)
    return gi, gj, tbl, prefix


# -- K5 -------------------------------------------------------------------------

def ms_half_shell(z_halo) -> bool:
    """Whether K5 walks the half shell (each in-cutoff pair once, the
    reaction added to j): wherever the j rows carry no explicit z halo
    rows.  The wrapper already requires >= 3 cells or rows an axis, so
    no two offsets reach one row.  With z halo rows the reactions would
    land on another device's rows: the double-sided walk."""
    return not z_halo


def _packed_slot(jj, row_end, cap):
    """The packed slot of j-space index jj of a head-halo row whose
    j-space row end is row_end (tbl[nx+1]): the row part, the right wrap
    halo (cell 0, the row's first slots) or the left wrap halo (cell
    nx-1, its last slots)."""
    return torch.where(jj >= 2 * cap, jj - 2 * cap,
                       torch.where(jj >= cap, jj - 4 * cap + row_end, jj))


def multisite_cell_forces_packed_reference(
    tbl, r_i, r_j, *, nx, ny, nz, cap, Wp, Wjp, cell_plane, box, rc2, rc2_lj,
    screen_alpha, meta, z_halo=False,
):
    """Plain PyTorch version of K5 (see multisite_cell_forces_packed):
    each packed i molecule of cell c against the j slots of cells
    c-1..c+1 of the neighbour rows, read from the cell-start table; the
    COM cutoff test first, then the pair function on the pairs inside a
    cutoff.  Where K5 takes the half shell (ms_half_shell) this walks the
    same pair set from the same side (the cutoff decided on i's
    separation, as the kernel decides it): the centre row's j after i and
    its right wrap halo, and the four forward rows; j gets -F, the same
    virial share, and its torque from the pair function evaluated from
    j's side."""
    P = r_i.shape[2]
    dtype, dev = r_i.dtype, r_i.device
    _bx, by, bz = (float(b) for b in box)
    half = ms_half_shell(z_halo)
    nzj = nz + 2 if z_halo else nz
    R = nz * ny
    acc = torch.zeros((R * Wp, 9), dtype=dtype, device=dev)
    sums = torch.zeros(3, dtype=dtype, device=dev)
    ri_flat = r_i.reshape(R, P, Wp)
    rj_flat = r_j.reshape(nzj * ny, P, Wjp)
    tb_flat = tbl.reshape(nzj * ny, nx + 3).long()
    kA = torch.arange(3 * cap, device=dev)
    kB = torch.arange(cap, device=dev)
    slot = torch.arange(Wp, device=dev)
    rc = max(1, ref_lanes(dev) // (Wp * 4 * cap))
    pair_kw = dict(rc2=rc2, rc2_lj=rc2_lj, screen_alpha=screen_alpha,
                   meta=meta)
    for r0 in range(0, R, rc):
        rows = torch.arange(r0, min(R, r0 + rc), device=dev)
        zs, ys = rows // ny, rows % ny
        Rc = rows.numel()
        pi4 = ri_flat[rows, :4].permute(0, 2, 1)  # [Rc, Wp, 4]
        wi = pi4[..., 3] > 0.5
        c = torch.round(ri_flat[rows, cell_plane]).long().clamp(0, nx - 1)
        wrap_hi = c >= nx - 1
        for dz, dy in (HALF_ROWS if half else OFFS):
            zk, sz = _row_shift(zs, dz, nz, z_halo, bz, dtype, dev)
            yk, sy = _row_shift(ys, dy, ny, False, by, dtype, dev)
            jrow = zk * ny + yk
            t = tb_flat[jrow]  # [Rc, nx+3]
            a0 = torch.gather(t, 1, c)
            a1 = torch.where(wrap_hi, t[:, nx + 1:nx + 2],
                             torch.gather(t, 1, c + 3))
            b1 = torch.where(wrap_hi, t[:, nx + 2:nx + 3], 0)
            j = torch.cat([a0[..., None] + kA, kB.expand(Rc, Wp, cap)], dim=-1)
            okA = kA < (a1 - a0)[..., None]
            if half and (dz, dy) == (0, 0):
                okA = okA & (j[..., :3 * cap] > (slot + 2 * cap)[None, :, None])
            okj = torch.cat([okA, kB < b1[..., None]], dim=-1)
            jsafe = torch.clamp(j, 0, Wjp - 1)
            src = rj_flat[jrow, :4]  # [Rc, 4, Wjp]
            g = torch.gather(src, 2, jsafe.reshape(Rc, 1, -1).expand(Rc, 4, -1))
            g = g.reshape(Rc, 4, Wp, 4 * cap)
            xj = torch.stack([g[:, 0], g[:, 1] + sy[:, None, None],
                              g[:, 2] + sz[:, None, None]], dim=-1)
            wj = okj & (g[:, 3] > 0.5)
            self_mask = None
            if (dz, dy) == (0, 0) and not half:
                self_mask = j == (slot + 2 * cap)[None, :, None]
            idx, drm, com2 = com_pairs(pi4[..., :3], wi, xj, wj, rc2, rc2_lj,
                                       self_mask)
            rr, ii, kk = idx
            jj = j[rr, ii, kk]
            pi = ri_flat[rows[rr], :, ii]
            pj = rj_flat[jrow[rr], :, jj]
            fmv, u6, ux, rf = pair_block(pi, pj, drm, com2, **pair_kw)
            acc.index_add_(0, rows[rr] * Wp + ii, fmv)
            sums += torch.stack([u6, ux, rf])
            if half:
                torque_j = pair_block(pj, pi, -drm, com2, **pair_kw)[0][:, 3:6]
                jslot = _packed_slot(jj, t[rr, nx + 1], cap)
                acc.index_add_(0, jrow[rr] * Wp + jslot,
                               torch.cat([-fmv[:, :3], torque_j, fmv[:, 6:]], 1))
    out = torch.zeros((nz, ny, NOUT, Wp), dtype=dtype, device=dev)
    out[:, :, :9] = acc.reshape(nz, ny, Wp, 9).permute(0, 1, 3, 2)
    u6, ux, rf = (sums if half else 0.5 * sums).unbind()
    return out, u6, ux, rf


def multisite_cell_forces_packed(
    tbl, r_i, r_j, *, nx, ny, nz, cap, Wp, Wjp, cell_plane, box, rc2, rc2_lj,
    screen_alpha, meta, z_halo=False,
):
    """K5 wrapper: rigid multi-site forces of the packed rows r_i [nz,
    ny, P, Wp] against the head-halo j rows r_j [nzj, ny, P, Wjp] with
    the cell-start table tbl [nzj, ny, nx+3] int32 (nzj = nz + 2 with
    z_halo: explicit halo rows, global-z shifts pre-applied; otherwise
    nz, wrapped in z with -+bz).  y wraps with -+by.  The grid needs >= 3
    cells per axis (in z, counting explicit halo rows) and a cell edge >=
    the cutoff.  Cutoffs, bodies and outputs as K6 (ops/cuda_ms.py:
    multisite_cell_forces).  Where ms_half_shell holds (no z halo rows)
    each pair inside the cutoff is evaluated once and its reaction added
    to j by atomics: the output agrees with the plain version to rounding
    and its last bits vary from run to run; the call counts on
    `half_launches` too.  With z halo rows each pair is evaluated from
    both sides, deterministically.  Returns (out [nz, ny, 10, Wp], u6,
    uX, myRF)."""
    what = "multisite_cell_forces_packed"
    nzj = nz + 2 if z_halo else nz
    P = r_i.shape[2]
    check_planes(what, r_i, (nz, ny, P, Wp), meta)
    check_planes(what, r_j, (nzj, ny, P, Wjp), meta)
    if tuple(tbl.shape) != (nzj, ny, nx + 3) or tbl.dtype != torch.int32:
        raise ValueError(f"{what}: tbl {tuple(tbl.shape)} {tbl.dtype}, want "
                         f"{(nzj, ny, nx + 3)} int32")
    if Wp % TI or Wp < nx * cap or Wjp < 2 * cap + Wp:
        raise ValueError(f"{what}: widths Wp={Wp}, Wjp={Wjp} at nx={nx}, "
                         f"cap={cap}")
    if not 0 <= cell_plane < P or min(nx, ny, nzj) < 3:
        raise ValueError(f"{what}: cell_plane {cell_plane} of {P} planes, "
                         f"dims {(nx, ny, nz)} (>= 3 cells or rows each)")
    if r_j.dtype != r_i.dtype or r_j.device != r_i.device or \
            tbl.device != r_i.device:
        raise ValueError(f"{what}: inputs differ in dtype or device")
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, Wp=Wp, Wjp=Wjp,
              cell_plane=cell_plane, box=box, rc2=rc2, rc2_lj=rc2_lj,
              screen_alpha=screen_alpha, meta=meta, z_halo=z_halo)
    if r_i.device.type == "cpu":
        return multisite_cell_forces_packed_reference(tbl, r_i, r_j, **kw)
    if r_i.device.type != "cuda":
        raise ValueError(f"{what}: device {r_i.device}")
    if not (r_i.is_contiguous() and r_j.is_contiguous() and tbl.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    res = launch_packed(tbl, r_i, r_j, **kw)
    multisite_cell_forces_packed.launches += 1
    multisite_cell_forces_packed.half_launches += ms_half_shell(z_halo)
    return res


multisite_cell_forces_packed.launches = 0
multisite_cell_forces_packed.half_launches = 0


def launch_packed(tbl, r_i, r_j, *, nx, ny, nz, cap, Wp, Wjp, cell_plane, box,
                  rc2, rc2_lj, screen_alpha, meta, z_halo=False):
    """The launch of csrc/ms_packed.cu behind
    multisite_cell_forces_packed, on checked inputs."""
    zh = int(bool(z_halo))
    return launch(
        "ms_packed", r_i, (nz, ny, NOUT, Wp), (Wp, ny, nz, zh),
        lambda out, part, tab, terms: (
            tbl.data_ptr(), r_i.data_ptr(), r_j.data_ptr(), out.data_ptr(),
            part.data_ptr(), tab, terms, nx, ny, nz, cap, r_i.shape[2], Wp,
            Wjp, cell_plane, zh),
        meta=meta, box=box, rc2=rc2, rc2_lj=rc2_lj, screen_alpha=screen_alpha,
        zero=ms_half_shell(z_halo))


class CudaMultiSitePackedPath(CudaMultiSitePath):
    """force_fn: the occupancy-packed variant of CudaMultiSitePath (the
    JAX package's PallasMultiSitePackedPath), kernel K5.  cap only
    sizes the binning slot table."""

    packed = True

    def __init__(self, table, spec: CellGridSpec, screen_alpha: float = 0.0):
        super().__init__(table, spec, screen_alpha=screen_alpha)
        if min(spec.dims) < 3:
            raise ValueError(
                f"CudaMultiSitePackedPath: dims {spec.dims} (the wrap halos "
                "need >= 3 cells per axis)")
        # the cell-index plane rides after the last LIVE plane; dead
        # trailing dipole/quadrupole blocks are not carried
        p_used = live_plane_count(self.meta)
        self.cell_plane = p_used
        self.Pb = -(-(p_used + 1) // 8) * 8
        nx = spec.dims[0]
        self.Wp = -(-(nx * spec.cap) // TI) * TI
        self.Wjp = -(-(2 * spec.cap + self.Wp) // JW) * JW

    def _build_views(self, mol: MoleculeState):
        """Packed kernel inputs from the molecule state: returns (tbl,
        r_i [nz, ny, Pb, Wp], r_j [nz, ny, Pb, Wjp], bins, prefix).
        The compaction gathers the 9 primary planes (r, valid, cid, q),
        one plane at a time, and rotates the site offsets in packed
        order (site_planes_packed)."""
        spec = self.spec
        nx, ny, nz = spec.dims
        cap = spec.cap
        n = mol.capacity
        dtype, dev = mol.r.dtype, mol.r.device
        Pb, Wp, Wjp = self.Pb, self.Wp, self.Wjp
        W = nx * cap
        R = nz * ny

        bins = bin_particles(mol.r, mol.valid, spec)
        slots_row = bins.slots.reshape(R, W).long()
        occ, prefix, row_cnt, src, ok = _compact(slots_row >= 0, nx, cap)
        msafe = torch.clamp(torch.gather(slots_row, 1, src), 0, n - 1)
        zero = torch.zeros((), dtype=dtype, device=dev)
        # one gather per primary plane (x y z valid cid q0..q3), written
        # straight into place
        g9 = torch.empty((9, R, W), dtype=dtype, device=dev)
        thin = (mol.r[:, 0], mol.r[:, 1], mol.r[:, 2], mol.valid.to(dtype),
                mol.cid.to(dtype), *mol.q.unbind(1))
        for p, col in enumerate(thin):
            g9[p] = torch.where(ok, col[msafe], zero)
        gi = torch.zeros((R, Pb, Wp), dtype=dtype, device=dev)
        gi[:, :5, :W] = g9[:5].permute(1, 0, 2)
        for p, col in enumerate(site_planes_packed(self.meta, self.cell_plane,
                                                   g9), start=5):
            gi[:, p, :W] = col
        tbl, gj = _finish_rows(gi, src, ok, occ, prefix, row_cnt, cap,
                               spec.box[0], self.cell_plane, Wjp)
        return (tbl.reshape(nz, ny, nx + 3), gi.reshape(nz, ny, Pb, Wp),
                gj.reshape(nz, ny, Pb, Wjp), bins, prefix)

    def kernel_packed(self, tbl, r_i, r_j):
        nx, ny, nz = self.spec.dims
        return multisite_cell_forces_packed(
            tbl, r_i, r_j, nx=nx, ny=ny, nz=nz, cap=self.spec.cap, Wp=self.Wp,
            Wjp=self.Wjp, cell_plane=self.cell_plane, box=self.spec.box,
            rc2=self.rc2, rc2_lj=self.rc2_lj, screen_alpha=self.screen_alpha,
            meta=self.meta)

    def __call__(self, mol: MoleculeState) -> Tuple:
        tbl, r_i, r_j, bins, prefix = self._build_views(mol)
        res = self.kernel_packed(tbl, r_i, r_j)
        return (*self.unpack(res, mol, bins, prefix), bins.overflow)

    def unpack(self, res, mol, bins, prefix):
        """(Forces, Macroscopic) of K5's result: a molecule's packed
        position is prefix[row, x] + its rank in the cell."""
        out, u6, ux, rf = res
        spec = self.spec
        nx, ny, nz = spec.dims
        cap = spec.cap
        slot_of = bins.slot_of.long()
        cell = torch.clamp(slot_of // cap, max=nz * ny * nx - 1)
        rank = slot_of % cap
        row = cell // nx
        ppos = prefix[torch.clamp(row, 0, nz * ny - 1),
                      torch.clamp(cell % nx, 0, nx - 1)].long() + rank
        ppos = torch.clamp(ppos, 0, self.Wp - 1)
        forces = self.gather_back(out, mol, row, ppos)
        macro = Macroscopic(upot6lj=u6, upot_xpoles=ux,
                            virial=out[:, :, 6:9].sum(), my_rf=rf)
        return forces, macro
