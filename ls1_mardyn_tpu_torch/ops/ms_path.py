"""Force-path adapter for the dense multi-site kernel K6 (the
counterpart of ls1_mardyn_tpu/ops/pallas_ms_path.py).

The general-molecule pipeline (the reference's VectorizedCellProcessor
role): flat molecule arrays -> per-molecule world site offsets
(quaternion rotation, plain PyTorch) -> plane gather into the kernel's
cell-row layout -> K6 -> gather-back of F/M/Vi.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from ls1_mardyn_tpu_torch.ops.cuda_ms import MSMeta, multisite_cell_forces
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState


def pick_ms_grid(r, box, cutoff, cap_min: int = 32, headroom: float = 1.5,
                 span: int = 4):
    """Cost-based grid/cap choice for the dense multi-site kernel (the
    TraversalTuner::findOptimalTraversal role, TraversalTuner.h:135, for
    this kernel family).  K6 meets the 27 neighbour cells of a slot, so a
    call costs n_cells * cap^2 * 27 candidate pairs.  Search the
    admissible grids near floor(box/cutoff) (cell edge >= cutoff on every
    axis), size cap from the measured max cell occupancy plus drift
    headroom (a multiple of 8), and take the cheapest.  (The TPU
    chooser's tx*cap % 128 alignment, tile width and VMEM rules are that
    kernel's tiling, not this one's.)

    Returns (dims, cap) or None when no admissible grid exists."""
    r = np.asarray(r, np.float64)
    box = np.asarray(box, np.float64)
    lo = [int(np.floor(b / cutoff)) for b in box]
    if min(lo) < 1:
        return None

    def cands(nmax):
        return list(range(nmax, max(nmax - span, 1) - 1, -1))

    def cap_of(max_occ):
        need = max(cap_min, int(np.ceil(headroom * max(max_occ, 1))))
        return -(-need // 8) * 8

    # per-axis cell index tables for each candidate count (bincount per
    # combination is the only O(N) work and span^3 stays small)
    axis_idx = []
    for a in range(3):
        tbl = {}
        for n in cands(lo[a]):
            tbl[n] = np.minimum((r[:, a] * (n / box[a])).astype(np.int64),
                                n - 1)
        axis_idx.append(tbl)

    best = None
    for nx in cands(lo[0]):
        for ny in cands(lo[1]):
            for nz in cands(lo[2]):
                cells = nx * ny * nz
                if best is not None and cells * cap_min ** 2 * 27 >= best[0]:
                    continue
                lin = (axis_idx[2][nz] * ny + axis_idx[1][ny]) * nx \
                    + axis_idx[0][nx]
                occ = int(np.bincount(lin, minlength=cells).max())
                cap = cap_of(occ)
                cost = cells * cap * cap * 27
                if best is None or cost < best[0]:
                    best = (cost, (nx, ny, nz), cap)
    return best[1], best[2]


def site_offsets_pp(meta: MSMeta, mol: MoleculeState):
    """World-frame site offsets and orientations of every molecule
    against the meta's geometry ([N, S, 3] each)."""
    dtype, dev = mol.r.dtype, mol.r.device
    qb = mol.q[..., None, :]
    cid = mol.cid.long()
    return {
        key: qrotate(qb, torch.as_tensor(np.asarray(meta._geom[g]), dtype=dtype,
                                         device=dev)[cid])
        for key, g in (("lj", "lj_pos"), ("charge", "charge_pos"),
                       ("dip", "dip_pos"), ("dip_e", "dip_e"),
                       ("quad", "quad_pos"), ("quad_e", "quad_e"))
    }


def plane_columns(meta: MSMeta, mol: MoleculeState):
    """The P plane columns of every molecule in layout order, each [N]:
    x y z valid cid, site offsets, orientations, zero padding."""
    dtype = mol.r.dtype
    sites = site_offsets_pp(meta, mol)
    n = mol.capacity
    cols = [mol.r[:, 0], mol.r[:, 1], mol.r[:, 2], mol.valid.to(dtype),
            mol.cid.to(dtype)]
    for key in ("lj", "charge", "dip", "dip_e", "quad", "quad_e"):
        cols.extend(sites[key].reshape(n, -1).unbind(1))
    zero = torch.zeros((n,), dtype=dtype, device=mol.r.device)
    cols.extend([zero] * (meta.P - len(cols)))
    return cols


class CudaMultiSitePath:
    """force_fn for SingleChipSimulation: rigid multi-site molecules of
    any component mix (LJ + charges + dipoles + quadrupoles) through the
    dense kernel K6 (the JAX package's PallasMultiSitePath).  Absolute
    coordinates: any grid whose cell edge is >= the cutoff, non-uniform
    z rows included."""

    packed = False

    def __init__(self, table, spec: CellGridSpec, screen_alpha: float = 0.0):
        self.spec = spec
        self.screen_alpha = float(screen_alpha)
        self.meta = MSMeta(table)
        self.rc2 = float(table.cutoff ** 2)
        self.rc2_lj = float(table.lj_cutoff ** 2)
        rc = max(table.cutoff, table.lj_cutoff)
        if float(min(spec.cell_len)) < rc:
            raise ValueError(
                f"CudaMultiSitePath: cell edge {min(spec.cell_len)} below the "
                f"cutoff {rc}")

    def layout(self, mol: MoleculeState):
        """Bin the molecules and gather them into K6's layout: returns
        (r_i [nz, ny, P, nx*cap], bins).  Empty slots are zeros.  Each
        plane is gathered on its own, straight into its place."""
        spec = self.spec
        nx, ny, nz = spec.dims
        cap = spec.cap
        n = mol.capacity
        dtype, dev = mol.r.dtype, mol.r.device
        bins = bin_particles(mol.r, mol.valid, spec)
        idx = bins.slots.reshape(nz, ny, nx * cap).long()
        safe = torch.clamp(idx, 0, n - 1)
        ok = (idx >= 0) & mol.valid[safe]
        zero = torch.zeros((), dtype=dtype, device=dev)
        r_i = torch.empty((nz, ny, self.meta.P, nx * cap), dtype=dtype,
                          device=dev)
        for p, col in enumerate(plane_columns(self.meta, mol)):
            r_i[:, :, p] = torch.where(ok, col[safe], zero)
        return r_i, bins

    def x_halo(self, r_i):
        """K6's j view: one periodic halo cell per side in x, shifted by
        -+Lx (every slot, as the JAX path shifts them)."""
        nx, cap = self.spec.dims[0], self.spec.cap
        Lx = self.spec.box[0]
        left = r_i[..., (nx - 1) * cap:].clone()
        right = r_i[..., :cap].clone()
        left[:, :, 0] -= Lx
        right[:, :, 0] += Lx
        return torch.cat([left, r_i, right], dim=-1)

    def kernel(self, r_i, r_j):
        nx, ny, nz = self.spec.dims
        return multisite_cell_forces(
            r_i, r_j, nx=nx, ny=ny, nz=nz, cap=self.spec.cap,
            box=self.spec.box, rc2=self.rc2, rc2_lj=self.rc2_lj,
            screen_alpha=self.screen_alpha, meta=self.meta)

    def gather_back(self, out, mol, slot_row, slot_pos):
        """Forces from the kernel's [rows..., 10, W] output and each
        molecule's row and position in it."""
        flat = out.reshape(-1, out.shape[-2], out.shape[-1])
        got = flat[slot_row, :9, slot_pos]  # [N, 9]
        got = torch.where(mol.valid[:, None], got, 0.0)
        return Forces(F=got[:, 0:3], M=got[:, 3:6], Vi=got[:, 6:9])

    def unpack(self, res, mol, bins):
        """(Forces, Macroscopic) of K6's result through the inverse slot
        map."""
        out, u6, ux, rf = res
        nx, ny, nz = self.spec.dims
        W = nx * self.spec.cap
        src = torch.clamp(bins.slot_of.long(), 0, nz * ny * W - 1)
        forces = self.gather_back(out, mol, src // W, src % W)
        macro = Macroscopic(upot6lj=u6, upot_xpoles=ux,
                            virial=out[:, :, 6:9].sum(), my_rf=rf)
        return forces, macro

    def __call__(self, mol: MoleculeState) -> Tuple[Forces, Macroscopic, torch.Tensor]:
        r_i, bins = self.layout(mol)
        res = self.kernel(r_i, self.x_halo(r_i))
        return (*self.unpack(res, mol, bins), bins.overflow)
