"""Force-path adapter for the 1CLJ cell kernels K3/K4 (the counterpart
of ls1_mardyn_tpu/ops/pallas_path.py: PallasLJPath).

Replaces the reference's reduced-memory-mode pipeline (VCP1CLJRMM +
ParticleCellRMM, src/particleContainer/adapter/VCP1CLJRMM.cpp): flat
molecule arrays are gathered into the kernel's row-major cell layout
each step (the rebinning the reference does in LinkedCells::update +
updateMoleculeCaches), the kernel runs, and forces come back through
the inverse slot map.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw, lj_cell_forces_row
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState


class CudaLJPath:
    """force_fn for SingleChipSimulation; single-component single-LJ-site
    molecules only (the reference's RMM restriction, MoleculeRMM.h:13).

    Kernel choice: the cell-window kernel K3 where nx >= 3 and the least
    cell edge is >= rc (`cw`), else the row kernel K4 on a j view with a
    one-cell x halo.  (The JAX class picks by the TPU's lane alignment,
    (4*cap) % 128 and tx*cap == 128; that is not the contract.)"""

    def __init__(self, table, spec: CellGridSpec):
        if not (table.K == 1 and len(table.components[0].ljcenters) == 1):
            raise ValueError("CudaLJPath requires a single 1CLJ component")
        if table.has_electrostatics():
            raise ValueError("CudaLJPath: scene has electrostatics")
        # cell-local coordinates require a uniform grid (origins are
        # exact integer cell arithmetic)
        if spec.z_edges is not None:
            raise ValueError("CudaLJPath needs a uniform grid")
        self.spec = spec
        self.eps24 = float(table.eps24[0, 0, 0, 0])
        self.sig2 = float(table.sig2[0, 0, 0, 0])
        self.shift6 = float(table.shift6[0, 0, 0, 0])
        self.rc2 = float(table.lj_cutoff ** 2)
        if float(min(spec.cell_len)) ** 2 < self.rc2:
            raise ValueError(
                f"CudaLJPath: cell edge {min(spec.cell_len)} below the cutoff"
            )
        self.hx = 1
        self.cw = spec.dims[0] >= 3

    def layout(self, mol: MoleculeState):
        """Bin the molecules and gather them into the kernels' layout:
        returns (r_i [nz, ny, 4, nx*cap] in cell-local coordinates,
        bins).  Cell-local coordinates keep full f32 precision at any
        box size, and periodicity becomes exact cell arithmetic in the
        kernel.  Empty slots are zeros with valid = 0: the kernels mask
        on validity, so the JAX layout's far-away y fill is not written.
        Each plane is gathered on its own (one 4-byte gather
        per slot; a gather of packed 16-byte rows ran 6 ms at 6.4M
        slots on an H100) and written straight into its place."""
        spec = self.spec
        nx, ny, nz = spec.dims
        cap = spec.cap
        n = mol.capacity
        dtype, dev = mol.r.dtype, mol.r.device
        bins = bin_particles(mol.r, mol.valid, spec)
        idx = bins.slots.reshape(nz, ny, nx * cap).long()
        safe = torch.clamp(idx, 0, n - 1)
        ok = (idx >= 0) & mol.valid[safe]
        lane = torch.arange(nx * cap, device=dev)
        cl = spec.cell_len
        origin = (
            (lane // cap).to(dtype) * cl[0],
            (torch.arange(ny, device=dev).to(dtype) * cl[1])[:, None],
            (torch.arange(nz, device=dev).to(dtype) * cl[2])[:, None, None],
        )
        zero = torch.zeros((), dtype=dtype, device=dev)
        r_i = torch.empty((nz, ny, 4, nx * cap), dtype=dtype, device=dev)
        for c in range(3):
            r_i[:, :, c] = torch.where(ok, mol.r[:, c][safe] - origin[c], zero)
        r_i[:, :, 3] = ok.to(dtype)
        return r_i, bins

    def x_halo(self, r_i):
        """K4's j view: r_i with hx periodic halo cells per side in x
        (plain copies: cell-local coordinates need no +-Lx shift)."""
        nx, cap, hx = self.spec.dims[0], self.spec.cap, self.hx
        return torch.cat(
            [r_i[..., (nx - hx) * cap:], r_i, r_i[..., : hx * cap]], dim=-1
        )

    def __call__(self, mol: MoleculeState) -> Tuple[Forces, Macroscopic, torch.Tensor]:
        spec = self.spec
        nx, cap = spec.dims[0], spec.cap
        n = mol.capacity
        dtype, dev = mol.r.dtype, mol.r.device
        r_i, bins = self.layout(mol)
        kw = dict(dims=spec.dims, cap=cap, eps24=self.eps24, sig2=self.sig2,
                  shift6=self.shift6, rc2=self.rc2)
        if self.cw:
            f, u6, vir = lj_cell_forces_cw(r_i, cell_len=spec.cell_len, **kw)
        else:
            f, u6, vir = lj_cell_forces_row(
                r_i, self.x_halo(r_i), box=spec.box, hx=self.hx,
                local_coords=True, **kw
            )
        # back to flat arrays via the inverse slot map (each valid
        # molecule occupies exactly one slot)
        fxyz = f[:, :, :3, :].permute(0, 1, 3, 2).reshape(-1, 3)
        src = torch.clamp(bins.slot_of.long(), 0, fxyz.shape[0] - 1)
        F = torch.where(mol.valid[:, None], fxyz[src], 0.0)
        zeros = torch.zeros((n, 3), dtype=dtype, device=dev)
        forces = Forces(F=F, M=zeros, Vi=zeros)
        zero = torch.zeros((), dtype=dtype, device=dev)
        macro = Macroscopic(upot6lj=u6, upot_xpoles=zero, virial=vir, my_rf=zero)
        return forces, macro, bins.overflow
