"""Planar (slab-based) long-range correction for interfacial systems
(the counterpart of ls1_mardyn_tpu/ops/lrc_planar.py; the reference's
Planar LRC, ls1-MarDyn src/longRange/Planar.{h,cpp}).

Method (Janecek, J. Phys. Chem. B 110, 6264 (2006)), LJ centers: the
tail interaction of a particle at height y with an infinite slab of
volume density rho at height y' (thickness dz) outside the cutoff is
    u(D) = rho*dz * [ (4 pi eps/5) sig^12 xi^-10 - 2 pi eps sig^6 xi^-4 ]
    xi = max(|y-y'|, rc)
The density profile is a histogram (a scatter-add), the correction
energy a [S,S] kernel matvec and the per-particle forces a slab-table
lookup.

Multi-site molecules: forces_torques resolves each LJ site at its world
position (COM + rotated offset) like the reference's site loops,
including the torque about the COM; _call_com bins the COM only
(identical for single-site components).
"""

from __future__ import annotations

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.state import MoleculeState, canonical_device, on_device


class PlanarLRC:
    """Slab LRC along one axis (default y, like the reference), on the
    card unless the caller asks for the CPU."""

    def __init__(self, table, box, nslabs: int = 100, axis: int = 1,
                 per_site: bool = True, dtype=torch.float64, device="cuda"):
        device = self.device = canonical_device(device)
        self.axis = axis
        self.per_site = per_site
        self.nslabs = nslabs
        self.box = np.asarray(box, float)
        self.L = float(self.box[axis])
        self.dz = self.L / nslabs
        self.area = float(np.prod(np.delete(self.box, axis)))
        rc = table.lj_cutoff
        K, NL = table.K, table.NL
        self.NL = NL
        y = (np.arange(nslabs) + 0.5) * self.dz
        # slab distance with periodic wrap
        D = np.abs(y[:, None] - y[None, :])
        D = np.minimum(D, self.L - D)
        xi = np.maximum(D, rc)
        self.W = np.zeros((K, K, nslabs, nslabs))
        self.dW = np.zeros((K, K, nslabs, nslabs))  # dU/dD (0 inside rc)
        self.Ws = np.zeros((K, NL, K, NL, nslabs, nslabs))
        self.dWs = np.zeros((K, NL, K, NL, nslabs, nslabs))
        sgn = np.sign(((y[:, None] - y[None, :]) + self.L / 2) % self.L - self.L / 2)
        for a in range(K):
            for b in range(K):
                for sa in range(NL):
                    for sb in range(NL):
                        if not (table.lj_mask[a, sa] and table.lj_mask[b, sb]):
                            continue
                        eps = table.eps24[a, b, sa, sb] / 24.0
                        s6 = table.sig2[a, b, sa, sb] ** 3
                        s12 = s6 * s6
                        u = (
                            4.0 * np.pi * eps / 5.0 * s12 / xi ** 10
                            - 2.0 * np.pi * eps * s6 / xi ** 4
                        )
                        du = np.where(
                            D > rc,
                            -8.0 * np.pi * eps * s12 / xi ** 11
                            + 8.0 * np.pi * eps * s6 / xi ** 5,
                            0.0,
                        )
                        self.W[a, b] += u * self.dz
                        self.dW[a, b] += du * self.dz
                        self.Ws[a, sa, b, sb] = u * self.dz
                        self.dWs[a, sa, b, sb] = du * self.dz

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self._W, self._dW = t(self.W), t(self.dW)
        self._Ws, self._dWs = t(self.Ws), t(self.dWs)
        # force direction: toward slab j relative to i
        self._sgn = t(sgn)
        self._lj_pos = t(table.lj_pos)
        self._lj_mask = torch.as_tensor(np.asarray(table.lj_mask, bool),
                                        device=device)

    def __call__(self, mol: MoleculeState):
        """(F [N,3], u_corr, virial_corr); forces_torques() also gives
        the per-site torques."""
        on_device(mol.r, self.device, "mol")
        if self.per_site and int(self.NL) > 0:
            F, _M, u, vir = self.forces_torques(mol)
            return F, u, vir
        return self._call_com(mol)

    def _density(self, cid, slab, mask, dtype):
        """Per-(component, site, slab) number densities [K, NL', S] of
        the binned entries (slab [N, NL'] or [N, 1])."""
        K, S = self._W.shape[0], self.nslabs
        nl = slab.shape[1]
        key = ((cid.long()[:, None] * nl
                + torch.arange(nl, device=slab.device)) * S + slab.long())
        counts = torch.zeros((K * nl * S,), dtype=dtype, device=slab.device)
        counts.index_add_(0, key.reshape(-1), mask.reshape(-1).to(dtype))
        return counts.reshape(K, nl, S) / (self.area * self.dz)

    def forces_torques(self, mol: MoleculeState):
        """Exact per-site slab correction: each LJ site binned at its
        world height, its force acting at the site (a torque about the
        COM).  Returns (F [N,3], M [N,3], u_corr, virial)."""
        dtype = mol.r.dtype
        S = self.nslabs
        cid = mol.cid.long()
        offs = qrotate(mol.q[:, None, :], self._lj_pos.to(dtype)[cid])  # [N, NL, 3]
        smask = self._lj_mask[cid] & mol.valid[:, None]
        ys = mol.r[:, None, self.axis] + offs[..., self.axis]
        ys = ys - torch.floor(ys / self.L) * self.L  # periodic wrap
        slab = torch.clamp((ys / self.dz).to(torch.int32), 0, S - 1).long()
        rho = self._density(cid, slab, smask, dtype)  # [K, NL, S]
        u_tab = torch.einsum("ambtij,btj->ami", self._Ws.to(dtype), rho)
        f_tab = torch.einsum("ambtij,ij,btj->ami", self._dWs.to(dtype),
                             -self._sgn.to(dtype), rho)
        site = torch.arange(self.NL, device=slab.device)
        zero = torch.zeros((), dtype=dtype, device=slab.device)
        u_per = torch.where(smask, u_tab[cid[:, None], site, slab], zero)
        f_site = torch.where(smask, f_tab[cid[:, None], site, slab], zero)
        u_corr = 0.5 * u_per.sum()
        F_site = torch.zeros(offs.shape, dtype=dtype, device=mol.r.device)
        F_site[..., self.axis] = f_site
        F = F_site.sum(1)
        M = torch.linalg.cross(offs, F_site, dim=-1).sum(1)
        return F, M, u_corr, zero

    def _call_com(self, mol: MoleculeState):
        """COM-binned correction: (F [N,3], u_corr, virial)."""
        dtype = mol.r.dtype
        S = self.nslabs
        cid = mol.cid.long()
        slab = torch.clamp((mol.r[:, self.axis] / self.dz).to(torch.int32),
                           0, S - 1).long()
        rho = self._density(cid, slab[:, None], mol.valid[:, None], dtype)[:, 0]
        u_tab = torch.einsum("abij,bj->ai", self._W.to(dtype), rho)  # [K, S]
        f_tab = torch.einsum("abij,ij,bj->ai", self._dW.to(dtype),
                             -self._sgn.to(dtype), rho)
        zero = torch.zeros((), dtype=dtype, device=slab.device)
        u_corr = 0.5 * torch.where(mol.valid, u_tab[cid, slab], zero).sum()
        F = torch.zeros((mol.capacity, 3), dtype=dtype, device=mol.r.device)
        F[:, self.axis] = torch.where(mol.valid, f_tab[cid, slab], zero)
        # the virial along the axis is not computed (as in the JAX
        # package: pressure profiles are unaffected for energy-only use)
        return F, u_corr, zero
