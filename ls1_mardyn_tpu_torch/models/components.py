"""Molecule types (components), interaction sites, and precomputed
pair-parameter tables.

Host-side equivalent of the reference's Component / Site hierarchy /
Comp2Param (src/molecules/Component.{h,cpp}, Site.h,
Comp2Param.{h,cpp}).  Unlike the reference's per-pair parameter
*streams*, this build bakes everything into dense padded numpy
arrays (`ComponentTable`) that the kernels index with (component_i,
site_i, component_j, site_j); padding slots carry zero coupling
constants so masked site pairs contribute exactly zero.

Conventions copied from the reference:
  - site coordinates are given in the principal-axes body frame with the
    origin at the center of mass (Component.cpp:140-167)
  - moments of inertia accumulate from LJ-center and charge site masses
    (Component.cpp:126-167); dipoles/quadrupoles are massless
  - rotational DOF: 3, minus one per vanishing principal moment
    (Component.cpp:159-165)
  - LJ mixing (Lorentz-Berthelot with optional xi/eta coefficients):
    eps24 = 24*xi*sqrt(eps_i*eps_j); sigma = eta*(sig_i+sig_j)/2
    (Comp2Param.cpp:19-100)
  - truncated-shifted LJ: shift6 = eps24*(s6 - s12), s2 = sig2/rc^2
    (Component.cpp:108-113 for intra-component sites with their own rc;
    Comp2Param.cpp:52-71 for cross-component pairs with the global rcLJ)
  - electrostatics coupling constants (Comp2Param.cpp:100-186):
    charge-charge q1*q2, charge-quadrupole 0.5*q*|Q|,
    charge-dipole -q*|mu|, quadrupole-quadrupole 0.75*|Qi|*|Qj|,
    dipole/quadrupole cross 1.5*|mu|*|Q|, dipole-dipole |mu_i|*|mu_j|
    with reaction-field factor rffac = my2 * 2(epsRF-1)/(rc^3(2epsRF+1))
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class LJCenter:
    r: np.ndarray  # body-frame position [3]
    m: float
    eps: float
    sigma: float
    shift6: float = 0.0  # truncated-shifted offset (0.0 for full LJ)

    @staticmethod
    def make(x, y, z, m, eps, sigma, rc=0.0, do_shift=False):
        shift6 = 0.0
        if do_shift and rc > 0:
            s2 = sigma * sigma / (rc * rc)
            s6 = s2 * s2 * s2
            # Component.cpp:108-113
            shift6 = 24.0 * eps * (s6 - s6 * s6)
        return LJCenter(np.array([x, y, z], float), m, eps, sigma, shift6)


@dataclasses.dataclass
class ChargeSite:
    r: np.ndarray
    m: float
    q: float


@dataclasses.dataclass
class DipoleSite:
    r: np.ndarray
    e: np.ndarray  # body-frame orientation unit vector [3]
    abs_my: float

    def __post_init__(self):
        n = np.linalg.norm(self.e)
        if n > 0:
            self.e = self.e / n


@dataclasses.dataclass
class QuadrupoleSite:
    r: np.ndarray
    e: np.ndarray
    abs_q: float

    def __post_init__(self):
        n = np.linalg.norm(self.e)
        if n > 0:
            self.e = self.e / n


@dataclasses.dataclass
class Component:
    """One molecule type. Mirrors src/molecules/Component.h."""

    cid: int = 0
    name: str = ""
    ljcenters: List[LJCenter] = dataclasses.field(default_factory=list)
    charges: List[ChargeSite] = dataclasses.field(default_factory=list)
    dipoles: List[DipoleSite] = dataclasses.field(default_factory=list)
    quadrupoles: List[QuadrupoleSite] = dataclasses.field(default_factory=list)
    # Principal moments of inertia; overridable from input files
    # (ASCIIReader.cpp:196-201: only positive values override).
    I_override: Optional[np.ndarray] = None
    # Stockmayer fluid (LJ center + point dipole at the same position):
    # site masses contribute no inertia, so the reference pins
    # I = [1, 1, 0] and rot_dof = 2 to make the dipole rotate
    # (Component.cpp:64-74,145).
    is_stockmayer: bool = False

    def add_ljcenter(self, x, y, z, m, eps, sigma, rc=0.0, do_shift=False):
        self.ljcenters.append(LJCenter.make(x, y, z, m, eps, sigma, rc, do_shift))

    def add_charge(self, x, y, z, m, q):
        self.charges.append(ChargeSite(np.array([x, y, z], float), m, q))

    def add_dipole(self, x, y, z, ex, ey, ez, abs_my):
        self.dipoles.append(
            DipoleSite(np.array([x, y, z], float), np.array([ex, ey, ez], float), abs_my)
        )

    def add_quadrupole(self, x, y, z, ex, ey, ez, abs_q):
        self.quadrupoles.append(
            QuadrupoleSite(np.array([x, y, z], float), np.array([ex, ey, ez], float), abs_q)
        )

    @property
    def mass(self) -> float:
        return sum(s.m for s in self.ljcenters) + sum(s.m for s in self.charges)

    def inertia(self) -> np.ndarray:
        """Principal moments (I11, I22, I33); Component.cpp:140-167."""
        if self.is_stockmayer:
            I = np.array([1.0, 1.0, 0.0])
            if self.I_override is not None:
                for d in range(3):
                    if self.I_override[d] > 0:
                        I[d] = self.I_override[d]
            return I
        I = np.zeros(3)
        for s in list(self.ljcenters) + list(self.charges):
            x, y, z = s.r
            I[0] += s.m * (y * y + z * z)
            I[1] += s.m * (x * x + z * z)
            I[2] += s.m * (x * x + y * y)
        if self.I_override is not None:
            for d in range(3):
                if self.I_override[d] > 0:
                    I[d] = self.I_override[d]
        return I

    def rot_dof(self) -> int:
        """3 minus one per vanishing principal moment (Component.cpp:159-165)."""
        I = self.inertia()
        return int(np.sum(I > 0.0))

    def num_sites(self) -> int:
        return (
            len(self.ljcenters)
            + len(self.charges)
            + len(self.dipoles)
            + len(self.quadrupoles)
        )


def _pad(arrs, shape, dtype=np.float64):
    out = np.zeros(shape, dtype=dtype)
    return out


class ComponentTable:
    """Dense padded per-component site arrays + pair coupling tables.

    The device-side replacement for Comp2Param's parameter streams
    (src/molecules/Comp2Param.cpp) and for Component's
    per-molecule lookups.  K = number of components; site counts padded
    to the per-type maxima (NL, NC, ND, NQ).  All arrays are plain
    numpy; callers move them to device / cast dtype as needed.
    """

    def __init__(
        self,
        components: Sequence[Component],
        mixing_xi: Optional[np.ndarray] = None,
        mixing_eta: Optional[np.ndarray] = None,
        eps_rf: float = 1.0,
        cutoff: float = 1.0e10,
        lj_cutoff: Optional[float] = None,
    ):
        if lj_cutoff is None:
            lj_cutoff = cutoff
        self.components = list(components)
        self.eps_rf = float(eps_rf)
        self.cutoff = float(cutoff)
        self.lj_cutoff = float(lj_cutoff)
        K = len(self.components)
        self.K = K
        NL = max([len(c.ljcenters) for c in self.components] + [1])
        NC = max([len(c.charges) for c in self.components] + [1])
        ND = max([len(c.dipoles) for c in self.components] + [1])
        NQ = max([len(c.quadrupoles) for c in self.components] + [1])
        self.NL, self.NC, self.ND, self.NQ = NL, NC, ND, NQ

        if mixing_xi is None:
            mixing_xi = np.ones((K, K))
        if mixing_eta is None:
            mixing_eta = np.ones((K, K))
        self.mixing_xi = np.asarray(mixing_xi, float)
        self.mixing_eta = np.asarray(mixing_eta, float)

        # per-component site geometry / masks
        self.lj_pos = np.zeros((K, NL, 3))
        self.lj_mask = np.zeros((K, NL), bool)
        self.lj_eps = np.zeros((K, NL))
        self.lj_sig = np.zeros((K, NL))
        self.lj_shift6 = np.zeros((K, NL))
        self.charge_pos = np.zeros((K, NC, 3))
        self.charge_mask = np.zeros((K, NC), bool)
        self.charge_q = np.zeros((K, NC))
        self.dip_pos = np.zeros((K, ND, 3))
        self.dip_mask = np.zeros((K, ND), bool)
        self.dip_e = np.zeros((K, ND, 3))
        self.dip_abs = np.zeros((K, ND))
        self.quad_pos = np.zeros((K, NQ, 3))
        self.quad_mask = np.zeros((K, NQ), bool)
        self.quad_e = np.zeros((K, NQ, 3))
        self.quad_abs = np.zeros((K, NQ))
        self.mass = np.zeros((K,))
        self.inertia = np.zeros((K, 3))
        self.inv_inertia = np.zeros((K, 3))
        self.rot_dof = np.zeros((K,), np.int32)

        for k, c in enumerate(self.components):
            for i, s in enumerate(c.ljcenters):
                self.lj_pos[k, i] = s.r
                self.lj_mask[k, i] = True
                self.lj_eps[k, i] = s.eps
                self.lj_sig[k, i] = s.sigma
                self.lj_shift6[k, i] = s.shift6
            for i, s in enumerate(c.charges):
                self.charge_pos[k, i] = s.r
                self.charge_mask[k, i] = True
                self.charge_q[k, i] = s.q
            for i, s in enumerate(c.dipoles):
                self.dip_pos[k, i] = s.r
                self.dip_mask[k, i] = True
                self.dip_e[k, i] = s.e
                self.dip_abs[k, i] = s.abs_my
            for i, s in enumerate(c.quadrupoles):
                self.quad_pos[k, i] = s.r
                self.quad_mask[k, i] = True
                self.quad_e[k, i] = s.e
                self.quad_abs[k, i] = s.abs_q
            self.mass[k] = c.mass
            I = c.inertia()
            self.inertia[k] = I
            self.inv_inertia[k] = np.where(I > 0, 1.0 / np.where(I > 0, I, 1.0), 0.0)
            self.rot_dof[k] = c.rot_dof()

        self._build_pair_tables()

    # -- pair coupling tables ------------------------------------------------
    def _build_pair_tables(self):
        K, NL, NC, ND, NQ = self.K, self.NL, self.NC, self.ND, self.NQ
        xi, eta = self.mixing_xi, self.mixing_eta

        # LJ: eps24[K,K,NL,NL], sig2, shift6 (Comp2Param.cpp:19-100)
        eps_i = self.lj_eps[:, None, :, None]  # [K,1,NL,1]
        eps_j = self.lj_eps[None, :, None, :]  # [1,K,1,NL]
        sig_i = self.lj_sig[:, None, :, None]
        sig_j = self.lj_sig[None, :, None, :]
        m_i = self.lj_mask[:, None, :, None]
        m_j = self.lj_mask[None, :, None, :]
        pm = m_i & m_j
        xi4 = xi[:, :, None, None]
        eta4 = eta[:, :, None, None]
        self.eps24 = np.where(pm, 24.0 * xi4 * np.sqrt(eps_i * eps_j), 0.0)
        sig = eta4 * 0.5 * (sig_i + sig_j)
        self.sig2 = np.where(pm, sig * sig, 1.0)  # pad with 1 to avoid 0/0
        # shift6: intra-component pairs use the i-site's own stored shift6
        # (Comp2Param.cpp:24-40 uses ljcenteri.shift6()); cross-component
        # pairs use the combined shift at the global LJ cutoff
        # (Comp2Param.cpp:52-71).
        rc2 = self.lj_cutoff * self.lj_cutoff
        s2 = self.sig2 / rc2
        s6 = s2 * s2 * s2
        shift_cross = self.eps24 * (s6 - s6 * s6)
        shift_intra = np.broadcast_to(
            self.lj_shift6[:, None, :, None], self.eps24.shape
        ).copy()
        same = np.eye(K, dtype=bool)[:, :, None, None]
        self.shift6 = np.where(pm, np.where(same, shift_intra, shift_cross), 0.0)

        # Electrostatics (Comp2Param.cpp:100-186). 4*pi*eps0 == 1 (reduced).
        q_i = self.charge_q[:, None, :, None]
        q_j = self.charge_q[None, :, None, :]
        cm_i = self.charge_mask[:, None, :, None]
        cm_j = self.charge_mask[None, :, None, :]
        self.qq = np.where(cm_i & cm_j, q_i * q_j, 0.0)  # [K,K,NC,NC]

        Q_j = self.quad_abs[None, :, None, :]
        qm_j = self.quad_mask[None, :, None, :]
        self.qQ05 = np.where(cm_i & qm_j, 0.5 * q_i * Q_j, 0.0)  # [K,K,NC,NQ]

        my_j = self.dip_abs[None, :, None, :]
        dm_j = self.dip_mask[None, :, None, :]
        self.minus_qmy = np.where(cm_i & dm_j, -q_i * my_j, 0.0)  # [K,K,NC,ND]

        Q_i = self.quad_abs[:, None, :, None]
        qm_i = self.quad_mask[:, None, :, None]
        self.QQ075 = np.where(qm_i & qm_j, 0.75 * Q_i * Q_j, 0.0)  # [K,K,NQ,NQ]
        self.Qmy15 = np.where(qm_i & dm_j, 1.5 * Q_i * my_j, 0.0)  # [K,K,NQ,ND]

        my_i = self.dip_abs[:, None, :, None]
        dm_i = self.dip_mask[:, None, :, None]
        self.myQ15 = np.where(dm_i & qm_j, 1.5 * my_i * Q_j, 0.0)  # [K,K,ND,NQ]
        self.my2 = np.where(dm_i & dm_j, my_i * my_j, 0.0)  # [K,K,ND,ND]
        # reaction field: rffac = my2 * 2(epsRF-1)/(rc^3 (2 epsRF+1))
        # (Comp2Param.cpp:160-166); rc is the electrostatics cutoff.
        rc3 = self.cutoff ** 3
        eps_rf_invrc3 = 2.0 * (self.eps_rf - 1.0) / (rc3 * (2.0 * self.eps_rf + 1.0))
        self.rffac = self.my2 * eps_rf_invrc3

    def has_electrostatics(self) -> bool:
        return bool(
            self.charge_mask.any() or self.dip_mask.any() or self.quad_mask.any()
        )

    def max_sites(self) -> int:
        return max(c.num_sites() for c in self.components)
