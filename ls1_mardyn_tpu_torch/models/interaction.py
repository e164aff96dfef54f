"""Molecule-pair interaction: all site-site contributions between two
rigid multi-site molecules, vectorized over batches of ordered pairs.

The counterpart of ls1_mardyn_tpu/models/interaction.py: PotForce
(src/molecules/potforce.h:282-503), restructured for
double-sided evaluation: for an *ordered* pair (i, j) we compute only
what lands on molecule i (force, torque, per-molecule virial) plus the
pair energies.  Evaluating both (i, j) and (j, i) reproduces the
reference's Newton-3rd-law bookkeeping exactly (the pair formulas are
antisymmetric in the force and role-symmetric in the torques); pair
energies are double-counted and must be halved by the caller.

Padded site slots carry zero coupling constants
(ComponentTable._build_pair_tables), so they contribute exactly zero —
no extra masking needed at site level.  Callers are responsible for
feeding a 'safe' drm (no zero-length vectors) and masking whole pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models import potentials as pot
from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, resolve_device


@dataclasses.dataclass
class PairParams:
    """Device-side mirror of ComponentTable (see components.py)."""

    # geometry [K, S, ...]
    lj_pos: torch.Tensor
    charge_pos: torch.Tensor
    charge_q: torch.Tensor  # [K, NC] raw site charges (Ewald k-space)
    dip_pos: torch.Tensor
    dip_e: torch.Tensor
    quad_pos: torch.Tensor
    quad_e: torch.Tensor
    # coupling tables [K, K, S_i, S_j]
    eps24: torch.Tensor
    sig2: torch.Tensor
    shift6: torch.Tensor
    qq: torch.Tensor
    qQ05: torch.Tensor
    Qq05: torch.Tensor
    minus_qmy: torch.Tensor
    minus_myq: torch.Tensor
    QQ075: torch.Tensor
    Qmy15: torch.Tensor
    myQ15: torch.Tensor
    my2: torch.Tensor
    rffac: torch.Tensor
    # per-component scalars
    mass: torch.Tensor
    inertia: torch.Tensor
    inv_inertia: torch.Tensor
    rot_dof: torch.Tensor
    # cutoffs (0-d tensors for dtype consistency)
    rc2: torch.Tensor  # electrostatics cutoff^2 (ref _cutoffRadiusSquare)
    rc2_lj: torch.Tensor  # LJ cutoff^2 (ref _LJCutoffRadiusSquare)
    # which coupling tables hold any non-zero entry (read once per
    # table; a block whose table is all zero adds exact zeros)
    _nonzero: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def has(self, name: str) -> bool:
        """True when coupling table `name` has a non-zero entry."""
        if name not in self._nonzero:
            self._nonzero[name] = bool((getattr(self, name) != 0).any())
        return self._nonzero[name]

    @staticmethod
    def from_table(table, dtype: torch.dtype = torch.float32, device="cuda") -> "PairParams":
        device = resolve_device(device)
        t = table
        minus_myq = np.transpose(t.minus_qmy, (1, 0, 3, 2)).copy()
        Qq05 = np.transpose(t.qQ05, (1, 0, 3, 2)).copy()

        def a(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        return PairParams(
            lj_pos=a(t.lj_pos),
            charge_pos=a(t.charge_pos),
            charge_q=a(t.charge_q),
            dip_pos=a(t.dip_pos),
            dip_e=a(t.dip_e),
            quad_pos=a(t.quad_pos),
            quad_e=a(t.quad_e),
            eps24=a(t.eps24),
            sig2=a(t.sig2),
            shift6=a(t.shift6),
            qq=a(t.qq),
            qQ05=a(t.qQ05),
            Qq05=a(Qq05),
            minus_qmy=a(t.minus_qmy),
            minus_myq=a(minus_myq),
            QQ075=a(t.QQ075),
            Qmy15=a(t.Qmy15),
            myQ15=a(t.myQ15),
            my2=a(t.my2),
            rffac=a(t.rffac),
            mass=a(t.mass),
            inertia=a(t.inertia),
            inv_inertia=a(t.inv_inertia),
            rot_dof=torch.as_tensor(np.asarray(t.rot_dof, np.int32), device=device),
            rc2=a(t.cutoff ** 2),
            rc2_lj=a(t.lj_cutoff ** 2),
        )


def site_offsets(pp: PairParams, q: torch.Tensor, cid: torch.Tensor):
    """World-frame site offsets (relative to COM) and multipole
    orientations for molecules with quaternion q and component cid.

    Mirrors FullMolecule::computeLJcenter_d etc.
    (FullMolecule.h:217-232: site_world = q.rotate(body_site)).
    Returns dict of [..., S, 3] arrays.
    """
    qb = q[..., None, :]
    cid = cid.long()
    return dict(
        lj=qrotate(qb, pp.lj_pos[cid]),
        charge=qrotate(qb, pp.charge_pos[cid]),
        dip=qrotate(qb, pp.dip_pos[cid]),
        dip_e=qrotate(qb, pp.dip_e[cid]),
        quad=qrotate(qb, pp.quad_pos[cid]),
        quad_e=qrotate(qb, pp.quad_e[cid]),
    )


def _pair_expand(drm, d_i, d_j):
    """drs[..., Si, Sj, 3] = drm + d_i - d_j; plus squared length."""
    drs = (
        drm[..., None, None, :]
        + d_i[..., :, None, :]
        - d_j[..., None, :, :]
    )
    dr2 = (drs * drs).sum(-1)
    return drs, dr2


def molecule_pair(
    drm: torch.Tensor,
    sites_i: dict,
    sites_j: dict,
    cid_i: torch.Tensor,
    cid_j: torch.Tensor,
    pp: PairParams,
    mask_lj: torch.Tensor,
    mask_elec: torch.Tensor,
    screen_alpha: float = 0.0,
):
    """All interactions of ordered molecule pair (i, j).

    Args:
      drm: [..., 3] COM distance r_i - r_j (minimum-image, 'safe').
      sites_i/j: outputs of :func:`site_offsets` for each side.
      mask_lj/mask_elec: [...] COM-distance cutoff masks
        (VectorizedCellProcessor.cpp:967-1024: LJ sites use the LJ
        cutoff, electrostatics the main cutoff, both COM-based).

    Returns dict with F (on i), M (torque on i), Vi (0.5*drm*F-style
    virial vector on i), u6lj, uX, my_rf (full pair energies -- halve
    when summing over ordered pairs).
    """
    dtype = drm.dtype
    batch = drm.shape[:-1]
    F = torch.zeros(batch + (3,), dtype=dtype, device=drm.device)
    M = torch.zeros_like(F)
    Vi = torch.zeros_like(F)
    u6lj = torch.zeros(batch, dtype=dtype, device=drm.device)
    uX = torch.zeros_like(u6lj)
    my_rf = torch.zeros_like(u6lj)

    mlj = mask_lj.to(dtype)
    mel = mask_elec.to(dtype)
    # component pair of every molecule pair (index tensors are int64 at
    # the use; the state keeps int32)
    ci = torch.as_tensor(cid_i, device=drm.device).long()
    cj = torch.as_tensor(cid_j, device=drm.device).long()

    def tab(t):
        return t[ci, cj]

    def add_force(f_net, d_site_i, m_extra=None):
        """Accumulate a site-level force on molecule i: translational
        force, torque via site cross product (FullMolecule.cpp:546-548),
        and virial 0.5*drm*f (potforce.h:316)."""
        nonlocal F, M, Vi
        fsum = f_net.sum((-3, -2))
        F = F + fsum
        M = M + torch.linalg.cross(d_site_i[..., :, None, :], f_net, dim=-1).sum((-3, -2))
        if m_extra is not None:
            M = M + m_extra.sum((-3, -2))
        Vi = Vi + 0.5 * drm * fsum

    # --- LJ centers (potforce.h:295-319) ---------------------------------
    if pp.has("eps24"):
        drs, dr2 = _pair_expand(drm, sites_i["lj"], sites_j["lj"])
        eps24 = tab(pp.eps24)
        sig2 = tab(pp.sig2)
        shift6 = tab(pp.shift6)
        f, u6 = pot.lj(drs, dr2, eps24, sig2)
        f = f * mlj[..., None, None, None]
        u6lj = u6lj + (u6 + shift6).sum((-2, -1)) * mlj
        add_force(f, sites_i["lj"])

    # --- charge_i x {charge, quadrupole, dipole}_j (potforce.h:330-381) --
    if pp.has("qq"):
        drs, dr2 = _pair_expand(drm, sites_i["charge"], sites_j["charge"])
        if screen_alpha:
            # Ewald real-space part (a reciprocal solver provides the k-space rest)
            f, u = pot.charge_charge_screened(
                drs, dr2, tab(pp.qq), screen_alpha
            )
        else:
            f, u = pot.charge_charge(drs, dr2, tab(pp.qq))
        f = f * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["charge"])

    if pp.has("qQ05"):
        drs, dr2 = _pair_expand(drm, sites_i["charge"], sites_j["quad"])
        e_j = sites_j["quad_e"][..., None, :, :]
        f, _m2, u = pot.charge_quadrupole(drs, dr2, e_j, tab(pp.qQ05))
        f = f * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["charge"])

    if pp.has("minus_qmy"):
        drs, dr2 = _pair_expand(drm, sites_i["charge"], sites_j["dip"])
        e_j = sites_j["dip_e"][..., None, :, :]
        f, _m2, u = pot.charge_dipole(drs, dr2, e_j, tab(pp.minus_qmy))
        f = f * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["charge"])

    # --- quadrupole_i x {charge, quadrupole, dipole}_j (potforce.h:382-439)
    # Quadrupole-Charge: drs = site_charge_j - site_quad_i
    # (minusSiteSiteDistanceAbs, potforce.h:391); f acts on the charge,
    # so molecule i receives -f; m2 (torque on the quadrupole) -> i.
    if pp.has("Qq05"):
        drs, dr2 = _pair_expand(-drm, sites_j["charge"], sites_i["quad"])
        drs = drs.transpose(-3, -2)  # -> [..., Sq_i, Sc_j, 3]
        dr2 = dr2.transpose(-2, -1)
        e_i = sites_i["quad_e"][..., :, None, :]
        f, m_on_i, u = pot.charge_quadrupole(drs, dr2, e_i, tab(pp.Qq05))
        f = -f * mel[..., None, None, None]
        m_on_i = m_on_i * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["quad"], m_on_i)

    if pp.has("QQ075"):
        drs, dr2 = _pair_expand(drm, sites_i["quad"], sites_j["quad"])
        e_i = sites_i["quad_e"][..., :, None, :]
        e_j = sites_j["quad_e"][..., None, :, :]
        f, m1, _m2, u = pot.quadrupole_quadrupole(drs, dr2, e_i, e_j, tab(pp.QQ075))
        f = f * mel[..., None, None, None]
        m1 = m1 * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["quad"], m1)

    # Quadrupole-Dipole: drs = site_dip_j - site_quad_i (potforce.h:427);
    # PotForceDiQuadrupole's 'dipole' role is j, 'quad' role is i; f acts
    # on the dipole -> i receives -f; the quad torque (our m2) -> i.
    if pp.has("Qmy15"):
        drs, dr2 = _pair_expand(-drm, sites_j["dip"], sites_i["quad"])
        drs = drs.transpose(-3, -2)
        dr2 = dr2.transpose(-2, -1)
        e_dip_j = sites_j["dip_e"][..., None, :, :]
        e_quad_i = sites_i["quad_e"][..., :, None, :]
        f, _m_dip, m_quad, u = pot.dipole_quadrupole(
            drs, dr2, e_dip_j, e_quad_i, tab(pp.Qmy15)
        )
        f = -f * mel[..., None, None, None]
        m_quad = m_quad * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["quad"], m_quad)

    # --- dipole_i x {charge, quadrupole, dipole}_j (potforce.h:440-496) --
    # Dipole-Charge: drs = site_charge_j - site_dip_i (potforce.h:448);
    # f acts on the charge -> i receives -f; dipole torque -> i.
    if pp.has("minus_myq"):
        drs, dr2 = _pair_expand(-drm, sites_j["charge"], sites_i["dip"])
        drs = drs.transpose(-3, -2)
        dr2 = dr2.transpose(-2, -1)
        e_i = sites_i["dip_e"][..., :, None, :]
        f, m_on_i, u = pot.charge_dipole(drs, dr2, e_i, tab(pp.minus_myq))
        f = -f * mel[..., None, None, None]
        m_on_i = m_on_i * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["dip"], m_on_i)

    # Dipole-Quadrupole: drs = site_dip_i - site_quad_j (potforce.h:465);
    # dipole role is i -> f on i, m1 on i.
    if pp.has("myQ15"):
        drs, dr2 = _pair_expand(drm, sites_i["dip"], sites_j["quad"])
        e_i = sites_i["dip_e"][..., :, None, :]
        e_j = sites_j["quad_e"][..., None, :, :]
        f, m1, _m2, u = pot.dipole_quadrupole(drs, dr2, e_i, e_j, tab(pp.myQ15))
        f = f * mel[..., None, None, None]
        m1 = m1 * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        add_force(f, sites_i["dip"], m1)

    # Dipole-Dipole (potforce.h:477-495)
    if pp.has("my2"):
        drs, dr2 = _pair_expand(drm, sites_i["dip"], sites_j["dip"])
        e_i = sites_i["dip_e"][..., :, None, :]
        e_j = sites_j["dip_e"][..., None, :, :]
        f, m1, _m2, u, rf = pot.dipole_dipole(
            drs, dr2, e_i, e_j, tab(pp.my2), tab(pp.rffac)
        )
        f = f * mel[..., None, None, None]
        m1 = m1 * mel[..., None, None, None]
        uX = uX + u.sum((-2, -1)) * mel
        my_rf = my_rf + rf.sum((-2, -1)) * mel
        add_force(f, sites_i["dip"], m1)

    return dict(F=F, M=M, Vi=Vi, u6lj=u6lj, uX=uX, my_rf=my_rf)



def add_pairs(
    acc: dict,
    sites_all: dict,
    cid: torch.Tensor,
    pp: PairParams,
    ii: torch.Tensor,
    jj: torch.Tensor,
    drm: torch.Tensor,
    mask_lj: torch.Tensor,
    mask_elec: torch.Tensor,
    screen_alpha: float = 0.0,
) -> None:
    """Evaluate a flat list of ordered molecule pairs (ii[p], jj[p]) with
    COM distance drm[p] and add what lands on molecule ii[p] into
    acc["F"], acc["M"], acc["Vi"] ([N,3]) and the pair energies into
    acc["u6lj"], acc["uX"], acc["my_rf"] (0-d).  Callers list only the
    pairs inside a cutoff, so the pair function runs on those alone.
    The adds go through index_add_, whose order on a CUDA tensor is not
    fixed: sums agree between runs to rounding, not bit for bit."""
    out = molecule_pair(
        drm,
        {k: a[ii] for k, a in sites_all.items()},
        {k: a[jj] for k, a in sites_all.items()},
        cid[ii], cid[jj], pp, mask_lj, mask_elec, screen_alpha=screen_alpha,
    )
    for k in ("F", "M", "Vi"):
        acc[k].index_add_(0, ii, out[k])
    for k in ("u6lj", "uX", "my_rf"):
        acc[k] = acc[k] + out[k].sum()


def pair_sums(n: int, dtype, device) -> dict:
    """Zeroed accumulators for add_pairs."""
    acc = {k: torch.zeros((n, 3), dtype=dtype, device=device)
           for k in ("F", "M", "Vi")}
    z0 = torch.zeros((), dtype=dtype, device=device)
    acc.update(u6lj=z0, uX=z0, my_rf=z0)
    return acc


def pair_sums_result(acc: dict):
    """(Forces, Macroscopic) of accumulated ordered pairs: pair
    energies were counted from both sides -> halve (the reference counts
    each unordered pair once, potforce.h:282-503); the global virial is
    the sum over molecules of sum_d Vi[d], each ordered side having
    contributed 0.5*drm.f like Viadd on both molecules
    (potforce.h:498-499)."""
    forces = Forces(F=acc["F"], M=acc["M"], Vi=acc["Vi"])
    macro = Macroscopic(
        upot6lj=0.5 * acc["u6lj"],
        upot_xpoles=0.5 * acc["uX"],
        virial=acc["Vi"].sum(),
        my_rf=0.5 * acc["my_rf"],
    )
    return forces, macro
