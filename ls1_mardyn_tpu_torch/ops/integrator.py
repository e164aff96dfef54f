"""Leapfrog (velocity-Verlet) integrator with rigid-body quaternion
rotation (the counterpart of ls1_mardyn_tpu/ops/integrator.py).

Numerics match the reference's two-phase update exactly:
  - pre-force  (Leapfrog::eventNewTimestep -> FullMolecule::upd_preF,
    src/molecules/FullMolecule.cpp:334-364):
      v += dt/(2m) * F;  r += dt * v
      w_body = I^-1 R(q)^-1 L
      q_half = normalize(q + dt/2 * dq/dt(q, w_body))
      L += dt/2 * M
      w_half = I^-1 R(q_half)^-1 L
      q = normalize(q + dt * dq/dt(q_half, w_half))
  - post-force (Leapfrog::eventForcesCalculated -> upd_postF,
    FullMolecule.cpp:366-389):
      v += dt/(2m) * F;  L += dt/2 * M
      accumulate 2*KE_trans = sum m v^2 and 2*KE_rot = sum I w^2
    (the kinetic sums feed Domain::calculateGlobalValues,
    src/Domain.cpp:152-262)

Molecules without rotational DOF keep q and L untouched: their
inv_inertia is zero (ComponentTable), so w_body is an exact zero, the
quaternion ladder returns q itself, and the `rot` select below keeps
the stored q in any case.  Invalid slots move nowhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.models.quaternion import qdifferentiate, qnormalize, qrotate_inv
from ls1_mardyn_tpu_torch.state import Forces, MoleculeState


def _body_omega(pp: PairParams, cid, q, L):
    """w_body = I^-1 R(q)^-1 L (FullMolecule.cpp:343-345; 'L = D = Iw')."""
    return qrotate_inv(q, L) * pp.inv_inertia[cid]


def _rotate(mol: MoleculeState, forces: Forces, pp, cid, half, dt, rot):
    """The rotational half-step ladder (FullMolecule.cpp:343-362);
    returns (q, L).  A scene whose components all lack rotational
    degrees of freedom skips it: `rot` is then False everywhere and the
    selects below would return q and L as they are."""
    if not pp.has("rot_dof"):
        return mol.q, mol.L
    w = _body_omega(pp, cid, mol.q, mol.L)
    q_half = qnormalize(mol.q + half * qdifferentiate(mol.q, w))
    L = mol.L + torch.where(rot, half * forces.M, 0.0)
    w_half = _body_omega(pp, cid, q_half, L)
    q_new = qnormalize(mol.q + dt * qdifferentiate(q_half, w_half))
    return torch.where(rot, q_new, mol.q), L


def _kick_terms(mol: MoleculeState, pp: PairParams, dt: float):
    cid = mol.cid.long()
    mass = pp.mass[cid]
    vmask = mol.valid[:, None]
    rot = vmask & (pp.rot_dof[cid] > 0)[:, None]
    return cid, mass, vmask, rot, 0.5 * dt


def upd_pre_force(
    mol: MoleculeState, forces: Forces, pp: PairParams, dt: float
) -> MoleculeState:
    cid, mass, vmask, rot, half = _kick_terms(mol, pp, dt)
    v = mol.v + torch.where(vmask, half / mass[:, None] * forces.F, 0.0)
    r = mol.r + torch.where(vmask, dt * v, 0.0)
    q, L = _rotate(mol, forces, pp, cid, half, dt, rot)
    return MoleculeState(
        r=r, v=v, q=q, L=L, cid=mol.cid, mid=mol.mid, valid=mol.valid
    )


def _kahan(x, comp, inc):
    """Compensated accumulation x += inc (Kahan-Neumaier): returns
    (x_new, comp_new).  The f32 answer to the reference's SPDP
    mixed-precision mode (SIMD_TYPES.h:110-113: f32 compute,
    effectively-f64 accumulate)."""
    y = inc - comp
    t = x + y
    return t, (t - x) - y


def upd_pre_force_kahan(
    mol: MoleculeState,
    forces: Forces,
    pp: PairParams,
    dt: float,
    rcomp: torch.Tensor,
    vcomp: torch.Tensor,
):
    """upd_pre_force with compensated r/v accumulation (for paths that
    keep absolute f32 positions: without compensation the per-step
    rounding of r += dt*v at |r| >> dt*|v| injects a random heating
    kick; the RMM path solves this with cell-local coordinates
    instead).  Returns (state, rcomp, vcomp)."""
    cid, mass, vmask, rot, half = _kick_terms(mol, pp, dt)
    v, vcomp = _kahan(
        mol.v, vcomp, torch.where(vmask, half / mass[:, None] * forces.F, 0.0)
    )
    r, rcomp = _kahan(mol.r, rcomp, torch.where(vmask, dt * v, 0.0))
    q, L = _rotate(mol, forces, pp, cid, half, dt, rot)
    out = MoleculeState(
        r=r, v=v, q=q, L=L, cid=mol.cid, mid=mol.mid, valid=mol.valid
    )
    return out, rcomp, vcomp


def _kinetic(pp: PairParams, cid, mass, q, v, L, valid):
    mv2 = mass * (v * v).sum(-1) * valid
    if not pp.has("inertia"):
        return mv2, torch.zeros_like(mv2)  # no rotating component
    w = _body_omega(pp, cid, q, L)
    iw2 = (pp.inertia[cid] * w * w).sum(-1) * valid
    return mv2, iw2


def upd_post_force_kahan(
    mol: MoleculeState,
    forces: Forces,
    pp: PairParams,
    dt: float,
    vcomp: torch.Tensor,
):
    """upd_post_force with compensated v accumulation; returns
    (state, mv2, Iw2, vcomp)."""
    cid, mass, vmask, rot, half = _kick_terms(mol, pp, dt)
    v, vcomp = _kahan(
        mol.v, vcomp, torch.where(vmask, half / mass[:, None] * forces.F, 0.0)
    )
    L = mol.L + torch.where(rot, half * forces.M, 0.0)
    mv2, iw2 = _kinetic(pp, cid, mass, mol.q, v, L, mol.valid)
    out = MoleculeState(
        r=mol.r, v=v, q=mol.q, L=L, cid=mol.cid, mid=mol.mid, valid=mol.valid
    )
    return out, mv2, iw2, vcomp


def upd_post_force(
    mol: MoleculeState, forces: Forces, pp: PairParams, dt: float
) -> Tuple[MoleculeState, torch.Tensor, torch.Tensor]:
    """Second half-kick. Returns (state, summv2_per_mol, sumIw2_per_mol);
    callers reduce the per-molecule kinetic terms into the thermostat
    sums (per thermostat region / component, Leapfrog.cpp:66-130)."""
    cid, mass, vmask, rot, half = _kick_terms(mol, pp, dt)
    v = mol.v + torch.where(vmask, half / mass[:, None] * forces.F, 0.0)
    L = mol.L + torch.where(rot, half * forces.M, 0.0)
    mv2, iw2 = _kinetic(pp, cid, mass, mol.q, v, L, mol.valid)
    out = MoleculeState(
        r=mol.r, v=v, q=mol.q, L=L, cid=mol.cid, mid=mol.mid, valid=mol.valid
    )
    return out, mv2, iw2


def kinetic_sums(mol: MoleculeState, pp: PairParams):
    """2*KE sums without advancing state (Domain::calculateVelocitySums /
    FullMolecule::calculate_mv2_Iw2, FullMolecule.cpp:412-421)."""
    cid = mol.cid.long()
    return _kinetic(pp, cid, pp.mass[cid], mol.q, mol.v, mol.L, mol.valid)
