"""Vectorized site-site pair potentials.

The counterpart of ls1_mardyn_tpu/models/potentials.py: the reference's
scalar pair physics (src/molecules/potforce.h) on tensors. Multipole formulas are from
Gray & Gubbins, *Theory of Molecular Fluids* (1984), ch. 2.4
"Explicit angle dependence", in electrostatic units (4*pi*eps0 == 1),
exactly like the reference.

All functions broadcast over arbitrary batch shapes.  Inputs:
  dr   [..., 3]  site-site distance vector, ``site_i - site_j``
  e_i  [..., 3]  world-frame orientation unit vector of site on molecule i
  e_j  [..., 3]  world-frame orientation unit vector of site on molecule j
and scalar (broadcastable) coupling constants from
:class:`~ls1_mardyn_tpu_torch.models.components.ComponentTable`.

Outputs: force ``f`` on molecule i's site (molecule j receives ``-f``),
torque contributions ``m1`` (on i) and ``m2`` (on j), and the pair
energy ``u``.  Sign conventions (which molecule gets +f, whether the
distance vector is negated) are resolved by the callers in
``oracle.py``/force kernels following potforce.h:282-503.

Everything is safe at dr == 0 (padded slots): callers mask outputs, and
we guard the divisions with a tiny epsilon so no NaN/Inf propagates
through ``where``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-30


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def lj(dr, dr2, eps24, sig2):
    """LJ-12-6 between two centers; PotForceLJ (potforce.h:18-31).

    Returns (f [...,3], u6 [...]) where u6 = 6*U (the reference
    accumulates Upot6LJ and divides by 6 at the end,
    VectorizedCellProcessor.cpp:156). The caller adds shift6.
    """
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    lj6 = sig2 * invdr2
    lj6 = lj6 * lj6 * lj6
    lj12 = lj6 * lj6
    lj12m6 = lj12 - lj6
    u6 = eps24 * lj12m6
    fac = eps24 * (lj12 + lj12m6) * invdr2
    return fac[..., None] * dr, u6


def charge_charge(dr, dr2, q1q2per4pie0):
    """Coulomb; PotForce2Charge (potforce.h:190-199)."""
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr = torch.sqrt(invdr2)
    u = q1q2per4pie0 * invdr
    fac = u * invdr2
    return fac[..., None] * dr, u


def charge_charge_screened(dr, dr2, q1q2per4pie0, alpha):
    """erfc-screened Coulomb (the real-space part of Ewald summation;
    replaces PotForce2Charge when a reciprocal solver handles the
    long-range tail):
      u = qq erfc(a r)/r,  f = qq (erfc(a r)/r + 2a/sqrt(pi) e^{-a^2r^2}) /r^2 * dr
    """
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr = torch.sqrt(invdr2)
    r = dr2 * invdr
    erfc = torch.erfc(alpha * r)
    u = q1q2per4pie0 * erfc * invdr
    two_a_pi = 2.0 * alpha / math.sqrt(math.pi)
    fac = (u + q1q2per4pie0 * two_a_pi * torch.exp(-alpha * alpha * dr2)) * invdr2
    return fac[..., None] * dr, u


def charge_dipole(dr, dr2, e_j, minus_qmy):
    """Charge (i) -- dipole (j); PotForceChargeDipole (potforce.h:237-263).

    dr points from the dipole site to the charge site when the charge is
    'i' (reference calls it with drs = site_charge - site_dipole).
    Returns (f on charge, m2 torque on the dipole, u).
    """
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr = torch.sqrt(invdr2)
    costj = _dot(e_j, dr) * invdr
    u_inv_costj = minus_qmy * invdr2
    u = u_inv_costj * costj
    partial_tj_invdr1 = u_inv_costj * invdr
    fac = 3.0 * u * invdr2
    f = fac[..., None] * dr - partial_tj_invdr1[..., None] * e_j
    minus_e_x_r = _cross(dr, e_j)  # == e_j x dr negated, matching potforce.h:257-260
    m2 = partial_tj_invdr1[..., None] * minus_e_x_r
    return f, m2, u


def charge_quadrupole(dr, dr2, e_j, qQ05):
    """Charge (i) -- quadrupole (j); PotForceChargeQuadrupole
    (potforce.h:205-231). Returns (f on charge, m2 on quadrupole, u)."""
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr = torch.sqrt(invdr2)
    costj = _dot(e_j, dr) * invdr
    qQinv4dr3 = qQ05 * invdr * invdr2
    u = qQinv4dr3 * (3.0 * costj * costj - 1.0)
    partial_rij_invdr1 = -3.0 * u * invdr2
    partial_tj_invdr1 = 6.0 * costj * qQinv4dr3 * invdr
    fac = costj * partial_tj_invdr1 * invdr - partial_rij_invdr1
    f = fac[..., None] * dr - partial_tj_invdr1[..., None] * e_j
    minus_e_x_r = _cross(dr, e_j)
    m2 = partial_tj_invdr1[..., None] * minus_e_x_r
    return f, m2, u


def dipole_dipole(dr, dr2, e_i, e_j, my2, rffac):
    """Dipole-dipole; PotForce2Dipole (potforce.h:36-80), Gray & Gubbins
    (2.180). Returns (f on i, m1 on i, m2 on j, u, my_rf_contrib).

    my_rf_contrib is the reaction-field term the reference accumulates as
    ``MyRF -= rffac*cosgij`` (potforce.h:57); we return
    ``-rffac*cosgij`` to be summed by the caller.
    """
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr1 = torch.sqrt(invdr2)
    myfac = my2 * invdr2 * invdr1
    costi = _dot(e_i, dr) * invdr1
    costj = _dot(e_j, dr) * invdr1
    cosgij = _dot(e_i, e_j)
    u = myfac * (cosgij - 3.0 * costi * costj)
    my_rf = -rffac * cosgij
    partial_ti = -myfac * 3.0 * costj * invdr1
    partial_tj = -myfac * 3.0 * costi * invdr1
    partial_gij = myfac
    partial_rij = -3.0 * u * invdr2
    fac = -partial_rij + (costi * partial_ti + costj * partial_tj) * invdr1
    f = (
        fac[..., None] * dr
        - partial_ti[..., None] * e_i
        - partial_tj[..., None] * e_j
    )
    ei_x_ej = _cross(e_i, e_j)
    ei_x_r = _cross(e_i, dr)
    ej_x_r = _cross(e_j, dr)
    m1 = -partial_ti[..., None] * ei_x_r + (rffac - partial_gij)[..., None] * ei_x_ej
    m2 = -partial_tj[..., None] * ej_x_r + (partial_gij - rffac)[..., None] * ei_x_ej
    return f, m1, m2, u, my_rf


def dipole_quadrupole(dr, dr2, e_i, e_j, myq15):
    """Dipole (i) -- quadrupole (j); PotForceDiQuadrupole
    (potforce.h:139-184), Gray & Gubbins (2.182).
    Returns (f on dipole, m1 on dipole, m2 on quadrupole, u)."""
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr1 = torch.sqrt(invdr2)
    myqfac = myq15 * invdr2 * invdr2
    costi = _dot(e_i, dr) * invdr1
    costj = _dot(e_j, dr) * invdr1
    cosgij = _dot(e_i, e_j)
    cos2tj = costj * costj
    u = myqfac * (-costi * (5.0 * cos2tj - 1.0) + 2.0 * cosgij * costj)
    partial_rij = -4.0 * u * invdr2
    partial_ti = myqfac * (-5.0 * cos2tj + 1.0) * invdr1
    partial_tj = myqfac * 2.0 * (-5.0 * costi * costj + cosgij) * invdr1
    partial_gij = myqfac * 2.0 * costj
    fac = -partial_rij + (costi * partial_ti + costj * partial_tj) * invdr1
    f = (
        fac[..., None] * dr
        - partial_ti[..., None] * e_i
        - partial_tj[..., None] * e_j
    )
    ei_x_ej = _cross(e_i, e_j)
    ei_x_r = _cross(e_i, dr)
    ej_x_r = _cross(e_j, dr)
    m1 = -partial_ti[..., None] * ei_x_r - partial_gij[..., None] * ei_x_ej
    m2 = -partial_tj[..., None] * ej_x_r + partial_gij[..., None] * ei_x_ej
    return f, m1, m2, u


def quadrupole_quadrupole(dr, dr2, e_i, e_j, q2075):
    """Quadrupole-quadrupole; PotForce2Quadrupole (potforce.h:86-133),
    Gray & Gubbins (2.184). Returns (f on i, m1 on i, m2 on j, u)."""
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    invdr1 = torch.sqrt(invdr2)
    qfac = q2075 * invdr2 * invdr2 * invdr1
    costi = _dot(e_i, dr) * invdr1
    costj = _dot(e_j, dr) * invdr1
    cosgij = _dot(e_i, e_j)
    cos2ti = costi * costi
    cos2tj = costj * costj
    term = cosgij - 5.0 * costi * costj
    u = qfac * (
        1.0 - 5.0 * (cos2ti + cos2tj) - 15.0 * cos2ti * cos2tj + 2.0 * term * term
    )
    partial_rij = -5.0 * u * invdr2
    partial_ti = -qfac * 10.0 * (costi + 3.0 * costi * cos2tj + 2.0 * costj * term) * invdr1
    partial_tj = -qfac * 10.0 * (costj + 3.0 * cos2ti * costj + 2.0 * costi * term) * invdr1
    partial_gij = qfac * 4.0 * term
    fac = -partial_rij + (costi * partial_ti + costj * partial_tj) * invdr1
    f = (
        fac[..., None] * dr
        - partial_ti[..., None] * e_i
        - partial_tj[..., None] * e_j
    )
    ei_x_ej = _cross(e_i, e_j)
    ei_x_r = _cross(e_i, dr)
    ej_x_r = _cross(e_j, dr)
    m1 = -partial_ti[..., None] * ei_x_r - partial_gij[..., None] * ei_x_ej
    m2 = -partial_tj[..., None] * ej_x_r + partial_gij[..., None] * ei_x_ej
    return f, m1, m2, u
