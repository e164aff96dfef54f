"""Ewald summation: full periodic electrostatics for point charges (the
counterpart of ls1_mardyn_tpu/ops/ewald.py).

The reference's long-range electrostatics slot (bhfmm,
ls1-MarDyn src/bhfmm/) filled by a uniform k-space method: the
structure factors
    S(k) = sum_j q_j exp(i k.r_j)
are dense [N_sites, K] matmuls, the reciprocal energy and forces are
elementwise in k.

Standard Ewald split (charges only; 4*pi*eps0 == 1, tinfoil boundary):
  U_real  = 1/2 sum_{i!=j,images} q_i q_j erfc(alpha r)/r   (cutoff rc)
  U_recip = (2*pi/V) sum_{k!=0} e^{-k^2/(4 a^2)}/k^2 |S(k)|^2
  U_self  = -alpha/sqrt(pi) * sum q_i^2
  U_intra = -1/2 sum_mol sum_{site pairs} q_a q_b erf(alpha r_ab)/r_ab
(intramolecular pairs are excluded interactions in the reference's
model, so their k-space contribution is removed by the erf term).

The real-space part rides the pair paths (their `screen_alpha`: K5/K6,
the N^2 oracle, the plain traversal); this module adds the reciprocal
pieces through the extra-force contract
    (mol, pp) -> (u, F [N,3], M [N,3]).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams, site_offsets
from ls1_mardyn_tpu_torch.state import MoleculeState, canonical_device, on_device

# bytes one [N_sites, k-chunk] temporary of the k-space passes may take
K_CHUNK_BYTES = 256 * 2**20


def make_kvectors(box, kmax: int, alpha: float, dtype=np.float64):
    """All reciprocal vectors 0 < |n| <= kmax (integer shells), with
    their Ewald coefficients 4*pi/V * exp(-k^2/4a^2)/k^2.
    Returns (k [K,3], coeff [K]) as numpy arrays."""
    box = np.asarray(box, float)
    rng = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    n = n[(n ** 2).sum(1) > 0]
    n = n[(n ** 2).sum(1) <= kmax ** 2]
    k = 2.0 * np.pi * n / box[None, :]
    k2 = (k ** 2).sum(1)
    V = float(np.prod(box))
    coeff = 4.0 * np.pi / V * np.exp(-k2 / (4.0 * alpha ** 2)) / k2
    return k.astype(dtype), coeff.astype(dtype)


@dataclasses.dataclass(frozen=True)
class EwaldParams:
    alpha: float
    kmax: int

    @staticmethod
    def auto(box, rc: float, accuracy: float = 1e-5) -> "EwaldParams":
        """Standard parameter heuristic: alpha from the real-space
        cutoff so erfc(alpha*rc) ~ accuracy, kmax to match."""
        box = np.asarray(box, float)
        alpha = np.sqrt(-np.log(accuracy)) / rc
        kmax = int(np.ceil(alpha * np.max(box) * np.sqrt(-np.log(accuracy)) / np.pi))
        return EwaldParams(alpha=float(alpha), kmax=max(kmax, 1))

    @staticmethod
    def tune(
        box, rc: float, q2_sum: float, n: int, accuracy: float = 1e-5
    ) -> "EwaldParams":
        """Self-tuning against the Kolafa-Perram RMS force-error
        estimates (Mol. Simul. 9, 351 (1992)): given the charge content
        (q2_sum = sum q_i^2 over n charge sites), bisect alpha so the
        real-space error at rc meets `accuracy` (force units), then grow
        kmax until the reciprocal estimate matches:
          dF_real  ~ 2 q2/sqrt(n rc V) exp(-a^2 rc^2)
          dF_recip ~ 2 q2 a/(pi sqrt(n kappa V)) exp(-(kappa/2a)^2)
        """
        box = np.asarray(box, float)
        V = float(np.prod(box))
        L = float(np.max(box))
        q2 = max(float(q2_sum), 1e-300)
        n = max(int(n), 1)

        def err_real(a):
            return 2.0 * q2 / np.sqrt(n * rc * V) * np.exp(-(a * rc) ** 2)

        def err_recip(a, kc):
            kappa = 2.0 * np.pi * kc / L  # cutoff in k-space
            return (
                2.0 * q2 * a / (np.pi * np.sqrt(n * kappa * V))
                * np.exp(-((kappa / (2.0 * a)) ** 2))
            )

        lo, hi = 1e-3 / rc, 20.0 / rc
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if err_real(mid) > accuracy:
                lo = mid
            else:
                hi = mid
        alpha = hi
        kmax = 1
        while err_recip(alpha, kmax) > accuracy and kmax < 64:
            kmax += 1
        return EwaldParams(alpha=float(alpha), kmax=int(kmax))


def charge_sites(mol: MoleculeState, pp: PairParams):
    """(world-frame charge-site offsets [N, NC, 3], absolute site
    positions [N, NC, 3], validity-weighted site charges [N, NC])."""
    offs = site_offsets(pp, mol.q, mol.cid)["charge"]
    wq = pp.charge_q[mol.cid.long()] * mol.valid[:, None].to(mol.r.dtype)
    return offs, mol.r[:, None, :] + offs, wq


def k_chunk(n_sites: int, n_k: int, dtype) -> int:
    """k-vectors a pass takes at once: one [n_sites, chunk] temporary
    stays within K_CHUNK_BYTES (the sum over chunks does not depend on
    the chunk beyond rounding)."""
    item = torch.finfo(dtype).bits // 8
    return max(1, min(n_k, K_CHUNK_BYTES // max(1, n_sites * item)))


def reciprocal_energy_forces(
    mol: MoleculeState,
    pp: PairParams,
    kvec: torch.Tensor,  # [K, 3]
    coeff: torch.Tensor,  # [K]
    alpha: float,
):
    """Reciprocal-space energy and per-molecule forces and torques, with
    the self and intramolecular corrections subtracted, so that (this +
    the erfc-screened real-space pair sum) equals the periodic Coulomb
    sum over distinct molecules.  Returns (u, F [N,3], M [N,3]).

    The k-vectors go in chunks of k_chunk (pass 1: the structure
    factor, pass 2: the forces)."""
    dtype = mol.r.dtype
    n = mol.capacity
    offs, rs, wq = charge_sites(mol, pp)
    nc = rs.shape[1]
    r_flat = rs.reshape(-1, 3)
    w_flat = wq.reshape(-1)
    K = kvec.shape[0]
    kc = k_chunk(r_flat.shape[0], K, dtype)
    Sr = torch.empty((K,), dtype=dtype, device=rs.device)
    Si = torch.empty_like(Sr)
    for k0 in range(0, K, kc):
        phase = r_flat @ kvec[k0:k0 + kc].T  # [NS, kc]
        Sr[k0:k0 + kc] = w_flat @ torch.cos(phase)
        Si[k0:k0 + kc] = w_flat @ torch.sin(phase)
    u_recip = 0.5 * torch.sum(coeff * (Sr * Sr + Si * Si))
    f_site = torch.zeros_like(r_flat)
    for k0 in range(0, K, kc):
        kk = kvec[k0:k0 + kc]
        phase = r_flat @ kk.T
        imag = torch.sin(phase) * Sr[k0:k0 + kc] - torch.cos(phase) * Si[k0:k0 + kc]
        f_site = f_site + imag @ (coeff[k0:k0 + kc, None] * kk)
    f_site = (f_site * w_flat[:, None]).reshape(n, nc, 3)
    F = f_site.sum(1)
    M = torch.linalg.cross(offs, f_site, dim=-1).sum(1)
    u_corr, F_c, M_c = self_intra_corrections(mol, alpha, rs, wq)
    return u_recip + u_corr, F + F_c, M + M_c


def self_intra_corrections(
    mol: MoleculeState,
    alpha: float,
    rs: torch.Tensor,  # [N, NC, 3] absolute charge-site positions
    wq: torch.Tensor,  # [N, NC] validity-weighted site charges
):
    """Self-energy and intramolecular-exclusion corrections shared by
    the direct (EwaldSolver) and mesh (PMESolver) k-space paths.
    Returns (u_self + u_intra, F [N,3], M [N,3])."""
    dtype = rs.dtype
    offs = rs - mol.r[:, None, :]
    a = float(alpha)
    u_self = -a / math.sqrt(math.pi) * torch.sum(wq * wq)
    drs = rs[:, :, None, :] - rs[:, None, :, :]  # [N, NC, NC, 3]
    dist2 = (drs * drs).sum(-1)
    nc = wq.shape[1]
    eye = torch.eye(nc, dtype=torch.bool, device=rs.device)
    qq = wq[:, :, None] * wq[:, None, :]
    pair_ok = (~eye)[None] & (qq.abs() > 0) & (dist2 > 1e-20)
    one = torch.ones((), dtype=dtype, device=rs.device)
    dist2s = torch.where(pair_ok, dist2, one)
    dist = torch.sqrt(dist2s)
    erf_term = torch.special.erf(a * dist) / dist
    zero = torch.zeros((), dtype=dtype, device=rs.device)
    u_intra = -0.5 * torch.where(pair_ok, qq * erf_term, zero).sum()
    # U_corr(r) = -qq*erf(ar)/r on each intra pair:
    # F_a = qq * (2a/sqrt(pi) e^{-a^2 r^2} - erf(ar)/r) / r^2 * dr_vec
    two_a_pi = 2.0 * a / math.sqrt(math.pi)
    fmag = torch.where(
        pair_ok,
        qq * (two_a_pi * torch.exp(-a * a * dist2) - erf_term) / dist2s,
        zero,
    )
    f_site = (fmag[..., None] * drs).sum(2)  # [N, NC, 3]
    F = f_site.sum(1)
    M = torch.linalg.cross(offs, f_site, dim=-1).sum(1)
    return u_self + u_intra, F, M


class EwaldSolver:
    """The reciprocal pieces of direct Ewald; the real-space erfc part is
    the pair path's (screen_alpha = params.alpha).  It lives on the card
    unless the caller asks for the CPU, and takes molecules on its own
    device only."""

    def __init__(self, box, params: EwaldParams, dtype=torch.float64,
                 device="cuda"):
        self.params = params
        self.device = canonical_device(device)
        k, c = make_kvectors(np.asarray(box), params.kmax, params.alpha)
        self.kvec = torch.as_tensor(k, dtype=dtype, device=self.device)
        self.coeff = torch.as_tensor(c, dtype=dtype, device=self.device)

    def __call__(self, mol: MoleculeState, pp: PairParams):
        on_device(mol.r, self.device, "mol")
        return reciprocal_energy_forces(
            mol, pp, self.kvec, self.coeff, self.params.alpha
        )
