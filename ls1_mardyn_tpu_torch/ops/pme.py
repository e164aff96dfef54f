"""Smooth particle-mesh Ewald (SPME): O(N log N) periodic electrostatics
(the counterpart of ls1_mardyn_tpu/ops/pme.py).

Method (Essmann et al., JCP 103, 8577 (1995)):
  - charges spread onto a [G1,G2,G3] mesh with cardinal B-splines of
    order p: each site adds wq * Mx * My * Mz to the p^3 cells
    (b - j) mod G below its base cell b, by an atomic scatter-add
    (`index_add_`);
  - Q_hat = FFT(Q); phi = IFFT(G(k) |b1 b2 b3|^2 Q_hat) * ng, with
    G(k) = 4 pi/(V k^2) exp(-k^2 / 4 alpha^2): the convolved potential
    mesh; U = 1/2 sum_mesh Q * phi (equal by Parseval to the k-sum);
  - forces: the analytic B-spline derivative interpolation of phi (the
    exact gradient of the discretised energy), a plain gather of the
    same p^3 cells.

The JAX package's sorted and blocked spread/gather modes work around
the TPU's serialising scatters and slow gathers; here one design runs
everywhere.  It has no buckets, so no bucket can overflow (the blocked
spread's NaN poisoning has nothing to guard).  Self-energy and
intramolecular corrections are ops/ewald.py's; the erfc-screened real
space is the pair path's (screen_alpha = alpha).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.ewald import (
    EwaldParams,
    charge_sites,
    self_intra_corrections,
)
from ls1_mardyn_tpu_torch.state import MoleculeState, canonical_device, on_device


def _shift_right(M):
    """M_{n-1} evaluated at (frac + j - 1): the columns shifted by one."""
    return torch.cat([torch.zeros_like(M[..., :1]), M[..., :-1]], dim=-1)


def bspline_weights(frac, p: int):
    """Cardinal B-spline values M_p(frac + j) for j = 0..p-1.

    frac: [...] fractional coordinates in [0, 1).  Returns [..., p]
    weights summing to 1, by M_n(u) = (u M_{n-1}(u) + (n-u) M_{n-1}(u-1))
    / (n-1)."""
    u = frac[..., None] + torch.arange(p, dtype=frac.dtype, device=frac.device)
    M = torch.clamp(1.0 - torch.abs(u - 1.0), min=0.0)  # M_2 on (0, 2)
    for n in range(3, p + 1):
        M = (u * M + (n - u) * _shift_right(M)) / (n - 1)
    return M


def bspline_weights_and_derivs(frac, p: int):
    """(M_p(frac+j), M_p'(frac+j)) for j = 0..p-1, using
    M_p'(u) = M_{p-1}(u) - M_{p-1}(u-1)."""
    u = frac[..., None] + torch.arange(p, dtype=frac.dtype, device=frac.device)
    M = torch.clamp(1.0 - torch.abs(u - 1.0), min=0.0)
    for n in range(3, p):
        M = (u * M + (n - u) * _shift_right(M)) / (n - 1)
    Mm1 = _shift_right(M)
    dM = M - Mm1
    M = (u * M + (p - u) * Mm1) / (p - 1)
    return M, dM


def _bsq(G: int, p: int, dtype):
    """|b(m)|^2 Euler exponential-spline factors for one dimension:
    1 / |sum_{j=0}^{p-2} M_p(j+1) e^{2 pi i m j / G}|^2 (numpy)."""
    m = np.arange(G)
    j = np.arange(p - 1)
    Mj = bspline_weights(torch.zeros((1,), dtype=torch.float64), p)[0].numpy()
    ph = np.exp(2.0 * np.pi * 1j * np.outer(m, j) / G)
    den = ph @ Mj[1:p]
    # odd orders make the denominator vanish at m = G/2: that mode is
    # zeroed (a clamp would inject a ~1/eps weight)
    d2 = np.abs(den) ** 2
    b2 = np.where(d2 < 1e-10, 0.0, 1.0 / np.maximum(d2, 1e-300))
    return b2.astype(dtype)


@dataclasses.dataclass(frozen=True)
class PMEParams:
    alpha: float
    grid: Tuple[int, int, int]
    order: int = 4

    @staticmethod
    def auto(box, rc: float, accuracy: float = 1e-5) -> "PMEParams":
        box = np.asarray(box, float)
        alpha = float(np.sqrt(-np.log(accuracy)) / rc)
        # mesh spacing ~ 1/(2 alpha) gives k_max ~ 2 pi alpha sqrt(-ln eps)
        kmax = alpha * np.sqrt(-np.log(accuracy)) / np.pi
        G = tuple(int(2 ** np.ceil(np.log2(max(8, 2 * kmax * L))))
                  for L in box)
        return PMEParams(alpha=alpha, grid=G, order=4)

    @staticmethod
    def tune(
        box, rc: float, q2_sum: float, n: int,
        accuracy: float = 1e-5, order: int = 6,
    ) -> "PMEParams":
        """Kolafa-Perram-tuned mesh: alpha and the k-cutoff from
        EwaldParams.tune, the mesh at 2x the k-space Nyquist rate so the
        order-p interpolation error stays below the truncation error."""
        ep = EwaldParams.tune(box, rc, q2_sum, n, accuracy)
        box = np.asarray(box, float)
        L = float(np.max(box))
        G = tuple(
            int(2 ** np.ceil(np.log2(max(8, 4.0 * ep.kmax * b / L))))
            for b in box
        )
        return PMEParams(alpha=ep.alpha, grid=G, order=order)


def _grid_indices_weights(rs, box, grid, p: int, with_derivs: bool = False):
    """Per-site spline columns: wrapped base cell bw [NS, 3] (int64),
    weights w3 [NS, 3, p], and with_derivs the derivative columns dw3
    [NS, 3, p] and du/dr `scale` (3 floats).  The box and grid enter as
    Python numbers, so no host tensor is sent to the device."""
    u = torch.stack([rs[:, d] / float(box[d]) * grid[d] for d in range(3)], dim=1)
    base = torch.floor(u)
    frac = u - base
    base = base.to(torch.int64)
    out = dict(bw=torch.stack([torch.remainder(base[:, d], grid[d])
                               for d in range(3)], dim=1))
    if with_derivs:
        out["w3"], out["dw3"] = bspline_weights_and_derivs(frac, p)
        out["scale"] = [grid[d] / float(box[d]) for d in range(3)]
    else:
        out["w3"] = bspline_weights(frac, p)
    return out


def _axis_cells(bw, grid, p: int):
    """Cells (b - j) mod G, j = 0..p-1, of each site on each axis:
    three [NS, p] int64 tensors."""
    joff = torch.arange(p, dtype=torch.int64, device=bw.device)
    return [torch.remainder(bw[:, d, None] - joff, grid[d]) for d in range(3)]


def _plane_index(ix_j, iy, iz, grid):
    """Flat mesh index [NS, p*p] of the cells (ix_j, iy[:, b], iz[:, c])."""
    G1, G2 = grid[1], grid[2]
    return ((ix_j[:, None, None] * G1 + iy[:, :, None]) * G2
            + iz[:, None, :]).reshape(ix_j.shape[0], -1)


def spread_charges(bw, w3, wq, grid, p: int):
    """Charge mesh Q [G1, G2, G3]: site s adds wq_s Mx My Mz to cell
    (b - j) mod G, by atomic scatter-adds, one x offset at a time (so no
    [NS, p^3] table is formed)."""
    ix, iy, iz = _axis_cells(bw, grid, p)
    wyz = (w3[:, 1, :, None] * w3[:, 2, None, :]).reshape(-1, p * p)
    Q = torch.zeros((int(np.prod(grid)),), dtype=wq.dtype, device=wq.device)
    for jx in range(p):
        vals = (wq * w3[:, 0, jx])[:, None] * wyz
        Q.index_add_(0, _plane_index(ix[:, jx], iy, iz, grid).reshape(-1),
                     vals.reshape(-1))
    return Q.reshape(grid)


def gather_forces(bw, w3, dw3, scale, wq, phi, grid, p: int):
    """Site forces [NS, 3] (already multiplied by -wq): the derivative
    interpolation of the potential mesh phi at each site's p^3 cells, a
    plain gather (the transpose of spread_charges)."""
    ix, iy, iz = _axis_cells(bw, grid, p)
    phi = phi.reshape(-1)
    wx, wy, wz = w3[:, 0], w3[:, 1], w3[:, 2]
    dwx, dwy, dwz = (dw3[:, d] * scale[d] for d in range(3))
    n = wq.shape[0]
    wyz = (wy[:, :, None] * wz[:, None, :]).reshape(n, -1)
    dyz = (dwy[:, :, None] * wz[:, None, :]).reshape(n, -1)
    ydz = (wy[:, :, None] * dwz[:, None, :]).reshape(n, -1)
    F = torch.zeros((n, 3), dtype=wq.dtype, device=wq.device)
    for jx in range(p):
        ph = phi[_plane_index(ix[:, jx], iy, iz, grid)]  # [NS, p*p]
        F[:, 0] += dwx[:, jx] * (wyz * ph).sum(1)
        F[:, 1] += wx[:, jx] * (dyz * ph).sum(1)
        F[:, 2] += wx[:, jx] * (ydz * ph).sum(1)
    return F * (-wq[:, None])


def _recip_kernel(box, grid, alpha, dtype):
    """G(k) on the FFT mesh (numpy)."""
    box = np.asarray(box, float)
    V = float(np.prod(box))
    ks = []
    for d, G in enumerate(grid):
        m = np.fft.fftfreq(G) * G  # integer frequencies, centered
        ks.append(2.0 * np.pi * m / box[d])
    KX, KY, KZ = np.meshgrid(*ks, indexing="ij")
    k2 = KX ** 2 + KY ** 2 + KZ ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        g = 4.0 * np.pi / V * np.exp(-k2 / (4.0 * alpha ** 2)) / k2
    g[0, 0, 0] = 0.0  # tinfoil boundary: drop k=0
    return g


def _full_kernel(box, grid, alpha, order, dtype):
    """G(k) * |b1 b2 b3|^2 (numpy)."""
    g = _recip_kernel(box, grid, alpha, np.float64)
    b2 = [_bsq(G, order, np.float64) for G in grid]
    B2 = b2[0][:, None, None] * b2[1][None, :, None] * b2[2][None, None, :]
    return (g * B2).astype(dtype)


class PMESolver:
    """Reciprocal-space energy, forces and torques by SPME: the mesh
    alternative to EwaldSolver under the same contract (the self and
    intramolecular corrections applied here).  It lives on the card
    unless the caller asks for the CPU, and takes molecules on its own
    device only."""

    def __init__(self, box, params: PMEParams, dtype=torch.float64,
                 device="cuda"):
        self.params = params
        self.device = canonical_device(device)
        self.box = tuple(float(b) for b in np.asarray(box))
        self.kern = torch.as_tensor(
            _full_kernel(self.box, params.grid, params.alpha, params.order,
                         np.float64),
            dtype=dtype, device=self.device,
        )

    def mesh_energy_forces(self, rs, wq):
        """(U_recip, site forces [NS,3]) from absolute charge-site
        positions rs [NS,3] and weighted charges wq [NS]."""
        p = self.params.order
        grid = self.params.grid
        giw = _grid_indices_weights(rs, self.box, grid, p, with_derivs=True)
        ng = int(np.prod(grid))
        Q = spread_charges(giw["bw"], giw["w3"], wq, grid, p)
        conv = self.kern.to(rs.dtype) * torch.fft.fftn(Q)
        # the UNNORMALISED inverse transform (ifftn * ng), so that
        # 1/2 sum_mesh Q phi equals the Parseval k-sum
        phi = torch.fft.ifftn(conv).real.to(rs.dtype) * ng
        u = 0.5 * torch.sum(Q * phi)
        F = gather_forces(giw["bw"], giw["w3"], giw["dw3"], giw["scale"], wq,
                          phi, grid, p)
        return u, F

    def __call__(self, mol: MoleculeState, pp: PairParams):
        """(U_recip + self + intra corrections, F [N,3], M [N,3])."""
        on_device(mol.r, self.device, "mol")
        offs, rs, wq = charge_sites(mol, pp)
        n, nc, _ = rs.shape
        u, f_site = self.mesh_energy_forces(rs.reshape(-1, 3), wq.reshape(-1))
        f_site = f_site.reshape(n, nc, 3)
        F = f_site.sum(1)
        M = torch.linalg.cross(offs, f_site, dim=-1).sum(1)
        u_corr, F_c, M_c = self_intra_corrections(mol, self.params.alpha, rs, wq)
        return u + u_corr, F + F_c, M + M_c
