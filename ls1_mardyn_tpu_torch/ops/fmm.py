"""Fast Multipole Method: solid-harmonics uniform octree (the counterpart
of ls1_mardyn_tpu/ops/fmm.py; the reference's bhfmm subsystem,
ls1-MarDyn src/bhfmm/: P2M at the leaves, M2M up, M2L across
interaction lists, L2L down, L2P + near-field P2P).

  * expansions are dense realified coefficient vectors per cell
    ([Re; Im], length 2(p+1)^2), so every translation is a real matmul;
  * the M2M / M2L / L2L operators are built once on the host (numpy
    complex128) and applied as batched matmuls over all cells of a
    level;
  * M2L runs per child parity: the 8 parity classes of a level each take
    their <= 189 interaction-list offsets; periodic boxes read the
    sources by torch.roll (aliased rolls at small grids are distinct
    physical images, each with its own operator);
  * L2P forces are the autograd gradient of the local-expansion
    potential (exactly consistent with the evaluated energy);
  * near-field P2P is the 27-neighbourhood dense window over the
    cell-major slot table, chunked over cells.

Conventions (pinned to machine precision in tests/test_fmm.py):
  R_n^m(r) = r^n P_n^m(cos t) e^{imp} / (n+m)!          (regular)
  S_n^m(r) = (n-m)! P_n^m(cos t) e^{imp} / r^{n+1}      (irregular)
  X_n^{-m} = (-1)^m conj(X_n^m);  no Condon-Shortley phase.

Scope: free-space and fully periodic boxes.  periodic=True runs the
wrapped M2L at levels 1..D, min-image near field, and a lattice
recursion for everything beyond the 27 nearest box images (3x-coarsening
blocks with a pre-summed 702-offset far operator per scale, in per-scale
units so that f32 stays finite), truncated at `lattice_scales`.  It
needs a neutral system; the cubic-shell summation order matches tinfoil
Ewald when the box dipole vanishes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.state import canonical_device, on_device

__all__ = ["FMMSolver", "FMMElectrostatics", "direct_coulomb"]

# pair elements ([chunk, cap, 27 cap]) one near-field pass may hold
NEAR_PAIRS = 2 ** 24
# interaction-list offsets one batched M2L matmul takes
M2L_CHUNK = 27


# ---------------------------------------------------------------------------
# host-side solid harmonics and operators (numpy, complex128)
# ---------------------------------------------------------------------------


def _sh_RS(v: np.ndarray, p: int) -> Tuple[Dict, Dict]:
    """Regular/irregular solid harmonics of a single point, as dicts
    keyed (n, m) for m = -n..n (Cartesian recursions)."""
    x, y, z = (float(c) for c in v)
    r2 = x * x + y * y + z * z
    R: Dict = {(0, 0): 1.0 + 0j}
    S: Dict = {(0, 0): 1.0 / np.sqrt(r2) + 0j}
    xy = x + 1j * y
    for n in range(1, p + 1):
        R[(n, n)] = R[(n - 1, n - 1)] * xy / (2 * n)
        S[(n, n)] = (2 * n - 1) * xy / r2 * S[(n - 1, n - 1)]
    for m in range(0, p + 1):
        for n in range(m + 1, p + 1):
            Rm2 = R.get((n - 2, m), 0.0)
            Sm2 = S.get((n - 2, m), 0.0)
            R[(n, m)] = ((2 * n - 1) * z * R[(n - 1, m)] - r2 * Rm2) / (
                (n + m) * (n - m)
            )
            S[(n, m)] = (
                (2 * n - 1) * z * S[(n - 1, m)] - ((n - 1) ** 2 - m * m) * Sm2
            ) / r2
    for n in range(0, p + 1):
        for m in range(1, n + 1):
            R[(n, -m)] = (-1) ** m * np.conj(R[(n, m)])
            S[(n, -m)] = (-1) ** m * np.conj(S[(n, m)])
    return R, S


def _sh_R(v: np.ndarray, p: int) -> Dict:
    """Regular harmonics only (well-defined at v = 0, where the irregular
    recursion divides by r^2)."""
    x, y, z = (float(c) for c in v)
    r2 = x * x + y * y + z * z
    R: Dict = {(0, 0): 1.0 + 0j}
    xy = x + 1j * y
    for n in range(1, p + 1):
        R[(n, n)] = R[(n - 1, n - 1)] * xy / (2 * n)
    for m in range(0, p + 1):
        for n in range(m + 1, p + 1):
            Rm2 = R.get((n - 2, m), 0.0)
            R[(n, m)] = ((2 * n - 1) * z * R[(n - 1, m)] - r2 * Rm2) / (
                (n + m) * (n - m)
            )
    for n in range(0, p + 1):
        for m in range(1, n + 1):
            R[(n, -m)] = (-1) ** m * np.conj(R[(n, m)])
    return R


def _idx(n: int, m: int) -> int:
    return n * n + n + m


def _hvec(H: Dict, p: int) -> np.ndarray:
    """Harmonics dict -> vector [(p+1)^2] in _idx order."""
    out = np.zeros(((p + 1) ** 2,), complex)
    for n in range(p + 1):
        for m in range(-n, n + 1):
            out[_idx(n, m)] = H[(n, m)]
    return out


@functools.lru_cache(maxsize=None)
def _shift_index(p: int, up: bool):
    """(rows, cols, harmonic index) of the non-zero entries of the M2M
    (up) or L2L operator: T[idx(n,m), idx(j,k)] = R_{n-j}^{m-k} (M2M) and
    T[idx(j',k'), idx(j,k)] = R_{j-j'}^{k-k'} (L2L)."""
    rows, cols, hidx = [], [], []
    for n in range(p + 1):
        for m in range(-n, n + 1):
            for j in range(n + 1):
                for k in range(-j, j + 1):
                    if abs(m - k) <= n - j:
                        hi, lo = _idx(n, m), _idx(j, k)
                        rows.append(hi if up else lo)
                        cols.append(lo if up else hi)
                        hidx.append(_idx(n - j, m - k))
    return np.asarray(rows), np.asarray(cols), np.asarray(hidx)


@functools.lru_cache(maxsize=None)
def _m2l_index(p: int):
    """(S-vector index [nc, nc], sign [nc, nc]) of the M2L operator
    T[idx(j,k), idx(n,m)] = (-1)^j conj(S_{n+j}^{m+k})."""
    nc = (p + 1) ** 2
    idxm = np.zeros((nc, nc), np.int64)
    sgn = np.zeros((nc, nc), np.int64)
    for j in range(p + 1):
        for k in range(-j, j + 1):
            for n in range(p + 1):
                for m in range(-n, n + 1):
                    idxm[_idx(j, k), _idx(n, m)] = _idx(n + j, m + k)
                    sgn[_idx(j, k), _idx(n, m)] = (-1) ** j
    return idxm, sgn


def _m2m_matrix(t: np.ndarray, p: int) -> np.ndarray:
    """M'_n^m = sum_{j<=n,k} R_{n-j}^{m-k}(-t) M_j^k  (shift the
    multipole center by t)."""
    nc = (p + 1) ** 2
    R = _hvec(_sh_R(-np.asarray(t, float), p), p)
    rows, cols, hidx = _shift_index(p, True)
    T = np.zeros((nc, nc), complex)
    T[rows, cols] = R[hidx]
    return T


def _m2l_matrix(t: np.ndarray, p: int) -> np.ndarray:
    """L_j^k = (-1)^j sum_{n,m} conj(S_{n+j}^{m+k}(t)) M_n^m  (multipole
    at c, local about c + t)."""
    _, S = _sh_RS(np.asarray(t, float), 2 * p)
    idxm, sgn = _m2l_index(p)
    return sgn * np.conj(_hvec(S, 2 * p)[idxm])


def _l2l_matrix(u: np.ndarray, p: int) -> np.ndarray:
    """L'_j'^k' = sum_{j>=j'} R_{j-j'}^{k-k'}(u) L_j^k  (shift the local
    center by u)."""
    nc = (p + 1) ** 2
    R = _hvec(_sh_R(np.asarray(u, float), p), p)
    rows, cols, hidx = _shift_index(p, False)
    T = np.zeros((nc, nc), complex)
    T[rows, cols] = R[hidx]
    return T


def _realify(A: np.ndarray, dtype) -> np.ndarray:
    """Complex [nc, nc] operator -> real [2nc, 2nc] acting on [Re; Im]
    coefficient vectors (exact)."""
    Ar, Ai = A.real, A.imag
    return np.asarray(
        np.block([[Ar, -Ai], [Ai, Ar]]), dtype=np.dtype(dtype)
    )


# ---------------------------------------------------------------------------
# device-side solid harmonics (torch; unrolled in (n, m))
# ---------------------------------------------------------------------------


def _rvec_real(dr: torch.Tensor, p: int) -> torch.Tensor:
    """Realified regular harmonics [..., 2(p+1)^2] of displacements
    dr [..., 3] (differentiable: L2P forces are its autograd gradient)."""
    x, y, z = dr[..., 0], dr[..., 1], dr[..., 2]
    r2 = x * x + y * y + z * z
    R = {(0, 0): (torch.ones_like(x), torch.zeros_like(x))}
    for n in range(1, p + 1):
        pr, pi = R[(n - 1, n - 1)]
        # * (x + iy) / (2n)
        R[(n, n)] = ((pr * x - pi * y) / (2 * n), (pr * y + pi * x) / (2 * n))
    for m in range(0, p + 1):
        for n in range(m + 1, p + 1):
            pr, pi = R[(n - 1, m)]
            qr, qi = R.get((n - 2, m), (0.0, 0.0))
            d = (n + m) * (n - m)
            R[(n, m)] = (
                ((2 * n - 1) * z * pr - r2 * qr) / d,
                ((2 * n - 1) * z * pi - r2 * qi) / d,
            )
    re: List = []
    im: List = []
    for n in range(p + 1):
        for m in range(-n, n + 1):
            a = abs(m)
            rr, ri = R[(n, a)]
            if m < 0:
                sgn = (-1) ** a
                rr, ri = sgn * rr, -sgn * ri
            re.append(rr)
            im.append(ri)
    return torch.stack(re + im, dim=-1)


def local_potential_and_grad(L, centers, pos, p: int):
    """phi(pos) = Re sum_nm L_nm R_nm(pos - center) = L_re.R_re - L_im.R_im
    for each row, and its gradient with respect to pos (autograd)."""
    nc = (p + 1) ** 2
    with torch.enable_grad():
        x = pos.detach().requires_grad_(True)
        rv = _rvec_real(x - centers, p)
        phi = (L[:, :nc] * rv[:, :nc]).sum(-1) - (L[:, nc:] * rv[:, nc:]).sum(-1)
        (g,) = torch.autograd.grad(phi.sum(), x)
    return phi.detach(), g


# ---------------------------------------------------------------------------
# uniform octree geometry
# ---------------------------------------------------------------------------


def _parity_offsets(par: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
    """M2L interaction-list offsets for a cell of child parity `par`:
    children of the parent's 27-neighbourhood minus the cell's own
    27-neighbourhood (<= 189 offsets)."""
    out = []
    rngs = [range(-2 - pq, 4 - pq) for pq in par]
    for ox in rngs[0]:
        for oy in rngs[1]:
            for oz in rngs[2]:
                if max(abs(ox), abs(oy), abs(oz)) <= 1:
                    continue
                out.append((ox, oy, oz))
    return out


_PARITIES = [(px, py, pz) for pz in (0, 1) for py in (0, 1) for px in (0, 1)]


@functools.lru_cache(maxsize=8)
def _lattice_operators(box: float, p: int, scales: int):
    """The periodic lattice recursion's operators, realified in f64:
    A~_k (27 shifted M2M copies) and T~_k (the 702 far M2L offsets) per
    scale, and D_0.  Per-scale units (raw entries grow like (3^k box)^n
    and overflow f32 by scale ~8): M~_k = D_k M_k,
    A~_k = D_{k+1} A_k D_k^-1, T~_k = T_k D_k^-1.  Cached: the 702
    operators of each scale take most of a solver's set-up."""
    nc = (p + 1) ** 2
    degs = np.array([n for n in range(p + 1) for _ in range(2 * n + 1)],
                    np.float64)
    lat_m2m, lat_m2l = [], []
    for k in range(scales):
        s = box * 3.0 ** k
        dk_inv = np.power(s, degs)
        dk1 = np.power(3.0 * s, -degs)
        A = np.zeros((nc, nc), complex)
        for o in np.ndindex(3, 3, 3):
            A += _m2m_matrix(-(np.array(o) - 1) * s, p)
        lat_m2m.append(_realify(dk1[:, None] * A * dk_inv[None, :], np.float64))
        T = np.zeros((nc, nc), complex)
        for b in np.ndindex(9, 9, 9):
            bb = np.array(b) - 4
            if np.abs(bb).max() <= 1:
                continue
            T += _m2l_matrix(-bb * s, p)
        lat_m2l.append(_realify(T * dk_inv[None, :], np.float64))
    d0 = np.concatenate([np.power(box, -degs)] * 2)
    return tuple(lat_m2m), tuple(lat_m2l), d0


@dataclasses.dataclass
class FMMSolver:
    """Coulomb solver: energy, potentials and forces of N point charges by
    the solid-harmonics FMM; free-space or fully periodic.

    box: cubic root-cell edge (particles must lie in [0, box)^3)
    depth: octree depth D (leaf grid 2^D per axis, D >= 2)
    order: expansion order p
    cap: max charges per leaf cell
    periodic: periodic boundary conditions (neutral systems only)
    lattice_scales: 3^K boxes of lattice recursion (periodic)
    """

    box: float
    depth: int = 3
    order: int = 8
    cap: int = 32
    dtype: torch.dtype = torch.float32
    periodic: bool = False
    lattice_scales: int = 10
    device: str = "cuda"

    def __post_init__(self):
        if self.depth < 2:
            raise ValueError("FMM octree needs depth >= 2")
        self.device = canonical_device(self.device)
        p = self.order
        self.nc = (p + 1) ** 2
        self.n_leaf = 2 ** self.depth
        self.leaf_edge = self.box / self.n_leaf
        f = np.dtype(np.float64 if self.dtype == torch.float64 else np.float32)
        # M2M (child -> parent) and L2L (parent -> child) per level, from
        # the leaves up; 8 child parities each (pz outer, px inner)
        self._m2m: List[np.ndarray] = []
        self._l2l: List[np.ndarray] = []
        for d in range(self.depth, 0, -1):
            child_edge = self.box / 2 ** d
            up, dn = [], []
            for px, py, pz in _PARITIES:
                off = (np.array([px, py, pz]) - 0.5) * child_edge
                up.append(_realify(_m2m_matrix(-off, p), f))
                dn.append(_realify(_l2l_matrix(off, p), f))
            self._m2m.append(np.stack(up))
            self._l2l.append(np.stack(dn))
        all_offs = sorted({o for par in _PARITIES for o in _parity_offsets(par)})
        self._m2l_offsets = all_offs
        self._par_lists = {par: set(_parity_offsets(par)) for par in _PARITIES}
        # M2L operators per level: source = target + o, so the
        # translation is t = -o * edge
        self._m2l: List[np.ndarray] = []
        self._m2l_min_level = 1 if self.periodic else 2
        for d in range(self._m2l_min_level, self.depth + 1):
            edge = self.box / 2 ** d
            self._m2l.append(np.stack([
                _realify(_m2l_matrix(-np.array(o) * edge, p), f)
                for o in all_offs
            ]))
        if self.periodic:
            A, T, d0 = _lattice_operators(float(self.box), p, self.lattice_scales)
            self._lat_m2m = [a.astype(f) for a in A]
            self._lat_m2l = [t.astype(f) for t in T]
            self._lat_d0 = d0.astype(f)
        self._to_device()

    def _to_device(self):
        def t(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self._t_m2m = [t(a) for a in self._m2m]
        self._t_l2l = [t(a) for a in self._l2l]
        self._t_m2l = [t(a) for a in self._m2l]
        # per child parity: its offsets in chunks of M2L_CHUNK, and each
        # chunk's rows of the level operator stacks (device indices)
        index = {o: i for i, o in enumerate(self._m2l_offsets)}
        self._par_chunks = {}
        for par in _PARITIES:
            offs = sorted(self._par_lists[par])
            self._par_chunks[par] = [
                (offs[c:c + M2L_CHUNK], torch.as_tensor(
                    [index[o] for o in offs[c:c + M2L_CHUNK]], device=self.device))
                for c in range(0, len(offs), M2L_CHUNK)]
        if self.periodic:
            self._t_lat_m2m = [t(a) for a in self._lat_m2m]
            self._t_lat_m2l = [t(a) for a in self._lat_m2l]
            self._t_lat_d0 = t(self._lat_d0)
        nl = self.n_leaf
        ii = torch.arange(nl, device=self.device)
        g = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 3)
        self._centers = (g.to(self.dtype) + 0.5) * self.leaf_edge
        self._nbr = torch.as_tensor(self._neighbor_table(), device=self.device)

    # -- device pipeline ----------------------------------------------------

    def _cell_of(self, r):
        nl = self.n_leaf
        ci = torch.clamp(torch.floor(r / self.leaf_edge).to(torch.int64), 0, nl - 1)
        return (ci[:, 0] * nl + ci[:, 1]) * nl + ci[:, 2]

    def _bin(self, r, valid):
        """Leaf binning into a dense [n_cells, cap] slot table (particle
        ids, -1 empty) and the overflow flag."""
        ncell = self.n_leaf ** 3
        cell = torch.where(valid, self._cell_of(r), ncell)  # invalid: dump bin
        order = torch.argsort(cell, stable=True)
        cs = cell[order]
        slot = torch.arange(cs.shape[0], device=r.device) - torch.searchsorted(
            cs, cs, side="left")
        live = cs < ncell
        overflow = torch.any((slot >= self.cap) & live)
        dest = torch.where((slot < self.cap) & live, cs * self.cap + slot,
                           ncell * self.cap)
        slots = torch.zeros((ncell * self.cap + 1,), dtype=torch.int64,
                            device=r.device)
        slots[dest] = order + 1
        return slots[:-1].reshape(ncell, self.cap) - 1, overflow

    def _compute(self, r, q, valid, gid):
        """(U, F [N,3], phi [N], overflow flag) of the charges."""
        p = self.order
        r = r.to(self.dtype)
        if self.periodic:
            r = torch.remainder(r, self.box)
        q = torch.where(valid, q.to(self.dtype), torch.zeros((), dtype=self.dtype,
                                                             device=r.device))
        slots, overflow = self._bin(r, valid)
        safe = torch.clamp(slots, min=0)
        w = (slots >= 0).to(self.dtype)  # [cells, cap]
        rc_ = r[safe]  # [cells, cap, 3]
        qc = q[safe] * w
        # P2M: M_leaf[c] = sum_slots q * R(r - center)
        Mleaf = torch.einsum(
            "cs,csk->ck", qc, _rvec_real(rc_ - self._centers[:, None, :], p))
        Lleaf = self._tree_pass(Mleaf)
        return self._finish_compute(r, q, Lleaf, slots, rc_, w, gid, overflow)

    def _shifted(self, Mp, n, par, o):
        """Multipoles of the sources (target + o) of the parity-`par`
        targets of a level grid [n, n, n, nc2] (Mp: the grid itself when
        periodic, else zero-padded by 3)."""
        if self.periodic:
            s = tuple(-(a + b) for a, b in zip(par, o))
            return torch.roll(Mp, s, dims=(0, 1, 2))[::2, ::2, ::2]
        a, b, c = (3 + pp + oo for pp, oo in zip(par, o))
        return Mp[a:a + n:2, b:b + n:2, c:c + n:2]

    def _tree_pass(self, Mleaf):
        """M2M / M2L / L2L (+ periodic lattice recursion): leaf
        multipoles [cells, 2nc] -> leaf locals [cells, 2nc]."""
        nc2 = 2 * self.nc
        nl = self.n_leaf
        dt = self.dtype
        dev = Mleaf.device
        # upward pass: leaves -> level 1
        Ms = [Mleaf.reshape(nl, nl, nl, nc2)]
        for li, d in enumerate(range(self.depth, 0, -1)):
            T = self._t_m2m[li]
            child = Ms[-1]
            npar = 2 ** (d - 1)
            parent = torch.zeros((npar, npar, npar, nc2), dtype=dt, device=dev)
            for k, (px, py, pz) in enumerate(_PARITIES):
                parent = parent + child[px::2, py::2, pz::2] @ T[k].T
            Ms.append(parent)
        # Ms[i] is the level (depth - i) grid
        # horizontal pass: each child parity takes its own offsets, in
        # chunks as one batched matmul
        Ls = {}
        for li, d in enumerate(range(self._m2l_min_level, self.depth + 1)):
            M = Ms[self.depth - d]
            n = 2 ** d
            h = n // 2
            T = self._t_m2l[li]
            Mp = M if self.periodic else torch.nn.functional.pad(
                M, (0, 0, 3, 3, 3, 3, 3, 3))
            L = torch.zeros((n, n, n, nc2), dtype=dt, device=dev)
            for par in _PARITIES:
                acc = torch.zeros((h ** 3, nc2), dtype=dt, device=dev)
                for chunk, rows in self._par_chunks[par]:
                    src = torch.stack([self._shifted(Mp, n, par, o) for o in chunk])
                    acc = acc + torch.bmm(src.reshape(len(chunk), h ** 3, nc2),
                                          T[rows].transpose(1, 2)).sum(0)
                L[par[0]::2, par[1]::2, par[2]::2] = acc.reshape(h, h, h, nc2)
            Ls[d] = L
        if self.periodic:
            # lattice far field beyond the 27 box images, in scaled units
            M_k = Ms[-1].reshape(nc2) * self._t_lat_d0
            L_root = torch.zeros((nc2,), dtype=dt, device=dev)
            for k in range(self.lattice_scales):
                L_root = L_root + self._t_lat_m2l[k] @ M_k
                M_k = self._t_lat_m2m[k] @ M_k
            # L2L root -> level-1 children (their matrices sit at
            # _l2l[depth - 1])
            T0 = self._t_l2l[self.depth - 1]
            child = Ls[1].clone()
            for k, (px, py, pz) in enumerate(_PARITIES):
                child[px, py, pz] += T0[k] @ L_root
            Ls[1] = child
        # downward pass: level d -> d+1 (child level d+1 matrices sit at
        # _l2l[depth - (d+1)])
        for d in range(self._m2l_min_level, self.depth):
            T = self._t_l2l[self.depth - (d + 1)]
            parent = Ls[d]
            child = Ls[d + 1]
            for k, (px, py, pz) in enumerate(_PARITIES):
                child[px::2, py::2, pz::2] += parent @ T[k].T
        return Ls[self.depth].reshape(-1, nc2)

    def _finish_compute(self, r, q, Lleaf, slots, rc_, w, gid, overflow):
        p = self.order
        dt = self.dtype
        safe = torch.clamp(slots, min=0)
        # L2P: far-field potential and its exact gradient
        cidx = self._cell_of(r)
        phi, g = local_potential_and_grad(Lleaf[cidx], self._centers[cidx], r, p)
        F_far = -q[:, None] * g
        # near field over the 27-neighbourhood; pairs of one exclusion
        # group (gid) never contribute
        ncell = slots.shape[0]
        nbr = self._nbr
        nb_slots = torch.where(
            nbr[:, :, None] >= 0, slots[torch.clamp(nbr, min=0)], -1
        ).reshape(ncell, -1)  # [cells, 27 cap]
        safe_j = torch.clamp(nb_slots, min=0)
        qj = q[safe_j] * (nb_slots >= 0).to(dt)
        gid = gid.to(torch.int64)
        gid_own = torch.where(slots >= 0, gid[safe], -1)
        gid_nb = torch.where(nb_slots >= 0, gid[safe_j], -2)
        qc = q[safe] * w
        phi_n = torch.zeros((ncell, self.cap), dtype=dt, device=r.device)
        F_n = torch.zeros((ncell, self.cap, 3), dtype=dt, device=r.device)
        one = torch.ones((), dtype=dt, device=r.device)
        zero = torch.zeros((), dtype=dt, device=r.device)
        chunk = max(1, min(ncell, NEAR_PAIRS // max(self.cap * self.cap * 27, 1)))
        for c0 in range(0, ncell, chunk):
            sl = slice(c0, c0 + chunk)
            d = rc_[sl, :, None, :] - r[safe_j[sl]][:, None, :, :]
            if self.periodic:
                d = d - self.box * torch.round(d / self.box)
            r2 = (d * d).sum(-1)
            ok = ((w[sl, :, None] > 0) & (qj[sl, None, :] != 0.0)
                  & (gid_own[sl, :, None] != gid_nb[sl, None, :]) & (r2 > 0))
            r2s = torch.where(ok, r2, one)
            inv = torch.where(ok, 1.0 / torch.sqrt(r2s), zero)
            phi_c = qj[sl, None, :] * inv  # [chunk, cap, 27 cap]
            f = (qc[sl, :, None] * phi_c / r2s)[..., None] * d
            phi_n[sl] = phi_c.sum(2)
            F_n[sl] = f.sum(2)
        flat = safe.reshape(-1)
        wflat = (slots.reshape(-1) >= 0).to(dt)
        phi_tot = phi.index_add(0, flat, phi_n.reshape(-1) * wflat)
        F = F_far.index_add(0, flat, F_n.reshape(-1, 3) * wflat[:, None])
        U = 0.5 * torch.sum(q * phi_tot)
        return U, F, phi_tot, overflow

    def _neighbor_table(self) -> np.ndarray:
        """[cells, 27] neighbour cell ids (-1 beyond a free-space edge)."""
        nl = self.n_leaf
        ii = np.arange(nl)
        cx, cy, cz = np.meshgrid(ii, ii, ii, indexing="ij")
        base = np.stack([cx, cy, cz], -1).reshape(-1, 3)
        offs = np.array([(ox, oy, oz) for ox in (-1, 0, 1)
                         for oy in (-1, 0, 1) for oz in (-1, 0, 1)])
        nb = base[:, None, :] + offs[None, :, :]
        if self.periodic:
            nb = nb % nl
            ok = np.ones(nb.shape[:-1], bool)
        else:
            ok = ((nb >= 0) & (nb < nl)).all(-1)
        ids = (nb[..., 0] * nl + nb[..., 1]) * nl + nb[..., 2]
        return np.where(ok, ids, -1).astype(np.int64)

    # -- public -------------------------------------------------------------

    def compute(self, r, q, valid=None, gid=None):
        """Energy U = 1/2 sum q_i phi_i, forces [N,3], potentials [N].
        gid: optional group ids (pairs within a group are excluded);
        defaults to one group per particle.  Raises on leaf-capacity
        overflow.  Host arrays go to the solver's device; a tensor on
        another device raises."""
        dev = self.device
        r = on_device(r, dev, "r", dtype=self.dtype)
        q = on_device(q, dev, "q", dtype=self.dtype)
        n = r.shape[0]
        valid = (torch.ones((n,), dtype=torch.bool, device=dev)
                 if valid is None else on_device(valid, dev, "valid"))
        gid = (torch.arange(n, device=dev) if gid is None
               else on_device(gid, dev, "gid"))
        U, F, phi, overflow = self._compute(r, q, valid, gid)
        if bool(overflow):
            raise RuntimeError(
                "FMM leaf cell capacity exceeded; raise cap or depth"
            )
        return U, F, phi


class FMMElectrostatics:
    """Molecule-level FMM electrostatics for the driver (the role bhfmm
    plays under `<electrostatic type="FastMultipoleMethod">`: the FMM
    owns ALL Coulomb work while the pair path runs LJ only,
    Simulation.cpp:781-797).

    The extra-force contract (mol, pp) -> (u, F, M): all charge sites go
    into the periodic FMM with the molecule index as the exclusion
    group, forces map back per molecule, torques from the world-frame
    site offsets.  Point charges only."""

    def __init__(self, box, table, pp, n_hint: int, dtype=torch.float32,
                 order: int = 8, depth: int = 0, cap: int = 0, device="cuda"):
        b = np.asarray(box, float)
        if not np.allclose(b, b[0], rtol=1e-6):
            raise ValueError("FMM electrostatics needs a cubic box")
        for c in table.components:
            if c.dipoles or c.quadrupoles:
                raise ValueError(
                    "FMM electrostatics handles point charges only "
                    "(the reference bhfmm constraint); use Ewald/SPME "
                    "for dipoles/quadrupoles"
                )
        self.NC = int(pp.charge_q.shape[1])
        if depth == 0:
            # aim for ~16 occupied sites per leaf (leaf count 8^D)
            n_sites = max(n_hint, 1) * self.NC
            depth = min(6, max(2, int(round(np.log(n_sites / 16) / np.log(8)))))
        self.depth = depth
        # intramolecular exclusion: all sites of one molecule must stay
        # within the 27-cell near field
        cq = pp.charge_pos.detach().cpu().numpy()
        r_max = float(np.max(np.linalg.norm(cq, axis=-1))) if cq.size else 0.0
        leaf_edge = float(b[0]) / 2 ** depth
        if leaf_edge < 2.0 * r_max:
            raise ValueError(
                f"FMM leaf edge {leaf_edge:.3g} < 2*max site radius "
                f"{r_max:.3g}: intramolecular exclusion would leak"
            )
        if cap == 0:
            mean_occ = max(n_hint, 1) * self.NC / 8 ** depth
            cap = int(max(32, 4 * mean_occ))
        self.solver = FMMSolver(
            box=float(b[0]), depth=depth, order=order, cap=cap, dtype=dtype,
            periodic=True, device=device,
        )

    def _call(self, mol, pp):
        from ls1_mardyn_tpu_torch.ops.ewald import charge_sites

        on_device(mol.r, self.solver.device, "mol")
        n = mol.capacity
        offs, rs, wq = charge_sites(mol, pp)
        qs = wq.reshape(-1)
        mids = torch.arange(n, device=rs.device).repeat_interleave(offs.shape[1])
        # zero-charge padding never occupies slots
        U, F_s, _phi, overflow = self.solver._compute(
            rs.reshape(-1, 3), qs, qs != 0.0, mids)
        f = F_s.reshape(n, -1, 3)
        F = f.sum(1)
        M = torch.linalg.cross(offs, f, dim=-1).sum(1)
        return U, F, M, overflow

    def __call__(self, mol, pp):
        u, F, M, overflow = self._call(mol, pp)
        # a leaf beyond its capacity would drop charge: the energy turns
        # NaN and the driver's watchdog aborts the run
        nan = torch.full((), float("nan"), dtype=u.dtype, device=u.device)
        return torch.where(overflow, nan, u), F, M

    def validate(self, mol, pp):
        """Host-side overflow check, once at prepare time (cap is 4x the
        mean leaf occupancy, so a later overflow means a drastic density
        change)."""
        _u, _F, _M, overflow = self._call(mol, pp)
        if bool(overflow):
            raise RuntimeError("FMM leaf cap exceeded; raise cap or depth")


def direct_coulomb(r, q):
    """O(N^2) reference (numpy, f64): potentials, forces, energy."""
    r = np.asarray(r, np.float64)
    q = np.asarray(q, np.float64)
    d = r[:, None, :] - r[None, :, :]
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, 1.0)
    inv = 1.0 / np.sqrt(r2)
    np.fill_diagonal(inv, 0.0)
    phi = (q[None, :] * inv).sum(1)
    f = (q[:, None] * q[None, :] * inv / np.where(r2 > 0, r2, 1))[..., None] * d
    F = f.sum(1)
    U = 0.5 * float((q * phi).sum())
    return phi, F, U
