"""A rigid molecular model and its forces, torques, energy and virial,
in plain PyTorch.

The model is a configuration's sites (configs/<name>.json): Lennard-
Jones 12-6 centres, truncated at the cutoff of the centres of mass and
shifted to zero at the cutoff where the configuration says so, and
linear point quadrupoles (Gray and Gubbins, Theory of Molecular Fluids,
eq. 2.184; the form ls1-MarDyn uses).  A molecule pair interacts when
its centres of mass lie closer than rc.  The energy of a block of pairs
is written down directly; forces and torques are its gradients
(autograd), taken with respect to the centre-of-mass separation, the
world-frame site offsets and the world-frame quadrupole axes:

  F_i   = -dU/d(r_i - r_j)
  tau_i = sum_sites d_ia x (-dU/dd_ia) + sum_quads e_iq x (-dU/de_iq)

and the virial is the sum over pairs of (r_i - r_j) . F_ij, with the
homogeneous tail correction of an untruncated-unshifted centre-centre
LJ fluid added to energy and virial (ls1-MarDyn's Homogeneous long-
range correction; none where the LJ centres are shifted).
Quaternions are (w, x, y, z); R(q) maps the body frame to the world.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.pairs import pair_blocks


TAIL_NODES = 96


def gauss_legendre(k):
    """Nodes x in (0, 1) and weights of k-point Gauss-Legendre (float64)."""
    i = torch.arange(1, k, dtype=torch.float64)
    beta = i / torch.sqrt(4 * i * i - 1)
    jacobi = torch.diag(beta, 1) + torch.diag(beta, -1)
    nodes, vecs = torch.linalg.eigh(jacobi)
    weights = 2 * vecs[0] ** 2
    return 0.5 * (nodes + 1), 0.5 * weights


def tail_pair_mean(r, t1, t2, m):
    """Mean of |r e + t1 n1 - t2 n2|^-m over independent uniform unit
    vectors n1, n2, for centre distances r > t1 + t2 (by the shell
    theorem: the mean of f(|R - t n|) over n is the integral of s f(s)
    over |R - t| < s < R + t, divided by 2 R t)."""
    if t1 == 0.0 and t2 == 0.0:
        return r ** -m
    if t1 == 0.0 or t2 == 0.0:
        t = t1 + t2
        k = 2 - m
        return ((r + t) ** k - (r - t) ** k) / (2 * r * t * k)
    k = 3 - m
    f3 = lambda s: s ** k / ((2 - m) * k)  # noqa: E731
    return (f3(r + t1 + t2) - f3(r + t1 - t2) - f3(r - t1 + t2)
            + f3(r - t1 - t2)) / (4 * r * t1 * t2)


def rotate(q, d):
    """R(q) d: body -> world, for q [..., 4] and d [..., 3]."""
    w, x, y, z = q.unbind(-1)
    a, b, c = d.unbind(-1)
    return torch.stack([
        (w * w + x * x - y * y - z * z) * a + 2 * (x * y - w * z) * b
        + 2 * (w * y + x * z) * c,
        2 * (w * z + x * y) * a + (w * w - x * x + y * y - z * z) * b
        + 2 * (y * z - w * x) * c,
        2 * (x * z - w * y) * a + 2 * (w * x + y * z) * b
        + (w * w - x * x - y * y + z * z) * c], -1)


def rotate_inv(q, d):
    """R(q)^T d: world -> body."""
    conj = torch.cat([q[..., :1], -q[..., 1:]], -1)
    return rotate(conj, d)


class Model:
    """The configuration's molecule on `device`, in `dtype`."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.dtype, self.device = dtype, device
        t = dict(dtype=dtype, device=device)
        lj = cfg["sites"]["lj"]
        quads = cfg["sites"].get("quadrupoles", [])
        self.rc = float(cfg["cutoff"])
        self.lj_r = torch.tensor([s["r"] for s in lj], **t)
        eps = torch.tensor([s["epsilon"] for s in lj], dtype=torch.float64)
        sig = torch.tensor([s["sigma"] for s in lj], dtype=torch.float64)
        # Lorentz-Berthelot mixing between the centres of one molecule kind
        self.eps = torch.sqrt(eps[:, None] * eps[None, :])
        self.sig = 0.5 * (sig[:, None] + sig[None, :])
        shifted = [bool(s["shifted"]) for s in lj]
        if len(set(shifted)) > 1:
            raise ValueError("all LJ centres shifted or none")
        self.shifted = shifted[0]
        sr6 = (self.sig / self.rc) ** 6
        self.shift = 4 * self.eps * (sr6 - sr6 * sr6) if self.shifted \
            else torch.zeros_like(self.eps)
        self.quad_r = torch.tensor([s["r"] for s in quads], **t).reshape(-1, 3)
        e = torch.tensor([s["e"] for s in quads], dtype=torch.float64).reshape(-1, 3)
        self.quad_e = (e / e.norm(dim=-1, keepdim=True)).to(**t)
        self.quad_Q = torch.tensor([s["Q"] for s in quads], dtype=torch.float64)
        m = torch.tensor([s["mass"] for s in lj], dtype=torch.float64)
        self.mass = float(m.sum())
        rb = torch.tensor([s["r"] for s in lj], dtype=torch.float64)
        # principal moments: the body frame is the principal frame
        inertia = (m[:, None] * ((rb * rb).sum(-1, keepdim=True) - rb * rb)).sum(0)
        self.inertia = inertia.to(**t)
        self.inv_inertia = torch.where(inertia > 0, 1.0 / inertia.clamp(min=1e-300),
                                       0.0).to(**t)
        self.rot_dof = int((inertia > 0).sum())

    def tail(self, n, volume):
        """(U, virial) tail corrections of n molecules in `volume`: the
        LJ energy and virial of the pairs whose centres of mass lie
        beyond rc, for a uniform fluid of freely oriented molecules
        (ls1-MarDyn's Homogeneous long-range correction); none where
        the LJ centres are shifted, and none for the quadrupoles (their
        orientational mean vanishes).

          U = n rho / 2  int_rc^inf 4 pi r^2 u(r) dr
          W = n rho / 2  int_rc^inf 4 pi r^2 (-r u'(r)) dr

        with u(r) the orientational mean of the site-site LJ sum at a
        centre distance r (tail_pair_mean), integrated by Gauss-Legendre
        in x = rc / r."""
        if self.shifted:
            return 0.0, 0.0
        x, wx = gauss_legendre(TAIL_NODES)
        rc = self.rc
        r = (rc / x).requires_grad_(True)
        tau = self.lj_r.double().norm(dim=-1).cpu()
        u = torch.zeros_like(r)
        for a in range(len(tau)):
            for b in range(len(tau)):
                s2 = float(self.sig[a, b]) ** 2
                u = u + 4 * float(self.eps[a, b]) * (
                    s2 ** 6 * tail_pair_mean(r, float(tau[a]), float(tau[b]), 12)
                    - s2 ** 3 * tail_pair_mean(r, float(tau[a]), float(tau[b]), 6))
        du = torch.autograd.grad(u.sum(), r)[0]
        r, u = r.detach(), u.detach()
        jac = wx * rc / (x * x)  # dr = rc / x^2 dx
        rho = n / volume
        pre = 0.5 * n * rho * 4 * math.pi
        return (float(pre * (jac * r * r * u).sum()),
                float(pre * (jac * r * r * (-r * du)).sum()))

    def pair_energy(self, drm, dl_i, dl_j, dq_i, dq_j, e_i, e_j):
        """Energy of each pair [P] from the COM separation drm [P,3], the
        world-frame LJ offsets [P,S,3], quadrupole offsets and axes
        [P,Q,3] of both molecules."""
        u = torch.zeros(drm.shape[0], dtype=drm.dtype, device=drm.device)
        S = dl_i.shape[1]
        for a in range(S):
            for b in range(S):
                d = drm + dl_i[:, a] - dl_j[:, b]
                r2 = (d * d).sum(-1)
                s6 = (float(self.sig[a, b]) ** 2 / r2) ** 3
                u = u + 4 * float(self.eps[a, b]) * (s6 * s6 - s6) \
                    + float(self.shift[a, b])
        Q = dq_i.shape[1]
        for a in range(Q):
            for b in range(Q):
                d = drm + dq_i[:, a] - dq_j[:, b]
                r2 = (d * d).sum(-1)
                inv = torch.rsqrt(r2)
                ci = (e_i[:, a] * d).sum(-1) * inv
                cj = (e_j[:, b] * d).sum(-1) * inv
                cij = (e_i[:, a] * e_j[:, b]).sum(-1)
                qfac = 0.75 * float(self.quad_Q[a] * self.quad_Q[b]) * inv / (r2 * r2)
                term = cij - 5 * ci * cj
                u = u + qfac * (1 - 5 * (ci * ci + cj * cj) - 15 * ci * ci * cj * cj
                                + 2 * term * term)
        return u

    def world_sites(self, q):
        """World-frame LJ offsets [N,S,3], quadrupole offsets and axes
        [N,Q,3] of molecules with orientations q [N,4]."""
        qb = q[:, None, :]
        return (rotate(qb, self.lj_r[None]), rotate(qb, self.quad_r[None]),
                rotate(qb, self.quad_e[None]))

    def forces(self, r, q, box, block_pairs=1 << 21, pairs=None):
        """dict(F [N,3], M [N,3], U, W, pairs): forces, torques, the pair
        energy and virial (no tail) and the number of pairs inside rc, of
        molecules at r [N,3] with orientations q [N,4] in `box` [3].  The
        pairs and their separations come from r in float64; everything
        after, from the separations and q on, is in the model's dtype."""
        dt = self.dtype
        r, q, box = r.double(), q.to(dt), box.double()
        n = len(r)
        dl, dq, de = self.world_sites(q)
        F = torch.zeros((n, 3), dtype=dt, device=r.device)
        M = torch.zeros_like(F)
        acc = torch.zeros(2, dtype=torch.float64, device=r.device)
        count = 0
        buf, held = [], 0
        blocks = pairs if pairs is not None else pair_blocks(r, box, self.rc)

        def flush():
            i = torch.cat([b[0] for b in buf])
            j = torch.cat([b[1] for b in buf])
            drm = torch.cat([b[2] for b in buf]).to(dt)
            self._add_block(i, j, drm, dl, dq, de, F, M, acc)
            buf.clear()

        for blk in blocks:
            buf.append(blk)
            held += len(blk[0])
            count += len(blk[0])
            if held >= block_pairs:
                flush()
                held = 0
        if buf:
            flush()
        return dict(F=F, M=M, U=float(acc[0]), W=float(acc[1]), pairs=count)

    def _add_block(self, i, j, drm, dl, dq, de, F, M, acc):
        leaves = [drm, dl[i], dl[j], dq[i], dq[j], de[i], de[j]]
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        u = self.pair_energy(*leaves)
        g = torch.autograd.grad(u.sum(), leaves, allow_unused=True)
        g = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(leaves, g)]
        d_drm, d_dli, d_dlj, d_dqi, d_dqj, d_ei, d_ej = g
        _, dli, dlj, dqi, dqj, ei, ej = leaves
        fi = -d_drm
        ti = (torch.linalg.cross(dli, -d_dli, dim=-1).sum(1)
              + torch.linalg.cross(dqi, -d_dqi, dim=-1).sum(1)
              + torch.linalg.cross(ei, -d_ei, dim=-1).sum(1))
        tj = (torch.linalg.cross(dlj, -d_dlj, dim=-1).sum(1)
              + torch.linalg.cross(dqj, -d_dqj, dim=-1).sum(1)
              + torch.linalg.cross(ej, -d_ej, dim=-1).sum(1))
        F.index_add_(0, i, fi.detach())
        F.index_add_(0, j, -fi.detach())
        M.index_add_(0, i, ti.detach())
        M.index_add_(0, j, tj.detach())
        acc[0] += u.detach().double().sum()
        acc[1] += (drm * fi).detach().double().sum()
