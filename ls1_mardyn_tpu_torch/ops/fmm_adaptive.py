"""Adaptive FMM: threshold-split octree + dual-tree traversal (the
counterpart of ls1_mardyn_tpu/ops/fmm_adaptive.py; the reference's
AdaptivePseudoParticleContainer / DttNode,
ls1-MarDyn src/bhfmm/containers/).

  * the octree (threshold splits, empty children pruned, mixed-depth
    leaves) and the dual tree traversal run on the host (numpy) and
    emit flat padded interaction lists: M2L pairs (node, node, weight)
    and P2P pairs (leaf, leaf, weight);
  * per-depth M2M/L2L operators are the 8 child-parity matrices of the
    uniform solver (ops/fmm.py), applied to every node of a depth as one
    batched matmul;
  * M2L pairs connect nodes at arbitrary depths and displacements, so
    per-pair operators are formed on the device from the irregular solid
    harmonics of the displacement (a gather from a (2p+1)^2 S-vector)
    and applied in chunks of batched matmuls;
  * acceptance is the multipole acceptance criterion
    (r_A + r_B) <= theta * |t|; theta = sqrt(3)/2 is the worst-case
    separation of the uniform solver's interaction lists.

Free-space boundaries only; periodic scenes take the uniform periodic
FMM, Ewald or SPME (the driver warns and ignores the adaptive container
there).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ops.fmm import (
    _idx,
    _l2l_matrix,
    _m2m_matrix,
    _realify,
    _rvec_real,
    local_potential_and_grad,
)
from ls1_mardyn_tpu_torch.state import canonical_device, on_device

__all__ = ["AdaptiveFMMSolver", "TreePlan"]

# the plan pads its M2L and P2P lists to multiples of these (the JAX
# package's list shapes, so that plans compare list for list)
M2L_BUCKET = 512
P2P_BUCKET = 1024
# bytes the temporaries of one M2L or P2P pass may hold: a pass is a
# fixed run of ~10^3 small launches (the S recursion), so the chunk is
# as large as this allows (chunks of 512 left an H100 launch-bound)
PASS_BYTES = 2 ** 31


def _svec_real(dr: torch.Tensor, p: int):
    """Realified irregular solid harmonics (re, im), each [..., (p+1)^2],
    of displacements dr [..., 3] (valid for |dr| > 0, which the MAC
    guarantees for every accepted pair)."""
    x, y, z = dr[..., 0], dr[..., 1], dr[..., 2]
    r2 = x * x + y * y + z * z
    rinv = 1.0 / torch.sqrt(r2)
    S = {(0, 0): (rinv, torch.zeros_like(x))}
    for n in range(1, p + 1):
        pr, pi = S[(n - 1, n - 1)]
        c = (2 * n - 1) / r2
        # * (2n-1) (x + iy) / r^2
        S[(n, n)] = (c * (pr * x - pi * y), c * (pr * y + pi * x))
    for m in range(0, p + 1):
        for n in range(m + 1, p + 1):
            pr, pi = S[(n - 1, m)]
            qr, qi = S.get((n - 2, m), (0.0, 0.0))
            a = (n - 1) ** 2 - m * m
            S[(n, m)] = (
                ((2 * n - 1) * z * pr - a * qr) / r2,
                ((2 * n - 1) * z * pi - a * qi) / r2,
            )
    re: List = []
    im: List = []
    for n in range(p + 1):
        for m in range(-n, n + 1):
            a = abs(m)
            sr, si = S[(n, a)]
            if m < 0:
                sgn = (-1) ** a
                sr, si = sgn * sr, -sgn * si
            re.append(sr)
            im.append(si)
    return torch.stack(re, dim=-1), torch.stack(im, dim=-1)


class TreePlan(NamedTuple):
    """Flat padded tree structure (device tensors)."""

    centers: torch.Tensor  # [Nn, 3] node centers
    depth: torch.Tensor  # [Nn] (root = 0)
    parity: torch.Tensor  # [Nn] child octant 0..7 (root: 0)
    parent: torch.Tensor  # [Nn] (root: 0)
    node_w: torch.Tensor  # [Nn] 1.0 for real nodes, 0.0 padding
    leaf_node: torch.Tensor  # [Nl] node id per leaf row (pad: 0)
    slots: torch.Tensor  # [Nl, cap] particle ids (pad: -1)
    leaf_of: torch.Tensor  # [N] leaf ROW id per particle (pad: 0)
    m2l_tgt: torch.Tensor  # [Pm] target node ids
    m2l_src: torch.Tensor  # [Pm] source node ids
    m2l_w: torch.Tensor  # [Pm] pair weight (pad: 0.0)
    p2p_tgt: torch.Tensor  # [Pp] target leaf ROW ids
    p2p_src: torch.Tensor  # [Pp] source leaf ROW ids
    p2p_w: torch.Tensor  # [Pp] pair weight (pad: 0.0)


def _bucket(n: int, granularity: int = 64) -> int:
    """Round a count up to a multiple of `granularity` (at least one)."""
    return max(granularity, -(-n // granularity) * granularity)


@dataclasses.dataclass
class AdaptiveFMMSolver:
    """Free-space Coulomb solver on a threshold-split adaptive octree.

    box: cubic root-cell edge; particles must lie in [0, box)^3
    order: expansion order p
    threshold: max particles per leaf before a node splits
    max_depth: hard subdivision floor (leaves may exceed `threshold`
        only there; the slot table capacity grows to fit)
    theta: multipole acceptance criterion (r_A+r_B <= theta*|t|)
    device: where the plan and the work live (the card unless the
        caller asks for the CPU; raises without a card)
    """

    box: float
    order: int = 8
    threshold: int = 32
    max_depth: int = 10
    theta: float = 0.866
    dtype: torch.dtype = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError("adaptive FMM threshold must be >= 1")
        self.device = canonical_device(self.device)
        p = self.order
        self.nc = (p + 1) ** 2
        f = np.dtype(np.float64 if self.dtype == torch.float64 else np.float32)
        # per-depth x per-parity M2M / L2L operators (depth d child edge
        # = box / 2^d; the uniform solver's matrices)
        up: List[np.ndarray] = [np.zeros((8, 2 * self.nc, 2 * self.nc), f)]
        dn: List[np.ndarray] = [np.zeros((8, 2 * self.nc, 2 * self.nc), f)]
        for d in range(1, self.max_depth + 1):
            child_edge = self.box / 2 ** d
            mu, md = [], []
            for par in range(8):
                bits = np.array([par & 1, (par >> 1) & 1, (par >> 2) & 1])
                off = (bits - 0.5) * child_edge
                mu.append(_realify(_m2m_matrix(-off, p), f))
                md.append(_realify(_l2l_matrix(off, p), f))
            up.append(np.stack(mu))
            dn.append(np.stack(md))
        self._t_up = np.stack(up)  # [max_depth+1, 8, 2nc, 2nc]
        self._t_dn = np.stack(dn)
        # M2L index map: A[(j,k),(n,m)] = (-1)^j conj(S_{n+j}^{m+k}(t))
        idxm = np.zeros((self.nc, self.nc), np.int64)
        sgn = np.zeros((self.nc, self.nc), f)
        for j in range(p + 1):
            for k in range(-j, j + 1):
                for n in range(p + 1):
                    for m in range(-n, n + 1):
                        idxm[_idx(j, k), _idx(n, m)] = _idx(n + j, m + k)
                        sgn[_idx(j, k), _idx(n, m)] = (-1.0) ** j
        self._m2l_idx = idxm
        self._m2l_sgn = sgn

        def t(a):
            return torch.as_tensor(a, device=self.device)

        self._d_up = t(self._t_up).to(self.dtype)
        self._d_dn = t(self._t_dn).to(self.dtype)
        self._d_idx = t(idxm)
        self._d_sgn = t(sgn).to(self.dtype)

    # -- host: tree build + dual tree traversal -----------------------------

    def build_plan(self, r: np.ndarray, valid=None, gid=None) -> TreePlan:
        """Threshold-split octree + dual tree traversal -> TreePlan, on
        the host (numpy); the arrays are bucket-padded.

        gid: optional [N] intramolecular-exclusion groups.  M2L sums every
        particle of both nodes, so a pair is accepted only when the least
        possible inter-node distance |t| - (r_A + r_B) exceeds the largest
        intramolecular extent; other pairs subdivide down to P2P, where
        the gid mask is exact."""
        r = np.asarray(r, np.float64)
        n = r.shape[0]
        if valid is None:
            valid = np.ones((n,), bool)
        valid = np.asarray(valid, bool)
        live = np.nonzero(valid)[0]

        # largest intramolecular extent: 2 * max distance from the group
        # centroid
        d_gid = 0.0
        if gid is not None and live.size:
            g = np.asarray(gid)[live]
            order = np.argsort(g, kind="stable")
            gs, rs = g[order], r[live][order]
            starts = np.r_[0, 1 + np.nonzero(np.diff(gs))[0], gs.size]
            cent = np.add.reduceat(rs, starts[:-1], axis=0) / np.diff(starts)[:, None]
            spread = np.linalg.norm(
                rs - np.repeat(cent, np.diff(starts), axis=0), axis=1
            )
            d_gid = 2.0 * float(spread.max()) if spread.size else 0.0

        centers: List[np.ndarray] = []
        depths: List[int] = []
        parities: List[int] = []
        parents: List[int] = []
        leaf_rows: List[Tuple[int, np.ndarray]] = []  # (node id, particles)

        half = 0.5 * self.box
        stack = [(np.array([half, half, half]), 0, 0, 0, live)]
        while stack:
            c, d, parent, par, idx = stack.pop()
            nid = len(centers)
            centers.append(c)
            depths.append(d)
            parities.append(par)
            parents.append(parent)
            if idx.size <= self.threshold or d >= self.max_depth:
                leaf_rows.append((nid, idx))
                continue
            q = self.box / 2 ** (d + 2)  # child center offset
            code = (
                (r[idx, 0] >= c[0]).astype(np.int32)
                + 2 * (r[idx, 1] >= c[1]).astype(np.int32)
                + 4 * (r[idx, 2] >= c[2]).astype(np.int32)
            )
            for p8 in range(8):
                sub = idx[code == p8]
                if sub.size == 0:
                    continue  # empty children pruned
                bits = np.array([p8 & 1, (p8 >> 1) & 1, (p8 >> 2) & 1])
                stack.append((c + (2 * bits - 1) * q, d + 1, nid, p8, sub))

        nn = len(centers)
        centers_a = np.stack(centers)
        depth_a = np.asarray(depths, np.int32)
        edge_a = self.box / 2.0 ** depth_a
        rad_a = (np.sqrt(3.0) / 2.0) * edge_a
        is_leaf = np.zeros((nn,), bool)
        for nid, _ in leaf_rows:
            is_leaf[nid] = True

        # dual tree traversal: ordered pairs, an exact cover of all
        # source -> target interactions
        m2l: List[Tuple[int, int]] = []
        p2p: List[Tuple[int, int]] = []
        children: List[List[int]] = [[] for _ in range(nn)]
        for nid in range(1, nn):
            children[parents[nid]].append(nid)
        pair_stack: List[Tuple[int, int]] = [(0, 0)]
        while pair_stack:
            a, b = pair_stack.pop()
            if a != b:
                t = centers_a[a] - centers_a[b]
                dist = float(np.sqrt(np.dot(t, t)))
                rr = rad_a[a] + rad_a[b]
                # MAC + gid guard
                if rr <= self.theta * dist and dist - rr > d_gid:
                    m2l.append((a, b))
                    continue
            if is_leaf[a] and is_leaf[b]:
                p2p.append((a, b))
            elif is_leaf[b] or (not is_leaf[a] and edge_a[a] >= edge_a[b]):
                for ch in children[a]:
                    pair_stack.append((ch, b))
            else:
                for ch in children[b]:
                    pair_stack.append((a, ch))

        # leaf slot table; capacity from the actual max (threshold unless
        # max_depth clipped a dense cluster)
        cap = _bucket(
            max(1, max((idx.size for _, idx in leaf_rows), default=1)),
            granularity=8,
        )
        nl = _bucket(len(leaf_rows), 8)
        slots = np.full((nl, cap), -1, np.int64)
        leaf_node = np.zeros((nl,), np.int32)
        leaf_row_of_node = np.zeros((nn,), np.int32)
        leaf_of = np.zeros((n,), np.int32)
        for row, (nid, idx) in enumerate(leaf_rows):
            slots[row, : idx.size] = idx
            leaf_node[row] = nid
            leaf_row_of_node[nid] = row
            leaf_of[idx] = row

        def pad_pairs(pairs, np_, to_rows):
            tg = np.zeros((np_,), np.int32)
            sc = np.zeros((np_,), np.int32)
            w = np.zeros((np_,), np.float32)
            if pairs:
                pa = np.asarray(pairs, np.int32)
                if to_rows:
                    pa = leaf_row_of_node[pa]
                tg[: len(pa)], sc[: len(pa)], w[: len(pa)] = pa[:, 0], pa[:, 1], 1.0
            return tg, sc, w

        m2l_t, m2l_s, m2l_w = pad_pairs(
            m2l, _bucket(max(1, len(m2l)), M2L_BUCKET), False
        )
        p2p_t, p2p_s, p2p_w = pad_pairs(
            p2p, _bucket(max(1, len(p2p)), P2P_BUCKET), True
        )
        nn_pad = _bucket(nn, 64)

        def padn(a, fill=0):
            out = np.full((nn_pad,) + a.shape[1:], fill, a.dtype)
            out[:nn] = a
            return out

        f = np.float64 if self.dtype == torch.float64 else np.float32

        def t(a):
            return torch.as_tensor(a, device=self.device)

        return TreePlan(
            centers=t(padn(centers_a.astype(f))),
            depth=t(padn(depth_a)),
            parity=t(padn(np.asarray(parities, np.int32))),
            parent=t(padn(np.asarray(parents, np.int32))),
            node_w=t(padn(np.ones((nn,), f))),
            leaf_node=t(leaf_node),
            slots=t(slots),
            leaf_of=t(leaf_of),
            m2l_tgt=t(m2l_t),
            m2l_src=t(m2l_s),
            m2l_w=t(m2l_w.astype(f)),
            p2p_tgt=t(p2p_t),
            p2p_src=t(p2p_s),
            p2p_w=t(p2p_w.astype(f)),
        )

    # -- device: batched evaluation ------------------------------------------

    def _compute(self, plan: TreePlan, r, q, valid, gid):
        p = self.order
        nc = self.nc
        nc2 = 2 * nc
        dt = self.dtype
        dev = r.device
        r = r.to(dt)
        zero = torch.zeros((), dtype=dt, device=dev)
        q = torch.where(valid, q.to(dt), zero)
        nn = plan.centers.shape[0]
        leaf_node = plan.leaf_node.long()
        parent = plan.parent.long()

        # P2M at the leaves (mixed depths; each row has its own center)
        safe = torch.clamp(plan.slots, min=0)
        w = (plan.slots >= 0).to(dt)  # [Nl, cap]
        lc = plan.centers[leaf_node]  # [Nl, 3]
        Mleaf = torch.einsum("cs,csk->ck", q[safe] * w,
                             _rvec_real(r[safe] - lc[:, None, :], p))
        M = torch.zeros((nn, nc2), dtype=dt, device=dev).index_add(
            0, leaf_node, Mleaf * plan.node_w[leaf_node][:, None])

        # upward M2M, deepest depth first: 8 parity-masked matmuls per depth
        par_sel = [(plan.parity == par).to(dt)[:, None] for par in range(8)]
        for d in range(self.max_depth, 0, -1):
            mask = ((plan.depth == d) & (plan.node_w > 0)).to(dt)
            Md = M * mask[:, None]
            contrib = torch.zeros_like(M)
            for par in range(8):
                contrib = contrib + (Md * par_sel[par]) @ self._d_up[d, par].T
            M = M.index_add(0, parent, contrib)

        # M2L over the traversal pairs: per-pair operators from the
        # irregular harmonics of the displacement, in chunks (a pair
        # holds ~4 [nc, nc] operators: Ar, Ai and their gathers)
        item = torch.finfo(dt).bits // 8
        B = max(1, PASS_BYTES // (4 * nc * nc * item))
        L = torch.zeros((nn, nc2), dtype=dt, device=dev)
        for c0 in range(0, plan.m2l_tgt.shape[0], B):
            tg = plan.m2l_tgt[c0:c0 + B].long()
            sc = plan.m2l_src[c0:c0 + B].long()
            pw = plan.m2l_w[c0:c0 + B]
            t = plan.centers[tg] - plan.centers[sc]  # [B, 3]
            # pad pairs have t = 0; keep the S recursion finite there
            t = t + (pw == 0)[:, None].to(dt) * self.box
            Sre, Sim = _svec_real(t, 2 * p)  # [B, (2p+1)^2] each
            Ar = self._d_sgn[None] * Sre[:, self._d_idx]  # [B, nc, nc]
            Ai = -self._d_sgn[None] * Sim[:, self._d_idx]
            Ms = M[sc] * pw[:, None]
            Mr, Mi = Ms[:, :nc, None], Ms[:, nc:, None]
            Lr = (torch.bmm(Ar, Mr) - torch.bmm(Ai, Mi))[..., 0]
            Li = (torch.bmm(Ar, Mi) + torch.bmm(Ai, Mr))[..., 0]
            L = L.index_add(0, tg, torch.cat([Lr, Li], dim=1))

        # downward L2L, shallow depth first
        for d in range(1, self.max_depth + 1):
            mask = ((plan.depth == d) & (plan.node_w > 0)).to(dt)
            Lp = L[parent] * mask[:, None]
            add = torch.zeros_like(L)
            for par in range(8):
                add = add + (Lp * par_sel[par]) @ self._d_dn[d, par].T
            L = L + add

        # L2P: potential and exact-gradient forces at the particles
        node = leaf_node[plan.leaf_of.long()]
        vmask = valid.to(dt)
        phi, g = local_potential_and_grad(L[node], plan.centers[node], r, p)
        phi = phi * vmask
        F_far = -q[:, None] * g

        # near-field P2P over the traversal's leaf pairs
        one = torch.ones((), dtype=dt, device=dev)
        gid = gid.long()
        phi_n = torch.zeros_like(phi)
        F_n = torch.zeros_like(F_far)
        # a leaf pair holds ~16 [cap, cap] planes (d, f, r2, inv, ...)
        cap = plan.slots.shape[1]
        Bp = max(1, PASS_BYTES // (16 * cap * cap * item))
        for c0 in range(0, plan.p2p_tgt.shape[0], Bp):
            tg = plan.p2p_tgt[c0:c0 + Bp].long()
            sc = plan.p2p_src[c0:c0 + Bp].long()
            pw = plan.p2p_w[c0:c0 + Bp]
            si, sj = plan.slots[tg], plan.slots[sc]  # [Bp, cap]
            safe_i, safe_j = torch.clamp(si, min=0), torch.clamp(sj, min=0)
            qj = q[safe_j] * (sj >= 0)
            d = r[safe_i][:, :, None, :] - r[safe_j][:, None, :, :]
            r2 = (d * d).sum(-1)
            ok = ((si >= 0)[:, :, None] & (sj >= 0)[:, None, :]
                  & (gid[safe_i][:, :, None] != gid[safe_j][:, None, :])
                  & (r2 > 0) & (pw > 0)[:, None, None])
            r2s = torch.where(ok, r2, one)
            inv = torch.where(ok, 1.0 / torch.sqrt(r2s), zero)
            phi_p = qj[:, None, :] * inv  # [Bp, cap, cap]
            f = (q[safe_i][:, :, None] * phi_p / r2s)[..., None] * d
            wi = (si >= 0).to(dt).reshape(-1)
            flat = safe_i.reshape(-1)
            phi_n = phi_n.index_add(0, flat, phi_p.sum(2).reshape(-1) * wi)
            F_n = F_n.index_add(0, flat, f.sum(2).reshape(-1, 3) * wi[:, None])

        phi_tot = (phi + phi_n) * vmask
        F = (F_far + F_n) * vmask[:, None]
        U = 0.5 * torch.sum(q * phi_tot)
        return U, F, phi_tot

    # -- public ---------------------------------------------------------------

    def compute(self, r, q, valid=None, gid=None, plan: TreePlan = None):
        """Energy U = 1/2 sum q_i phi_i, forces [N,3], potentials [N].
        Builds the tree from the current positions unless a `plan` (from
        build_plan) is passed.  Host arrays go to the solver's device; a
        tensor on another device raises."""
        dev = self.device
        r = on_device(r, dev, "r")
        q = on_device(q, dev, "q")
        n = r.shape[0]
        valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
                 else on_device(valid, dev, "valid"))
        gid = (torch.arange(n, device=dev) if gid is None
               else on_device(gid, dev, "gid"))
        if plan is None:
            plan = self.build_plan(r.detach().cpu().numpy(),
                                   valid.cpu().numpy(), gid=gid.cpu().numpy())
        return self._compute(plan, r, q, valid, gid)
