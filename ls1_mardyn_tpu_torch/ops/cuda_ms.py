"""Kernel K6: rigid multi-site molecule forces on the dense cap-padded
cell rows, and the host side both multi-site kernels share (the
counterpart of ls1_mardyn_tpu/ops/pallas_multisite.py).

  K6 multisite_cell_forces   csrc/ms_dense.cu    multisite_cell_forces_pallas

The layout is the JAX package's: a slot carries P planes

  [x, y, z, valid, cid, lj offsets (3 per LJ site), charge offsets,
   dipole offsets, dipole orientations, quadrupole offsets,
   quadrupole orientations]  (plane_layout; padded to a multiple of 8)

with the world-frame site offsets rotated outside the kernel.  r_i is
[nz, ny, P, nx*cap] (absolute coordinates, cap slots per cell along the
last axis), r_j its view with one periodic x halo cell per side,
pre-shifted by -+Lx: [nz(+2), ny(+2), P, (nx+2)*cap]; with z_halo /
y_halo it carries one explicit halo row per side in z / y.  The output
keeps the JAX layout [nz, ny, 10, nx*cap]: planes 0-8 are F, M and Vi
per slot; plane 9 (the TPU kernel's one-hot scalar lanes) is zero, and
u6, uX and myRF come back as 0-d tensors (K6 evaluates every pair from
both sides and halves them).

Both multi-site kernels (K5 in ops/cuda_ms_packed.py) evaluate one
"site-pair program": the list of (interaction body, site a, site b)
terms whose coupling mask is non-zero (MSMeta.terms), with the coupling
constants of every component pair in one flat table (MSMeta.flat_tables).
A wrapper takes the plain PyTorch version only for a CPU tensor; a CUDA
tensor launches the kernel (built at first use) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import molecule_pair
from ls1_mardyn_tpu_torch.ops import _build

NOUT = 10  # fx fy fz mx my mz vix viy viz (plane 9: zero)
# (dz, dy) of the 9 neighbour rows, the JAX package's order
OFFS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0),
        (1, 1)]
# candidate pair lanes per pass of the plain versions (bounds their
# temporaries; a card takes passes 8x as large)
_REF_LANES = 1 << 23


def ref_lanes(dev) -> int:
    return _REF_LANES * (8 if dev.type == "cuda" else 1)

# the 13 coupling tables [K, K, Sa, Sb] of the seven interaction bodies
TABLE_NAMES = ("eps24", "sig2", "shift6", "qq", "qQ05", "Qq05", "minus_qmy",
               "minus_myq", "QQ075", "Qmy15", "myQ15", "my2", "rffac")

# interaction bodies of the site-pair program (csrc/ms_pair.cuh: Body):
# name -> (code, i site category, j site category, i orientation,
#          j orientation, coupling tables)
BODIES = {
    "lj": (0, "lj", "lj", None, None, ("eps24", "sig2", "shift6")),
    "cc": (1, "charge", "charge", None, None, ("qq",)),
    "cq": (2, "charge", "quad", None, "quad_e", ("qQ05",)),
    "cd": (3, "charge", "dip", None, "dip_e", ("minus_qmy",)),
    "qc": (4, "quad", "charge", "quad_e", None, ("Qq05",)),
    "qq": (5, "quad", "quad", "quad_e", "quad_e", ("QQ075",)),
    "qd": (6, "quad", "dip", "quad_e", "dip_e", ("Qmy15",)),
    "dc": (7, "dip", "charge", "dip_e", None, ("minus_myq",)),
    "dq": (8, "dip", "quad", "dip_e", "quad_e", ("myQ15",)),
    "dd": (9, "dip", "dip", "dip_e", "dip_e", ("my2", "rffac")),
}
TERM_INTS = 10  # body, pi, pj, ei, ej, c0, c1, c2, cstride, (pad)


def plane_layout(NL, NC, ND, NQ):
    """Returns (n_planes, dict of plane index ranges)."""
    idx = {}
    p = 5  # x y z w cid
    idx["lj"] = p
    p += 3 * NL
    idx["charge"] = p
    p += 3 * NC
    idx["dip"] = p
    p += 3 * ND
    idx["dip_e"] = p
    p += 3 * ND
    idx["quad"] = p
    p += 3 * NQ
    idx["quad_e"] = p
    p += 3 * NQ
    # pad plane count to a multiple of 8 (the JAX layout's sublane tile)
    P = -(-p // 8) * 8
    return P, idx


class MSMeta:
    """Hashable bundle of the static kernel metadata: site counts, plane
    layout, the coupling tables and masks, and the site geometry
    (the JAX package's _MSMeta)."""

    def __init__(self, table):
        self.K = table.K
        self.NL, self.NC, self.ND, self.NQ = (
            table.NL, table.NC, table.ND, table.NQ,
        )
        P, layout = plane_layout(self.NL, self.NC, self.ND, self.NQ)
        self.P = P
        self.layout = layout
        minus_myq = np.transpose(table.minus_qmy, (1, 0, 3, 2)).copy()
        Qq05 = np.transpose(table.qQ05, (1, 0, 3, 2)).copy()
        self.tables = dict(
            eps24=table.eps24, sig2=table.sig2, shift6=table.shift6,
            qq=table.qq, qQ05=table.qQ05, Qq05=Qq05,
            minus_qmy=table.minus_qmy, minus_myq=minus_myq,
            QQ075=table.QQ075, Qmy15=table.Qmy15, myQ15=table.myQ15,
            my2=table.my2, rffac=table.rffac,
        )
        self.masks = dict(
            lj=table.eps24.any(axis=(0, 1)),
            cc=table.qq.any(axis=(0, 1)),
            cq=table.qQ05.any(axis=(0, 1)),
            cd=table.minus_qmy.any(axis=(0, 1)),
            qc=Qq05.any(axis=(0, 1)),
            qq=table.QQ075.any(axis=(0, 1)),
            qd=table.Qmy15.any(axis=(0, 1)),
            dc=minus_myq.any(axis=(0, 1)),
            dq=table.myQ15.any(axis=(0, 1)),
            dd=table.my2.any(axis=(0, 1)),
        )
        self._geom = dict(
            lj_pos=table.lj_pos, charge_pos=table.charge_pos,
            dip_pos=table.dip_pos, dip_e=table.dip_e,
            quad_pos=table.quad_pos, quad_e=table.quad_e,
        )
        # site geometry dedup: two sites (possibly of different
        # categories) whose body-frame positions are identical across
        # ALL components have identical world offset planes; sites at
        # the origin have zero offsets for every orientation.  The
        # kernels skip the offset of a zero site (site_zero); the JAX
        # kernel's alias pruning (site_rep) is kept as data.
        cats = [("lj", np.asarray(table.lj_pos), self.NL),
                ("charge", np.asarray(table.charge_pos), self.NC),
                ("dip", np.asarray(table.dip_pos), self.ND),
                ("quad", np.asarray(table.quad_pos), self.NQ)]
        reps = {}
        seen = []
        zero = {}
        for cat, pos, ns in cats:
            for s in range(ns):
                p = pos[:, s, :]
                zero[(cat, s)] = not p.any()
                for key, q in seen:
                    if np.array_equal(q, p):
                        reps[(cat, s)] = key
                        break
                else:
                    reps[(cat, s)] = (cat, s)
                    seen.append(((cat, s), p))
        self.site_rep = reps
        self.site_zero = zero
        self._key = (
            self.K, self.NL, self.NC, self.ND, self.NQ,
            *(self.tables[k].tobytes() for k in
              ("eps24", "sig2", "shift6", "qq", "qQ05", "minus_qmy", "QQ075",
               "Qmy15", "myQ15", "my2", "rffac")),
            np.asarray(table.lj_pos).tobytes(),
            np.asarray(table.charge_pos).tobytes(),
            np.asarray(table.dip_pos).tobytes(),
            np.asarray(table.quad_pos).tobytes(),
        )
        self._device = {}
        # 1 + the highest plane the site-pair program reads (x..cid at
        # least)
        t = self.terms()
        self.planes_needed = 5
        for col in (1, 2, 3, 4):
            if len(t) and t[:, col].max() >= 0:
                self.planes_needed = max(self.planes_needed,
                                         int(t[:, col].max()) + 3)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, MSMeta) and self._key == other._key

    def flat_tables(self):
        """The 13 coupling tables raveled into one float64 vector, and
        each table's offset in it."""
        offs, parts, at = {}, [], 0
        for name in TABLE_NAMES:
            a = np.asarray(self.tables[name], np.float64).ravel()
            offs[name] = at
            parts.append(a)
            at += a.size
        return np.concatenate(parts), offs

    def terms(self):
        """The site-pair program: int32 [n_terms, TERM_INTS], one row per
        (body, site a, site b) whose coupling mask is non-zero, in the
        JAX kernel's body order.  Row: body code; plane base of the i
        site offset and of the j site offset (-1 for a site at the
        centre of mass); plane base of the i and j orientation (-1 where
        the body has none); offsets into flat_tables() of up to three
        coupling constants for component pair (0, 0); the stride between
        component pairs.  Constant c of component pair (ci, cj) is
        flat[c + (ci*K + cj) * stride]."""
        L = self.layout
        _, offs = self.flat_tables()
        rows = []
        for name, (code, ci_cat, cj_cat, ei_cat, ej_cat, tabs) in BODIES.items():
            mask = np.asarray(self.masks[name])
            Sa, Sb = mask.shape
            for sa in range(Sa):
                for sb in range(Sb):
                    if not mask[sa, sb]:
                        continue
                    pi = -1 if self.site_zero[(ci_cat, sa)] else L[ci_cat] + 3 * sa
                    pj = -1 if self.site_zero[(cj_cat, sb)] else L[cj_cat] + 3 * sb
                    ei = -1 if ei_cat is None else L[ei_cat] + 3 * sa
                    ej = -1 if ej_cat is None else L[ej_cat] + 3 * sb
                    cs = [offs[t] + sa * Sb + sb for t in tabs]
                    cs += [0] * (3 - len(cs))
                    rows.append([code, pi, pj, ei, ej, *cs, Sa * Sb, 0])
        return np.asarray(rows, np.int32).reshape(-1, TERM_INTS)

    def device_program(self, dtype, device):
        """(flat tables, terms) on `device`, cached per dtype/device."""
        key = (dtype, str(device))
        if key not in self._device:
            flat, _ = self.flat_tables()
            self._device[key] = (
                torch.as_tensor(flat, dtype=dtype, device=device),
                torch.as_tensor(self.terms(), device=device).contiguous(),
            )
        return self._device[key]

    def couplings(self, dtype, device):
        """The coupling tables as a PairParams-like object for
        models.interaction.molecule_pair (the plain versions)."""
        key = ("couplings", dtype, str(device))
        if key not in self._device:
            self._device[key] = _Couplings(self.tables, dtype, device)
        return self._device[key]


class _Couplings:
    """The coupling-table fields of PairParams that molecule_pair reads."""

    def __init__(self, tables, dtype, device):
        for k, v in tables.items():
            setattr(self, k, torch.as_tensor(np.asarray(v), dtype=dtype,
                                             device=device))
        self._nonzero = {k: bool(np.asarray(v).any()) for k, v in tables.items()}

    def has(self, name: str) -> bool:
        return self._nonzero[name]


# -- the plain versions' pair evaluation ---------------------------------------

def _sites(planes, meta):
    """Site offsets and orientations of gathered slots [M, P] as the
    site_offsets dict molecule_pair takes ([M, S, 3] each); a block the
    layout carries beyond P (dead trailing planes of the packed rows) is
    zero."""
    M, P = planes.shape
    L = meta.layout
    out = {}
    for key, ns in (("lj", meta.NL), ("charge", meta.NC), ("dip", meta.ND),
                    ("dip_e", meta.ND), ("quad", meta.NQ),
                    ("quad_e", meta.NQ)):
        b = L[key]
        if b + 3 * ns <= P:
            out[key] = planes[:, b:b + 3 * ns].reshape(M, ns, 3)
        else:
            out[key] = planes.new_zeros((M, ns, 3))
    return out


def pair_block(pi, pj, drm, com2, *, rc2, rc2_lj, screen_alpha, meta):
    """All site-site terms of the ordered molecule pairs (i, j) given by
    their gathered planes pi, pj [M, P] (of which the pair function
    reads the component and site planes), the COM separation drm [M, 3]
    and its square com2 [M] (formed as the kernels form it).  Returns
    (per-pair [M, 9] F, M, Vi on i, and the unhalved sums u6, uX,
    myRF)."""
    cpl = meta.couplings(pi.dtype, pi.device)
    mlj = com2 < rc2_lj
    mel = com2 < rc2
    cid_i = torch.round(pi[:, 4]).long()
    cid_j = torch.round(pj[:, 4]).long()
    res = molecule_pair(drm, _sites(pi, meta), _sites(pj, meta), cid_i, cid_j,
                        cpl, mlj, mel, screen_alpha=screen_alpha)
    fmv = torch.cat([res["F"], res["M"], res["Vi"]], dim=1)
    return fmv, res["u6lj"].sum(), res["uX"].sum(), res["my_rf"].sum()


def _row_shift(idx, d, n, halo, box_len, dtype, dev):
    """Neighbour row index into the j source and its image shift for the
    rows idx at offset d: wrapped with -+box_len, or (halo) the explicit
    halo row idx+d+1 with no shift."""
    raw = idx + d
    if halo:
        return raw + 1, torch.zeros(raw.shape, dtype=dtype, device=dev)
    L = torch.tensor(box_len, dtype=dtype, device=dev)
    sh = torch.where(raw < 0, -L, torch.where(raw >= n, L, torch.zeros_like(L)))
    return torch.remainder(raw, n), sh


def com_pairs(xi, wi, xj, wj, rc2, rc2_lj, self_mask=None):
    """Candidate test of i slots xi [..., A, 3] (wi validity) against j
    candidates xj [..., A, B, 3] or [..., 1, B, 3] (wj): the COM
    separation and its square, rounded as the kernels round them, and
    the indices of the pairs inside either cutoff."""
    d = [xi[..., c, None] - xj[..., c] for c in range(3)]
    com2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    m = wi[..., None] & wj & ((com2 < rc2_lj) | (com2 < rc2))
    if self_mask is not None:
        m = m & ~self_mask
    idx = m.nonzero(as_tuple=True)
    drm = torch.stack([d[0][idx], d[1][idx], d[2][idx]], dim=1)
    return idx, drm, com2[idx]


def multisite_cell_forces_reference(
    r_i, r_j, *, nx, ny, nz, cap, box, rc2, rc2_lj, screen_alpha, meta,
    z_halo=False, y_halo=False,
):
    """Plain PyTorch version of K6 (see multisite_cell_forces): for each
    i slot, the slots of cells x-1..x+1 of the 9 neighbour rows of the
    halo view, the COM cutoff test first, then the pair function
    (models.interaction.molecule_pair) on the pairs inside a cutoff."""
    P = r_i.shape[2]
    W = nx * cap
    Wj = (nx + 2) * cap
    dtype, dev = r_i.dtype, r_i.device
    _bx, by, bz = (float(b) for b in box)
    nyj = ny + 2 if y_halo else ny
    acc = torch.zeros((nz * ny * W, 9), dtype=dtype, device=dev)
    sums = torch.zeros(3, dtype=dtype, device=dev)
    ri_flat = r_i.reshape(nz * ny, P, W)
    rj_flat = r_j.reshape(-1, P, Wj)
    R = nz * ny
    rc = max(1, ref_lanes(dev) // (W * 3 * cap))
    a_idx = torch.arange(cap, device=dev)
    b_idx = torch.arange(3 * cap, device=dev)
    self_cell = (b_idx[None, :] == a_idx[:, None] + cap)  # [cap, 3cap]
    for r0 in range(0, R, rc):
        rows = torch.arange(r0, min(R, r0 + rc), device=dev)
        zs, ys = rows // ny, rows % ny
        pi4 = ri_flat[rows, :4].reshape(-1, 4, nx, cap).permute(0, 2, 3, 1)
        wi = pi4[..., 3] > 0.5  # [Rc, nx, cap]
        for dz, dy in OFFS:
            zj, sz = _row_shift(zs, dz, nz, z_halo, bz, dtype, dev)
            yj, sy = _row_shift(ys, dy, ny, y_halo, by, dtype, dev)
            jrow = zj * nyj + yj
            win = rj_flat[jrow, :4].unfold(-1, 3 * cap, cap)  # [Rc,4,nx,3cap]
            xj = torch.stack([win[:, 0], win[:, 1] + sy[:, None, None],
                              win[:, 2] + sz[:, None, None]], dim=-1)
            wj = (win[:, 3] > 0.5)[:, :, None, :]
            idx, drm, com2 = com_pairs(
                pi4[..., :3], wi, xj[:, :, None], wj, rc2, rc2_lj,
                self_cell if (dz, dy) == (0, 0) else None)
            rr, xx, a, b = idx
            islot = xx * cap + a
            jslot = xx * cap + b
            pi = ri_flat[rows[rr], :, islot]
            pj = rj_flat[jrow[rr], :, jslot]
            fmv, u6, ux, rf = pair_block(
                pi, pj, drm, com2, rc2=rc2, rc2_lj=rc2_lj,
                screen_alpha=screen_alpha, meta=meta)
            acc.index_add_(0, rows[rr] * W + islot, fmv)
            sums += torch.stack([u6, ux, rf])
    out = torch.zeros((nz, ny, NOUT, W), dtype=dtype, device=dev)
    out[:, :, :9] = acc.reshape(nz, ny, W, 9).permute(0, 1, 3, 2)
    u6, ux, rf = (0.5 * sums).unbind()
    return out, u6, ux, rf


# -- the CUDA launches ----------------------------------------------------------

_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument types of each library's <name>_f32 / <name>_f64 entry points
_ARGTYPES = {
    # ri, rj, out, part, tab, terms; nx ny nz cap P zhalo yhalo;
    # by bz rc2 rc2lj alpha; K ntab nterms; stream
    "ms_dense": [_VP] * 6 + [_CI] * 7 + [_CD] * 5 + [_CI] * 3 + [_VP],
    # tbl, ri, rj, out, part, tab, terms; nx ny nz cap P Wp Wjp
    # cell_plane zhalo; by bz rc2 rc2lj alpha; K ntab nterms; stream
    "ms_packed": [_VP] * 7 + [_CI] * 9 + [_CD] * 5 + [_CI] * 3 + [_VP],
}
_NB_ARGS = {"ms_dense": 4, "ms_packed": 4}


def type_lib(lib, name):
    """Set the argument and result types of a loaded csrc/<name>.cu
    library's entry points (once); returns it."""
    if not getattr(lib, "_typed", False):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = _CI
        nb = getattr(lib, name + "_num_blocks")
        nb.argtypes = [_CI] * _NB_ARGS[name]
        nb.restype = _CI
        lib._typed = True
    return lib


def _lib(name):
    return type_lib(_build.load(name), name)


def launch(name, r_i, out_shape, nb_args, args, *, meta, box, rc2, rc2_lj,
           screen_alpha, zero=False):
    """Allocate the output (zeroed where the kernel adds to it) and the
    partial sums (<name>_num_blocks rows), launch csrc/<name>.cu on
    PyTorch's current stream, check the status; returns (out, u6, uX,
    myRF).  args(out, part, tab, terms) gives the entry point's pointer
    and layout arguments before the physical constants."""
    lib = _lib(name)
    dtype, dev = r_i.dtype, r_i.device
    tab, terms = meta.device_program(dtype, dev)
    out = (torch.zeros if zero else torch.empty)(out_shape, dtype=dtype,
                                                 device=dev)
    nb = getattr(lib, name + "_num_blocks")(*nb_args)
    part = torch.empty((nb, 3), dtype=dtype, device=dev)
    fn = getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    stream = _build.stream_of(lib, r_i, name)
    _build.check(fn(*args(out, part, tab.data_ptr(), terms.data_ptr()),
                    float(box[1]), float(box[2]), float(rc2), float(rc2_lj),
                    float(screen_alpha), int(meta.K), int(tab.numel()),
                    int(terms.shape[0]), stream), name)
    u6, ux, rf = part.sum(0).unbind()
    return out, u6, ux, rf


def check_planes(what, r, shape, meta):
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {r.dtype} (f32/f64 only)")
    if tuple(r.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(r.shape)} != {tuple(shape)}")
    if r.shape[2] < meta.planes_needed:
        raise ValueError(
            f"{what}: {r.shape[2]} planes, the site-pair program reads "
            f"{meta.planes_needed}")


def multisite_cell_forces(
    r_i, r_j, *, nx, ny, nz, cap, box, rc2, rc2_lj, screen_alpha, meta,
    z_halo=False, y_halo=False,
):
    """K6 wrapper: double-sided rigid multi-site forces of every slot of
    r_i [nz, ny, P, nx*cap] against the x-halo view r_j [nz(+2), ny(+2),
    P, (nx+2)*cap].  A slot meets the slots of cells x-1..x+1 of the 9
    (dz, dy) neighbour rows (the caller's cell edge is >= the cutoff);
    a neighbour row whose index wrapped is shifted by -+by / -+bz, an
    explicit halo row (z_halo / y_halo) is not.  The cutoff is
    COM-based: LJ terms count where |drm|^2 < rc2_lj, electrostatic
    ones where |drm|^2 < rc2; charge-charge is erfc-screened when
    screen_alpha > 0.  The TPU kernel's tile width tx and j chunk jw
    are its own tiling and not part of this contract.
    Returns (out [nz, ny, 10, nx*cap], u6, uX, myRF)."""
    W, Wj = nx * cap, (nx + 2) * cap
    what = "multisite_cell_forces"
    check_planes(what, r_i, (nz, ny, r_i.shape[2], W), meta)
    check_planes(what, r_j, (nz + 2 * bool(z_halo), ny + 2 * bool(y_halo),
                             r_i.shape[2], Wj), meta)
    if r_j.dtype != r_i.dtype or r_j.device != r_i.device:
        raise ValueError(f"{what}: r_i and r_j differ in dtype or device")
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, box=box, rc2=rc2, rc2_lj=rc2_lj,
              screen_alpha=screen_alpha, meta=meta, z_halo=z_halo,
              y_halo=y_halo)
    if r_i.device.type == "cpu":
        return multisite_cell_forces_reference(r_i, r_j, **kw)
    if r_i.device.type != "cuda":
        raise ValueError(f"{what}: device {r_i.device}")
    if not (r_i.is_contiguous() and r_j.is_contiguous()):
        raise ValueError(f"{what}: r_i and r_j must be contiguous")
    res = launch_dense(r_i, r_j, **kw)
    multisite_cell_forces.launches += 1
    return res


multisite_cell_forces.launches = 0


def launch_dense(r_i, r_j, *, nx, ny, nz, cap, box, rc2, rc2_lj, screen_alpha,
                 meta, z_halo=False, y_halo=False):
    """The launch of csrc/ms_dense.cu behind multisite_cell_forces, on
    checked inputs."""
    return launch(
        "ms_dense", r_i, (nz, ny, NOUT, nx * cap), (nx, ny, nz, cap),
        lambda out, part, tab, terms: (
            r_i.data_ptr(), r_j.data_ptr(), out.data_ptr(), part.data_ptr(),
            tab, terms, nx, ny, nz, cap, r_i.shape[2], int(bool(z_halo)),
            int(bool(y_halo))),
        meta=meta, box=box, rc2=rc2, rc2_lj=rc2_lj, screen_alpha=screen_alpha)
