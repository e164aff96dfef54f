"""Kernel K10: 1CLJ forces on occupancy-packed pencils, with the pencil
pack, unpack and group tables (the counterpart of
ls1_mardyn_tpu/ops/pallas_packed.py).

Layout: each (z, y) PENCIL (one x row of cells) stores its valid
molecules contiguously in x-cell order, packed [nz, ny, 9, Wp] = (x, y,
z cell-local, cx = x-cell index as a float, w, vx, vy, vz, mid); lanes
past the pencil's count carry zeros and the sentinel y =
SENTINEL_SCALE*(1+lane).  pack_pencils, unpack_pencils and build_tables
are module-boundary layouts: they are bit-identical to the JAX package's
(a stable sort where the JAX side sorts with lax.sort), so states and
tables can be compared lane by lane.

  K10 lj_forces_packed   csrc/lj_packed.cu   lj_forces_packed

The kernel takes groups of 32 packed i molecules over the 5
Newton-3rd-law forward pencils, each pair once (u6 and the virial are
not halved), plus a periodic-x wrap pass for the edge groups.  It finds
each group's exact j cell range in the cx plane, so the 128-lane window
limit that build_tables reports as `feasible` (a TPU alignment rule)
does not bind it.  A wrapper takes the plain version only for a CPU
tensor; a CUDA tensor launches the kernel (built at first use) or
raises.  launch_lj_packed is the launch behind the wrapper, on checked
inputs (it takes a CPU tensor only with a library built for the CPU,
tools/cuda_emu.py); ops/cuda_lj.inside_pairs(kernel="packed") counts
the pairs inside the cutoff that the kernel evaluates (a launch with
eps24 = 0 and shift6 = 1), exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ls1_mardyn_tpu_torch.models import potentials
from ls1_mardyn_tpu_torch.ops import _build
from ls1_mardyn_tpu_torch.ops.cuda_lj import _REF_CHUNK, SENTINEL_SCALE

# packed plane indices
PX, PY, PZ, PCX, PW, PVX, PVY, PVZ, PMID = range(9)
# kernel position planes (x, y, z, cx)
KPLANES = 4
# forward rows (dz, dy); index 0 is the center (in-pencil) row
POFFS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))
GSZ = 32  # i molecules per group
PH = 8  # phase copies of the TPU kernel (window offsets align to WIN // PH)
WIN = 128  # j window lanes of the TPU kernel
NT = 16  # table ints per group
# table columns: the group's base cell, then the TPU kernel's window
# offsets woff[k] (columns 1..5) and wrap woff2[k] (6..10), then the wrap
# window's cx offset (+-nx)
T_CB = 0
T_O2 = 11
# meta columns (per pencil)
M_NG = 0
M_ELO = 1
M_EHI = 2
M_CNT = 3
NMETA = 8
_BIG = 2 ** 30


def _ceil_div(a, b):
    return (a + b - 1) // b


# ---------------------------------------------------------------------------
# pack / unpack / tables (plain torch, at rebin cadence)
# ---------------------------------------------------------------------------

def pencil_counts(valid_lane, nx: int, cap: int):
    """occ [nz,ny,nx], starts (exclusive cumsum) [nz,ny,nx], cnt [nz,ny],
    all int32, from a dense [nz, ny, nx*cap] validity plane."""
    nz, ny, _ = valid_lane.shape
    occ = valid_lane.reshape(nz, ny, nx, cap).sum(-1).to(torch.int32)
    starts = torch.cumsum(occ, dim=-1, dtype=torch.int32) - occ
    return occ, starts, occ.sum(-1, dtype=torch.int32)


def _lane(shape, dev):
    """int32 lane index along the last axis, broadcast to `shape`."""
    return torch.arange(shape[-1], dtype=torch.int32, device=dev).expand(shape)


def pack_pencils(planes, forces, nx: int, cap: int, Wp: int):
    """Dense [nz,ny,8,nx*cap] planes (+[nz,ny,3,W] forces) -> packed
    [nz,ny,9,Wp] (+ packed forces [nz,ny,3,Wp]), occ/starts/cnt,
    overflow flag (a pencil holds more than Wp molecules).

    One stable per-pencil sort by (valid ? lane : BIG) moves the valid
    molecules to the front in x-cell order (the dense lane order is
    already cell-major)."""
    nz, ny, NP, W = planes.shape
    dtype, dev = planes.dtype, planes.device
    valid = planes[:, :, 3, :] > 0.5
    occ, starts, cnt = pencil_counts(valid, nx, cap)
    lane = _lane((nz, ny, W), dev)
    key = torch.where(valid, lane, _BIG)
    order = torch.sort(key, dim=-1, stable=True).indices
    cxf = torch.div(lane, cap, rounding_mode="floor").to(dtype)
    ops = torch.cat([planes, cxf[:, :, None], forces], dim=2)  # [nz,ny,12,W]
    srt = torch.gather(ops, 3, order[:, :, None, :].expand(-1, -1, ops.shape[2], -1))
    if W < Wp:
        srt = torch.nn.functional.pad(srt, (0, Wp - W))
    s = srt[..., :Wp]
    overflow = cnt.max() > Wp
    q = _lane((nz, ny, Wp), dev)
    live = q < cnt[:, :, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    sent = SENTINEL_SCALE * (1.0 + q.to(dtype))

    def keep(c):
        return torch.where(live, s[:, :, c], zero)

    packed = torch.stack(
        [keep(0), torch.where(live, s[:, :, 1], sent), keep(2), keep(8), keep(3),
         keep(4), keep(5), keep(6), keep(7)], dim=2)
    pforces = torch.stack([keep(9), keep(10), keep(11)], dim=2)
    return packed, pforces, occ, starts, cnt, overflow


def unpack_pencils(packed, pforces, occ, starts, nx: int, cap: int):
    """Packed [nz,ny,9,Wp] -> dense [nz,ny,8,nx*cap] (+forces [nz,ny,3,W]).

    Placement is a per-pencil union sort: items keyed by their dense
    destination cx*cap + (q - starts[cx]) plus one filler per EMPTY dense
    slot keyed by its own lane; the keys below W are then a permutation
    of [0, W) and the first W sorted entries are the dense layout; the
    fillers are zeros."""
    nz, ny, _, Wp = packed.shape
    W = nx * cap
    dtype, dev = packed.dtype, packed.device
    w = packed[:, :, PW, :]
    q = _lane((nz, ny, Wp), dev)
    cx = torch.clamp(packed[:, :, PCX, :].to(torch.int32), 0, nx - 1)
    s_at = torch.gather(starts, 2, cx.long())
    dest = torch.where(w > 0.5, cx * cap + (q - s_at), _BIG)
    items = torch.cat(
        [packed[:, :, [PX, PY, PZ, PW, PVX, PVY, PVZ, PMID], :], pforces], dim=2)
    lane = _lane((nz, ny, W), dev)
    occ_lane = torch.repeat_interleave(occ, cap, dim=-1)
    empty = (lane % cap) >= occ_lane
    kf = torch.where(empty, lane, _BIG + 1)
    fvals = torch.zeros((nz, ny, 11, W), dtype=dtype, device=dev)
    keys = torch.cat([dest, kf], dim=-1)
    ops = torch.cat([items, fvals], dim=-1)
    order = torch.sort(keys, dim=-1, stable=True).indices[..., :W]
    out = torch.gather(ops, 3, order[:, :, None, :].expand(-1, -1, 11, -1))
    return out[:, :, :8], out[:, :, 8:]


def build_tables(occ, starts, cnt, *, nx: int, Wp: int):
    """Per-group tables of the packed kernel, as the JAX package builds
    them for its TPU kernel.

    Returns (tab [nz,ny,Gmax,NT] int32, meta [nz,ny,1,NMETA] int32,
    feasible 0-d bool).  tab holds each group's base cell cb, its 128-lane
    window offsets (woff, woff2; the TPU kernel's) and the wrap window's
    cx offset; meta holds (ng, e_lo, e_hi, cnt) per pencil.  feasible is
    False where a TPU window cannot cover a group's cells in 128 lanes,
    a group wraps at both ends, or nx < 6; the CUDA kernel takes exact
    ranges and needs none of it."""
    nz, ny, _ = occ.shape
    dev = occ.device
    i32 = torch.int32
    step = WIN // PH
    Gmax = Wp // GSZ
    ng = _ceil_div(cnt, GSZ)
    t = torch.arange(Gmax, dtype=i32, device=dev)
    first = (GSZ * t)[None, None, :]
    cnt1 = torch.clamp(cnt, min=1)[:, :, None]
    last = torch.minimum(first + GSZ - 1, cnt1 - 1)
    live_t = first < cnt1
    st4 = starts[:, :, None, :]
    cf = (st4 <= first[..., None]).sum(-1, dtype=i32) - 1
    cl_ = (st4 <= last[..., None]).sum(-1, dtype=i32) - 1
    cell_lo = cf - 1
    cell_hi = cl_ + 1
    wrap_lo = cell_lo < 0
    wrap_hi = cell_hi > nx - 1
    cb = torch.where(live_t, cf, 0)

    def take(a, idx):
        return torch.gather(a, 2, idx.long())

    woffs, woffs2 = [], []
    feas = torch.ones((), dtype=torch.bool, device=dev)
    for dz, dy in POFFS:
        starts_k = torch.roll(starts, (-dz, -dy), (0, 1))
        cnt_k = torch.roll(cnt, (-dz, -dy), (0, 1))[:, :, None]
        a = torch.clamp(cell_lo, 0, nx - 1)
        b = torch.clamp(cell_hi, 0, nx - 1)
        woff = torch.div(take(starts_k, a), step, rounding_mode="floor") * step
        end_b = torch.where(b >= nx - 1, cnt_k,
                            take(starts_k, torch.clamp(b + 1, max=nx - 1)))
        feas = feas & torch.where(live_t, end_b - woff <= WIN, True).all()
        w2_lo = torch.div(take(starts_k, torch.full_like(a, nx - 1)), step,
                          rounding_mode="floor") * step
        hi_c = torch.clamp(cell_hi - nx + 1, 0, nx - 1)
        end2_hi = take(starts_k, hi_c)
        woff2 = torch.where(wrap_lo, w2_lo, 0)
        end2 = torch.where(wrap_lo, cnt_k.expand_as(end2_hi), end2_hi)
        has2 = (wrap_lo | wrap_hi) & live_t
        feas = feas & torch.where(has2, end2 - woff2 <= WIN, True).all()
        woffs.append(torch.where(live_t, woff, 0))
        woffs2.append(torch.where(has2, woff2, 0))
    feas = feas & ~(wrap_lo & wrap_hi & live_t).any() & (nx >= 6)
    o2 = torch.where(wrap_lo, -nx, nx).to(i32)
    zeros = torch.zeros_like(cb)
    tab = torch.stack([cb] + woffs + woffs2 + [o2] + [zeros] * (NT - T_O2 - 1),
                      dim=-1).to(i32)
    e_lo = (wrap_lo & live_t).sum(-1, dtype=i32)
    e_hi = (wrap_hi & live_t).sum(-1, dtype=i32)
    z2 = torch.zeros_like(e_lo)
    meta = torch.stack([ng.to(i32), e_lo, e_hi, cnt.to(i32)]
                       + [z2] * (NMETA - 4), dim=-1)[:, :, None, :]
    return tab, meta, feas


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def lj_forces_packed_reference(pos4, tab, meta, *, nx, ny, nz, Wp, box, eps24,
                               sig2, shift6, rc2, compute_macro=True,
                               count=False):
    """Plain PyTorch version of K10, per pencil on the packed lanes: the
    molecules of each cell (a run of lanes, found from the cx plane) meet
    those of the cells dx = -1, 0, +1 of the 5 forward pencils, recentred
    on the i lane's group base cell cb as the kernel recentres them
    (x'' = x + (cx - cb)*clx; a j cell across the x wrap one box length
    away).  In the own pencil a pair counts when j's lane is above i's.
    Each pair once; the reaction goes to j with index_add_.  count=True
    returns the number of pairs inside the cutoff instead."""
    dtype, dev = pos4.dtype, pos4.device
    clx, cly, clz = (float(b) / n for b, n in zip(box, (nx, ny, nz)))
    cnt = meta[:, :, 0, M_CNT].long()
    q = torch.arange(Wp, device=dev)
    live = q < cnt[:, :, None]
    cx = torch.where(live, pos4[:, :, PCX].long(), nx)  # dead lanes: cell nx
    # lanes of each (pencil, cell): starts by searchsorted, cap = max occupancy
    starts = torch.searchsorted(cx.reshape(nz * ny, Wp).contiguous(),
                                torch.arange(nx + 1, device=dev).expand(
                                    nz * ny, nx + 1).contiguous())
    starts = starts.reshape(nz, ny, nx + 1)
    occ = starts[..., 1:] - starts[..., :-1]
    cap = max(1, int(occ.max()))
    slot = torch.arange(cap, device=dev)
    lane = starts[..., :-1, None] + slot  # [nz,ny,nx,cap]
    ok = slot < occ[..., None]
    lane = torch.where(ok, lane, 0)
    cb = tab[:, :, :, T_CB].long()  # [nz,ny,Gmax]

    def cells(a):  # [nz,ny,Wp] -> [nz,ny,nx,cap] by lane
        return torch.gather(a, 2, lane.reshape(nz, ny, -1)).reshape(lane.shape)

    x, y, z = (cells(pos4[:, :, c]) for c in (PX, PY, PZ))
    cxc = cells(pos4[:, :, PCX])
    cbi = torch.gather(cb, 2, torch.div(lane, GSZ, rounding_mode="floor")
                       .reshape(nz, ny, -1)).reshape(lane.shape).to(dtype)
    xi_all = x + (cxc - cbi) * clx
    f = torch.zeros((nz * ny * Wp, 3), dtype=dtype, device=dev)
    u6 = torch.zeros((), dtype=dtype, device=dev)
    vir = torch.zeros((), dtype=dtype, device=dev)
    zs = torch.arange(nz, device=dev)
    ys = torch.arange(ny, device=dev)
    cs = torch.arange(nx, device=dev)
    n_inside = 0
    zc = max(1, min(nz, _REF_CHUNK // (ny * nx * cap * cap)))
    for z0 in range(0, nz, zc):
        z1 = min(nz, z0 + zc)
        sl = slice(z0, z1)
        xi, yi, zi, oki = xi_all[sl], y[sl], z[sl], ok[sl]
        li = lane[sl]
        for k, (dz, dy) in enumerate(POFFS):
            jz = torch.remainder(zs[sl] + dz, nz)
            jy = torch.remainder(ys + dy, ny)
            for dx in (-1, 0, 1):
                raw = cs + dx
                jx = torch.remainder(raw, nx)
                # cbj = cb, cb + nx (low wrap) or cb - nx (high wrap)
                o2 = ((raw < 0).to(dtype) - (raw >= nx).to(dtype)) * nx

                def jrows(a):
                    return a.index_select(0, jz).index_select(1, jy) \
                        .index_select(2, jx)

                cxj = jrows(cxc)
                okj = jrows(ok)
                lj_ = jrows(lane)
                # per (i slot, j slot): x_j recentred on the i lane's cb
                cbj = cbi[sl][..., :, None] + o2[None, None, :, None, None]
                xjs = jrows(x)[..., None, :] + (cxj[..., None, :] - cbj) * clx
                ygs = yi - torch.tensor(dy * cly, dtype=dtype, device=dev)
                zgs = zi - torch.tensor(dz * clz, dtype=dtype, device=dev)
                ddx = xi[..., :, None] - xjs
                ddy = ygs[..., :, None] - jrows(y)[..., None, :]
                ddz = zgs[..., :, None] - jrows(z)[..., None, :]
                dr2 = ddx * ddx + ddy * ddy + ddz * ddz
                m = oki[..., :, None] & okj[..., None, :] & (dr2 < rc2)
                if k == 0:
                    m = m & (lj_[..., None, :] > li[..., :, None])
                if count:
                    n_inside += int(m.sum())
                    continue
                zz, yy, xx, si, sj = m.nonzero(as_tuple=True)
                dr = torch.stack([ddx[zz, yy, xx, si, sj], ddy[zz, yy, xx, si, sj],
                                  ddz[zz, yy, xx, si, sj]], -1)
                fp, u6p = potentials.lj(dr, dr2[zz, yy, xx, si, sj], eps24, sig2)
                zabs = zz + z0
                ii = (zabs * ny + yy) * Wp + li[zz, yy, xx, si]
                jj = (jz[zz] * ny + jy[yy]) * Wp + lj_[zz, yy, xx, sj]
                f.index_add_(0, ii, fp)
                f.index_add_(0, jj, -fp)
                if compute_macro:
                    u6 += (u6p + shift6).sum()
                    vir += (fp * dr).sum()
    if count:
        return n_inside
    f = f.reshape(nz, ny, Wp, 3).permute(0, 1, 3, 2).contiguous()
    return f, u6, vir


_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def type_lib(lib):
    """Set the argument and result types of a loaded csrc/lj_packed.cu
    library's entry points (once); returns it."""
    if not getattr(lib, "_typed", False):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, "lj_packed" + suffix)
            fn.argtypes = [_VP] * 5 + [_CI] * 5 + [_CD] * 7 + [_CI, _VP]
            fn.restype = _CI
        lib.lj_packed_num_blocks.argtypes = [_CI] * 3
        lib.lj_packed_num_blocks.restype = _CI
        lib._typed = True
    return lib


def _lib():
    return type_lib(_build.load("lj_packed"))


def lj_forces_packed(pos4, tab, meta, *, nx, ny, nz, Wp, box, eps24, sig2,
                     shift6, rc2, compute_macro=True):
    """K10 wrapper.  pos4 [nz, ny, 4, Wp] (x, y, z cell-local, cx) of the
    packed pencils, tab [nz, ny, Wp/32, 16] and meta [nz, ny, 1, 8] int32
    from build_tables.  Needs nx, ny, nz >= 3 and cell edges >= rc; any
    state build_tables describes is computed whole, `feasible` or not.
    Returns (f [nz,ny,3,Wp] in packed lane order, u6, vir), each pair
    counted once."""
    what = "lj_forces_packed"
    if pos4.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {pos4.dtype} (f32/f64 only)")
    gmax = Wp // GSZ
    for name, t, shape, dt in (
            ("pos4", pos4, (nz, ny, KPLANES, Wp), None),
            ("tab", tab, (nz, ny, gmax, NT), torch.int32),
            ("meta", meta, (nz, ny, 1, NMETA), torch.int32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"{what}: {name} dtype {t.dtype} (int32)")
        if t.device != pos4.device:
            raise ValueError(f"{what}: {name} on {t.device}, pos4 on {pos4.device}")
    if Wp % GSZ:
        raise ValueError(f"{what}: Wp {Wp} (a multiple of {GSZ})")
    if min(nx, ny, nz) < 3:
        raise ValueError(f"{what}: dims {(nx, ny, nz)} need >= 3 cells per axis")
    cl = tuple(float(b) / n for b, n in zip(box, (nx, ny, nz)))
    if min(cl) ** 2 < rc2:
        raise ValueError(f"{what}: cell edge {min(cl)} < cutoff")
    kw = dict(nx=nx, ny=ny, nz=nz, Wp=Wp, box=box, eps24=eps24, sig2=sig2,
              shift6=shift6, rc2=rc2, compute_macro=compute_macro)
    if pos4.device.type == "cpu":
        return lj_forces_packed_reference(pos4, tab, meta, **kw)
    if pos4.device.type != "cuda":
        raise ValueError(f"{what}: device {pos4.device}")
    if not (pos4.is_contiguous() and tab.is_contiguous() and meta.is_contiguous()):
        raise ValueError(f"{what}: pos4, tab and meta must be contiguous")
    out = launch_lj_packed(pos4, tab, meta, **kw)
    lj_forces_packed.launches += 1
    return out


lj_forces_packed.launches = 0


def launch_lj_packed(pos4, tab, meta, *, nx, ny, nz, Wp, box, eps24, sig2,
                     shift6, rc2, compute_macro=True, parts=False):
    """The launch of csrc/lj_packed.cu behind lj_forces_packed, on checked
    inputs (f zeroed first: the kernel adds into it): (f, u6, vir), or
    (f, part) with `parts` (the per-block sums part[block] = (u6,
    vir))."""
    lib = _lib()
    gmax = Wp // GSZ
    cl = tuple(float(b) / n for b, n in zip(box, (nx, ny, nz)))
    f = torch.zeros((nz, ny, 3, Wp), dtype=pos4.dtype, device=pos4.device)
    part = torch.empty((lib.lj_packed_num_blocks(nz, ny, gmax), 2),
                       dtype=pos4.dtype, device=pos4.device)
    fn = lib.lj_packed_f32 if pos4.dtype == torch.float32 else lib.lj_packed_f64
    _build.check(fn(pos4.data_ptr(), tab.data_ptr(), meta.data_ptr(),
                    f.data_ptr(), part.data_ptr(), nx, ny, nz, Wp, gmax, *cl,
                    float(eps24), float(sig2), float(shift6), float(rc2),
                    int(bool(compute_macro)),
                    _build.stream_of(lib, pos4, "lj_forces_packed")),
                 "lj_forces_packed")
    if parts:
        return f, part
    if compute_macro:
        u6, vir = part.sum(0).unbind()
    else:
        u6 = vir = torch.zeros((), dtype=pos4.dtype, device=pos4.device)
    return f, u6, vir

