"""The multi-site kernels' plain versions (ls1_mardyn_tpu_torch/ops/cuda_ms.py:
K6 multisite_cell_forces, ops/cuda_ms_packed.py: K5
multisite_cell_forces_packed) against the JAX package's Pallas kernels
in interpret mode, f64 on the CPU, on the same inputs made with numpy
from a seed, and the static kernel metadata (MSMeta) against _MSMeta.

Scenes, built in the repo: "mix" (two components, A: LJ + charge +
dipole, B: LJ + charge + quadrupole, off-COM sites, eps_rf 5: all seven
bodies and the reversed ones), "2cljq" (two LJ sites and an axial
quadrupole), "water" (LJ + three charges, SPC/E-like, erfc-screened at
alpha 0.9), "ions" (LJ + two off-COM charges of either sign).

Tolerances (the JAX kernel tests' own): F, M and Vi within 1e-11 of
their max; u6, uX and myRF rtol 1e-10.  Each JAX kernel call compiles
for ~5-20 s; the file runs one per case.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.ascii_reader import PhaseSpaceData as JaxPSD
from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu.ops.pallas_ms_packed import (
    live_plane_count as jax_live_plane_count,
    multisite_cell_forces_packed as jax_k5,
)
from ls1_mardyn_tpu.ops.pallas_multisite import (
    _MSMeta,
    multisite_cell_forces_pallas as jax_k6,
)
from ls1_mardyn_tpu.scene import build_scene as jax_build_scene
from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.models.components import Component
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.cuda_ms import (
    MSMeta,
    multisite_cell_forces,
)
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
    CudaMultiSitePackedPath,
    live_plane_count,
    multisite_cell_forces_packed,
)
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from ls1_mardyn_tpu_torch.scene import build_scene

torch.set_num_threads(1)


def components(kind, C, rc=3.0):
    """Hand-built components of a scene kind, for either package."""
    if kind == "mix":
        a = C(cid=0)
        a.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc, False)
        a.add_charge(0.25, 0.0, 0.0, 0.1, 0.5)
        a.add_dipole(0.0, 0.1, 0.0, 0.0, 1.0, 0.0, 0.8)
        b = C(cid=1)
        b.add_ljcenter(0.0, 0.0, 0.0, 1.2, 0.8, 1.1, rc, False)
        b.add_charge(0.0, 0.2, 0.0, 0.1, -0.5)
        b.add_quadrupole(0.05, 0.0, 0.0, 1.0, 0.0, 0.0, 0.9)
        return [a, b]
    if kind == "2cljq":
        c = C(cid=0)
        c.add_ljcenter(0.0, 0.0, -0.2, 0.5, 1.0, 1.0, rc, True)
        c.add_ljcenter(0.0, 0.0, 0.2, 0.5, 1.0, 1.0, rc, True)
        c.add_quadrupole(0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.2)
        return [c]
    if kind == "water":
        c = C(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
        c.add_charge(0.0, 0.0, 0.0, 0.0, -0.8476)
        c.add_charge(0.316, 0.245, 0.0, 0.01, 0.4238)
        c.add_charge(-0.316, 0.245, 0.0, 0.01, 0.4238)
        return [c]
    comps = []  # "ions"
    for sign in (1.0, -1.0):
        c = C(cid=len(comps))
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
        c.add_charge(0.1, 0.0, 0.0, 0.01, sign * 0.5)
        c.add_charge(-0.1, 0.0, 0.0, 0.01, -sign * 0.5)
        comps.append(c)
    return comps


def lattice(n, box, seed, thin_upper_z=0.0):
    """A jittered simple-cubic lattice of about n sites in box (numpy)."""
    rng = np.random.default_rng(seed)
    box = np.broadcast_to(np.asarray(box, float), (3,)).copy()
    k = np.maximum(1, np.round(box * (n / box.prod()) ** (1 / 3))).astype(int)
    g = np.stack(np.meshgrid(*[np.arange(m) for m in k], indexing="ij"),
                 -1).reshape(-1, 3)
    r = ((g + 0.5) * (box / k) + rng.uniform(-0.15, 0.15, g.shape)) % box
    if thin_upper_z:
        r = r[(r[:, 2] < box[2] / 2) | (rng.random(len(r)) < thin_upper_z)]
    return r, box


def scene(kind, r, box, rc=3.0, seed=1):
    """The same scene for both packages from numpy positions r:
    (port mol, port table, JAX mol, JAX table, box), f64; scene_pp
    gives the pair parameters too."""
    s = scene_pp(kind, r, box, rc, seed)
    return s.pmol, s.ptable, s.jmol, s.jtable, s.box


def scene_pp(kind, r, box, rc=3.0, seed=1):
    """scene() as a namespace with the port's and the JAX package's
    PairParams (ppp, jpp)."""
    rng = np.random.default_rng(seed)
    n = len(r)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    out = []
    for PSD, C in ((PhaseSpaceData, Component), (JaxPSD, JaxComponent)):
        comps = components(kind, C, rc)
        K = len(comps)
        out.append(PSD(
            components=comps, mixing_xi=np.ones((K, K)),
            mixing_eta=np.ones((K, K)), eps_rf=5.0, box=np.asarray(box, float),
            temperature=1.0, current_time=0.0, mid=np.arange(1, n + 1),
            cid=(np.arange(n) % K).astype(np.int32), r=np.array(r),
            v=np.zeros((n, 3)), q=q.copy(), L=np.zeros((n, 3))))
    pmol, ppp, ptable, pbox = build_scene(out[0], cutoff=rc,
                                          dtype=torch.float64, device="cpu")
    jmol, jpp, jtable, _ = jax_build_scene(out[1], cutoff=rc, dtype=jnp.float64)
    return types.SimpleNamespace(pmol=pmol, ppp=ppp, ptable=ptable, jmol=jmol,
                                 jpp=jpp, jtable=jtable,
                                 box=tuple(float(b) for b in pbox))


def assert_outputs_match(got, want, F_tol=1e-11, s_rtol=1e-10, width=None):
    """(out, u6, uX, myRF) of the port against the JAX kernel's: F, M and
    Vi slot by slot within F_tol of their max, the scalars rtol s_rtol."""
    out = got[0].numpy()
    ref = np.asarray(want[0])
    if width is not None:
        out, ref = out[..., :width], ref[..., :width]
    for tag, sl in (("F", slice(0, 3)), ("M", slice(3, 6)), ("Vi", slice(6, 9))):
        scale = max(np.abs(ref[:, :, sl]).max(), 1e-300)
        np.testing.assert_allclose(out[:, :, sl] / scale, ref[:, :, sl] / scale,
                                   atol=F_tol, rtol=0, err_msg=tag)
    for tag, a, b in zip(("u6", "uX", "myRF"), got[1:], want[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=s_rtol,
                                   atol=1e-300, err_msg=tag)


@pytest.mark.parametrize("kind", ["mix", "2cljq", "water"])
def test_msmeta_matches_jax(kind):
    r, box = lattice(27, 9.0, 2)
    _, ptable, _, jtable, _ = scene(kind, r, box)
    pm, jm = MSMeta(ptable), _MSMeta(jtable)
    assert (pm.K, pm.NL, pm.NC, pm.ND, pm.NQ, pm.P) == \
        (jm.K, jm.NL, jm.NC, jm.ND, jm.NQ, jm.P)
    assert pm.layout == jm.layout
    assert pm.site_rep == jm.site_rep and pm.site_zero == jm.site_zero
    assert pm.tables.keys() == jm.tables.keys() and pm.masks.keys() == jm.masks.keys()
    for k in jm.tables:
        np.testing.assert_array_equal(pm.tables[k], jm.tables[k], k)
    for k in jm.masks:
        np.testing.assert_array_equal(pm.masks[k], jm.masks[k], k)
    assert live_plane_count(pm) == jax_live_plane_count(jm)
    assert hash(pm) == hash(MSMeta(ptable)) and pm == MSMeta(ptable)
    # the site-pair program holds one term per non-zero mask entry
    assert len(pm.terms()) == sum(int(np.sum(m)) for m in pm.masks.values())
    flat, offs = pm.flat_tables()
    for k, v in pm.tables.items():
        np.testing.assert_array_equal(flat[offs[k]:offs[k] + v.size], v.ravel())


def _dense_inputs(kind, n, box, cap, seed=3, alpha=0.0):
    r, box = lattice(n, box, seed)
    pmol, ptable, _, jtable, box = scene(kind, r, box, seed=seed)
    spec = CellGridSpec.create(np.asarray(box), 3.0, cap=cap)
    path = CudaMultiSitePath(ptable, spec, screen_alpha=alpha)
    r_i, _ = path.layout(pmol)
    r_j = path.x_halo(r_i)
    nx, ny, nz = spec.dims
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, box=spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=alpha)
    return r_i, r_j, path.meta, _MSMeta(jtable), kw


def _yz_halo(r_j, box):
    """Explicit halo rows in y and z: the periodic images, shifted where
    valid (what a slab or mesh exchange delivers)."""
    rows = torch.cat([r_j[:, -1:], r_j, r_j[:, :1]], dim=1)
    rows[:, 0, 1] -= box[1] * rows[:, 0, 3]
    rows[:, -1, 1] += box[1] * rows[:, -1, 3]
    rows = torch.cat([rows[-1:], rows, rows[:1]], dim=0)
    rows[0, :, 2] -= box[2] * rows[0, :, 3]
    rows[-1, :, 2] += box[2] * rows[-1, :, 3]
    return rows


@pytest.mark.parametrize("case", ["base", "yz_halo", "cap160"])
def test_k6_plain_matches_jax(case):
    """K6's plain version against multisite_cell_forces_pallas(interpret):
    all seven bodies on the mixture; explicit z + y halo rows on the
    2CLJQ fluid (equal to its wrapped result); the screened water-like
    scene at cap 160, where the TPU kernel chunks its j window (jw)."""
    kind, n, box, cap, alpha = {
        "base": ("mix", 500, 12.0, 32, 0.0),
        "yz_halo": ("2cljq", 300, 9.6, 32, 0.0),
        "cap160": ("water", 343, 9.6, 160, 0.9),
    }[case]
    r_i, r_j, meta, jmeta, kw = _dense_inputs(kind, n, box, cap, alpha=alpha)
    extra, jextra = {}, {}
    if case == "yz_halo":
        wrapped = multisite_cell_forces(r_i, r_j, meta=meta, **kw)
        r_j = _yz_halo(r_j, kw["box"])
        extra = jextra = dict(z_halo=True, y_halo=True)
    if case == "cap160":
        jextra = dict(jw=cap)
    got = multisite_cell_forces(r_i, r_j, meta=meta, **kw, **extra)
    want = jax_k6(jnp.asarray(r_i.numpy()), jnp.asarray(r_j.numpy()), tx=1,
                  meta=jmeta, interpret=True, **kw, **jextra)
    assert_outputs_match(got, want)
    assert float(got[0][:, :, 0:3].abs().max()) > 0
    if case == "yz_halo":
        for a, b in zip(got, wrapped):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def packed_inputs(kind, r, box, cap, seed=3, alpha=0.0):
    pmol, ptable, jmol, jtable, box = scene(kind, r, box, seed=seed)
    spec = CellGridSpec.create(np.asarray(box), 3.0, cap=cap)
    path = CudaMultiSitePackedPath(ptable, spec, screen_alpha=alpha)
    tbl, r_i, r_j, _, _ = path._build_views(pmol)
    nx, ny, nz = spec.dims
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, Wp=path.Wp, Wjp=path.Wjp,
              cell_plane=path.cell_plane, box=spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=alpha)
    return (tbl, r_i, r_j), path, _MSMeta(jtable), kw


@pytest.mark.parametrize("case", ["mix", "water", "multitile_z_halo"])
def test_k5_plain_matches_jax(case):
    """K5's plain version against multisite_cell_forces_packed(interpret)
    on the mixture, on the screened water-like scene, and on an elongated
    box whose rows hold more than 128 molecules (several i tiles) under
    z_halo with z-inhomogeneous row counts: the inner z rows of a
    periodic packed build against all of its rows as explicit halo
    rows."""
    if case == "multitile_z_halo":
        r, box = lattice(2600, (36.0, 9.6, 12.0), 5, thin_upper_z=0.4)
        kind, cap, alpha = "mix", 48, 0.0
    else:
        r, box = lattice(343, 9.6, 3)
        kind, cap, alpha = case, 32, (0.9 if case == "water" else 0.0)
    (tbl, r_i, r_j), path, jmeta, kw = packed_inputs(kind, r, box, cap,
                                                     alpha=alpha)
    if case == "multitile_z_halo":
        counts = (r_i[:, :, 3] > 0.5).sum(-1)
        assert int(counts.max()) > 128 and path.Wp // 128 >= 3
        assert int(counts[1].max()) != int(counts[2].max())
        r_i = r_i[1:-1].contiguous()
        kw.update(nz=kw["nz"] - 2, z_halo=True)
    got = multisite_cell_forces_packed(tbl, r_i, r_j, meta=path.meta, **kw)
    want = jax_k5(jnp.asarray(tbl.numpy()), jnp.asarray(r_i.numpy()),
                  jnp.asarray(r_j.numpy()), meta=jmeta, interpret=True, **kw)
    assert_outputs_match(got, want)


def test_wrappers_check_their_inputs():
    """A wrapper raises on inputs its kernel does not take; a CPU tensor
    runs the plain version (no launch is counted)."""
    r, box = lattice(200, 9.0, 1)
    (tbl, r_i, r_j), path, _, kw = packed_inputs("2cljq", r, box, 32)
    n0 = multisite_cell_forces_packed.launches
    multisite_cell_forces_packed(tbl, r_i, r_j, meta=path.meta, **kw)
    assert multisite_cell_forces_packed.launches == n0
    with pytest.raises(ValueError, match="tbl"):
        multisite_cell_forces_packed(tbl.long(), r_i, r_j, meta=path.meta, **kw)
    with pytest.raises(ValueError, match="planes"):
        multisite_cell_forces_packed(tbl, r_i[:, :, :8], r_j[:, :, :8],
                                     meta=path.meta, **kw)
    with pytest.raises(ValueError, match=">= 3"):
        multisite_cell_forces_packed(tbl[:2], r_i[:2], r_j[:2], meta=path.meta,
                                     **dict(kw, nz=2))
    r_i, r_j, meta, _, kw = _dense_inputs("2cljq", 200, 9.0, 32)
    with pytest.raises(TypeError, match="dtype"):
        multisite_cell_forces(r_i.int(), r_j.int(), meta=meta, **kw)
    with pytest.raises(ValueError, match="shape"):
        multisite_cell_forces(r_i, r_j, meta=meta, **dict(kw, z_halo=True))
