"""The multi-site force paths of the port (ops/ms_path.CudaMultiSitePath,
K6; ops/cuda_ms_packed.CudaMultiSitePackedPath, K5) and their host side
against the JAX package's, f64 on the CPU: the packed views (cell-start
table, packed i rows, head-halo j rows, prefix) bit for bit, the grid
choosers, a periodic-wrap stress of the packed rows at several caps,
and both paths against the JAX paths (Pallas kernels in interpret mode)
and the port's N^2 oracle.

Tolerances (the JAX tests' own): paths against JAX and the oracle within
1e-11 of max|F| / max|M|, energies rtol 1e-10; packed against dense
within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops.cells import CellGridSpec as JaxSpec
from ls1_mardyn_tpu.ops.pallas_ms_packed import (
    PallasMultiSitePackedPath,
    pack_dense_rows as jax_pack_dense_rows,
    pick_ms_grid_packed as jax_pick_packed,
)
from ls1_mardyn_tpu.ops.pallas_ms_path import PallasMultiSitePath
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
    CudaMultiSitePackedPath,
    pack_dense_rows,
    pick_ms_grid_packed,
)
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath, pick_ms_grid
from test_torch_ms_kernels import lattice, scene_pp

torch.set_num_threads(1)


def clustered(n, L, seed):
    """Half the molecules in one octant: uneven occupancy, multi-tile
    rows, empty cells (positions only)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, L / 2, (n // 2, 3)),
                           rng.uniform(0, L, (n - n // 2, 3))]), np.full(3, L)


def wrap_biased(n, L, seed):
    """Molecules crowded at the x faces of a 3x3x3 grid: wrap pairs
    dominate (the JAX wrap-halo test's scene)."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random(n) < 0.5, rng.random(n) * 0.08 * L,
                 L * (1 - rng.random(n) * 0.08))
    return np.stack([x, rng.random(n) * L, rng.random(n) * L], 1), np.full(3, L)


@pytest.mark.parametrize("case", ["clustered", "wrap3"])
def test_packed_views_bit_identical_to_jax(case):
    """_build_views (tbl, r_i, r_j, prefix) and pack_dense_rows give the
    JAX package's arrays bit for bit (the port keeps planes first)."""
    r, box = clustered(1400, 16.0, 11) if case == "clustered" else \
        wrap_biased(400, 9.5, 7)
    s = scene_pp("ions" if case == "wrap3" else "mix", r, box)
    cap = 64 if case == "clustered" else 128
    spec = CellGridSpec.create(np.asarray(s.box), 3.0, cap=cap)
    path = CudaMultiSitePackedPath(s.ptable, spec)
    jpath = PallasMultiSitePackedPath(
        s.jtable, JaxSpec.create(np.asarray(s.box), 3.0, cap=cap), interpret=True)
    tbl, r_i, r_j, _, prefix = path._build_views(s.pmol)
    # eagerly: under jit XLA fuses the rotation's products into FMAs,
    # which moves the last bit of some site planes
    want = [jpath._build_views(s.jmol)[k] for k in (0, 1, 2, 4)]
    for name, a, b in zip(("tbl", "r_i", "r_j", "prefix"),
                          (tbl, r_i, r_j, prefix), want):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    if case == "clustered":
        assert int((r_i[:, :, 3] > 0.5).sum(-1).max()) > 128
    # the dense rows of the same state, packed
    dense = CudaMultiSitePath(s.ptable, spec)
    g, _ = dense.layout(s.pmol)
    nx, ny, nz = spec.dims
    g = g.reshape(nz * ny, g.shape[2], -1)
    got = pack_dense_rows(g, nx, cap, spec.box[0], path.cell_plane, path.Wp,
                          path.Wjp)
    want = jax_pack_dense_rows(jnp.asarray(g.permute(0, 2, 1).numpy()), nx, cap,
                               spec.box[0], path.cell_plane, path.Wp, path.Wjp)
    for name, a, b in zip(("gi", "gj", "tbl", "prefix"), got, want):
        b = np.asarray(b)
        if a.dim() == 3:
            b = np.moveaxis(b, -1, 1)
        np.testing.assert_array_equal(a.numpy(), b, name)


def test_grid_choosers():
    """pick_ms_grid_packed gives the JAX package's grid and cap (the
    JAX version also returns its TPU lane estimate); pick_ms_grid is
    admissible (cell edge >= rc) and never dearer than floor(box / rc)
    at the same capacity rule."""
    for r, box, rc in (clustered(2000, 20.0, 3) + (3.0,),
                       lattice(3000, (24.0, 15.0, 31.0), 4) + (2.5,),
                       wrap_biased(400, 9.5, 7) + (3.0,)):
        got = pick_ms_grid_packed(r, box, rc)
        want = jax_pick_packed(r, box, rc)
        assert got == want[:2]
        dims, cap = pick_ms_grid(r, box, rc)
        assert all(b / d >= rc for b, d in zip(box, dims))
        floor_dims = tuple(int(b // rc) for b in box)
        idx = [np.minimum((r[:, a] * floor_dims[a] / box[a]).astype(int),
                          floor_dims[a] - 1) for a in range(3)]
        occ_f = np.bincount((idx[2] * floor_dims[1] + idx[1]) * floor_dims[0]
                            + idx[0]).max()
        cap_f = -(-max(32, int(np.ceil(1.5 * occ_f))) // 8) * 8
        assert np.prod(dims) * cap ** 2 <= np.prod(floor_dims) * cap_f ** 2
        assert cap % 8 == 0 and cap >= 1.5 * np.bincount(
            (np.minimum((r[:, 2] * dims[2] / box[2]).astype(int), dims[2] - 1)
             * dims[1] + np.minimum((r[:, 1] * dims[1] / box[1]).astype(int),
                                    dims[1] - 1)) * dims[0]
            + np.minimum((r[:, 0] * dims[0] / box[0]).astype(int), dims[0] - 1)
        ).max()


def _forces(path, mol):
    f, m, ovf = path(mol)
    assert not bool(ovf)
    return f, m


def _assert_same(f, m, f_ref, m_ref, tol, e_rtol):
    for name in ("F", "M", "Vi"):
        a = np.asarray(getattr(f, name))
        b = np.asarray(getattr(f_ref, name))
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a / scale, b / scale, atol=tol, rtol=0,
                                   err_msg=name)
    for name in ("upot6lj", "upot_xpoles", "virial", "my_rf"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(m_ref, name)), rtol=e_rtol,
                                   atol=1e-300, err_msg=name)


@pytest.mark.parametrize("cap", [64, 96, 128, 160])
def test_wrap_halo_stress(cap):
    """The head-halo layout on a 3x3x3 grid whose molecules crowd the x
    faces: the packed path counts every wrap pair once at every cap
    (the TPU kernel's head walk needs cap <= 128), against the dense
    path (1e-12) and the N^2 oracle (1e-11); against the JAX packed path
    at cap 128."""
    r, box = wrap_biased(400, 9.5, 7)
    s = scene_pp("ions", r, box)
    spec = CellGridSpec.create(np.asarray(s.box), 3.0, cap=cap)
    assert spec.dims == (3, 3, 3)
    fp, mp = _forces(CudaMultiSitePackedPath(s.ptable, spec), s.pmol)
    fd, md = _forces(CudaMultiSitePath(s.ptable, spec), s.pmol)
    _assert_same(fp, mp, fd, md, 1e-12, 1e-12)
    fo, mo = compute_forces_n2(s.pmol, s.ppp, s.box)
    _assert_same(fp, mp, fo, mo, 1e-11, 1e-10)
    if cap == 128:
        jpath = PallasMultiSitePackedPath(
            s.jtable, JaxSpec.create(np.asarray(s.box), 3.0, cap=cap),
            interpret=True)
        fj, mj, _ = jax.jit(jpath.__call__)(s.jmol)
        _assert_same(fp, mp, fj, mj, 1e-11, 1e-10)


def test_paths_match_jax_and_oracle():
    """Both paths on a clustered 2CLJQ fluid against the JAX package's
    dense and packed paths and the port's N^2 oracle."""
    r, box = clustered(600, 14.0, 5)
    s = scene_pp("2cljq", r, box)
    spec = CellGridSpec.create(np.asarray(s.box), 3.0, cap=64)
    jspec = JaxSpec.create(np.asarray(s.box), 3.0, cap=64)
    fo, mo = compute_forces_n2(s.pmol, s.ppp, s.box)
    got = {}
    for key, cls, jcls in (("dense", CudaMultiSitePath, PallasMultiSitePath),
                           ("packed", CudaMultiSitePackedPath,
                            PallasMultiSitePackedPath)):
        f, m = _forces(cls(s.ptable, spec), s.pmol)
        fj, mj, _ = jax.jit(jcls(s.jtable, jspec, interpret=True).__call__)(s.jmol)
        _assert_same(f, m, fj, mj, 1e-11, 1e-10)
        _assert_same(f, m, fo, mo, 1e-11, 1e-10)
        got[key] = (f, m)
    _assert_same(*got["packed"], *got["dense"], 1e-12, 1e-12)
    assert float(got["packed"][0].M.abs().max()) > 0
