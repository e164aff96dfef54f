"""Kernels K3 and K4: their plain PyTorch versions
(ls1_mardyn_tpu_torch/ops/cuda_lj.py: lj_cell_forces_cw,
lj_cell_forces_row) against the JAX TPU kernels
lj_cell_forces_pallas_cw and lj_cell_forces_pallas in interpret mode,
and the force path CudaLJPath against PallasLJPath; f64 on the CPU.

The planes are those of tests/test_pallas_lj.py::
test_pallas_lj_cw_matches_row_kernel (random cell-local coordinates,
slots >= 20 of each cell empty, zeros or the y sentinel).  Tolerances
are the JAX kernel tests': forces atol 1e-12 after scaling by max|F|
(the same pair terms summed in another order, and r_i - (r_j + shift)
against (r_i - r_j) + shift), u6 and virial rtol 1e-11; the path 1e-13
of max|F| and rtol 1e-12.  The JAX row kernel runs with tx=1: it pairs
an i slot with its whole (tx+2)-cell window, the port with +-1 cell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.generators import cubic_grid
from ls1_mardyn_tpu.models.components import Component
from ls1_mardyn_tpu.ops.cells import CellGridSpec as JSpec
from ls1_mardyn_tpu.ops.pallas_lj import (
    SENTINEL_SCALE,
    lj_cell_forces_pallas,
    lj_cell_forces_pallas_cw,
)
from ls1_mardyn_tpu.ops.pallas_path import PallasLJPath
from ls1_mardyn_tpu.scene import build_scene
from ls1_mardyn_tpu_torch.interop import molecule_state_from_numpy, pair_params_from_numpy
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops import cuda_lj
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw, lj_cell_forces_row
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

CAP, CL = 32, 2.8
LJ = dict(eps24=24.0, sig2=1.0, shift6=0.1, rc2=2.5 ** 2)


def _planes(dims, sentinel=False, seed=5, rows=None):
    """[nz(rows), ny, 4, nx*cap] numpy planes in cell-local coordinates."""
    nx, ny, nz = dims
    nz = rows or nz
    W = nx * CAP
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, CL, size=(nz, ny, 3, W))
    slot = np.arange(W) % CAP
    invalid = slot >= 20
    fill = SENTINEL_SCALE * (1.0 + slot) if sentinel else 0.0
    r[:, :, 1, :] = np.where(invalid[None, None], fill, r[:, :, 1, :])
    r[:, :, 0, :] = np.where(invalid[None, None], 0.0, r[:, :, 0, :])
    r[:, :, 2, :] = np.where(invalid[None, None], 0.0, r[:, :, 2, :])
    w = np.broadcast_to(np.where(invalid, 0.0, 1.0), (nz, ny, W))
    return np.concatenate([r, w[:, :, None, :]], axis=2)


def _xhalo(a, nx, left, right, shift=0.0):
    """x halo of `left` cells before and `right` cells after, periodic
    copies shifted by -+shift in x where valid (absolute mode)."""
    lo = a[..., (nx - left) * CAP:].copy()
    hi = a[..., : right * CAP].copy()
    lo[:, :, 0] -= shift * lo[:, :, 3]
    hi[:, :, 0] += shift * hi[:, :, 3]
    return np.concatenate([lo, a, hi], axis=-1)


def _absolute(a, dims):
    """Cell-local planes -> absolute coordinates (valid slots only)."""
    nx, ny, nz = dims
    out = a.copy()
    w = a[:, :, 3]
    out[:, :, 0] += (np.arange(nx * CAP) // CAP) * CL * w
    out[:, :, 1] += (np.arange(a.shape[1]) * CL)[None, :, None] * w
    out[:, :, 2] += (np.arange(a.shape[0]) * CL)[:, None, None] * w
    return out


def _box(dims):
    return tuple(d * CL for d in dims)


def _assert_same(port, jax_out, planes=3):
    fp, u6p, virp = port
    out, u6j, virj = jax_out
    out = np.asarray(out)
    fj = out[:, :, :3] if planes == 3 else out[:, :, [0, 1, 2, 4, 5, 6]]
    assert tuple(fp.shape) == fj.shape
    scale = np.abs(fj[:, :, :3]).max()
    np.testing.assert_allclose(fp.numpy() / scale, fj / scale, atol=1e-12)
    np.testing.assert_allclose(float(u6p), float(u6j), rtol=1e-11)
    np.testing.assert_allclose(float(virp), float(virj), rtol=1e-11)


def _jax_kw(dims, tx, sentinel=False):
    nx, ny, nz = dims
    return dict(nx=nx, ny=ny, nz=nz, cap=CAP, tx=tx, box=_box(dims),
                interpret=True, compute_macro=True, sentinel=sentinel,
                fast_recip=False, **LJ)


@pytest.mark.parametrize(
    "dims,sentinel,vi,z_halo",
    [
        ((4, 4, 4), False, False, False),
        ((4, 4, 4), True, False, False),
        ((4, 4, 4), False, True, False),
        ((4, 3, 3), False, False, True),
        ((4, 2, 3), False, False, False),  # two offsets reach one y row
    ],
    ids=["plain", "sentinel", "vi", "z_halo", "ny2"],
)
def test_cw_reference_matches_jax_cw(dims, sentinel, vi, z_halo):
    nx, ny, nz = dims
    r_i = _planes(dims, sentinel)
    # explicit z halo rows are NOT the periodic images: other molecules
    src = _planes(dims, sentinel, seed=9, rows=nz + 2) if z_halo else r_i
    if z_halo:
        src[1:-1] = r_i
    r_j = _xhalo(src, nx, 1, 3)
    jout = lj_cell_forces_pallas_cw(
        jnp.asarray(r_i), jnp.asarray(r_j), z_halo=z_halo, compute_vi=vi,
        **_jax_kw(dims, tx=4, sentinel=sentinel))
    port = lj_cell_forces_cw(
        torch.as_tensor(r_i), torch.as_tensor(src) if z_halo else None,
        dims=dims, cap=CAP, cell_len=(CL,) * 3, z_halo=z_halo, compute_vi=vi,
        **LJ)
    _assert_same(port, jout, planes=6 if vi else 3)
    if vi:
        # the per-slot virial sums to the global one
        np.testing.assert_allclose(float(port[0][:, :, 3:].sum()),
                                   float(port[2]), rtol=1e-11)


@pytest.mark.parametrize(
    "dims,local,sentinel,z_halo,y_halo",
    [
        ((4, 4, 4), True, False, False, False),
        ((4, 4, 4), True, True, False, False),
        ((4, 4, 4), False, False, False, False),
        ((4, 3, 3), False, False, True, False),
        ((4, 3, 3), False, False, False, True),
        ((2, 3, 3), True, False, False, False),
    ],
    ids=["local", "local-sentinel", "absolute", "z_halo", "y_halo", "nx2"],
)
def test_row_reference_matches_jax_row(dims, local, sentinel, z_halo, y_halo):
    nx, ny, nz = dims
    box = _box(dims)
    r_i = _planes(dims, sentinel)
    if local:
        r_j = _xhalo(r_i, nx, 1, 1)
    else:
        # absolute coordinates; explicit halo rows hold other molecules,
        # already at the positions the exchange would give them
        rows = _planes((nx, ny + 2 * y_halo, nz), seed=9, rows=nz + 2 * z_halo)
        rows[z_halo:z_halo + nz, y_halo:y_halo + ny] = r_i
        rows = _absolute(rows, dims)
        rows[:, :, 1] -= y_halo * CL * rows[:, :, 3]
        rows[:, :, 2] -= z_halo * CL * rows[:, :, 3]
        r_i = rows[z_halo:z_halo + nz, y_halo:y_halo + ny].copy()
        r_j = _xhalo(rows, nx, 1, 1, shift=box[0])
    jout = lj_cell_forces_pallas(
        jnp.asarray(r_i), jnp.asarray(r_j), local_coords=local, hx=1,
        jt=sentinel, z_halo=z_halo, y_halo=y_halo,
        **_jax_kw(dims, tx=1, sentinel=sentinel))
    port = lj_cell_forces_row(
        torch.as_tensor(r_i), torch.as_tensor(r_j), dims=dims, cap=CAP,
        box=box, local_coords=local, z_halo=z_halo, y_halo=y_halo,
        sentinel=sentinel, **LJ)
    _assert_same(port, jout)


def test_cw_and_row_wrappers_check_their_inputs():
    r = torch.zeros((4, 4, 4, 4 * CAP), dtype=torch.float64)
    kw = dict(cap=CAP, **LJ)
    before = (cuda_lj.lj_cell_forces_cw.launches,
              cuda_lj.lj_cell_forces_row.launches)
    with pytest.raises(ValueError, match="nx >= 3"):
        lj_cell_forces_cw(r[..., : 2 * CAP], dims=(2, 4, 4),
                          cell_len=(CL,) * 3, **kw)
    with pytest.raises(ValueError, match="cutoff"):
        lj_cell_forces_cw(r, dims=(4, 4, 4), cell_len=(2.0,) * 3, **kw)
    with pytest.raises(ValueError, match="z_halo"):
        lj_cell_forces_cw(r, dims=(4, 4, 4), cell_len=(CL,) * 3, z_halo=True,
                          **kw)
    with pytest.raises(ValueError, match="cutoff"):
        lj_cell_forces_row(r, torch.zeros((4, 4, 4, 6 * CAP),
                                          dtype=torch.float64),
                           dims=(4, 4, 4), box=(8.0,) * 3, **kw)
    with pytest.raises(ValueError, match="shape"):
        lj_cell_forces_row(r, r, dims=(4, 4, 4), box=_box((4, 4, 4)), **kw)
    with pytest.raises(TypeError):
        lj_cell_forces_cw(r.to(torch.int32), dims=(4, 4, 4),
                          cell_len=(CL,) * 3, **kw)
    # a CPU tensor runs the plain version and counts no launch
    lj_cell_forces_cw(r, dims=(4, 4, 4), cell_len=(CL,) * 3, **kw)
    assert before == (cuda_lj.lj_cell_forces_cw.launches,
                      cuda_lj.lj_cell_forces_row.launches)


def _scene(n, rho, cutoff, shifted, seed=3, dtype=jnp.float64):
    L = (n / rho) ** (1.0 / 3.0)
    comps = None
    if shifted:
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.3, 0.9, cutoff, True)
        comps = [c]
    data = cubic_grid(n, [L, L, L], 1.0, components=comps, seed=seed)
    mol, pp, table, box = build_scene(data, cutoff=cutoff, dtype=dtype)
    return data, mol, pp, table, np.asarray(box)


def _port_scene(data, mol, pp, cutoff, dtype=None):
    table = ComponentTable(data.components, mixing_xi=data.mixing_xi,
                           mixing_eta=data.mixing_eta, eps_rf=data.eps_rf,
                           cutoff=cutoff, lj_cutoff=cutoff)
    pmol = molecule_state_from_numpy(
        {k: np.asarray(getattr(mol, k)) for k in
         ("r", "v", "q", "L", "cid", "mid", "valid")}, dtype=dtype)
    ppp = pair_params_from_numpy(
        {k: np.asarray(v) for k, v in vars(pp).items()}, dtype=dtype)
    return table, pmol, ppp


@pytest.mark.parametrize(
    "n,rho,cutoff,cap,shifted",
    [(500, 0.55, 2.5, 32, False), (500, 0.55, 2.5, 32, True),
     (193, 0.2, 3.0, 64, False)],
    ids=["unshifted", "shifted", "partial-occupancy"],
)
def test_lj_path_matches_pallas_lj_path(n, rho, cutoff, cap, shifted):
    data, mol, pp, jtable, box = _scene(n, rho, cutoff, shifted)
    jspec = JSpec.create(box, cutoff, cap=cap)
    jf, jm, jovf = jax.jit(PallasLJPath(jtable, jspec, interpret=True).__call__)(mol)
    table, pmol, _ = _port_scene(data, mol, pp, cutoff)
    path = CudaLJPath(table, CellGridSpec.create(box, cutoff, cap=cap))
    assert path.spec.dims == jspec.dims and path.cw
    pf, pm, povf = path(pmol)
    scale = np.abs(np.asarray(jf.F)).max()
    np.testing.assert_allclose(pf.F.numpy() / scale, np.asarray(jf.F) / scale,
                               atol=1e-13)
    np.testing.assert_allclose(float(pm.upot6lj), float(jm.upot6lj), rtol=1e-12)
    np.testing.assert_allclose(float(pm.virial), float(jm.virial), rtol=1e-12)
    assert bool(povf) == bool(jovf)
    assert float(pf.M.abs().max()) == 0.0


def test_lj_path_row_kernel_on_two_x_cells():
    """nx = 2 takes the row kernel K4 (cw off); same forces as the N^2
    oracle."""
    data, mol, pp, _, box = _scene(260, 0.5, 2.5, False)
    box = box * np.array([5.2 / box[0], 1.0, 1.0])
    table, pmol, ppp = _port_scene(data, mol, pp, 2.5)
    pmol.r[:, 0] *= 5.2 / float(np.asarray(mol.r)[:, 0].max() + 1.0)
    path = CudaLJPath(table, CellGridSpec.create(box, 2.5, cap=64))
    assert path.spec.dims[0] == 2 and not path.cw
    pf, pm, _ = path(pmol)
    of, om = compute_forces_n2(pmol, ppp, box, images=1)
    scale = float(of.F.abs().max())
    np.testing.assert_allclose(pf.F.numpy() / scale, of.F.numpy() / scale,
                               atol=1e-12)
    np.testing.assert_allclose(float(pm.upot6lj), float(om.upot6lj), rtol=1e-11)


def test_lj_path_sentinel_f32_large_cap():
    """f32 at cap 128 against the N^2 oracle on the same f32 state: no
    empty slot may come inside the cutoff through the f32 rounding of
    the cell-edge shift (the scene and the 2e-6 of max|F| of tests/test_pallas_lj.py::
    test_pallas_lj_sentinel_f32_large_cap: f32 rounding of the ~100 pair
    terms per molecule, summed in another order)."""
    n, rho, cutoff = 343, 0.55, 2.5
    L = (n / rho) ** (1.0 / 3.0)
    data = cubic_grid(n, [L, L, L], 1.1, seed=0)
    mol, pp, _, box = build_scene(data, cutoff=cutoff, dtype=jnp.float32)
    box = np.asarray(box, np.float64)
    table, pmol, ppp = _port_scene(data, mol, pp, cutoff)
    assert pmol.r.dtype == torch.float32
    path = CudaLJPath(table, CellGridSpec.create(box, cutoff, cap=128))
    # a scene on which the JAX layout writes its far-away fill; the
    # port's layout leaves empty slots at zero and the kernels mask them
    assert cuda_lj.sentinel_eligible(path.spec.cell_len, path.rc2, 128)
    pf, pm, _ = path(pmol)
    of, om = compute_forces_n2(pmol, ppp, box, images=1)
    assert bool(torch.isfinite(pf.F).all())
    scale = float(of.F.abs().max())
    np.testing.assert_allclose(pf.F.numpy() / scale, of.F.numpy() / scale,
                               atol=2e-6)
    np.testing.assert_allclose(float(pm.upot), float(om.upot), rtol=1e-5)
