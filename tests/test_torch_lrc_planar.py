"""The port's planar slab correction (ls1_mardyn_tpu_torch/ops/lrc_planar.py)
against the JAX package's (ls1_mardyn_tpu/ops/lrc_planar.py), f64 on the
CPU: the slab kernels W, dW and the per-site Ws, dWs bit-identical; the
per-site forces, torques and energy (forces_torques) and the COM mode
(_call_com) equal to JAX's to rounding on the scenes of tests/test_lrc.py
(a bulk fluid, a 1CLJ liquid slab in vapour, a tilted 2CLJ dumbbell at
the interface), and the physics those tests check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.generators import cubic_grid as jax_cubic_grid
from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu.models.components import ComponentTable as JaxTable
from ls1_mardyn_tpu.ops.lrc_planar import PlanarLRC as JaxPlanarLRC
from ls1_mardyn_tpu.scene import build_scene as jax_build_scene
from ls1_mardyn_tpu.state import MoleculeState as JaxMol
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.ops.lrc import HomogeneousLRC
from ls1_mardyn_tpu_torch.ops.lrc_planar import PlanarLRC
from ls1_mardyn_tpu_torch.scene import build_scene
from ls1_mardyn_tpu_torch.state import MoleculeState
from test_torch_ewald import rel

torch.set_num_threads(1)


def _grid_scene(n, box, seed, shift_y=0.0, full_box=None):
    """A cubic_grid fluid in both packages (optionally shifted along y
    into a larger box): (port mol, table, box), (JAX mol, table, box)."""
    out = []
    for gen, build, kw in ((cubic_grid, build_scene, dict(dtype=torch.float64,
                                                          device="cpu")),
                           (jax_cubic_grid, jax_build_scene,
                            dict(dtype=jnp.float64))):
        data = gen(n, box, 1.0, seed=seed)
        data.r[:, 1] += shift_y
        if full_box is not None:
            data.box = np.asarray(full_box, float)
        mol, _pp, table, b = build(data, cutoff=2.5, **kw)
        out.append((mol, table, b))
    return out


def _dumbbell_scene():
    """tests/test_lrc.py's liquid slab of 2CLJ dumbbells plus one tilted
    probe above the interface, in both packages."""
    rc, Lx, Ly, Lz = 2.5, 10.0, 30.0, 10.0
    rng = np.random.default_rng(8)
    n = int(0.7 * Lx * Lz * 10.0)
    r = rng.uniform(0, 1, (n, 3)) * np.array([Lx, 10.0, Lz])
    r[:, 1] += 10.0
    a = np.pi / 4
    allr = np.vstack([r, [[5.0, 21.2, 5.0]]])
    allq = np.vstack([np.tile([1.0, 0, 0, 0], (n, 1)),
                      [[np.cos(a / 2), np.sin(a / 2), 0.0, 0.0]]])
    out = []
    for C, T, M, kw in ((Component, ComponentTable, MoleculeState,
                         dict(dtype=torch.float64, device="cpu")),
                        (JaxComponent, JaxTable, JaxMol, dict(dtype=jnp.float64))):
        c = C(cid=0)
        c.add_ljcenter(0, 0, 0.5, 0.5, 1.0, 1.0, rc, False)
        c.add_ljcenter(0, 0, -0.5, 0.5, 1.0, 1.0, rc, False)
        mol = M.from_numpy(r=allr, v=np.zeros_like(allr), q=allq, **kw)
        out.append((mol, T([c], cutoff=rc, lj_cutoff=rc), np.array([Lx, Ly, Lz])))
    return out, n


def _both(port, jax_, nslabs, per_site=True):
    (mol, table, box), (jmol, jtable, jbox) = port, jax_
    pl = PlanarLRC(table, box, nslabs=nslabs, axis=1, per_site=per_site, device="cpu")
    jpl = JaxPlanarLRC(jtable, jbox, nslabs=nslabs, axis=1, per_site=per_site)
    for name in ("W", "dW", "Ws", "dWs"):
        assert np.array_equal(getattr(pl, name), getattr(jpl, name)), name
    return pl, jpl, mol, jmol


def _check_forces_torques(pl, jpl, mol, jmol):
    F, M, u, _ = pl.forces_torques(mol)
    jF, jM, ju, _ = jpl.forces_torques(jmol)
    assert rel(float(u), float(ju)) < 1e-12
    assert rel(F.numpy(), jF) < 1e-12
    assert np.abs(M.numpy() - np.asarray(jM)).max() <= 1e-12 * max(
        np.abs(np.asarray(jM)).max(), 1.0)
    Fc, uc, _ = pl._call_com(mol)
    jFc, juc, _ = jpl._call_com(jmol)
    assert rel(float(uc), float(juc)) < 1e-12
    assert rel(Fc.numpy(), jFc) < 1e-12
    return F, M, u


def test_planar_bulk_reduces_to_homogeneous():
    n, rho = 2000, 0.6
    L = (n / rho) ** (1 / 3)
    port, jax_ = _grid_scene(n, [L, L, L], seed=42)
    pl, jpl, mol, jmol = _both(port, jax_, nslabs=200)
    F, _M, u = _check_forces_torques(pl, jpl, mol, jmol)
    hom = HomogeneousLRC(port[1], [n], L ** 3)
    np.testing.assert_allclose(float(u), hom.upot_corr, rtol=2e-2)
    np.testing.assert_allclose(F.numpy().mean(axis=0), 0.0,
                               atol=1e-3 * abs(hom.upot_corr) / n)


def test_planar_forces_point_into_liquid_slab():
    Lx = Lz = 10.0
    n = int(0.7 * Lx * Lz * 10.0)
    port, jax_ = _grid_scene(n, [Lx, 10.0, Lz], seed=2, shift_y=10.0,
                             full_box=[Lx, 30.0, Lz])
    pl, jpl, mol, jmol = _both(port, jax_, nslabs=120)
    F, M, u = _check_forces_torques(pl, jpl, mol, jmol)
    Fy, y = F.numpy()[:, 1], mol.r.numpy()[:, 1]
    assert Fy[(y > 10.0) & (y < 10.8)].mean() > 0
    assert Fy[(y > 19.2) & (y < 20.0)].mean() < 0
    assert float(u) < 0
    # single-site: the per-site and COM modes agree, no torque
    Fc, uc, _ = pl._call_com(mol)
    np.testing.assert_allclose(float(uc), float(u), rtol=1e-12)
    np.testing.assert_allclose(Fc.numpy(), F.numpy(), atol=1e-12)
    np.testing.assert_allclose(M.numpy(), 0.0, atol=1e-14)


@pytest.mark.parametrize("per_site", [True, False])
def test_planar_dumbbell_torque_at_interface(per_site):
    (port, jax_), n = _dumbbell_scene()
    pl, jpl, mol, jmol = _both(port, jax_, nslabs=120, per_site=per_site)
    F, M, _u = _check_forces_torques(pl, jpl, mol, jmol)
    Fp, u_call, _ = pl(mol)
    jFp, ju_call, _ = jpl(jmol)
    assert rel(Fp.numpy(), jFp) < 1e-12
    assert rel(float(u_call), float(ju_call)) < 1e-12
    Mp = M.numpy()[n]
    assert F.numpy()[n, 1] < 0  # pulled toward the liquid below
    assert abs(Mp[0]) > 1e-8
    assert abs(Mp[1]) < 1e-12 and abs(Mp[2]) < 1e-12
