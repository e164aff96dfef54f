"""Direct Ewald summation of the port (ls1_mardyn_tpu_torch/ops/ewald.py)
against the JAX package's (ls1_mardyn_tpu/ops/ewald.py), f64 on the CPU,
at the JAX tests' tolerances (tests/test_ewald.py): the NaCl Madelung
constant, independence of the alpha split, forces against the energy
gradient; the k-vector and coefficient tables and the tuned parameters
bit-identical; the reciprocal energy, forces and torques of rigid
three-charge molecules equal to the JAX function's to rounding.

The real-space half is the port's own N^2 oracle with screen_alpha
(models/oracle.compute_forces_n2): the same erfc pair sum the driver
hands to every pair path; through the driver, K5's path (its plain
version here) carries the solver's alpha and agrees with the plain
traversal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu.models.components import ComponentTable as JaxTable
from ls1_mardyn_tpu.models.interaction import PairParams as JaxPP
from ls1_mardyn_tpu.ops import ewald as jax_ewald
from ls1_mardyn_tpu.state import MoleculeState as JaxMol
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops import ewald
from ls1_mardyn_tpu_torch.ops.ewald import (
    EwaldParams,
    EwaldSolver,
    make_kvectors,
    reciprocal_energy_forces,
)
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from ls1_mardyn_tpu_torch.state import MoleculeState
from test_ewald import MADELUNG_NACL, _nacl

torch.set_num_threads(1)

# SPC/E-like water scaled to sigma = 1 (tools/bench_ms.py: h2o_scene)
WATER_Q = ((0.0, 0.0, 0.0, -0.8476), (0.316, 0.245, 0.0, 0.4238),
           (-0.316, 0.245, 0.0, 0.4238))


def ion_components(C, lj=False):
    """+1 and -1 point charges at the COM (with a small LJ core for the
    driver's molten salt)."""
    comps = []
    for sign in (1.0, -1.0):
        c = C(cid=len(comps))
        if lj:
            c.add_ljcenter(0, 0, 0, 1.0, 0.2, 1.0)
        c.add_charge(0.0, 0.0, 0.0, 0.0 if lj else 1.0, sign)
        comps.append(c)
    return comps


def water_component(C):
    c = C(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
    for x, y, z, q in WATER_Q:
        c.add_charge(x, y, z, 0.0 if q < 0 else 0.01, q)
    return c


def scene(comps_of, r, cid, box, rc, q=None):
    """The same molecules in both packages: (port mol, port pp, JAX mol,
    JAX pp), f64."""
    table = ComponentTable(comps_of(Component), cutoff=rc, lj_cutoff=rc)
    jtable = JaxTable(comps_of(JaxComponent), cutoff=rc, lj_cutoff=rc)
    kw = dict(r=r, v=np.zeros_like(r), q=q, cid=np.asarray(cid, np.int32))
    mol = MoleculeState.from_numpy(dtype=torch.float64, device="cpu", **kw)
    pp = PairParams.from_table(table, dtype=torch.float64, device="cpu")
    jmol = JaxMol.from_numpy(dtype=jnp.float64, **kw)
    jpp = JaxPP.from_table(jtable, dtype=jnp.float64)
    return mol, pp, jmol, jpp


def charge_scene(r, signs, box, rc):
    return scene(ion_components, r, np.where(signs > 0, 0, 1), box, rc)


def water_scene(n, box, seed=0, rc=2.5):
    """n rigid waters at random positions and orientations."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, box, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return scene(lambda C: [water_component(C)], r, np.zeros(n), np.full(3, box),
                 rc, q=q)


def real_space(mol, pp, box, alpha):
    """(u, F) of the erfc-screened real-space pair sum (the oracle)."""
    forces, macro = compute_forces_n2(mol, pp, box, screen_alpha=alpha)
    return float(macro.upot_xpoles), forces.F.numpy()


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_madelung_constant_nacl():
    r, q, box = _nacl(cells=4, d=1.0)
    mol, pp, jmol, jpp = charge_scene(r, q, box, 1.9)
    params = EwaldParams(alpha=2.0, kmax=12)
    u_k, F_k, M_k = EwaldSolver(box, params, device="cpu")(mol, pp)
    ju, jF, jM = jax_ewald.EwaldSolver(box, jax_ewald.EwaldParams(2.0, 12),
                                       dtype=jnp.float64)(jmol, jpp)
    assert abs(float(u_k) - float(ju)) <= 1e-12 * abs(float(ju))
    assert np.abs(F_k.numpy() - np.asarray(jF)).max() < 1e-12
    u_r, F_r = real_space(mol, pp, box, params.alpha)
    madelung = -2.0 * (float(u_k) + u_r) / len(r)
    np.testing.assert_allclose(madelung, MADELUNG_NACL, rtol=1e-6)
    np.testing.assert_allclose(F_k.numpy() + F_r, 0.0, atol=1e-8)


def test_ewald_parameter_independence():
    rng = np.random.default_rng(3)
    n, box, rc = 32, np.array([6.0] * 3), 2.9
    r = rng.uniform(0.7, 5.3, size=(n, 3))
    mol, pp, jmol, jpp = charge_scene(r, np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                                      box, rc)
    totals = []
    for alpha, kmax in ((1.4, 10), (1.8, 14)):
        u_k, F_k, _ = EwaldSolver(box, EwaldParams(alpha, kmax), device="cpu")(mol, pp)
        ju, jF, _ = jax_ewald.EwaldSolver(
            box, jax_ewald.EwaldParams(alpha, kmax), dtype=jnp.float64)(jmol, jpp)
        assert rel(float(u_k), float(ju)) < 1e-12
        assert rel(F_k.numpy(), jF) < 1e-12
        totals.append(float(u_k) + real_space(mol, pp, box, alpha)[0])
    np.testing.assert_allclose(totals[0], totals[1], rtol=1e-6)


def test_ewald_forces_match_energy_gradient():
    rng = np.random.default_rng(4)
    n, box, rc, alpha = 16, np.array([5.0] * 3), 2.4, 2.0
    r = rng.uniform(0.5, 4.5, size=(n, 3))
    mol, pp, _, _ = charge_scene(r, np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                                 box, rc)
    solver = EwaldSolver(box, EwaldParams(alpha=alpha, kmax=12), device="cpu")

    def total(m):
        return float(solver(m, pp)[0]) + real_space(m, pp, box, alpha)[0]

    F = solver(mol, pp)[1].numpy() + real_space(mol, pp, box, alpha)[1]
    h = 1e-6
    for i, d in ((0, 0), (3, 1), (7, 2)):
        rp, rm = mol.r.clone(), mol.r.clone()
        rp[i, d] += h
        rm[i, d] -= h
        fd = -(total(dataclasses.replace(mol, r=rp))
               - total(dataclasses.replace(mol, r=rm))) / (2 * h)
        np.testing.assert_allclose(F[i, d], fd, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("box,kmax,alpha", [
    ((6.0, 6.0, 6.0), 12, 2.0), ((7.0, 5.5, 9.1), 9, 1.3)])
def test_kvector_tables_bit_identical(box, kmax, alpha):
    k, c = make_kvectors(np.asarray(box), kmax, alpha)
    solver = EwaldSolver(box, EwaldParams(alpha, kmax), device="cpu")
    jsolver = jax_ewald.EwaldSolver(np.asarray(box), jax_ewald.EwaldParams(alpha, kmax),
                                    dtype=jnp.float64)
    assert np.array_equal(solver.kvec.numpy(), np.asarray(jsolver.kvec))
    assert np.array_equal(solver.coeff.numpy(), np.asarray(jsolver.coeff))
    assert np.array_equal(k, np.asarray(jsolver.kvec))
    for acc in (1e-4, 1e-5):
        assert EwaldParams.tune(box, 3.0, 40.0, 64, acc) == \
            EwaldParams(**vars(jax_ewald.EwaldParams.tune(box, 3.0, 40.0, 64, acc)))
        assert EwaldParams.auto(box, 3.0, acc) == \
            EwaldParams(**vars(jax_ewald.EwaldParams.auto(box, 3.0, acc)))


@pytest.mark.parametrize("chunk", [0, 37])
def test_water_reciprocal_with_torques(chunk, monkeypatch):
    """Three charges a molecule at random orientations: reciprocal
    energy, forces and torques with the self and intramolecular
    corrections, equal to the JAX function's to rounding, whatever the
    k-chunk (all k-vectors at once, or 37 at a time)."""
    mol, pp, jmol, jpp = water_scene(40, 6.0, seed=5)
    if chunk:
        # 120 sites of 8 bytes a k-vector
        monkeypatch.setattr(ewald, "K_CHUNK_BYTES", 120 * 8 * chunk)
        assert ewald.k_chunk(120, 10 ** 4, torch.float64) == chunk
    params = EwaldParams.tune(np.full(3, 6.0), 2.5, 40 * 1.0775, 120, 1e-5)
    solver = EwaldSolver(np.full(3, 6.0), params, device="cpu")
    assert chunk or ewald.k_chunk(120, solver.kvec.shape[0],
                                  torch.float64) == solver.kvec.shape[0]
    u, F, M = reciprocal_energy_forces(mol, pp, solver.kvec, solver.coeff,
                                       params.alpha)
    ju, jF, jM = jax_ewald.EwaldSolver(
        np.full(3, 6.0), jax_ewald.EwaldParams(params.alpha, params.kmax),
        dtype=jnp.float64)(jmol, jpp)
    assert rel(float(u), float(ju)) < 1e-12
    assert rel(F.numpy(), jF) < 1e-11
    assert rel(M.numpy(), jM) < 1e-11
    assert np.abs(M.numpy()).max() > 1e-3  # the torques are not trivially zero


def water_driver_scene(n, seed=11):
    """The water class of tools/bench_ms.py (rho 0.8, random
    orientations), in the port's types."""
    L = (n / 0.8) ** (1 / 3)
    data = cubic_grid(n, [L] * 3, 1.1, components=[water_component(Component)],
                      seed=seed)
    q = np.random.default_rng(5).normal(size=(n, 4))
    data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    cfg = XMLConfig(timestep=0.002, temperature=1.1, box=np.full(3, L), cutoff=3.0,
                    lj_cutoff=3.0, electrostatic_solver="Ewald",
                    ewald_accuracy=1e-4)
    return cfg, data


def test_screen_alpha_reaches_k5_path():
    """Water under ms_packed: K5's path carries the solver's alpha, and its
    start forces equal the plain traversal's with the same screening."""
    cfg, data = water_driver_scene(2744)
    packed = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                          device="cpu", force_mode="ms_packed")
    path = packed.engine._force_fn
    assert isinstance(path, CudaMultiSitePath) and path.packed
    assert isinstance(packed.ewald, EwaldSolver)
    assert path.screen_alpha == packed.ewald.params.alpha > 0
    cells = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                         device="cpu", force_mode="cells")
    assert cells.engine.config.screen_alpha == path.screen_alpha
    packed.engine.prepare_start()
    cells.engine.prepare_start()
    for a, b in ((packed.engine.forces.F, cells.engine.forces.F),
                 (packed.engine.forces.M, cells.engine.forces.M)):
        assert (a - b).abs().max() <= 1e-10 * b.abs().max()
    np.testing.assert_allclose(float(packed.engine.macro.upot),
                               float(cells.engine.macro.upot), rtol=1e-11)
