"""SPME of the port (ls1_mardyn_tpu_torch/ops/pme.py) against the JAX
package's (ls1_mardyn_tpu/ops/pme.py), f64 on the CPU, at the JAX tests'
tolerances (tests/test_pme.py): the Madelung constant, the mesh against
direct Ewald, forces against the energy gradient; the influence function
`kern` and the tuned parameters bit-identical; the port's one spread
(an atomic scatter-add) and gather held against JAX's sorted, blocked and
direct modes.

The port's spread has no buckets, so it cannot overflow: where the JAX
blocked spread raises its overflow flag (test_blocked_spread_overflow_
flags), the port's keeps every charge (test_spread_keeps_crammed_charge).
All JAX mesh calls share one grid and order per shape, so each compiles
once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops import pme as jax_pme
from ls1_mardyn_tpu_torch.ops.ewald import EwaldParams, EwaldSolver
from ls1_mardyn_tpu_torch.ops.pme import (
    PMEParams,
    PMESolver,
    _grid_indices_weights,
    bspline_weights,
    bspline_weights_and_derivs,
    gather_forces,
    spread_charges,
)
from test_ewald import MADELUNG_NACL, _nacl
from test_torch_ewald import charge_scene, real_space, rel, water_scene

torch.set_num_threads(1)

# one mesh for the spread/gather comparisons (JAX compiles per shape)
N_S, BOX_S, GRID_S, P_S = 3000, (11.0, 9.5, 10.2), (32, 16, 32), 4


def test_madelung_constant_nacl_pme():
    r, q, box = _nacl(cells=4, d=1.0)
    mol, pp, _, _ = charge_scene(r, q, box, 1.9)
    params = PMEParams(alpha=2.0, grid=(32, 32, 32), order=6)
    u_k, F_k, _ = PMESolver(box, params, device="cpu")(mol, pp)
    u_r, F_r = real_space(mol, pp, box, params.alpha)
    madelung = -2.0 * (float(u_k) + u_r) / len(r)
    np.testing.assert_allclose(madelung, MADELUNG_NACL, rtol=1e-5)
    np.testing.assert_allclose(F_k.numpy() + F_r, 0.0, atol=1e-6)


def test_pme_matches_direct_ewald():
    rng = np.random.default_rng(11)
    n, box, rc, alpha = 48, np.array([6.0] * 3), 2.9, 1.8
    r = rng.uniform(0.0, 6.0, size=(n, 3))
    mol, pp, _, _ = charge_scene(r, np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                                 box, rc)
    u_d, F_d, _ = EwaldSolver(box, EwaldParams(alpha=alpha, kmax=16),
                              device="cpu")(mol, pp)
    u_m, F_m, _ = PMESolver(box, PMEParams(alpha, (48, 48, 48), 6),
                            device="cpu")(mol, pp)
    np.testing.assert_allclose(float(u_m), float(u_d), rtol=2e-5)
    scale = np.abs(F_d.numpy()).max()
    np.testing.assert_allclose(F_m.numpy(), F_d.numpy(), atol=2e-4 * scale)


def test_pme_forces_match_energy_gradient():
    rng = np.random.default_rng(12)
    n, box = 16, np.array([5.0] * 3)
    r = rng.uniform(0.0, 5.0, size=(n, 3))
    mol, pp, _, _ = charge_scene(r, np.where(np.arange(n) % 2 == 0, 1.0, -1.0),
                                 box, 2.4)
    solver = PMESolver(box, PMEParams(alpha=2.0, grid=(32, 32, 32), order=4),
                       device="cpu")
    F = solver(mol, pp)[1].numpy()
    h = 1e-5
    for i, d in ((0, 0), (3, 1), (7, 2)):
        rp, rm = mol.r.clone(), mol.r.clone()
        rp[i, d] += h
        rm[i, d] -= h
        fd = -(float(solver(dataclasses.replace(mol, r=rp), pp)[0])
               - float(solver(dataclasses.replace(mol, r=rm), pp)[0])) / (2 * h)
        np.testing.assert_allclose(F[i, d], fd, rtol=5e-4, atol=1e-7)


@pytest.mark.parametrize("box,grid,order,alpha", [
    ((5.0, 5.0, 5.0), (32, 32, 32), 6, 2.0),
    ((10.0, 11.0, 9.0), (12, 10, 8), 5, 0.8),
    ((7.3, 7.3, 7.3), (16, 16, 16), 4, 1.1)])
def test_influence_function_bit_identical(box, grid, order, alpha):
    params = PMEParams(alpha, grid, order)
    kern = PMESolver(box, params, device="cpu").kern.numpy()
    jkern = np.asarray(jax_pme.PMESolver(
        box, jax_pme.PMEParams(alpha, grid, order), dtype=jnp.float64).kern)
    assert np.array_equal(kern, jkern)
    b = np.asarray(box)
    for acc in (1e-4, 1e-5):
        assert PMEParams.tune(b, 3.0, 40.0, 64, acc) == PMEParams(
            **vars(jax_pme.PMEParams.tune(b, 3.0, 40.0, 64, acc)))
    assert PMEParams.auto(b, 3.0) == PMEParams(**vars(jax_pme.PMEParams.auto(b, 3.0)))


@pytest.mark.parametrize("p", [4, 6])
def test_bspline_weights_bit_identical(p):
    frac = np.random.default_rng(p).uniform(0, 1, (64,))
    w = bspline_weights(torch.as_tensor(frac), p).numpy()
    jw = np.asarray(jax_pme.bspline_weights(jnp.asarray(frac), p))
    assert np.array_equal(w, jw)
    w2, dw = bspline_weights_and_derivs(torch.as_tensor(frac), p)
    jw2, jdw = jax_pme.bspline_weights_and_derivs(jnp.asarray(frac), p)
    assert np.array_equal(dw.numpy(), np.asarray(jdw))
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=0, atol=1e-15)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-14)


@pytest.fixture(scope="module")
def mesh_inputs():
    """Sites, charges and a random potential mesh on the shared grid, and
    the JAX package's spline columns of them."""
    rng = np.random.default_rng(0)
    rs = rng.uniform(0, 1, (N_S, 3)) * np.asarray(BOX_S)
    wq = rng.normal(size=N_S)
    phi = rng.normal(size=int(np.prod(GRID_S)))
    giw = _grid_indices_weights(torch.as_tensor(rs), BOX_S, GRID_S, P_S,
                                with_derivs=True)
    jgiw = jax_pme._grid_indices_weights(
        jnp.asarray(rs), jnp.asarray(wq), BOX_S, GRID_S, P_S, jnp.float64,
        with_derivs=True, products=True)
    return rs, wq, phi, giw, jgiw


def test_grid_columns_match(mesh_inputs):
    _, _, _, giw, jgiw = mesh_inputs
    assert np.array_equal(giw["bw"].numpy(), np.asarray(jgiw["bw"]))
    np.testing.assert_allclose(giw["w3"].numpy(), np.asarray(jgiw["w3"]),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(giw["dw3"].numpy(), np.asarray(jgiw["dw3"]),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", ["sorted", "blocked"])
def test_spread_matches_jax_modes(mesh_inputs, mode):
    _, wq, _, giw, jgiw = mesh_inputs
    Q = spread_charges(giw["bw"], giw["w3"], torch.as_tensor(wq), GRID_S, P_S)
    if mode == "sorted":
        jQ = jax_pme._spread_sorted(jgiw["bw"], jgiw["w3"], jnp.asarray(wq),
                                    GRID_S, P_S, jnp.float64)
    else:
        jQ, ovf = jax_pme._spread_blocked(jgiw["bw"], jgiw["w3"], jnp.asarray(wq),
                                          GRID_S, P_S, jnp.float64)
        assert not bool(ovf)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), atol=1e-13)


@pytest.mark.parametrize("mode", ["sorted", "blocked", "direct"])
def test_gather_matches_jax_modes(mesh_inputs, mode):
    _, wq, phi, giw, jgiw = mesh_inputs
    F = gather_forces(giw["bw"], giw["w3"], giw["dw3"], giw["scale"],
                      torch.as_tensor(wq), torch.as_tensor(phi), GRID_S, P_S)
    args = (jgiw["bw"], jgiw["w3"], jgiw["dw3"], jgiw["scale"], jnp.asarray(wq),
            jnp.asarray(phi), GRID_S, P_S, jnp.float64)
    if mode == "sorted":
        jF = jax_pme._gather_sorted(*args)
    elif mode == "blocked":
        jF, ovf = jax_pme._gather_blocked(*args)
        assert not bool(ovf)
    else:
        ph = jnp.asarray(phi)[jgiw["lin"]]
        jF = jnp.stack([-jnp.sum(jgiw["D"][d] * ph, axis=1) * jnp.asarray(wq)
                        for d in range(3)], axis=-1)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), atol=1e-12)


def test_spread_keeps_crammed_charge():
    """4096 charges in one cell: the JAX blocked spread flags a bucket
    overflow there; the port's scatter-add has no bucket and keeps every
    charge, at the same cells as JAX's sorted spread."""
    n, box, grid, p = 4096, (16.0, 16.0, 16.0), (16, 16, 16), 4
    rs = np.full((n, 3), 0.5)
    wq = np.ones((n,))
    giw = _grid_indices_weights(torch.as_tensor(rs), box, grid, p)
    Q = spread_charges(giw["bw"], giw["w3"], torch.as_tensor(wq), grid, p)
    np.testing.assert_allclose(float(Q.sum()), n, rtol=1e-13)
    jgiw = jax_pme._grid_indices_weights(jnp.asarray(rs), jnp.asarray(wq), box,
                                         grid, p, jnp.float64, products=False)
    jQ = jax_pme._spread_sorted(jgiw["bw"], jgiw["w3"], jnp.asarray(wq), grid, p,
                                jnp.float64)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), rtol=1e-12, atol=1e-12)


def test_pme_solver_water_with_torques():
    """PMESolver.__call__ on rigid three-charge molecules against the JAX
    solver (its default blocked spread and gather): energy, forces and
    torques to rounding."""
    mol, pp, jmol, jpp = water_scene(40, 6.0, seed=5)
    params = PMEParams(alpha=1.6, grid=(16, 16, 16), order=6)
    u, F, M = PMESolver(np.full(3, 6.0), params, device="cpu")(mol, pp)
    ju, jF, jM = jax_pme.PMESolver(
        np.full(3, 6.0), jax_pme.PMEParams(1.6, (16, 16, 16), 6),
        dtype=jnp.float64)(jmol, jpp)
    assert rel(float(u), float(ju)) < 1e-11
    assert rel(F.numpy(), jF) < 1e-10
    assert rel(M.numpy(), jM) < 1e-10
