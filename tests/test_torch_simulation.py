"""The general engine (ls1_mardyn_tpu_torch/simulation.py:
SingleChipSimulation, ops/integrator.py, ops/thermostat.py) against the
JAX package's, f64 on the CPU, from the same start state.

Step by step on a 2CLJ+quadrupole fluid through the general traversal:
after 20 steps r, v, q, L agree to 1e-10 (the same arithmetic, pair
terms summed in another order, over 20 steps of a stable trajectory)
and T, p, Upot to rtol 1e-10.  Component-wise, undirected and
TemperatureControl thermostats each for a few steps under a stand-in
force (1e-12: no pair sums involved); the torque-free
rotor (tests/test_simulation_e2e.py) and the NVE energy drift in the
port alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops.thermostat import TemperatureControlRegion as JRegion
from ls1_mardyn_tpu.simulation import SimConfig as JSimConfig
from ls1_mardyn_tpu.simulation import SingleChipSimulation as JSim
from ls1_mardyn_tpu.state import Forces as JForces
from ls1_mardyn_tpu.state import Macroscopic as JMacroscopic
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.integrator import (
    kinetic_sums,
    upd_post_force,
    upd_post_force_kahan,
    upd_pre_force,
    upd_pre_force_kahan,
)
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
from ls1_mardyn_tpu_torch.ops.thermostat import TemperatureControlRegion
from ls1_mardyn_tpu_torch.simulation import SimConfig, SingleChipSimulation
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState, SimState
from test_torch_models import _scene

torch.set_num_threads(1)


def _tether(xp, macro_cls, forces_cls, box):
    """A cheap stand-in force_fn for the thermostat tests, the same in
    both packages: a harmonic tether to the box centre and a torque
    from the same vector (the thermostats read v and L, whatever made
    them; this keeps the JAX compile to the integrator and thermostat)."""
    def force_fn(mol):
        d = mol.r - xp.asarray(box / 2)
        z = xp.zeros((), dtype=d.dtype)
        return (forces_cls(F=-0.5 * d, M=0.05 * d[:, [1, 2, 0]], Vi=0.0 * d),
                macro_cls(z, z, z, z), xp.zeros((), dtype=bool))
    return force_fn


def _run_both(kind, steps, n=150, tether=False, **cfg):
    """(JAX engine, its last globals, port engine, its last globals)
    after `steps` steps from the same state."""
    jmol, jpp, pmol, ppp, box, _ = _scene(kind, n=n)
    regions = cfg.pop("regions", ())
    jfn = _tether(jnp, JMacroscopic, JForces, box) if tether else None
    pfn = _tether(torch, Macroscopic, Forces, box) if tether else None
    jsim = JSim(jmol, jpp, box, JSimConfig(
        dt=0.002, cell_cap=32, cell_chunk=9,
        temp_control_regions=tuple(JRegion(**r) for r in regions), **cfg),
        force_fn=jfn)
    psim = SingleChipSimulation(pmol, ppp, box, SimConfig(
        dt=0.002, cell_cap=32,
        temp_control_regions=tuple(TemperatureControlRegion(**r)
                                   for r in regions), **cfg), force_fn=pfn)
    assert psim.spec.dims == jsim.spec.dims
    return jsim, jsim.run(steps), psim, psim.run(steps)


def _assert_state_equal(psim, gp, jsim, gj, atol=1e-10, rtol=1e-10):
    box = np.asarray(jsim.box)
    for name in ("r", "v", "q", "L"):
        d = getattr(psim.mol, name).numpy() - np.asarray(getattr(jsim.mol, name))
        if name == "r":
            d -= box * np.round(d / box)
        np.testing.assert_allclose(d, 0.0, atol=atol, err_msg=name)
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=rtol,
                                   err_msg=name)


def test_single_chip_simulation_matches_jax_20_steps():
    jsim, gj, psim, gp = _run_both("2cljq", 20, target_temperature=1.0)
    assert psim.started and psim.macro_fresh and psim._step_count == 20
    _assert_state_equal(psim, gp, jsim, gj)
    np.testing.assert_allclose(psim.forces.M.numpy(), np.asarray(jsim.forces.M),
                               atol=1e-9)
    # rigid rotation really happened, and stayed normalized
    assert float((psim.mol.q[:, 0] - 1).abs().max()) > 1e-3
    np.testing.assert_allclose((psim.mol.q ** 2).sum(-1).numpy(), 1.0, atol=1e-13)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(target_temperature=1.0, component_thermostat=(0, 1),
             thermostat_temps=(0.8, 1.3)),
        dict(target_temperature=1.0, component_thermostat=(0, 1),
             thermostat_temps=(0.8, 1.3), undirected_thermostats=(True, False)),
        dict(target_temperature=0.9, undirected_thermostats=(True,)),
        dict(thermostat=False, regions=[
            dict(lower=(0.0, 0.0, 0.0), upper=(4.0, 7.6, 7.6),
                 target_temperature=0.7, nslabs=2, directions=(0, 2)),
            dict(lower=(4.0, 0.0, 0.0), upper=(7.6, 7.6, 7.6),
                 target_temperature=1.4, frequency=2, component=1,
                 ramp_start_t=1.0, ramp_end_t=2.0, ramp_update_stop=4),
        ]),
    ],
    ids=["componentwise", "componentwise-undirected", "global-undirected",
         "temp_control"],
)
def test_thermostats_match_jax(cfg):
    jsim, gj, psim, gp = _run_both("charged", 6, tether=True, **cfg)
    _assert_state_equal(psim, gp, jsim, gj, atol=1e-12, rtol=1e-12)
    assert float(psim.mol.L.abs().max()) > 0.1


def test_torque_free_rotor_conserves_L_and_norm():
    """Torque-free rigid rotor (tests/test_simulation_e2e.py::
    test_rigid_body_free_rotation_conserves_L_and_energy): world-frame L
    exact, |q| = 1, rotational energy to integrator order; beside it a
    1CLJ molecule (zero inertia) and an invalid slot stay untouched."""
    c = Component(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.5, 1.0, 1.0, 1.0)
    c.add_ljcenter(0.0, 0.0, -0.5, 1.0, 1.0, 1.0)
    c.add_charge(0.3, 0.0, 0.0, 0.5, 0.1)
    atom = Component(cid=1)
    atom.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    pp = PairParams.from_table(ComponentTable([c, atom], cutoff=5.0),
                               dtype=torch.float64, device="cpu")
    q0 = np.array([[1.0, 0, 0, 0], [0.5, 0.5, 0.5, 0.5], [1.0, 0, 0, 0]])
    mol = MoleculeState.from_numpy(
        r=np.zeros((2, 3)), v=np.zeros((2, 3)), q=q0[:2],
        L=np.array([[0.4, 0.3, 0.2], [0.0, 0.0, 0.0]]),
        cid=np.array([0, 1]), capacity=3, dtype=torch.float64,
        device="cpu")
    forces = Forces.zeros(3, torch.float64)
    iw2s = []
    for _ in range(2000):
        mol = upd_pre_force(mol, forces, pp, 0.001)
        mol, _, iw2 = upd_post_force(mol, forces, pp, 0.001)
        iw2s.append(float(iw2[0]))
    np.testing.assert_allclose(mol.L[0].numpy(), [0.4, 0.3, 0.2], atol=1e-14)
    np.testing.assert_allclose(float((mol.q[0] ** 2).sum()), 1.0, atol=1e-12)
    assert abs(iw2s[-1] - iw2s[0]) / iw2s[0] < 1e-4
    assert float((mol.q[0] - torch.as_tensor(q0[0])).abs().max()) > 0.1
    np.testing.assert_array_equal(mol.q[1:].numpy(), q0[1:])
    assert bool(torch.isfinite(mol.q).all()) and not bool(mol.valid[2])
    assert int(mol.num_valid()) == 2
    mv2, iw2 = kinetic_sums(mol, pp)
    assert float(iw2[1]) == 0.0 and float(iw2[2]) == 0.0


def test_kahan_integrator_equals_plain_in_f64():
    _, _, pmol, ppp, _, _ = _scene("2cljq", n=40)
    g = torch.Generator().manual_seed(1)
    forces = Forces(*(torch.randn((40, 3), generator=g, dtype=torch.float64)
                      for _ in range(3)))
    z = torch.zeros((40, 3), dtype=torch.float64)
    a = upd_pre_force(pmol, forces, ppp, 0.002)
    b, rc, vc = upd_pre_force_kahan(pmol, forces, ppp, 0.002, z, z)
    for name in ("r", "v", "q", "L"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), atol=1e-15)
    a2, mv2a, iw2a = upd_post_force(a, forces, ppp, 0.002)
    b2, mv2b, iw2b, _ = upd_post_force_kahan(b, forces, ppp, 0.002, vc)
    np.testing.assert_allclose(a2.v.numpy(), b2.v.numpy(), atol=1e-15)
    np.testing.assert_allclose(mv2a.numpy(), mv2b.numpy(), rtol=1e-13)
    st = SimState.create(pmol)
    assert st.step == 0 and st.forces.F.shape == (40, 3)
    assert float((st.macro + st.macro).upot) == 0.0


def test_nve_energy_drift_shifted_lj():
    """NVE, shifted LJ through the 1CLJ force path: total energy drifts
    by less than 2e-4 of its value over 200 steps."""
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    n, rho, rc = 216, 0.5, 2.5
    L = (n / rho) ** (1.0 / 3.0)
    c = Component(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc, True)
    data = cubic_grid(n, [L, L, L], 0.9, components=[c], seed=5)
    table = ComponentTable([c], cutoff=rc, lj_cutoff=rc)
    pp = PairParams.from_table(table, dtype=torch.float64, device="cpu")
    mol = MoleculeState.from_numpy(r=data.r, v=data.v, dtype=torch.float64,
                                   device="cpu")
    cfg = SimConfig(dt=0.002, thermostat=False, cell_cap=32)
    path = CudaLJPath(table, CellGridSpec.create((L,) * 3, rc, cap=32))
    sim = SingleChipSimulation(mol, pp, (L,) * 3, cfg, force_fn=path)

    def energy(gv):
        return float(gv.upot) + 0.5 * float(gv.summv2)

    e0 = energy(sim.run(1, check_overflow_every=1))
    e1 = energy(sim.run(200))
    assert abs(e1 - e0) / abs(e0) < 2e-4, (e0, e1)
    p = (sim.mol.v * pp.mass[0]).sum(0)
    assert float(p.abs().max()) < 1e-10
    with pytest.raises(RuntimeError, match="cell capacity exceeded"):
        small = dataclasses.replace(cfg, cell_cap=4)
        SingleChipSimulation(mol, pp, (L,) * 3, small).run(
            1, check_overflow_every=1)
