"""The plugins that change the molecule set, the velocities or the
forces, against the JAX package's (CPU, f64), on the scenes of the JAX
tests (tests/test_plugins_nemd.py, test_extra_plugins.py,
test_wallpotential.py), through the drivers (state and globals after a
run): Mirror types 1, 2, 5 and 6, WallPotential, FixRegion, COMaligner,
InMemoryCheckpointing, Dropaligner, Dropaccelerator, MirrorSystem.  The
NEMD control plugins and MettDeamon are in test_torch_mettdeamon.py.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io.ascii_reader import PhaseSpaceData as JData
from ls1_mardyn_tpu.io.generators import cubic_grid as jgrid
from ls1_mardyn_tpu.io.xml_config import PluginSpec as JSpec
from ls1_mardyn_tpu.io.xml_config import XMLConfig as JConfig
from ls1_mardyn_tpu.models.components import Component as JComponent
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData as PData
from ls1_mardyn_tpu_torch.io.generators import cubic_grid as pgrid
from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, XMLConfig
from ls1_mardyn_tpu_torch.models.components import Component
from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation
from test_torch_gcmc import KEYS

torch.set_num_threads(1)

JAX = dict(cls=JConfig, spec=JSpec, grid=jgrid, md=JaxMD, data=JData,
           comp=JComponent, kw=dict(dtype=jnp.float64))
PORT = dict(cls=XMLConfig, spec=PluginSpec, grid=pgrid, md=MDSimulation,
            data=PData, comp=Component, kw=dict(dtype=torch.float64, device="cpu"))


def assert_same_state(psim, jsim, tol=1e-9):
    jm, pm = jsim.molecules(), psim.molecules()
    jvalid = np.asarray(jm.valid)
    np.testing.assert_array_equal(pm.valid.numpy(), jvalid)
    for k in KEYS:
        a, b = getattr(pm, k).numpy()[jvalid], np.asarray(getattr(jm, k))[jvalid]
        if k in ("cid", "mid"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * max(1.0, np.abs(b).max()), err_msg=k)


def assert_same_globals(pgv, jgv):
    for k in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(pgv, k)), float(getattr(jgv, k)),
                                   rtol=1e-9, err_msg=k)


def cube_scene(side, n=216, rho=0.4, T=1.0, box=None, dy=0.0, seed=42):
    """tests/test_plugins_nemd.py's lattices: n molecules in [L, side,
    L] (side None: the cube), shifted by dy along y, in `box`."""
    L = (n / rho) ** (1 / 3)

    def data(s):
        d = s["grid"](n, [L, side or L, L], T, seed=seed)
        d.r[:, 1] += dy
        d.box = np.array(box or [L, L, L], float)
        return d

    return data, L


def run_pair(data_fn, plugins, steps, T=1.0, dt=0.002, rc=2.5, ensemble="NVT",
             prep=None, **md_kw):
    """Both drivers on the same start state with the same plugins for
    `steps` steps; prep(sim) runs on each before the first step."""
    out = []
    for s in (JAX, PORT):
        d = data_fn(s)
        cfg = s["cls"](timestep=dt, temperature=T, box=np.asarray(d.box), cutoff=rc,
                       lj_cutoff=rc, ensemble_type=ensemble,
                       plugins=[s["spec"](nm, dict(pr)) for nm, pr in plugins])
        sim = s["md"](cfg, phase_space_data=d, **s["kw"], **md_kw)
        if prep is not None:
            prep(sim)
        gv = sim.run(steps=steps, print_every=0)
        out.append((sim, gv))
    (jsim, jgv), (psim, pgv) = out
    assert isinstance(psim.engine, SingleChipSimulation)
    return jsim, jgv, psim, pgv


def plugin(sim, name, i=0):
    return [p for p in sim._plugins if type(p).__name__ == name][i]


MIRRORS = {
    1: [("Mirror", {"position": "5.5", "axis": "1", "direction": "1"}),
        ("Mirror", {"position": "2.5", "axis": "1", "direction": "-1"})],
    2: [("Mirror", {"type": "2", "position": "5.5", "axis": "1", "direction": "1",
                    "forceConstant": "50.0"}),
        ("Mirror", {"type": "2", "position": "2.5", "axis": "1", "direction": "-1",
                    "forceConstant": "50.0"})],
    5: [("Mirror", {"type": "5", "position": "4.0", "axis": "1", "dir": "o-|",
                    "meland": {"velo_target": "0.3"}})],
    6: [("Mirror", {"type": "6", "position": "4.0", "axis": "1", "direction": "1",
                    "ramping": {"start": "0", "stop": "20", "treatment": "0"}})],
}


@pytest.mark.parametrize("mtype", [1, 2, 5, 6])
def test_mirror_matches_jax(tmp_path, mtype):
    """Types 1 and 2 confine a lattice between two mirrors just inside
    its outer layers (40 steps);
    types 5 and 6 delete or reflect the outward movers of a lattice next
    to the mirror (30 steps, numpy draws from the same seed)."""
    os.chdir(tmp_path)
    if mtype in (1, 2):
        data, L = cube_scene(3.6, box=None, dy=2.2)
        box = [L, 8.0, L]
        T, steps = 1.0, 40
    else:
        data, L = cube_scene(4.0, dy=0.3, T=1.5)
        box = [L, 8.0, L]
        T, steps = 1.5, 30

    def data_fn(s):
        d = data(s)
        d.box = np.asarray(box, float)
        return d

    jsim, jgv, psim, pgv = run_pair(data_fn, MIRRORS[mtype], steps, T=T)
    assert_same_globals(pgv, jgv)
    assert_same_state(psim, jsim)
    counts = []
    for i in range(len(MIRRORS[mtype])):
        jm, pm = plugin(jsim, "Mirror", i), plugin(psim, "Mirror", i)
        counts.append((pm.reflected, pm.deleted))
        assert counts[-1] == (jm.reflected, jm.deleted)
    reflected, deleted = np.sum(counts, axis=0)
    if mtype in (1, 5, 6):
        assert reflected > 0
    if mtype in (5, 6):
        assert deleted > 0 and int(float(pgv.n)) == 216 - deleted


WALL = {"potential": "93", "density": "0.9", "sigma": "1.0",
        "epsilon": "1.0", "yoff": "0.0", "ycut": "2.0", "width": "0.0"}


@pytest.mark.parametrize("pot", ["93", "104"])
def test_wallpotential_run_matches_jax(tmp_path, pot):
    """tests/test_wallpotential.py's NVE scene over 30 steps."""
    os.chdir(tmp_path)

    def data_fn(s):
        d = s["grid"](125, [8.0, 3.0, 8.0], 0.6, seed=5)
        d.r[:, 1] += 1.0
        d.box = np.array([8.0, 8.0, 8.0])
        return d

    wall = dict(WALL, potential=pot, delta="0.7")
    jsim, jgv, psim, pgv = run_pair(data_fn, [("WallPotential", wall)], 30, T=0.6,
                                    dt=0.001, rc=2.2, ensemble="NVE")
    assert_same_globals(pgv, jgv)
    assert_same_state(psim, jsim)


def lattice(s, n=216, rho=0.4, T=1.0):
    L = (n / rho) ** (1 / 3)
    return s["grid"](n, [L, L, L], T)


def push_x(sim):
    """Every molecule +0.5 along x (tests/test_plugins_nemd.py)."""
    m = sim.engine.mol
    dv = (torch.tensor([0.5, 0.0, 0.0], dtype=m.v.dtype) if torch.is_tensor(m.v)
          else jnp.asarray([0.5, 0.0, 0.0]))
    sim.engine.mol = dataclasses.replace(m, v=m.v + dv)


def test_fixregion_comaligner_checkpointing_match_jax(tmp_path):
    """FixRegion (y < 2 frozen), COMaligner (every 5 steps, after a push
    along x) and InMemoryCheckpointing (snapshot every 5 steps, restored
    at step 12) together, 16 steps."""
    os.chdir(tmp_path)
    plugins = [
        ("FixRegion", {"xmin": "0", "xmax": "1e30", "ymin": "0", "ymax": "2.0",
                       "zmin": "0", "zmax": "1e30"}),
        ("COMaligner", {"interval": "5"}),
        ("InMemoryCheckpointing", {"writefrequency": "5", "restartAtIteration": "12"}),
    ]
    jsim, jgv, psim, pgv = run_pair(lattice, plugins, 16, prep=push_x)
    assert_same_globals(pgv, jgv)
    assert_same_state(psim, jsim)
    assert plugin(psim, "InMemoryCheckpointing").restart_at == -1
    assert psim.time == pytest.approx(jsim.time, abs=1e-12)


def test_drop_plugins_match_jax(tmp_path):
    """Dropaligner, Dropaccelerator and MirrorSystem
    (tests/test_extra_plugins.py) in one run of 6 steps."""
    os.chdir(tmp_path)
    plugins = [
        ("MirrorSystem", {"yPos": "0.0"}),
        ("Dropaccelerator", {"xposition": "3", "yposition": "3", "zposition": "3",
                             "dropradius": "2", "velocity": "1.0", "starttime": "1",
                             "steps": "3"}),
        ("Dropaligner", {"xpos": "4.5", "ypos": "4.5", "zpos": "4.5",
                         "radius": "3", "interval": "2"}),
    ]
    jsim, jgv, psim, pgv = run_pair(lambda s: lattice(s, n=125), plugins, 6)
    assert_same_globals(pgv, jgv)
    assert_same_state(psim, jsim)


PORTED = ("CavityWriter", "WidomInsertion", "Mirror", "WallPotential",
          "FixRegion", "COMaligner", "InMemoryCheckpointing", "DistControl",
          "DriftCtrl", "PosNegComp", "ExtractPhase", "MettDeamon",
          "MettDeamonFeedrateDirector", "Dropaligner", "Dropaccelerator",
          "MirrorSystem")


def test_plugin_registry_and_engine_gates_match_jax():
    """The sixteen plugins of this slice are registered and no longer
    refused; with the 23 observers still refused they make up the JAX
    registry; the RMM and axis-swap gates are JAX's."""
    import ls1_mardyn_tpu.plugins  # noqa: F401  (registers)
    from ls1_mardyn_tpu.plugins.base import PluginFactory as JFactory
    from ls1_mardyn_tpu_torch.driver import LATER_PLUGINS
    from ls1_mardyn_tpu_torch.plugins import PluginFactory

    assert len(LATER_PLUGINS) == 23 and not LATER_PLUGINS & set(PORTED)
    assert set(PORTED) <= set(PluginFactory._registry)
    assert set(JFactory._registry) == set(PluginFactory._registry) | LATER_PLUGINS
    assert MDSimulation._RMM_SAFE_PLUGINS == JaxMD._RMM_SAFE_PLUGINS
    assert MDSimulation._SWAP_SAFE_PLUGINS == JaxMD._SWAP_SAFE_PLUGINS


def _later_names():
    from ls1_mardyn_tpu_torch.driver import LATER_PLUGINS

    return sorted(LATER_PLUGINS)


@pytest.mark.parametrize("name", _later_names())
def test_observer_plugins_of_a_later_slice_raise(name):
    cfg = XMLConfig(timestep=0.002, temperature=1.0, box=np.array([8.0] * 3),
                    cutoff=2.5, lj_cutoff=2.5,
                    output_plugins=[PluginSpec(name, {})])
    with pytest.raises(NotImplementedError, match="ROADMAP slice 6b"):
        MDSimulation(cfg, dtype=torch.float64, device="cpu")


def test_in_memory_checkpointing_restores_on_the_rmm_engine(tmp_path):
    """InMemoryCheckpointing keeps the RMM engine (it is RMM-safe in both
    packages); its restore at step 12 goes through the engine's mol
    setter, so step 12 replays step 11 (the snapshot of step 10 advanced
    by one step), as in tests/test_plugins_nemd.py."""
    from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine

    os.chdir(tmp_path)
    n = 1500
    L = (n / 0.6) ** (1 / 3)
    cfg = XMLConfig(timestep=0.002, temperature=1.0, box=np.array([L] * 3),
                    cutoff=2.5, lj_cutoff=2.5,
                    plugins=[PluginSpec("InMemoryCheckpointing",
                                        {"writefrequency": "5",
                                         "restartAtIteration": "12"})])
    sim = MDSimulation(cfg, dtype=torch.float64, device="cpu",
                       phase_space_data=pgrid(n, [L] * 3, 1.0))
    assert isinstance(sim.engine, RMMEngine)
    snaps = {}

    class Spy:
        write_frequency = 1

        def site_wise_forces_fn(self, table, box):
            return None

        def init(self, s):
            pass

        def finish(self, s):
            pass

        def before_event_new_timestep(self, s, k):
            pass

        def before_forces(self, s, k):
            pass

        def after_forces(self, s, k):
            pass

        def end_step(self, s, k):
            m = s.molecules()
            snaps[k] = m.r[torch.argsort(m.mid)].numpy().copy()

    sim._plugins.append(Spy())
    sim.run(steps=14, print_every=0)
    assert isinstance(sim.engine, RMMEngine)
    np.testing.assert_allclose(snaps[12], snaps[11], rtol=0, atol=1e-12)
    assert int(sim.molecules().valid.sum()) == n
