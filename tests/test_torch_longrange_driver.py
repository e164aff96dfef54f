"""Long-range electrostatics and the planar correction through the port's
driver (ls1_mardyn_tpu_torch/driver.py: MDSimulation with
electrostatic_solver="Ewald" and longrange="planar") against the JAX
package's MDSimulation, f64 on the CPU.

  * the molten salt of tests/test_ewald_driver.py (6^3 ions, jittered,
    at T ~ 1) under ewald_method "direct", "pme" and "fmm": 10 steps on
    the N^2 oracle
    with erfc screening (direct, pme) or LJ only (fmm), T, p, Upot and
    r, v equal to the JAX driver's to rounding;
  * "auto" picks the same solver as the JAX driver on both sides of its
    N_sites * K = 2e8 crossover;
  * an Ewald tag on a scene without charges builds no solver, and a
    1CLJ scene keeps the RMM engine; a planar 1CLJ slab leaves it (the
    general engine, K3's path at a size the cell kernel takes) and runs
    equal to the JAX driver;
  * the adaptive re-spec rebuilds the same solver, FMM refuses
    force_mode="cells" and ignores the adaptive container with a warning
    (the screening of K5's path: tests/test_torch_ewald.py);
  * each solver, built directly, lives on the card unless asked for the
    CPU, and refuses tensors on another device.

The JAX FMM runs at order 3 (its Python-built lattice operators take
minutes at order 8); the JAX runs are shared through _JAX.
"""

import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io.generators import cubic_grid as jax_cubic_grid
from ls1_mardyn_tpu.io.xml_config import XMLConfig as JaxXMLConfig
from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.ewald import EwaldParams, EwaldSolver
from ls1_mardyn_tpu_torch.ops.fmm import FMMElectrostatics, FMMSolver
from ls1_mardyn_tpu_torch.ops.fmm_adaptive import AdaptiveFMMSolver
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
from ls1_mardyn_tpu_torch.ops.lrc_planar import PlanarLRC
from ls1_mardyn_tpu_torch.ops.pme import PMEParams, PMESolver
from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine
from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation
from test_ewald_driver import _molten_salt_config
from test_torch_driver import _by_mid
from test_torch_ewald import ion_components, water_component, water_driver_scene

torch.set_num_threads(1)

STEPS = 10
_JAX = {}


def salt_config(n_side=6, d=1.1, T=1.0):
    """The port's twin of test_ewald_driver._molten_salt_config."""
    comps = ion_components(Component, lj=True)
    idx = np.arange(n_side)
    g = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    r = (g + 0.5) * d
    q = np.where(g.sum(1) % 2 == 0, 1.0, -1.0)
    box = np.array([n_side * d] * 3)
    ones = np.ones((2, 2))
    cfg = XMLConfig(timestep=0.001, temperature=T, box=box, cutoff=2.5,
                    lj_cutoff=2.5, components=comps, mixing_xi=ones,
                    mixing_eta=ones, electrostatic_solver="Ewald",
                    ewald_accuracy=1e-5)
    data = PhaseSpaceData(
        components=comps, mixing_xi=ones, mixing_eta=ones, eps_rf=1.0, box=box,
        temperature=T, current_time=0.0,
        mid=np.arange(1, len(r) + 1, dtype=np.int64),
        cid=np.where(q > 0, 0, 1).astype(np.int32), r=r, v=np.zeros_like(r),
        q=np.tile([1.0, 0, 0, 0], (len(r), 1)), L=np.zeros_like(r))
    return cfg, data


def _thermal(data):
    """The lattice jittered and given velocities at T ~ 1 (the same arrays
    for both packages): a perfect rock-salt lattice at rest has zero
    forces, and a trajectory from it follows rounding noise."""
    rng = np.random.default_rng(17)
    data.r = data.r + rng.uniform(-0.05, 0.05, data.r.shape)
    data.v = rng.normal(0.0, 1.0, data.r.shape)
    return data


def _jax_salt(method):
    """The JAX driver's run of the molten salt under one method, once."""
    if method not in _JAX:
        cfg, data = _molten_salt_config()
        data = _thermal(data)
        cfg.ewald_method = method
        cfg.fmm_order = 3
        jsim = JaxMD(cfg, dtype=jnp.float64, phase_space_data=data)
        jsim.engine.prepare_start()
        u0 = float(jsim.engine.macro.upot)
        _JAX[method] = (jsim, u0, jsim.run(steps=STEPS, print_every=0))
    return _JAX[method]


def _compare(port, gp, jsim, gj, box, tol=1e-9):
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=tol,
                                   err_msg=name)
    mid_p, r_p, v_p = _by_mid(port.molecules())
    mid_j, r_j, v_j = _by_mid(jsim.molecules())
    np.testing.assert_array_equal(mid_p, mid_j)
    dr = r_p - r_j
    dr -= box * np.round(dr / box)
    np.testing.assert_allclose(dr, 0.0, atol=tol)
    np.testing.assert_allclose(v_p, v_j, atol=tol)


@pytest.mark.parametrize("method,solver", [
    ("direct", EwaldSolver), ("pme", PMESolver), ("fmm", FMMElectrostatics)])
def test_molten_salt_matches_jax(method, solver):
    cfg, data = salt_config()
    cfg.ewald_method = method
    cfg.fmm_order = 3
    port = MDSimulation(cfg, dtype=torch.float64, phase_space_data=_thermal(data),
                        device="cpu")
    assert type(port.ewald) is solver
    assert isinstance(port.engine, SingleChipSimulation)
    jsim, ju0, gj = _jax_salt(method)
    assert type(port.ewald).__name__ == type(jsim.ewald).__name__
    assert port._screen_alpha == jsim._screen_alpha
    if method == "fmm":
        # the pair path runs LJ only: the FMM owns all Coulomb work
        assert port._screen_alpha == 0.0
        assert not port._table_pair.has_electrostatics()
        assert port.table.has_electrostatics()
        assert port.ewald.depth == jsim.ewald.depth
        assert port.ewald.solver.cap == jsim.ewald.solver.cap
    else:
        assert port._screen_alpha == port.ewald.params.alpha > 0
        assert port.engine.config.screen_alpha == port._screen_alpha
    port.engine.prepare_start()
    u0 = float(port.engine.macro.upot)
    assert u0 < 0
    np.testing.assert_allclose(u0, ju0, rtol=1e-11)
    gp = port.run(steps=STEPS, print_every=0)
    _compare(port, gp, jsim, gj, cfg.box)


@pytest.mark.parametrize("n,expect", [(4096, EwaldSolver), (5000, PMESolver)])
def test_auto_picks_the_jax_solver(n, expect):
    """N_sites * K: 1.74e8 at N = 4096 (kmax 15), 2.5e8 at N = 5000."""
    cfg, data = water_driver_scene(n)
    port = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                        device="cpu", force_mode="cells")
    assert type(port.ewald) is expect
    L = cfg.box[0]
    jdata = jax_cubic_grid(n, [L] * 3, 1.1, components=[water_component(JaxComponent)],
                           seed=11)
    jdata.q = data.q
    jcfg = JaxXMLConfig(timestep=0.002, temperature=1.1, box=cfg.box, cutoff=3.0,
                        lj_cutoff=3.0, electrostatic_solver="Ewald",
                        ewald_accuracy=1e-4)
    jsim = JaxMD(jcfg, dtype=jnp.float64, phase_space_data=jdata, force_mode="cells")
    assert type(jsim.ewald).__name__ == expect.__name__
    assert port._screen_alpha == jsim._screen_alpha


def _lj_config(Cfg, box, **kw):
    return Cfg(timestep=0.002, temperature=0.8, box=box, cutoff=2.5,
               lj_cutoff=2.5, ensemble_type="NVT", **kw)


def test_ewald_tag_without_charges_keeps_rmm():
    n = 6000
    box = np.full(3, (n / 0.8) ** (1 / 3))
    data = cubic_grid(n, box, 0.8, seed=3)
    for tag in (None, "Ewald"):
        md = MDSimulation(_lj_config(XMLConfig, box, electrostatic_solver=tag),
                          dtype=torch.float64, phase_space_data=data, device="cpu")
        assert md.ewald is None and md._screen_alpha == 0.0
        assert isinstance(md.engine, RMMEngine), tag


def _slab(gen, n_side=(8, 6, 8), box=(9.0, 24.0, 9.0), seed=2):
    """A 1CLJ liquid slab (rho 0.7) from y = 8 up in a box elongated
    along y, the rest vapour."""
    n = int(np.prod(n_side))
    data = gen(n, [box[0], n / (0.7 * box[0] * box[2]), box[2]], 0.8, seed=seed)
    data.r[:, 1] += 8.0
    data.box = np.asarray(box, float)
    return data


def test_planar_slab_leaves_rmm_and_matches_jax():
    box = np.array([9.0, 24.0, 9.0])
    kw = dict(longrange="planar", longrange_params={"slabs": 60})
    port = MDSimulation(_lj_config(XMLConfig, box, **kw), dtype=torch.float64,
                        phase_space_data=_slab(cubic_grid), device="cpu")
    assert isinstance(port.engine, SingleChipSimulation)
    assert port.planar_lrc is not None and port.planar_lrc.nslabs == 60
    assert port.engine.config.upot_corr == 0.0
    jsim = JaxMD(_lj_config(JaxXMLConfig, box, **kw), dtype=jnp.float64,
                 phase_space_data=_slab(jax_cubic_grid))
    gj = jsim.run(steps=STEPS, print_every=0)
    gp = port.run(steps=STEPS, print_every=0)
    _compare(port, gp, jsim, gj, box)


def test_planar_slab_takes_k3_path():
    """At a size where the cell kernel beats N^2, the planar 1CLJ slab runs
    K3's path on the general engine (the RMM engine would drop the
    correction)."""
    box = (16.0, 40.0, 16.0)
    data = _slab(cubic_grid, n_side=(16, 12, 16), box=box)
    md = MDSimulation(_lj_config(XMLConfig, np.asarray(box), longrange="planar"),
                      dtype=torch.float64, phase_space_data=data, device="cpu")
    assert isinstance(md.engine, SingleChipSimulation)
    assert isinstance(md.engine._force_fn, CudaLJPath) and md.engine._force_fn.cw
    assert md.engine._extra_force_fn is not None


def test_respec_rebuilds_the_same_solver():
    cfg, data = salt_config()
    cfg.ewald_method = "pme"
    md = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data, device="cpu")
    md.run(steps=2, print_every=0)
    params, alpha = md.ewald.params, md._screen_alpha
    md._respec_cell_cap(2 * md.engine.config.cell_cap)
    assert isinstance(md.ewald, PMESolver) and md.ewald.params == params
    assert md.engine.config.screen_alpha == alpha
    assert md.engine._extra_force_fn is md.ewald
    gv = md.run(steps=2, print_every=0)
    assert np.isfinite(float(gv.upot))


def test_fmm_refuses_cells_and_ignores_adaptive(caplog):
    cfg, data = salt_config()
    cfg.ewald_method = "fmm"
    cfg.fmm_order = 3
    with pytest.raises(ValueError, match="fmm"):
        MDSimulation(cfg, dtype=torch.float64, phase_space_data=data, device="cpu",
                     force_mode="cells")
    cfg.fmm_adaptive = True
    with caplog.at_level(logging.WARNING):
        md = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                          device="cpu")
    assert isinstance(md.ewald, FMMElectrostatics)
    assert "adaptiveContainer" in caplog.text


def _solvers(**kw):
    """Each long-range solver of the port at a tiny size, built with `kw`
    (device=... or nothing), and a call of it on a state whose tensors
    lie on `dev`."""
    table = ComponentTable(ion_components(Component, lj=True), cutoff=2.5,
                           lj_cutoff=2.5)
    pp = PairParams.from_table(table, dtype=torch.float64, device="cpu")
    box = np.full(3, 6.6)

    def mol(dev):
        return types.SimpleNamespace(r=torch.zeros((4, 3), device=dev))

    def rq(dev):
        return torch.zeros((4, 3), device=dev), torch.zeros((4,), device=dev)

    return {
        "ewald": (lambda: EwaldSolver(box, EwaldParams(2.0, 3), **kw),
                  lambda s, dev: s(mol(dev), pp)),
        "pme": (lambda: PMESolver(box, PMEParams(2.0, (8, 8, 8), 4), **kw),
                lambda s, dev: s(mol(dev), pp)),
        "fmm": (lambda: FMMSolver(box=6.6, depth=2, order=2, **kw),
                lambda s, dev: s.compute(*rq(dev))),
        "fmm_electrostatics": (
            lambda: FMMElectrostatics(box, table, pp, 216, order=2, depth=2, **kw),
            lambda s, dev: s(mol(dev), pp)),
        "adaptive_fmm": (lambda: AdaptiveFMMSolver(box=6.6, order=2, max_depth=2,
                                                   **kw),
                         lambda s, dev: s.compute(*rq(dev))),
        "planar": (lambda: PlanarLRC(table, box, nslabs=10, **kw),
                   lambda s, dev: s(mol(dev))),
    }


@pytest.mark.parametrize("name", ["ewald", "pme", "fmm", "fmm_electrostatics",
                                  "adaptive_fmm", "planar"])
def test_solver_defaults_to_the_card(name, monkeypatch):
    """Built without a device, a solver asks for the card and raises
    where there is none (nothing falls back to the CPU on its own)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build, _ = _solvers()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


@pytest.mark.parametrize("name", ["ewald", "pme", "fmm", "fmm_electrostatics",
                                  "adaptive_fmm", "planar"])
def test_solver_refuses_tensors_on_another_device(name):
    """A solver takes tensors on its own device only: it never copies
    them to where it lives (the meta device stands in for the card)."""
    build, call = _solvers(device="cpu")[name]
    with pytest.raises(ValueError, match="the solver on cpu"):
        call(build(), "meta")
