"""The general-engine branch of the port's driver
(ls1_mardyn_tpu_torch/driver.py: MDSimulation with force_mode "pallas",
"cells" and the non-RMM "auto" cases) against the JAX package's driver,
f64 on the CPU, on XML scenes written to tmp_path and on hand-built
inhomogeneous scenes.

After the steps, T, p and Upot agree to rtol 1e-9 and positions and
velocities to 1e-9: the two drivers may sum the same pair terms through
different paths (the JAX driver sends a small "cells" scene to its N^2
sweep, the port runs the cell traversal it was asked for).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io.generators import cubic_grid as jax_cubic_grid
from ls1_mardyn_tpu.io.xml_config import XMLConfig as JaxXMLConfig
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig, read_xml_config
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine
from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation
from test_torch_driver import _by_mid, _xml

torch.set_num_threads(1)

TWO_CLJQ = """
          <site type="LJ126" id="2">
            <coords><x>0</x><y>0</y><z>0.4</z></coords>
            <mass>1.0</mass><sigma>1.0</sigma><epsilon>1.0</epsilon>
            <shifted>{shifted}</shifted>
          </site>
          <site type="Quadrupole" id="3">
            <coords><x>0</x><y>0</y><z>0.2</z></coords>
            <quadrupolemoment><x>0</x><y>0</y><z>1</z><abs>1.2</abs>
            </quadrupolemoment>
          </site>"""


def _assert_same_run(port, gp, jsim, gj, L, atol=1e-9):
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=1e-9,
                                   err_msg=name)
    mid_p, r_p, v_p = _by_mid(port.molecules())
    mid_j, r_j, v_j = _by_mid(jsim.molecules())
    np.testing.assert_array_equal(mid_p, mid_j)
    dr = r_p - r_j
    dr -= L * np.round(dr / L)
    np.testing.assert_allclose(dr, 0.0, atol=atol)
    np.testing.assert_allclose(v_p, v_j, atol=atol)


@pytest.mark.parametrize(
    "mode,n,extra_site",
    [("pallas", 1000, ""), ("cells", 600, TWO_CLJQ.format(shifted=0))],
    ids=["pallas-1clj", "cells-2cljq"],
)
def test_general_driver_matches_jax(tmp_path, mode, n, extra_site):
    path, L = _xml(tmp_path, n, 0.6, extra_site=extra_site)
    port = MDSimulation.from_xml(path, dtype=torch.float64, force_mode=mode,
                                 device="cpu")
    jsim = JaxMD.from_xml(path, dtype=jnp.float64, force_mode=mode)
    assert isinstance(port.engine, SingleChipSimulation)
    # "pallas" is the 1CLJ kernel path; "cells" the built-in traversal
    assert isinstance(port.engine._force_fn, CudaLJPath) == (mode == "pallas")
    assert port.engine.config.cell_cap == jsim.engine.config.cell_cap
    gp = port.run(steps=20, print_every=0)
    gj = jsim.run(steps=20, print_every=0)
    _assert_same_run(port, gp, jsim, gj, L)
    if mode == "cells":
        q = port.molecules().q
        assert float((q[:, 0] - 1).abs().max()) > 1e-4  # rigid rotation
        np.testing.assert_allclose(np.asarray(q), np.asarray(jsim.molecules().q),
                                   atol=1e-9)


def test_rmm_engine_matches_general_engine(tmp_path):
    """tests/test_rmm_engine.py::test_rmm_engine_matches_general_engine in
    the port: same physics, same leapfrog and thermostat; only the state
    layout and summation orders differ (f64: 1e-9 after 12 steps)."""
    path, L = _xml(tmp_path, 1024, 0.6)
    rmm = MDSimulation.from_xml(path, dtype=torch.float64, force_mode="rmm",
                                device="cpu")
    gen = MDSimulation.from_xml(path, dtype=torch.float64, force_mode="pallas",
                                device="cpu")
    assert isinstance(rmm.engine, RMMEngine)
    assert isinstance(gen.engine, SingleChipSimulation)
    gr = rmm.run(steps=12, print_every=0)
    gg = gen.run(steps=12, print_every=0)
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gr, name)),
                                   float(getattr(gg, name)), rtol=1e-9)
    assert int(gr.n) == int(gg.n) == 1024
    _, r_r, v_r = _by_mid(rmm.molecules())
    _, r_g, v_g = _by_mid(gen.molecules())
    dr = r_r - r_g
    dr -= L * np.round(dr / L)
    np.testing.assert_allclose(dr, 0.0, atol=1e-9)
    np.testing.assert_allclose(v_r, v_g, atol=1e-9)


def test_small_box_falls_through_to_general_engine(tmp_path):
    """A box too small for a >= 4-cell RMM grid runs the general engine
    under "auto" and even under "rmm"; tiny scenes take the N^2 sweep."""
    path, _ = _xml(tmp_path, 200, 0.6)
    for mode in ("auto", "rmm"):
        sim = MDSimulation.from_xml(path, dtype=torch.float64, force_mode=mode,
                                    device="cpu")
        assert isinstance(sim.engine, SingleChipSimulation)
        assert not isinstance(sim.engine._force_fn, CudaLJPath)
    gv = sim.run(steps=5, print_every=0)
    assert np.isfinite(float(gv.upot)) and int(gv.n) == 200
    assert abs(float(gv.temperature) / 1.1 - 1) < 0.1
    assert sim.forces_array().shape == (200, 3)
    # an empty scene runs too (the N^2 sweep over no molecules)
    data = cubic_grid(8, [9.0] * 3, 1.1)
    empty = type(data)(**{**vars(data), **{k: getattr(data, k)[:0] for k in
                                           ("r", "v", "q", "L", "cid", "mid")}})
    sim = MDSimulation(XMLConfig(timestep=0.002, temperature=1.1,
                                 box=np.full(3, 9.0), cutoff=2.5, lj_cutoff=2.5,
                                 ensemble_type="NVT"),
                       phase_space_data=empty, device="cpu")
    gv = sim.run(steps=2, print_every=0)
    assert int(gv.n) == 0 and float(gv.upot) == 0.0


def _slab_data(axis, mod, n=500, seed=11):
    """A liquid slab (a jittered 8^3 lattice, 3 sigma up the long axis)
    normal to `axis` in a box five times as long on that axis, the rest
    vacuum:
    (PhaseSpaceData, box)."""
    box = np.array([8.2, 8.2, 8.2])
    box[axis] = 41.0
    rng = np.random.default_rng(seed)
    data = mod(n, box, 1.1, seed=seed)
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3)[rng.permutation(512)[:n]].astype(float)
    data.r = (g + 0.5 + rng.uniform(-0.1, 0.1, g.shape)) * 1.02
    data.r[:, axis] += 3.0
    return data, box


@pytest.mark.parametrize("axis", [2, 1], ids=["adaptive-z", "axis-swap"])
def test_inhomogeneous_scene_matches_jax(axis):
    """A vapour-dominated slab: non-uniform z rows are adopted, and with
    the slab normal to y that axis is swapped onto z in the engine
    frame; accessors give the original frame."""
    pdata, box = _slab_data(axis, cubic_grid)
    jdata, _ = _slab_data(axis, jax_cubic_grid)
    kw = dict(timestep=0.002, temperature=1.1, box=box, cutoff=2.5,
              lj_cutoff=2.5, ensemble_type="NVT")
    port = MDSimulation(XMLConfig(**kw), dtype=torch.float64,
                        phase_space_data=pdata, force_mode="cells", device="cpu")
    jsim = JaxMD(JaxXMLConfig(**kw), dtype=jnp.float64,
                 phase_space_data=jdata, force_mode="cells")
    assert port._axis_swap == jsim._axis_swap == (None if axis == 2 else 1)
    assert port._z_edges is not None and port._z_edges == jsim._z_edges
    assert port.engine.spec.z_edges == jsim.engine.spec.z_edges
    assert port.engine.spec.dims == jsim.engine.spec.dims
    gp = port.run(steps=8, print_every=0)
    gj = jsim.run(steps=8, print_every=0)
    _assert_same_run(port, gp, jsim, gj, box)
    np.testing.assert_allclose(np.asarray(port.forces_array()),
                               np.asarray(jsim.forces_array()), atol=1e-8)
    snap = port._export_phasespace()
    np.testing.assert_allclose(snap.box, box)
    # original frame: only the long axis reaches beyond the short edge
    assert snap.r[:, axis].max() > 8.2 > np.delete(snap.r, axis, 1).max()


def test_overflow_respec_continues(tmp_path):
    """A cell capacity forced too small overflows; at the watchdog the
    driver re-measures, rebuilds the engine and goes on."""
    path, _ = _xml(tmp_path, 600, 0.6)
    sim = MDSimulation.from_xml(path, dtype=torch.float64, force_mode="cells",
                                cell_cap=4, device="cpu")
    eng0 = sim.engine
    assert eng0.spec.cap == 4
    gv = sim.run(steps=3, print_every=0)
    assert sim.engine is not eng0 and sim.engine.spec.cap >= 32
    assert sim.engine._step_count == sim.step == 3
    gv = sim.run(steps=3, print_every=0)
    assert int(gv.n) == 600 and np.isfinite(float(gv.upot))


def test_unsupported_settings_raise(tmp_path, monkeypatch):
    path, _ = _xml(tmp_path, 600, 0.6)
    cfg = read_xml_config(path)
    cfg.cells_in_cutoff = 2
    with pytest.raises(ValueError, match="cellsInCutoffRadius"):
        MDSimulation(cfg, device="cpu")
    cfg.cells_in_cutoff = 1
    with pytest.raises(ValueError, match="force_mode"):
        MDSimulation(cfg, force_mode="fast", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDSimulation(cfg, force_mode="pallas")
