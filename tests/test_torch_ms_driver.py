"""The multi-site branch of the port's driver (ls1_mardyn_tpu_torch/driver.py:
MDSimulation with force_mode "ms_packed", "ms_dense" and "auto" on a
rigid multi-site scene, and "auto" on a 1CLJ scene that adopts
non-uniform z rows) against the JAX package's MDSimulation in the same
mode, f64 on the CPU, where the JAX driver runs its Pallas kernels in
interpret mode.  After the steps T, p and Upot agree to rtol 1e-9 and
r, v, q and L to 1e-9.

An explicit cell_cap makes both drivers skip their grid choosers, so
they run the same grid: "ms_packed" and the port's "auto" go to K5,
"ms_dense" to K6 (the JAX driver in interpret mode skips its choosers
in any case).  Without a cell_cap the port's packed grid chooser sizes
K5's grid; it agrees all the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io.generators import cubic_grid as jax_cubic_grid
from ls1_mardyn_tpu.io.xml_config import XMLConfig as JaxXMLConfig
from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu.ops.pallas_ms_packed import PallasMultiSitePackedPath
from ls1_mardyn_tpu.ops.pallas_ms_path import PallasMultiSitePath
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
from ls1_mardyn_tpu_torch.models.components import Component
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import pick_ms_grid_packed
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from test_torch_driver import _by_mid
from test_torch_ms_kernels import components

torch.set_num_threads(1)

STEPS = 5
N, RHO = 2744, 0.45


def _lattice(mod_grid, C):
    """A 2CLJ+quadrupole lattice of N molecules with random orientations
    and angular momenta, for either package."""
    L = (N / RHO) ** (1 / 3)
    data = mod_grid(N, [L] * 3, 1.1, components=components("2cljq", C, 2.5),
                    seed=3)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(N, 4))
    data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    data.L = rng.normal(0, 0.2, (N, 3))
    return data, np.full(3, L)


def _slab(mod_grid, seed=11):
    """A 1CLJ liquid slab (a jittered 14x14x12 lattice, 4 sigma up z) in a
    (14.4, 14.4, 48) box, the rest vapour: the drivers lay non-uniform z
    rows over it."""
    box = np.array([14.4, 14.4, 48.0])
    g = np.stack(np.meshgrid(np.arange(14), np.arange(14), np.arange(12),
                             indexing="ij"), -1).reshape(-1, 3).astype(float)
    data = mod_grid(len(g), box, 1.1, seed=seed)
    rng = np.random.default_rng(seed)
    data.r = (g + 0.5 + rng.uniform(-0.1, 0.1, g.shape)) * (14.4 / 14)
    data.r[:, 2] += 4.0
    return data, box


def _config(Cfg, box):
    return Cfg(timestep=0.002, temperature=1.1, box=box, cutoff=2.5,
               lj_cutoff=2.5, ensemble_type="NVT")


def _compare(port, gp, jsim, gj, box):
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=1e-9,
                                   err_msg=name)
    pm, jm = port.molecules(), jsim.molecules()
    mid_p, r_p, v_p = _by_mid(pm)
    mid_j, r_j, v_j = _by_mid(jm)
    np.testing.assert_array_equal(mid_p, mid_j)
    dr = r_p - r_j
    dr -= box * np.round(dr / box)
    np.testing.assert_allclose(dr, 0.0, atol=1e-9)
    np.testing.assert_allclose(v_p, v_j, atol=1e-9)
    op = np.argsort(np.asarray(pm.mid)[np.asarray(pm.valid)])
    oj = np.argsort(np.asarray(jm.mid)[np.asarray(jm.valid)])
    for k in ("q", "L"):
        np.testing.assert_allclose(
            np.asarray(getattr(pm, k))[np.asarray(pm.valid)][op],
            np.asarray(getattr(jm, k))[np.asarray(jm.valid)][oj], atol=1e-9,
            err_msg=k)


_JAX = {}


def _jax_run(key, build):
    if key not in _JAX:
        jsim = build()
        _JAX[key] = (jsim, jsim.run(steps=STEPS, print_every=0))
    return _JAX[key]


@pytest.mark.parametrize("mode,cap", [("ms_packed", 32), ("ms_dense", 32),
                                      ("auto", 32), ("auto", 0)],
                         ids=["ms_packed", "ms_dense", "auto", "auto-chooser"])
def test_multisite_driver_matches_jax(mode, cap):
    pdata, box = _lattice(cubic_grid, Component)
    port = MDSimulation(_config(XMLConfig, box), dtype=torch.float64,
                        phase_space_data=pdata, force_mode=mode, cell_cap=cap,
                        device="cpu")
    path = port.engine._force_fn
    assert isinstance(path, CudaMultiSitePath)
    # the static rule: K5 wherever its packed rows can run, K6 when asked
    assert path.packed == (mode != "ms_dense")
    if cap:
        assert path.spec.cap == cap and path.spec.dims == (7, 7, 7)
    else:
        assert (path.spec.dims, path.spec.cap) == \
            pick_ms_grid_packed(pdata.r, box, 2.5)
    # the JAX driver's packed run (which "auto" shares), or its dense run
    jmode = "ms_dense" if mode == "ms_dense" else "ms_packed"

    def build():
        jdata, _ = _lattice(jax_cubic_grid, JaxComponent)
        return JaxMD(_config(JaxXMLConfig, box), dtype=jnp.float64,
                     phase_space_data=jdata, force_mode=jmode, cell_cap=32)

    jsim, gj = _jax_run(jmode, build)
    jpath = jsim.engine._force_fn
    assert type(jpath) is (PallasMultiSitePackedPath if jmode == "ms_packed"
                           else PallasMultiSitePath)
    gp = port.run(steps=STEPS, print_every=0)
    _compare(port, gp, jsim, gj, box)


def test_adaptive_z_1clj_runs_k6_and_matches_jax():
    """A 1CLJ slab in vapour adopts non-uniform z rows; the 1CLJ cell
    kernels need a uniform grid, so "auto" runs the dense multi-site
    kernel (K6), as the JAX driver does."""
    pdata, box = _slab(cubic_grid)
    jdata, _ = _slab(jax_cubic_grid)
    port = MDSimulation(_config(XMLConfig, box), dtype=torch.float64,
                        phase_space_data=pdata, device="cpu")
    jsim = JaxMD(_config(JaxXMLConfig, box), dtype=jnp.float64,
                 phase_space_data=jdata)
    assert port._z_edges is not None and port._z_edges == jsim._z_edges
    path = port.engine._force_fn
    assert type(path) is CudaMultiSitePath and path.spec.z_edges == port._z_edges
    assert isinstance(jsim.engine._force_fn, PallasMultiSitePath)
    gp = port.run(steps=STEPS, print_every=0)
    gj = jsim.run(steps=STEPS, print_every=0)
    _compare(port, gp, jsim, gj, box)
    assert int(gp.n) == len(pdata.mid)


def test_multisite_path_rules():
    """Two static rules of the port's multi-site branch: "ms_packed" on a
    grid below 3 cells on an axis runs the dense kernel (the packed rows'
    wrap halos need 3); and cells span the longer cutoff when the
    electrostatic one exceeds the LJ one, so no charge pair is dropped
    (forces equal the N^2 oracle's)."""
    data = cubic_grid(400, [6.0] * 3, 1.1,
                      components=components("2cljq", Component, 2.5), seed=3)
    cfg = XMLConfig(timestep=0.002, temperature=1.1, box=np.full(3, 6.0),
                    cutoff=2.5, lj_cutoff=2.5, ensemble_type="NVT")
    sim = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                       force_mode="ms_packed", cell_cap=32, device="cpu")
    path = sim.engine._force_fn
    assert type(path) is CudaMultiSitePath and path.spec.dims == (2, 2, 2)

    n, L = 1500, 14.0
    data = cubic_grid(n, [L] * 3, 1.1, components=components("ions", Component),
                      seed=4)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(n, 4))
    data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    data.cid = (np.arange(n) % 2).astype(data.cid.dtype)
    cfg = XMLConfig(timestep=0.002, temperature=1.1, box=np.full(3, L),
                    cutoff=3.4, lj_cutoff=2.5, ensemble_type="NVT")
    sim = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                       force_mode="ms_dense", device="cpu")
    path = sim.engine._force_fn
    assert isinstance(path, CudaMultiSitePath)
    assert min(path.spec.cell_len) >= 3.4 and path.spec.dims == (4, 4, 4)
    f, m, overflow = path(sim.engine.mol)
    assert not bool(overflow)
    fo, mo = compute_forces_n2(sim.engine.mol, sim.pp, sim.box)
    scale = float(fo.F.abs().max())
    assert float((f.F - fo.F).abs().max()) <= 1e-11 * scale
    np.testing.assert_allclose(float(m.upot), float(mo.upot), rtol=1e-10)
