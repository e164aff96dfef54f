"""The RMM path end to end: the port's MDSimulation against the JAX
package's MDSimulation, both with force_mode="rmm" (MDSimulation ->
RMMEngine -> RMMSimulation), f64 on the CPU, on CubicGridGenerator XML
scenes written to tmp_path.  One scene lands on cap 32, one escalates to
cap 64 in pick_rmm_grid.  After 20 steps, T, p and Upot agree to rtol
1e-9 and every molecule's r and v to atol 1e-10.

Both sides use force_mode="rmm": the JAX driver's "auto" sends scenes
this small to its N^2 oracle.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, read_xml_config
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from ls1_mardyn_tpu_torch.ops.rmm import CellCapacityError

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XML = """<?xml version="1.0" encoding="UTF-8"?>
<mardyn version="20100525">
  <simulation type="MD">
    <integrator type="Leapfrog"><timestep>0.002</timestep></integrator>
    <run><currenttime>0</currenttime>
      <production><steps>{steps}</steps></production></run>
    <ensemble type="{ensemble}">
      <temperature>1.1</temperature>
      <domain type="box"><lx>{L}</lx><ly>{L}</ly><lz>{L}</lz></domain>
      <components>
        <moleculetype id="1" name="Argon">
          <site type="LJ126" id="1">
            <coords><x>0</x><y>0</y><z>0</z></coords>
            <mass>1.0</mass><sigma>1.0</sigma><epsilon>1.0</epsilon>
            <shifted>{shifted}</shifted>
          </site>{extra_site}
        </moleculetype>
      </components>
      <phasespacepoint>
        <generator name="CubicGridGenerator">
          <numMolecules>{n}</numMolecules>
        </generator>
      </phasespacepoint>
    </ensemble>
    <algorithm>
      <datastructure type="LinkedCells">
        <cellsInCutoffRadius>1</cellsInCutoffRadius></datastructure>
      <cutoffs type="CenterOfMass"><radiusLJ>2.5</radiusLJ></cutoffs>
    </algorithm>
  </simulation>
</mardyn>
"""

CHARGE = """
          <site type="Charge" id="2">
            <coords><x>0</x><y>0</y><z>0.1</z></coords>
            <mass>0.0</mass><charge>0.5</charge>
          </site>"""


def _xml(tmp_path, n, rho, steps=20, shifted=0, ensemble="NVT", extra_site=""):
    L = (n / rho) ** (1.0 / 3.0)
    p = tmp_path / f"scene_{n}_{rho}.xml"
    p.write_text(XML.format(n=n, L=repr(L), steps=steps, shifted=shifted,
                            ensemble=ensemble, extra_site=extra_site))
    return str(p), L


def _by_mid(mol):
    valid = np.asarray(mol.valid)
    mid = np.asarray(mol.mid)[valid]
    o = np.argsort(mid)
    return mid[o], np.asarray(mol.r)[valid][o], np.asarray(mol.v)[valid][o]


_JAX_RUNS = {}


def _jax_run(path, key):
    """The JAX driver's 20-step run of a scene, once per scene and test
    process: (engine, last GlobalValues, molecules by id)."""
    if key not in _JAX_RUNS:
        jsim = JaxMD.from_xml(path, dtype=jnp.float64, force_mode="rmm")
        gj = jsim.run(steps=20, print_every=0)
        _JAX_RUNS[key] = (jsim.engine, gj, _by_mid(jsim.molecules()))
    return _JAX_RUNS[key]


def _compare(port, gp, jax_run, L, n):
    _, gj, (mid_j, r_j, v_j) = jax_run
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=1e-9,
                                   err_msg=name)
    mid_p, r_p, v_p = _by_mid(port.molecules())
    np.testing.assert_array_equal(mid_p, mid_j)
    assert len(mid_p) == n
    dr = r_p - r_j
    dr -= L * np.round(dr / L)
    np.testing.assert_allclose(dr, 0.0, atol=1e-10)
    np.testing.assert_allclose(v_p, v_j, atol=1e-10)


@pytest.mark.parametrize(
    "n,rho,shifted,cap",
    [(1024, 0.6, 0, 32), (1500, 0.6, 1, 64)],
)
def test_driver_matches_jax(tmp_path, n, rho, shifted, cap):
    path, L = _xml(tmp_path, n, rho, shifted=shifted)
    port = MDSimulation.from_xml(path, dtype=torch.float64, force_mode="rmm",
                                 device="cpu")
    jrun = _jax_run(path, (n, rho, shifted))
    jeng = jrun[0]
    assert port.engine.spec.cap == jeng.spec.cap == cap
    assert port.engine.spec.dims == jeng.spec.dims
    assert port.engine.sim.rebin_every == jeng.sim.rebin_every
    gp = port.run(steps=20, print_every=0)
    _compare(port, gp, jrun, L, n)


def test_driver_respec_on_capacity_overflow(tmp_path):
    """A capacity overflow at a rebin makes the driver re-spec the grid
    at twice the cap and go on from the untouched state: the trajectory
    still matches the JAX run, which never overflowed."""
    n, rho = 1024, 0.6
    path, L = _xml(tmp_path, n, rho)
    port = MDSimulation.from_xml(path, dtype=torch.float64, force_mode="rmm",
                                 device="cpu")
    port.engine.sim.rebin_every = 4
    eng0 = port.engine

    def full_cell():
        raise CellCapacityError("forced overflow")

    eng0.sim.rebin = full_cell
    gp = port.run(steps=20, print_every=0)
    assert port.engine is not eng0
    assert port.engine.spec.cap == 64
    _compare(port, gp, _jax_run(path, (n, rho, 0)), L, n)


def test_engine_retarget_moves_the_thermostat(tmp_path):
    path, _ = _xml(tmp_path, 1024, 0.6)
    port = MDSimulation.from_xml(path, dtype=torch.float64, device="cpu")
    t0 = float(port.run(steps=2, print_every=0).temperature)
    port.engine.retarget(0.8)
    assert port.engine.config.target_temperature == 0.8
    t1 = float(port.run(steps=6, print_every=0).temperature)
    assert abs(t1 - 0.8) < 0.25 * abs(t0 - 0.8)


def test_cli_runs_on_cpu(tmp_path):
    path, _ = _xml(tmp_path, 1200, 0.6, steps=5)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "ls1_mardyn_tpu_torch", path, "-N", "5",
         "--device", "cpu", "--print-every", "5",
         "--final-checkpoint", str(tmp_path / "final.inp")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Simstep = 5" in res.stdout + res.stderr
    assert (tmp_path / "final.inp").read_text().count("\n") > 1200


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ls1_mardyn_tpu'] = None\n"
        "import ls1_mardyn_tpu_torch, torch\n"
        "import ls1_mardyn_tpu_torch.cli, ls1_mardyn_tpu_torch.driver\n"
        "import ls1_mardyn_tpu_torch.interop\n"
        "import ls1_mardyn_tpu_torch.plugins, ls1_mardyn_tpu_torch.native\n"
        "import ls1_mardyn_tpu_torch.plugins.writers\n"
        "import ls1_mardyn_tpu_torch.plugins.diagnostics\n"
        "import ls1_mardyn_tpu_torch.plugins.nemd, ls1_mardyn_tpu_torch.plugins.nemd2\n"
        "import ls1_mardyn_tpu_torch.plugins.mettdeamon\n"
        "import ls1_mardyn_tpu_torch.plugins.extra, ls1_mardyn_tpu_torch.plugins.widom\n"
        "import ls1_mardyn_tpu_torch.ensemble.grand_canonical\n"
        "import ls1_mardyn_tpu_torch.ensemble.cavity\n"
        "import ls1_mardyn_tpu_torch.io.binary_io\n"
        "import ls1_mardyn_tpu_torch.io.compression\n"
        "import ls1_mardyn_tpu_torch.ops.rdf\n"
        "import ls1_mardyn_tpu_torch.ops.ewald, ls1_mardyn_tpu_torch.ops.pme\n"
        "import ls1_mardyn_tpu_torch.ops.lrc_planar\n"
        "import ls1_mardyn_tpu_torch.ops.fmm, ls1_mardyn_tpu_torch.ops.fmm_adaptive\n"
        "import ls1_mardyn_tpu_torch.utils.meminfo\n"
        "import ls1_mardyn_tpu_torch.utils.sysmon\n"
        "import ls1_mardyn_tpu_torch.utils.expression\n"
        "from ls1_mardyn_tpu_torch.native import get_psio, lz4_compress\n"
        "assert get_psio() is not None and lz4_compress(b'x')\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def _cfg(tmp_path, n=1200, **kw):
    path, _ = _xml(tmp_path, n, 0.6, **kw)
    return read_xml_config(path)


@pytest.mark.parametrize("case,slice_", [("plugin", 6)])
def test_out_of_slice_scene_raises(tmp_path, case, slice_):
    """What later slices bring raises, naming the slice (long-range
    electrostatics and the planar correction are ported:
    tests/test_torch_longrange_driver.py; muVT:
    tests/test_torch_ensembles_driver.py)."""
    cfg = _cfg(tmp_path)
    cfg.output_plugins.append(PluginSpec("RDF", {}))
    with pytest.raises(NotImplementedError, match=f"ROADMAP slice {slice_}"):
        MDSimulation(cfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize(
    "mode,kernel",
    [("auto", "K5"), ("pallas", "K5"), ("ms_dense", "K6")],
    ids=["charges", "charges_pallas", "force_mode"],
)
def test_multisite_scene_takes_the_multisite_kernels(tmp_path, mode, kernel):
    """A multi-site scene under "auto" or "pallas" goes to the multi-site
    kernels, as in the JAX driver: the packed K5 wherever its rows can
    run; "ms_dense" asks for K6.  It does not slide onto the plain
    traversal."""
    # large enough that the cost rule does not pick the N^2 sweep
    cfg = _cfg(tmp_path, n=3000, extra_site=CHARGE)
    sim = MDSimulation(cfg, dtype=torch.float64, device="cpu", force_mode=mode)
    path = sim.engine._force_fn
    assert type(path) is {"K5": CudaMultiSitePackedPath,
                          "K6": CudaMultiSitePath}[kernel]


def test_rmm_mode_needs_1clj_scene(tmp_path):
    """"rmm" on a multi-site scene raises instead of sliding onto the
    N^2 sweep or the plain traversal."""
    cfg = _cfg(tmp_path, n=3000, extra_site=CHARGE)
    with pytest.raises(ValueError, match="force_mode='rmm' needs"):
        MDSimulation(cfg, dtype=torch.float64, device="cpu", force_mode="rmm")


def test_cuda_device_required_unless_cpu_requested(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDSimulation(_cfg(tmp_path))
