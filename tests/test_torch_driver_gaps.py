"""The driver's remaining inputs and run options in the port, against the
JAX package where it has the same function (CPU, f64):

- each generator branch of the driver (MkesferaGenerator,
  MkTcTSGenerator, PerCellGenerator, MultiObjectGenerator with a
  ReplicaFiller reading a binary checkpoint and a GridFiller) through
  XML gives the JAX driver's PhaseSpaceData;
- ops/rdf's pair counts and distance histogram equal JAX's;
- loop_abort_time, timed_checkpoint and the profiler window;
- every CLI flag of the slice parses and runs on --device cpu, and
  --print-meminfo prints.
"""

import json
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.ops import cells as jcells
from ls1_mardyn_tpu.ops import rdf as jrdf
from ls1_mardyn_tpu.state import MoleculeState as JaxMol
from ls1_mardyn_tpu_torch import cli
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.ascii_reader import read_inp
from ls1_mardyn_tpu_torch.io.binary_io import write_binary_checkpoint
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.ops import cells, rdf
from ls1_mardyn_tpu_torch.state import MoleculeState
from ls1_mardyn_tpu_torch.utils.logger import global_log
from test_torch_driver import REPO, XML

torch.set_num_threads(1)

GENERATORS = {
    "mkesfera": (16.0, """<generator name="MkesferaGenerator">
        <droplet><radius>4.0</radius></droplet>
        <density-liquid>0.7</density-liquid>
        <density-vapor>0.02</density-vapor></generator>"""),
    "mktcts": (12.0, """<generator name="MkTcTSGenerator">
        <density-liquid>0.7</density-liquid>
        <density-vapor>0.03</density-vapor>
        <liq_fraction>0.4</liq_fraction></generator>"""),
    "percell": (12.0, """<generator name="PerCellGenerator">
        <numMoleculesPerCell>5</numMoleculesPerCell>
        <initTemperature>0.9</initTemperature></generator>"""),
    "multiobject": (10.0, """<generator name="MultiObjectGenerator">
        <objectgenerator>
          <filler type="ReplicaFiller">
            <input type="BinaryReader"><header>cell.dat.header.xml</header>
              <data>cell.dat</data></input></filler>
          <object type="Cuboid"><lower><x>0</x><y>0</y><z>0</z></lower>
            <upper><x>10</x><y>5</y><z>10</z></upper></object>
        </objectgenerator>
        <objectgenerator>
          <filler type="GridFiller">
            <lattice><system>cubic</system><centering>face</centering>
            </lattice>
            <basis><site><componentid>1</componentid>
              <coordinate><x>0.5</x><y>0.5</y><z>0.5</z></coordinate>
            </site></basis>
            <density>0.1</density></filler>
          <object type="Cuboid"><lower><x>0</x><y>5</y><z>0</z></lower>
            <upper><x>10</x><y>10</y><z>10</z></upper></object>
          <velocityAssigner type="EqualVelocityDistribution"/>
        </objectgenerator></generator>"""),
}


def scene_xml(d, L, phasespace, steps=10, output=""):
    """The test_torch_driver scene in a box of edge L with another
    <phasespacepoint> body and an optional <output> block."""
    text = XML.format(n=1, L=repr(L), steps=steps, shifted=0, ensemble="NVT",
                      extra_site="")
    i = text.index("<phasespacepoint>") + len("<phasespacepoint>")
    j = text.index("</phasespacepoint>")
    text = text[:i] + phasespace + text[j:]
    text = text.replace("</algorithm>", "</algorithm>" + output)
    path = os.path.join(d, "config.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_through_xml_matches_jax(tmp_path, name):
    L, body = GENERATORS[name]
    d = str(tmp_path)
    if name == "multiobject":
        cell = cubic_grid(100, [5.0] * 3, 1.0, seed=4)
        write_binary_checkpoint(os.path.join(d, "cell.dat"),
                                os.path.join(d, "cell.dat.header.xml"), cell)
    path = scene_xml(d, L, body)
    port = MDSimulation.from_xml(path, dtype=torch.float64, device="cpu",
                                 allow_axis_swap=False)
    ref = JaxMD.from_xml(path, dtype=jnp.float64, allow_axis_swap=False)
    a, b = port.phase_space, ref.phase_space
    assert len(a.mid) > 50
    for k in ("mid", "cid", "r", "v", "q", "L", "box"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)


def test_pair_counts_and_histogram_match_jax():
    """Two components at rho 0.5 in an 11 x 12 x 13 box, rc_lj 2.5 and
    rc_c 3.5 (grid of the larger cutoff, cap from the occupancy)."""
    rng = np.random.default_rng(9)
    box = (11.0, 12.0, 13.0)
    n = int(0.5 * np.prod(box))
    r = rng.random((n, 3)) * box
    cid = rng.integers(0, 2, n).astype(np.int32)
    dims = tuple(int(b // 3.5) for b in box)
    kw = dict(dims=dims, box=box, cap=48)
    spec, jspec = cells.CellGridSpec(**kw), jcells.CellGridSpec(**kw)
    ids, shift = cells.neighbor_table(spec)
    jids, jshift = jcells.neighbor_table(jspec)
    valid = np.ones(n, bool)
    valid[::17] = False
    lj, cc, ovf = rdf.pair_count_by_component(
        torch.as_tensor(r), torch.as_tensor(valid), torch.as_tensor(cid),
        spec, ids, shift, 2.5 ** 2, 3.5 ** 2, 2)
    jlj, jcc, jovf = jrdf.pair_count_by_component(
        jnp.asarray(r), jnp.asarray(valid), jnp.asarray(cid), jspec,
        jnp.asarray(jids), jnp.asarray(jshift), 2.5 ** 2, 3.5 ** 2, 2)
    assert not bool(ovf) and not bool(jovf)
    np.testing.assert_array_equal(lj.numpy(), np.asarray(jlj))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(jcc))
    assert lj.sum() > 1000
    h = rdf.pair_distance_histogram(
        MoleculeState.from_numpy(r=r, v=np.zeros_like(r), cid=cid,
                                 dtype=torch.float64, device="cpu"),
        spec, ids, shift, 3.5, 35)
    jh = jrdf.pair_distance_histogram(
        JaxMol.from_numpy(r=r, v=np.zeros_like(r), cid=cid,
                          dtype=jnp.float64), jspec,
        jnp.asarray(jids), jnp.asarray(jshift), 3.5, 35)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def _lattice_xml(d, n=1000, rho=0.6, **kw):
    L = (n / rho) ** (1 / 3)
    return scene_xml(d, L, f"""<generator name="CubicGridGenerator">
        <numMolecules>{n}</numMolecules></generator>""", **kw)


def test_loop_abort_and_timed_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = _lattice_xml(str(tmp_path))
    sim = MDSimulation.from_xml(path, dtype=torch.float64, device="cpu")
    sim.run(steps=10, print_every=0, loop_abort_time=1e-9)
    assert sim.step == 1
    assert not os.path.exists("timed.restart.dat")
    sim.run(steps=10, print_every=0, timed_checkpoint=1e-9)
    assert sim.step == 2
    got = read_inp("timed.restart.dat")
    want = sim._export_phasespace()
    np.testing.assert_array_equal(got.mid, want.mid)
    np.testing.assert_array_equal(got.r, want.r)
    np.testing.assert_array_equal(got.v, want.v)
    assert got.current_time == want.current_time


def test_profile_window_writes_a_trace(tmp_path):
    path = _lattice_xml(str(tmp_path))
    sim = MDSimulation.from_xml(path, dtype=torch.float64, device="cpu")
    trace = tmp_path / "trace"
    sim.run(steps=6, print_every=0, profile_dir=str(trace),
            profile_steps=(2, 4))
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # a window beyond the run is clamped into it
    sim.run(steps=3, print_every=0, profile_dir=str(tmp_path / "t2"))
    assert (tmp_path / "t2" / "trace.json").exists()


@pytest.fixture
def restore_logger():
    handlers, level = list(global_log.handlers), global_log.level
    yield
    for h in global_log.handlers:
        h.close()
    global_log.handlers[:] = handlers
    global_log.setLevel(level)


def test_cli_flags_run_on_cpu(tmp_path, monkeypatch, restore_logger):
    monkeypatch.chdir(tmp_path)
    out = ("<output><outputplugin name=\"ResultWriter\"><writefrequency>2"
           "</writefrequency><outputprefix>cli</outputprefix></outputplugin>"
           "</output>")
    path = _lattice_xml(str(tmp_path), output=out)
    rc = cli.main([path, "-N", "6", "--device", "cpu", "--precision", "f64",
                   "--loop-abort-time", "600", "--timed-checkpoint", "600",
                   "--print-meminfo", "--profile", "prof",
                   "--profile-steps", "2:4", "-S", "--logfile", "run.log",
                   "-v", "--print-every", "3",
                   "--final-checkpoint", "final.inp"])
    assert rc == 0
    log = (tmp_path / "run.log").read_text()
    assert "Simstep = 6" in log and "host RSS" in log
    assert global_log.level == logging.DEBUG
    assert (tmp_path / "prof" / "trace.json").exists()
    assert len(read_inp("final.inp").mid) == 1000
    rows = [ln.split() for ln in open("cli.res")]
    assert [r[0] for r in rows if r[0].isdigit()] == ["2", "4", "6"]
    assert not os.path.exists("timed.restart.dat")
    rc = cli.main([path, "-N", "2", "--device", "cpu",
                   "--legacy-cell-processor", "--logfile", "legacy.log"])
    assert rc == 0
    assert "general multi-site cell traversal" in \
        (tmp_path / "legacy.log").read_text()


def test_cli_module_prints_meminfo_and_runs_tests(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    path = _lattice_xml(str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-m", "ls1_mardyn_tpu_torch", path, "-N", "2",
         "--device", "cpu", "--print-meminfo"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Memory info:" in res.stdout and "host RSS:" in res.stdout
    tdir = tmp_path / "t"
    tdir.mkdir()
    (tdir / "test_one.py").write_text("def test_one():\n    assert True\n")
    res = subprocess.run(
        [sys.executable, "-m", "ls1_mardyn_tpu_torch", "--tests",
         "--test-dir", str(tdir)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:]
    assert "1 passed" in res.stdout


@pytest.mark.parametrize("plugin,swap", [("ResultWriter", True),
                                         ("LoadImbalanceThroughSleepPlugin", False)])
def test_plugins_gate_the_axis_swap(tmp_path, plugin, swap):
    """A liquid slab normal to y swaps y onto z unless a plugin that is
    not known to be frame-free is configured, as in the JAX driver."""
    from ls1_mardyn_tpu.io.xml_config import PluginSpec as JaxSpec
    from ls1_mardyn_tpu.io.xml_config import read_xml_config as jax_read
    from ls1_mardyn_tpu_torch.io.generators import mktcts
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, read_xml_config

    path = scene_xml(str(tmp_path), 12.0, GENERATORS["percell"][1])
    data = mktcts(0.75, 0.0, [10.0, 40.0, 10.0], 0.9, liq_fraction=0.25)
    cfg, jcfg = read_xml_config(path), jax_read(path)
    cfg.output_plugins.append(PluginSpec(plugin, {}))
    jcfg.output_plugins.append(JaxSpec(plugin, {}))
    got = MDSimulation._detect_swap_axis(data, cfg)
    assert got == JaxMD._detect_swap_axis(data, jcfg)
    assert got == (1 if swap else None)


def test_vectorization_tuner_and_sleep_plugin(tmp_path):
    out = (f"<output><outputplugin name=\"VectorizationTuner\"><counts>216,343"
           f"</counts><outputprefix>{tmp_path}/vt</outputprefix></outputplugin>"
           "</output><plugin name=\"LoadImbalanceThroughSleepPlugin\">"
           "<sleepTime>0.1</sleepTime></plugin>")
    path = _lattice_xml(str(tmp_path), output=out)
    sim = MDSimulation.from_xml(path, dtype=torch.float64, device="cpu")
    # neither is RMM-safe: the general engine
    assert type(sim.engine).__name__ == "SingleChipSimulation"
    rows = [ln.split() for ln in open(tmp_path / "vt.tuner")]
    assert rows[0][0] == "#N" and [r[0] for r in rows[1:]] == ["216", "343"]
    assert all(float(r[1]) > 0 for r in rows[1:])
    sim.run(steps=2, print_every=0)
