"""The observer plugins end to end: the port's MDSimulation against the
JAX package's on the same XML (1CLJ, N = 1500, f64, 20 steps, CPU; the
JAX kernels in interpret mode).

- Under force_mode "auto" the writer set (ResultWriter, EnergyLogWriter,
  MaxWriter, XyzWriter, CheckpointWriter in ASCII and binary,
  TimerWriter, SysMonOutput) keeps both drivers on the RMM engine, run
  through the library and through the CLI.
- MaxCheck and FlopRateWriter are not RMM-safe: both drivers run the
  general engine with the 1CLJ cell kernel (the port's K3, JAX's Pallas
  path).

Every output file has the JAX file's header and columns (timestamps and
wall-clock times aside) and numbers within rtol 1e-9; c_v equals JAX's
cv().  A re-spec under ResultWriter leaves one .res file with every
row.  N = 1500 is the smallest size at which both drivers' cost rules
pick the cell kernel (and so the RMM engine) over the N^2 sweep.
"""

import logging
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu_torch import cli
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.ascii_reader import read_inp
from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint
from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, read_xml_config
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
from ls1_mardyn_tpu_torch.ops.rmm import CellCapacityError
from ls1_mardyn_tpu_torch.utils.logger import global_log
from test_torch_driver import XML

torch.set_num_threads(1)

N, RHO, STEPS = 1500, 0.6, 20

WRITERS = """<output>
 <outputplugin name="ResultWriter"><writefrequency>5</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="EnergyLogWriter"><writefrequency>5</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="MaxWriter"><writefrequency>5</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="XyzWriter"><writefrequency>10</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="CheckpointWriter"><writefrequency>10</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="CheckpointWriter"><writefrequency>20</writefrequency>
  <type>binary</type><outputprefix>{d}/bin</outputprefix></outputplugin>
 <outputplugin name="TimerWriter"><writefrequency>10</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="SysMonOutput"><writefrequency>10</writefrequency>
 </outputplugin>
</output>"""

LIMITERS = """<output>
 <outputplugin name="ResultWriter"><writefrequency>5</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
 <outputplugin name="FlopRateWriter"><writefrequency>5</writefrequency>
  <outputprefix>{d}/run</outputprefix></outputplugin>
</output>
<plugin name="MaxCheck"><vmax>2.5</vmax></plugin>"""

FILES = ("run.res", "run.elog", "run.max", "run.buildup.xyz",
         "run-10.restart.dat", "run-20.restart.dat")


def write_xml(d, plugins, equilibration=0):
    """The 1CLJ scene of test_torch_driver with `plugins` writing into d;
    returns the XML's path."""
    L = (N / RHO) ** (1.0 / 3.0)
    text = XML.format(n=N, L=repr(L), steps=STEPS, shifted=0,
                      ensemble="NVT", extra_site="")
    text = text.replace("</algorithm>", "</algorithm>" + plugins.format(d=d))
    if equilibration:
        text = text.replace(
            "<run>", f"<run><equilibration><steps>{equilibration}</steps>"
                     "</equilibration>")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "config.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _tokens(line):
    return line.split()


def _number(tok):
    try:
        return float(tok)
    except ValueError:
        return None


def same_text(a, b, rtol=1e-9, columns=None):
    """Line by line and token by token: a token that is a number agrees
    within rtol, any other token is equal.  Lines that carry a
    timestamp agree up to it.  `columns` limits numeric rows to their
    first columns (FlopRateWriter's GFLOPS is a wall-clock rate)."""
    la = open(a).read().splitlines()
    lb = open(b).read().splitlines()
    assert len(la) == len(lb), (a, len(la), len(lb))
    for i, (x, y) in enumerate(zip(la, lb)):
        if " started at " in x or " finished at " in x:
            assert x.split(" at ")[0] == y.split(" at ")[0], (a, i)
            continue
        tx, ty = _tokens(x), _tokens(y)
        assert len(tx) == len(ty), (a, i, x, y)
        # whitespace between tokens (column layout) is identical
        assert re.sub(r"\S+", "x", x) == re.sub(r"\S+", "x", y), (a, i)
        for k, (p, q) in enumerate(zip(tx, ty)):
            if columns is not None and k >= columns:
                break
            fp, fq = _number(p), _number(q)
            if fp is None or fq is None:
                assert p == q, (a, i, k, p, q)
            else:
                assert math.isclose(fp, fq, rel_tol=rtol, abs_tol=0.0) or \
                    fp == fq, (a, i, k, p, q)


def same_timers(a, b):
    """TimerWriter files: the same step line, timers and call counts
    (the seconds are wall-clock)."""
    def shape(path):
        return [(t[0], t[-1]) if len(t) > 1 else tuple(t)
                for t in map(str.split, open(path).read().splitlines())]
    assert shape(a) == shape(b)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX driver's runs of both scenes, once per test process:
    {scene: (output dir, engine, force path, cv)}."""
    out = {}
    for key, plugins in (("writers", WRITERS), ("limiters", LIMITERS)):
        d = str(tmp_path_factory.mktemp(f"jax_{key}"))
        sim = JaxMD.from_xml(write_xml(d, plugins), dtype=jnp.float64)
        sim.run(steps=STEPS, print_every=0)
        out[key] = (d, type(sim.engine).__name__,
                    type(getattr(sim.engine, "_force_fn", None)).__name__,
                    sim.cv())
    return out


def run_port(d, plugins, equilibration=0, **kw):
    return MDSimulation.from_xml(write_xml(d, plugins, equilibration),
                                 dtype=torch.float64, device="cpu", **kw)


def test_writers_on_rmm_match_jax(tmp_path, jax_runs, caplog):
    dj, eng_j, _, cv_j = jax_runs["writers"]
    d = str(tmp_path)
    with caplog.at_level(logging.INFO, logger="ls1_torch"):
        sim = run_port(d, WRITERS)
        assert type(sim.engine).__name__ == eng_j == "RMMEngine"
        sim.run(steps=STEPS, print_every=0)
    for name in FILES:
        same_text(os.path.join(d, name), os.path.join(dj, name))
    same_binary_checkpoint(d, dj)
    same_timers(os.path.join(d, "run.timers"), os.path.join(dj, "run.timers"))
    assert caplog.text.count("System Monitor (") == 4  # initial, 10, 20, final
    assert math.isclose(sim.cv(), cv_j, rel_tol=1e-9)
    rows = [ln.split() for ln in open(os.path.join(d, "run.res"))]
    assert [int(r[0]) for r in rows if r[0].isdigit()] == [5, 10, 15, 20]


def same_binary_checkpoint(d, dj):
    """The port's binary checkpoint against the JAX package's ASCII one
    (its CheckpointWriter ignores <type>), molecules matched by id."""
    path = os.path.join(d, "bin-20.restart.dat")
    a = read_binary_checkpoint(path, path + ".header.xml")
    b = read_inp(os.path.join(dj, "bin-20.restart.dat"))
    oa, ob = np.argsort(a.mid), np.argsort(b.mid)
    np.testing.assert_array_equal(a.mid[oa], b.mid[ob])
    for k in ("r", "v", "q", "L"):
        np.testing.assert_allclose(getattr(a, k)[oa], getattr(b, k)[ob],
                                   rtol=1e-9, atol=0, err_msg=k)
    np.testing.assert_array_equal(a.box, b.box)
    assert a.current_time == b.current_time


def test_cli_writes_the_jax_files(tmp_path, jax_runs, monkeypatch):
    """`python -m ls1_mardyn_tpu_torch <xml> --device cpu --precision
    f64` (in process) writes the JAX run's files, a binary checkpoint
    included."""
    dj = jax_runs["writers"][0]
    d = str(tmp_path)
    path = write_xml(d, WRITERS)
    monkeypatch.chdir(tmp_path)
    handlers, level = list(global_log.handlers), global_log.level
    try:
        assert cli.main([path, "--device", "cpu", "--precision", "f64",
                         "--logfile", "cli.log"]) == 0
    finally:
        for h in global_log.handlers:
            h.close()
        global_log.handlers[:] = handlers
        global_log.setLevel(level)
    log = open("cli.log").read()
    assert "engine: RMM dense fast path" in log
    assert log.count("System Monitor (") == 4
    for name in FILES:
        same_text(os.path.join(d, name), os.path.join(dj, name))
    same_binary_checkpoint(d, dj)


def test_limiters_take_the_general_engine(tmp_path, jax_runs):
    dj, eng_j, path_j, _ = jax_runs["limiters"]
    d = str(tmp_path)
    sim = run_port(d, LIMITERS)
    assert type(sim.engine).__name__ == eng_j == "SingleChipSimulation"
    assert path_j == "PallasLJPath"
    assert isinstance(sim.engine._force_fn, CudaLJPath) and sim.engine._force_fn.cw
    sim.run(steps=STEPS, print_every=0)
    same_text(os.path.join(d, "run.res"), os.path.join(dj, "run.res"))
    same_text(os.path.join(d, "run.floprate"), os.path.join(dj, "run.floprate"),
              columns=2)


def test_respec_keeps_one_result_file(tmp_path, jax_runs):
    """A capacity overflow at a rebin re-specs the grid mid-run: the
    rebuilt driver adopts the plugins, so the .res file is neither
    truncated nor written twice and holds the JAX run's rows."""
    dj = jax_runs["writers"][0]
    d = str(tmp_path)
    # "rmm": under "auto" the doubled cap sends a scene this small to the
    # N^2 sweep
    sim = run_port(d, WRITERS, force_mode="rmm")
    plugins = list(sim._plugins)
    eng0 = sim.engine
    eng0.sim.rebin_every = 12

    def full_cell():
        raise CellCapacityError("forced overflow")

    eng0.sim.rebin = full_cell
    sim.run(steps=STEPS, print_every=0)
    assert sim.engine is not eng0
    assert type(sim.engine).__name__ == "RMMEngine"
    assert sim._plugins == plugins
    for name in ("run.res", "run.elog", "run-20.restart.dat"):
        same_text(os.path.join(d, name), os.path.join(dj, name))


def test_cv_after_equilibration(tmp_path):
    """c_v samples only macro-fresh steps after <equilibration><steps>
    (Domain::record_cv): three runs of 4 steps compute Upot on steps 4,
    8 and 12, and only 8 and 12 come after step 6."""
    sim = run_port(str(tmp_path), "", equilibration=6)
    u = []
    for _ in range(3):
        gv = sim.run(steps=4, print_every=0)
        u.append(float(gv.upot))
    assert sim._cv_n == 2
    n, t = float(gv.n), float(gv.temperature)
    u = np.array(u[1:])
    want = 1.5 + (np.sum(u * u) - np.sum(u) ** 2 / 2) / (2 * n * t * t)
    assert math.isclose(sim.cv(), want, rel_tol=1e-9)


def _cfg(tmp_path, *specs):
    cfg = read_xml_config(write_xml(str(tmp_path), ""))
    cfg.output_plugins.extend(PluginSpec(n, p) for n, p in specs)
    return cfg


def test_rmm_mode_refuses_an_unsafe_plugin(tmp_path):
    cfg = _cfg(tmp_path, ("MaxCheck", {"vmax": "2.5"}))
    with pytest.raises(ValueError, match="force_mode='rmm'.*MaxCheck"):
        MDSimulation(cfg, dtype=torch.float64, device="cpu", force_mode="rmm")


def test_unknown_plugin_is_ignored(tmp_path, caplog):
    cfg = _cfg(tmp_path, ("NoSuchPlugin", {}),
               ("TestPlugin", {}))
    with caplog.at_level(logging.WARNING, logger="ls1_torch"):
        sim = MDSimulation(cfg, dtype=torch.float64, device="cpu")
    assert "ignoring unknown plugin 'NoSuchPlugin'" in caplog.text
    assert [p.name for p in sim._plugins] == ["TestPlugin"]
    assert type(sim.engine).__name__ == "RMMEngine"
    sim.run(steps=2, print_every=0)
    assert sim._plugins[0].calls[:4] == [
        ("beforeEventNewTimestep", 1), ("beforeForces", 1),
        ("afterForces", 1), ("endStep", 1)]
