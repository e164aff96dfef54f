"""The muVT ensemble, CavityWriter, WidomInsertion and the siteWiseForces
hook through the drivers: the port's MDSimulation against the JAX
package's (CPU, f64).

- muVT: a 1CLJ fluid (N = 216) with two insertions and two deletions a
  step for 12 steps, both ensembles fed the same draws
  (test_torch_gcmc.Draws): the molecule counts, T, p and Upot, and the
  state slot by slot (inserted molecules included, whose first
  half-kick reads the force an invalid slot holds).
- The reserve capacity, a re-spec that keeps the ensemble, and the
  control volume under an axis swap (the port permutes it into the
  engine frame; the JAX driver does not: ROADMAP Queue 3).
- CavityWriter and WidomInsertion files against JAX's (Widom's draws are
  JAX's key chain, injected).
- WallPotential and Mirror type 2 summed into Upot as JAX sums them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io.generators import cubic_grid as jgrid
from ls1_mardyn_tpu.io.xml_config import PluginSpec as JSpec
from ls1_mardyn_tpu.io.xml_config import XMLConfig as JConfig
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io.generators import cubic_grid as pgrid
from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, XMLConfig
from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation
from test_torch_gcmc import KEYS, Draws, jax_draws, port_draws

torch.set_num_threads(1)


def same_text(a, b, rtol=1e-9):
    """Line by line and token by token: equal, or numbers within rtol
    (the widom file's error column is nan before two blocks)."""
    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    assert len(la) == len(lb), (a, len(la), len(lb))
    for i, (x, y) in enumerate(zip(la, lb)):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty) and x.count("\t") == y.count("\t"), (a, i)
        for p, q in zip(tx, ty):
            if p != q:
                assert np.isclose(float(p), float(q), rtol=rtol, atol=0), (a, i, p, q)


N, RHO, T, STEPS = 216, 0.5, 1.5, 12


def muvt_config(cls, spec, n=N, rho=RHO, mu=-2.0, instances=2, control=None):
    """tests/test_ensembles_observables.py::
    test_muvt_driver_reserves_insertion_slots's scene (cls/spec: the
    JAX package's or the port's XMLConfig and PluginSpec)."""
    L = (n / rho) ** (1 / 3)
    cfg = cls(timestep=0.002, temperature=T, box=np.array([L, L, L]),
              cutoff=2.5, lj_cutoff=2.5, ensemble_type="muVT",
              generator=spec("CubicGridGenerator", {"numMolecules": str(n)}))
    p = {"mu": str(mu), "cid": "1", "interval": "1", "instances": str(instances)}
    if control is not None:
        p["control"] = control
    cfg.chemical_potentials.append(spec("ChemicalPotential", p))
    return cfg


@pytest.fixture(scope="module")
def muvt_runs():
    """Both drivers over STEPS steps with the same draws."""
    mp = pytest.MonkeyPatch()
    draws = Draws(STEPS, 4, seed=21)
    jsim = JaxMD(muvt_config(JConfig, JSpec), dtype=jnp.float64)
    jax_draws(mp, jsim.gc, draws)
    psim = MDSimulation(muvt_config(XMLConfig, PluginSpec), dtype=torch.float64,
                        device="cpu")
    port_draws(psim.gc, draws)
    try:
        jgv = jsim.run(steps=STEPS, print_every=0)
        pgv = psim.run(steps=STEPS, print_every=0)
    finally:
        mp.undo()
    return jsim, jgv, psim, pgv


def test_muvt_driver_matches_jax(muvt_runs):
    jsim, jgv, psim, pgv = muvt_runs
    assert isinstance(psim.engine, SingleChipSimulation)
    jg, pg = jsim.gc, psim.gc
    counters = [(g.attempted, g.accepted_del, g.accepted_ins) for g in (jg, pg)]
    assert counters[0] == counters[1], counters
    assert pg.accepted_ins > 0 and pg.accepted_del > 0
    assert pg.attempted == 4 * STEPS
    assert int(float(pgv.n)) == int(float(jgv.n)) == N + pg.accepted_ins - pg.accepted_del
    for k in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(pgv, k)), float(getattr(jgv, k)),
                                   rtol=1e-9, err_msg=k)
    jm, pm = jsim.molecules(), psim.molecules()
    for k in KEYS:
        a, b = getattr(pm, k).numpy(), np.asarray(getattr(jm, k))
        if k in ("cid", "mid", "valid"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            v = b[np.asarray(jm.valid)]
            np.testing.assert_allclose(a[np.asarray(jm.valid)], v, rtol=0,
                                       atol=1e-9 * max(1.0, np.abs(v).max()),
                                       err_msg=k)


def test_muvt_reserve_capacity(muvt_runs):
    jsim, _jgv, psim, _pgv = muvt_runs
    assert psim.engine.mol.capacity == jsim.engine.mol.capacity == N + 64
    cfg = muvt_config(XMLConfig, PluginSpec, n=1000, rho=0.6)
    assert MDSimulation(cfg, dtype=torch.float64, device="cpu").mol.capacity == 1125
    with pytest.raises(ValueError, match="muVT"):
        MDSimulation(cfg, dtype=torch.float64, device="cpu", force_mode="rmm")


def test_muvt_respec_keeps_ensemble():
    """A re-spec hands the ensemble (its generator and counters) to the
    rebuilt engine, whose state gets fresh reserve slots."""
    sim = MDSimulation(muvt_config(XMLConfig, PluginSpec), dtype=torch.float64,
                       device="cpu", force_mode="cells")
    sim.run(steps=3, print_every=0)
    gc = sim.gc
    before = (gc.attempted, gc.accepted_ins, gc.accepted_del)
    n = int(sim.engine.mol.valid.sum())
    sim._respec_cell_cap(2 * sim.engine.config.cell_cap)
    assert sim.gc is gc and (gc.attempted, gc.accepted_ins, gc.accepted_del) == before
    assert sim.engine.mol.capacity == n + 64
    gv = sim.run(steps=2, print_every=0)
    assert gc.attempted == before[0] + 2 * 4
    assert int(float(gv.n)) == N + gc.accepted_ins - gc.accepted_del


def test_muvt_control_volume_follows_axis_swap():
    """A slab along y in vacuum swaps y onto z in the engine frame.  The
    port permutes the world-frame control volume with it, so insertions
    land inside it in the world frame; the JAX driver keeps the world
    bounds against engine-frame positions (a fault recorded in ROADMAP
    Queue 3, not copied)."""
    n, Lx, Ly = 200, 8.0, 30.0

    def build(cls, spec, grid, md, **kw):
        data = grid(n, [Lx, 4.0, Lx], T, seed=3)
        data.r[:, 1] += 10.0
        data.box = np.array([Lx, Ly, Lx])
        cfg = cls(timestep=0.002, temperature=T, box=data.box, cutoff=2.5,
                  lj_cutoff=2.5, ensemble_type="muVT")
        cfg.chemical_potentials.append(spec("ChemicalPotential", {
            "mu": "4.0", "cid": "1", "interval": "1", "instances": "3",
            "control": {"lower": {"x": "0", "y": "20", "z": "0"},
                        "upper": {"x": "4", "y": "25", "z": "8"}}}))
        return md(cfg, phase_space_data=data, **kw)

    jsim = build(JConfig, JSpec, jgrid, JaxMD, dtype=jnp.float64)
    psim = build(XMLConfig, PluginSpec, pgrid, MDSimulation, dtype=torch.float64,
                 device="cpu")
    assert psim._axis_swap == jsim._axis_swap == 1
    lo, hi = np.array([0.0, 20.0, 0.0]), np.array([4.0, 25.0, 8.0])
    perm = [0, 2, 1]
    np.testing.assert_array_equal(psim.gc.chem_pots[0].control_lower, lo[perm])
    np.testing.assert_array_equal(psim.gc.chem_pots[0].control_upper, hi[perm])
    # the JAX ensemble holds the world bounds in the engine frame
    np.testing.assert_array_equal(jsim.gc.chem_pots[0].control_lower, lo)
    valid0 = psim.molecules().valid.clone()
    psim.run(steps=2, print_every=0)
    mol = psim.molecules()
    new = (mol.valid & ~valid0[:mol.capacity]).numpy()
    assert psim.gc.accepted_ins > 0 and new.any()
    r = mol.r.numpy()[new]
    assert ((r >= lo) & (r < hi)).all()


def widom_draws_of_jax(seed, n):
    """The port's WidomInsertion.draws replaced by the JAX plugin's key
    chain (plugins/widom.py:100-106)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(m, dtype, device):
        state["key"], k1, k2 = jax.random.split(state["key"], 3)
        u = np.asarray(jax.random.uniform(k1, (m, 3), dtype=jnp.float64))
        z = np.asarray(jax.random.normal(k2, (m, 4), dtype=jnp.float64))
        return (torch.tensor(u, dtype=dtype, device=device),
                torch.tensor(z, dtype=dtype, device=device))

    return draws


def sampler_config(cls, spec, d, n=200, rho=0.3):
    L = (n / rho) ** (1 / 3)
    return cls(
        timestep=0.002, temperature=1.5, box=np.array([L, L, L]), cutoff=2.5,
        lj_cutoff=2.5,
        generator=spec("CubicGridGenerator", {"numMolecules": str(n)}),
        output_plugins=[spec("CavityWriter", {
            "writefrequency": "2", "outputprefix": f"{d}/cav", "Nx": "4",
            "Ny": "4", "Nz": "4", "radius": "1.2", "maxNeighbours": "1",
            "componentid": ["0", "1"],
            "ControlVolume": {"x0": "1.0", "x1": str(L - 1.0)}})],
        plugins=[spec("WidomInsertion", {
            "cid": "1", "insertions": "64", "samplefrequency": "1",
            "writefrequency": "2", "temperature": "1.5",
            "outputprefix": f"{d}/widom", "cv": {"x0": "1.0", "x1": str(L / 2)}})])


def test_cavity_and_widom_files_match_jax(tmp_path):
    """CavityWriter (control volume, two components) and WidomInsertion
    (restricted volume, blocks) over 8 steps: every file equal to JAX's
    within rtol 1e-9, mu_excess and its error too."""
    dj, dp = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dp.mkdir()
    jsim = JaxMD(sampler_config(JConfig, JSpec, dj), dtype=jnp.float64)
    jsim.run(steps=8, print_every=0)
    psim = MDSimulation(sampler_config(XMLConfig, PluginSpec, dp), dtype=torch.float64,
                        device="cpu")
    widom = [p for p in psim._plugins if p.name == "WidomInsertion"][0]
    widom.draws = widom_draws_of_jax(4711, 64)
    psim.run(steps=8, print_every=0)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dp))
    assert "cav-c1-0004.cav.xyz" in names and "widom.widom" in names
    for name in names:
        same_text(dj / name, dp / name)
    jw = [p for p in jsim._plugins if p.name == "WidomInsertion"][0]
    np.testing.assert_allclose(widom.mu_excess, jw.mu_excess, rtol=1e-9)
    np.testing.assert_allclose(widom.stderr_mu, jw.stderr_mu, rtol=1e-9)
    assert len(widom._block_means) == 4


def test_widom_cell_probe_matches_rows(monkeypatch):
    """The full-width Widom probe (a cell table's 27 cells) against the
    O(N) rows on the same draws, f64 1e-12; the rows in passes of a few
    probes (a small PASS_BYTES)."""
    from ls1_mardyn_tpu_torch.ensemble import grand_canonical
    from ls1_mardyn_tpu_torch.ensemble.grand_canonical import (
        cell_probe_geometry, probe_energies, probe_reach, probe_table)
    from ls1_mardyn_tpu_torch.scene import build_scene

    n = 1500
    L = (n / 0.6) ** (1 / 3)
    mol, pp, _t, box = build_scene(pgrid(n, [L, L, L], 1.2, seed=4), cutoff=2.5,
                                   device="cpu")
    g = torch.Generator().manual_seed(0)
    r = torch.rand((40, 3), generator=g, dtype=torch.float64) * L
    q = torch.randn((40, 4), generator=g, dtype=torch.float64)
    q = q / q.norm(dim=1, keepdim=True)
    cid = torch.tensor(0, dtype=torch.int32)
    geom = cell_probe_geometry(n, L ** 3, [L] * 3, probe_reach(pp), 1)
    slots, (dims, cap), ovf = probe_table(mol, [L] * 3, geom)
    assert not bool(ovf) and cap == geom[1]
    cells = probe_energies(mol, pp, box, r, q, cid, table=slots, dims=dims)
    monkeypatch.setattr(grand_canonical, "PASS_BYTES", 1 << 16)
    rows = probe_energies(mol, pp, box, r, q, cid)
    np.testing.assert_allclose(cells.numpy(), rows.numpy(), rtol=1e-12, atol=1e-12)


WALL = {"potential": "93", "density": "0.9", "sigma": "1.0",
        "epsilon": "1.0", "yoff": "0.0", "ycut": "2.0", "width": "0.0"}
MIRROR2 = {"type": "2", "position": "3.0", "axis": "1", "direction": "1",
           "forceConstant": "50.0"}


@pytest.mark.parametrize("plugins", [
    [("WallPotential", WALL)],
    [("WallPotential", dict(WALL, potential="104", delta="0.7")),
     ("Mirror", MIRROR2)],
], ids=["wall93", "wall104_mirror2"])
def test_site_wise_forces_summed_into_upot(plugins):
    """tests/test_wallpotential.py's scene: the plugins' contributions
    enter the port's Upot and forces as the JAX driver's (f64 1e-10),
    and change Upot."""
    def build(cls, spec, grid, md, plugins, **kw):
        data = grid(125, [8.0, 3.0, 8.0], 0.8, seed=5)
        data.r[:, 1] += 1.0
        data.box = np.array([8.0, 8.0, 8.0])
        cfg = cls(timestep=0.001, temperature=0.8, box=data.box, cutoff=2.2,
                  lj_cutoff=2.2, plugins=[spec(nm, pr) for nm, pr in plugins])
        sim = md(cfg, phase_space_data=data, **kw)
        sim.engine.prepare_start()
        return sim

    jsim = build(JConfig, JSpec, jgrid, JaxMD, plugins, dtype=jnp.float64)
    psim = build(XMLConfig, PluginSpec, pgrid, MDSimulation, plugins,
                 dtype=torch.float64, device="cpu")
    bare = build(XMLConfig, PluginSpec, pgrid, MDSimulation, [],
                 dtype=torch.float64, device="cpu")
    u_j, u_p = float(jsim.engine.macro.upot), float(psim.engine.macro.upot)
    np.testing.assert_allclose(u_p, u_j, rtol=1e-10)
    assert abs(u_p - float(bare.engine.macro.upot)) > 1e-3
    for k in ("F", "M"):
        np.testing.assert_allclose(getattr(psim.engine.forces, k).numpy(),
                                   np.asarray(getattr(jsim.engine.forces, k)),
                                   rtol=0, atol=1e-10)
    gj, gp = jsim.run(steps=5, print_every=0), psim.run(steps=5, print_every=0)
    np.testing.assert_allclose(float(gp.upot), float(gj.upot), rtol=1e-10)


@pytest.mark.parametrize("radius", [1.5, 4.0], ids=["cells", "rows"])
def test_cavity_counts_match_jax(monkeypatch, radius):
    """tests/test_cavity_diagnostics.py's slab (400 molecules in z < 4 of
    a 10^3 box): the neighbour counts of the port, through the cell table
    (radius 1.5: 6 cells an axis) and through the chunked rows (radius
    4.0: 2 cells an axis), equal JAX's _count_neighbours exactly."""
    from ls1_mardyn_tpu.ensemble.cavity import CavityEnsemble as JCav
    from ls1_mardyn_tpu.state import MoleculeState as JState
    from ls1_mardyn_tpu_torch.ensemble import grand_canonical
    from ls1_mardyn_tpu_torch.ensemble.cavity import CavityEnsemble, count_neighbours
    from ls1_mardyn_tpu_torch.state import MoleculeState

    rng = np.random.default_rng(0)
    box = np.array([10.0, 10.0, 10.0])
    r = rng.uniform(0, 1, (400, 3)) * box
    r[:, 2] *= 0.4
    jmol = JState.from_numpy(r=r, v=np.zeros_like(r), capacity=420, dtype=jnp.float64)
    pmol = MoleculeState.from_numpy(r=r, v=np.zeros_like(r), capacity=420,
                                    dtype=torch.float64, device="cpu")
    maxn = 2 if radius < 2 else 60
    jce = JCav(box, grid=(5, 5, 5), radius=radius, max_neighbours=maxn)
    pce = CavityEnsemble(box, grid=(5, 5, 5), radius=radius, max_neighbours=maxn)
    (ja, jc), (pa, pc) = jce.cavity_step(jmol), pce.cavity_step(pmol)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pa, ja)
    assert 0 < pa.sum() < len(pa)
    # a pass budget of a few probes gives the same counts
    monkeypatch.setattr(grand_canonical, "PASS_BYTES", 1 << 16)
    small = count_neighbours(torch.as_tensor(pce.probe_r), pmol, box, radius)
    np.testing.assert_array_equal(small.numpy(), jc)
