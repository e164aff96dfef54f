"""The grand-canonical ensemble against the JAX package's (CPU, f64):
the two probe energies, the cycle in both probe modes with the same
draws on both sides (the freed-slot and delta-list cases and the probe
table's overflow retry), and the chemical potentials read from XML.

Both cycles read explicit draws: the port's through
GrandCanonicalEnsemble.draws, the JAX cycle through a stand-in for
jax.random that the test puts in the JAX module's namespace for the
cycle's trace only (`jax_draws`).  Its keys are [cycle, trial, sub]
triples, and its uniforms and normals are read from the same tables
(`Draws`) that the port's draws() returns, so every decision agrees.
JAX's deletion pick, randint(1, total + 1), becomes the port's
1 + floor(u * total).
"""

import dataclasses
import itertools
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ls1_mardyn_tpu.ensemble.grand_canonical as jgc
from ls1_mardyn_tpu.io.generators import cubic_grid
from ls1_mardyn_tpu.io.xml_config import PluginSpec, _params_dict
from ls1_mardyn_tpu.ops.cells import CellGridSpec as JSpec
from ls1_mardyn_tpu.ops.cells import bin_particles as jbin
from ls1_mardyn_tpu.scene import build_scene as jax_build_scene
from ls1_mardyn_tpu_torch.ensemble import grand_canonical as pgc
from ls1_mardyn_tpu_torch.interop import molecule_state_from_numpy, pair_params_from_numpy
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from test_torch_models import _scene as ms_scene

torch.set_num_threads(1)

KEYS = ("r", "v", "q", "L", "cid", "mid", "valid")


class Draws:
    """Uniforms U and normals Z [cycles, trials, 5, 4] from a seed: the
    draws of cycle c, trial t, sub-key s (1..4 as JAX splits a trial's
    key)."""

    def __init__(self, cycles, trials, seed=0):
        rng = np.random.default_rng(seed)
        self.U = rng.uniform(size=(cycles, trials, 5, 4))
        self.Z = rng.normal(size=(cycles, trials, 5, 4))

    def port(self, c, nd, ni):
        """Cycle c in the layout of GrandCanonicalEnsemble.draws."""
        U, Z = self.U[c], self.Z[c]
        u = np.zeros((nd + ni, 4))
        z = np.zeros((ni, 7))
        u[:nd, 0], u[:nd, 1] = U[:nd, 1, 0], U[:nd, 2, 0]
        u[nd:, :3], u[nd:, 3] = U[nd:nd + ni, 1, :3], U[nd:nd + ni, 3, 0]
        z[:, :4], z[:, 4:] = Z[nd:nd + ni, 2, :4], Z[nd:nd + ni, 4, :3]
        return u, z


class _FakeRandom:
    """jax.random's split/randint/uniform/normal over Draws' tables;
    keys are int32 [cycle, trial, sub] (a cycle key has trial -1)."""

    def __init__(self, d: Draws):
        self.U, self.Z = jnp.asarray(d.U), jnp.asarray(d.Z)

    @staticmethod
    def split(key, num=2):
        i = jnp.int32
        return jnp.stack([
            jnp.where(key[1] < 0, jnp.stack([key[0], i(t), i(0)]),
                      jnp.stack([key[0], key[1], i(t + 1)]))
            for t in range(num)])

    def _u(self, tab, key, shape):
        size = int(np.prod(shape)) if shape else 1
        return tab[key[0], key[1], key[2], :size].reshape(shape)

    def uniform(self, key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        u = self._u(self.U, key, shape).astype(dtype)
        return jax.lax.max(jnp.asarray(minval, dtype),
                           u * (maxval - minval) + minval)

    def normal(self, key, shape=(), dtype=float):
        return self._u(self.Z, key, shape).astype(dtype)

    def randint(self, key, shape, minval, maxval):
        span = maxval - minval
        u = self._u(self.U, key, ())
        return minval + jnp.minimum(
            jnp.floor(u * span.astype(u.dtype)).astype(jnp.int32), span - 1)


class _JaxProxy:
    def __init__(self, fake):
        self.random = fake

    def __getattr__(self, name):
        return getattr(jax, name)


def jax_draws(monkeypatch, jens, d: Draws):
    """Feed the JAX ensemble Draws' tables: its module sees the stand-in
    jax.random, and each cycle's key names the cycle."""
    monkeypatch.setattr(jgc, "jax", _JaxProxy(_FakeRandom(d)))
    counter = itertools.count()
    jens._next = lambda: jnp.asarray([next(counter), -1, -1], jnp.int32)


def port_draws(pens, d: Draws):
    counter = itertools.count()

    def draws(icp, dtype):
        cp = pens.chem_pots[icp]
        u, z = d.port(next(counter), cp.deletions_per_interval,
                      cp.insertions_per_interval)
        dev = pens.device
        return (torch.as_tensor(u, dtype=dtype, device=dev),
                torch.as_tensor(z, dtype=dtype, device=dev))

    pens.draws = draws


def to_port(jmol, jpp=None):
    pmol = molecule_state_from_numpy({k: np.asarray(getattr(jmol, k)) for k in KEYS})
    if jpp is None:
        return pmol
    return pmol, pair_params_from_numpy({k: np.asarray(v) for k, v in vars(jpp).items()})


def assert_states_equal(pmol, jmol, atol=1e-12):
    for k in KEYS:
        a, b = getattr(pmol, k).numpy(), np.asarray(getattr(jmol, k))
        if k in ("cid", "mid", "valid"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def lj_scene(n=600, rho=0.35, T=1.2, seed=5, reserve=128):
    """tests/test_gcmc_cell_probe.py's scene (>= 3 cells an axis)."""
    L = (n / rho) ** (1 / 3)
    data = cubic_grid(n, [L, L, L], T, seed=seed)
    jmol, jpp, _t, _b = jax_build_scene(data, cutoff=2.5, dtype=jnp.float64,
                                         capacity=n + reserve)
    return jmol, jpp, L


def _energies(jmol, jpp, box, table, dims, r, q, cid, excl, freed=None):
    pmol, ppp = to_port(jmol, jpp)
    pbox = torch.as_tensor(box)
    pr, pq = torch.tensor(np.asarray(r)), torch.tensor(np.asarray(q))
    pcid = torch.tensor(int(cid), dtype=torch.int32)
    pex = torch.tensor([int(excl)])
    e_row = (float(jgc.single_molecule_energy(
        jmol, jpp, jnp.asarray(box), r, q, jnp.int32(cid), jnp.int32(excl))),
        float(pgc.single_molecule_energy(pmol, ppp, pbox, pr, pq, pcid, pex)))
    pfreed = None if freed is None else torch.tensor(np.asarray(freed))
    e_cell = (float(jgc.cell_probe_energy(
        jmol, jpp, jnp.asarray(box), table, dims, r, q, jnp.int32(cid),
        jnp.int32(excl), freed=freed)),
        float(pgc.cell_probe_energy(
            pmol, ppp, pbox, torch.tensor(np.asarray(table)), dims, pr, pq,
            pcid, pex, freed=pfreed)))
    return e_row, e_cell


@pytest.mark.parametrize("kind", ["1clj", "2cljq"])
def test_probe_energies_match_jax(kind):
    """single_molecule_energy and cell_probe_energy against JAX's, f64
    1e-12: random probes, a real molecule with itself excluded, and a
    freed slot moved one cell (the stale-row case)."""
    if kind == "1clj":
        jmol, jpp, L = lj_scene()
    else:
        jmol, jpp, _pm, _pp, box, _d = ms_scene("2cljq", n=150, rho=0.35)
        L = float(box[0])
    box = np.array([L, L, L])
    dims = tuple(int(np.floor(L / 2.5)) for _ in range(3))
    assert min(dims) >= 3
    bins = jbin(jmol.r, jmol.valid, JSpec(dims=dims, box=(L, L, L), cap=64))
    assert not bool(bins.overflow)
    # the port's table is the JAX table
    pb = bin_particles(to_port(jmol).r, to_port(jmol).valid,
                       CellGridSpec(dims=dims, box=(L, L, L), cap=64))
    np.testing.assert_array_equal(pb.slots.numpy(), np.asarray(bins.slots))
    rng = np.random.default_rng(2)
    cases = []
    for _ in range(3):
        qv = rng.normal(size=4)
        cases.append((rng.uniform(0, L, 3), qv / np.linalg.norm(qv), 0, -1, None))
    cases.append((np.asarray(jmol.r[7]), np.asarray(jmol.q[7]), 0, 7, None))
    s = 7
    r_new = (np.asarray(jmol.r)[s] + np.array([2.6, 0.0, 0.0])) % L
    jmol2 = dataclasses.replace(jmol, r=jmol.r.at[s].set(jnp.asarray(r_new)))
    freed = jnp.zeros((jmol.capacity,), bool).at[s].set(True)
    for r, q, cid, excl, fr in cases:
        (jr, pr), (jc, pc) = _energies(jmol, jpp, box, bins.slots, dims,
                                       jnp.asarray(r), jnp.asarray(q), cid, excl)
        np.testing.assert_allclose(pr, jr, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pc, jc, rtol=1e-12, atol=1e-12)
    r_p = jnp.asarray(np.asarray(jmol.r)[s] + 0.3)
    (jr, pr), (jc, pc) = _energies(jmol2, jpp, box, bins.slots, dims, r_p,
                                   jnp.asarray([1.0, 0, 0, 0]), 0, -1,
                                   freed=freed)
    np.testing.assert_allclose(pc, jc, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pr, jr, rtol=1e-12, atol=1e-12)


def _run_both(monkeypatch, jmol, jpp, L, cps, T, steps, cell, draws, cap=None,
              seed=42):
    """The JAX and the port ensembles over `steps` steps with the same
    draws; cell picks the probe (CELL_PROBE_MIN_N), cap forces the probe
    table's capacity."""
    monkeypatch.setattr(jgc.GrandCanonicalEnsemble, "CELL_PROBE_MIN_N",
                        1 if cell else 10 ** 12)
    monkeypatch.setattr(pgc.GrandCanonicalEnsemble, "CELL_PROBE_MIN_N",
                        1 if cell else 10 ** 12)
    jens = jgc.GrandCanonicalEnsemble(cps, T, [L, L, L], seed=seed)
    pcps = [pgc.ChemicalPotential(**dataclasses.asdict(c)) for c in cps]
    pens = pgc.GrandCanonicalEnsemble(pcps, T, [L, L, L], seed=seed, device="cpu")
    jax_draws(monkeypatch, jens, draws)
    port_draws(pens, draws)
    pmol, ppp = to_port(jmol, jpp)
    if cap is not None:
        for ens, m in ((jens, jmol), (pens, pmol)):
            geom = ens._probe_geometry(m, jpp if ens is jens else ppp)
            ens._probe_caps[0] = (geom[0], cap)
    for s in range(1, steps + 1):
        jmol = jens.step(jmol, jpp, s)
        pmol = pens.step(pmol, ppp, s)
    return jmol, jens, pmol, pens


def _counters(ens):
    return ens.attempted, ens.accepted_del, ens.accepted_ins


@pytest.mark.parametrize("cell", [False, True], ids=["row", "cell"])
def test_cycle_matches_jax(monkeypatch, cell):
    """Three cycles of 4 deletions and 6 insertions: every decision, the
    counters and the state slot by slot as JAX's, in the O(N) row mode
    and in the cell-probe mode (same-cycle insertions on the delta list,
    deletions of just-inserted molecules)."""
    jmol, jpp, L = lj_scene()
    cps = [jgc.ChemicalPotential(mu=-4.0, interval=1, insertions_per_interval=6,
                                 deletions_per_interval=4)]
    jm, jens, pm, pens = _run_both(monkeypatch, jmol, jpp, L, cps, 1.2, 3, cell,
                                   Draws(3, 10, seed=1))
    assert (jens._probe_caps[0] is not None) == cell
    assert (pens._probe_caps[0] is not None) == cell
    assert _counters(pens) == _counters(jens) == (30, *_counters(jens)[1:])
    assert jens.accepted_ins > 0 and jens.accepted_del > 0
    assert pens.cycles == 3
    assert_states_equal(pm, jm)


def test_cycle_slot_reuse_matches_jax(monkeypatch):
    """No reserve slots: every insertion reuses a slot a deletion of the
    same cycle freed (tests/test_gcmc_cell_probe.py's slot-reuse scene),
    cell probe with the freed mask, against JAX."""
    jmol, jpp, L = lj_scene(n=320, rho=0.45, seed=8, reserve=0)
    cps = [jgc.ChemicalPotential(mu=-4.0, interval=1, insertions_per_interval=8,
                                 deletions_per_interval=8)]
    jm, jens, pm, pens = _run_both(monkeypatch, jmol, jpp, L, cps, 1.2, 4, True,
                                   Draws(4, 16, seed=2), seed=7)
    assert jens.accepted_del > 0 and jens.accepted_ins > 0
    assert _counters(pens) == _counters(jens)
    assert_states_equal(pm, jm)


def test_cycle_overflow_retry_matches_jax(monkeypatch):
    """A probe table one doubling too small overflows: both ensembles
    double it and run the cycle again on the untouched state with the
    same draws; the results agree."""
    jmol, jpp, L = lj_scene()
    dims = tuple(int(np.floor(L / 2.5)) for _ in range(3))
    occ = int(np.asarray(jbin(jmol.r, jmol.valid,
                              JSpec(dims=dims, box=(L, L, L), cap=64)).counts).max())
    cap = 2 ** int(np.floor(np.log2(occ - 1)))  # cap < occ <= 2 cap
    cps = [jgc.ChemicalPotential(mu=-4.0, interval=1, insertions_per_interval=3,
                                 deletions_per_interval=1)]
    jm, jens, pm, pens = _run_both(monkeypatch, jmol, jpp, L, cps, 1.2, 1, True,
                                   Draws(1, 4, seed=3), cap=cap, seed=11)
    assert pens._probe_caps[0][1] == jens._probe_caps[0][1] == 2 * cap
    assert _counters(pens) == _counters(jens) == (4, *_counters(jens)[1:])
    assert_states_equal(pm, jm)


def test_build_chemical_potentials_matches_jax():
    """The XML of tests/test_ensembles_observables.py::
    test_chemical_potential_xml_full_semantics, read by both."""
    el = ET.fromstring(
        """<chemicalpotential><mu>1.0</mu><cid>1</cid>
        <interval>2</interval><instances>3</instances>
        <control><lower><x>0</x><y>0</y><z>0</z></lower>
        <upper><x>4</x><y>8</y><z>8</z></upper></control>
        </chemicalpotential>"""
    )
    spec = PluginSpec("ChemicalPotential", _params_dict(el))
    box = np.array([8.0, 8.0, 8.0])
    (jc,) = jgc._build_chemical_potentials([spec], box)
    (pc,) = pgc._build_chemical_potentials([spec], box)
    for f in dataclasses.fields(pc):
        np.testing.assert_array_equal(getattr(pc, f.name), getattr(jc, f.name))
    assert pc.insertions_per_interval == pc.deletions_per_interval == 3
    # a legacy spelling and a partial control volume
    spec2 = PluginSpec("ChemicalPotential", {
        "mu": "-1", "componentid": "2", "everyNTimesteps": "5",
        "control": {"lower": {"y": "3"}}})
    (jc2,), (pc2,) = (jgc._build_chemical_potentials([spec2], box),
                      pgc._build_chemical_potentials([spec2], box))
    assert (pc2.component, pc2.interval) == (jc2.component, jc2.interval) == (1, 5)
    np.testing.assert_array_equal(pc2.control_lower, jc2.control_lower)
    assert pc2.control_upper is None and jc2.control_upper is None


def test_gcmc_equilibrates_density_direction():
    """The port's own draws (its torch.Generator): attractive mu gains
    molecules, repulsive mu loses them; the input state is not written
    (tests/test_ensembles_observables.py's direction check)."""
    n, rho, T = 100, 0.2, 1.2
    L = (n / rho) ** (1 / 3)
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid as pgrid
    from ls1_mardyn_tpu_torch.scene import build_scene

    data = pgrid(n, [L, L, L], T, seed=5)
    mol, pp, _t, box = build_scene(data, cutoff=2.5, capacity=n + 64,
                                   device="cpu")
    valid0 = mol.valid.clone()
    out = {}
    for mu in (5.0, -20.0):
        ens = pgc.GrandCanonicalEnsemble(
            [pgc.ChemicalPotential(mu=mu, interval=1, insertions_per_interval=4,
                                   deletions_per_interval=4)],
            T, box.numpy(), seed=3, device="cpu")
        m = mol
        for s in range(1, 10):
            m = ens.step(m, pp, s)
        out[mu] = int(m.valid.sum())
        assert ens.attempted == 9 * 8
    assert out[5.0] > n > out[-20.0]
    assert torch.equal(mol.valid, valid0)
