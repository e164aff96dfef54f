"""The NEMD control plugins and the reservoir feed against the JAX
package's (CPU, f64), on the scenes of tests/test_nemd2.py:

- DistControl, DriftCtrl, PosNegComp and ExtractPhase through the
  drivers (state and globals after a run, the interfaces and file);
- MettDeamon hook by hook (the JAX driver cannot step after a
  MettDeamon change: it sets the engine's forces to None and its next
  step fails, ROADMAP Queue 3), then the port's driver feeding a film
  through Mirror type 5's deletions;
- MettDeamonFeedrateDirector: the port's sets a MettDeamon's feed from
  the outflow; the JAX package's raises ImportError.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nemd import (
    JAX, PORT, assert_same_globals, assert_same_state, plugin, run_pair)

torch.set_num_threads(1)


def slab_data(s, n_extra=True, two=False, Ly=30.0, T=0.8, rho=0.7):
    """tests/test_nemd2.py's liquid film in y [10, 20), vapour elsewhere,
    on a lattice (the JAX test's uniform draws overlap, and their forces
    amplify rounding within a few steps); two: a second component for
    PosNegComp; n_extra: two vapour molecules outside the film for
    ExtractPhase."""
    Lx = Lz = 8.0
    comps = []
    for k in range(2 if two else 1):
        c = s["comp"](cid=k)
        c.add_ljcenter(0, 0, 0, 1.0, 1.0, 1.0)
        comps.append(c)
    n = int(rho * Lx * Lz * 10.0)
    base = s["grid"](n, [Lx, 10.0, Lz], T, seed=12)
    r, v = base.r.copy(), base.v.copy()
    r[:, 1] += 10.0
    if n_extra:
        r = np.vstack([r, [[1.0, 2.0, 1.0], [1.0, 25.0, 1.0]]])
        v = np.vstack([v, np.zeros((2, 3))])
    m = len(r)
    K = len(comps)
    return s["data"](
        components=comps, mixing_xi=np.ones((K, K)), mixing_eta=np.ones((K, K)),
        eps_rf=1.0, box=np.array([Lx, Ly, Lz]), temperature=T, current_time=0.0,
        mid=np.arange(1, m + 1, dtype=np.int64), cid=np.zeros(m, np.int32),
        r=r, v=v, q=np.tile([1.0, 0, 0, 0], (m, 1)), L=np.zeros_like(r))


def test_nemd2_plugins_match_jax(tmp_path):
    """DistControl (update every 2 steps, 60 bins), DriftCtrl (4 bins of
    the film, every 3 steps), PosNegComp and ExtractPhase (at step 4) on
    the two-component film, 8 steps; DistControl's interfaces and file
    as JAX's."""
    os.chdir(tmp_path)
    plugins = [
        ("DistControl", {"control": {"update": "2"}, "subdivision": {"number": "60"},
                         "method": {"type": "density"}, "outputprefix": "dc"}),
        ("DriftCtrl", {"control": {"freq": {"control": "3"}},
                       "target": {"cid": "1", "drift": {"vx": "0.5", "vy": "0",
                                                        "vz": "0"}},
                       "range": {"yl": "10", "yr": "20",
                                 "subdivision": {"binwidth": "2.5"}}}),
        ("PosNegComp", {"cid_ub_pos": "1", "cid_ub_neg": "2"}),
        ("ExtractPhase", {"step": "4", "left": "10", "right": "20"}),
    ]
    jsim, jgv, psim, pgv = run_pair(lambda s: slab_data(s, two=True), plugins, 8,
                                    T=0.8)
    assert_same_globals(pgv, jgv)
    assert_same_state(psim, jsim)
    jd, pd = plugin(jsim, "DistControl"), plugin(psim, "DistControl")
    assert pd._log == jd._log and len(pd._log) == 5
    assert 9.0 < pd.left < 11.5 and 18.5 < pd.right < 21.0
    n = int(float(pgv.n))
    assert n == int(float(jgv.n)) < len(slab_data(PORT, two=True).mid)
    for sim in (jsim, psim):
        sim._plugins[0].finish(sim)
    assert open(tmp_path / "dc.dat").read().count("\n") == 6


def test_distcontrol_denderiv_histogram_matches_numpy(tmp_path):
    """The device histogram has numpy.histogram's bins (values on the
    edges included), and the 'denderiv' method finds JAX's interfaces."""
    from ls1_mardyn_tpu_torch.plugins.nemd2 import histogram

    edges = np.histogram_bin_edges([], bins=7, range=(0.0, 3.5))
    y = np.concatenate([edges, np.random.default_rng(1).uniform(-1, 4.5, 300)])
    keep = np.ones(len(y), bool)
    keep[::5] = False
    got = histogram(torch.as_tensor(y), torch.as_tensor(keep),
                    torch.as_tensor(edges)).numpy()
    np.testing.assert_array_equal(got, np.histogram(y[keep], bins=7, range=(0, 3.5))[0])
    os.chdir(tmp_path)
    dc = ("DistControl", {"control": {"update": "1"}, "subdivision": {"number": "60"},
                          "method": {"type": "denderiv"}})
    jsim, _jgv, psim, _pgv = run_pair(lambda s: slab_data(s), [dc], 1, T=0.8)
    jd, pd = plugin(jsim, "DistControl"), plugin(psim, "DistControl")
    assert (pd.left, pd.right) == (jd.left, jd.right)


def mett_data(s, n=400):
    """tests/test_nemd2.py's _mett_config: component 2 is the frozen
    variant of 1; a liquid slab at the bottom is the reservoir."""
    Lx = Lz = 8.0
    T = 0.8
    comps = []
    for k in range(2):
        c = s["comp"](cid=k)
        c.add_ljcenter(0, 0, 0, 1.0, 1.0, 1.0)
        comps.append(c)
    rng = np.random.default_rng(12)
    r = rng.uniform(0, 1, (n, 3)) * np.array([Lx, 8.0, Lz])
    v = rng.normal(0, np.sqrt(T), (n, 3))
    return s["data"](
        components=comps, mixing_xi=np.ones((2, 2)), mixing_eta=np.ones((2, 2)),
        eps_rf=1.0, box=np.array([Lx, 30.0, Lz]), temperature=T, current_time=0.0,
        mid=np.arange(1, n + 1, dtype=np.int64), cid=np.zeros(n, np.int32),
        r=r, v=v, q=np.tile([1.0, 0, 0, 0], (n, 1)), L=np.zeros_like(r))


METT = {
    "control": {"updatefreq": "10",
                "feed": {"init": "1.1", "direction": "1", "method": "4",
                         "release_velo": {"method": "3", "fix_value": "0.2"}}},
    "reservoir": {"width": "4.0", "binwidth": "2.0", "ins_percent": "0.7"},
    "changes": {"change": {"from": "1", "to": "2"}},
    "writefrequency": "1",
}


def _mett_sim(s, plugins):
    d = mett_data(s)
    cfg = s["cls"](timestep=0.002, temperature=0.8, box=d.box, cutoff=2.5,
                   lj_cutoff=2.5, plugins=[s["spec"](nm, dict(pr)) for nm, pr in plugins])
    return s["md"](cfg, phase_space_data=d, **s["kw"])


def test_mettdeamon_hooks_match_jax(tmp_path):
    """tests/test_nemd2.py's reservoir feed and release, hook by hook on
    both: 120 molecules deleted at step 2, bins inserted as frozen molecules at the feed
    boundary (70% of each, numpy draws from the same seed), the ride,
    a release across the transition plane (velocity + 0.2), the
    deletion window and the feed log."""
    plugins = [("MettDeamon", METT)]
    sims = {}
    for name, s in (("jax", JAX), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        os.chdir(d)
        sim = _mett_sim(s, plugins)
        xp = jnp if s is JAX else torch
        md = sim._plugins[0]
        for step in range(1, 6):
            if step == 2:
                # an evaporation sink deletes 120 molecules
                mol = sim.engine.mol
                valid = np.asarray(mol.valid).copy()
                valid[np.flatnonzero(valid)[:120]] = False
                sim.engine.mol = dataclasses.replace(mol, valid=xp.asarray(valid))
            if step == 4:
                # one frozen molecule past the transition plane
                mol = sim.engine.mol
                fi = np.flatnonzero(np.asarray(mol.valid) & (np.asarray(mol.cid) == 1))[0]
                r = np.array(mol.r)
                r[fi, 1] = md.transition_y + 0.5
                sim.engine.mol = dataclasses.replace(mol, r=xp.asarray(r))
            md.before_event_new_timestep(sim, step)
            md.before_forces(sim, step)
            md.after_forces(sim, step)
        md.finish(sim)
        sims[name] = sim
    jsim, psim = sims["jax"], sims["port"]
    jm, pm = jsim._plugins[0], psim._plugins[0]
    assert (pm.inserted, pm.released, pm.active_bin, pm.deleted_sum) == \
        (jm.inserted, jm.released, jm.active_bin, jm.deleted_sum)
    assert pm.inserted > 0 and pm.released >= 1 and pm.deleted_sum == 120
    assert pm.feed_sum == pytest.approx(jm.feed_sum, abs=1e-12)
    assert_same_state(psim, jsim, tol=1e-12)
    assert open(tmp_path / "port" / "MettDeamon_feed.dat").read() == \
        open(tmp_path / "jax" / "MettDeamon_feed.dat").read()


FEED = {
    "control": {"updatefreq": "5", "numvals": "4",
                "feed": {"init": "0.5", "direction": "1", "method": "1"}},
    "reservoir": {"width": "4.0", "binwidth": "1.0"},
    "changes": {"change": {"from": "1", "to": "2"}},
    "writefrequency": "5",
}
SINK = ("Mirror", {"type": "5", "position": "12.0", "axis": "1", "dir": "o-|",
                   "meland": {"velo_target": "0.5"}})
DIRECTOR = ("MettDeamonFeedrateDirector", {"updatefreq": "4"})


def test_mettdeamon_feeds_a_run_and_jax_stops(tmp_path):
    """The port's driver runs MettDeamon (deleted-molecules feed) with a
    Mirror type 5 sink and the FeedrateDirector for 12 steps: molecules
    are deleted by the sink, bins inserted into the freed slots and
    released, and the director sets the feed from the outflow.  The JAX
    driver stops at the step after MettDeamon's first change (its
    engine's forces are None); its FeedrateDirector raises ImportError."""
    os.chdir(tmp_path)
    plugins = [("MettDeamon", FEED), SINK, DIRECTOR]
    psim = _mett_sim(PORT, plugins)
    md, sink, director = psim._plugins
    feeds = []
    orig = director.end_step

    def spy(sim, step):
        orig(sim, step)
        if step % director.update_freq == 0:
            feeds.append(md.feed_actual)

    director.end_step = spy
    gv = psim.run(steps=12, print_every=0)
    assert sink.deleted > 0 and md.inserted > 0
    # MettDeamon counts the net falls of N between steps (the JAX
    # package's bookkeeping): the sink's deletions less same-step feeds
    assert 0 < md.deleted_sum <= sink.deleted
    assert int(float(gv.n)) == 400 - sink.deleted + md.inserted
    assert len(feeds) == 3 and feeds[0] != 0.5 and min(feeds) >= 0
    assert np.isfinite(float(gv.upot))

    jsim = _mett_sim(JAX, [("MettDeamon", FEED)])
    with pytest.raises(AttributeError):
        jsim.run(steps=4, print_every=0)
    jsim2 = _mett_sim(JAX, [DIRECTOR])
    with pytest.raises(ImportError):
        jsim2._plugins[0].end_step(jsim2, 4)


def test_feedrate_director_sets_the_feed(tmp_path):
    """MettDeamonFeedrateDirector's own arithmetic: outflow since its
    last update, per step, over (reservoir density * area_xz), for each
    MettDeamon of the run."""
    os.chdir(tmp_path)
    psim = _mett_sim(PORT, [("MettDeamon", FEED), DIRECTOR])
    md, director = psim._plugins
    md._deleted.add(torch.tensor(24))
    director.end_step(psim, 4)
    assert md.feed_actual == pytest.approx(24 / 4 / (md.res_density * md.area_xz))
    md._deleted.add(torch.tensor(8))
    director.end_step(psim, 7)  # not an update step
    director.end_step(psim, 8)
    assert md.feed_actual == pytest.approx(8 / 4 / (md.res_density * md.area_xz))
    assert director.reads == 2
