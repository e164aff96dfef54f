"""The port's molecular models (ls1_mardyn_tpu_torch/models) against the
JAX package's, f64 on the CPU, on inputs made with numpy from a seed:
the quaternion functions, each of the seven site-site potentials,
molecule_pair, the PairParams tables through interop, and the N^2
oracle on a 1CLJ, a 2CLJ+quadrupole and a charged three-site scene.

Tolerances: the elementwise functions repeat the JAX arithmetic term
for term (rtol 1e-12, atol 1e-13 for results that cancel to ~0); the
oracle sums the same pair terms in another order (1e-11 of max|F|,
rtol 1e-11 on the energies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.generators import cubic_grid
from ls1_mardyn_tpu.models import interaction as jinter
from ls1_mardyn_tpu.models import potentials as jpot
from ls1_mardyn_tpu.models import quaternion as jquat
from ls1_mardyn_tpu.models.components import Component as JComponent
from ls1_mardyn_tpu.models.oracle import compute_forces_n2_jit
from ls1_mardyn_tpu.scene import build_scene as jax_build_scene
from ls1_mardyn_tpu_torch.interop import (
    molecule_state_from_numpy,
    pair_params_from_numpy,
    to_numpy,
)
from ls1_mardyn_tpu_torch.io.generators import cubic_grid as port_cubic_grid
from ls1_mardyn_tpu_torch.models import interaction as pinter
from ls1_mardyn_tpu_torch.models import potentials as ppot
from ls1_mardyn_tpu_torch.models import quaternion as pquat
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.scene import build_scene

torch.set_num_threads(1)

T = torch.as_tensor
RNG = np.random.default_rng(17)


def _close(p, j, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=rtol, atol=atol)


def _unit(shape):
    e = RNG.normal(size=shape + (3,))
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_quaternion_functions_match_jax():
    a = RNG.normal(size=(7, 4))
    b = RNG.normal(size=(7, 4))
    d = RNG.normal(size=(7, 3))
    for name, args in (("qmul", (a, b)), ("qnorm2", (a,)), ("qnormalize", (a,)),
                       ("qconj", (a,)), ("qrotate", (a, d)),
                       ("qrotate_inv", (a, d)), ("qdifferentiate", (a, d))):
        got = getattr(pquat, name)(*(T(x) for x in args))
        want = getattr(jquat, name)(*(jnp.asarray(x) for x in args))
        _close(got, want)
    _close(pquat.from_axis_angle(0.7, [1.0, 2.0, -0.5]),
           jquat.from_axis_angle(0.7, [1.0, 2.0, -0.5]))
    # a unit quaternion's rotation is undone by its inverse rotation
    q = pquat.qnormalize(T(a))
    _close(pquat.qrotate_inv(q, pquat.qrotate(q, T(d))), d, atol=1e-14)


POTENTIALS = {
    "lj": lambda dr, dr2, ei, ej: (dr, dr2, 24.0 * 0.8, 1.1),
    "charge_charge": lambda dr, dr2, ei, ej: (dr, dr2, -0.7),
    "charge_charge_screened": lambda dr, dr2, ei, ej: (dr, dr2, -0.7, 0.35),
    "charge_dipole": lambda dr, dr2, ei, ej: (dr, dr2, ej, 0.4),
    "charge_quadrupole": lambda dr, dr2, ei, ej: (dr, dr2, ej, 0.6),
    "dipole_dipole": lambda dr, dr2, ei, ej: (dr, dr2, ei, ej, 1.3, 0.02),
    "dipole_quadrupole": lambda dr, dr2, ei, ej: (dr, dr2, ei, ej, 0.9),
    "quadrupole_quadrupole": lambda dr, dr2, ei, ej: (dr, dr2, ei, ej, 2.1),
}


@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_potential_matches_jax(name):
    dr = RNG.normal(size=(5, 6, 3)) * 1.5
    dr2 = (dr * dr).sum(-1)
    ei, ej = _unit((5, 6)), _unit((5, 6))
    args = POTENTIALS[name](dr, dr2, ei, ej)
    got = getattr(ppot, name)(*(T(x) if isinstance(x, np.ndarray) else x
                                for x in args))
    want = getattr(jpot, name)(*(jnp.asarray(x) if isinstance(x, np.ndarray)
                                 else x for x in args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def _components(kind, mod):
    """Hand-built components, the same for both packages."""
    C = mod
    if kind == "1clj":
        c = C(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 2.5, False)
        return [c]
    if kind == "2cljq":
        c = C(cid=0)
        c.add_ljcenter(0.0, 0.0, -0.3, 0.5, 1.1, 0.9, 2.5, True)
        c.add_ljcenter(0.0, 0.0, 0.3, 0.5, 1.1, 0.9, 2.5, True)
        c.add_quadrupole(0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.4)
        return [c]
    # two components: a charged three-site molecule with a dipole, and a
    # 1CLJ + quadrupole solvent
    a = C(cid=0)
    a.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 2.5, False)
    a.add_charge(0.25, 0.0, 0.0, 0.1, 0.6)
    a.add_charge(-0.25, 0.0, 0.1, 0.1, -0.6)
    a.add_dipole(0.0, 0.1, 0.0, 0.0, 1.0, 0.0, 0.8)
    b = C(cid=1)
    b.add_ljcenter(0.0, 0.0, 0.0, 1.2, 0.8, 1.1, 2.5, False)
    b.add_quadrupole(0.05, 0.0, 0.0, 1.0, 0.0, 0.0, 0.9)
    return [a, b]


def _scene(kind, n=150, rho=0.35, seed=4):
    """(jax mol, jax pp, port mol, port pp, box, data) of a jittered
    lattice with random orientations and angular momenta."""
    L = (n / rho) ** (1.0 / 3.0)
    data = cubic_grid(n, [L, L, L], 1.0, components=_components(kind, JComponent),
                      seed=seed)
    rng = np.random.default_rng(seed)
    data.r = (data.r + rng.normal(0, 0.08, data.r.shape)) % L
    q = rng.normal(size=(n, 4))
    data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    data.L = rng.normal(0, 0.3, (n, 3))
    if kind == "charged":
        data.cid = (np.arange(n) % 2).astype(data.cid.dtype)
    jmol, jpp, jtable, box = jax_build_scene(data, cutoff=2.5, dtype=jnp.float64)
    pmol = molecule_state_from_numpy(
        {k: np.asarray(getattr(jmol, k)) for k in
         ("r", "v", "q", "L", "cid", "mid", "valid")})
    ppp = pair_params_from_numpy({k: np.asarray(v) for k, v in vars(jpp).items()})
    return jmol, jpp, pmol, ppp, np.asarray(box), data


@pytest.mark.parametrize("kind", ["1clj", "2cljq", "charged"])
def test_pair_params_tables_equal_through_interop(kind):
    jmol, jpp, pmol, ppp, _, data = _scene(kind)
    table = ComponentTable(_components(kind, Component), eps_rf=data.eps_rf,
                           cutoff=2.5, lj_cutoff=2.5)
    own = pinter.PairParams.from_table(table, dtype=torch.float64, device="cpu")
    for k, v in vars(jpp).items():
        np.testing.assert_array_equal(getattr(ppp, k).numpy(), np.asarray(v), k)
        np.testing.assert_array_equal(getattr(own, k).numpy(), np.asarray(v), k)
    assert ppp.rot_dof.dtype == torch.int32
    back = to_numpy(pmol)
    for k in ("r", "v", "q", "L", "cid", "mid", "valid"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jmol, k)), k)


def test_build_scene_matches_jax_and_defaults_to_the_card(monkeypatch):
    """scene.build_scene gives the JAX package's state, tables and box
    (with reserve slots), and runs on the card unless asked for the CPU:
    without a card the default raises."""
    kw = dict(components=None, seed=3)
    jdata = cubic_grid(64, [6.0, 6.5, 7.0], 0.9, **kw)
    pdata = port_cubic_grid(64, [6.0, 6.5, 7.0], 0.9, **kw)
    jmol, jpp, _, jbox = jax_build_scene(jdata, cutoff=2.5, lj_cutoff=2.0,
                                         capacity=80, dtype=jnp.float64)
    pmol, ppp, table, pbox = build_scene(pdata, cutoff=2.5, lj_cutoff=2.0,
                                         capacity=80, dtype=torch.float64,
                                         device="cpu")
    assert pmol.capacity == 80 and int(pmol.num_valid()) == 64
    assert table.lj_cutoff == 2.0
    for k in ("r", "v", "q", "L", "cid", "mid", "valid"):
        np.testing.assert_array_equal(getattr(pmol, k).numpy(),
                                      np.asarray(getattr(jmol, k)), k)
    for k, v in vars(jpp).items():
        np.testing.assert_array_equal(getattr(ppp, k).numpy(), np.asarray(v), k)
    np.testing.assert_array_equal(pbox.numpy(), np.asarray(jbox))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scene(pdata, cutoff=2.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pinter.PairParams.from_table(table)


def test_molecule_pair_matches_jax():
    jmol, jpp, pmol, ppp, box, _ = _scene("charged", n=40)
    i, j = np.arange(0, 20), np.arange(20, 40)
    drm = np.asarray(jmol.r)[i] - np.asarray(jmol.r)[j]
    drm -= box * np.round(drm / box)
    m = np.ones(20, bool)
    js = jinter.site_offsets(jpp, jmol.q, jmol.cid)
    ps = pinter.site_offsets(ppp, pmol.q, pmol.cid)
    for k in js:
        _close(ps[k], js[k])
    want = jinter.molecule_pair(
        jnp.asarray(drm), {k: a[i] for k, a in js.items()},
        {k: a[j] for k, a in js.items()}, jmol.cid[i], jmol.cid[j], jpp,
        jnp.asarray(m), jnp.asarray(m))
    got = pinter.molecule_pair(
        T(drm), {k: a[i] for k, a in ps.items()},
        {k: a[j] for k, a in ps.items()}, pmol.cid[i], pmol.cid[j], ppp,
        T(m), T(m))
    for k in want:
        _close(got[k], want[k], rtol=1e-11, atol=1e-12)
    # screened Coulomb
    want = jinter.molecule_pair(
        jnp.asarray(drm), {k: a[i] for k, a in js.items()},
        {k: a[j] for k, a in js.items()}, jmol.cid[i], jmol.cid[j], jpp,
        jnp.asarray(m), jnp.asarray(m), screen_alpha=0.3)
    got = pinter.molecule_pair(
        T(drm), {k: a[i] for k, a in ps.items()},
        {k: a[j] for k, a in ps.items()}, pmol.cid[i], pmol.cid[j], ppp,
        T(m), T(m), screen_alpha=0.3)
    _close(got["F"], want["F"], rtol=1e-11, atol=1e-12)
    _close(got["uX"], want["uX"], rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("kind", ["1clj", "2cljq", "charged"])
def test_oracle_matches_jax_oracle(kind):
    jmol, jpp, pmol, ppp, box, _ = _scene(kind)
    jf, jm = compute_forces_n2_jit(jmol, jpp, jnp.asarray(box))
    pf, pm = compute_forces_n2(pmol, ppp, box, chunk=64, images=0)
    for name in ("F", "M", "Vi"):
        want = np.asarray(getattr(jf, name))
        scale = max(np.abs(want).max(), 1e-300)
        np.testing.assert_allclose(getattr(pf, name).numpy() / scale,
                                   want / scale, atol=1e-11, err_msg=name)
    for name in ("upot6lj", "upot_xpoles", "virial", "my_rf"):
        np.testing.assert_allclose(float(getattr(pm, name)),
                                   float(getattr(jm, name)), rtol=1e-11,
                                   atol=1e-12, err_msg=name)
    # Newton's third law in the port alone
    assert float(pf.F.sum(0).abs().max()) < 1e-10 * float(pf.F.abs().max())


def test_oracle_27_images_and_invalid_slots():
    """cutoff > box/2 takes the 27-image sum; reserve slots (invalid)
    feel and exert nothing."""
    jmol, jpp, pmol, ppp, box, _ = _scene("2cljq", n=27, rho=0.45)
    assert 2.5 > box.min() / 2
    jf, jm = compute_forces_n2_jit(jmol, jpp, jnp.asarray(box))
    pf, pm = compute_forces_n2(pmol, ppp, box, images=0)
    scale = np.abs(np.asarray(jf.F)).max()
    np.testing.assert_allclose(pf.F.numpy() / scale, np.asarray(jf.F) / scale,
                               atol=1e-11)
    np.testing.assert_allclose(float(pm.upot), float(jm.upot), rtol=1e-11)
    pmol.valid[20:] = False
    pf2, _ = compute_forces_n2(pmol, ppp, box, images=27)
    assert float(pf2.F[20:].abs().max()) == 0.0
    assert float((pf2.F[:20] - pf.F[:20]).abs().max()) > 0.0
