"""The port's RMMSimulation against the JAX package's RMMSimulation
(interpret mode), f64 on the CPU.

Both start from the JAX engine's initial state, carried across through
ls1_mardyn_tpu_torch.interop, and run 20 steps with rebin_every=4 (so
the shift rebin runs four times).  Per molecule id, r and v agree to
atol 1e-10; T, p and Upot to rtol 1e-9.  Cases at cap 32 and cap 64
(the capacity the driver's re-spec doubles to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.generators import cubic_grid
from ls1_mardyn_tpu.ops.cells import CellGridSpec as JaxSpec
from ls1_mardyn_tpu.ops.rmm import RMMSimulation as JaxRMM
from ls1_mardyn_tpu.scene import build_scene
from ls1_mardyn_tpu_torch.interop import pair_params_from_numpy, rmm_state_from_numpy
from ls1_mardyn_tpu_torch.io.generators import cubic_grid as port_cubic_grid
from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation
from ls1_mardyn_tpu_torch.state import MoleculeState

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

RC, DT = 2.5, 0.002


def _by_mid(mol):
    valid = np.asarray(mol.valid)
    mid = np.asarray(mol.mid)[valid]
    o = np.argsort(mid)
    return mid[o], np.asarray(mol.r)[valid][o], np.asarray(mol.v)[valid][o]


@pytest.mark.parametrize(
    "n,rho,T,nd,cap",
    [
        (500, 0.45, 1.1, 4, 32),
        (500, 0.55, 1.0, 3, 64),  # the tests/test_rmm.py scene
    ],
)
def test_rmm_matches_jax(n, rho, T, nd, cap):
    L = (n / rho) ** (1.0 / 3.0)
    data = cubic_grid(n, [L, L, L], T, seed=3)
    mol, jpp, table, box = build_scene(data, cutoff=RC, dtype=jnp.float64)
    box_t = tuple(float(b) for b in np.asarray(box))
    kw = dict(dt=DT, target_temperature=T, thermostat=True, rebin_every=4)
    jsim = JaxRMM(table, jpp, box, JaxSpec(dims=(nd,) * 3, box=box_t, cap=cap),
                  tx=next(t for t in (4, 2, 1) if nd % t == 0),
                  interpret=True, **kw)
    assert jsim.cwn3l  # the JAX side runs kernel K1's TPU original
    jsim.init_from_molecules(mol)

    ptable = ComponentTable(data.components, mixing_xi=data.mixing_xi,
                            mixing_eta=data.mixing_eta, eps_rf=data.eps_rf,
                            cutoff=RC, lj_cutoff=RC)
    pp = pair_params_from_numpy(
        {k: np.asarray(v) for k, v in vars(jpp).items()})
    sim = RMMSimulation(ptable, pp, box_t,
                        CellGridSpec(dims=(nd,) * 3, box=box_t, cap=cap),
                        device="cpu", **kw)
    st = jsim.state
    sim.state = rmm_state_from_numpy(
        *(np.asarray(getattr(st, k)) for k in
          ("planes", "forces", "vcomp", "rcomp", "u6", "vir")))

    gj = jsim.run(20)
    gp = sim.run(20)
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(gp, name)),
                                   float(getattr(gj, name)), rtol=1e-9,
                                   err_msg=name)
    mid_j, r_j, v_j = _by_mid(jsim.to_molecules())
    mid_p, r_p, v_p = _by_mid(sim.to_molecules())
    np.testing.assert_array_equal(mid_p, mid_j)
    assert len(mid_p) == n
    dr = r_p - r_j
    dr -= L * np.round(dr / L)
    np.testing.assert_allclose(dr, 0.0, atol=1e-10)
    np.testing.assert_allclose(v_p, v_j, atol=1e-10)


def test_rmm_init_packing_consistent_on_boundaries():
    """Regression (tests/test_rmm.py): init_from_molecules must bin by
    the SAME host-f64 cell assignment that defines the cell-local
    coordinates.  An independent f32 binning can disagree on
    boundary-exact coordinates (lattice scenes), displacing molecules by
    a whole cell edge.  Invariant: cell origin + local == the molecule's
    true position."""
    # nd=6: the port's 27-cell kernel needs cell edge >= rc (the JAX
    # test's nd=8 grid runs the JAX row kernel instead)
    n, nd, cap = 4096, 6, 64
    rho, T = 0.8, 1.1
    L = (n / rho) ** (1 / 3)
    c = Component(cid=0)
    c.add_ljcenter(0, 0, 0, 1.0, 1.0, 1.0, RC, True)
    data = port_cubic_grid(n, [L, L, L], T, components=[c], seed=7)
    # snap a third of the molecules onto cell planes
    cl = L / nd
    snap = np.arange(0, n, 3)
    data.r[snap, 0] = np.round(data.r[snap, 0] / cl) * cl % L
    table = ComponentTable(data.components, cutoff=RC, lj_cutoff=RC)
    mol = MoleculeState.from_numpy(r=data.r, v=data.v,
                                   mid=data.mid.astype(np.int32),
                                   dtype=torch.float32, device="cpu")
    box = tuple(float(b) for b in np.asarray(data.box, np.float32))
    spec = CellGridSpec(dims=(nd,) * 3, box=box, cap=cap)
    sim = RMMSimulation(table, None, box, spec, dt=0.002,
                        target_temperature=T, device="cpu")
    sim.init_from_molecules(mol)
    p = sim.state.planes.numpy().astype(np.float64)
    w = p[:, :, 3, :] > 0.5
    lane = np.arange(nd * cap)
    zz, yy = np.meshgrid(np.arange(nd), np.arange(nd), indexing="ij")
    clv = np.asarray(spec.cell_len)
    absr = np.stack([
        p[:, :, 0, :] + (lane // cap)[None, None, :] * clv[0],
        p[:, :, 1, :] + yy[:, :, None] * clv[1],
        p[:, :, 2, :] + zz[:, :, None] * clv[2],
    ], -1)
    mid = p[:, :, 7, :].astype(int)
    rt = mol.r.numpy().astype(np.float64)[mid[w] - 1]
    err = np.abs(absr[w] - rt).max()
    assert err < 1e-4, f"mispacked molecules: max displacement {err}"
    assert int(w.sum()) == n
