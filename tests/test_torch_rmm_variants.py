"""The port's RMMSimulation (one force path, kernel K1) against every
kernel path of the JAX package's, f64 on the CPU (JAX in interpret
mode).

One JAX simulation per switch setting (row kernel, cw without n3l,
lanej, n3l, zb, zb with gram), each switch set before the first force
evaluation: the JAX engine traces its kernel once.  The port's engine,
which has no switches, starts from the JAX engine's initial state
(through ls1_mardyn_tpu_torch.interop), and both run 10 steps on an
N = 1000 scene of nd = 4 cells a side at cap 64, with one shift rebin
(step 8).  Per molecule id, r and v agree to atol 1e-10; T, p and Upot
to rtol 1e-10.
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
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation

from test_torch_rmm import _by_mid

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

RC, DT = 2.5, 0.002
N, RHO, T, ND, CAP = 1000, 0.55, 1.0, 4, 64

# the JAX engine's switches each case sets (the rest keep its defaults)
SWITCHES = {
    "row": dict(cw=False),
    "cw": dict(cwn3l=False),
    "lanej": dict(cw=False, lanej=True),
    "n3l": dict(cw=False, n3l=True),
    "zb": dict(cw=False, zb=True),
    "zb_gram": dict(cw=False, zb=True, zb_gram=True),
}


def _sims(switches):
    """(JAX engine, port engine, box length) on the shared scene, the
    JAX engine with `switches` set and the port started from its state."""
    L = (N / RHO) ** (1.0 / 3.0)
    data = cubic_grid(N, [L, L, L], T, seed=3)
    mol, jpp, table, box = build_scene(data, cutoff=RC, dtype=jnp.float64)
    box_t = tuple(float(b) for b in np.asarray(box))
    kw = dict(dt=DT, target_temperature=T, thermostat=True, rebin_every=8)
    jsim = JaxRMM(table, jpp, box, JaxSpec(dims=(ND,) * 3, box=box_t, cap=CAP),
                  tx=4, interpret=True, **kw)
    ptable = ComponentTable(data.components, mixing_xi=data.mixing_xi,
                            mixing_eta=data.mixing_eta, eps_rf=data.eps_rf,
                            cutoff=RC, lj_cutoff=RC)
    pp = pair_params_from_numpy({k: np.asarray(v) for k, v in vars(jpp).items()})
    sim = RMMSimulation(ptable, pp, box_t,
                        CellGridSpec(dims=(ND,) * 3, box=box_t, cap=CAP),
                        device="cpu", **kw)
    for k, v in switches.items():
        setattr(jsim, k, v)
    jsim.init_from_molecules(mol)
    st = jsim.state
    sim.state = rmm_state_from_numpy(
        *(np.asarray(getattr(st, k)) for k in
          ("planes", "forces", "vcomp", "rcomp", "u6", "vir")))
    return jsim, sim, L


def _agree(ga, gb, ma, mb, L):
    for name in ("temperature", "pressure", "upot"):
        np.testing.assert_allclose(float(getattr(ga, name)),
                                   float(getattr(gb, name)), rtol=1e-10,
                                   err_msg=name)
    mid_a, r_a, v_a = _by_mid(ma)
    mid_b, r_b, v_b = _by_mid(mb)
    np.testing.assert_array_equal(mid_a, mid_b)
    assert len(mid_a) == N
    dr = r_a - r_b
    dr -= L * np.round(dr / L)
    np.testing.assert_allclose(dr, 0.0, atol=1e-10)
    np.testing.assert_allclose(v_a, v_b, atol=1e-10)


@pytest.mark.parametrize("case", list(SWITCHES))
def test_rmm_switch_matches_jax(case):
    jsim, sim, L = _sims(SWITCHES[case])
    assert sim.sentinel and jsim.sentinel  # the empty slots carry the fill
    gj = jsim.run(10)
    gp = sim.run(10)
    _agree(gp, gj, sim.to_molecules(), jsim.to_molecules(), L)
