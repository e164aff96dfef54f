"""Kernel K2's plain PyTorch version (ls1_mardyn_tpu_torch/ops/cuda_rebin.py,
through RMMSimulation._rebin_shift) against the JAX package's
RMMSimulation._rebin_shift and its Pallas kernel rebin_shift_pallas
(interpret mode), on the CPU.

The state is a cubic-grid scene drifted for 12 steps by the port (so
molecules have crossed cell faces); the same numpy arrays go to both
sides.  Planes, forces and the overflow flag must be BIT-identical, in
f64 and in f32, as tests/test_pallas_rebin.py demands of the JAX pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.io.generators import cubic_grid
from ls1_mardyn_tpu.ops.cells import CellGridSpec as JaxSpec
from ls1_mardyn_tpu.ops.rmm import RMMSimulation as JaxRMM
from ls1_mardyn_tpu.ops.rmm import RMMState as JaxState
from ls1_mardyn_tpu.scene import build_scene
from ls1_mardyn_tpu_torch.interop import rmm_state_from_numpy
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift
from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation
from ls1_mardyn_tpu_torch.state import MoleculeState

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

N, RHO, T, RC, DT = 500, 0.5, 1.2, 2.5, 0.004
DTYPES = {"f64": (torch.float64, jnp.float64, np.float64),
          "f32": (torch.float32, jnp.float32, np.float32)}


def _sims(sentinel_edge, prec, steps=12):
    """(port sim drifted `steps` steps, JAX sim on the same grid)."""
    tdt, jdt, ndt = DTYPES[prec]
    L = (N / RHO) ** (1 / 3)
    data = cubic_grid(N, [L, L, L], T, seed=3)
    nd = max(4, int(L / (RC + sentinel_edge)))
    nd -= nd % 4
    # the box as the working precision holds it, on both sides
    box = tuple(float(b) for b in np.asarray(data.box, ndt))
    table = ComponentTable(data.components, mixing_xi=data.mixing_xi,
                           mixing_eta=data.mixing_eta, eps_rf=data.eps_rf,
                           cutoff=RC, lj_cutoff=RC)
    sim = RMMSimulation(
        table, PairParams.from_table(table, tdt, "cpu"), box,
        CellGridSpec(dims=(nd,) * 3, box=box, cap=32), dt=DT,
        target_temperature=T, rebin_every=10 ** 9, sample_every=1,
        device="cpu",
    )
    sim.init_from_molecules(MoleculeState.from_numpy(
        r=data.r, v=data.v, mid=data.mid.astype(np.int32), dtype=tdt,
        device="cpu"))
    for _ in range(steps):
        sim.state, _ = sim._step(sim.state)
    _, jpp, jtable, jbox = build_scene(data, cutoff=RC, dtype=jdt)
    jsim = JaxRMM(jtable, jpp, jbox, JaxSpec(dims=(nd,) * 3, box=box, cap=32),
                  dt=DT, target_temperature=T, thermostat=True, tx=4,
                  rebin_every=10 ** 9, sample_every=1, interpret=True)
    assert sim.sentinel == jsim.sentinel
    return sim, jsim


def _to_jax(st_np):
    return JaxState(**{k: jnp.asarray(v) for k, v in st_np.items()})


def _assert_same(port_state, jax_state):
    np.testing.assert_array_equal(port_state.planes.numpy(),
                                  np.asarray(jax_state.planes))
    np.testing.assert_array_equal(port_state.forces.numpy(),
                                  np.asarray(jax_state.forces))


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("sentinel_edge", [0.2, 0.8])
def test_rebin_shift_bit_identical_to_jax(sentinel_edge, prec):
    sim, jsim = _sims(sentinel_edge, prec)
    st_np = sim.state_numpy()
    sa, ova = sim._rebin_shift(sim.state)
    sb, ovb = jsim._rebin_shift(_to_jax(st_np))
    assert bool(ova) == bool(ovb) == False  # noqa: E712
    _assert_same(sa, sb)
    # some molecules really changed cell
    moved = sa.planes[:, :, 7, :] != sim.state.planes[:, :, 7, :]
    assert bool(moved.any())


def test_rebin_shift_bit_identical_to_pallas_kernel():
    sim, jsim = _sims(0.2, "f32")
    st_np = sim.state_numpy()
    sa, ova = sim._rebin_shift(sim.state)
    sb, ovb = jsim._rebin_shift_pl(_to_jax(st_np))
    assert bool(ova) == bool(ovb) == False  # noqa: E712
    _assert_same(sa, sb)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_global_rebin_bit_identical_to_jax(prec):
    sim, jsim = _sims(0.8, prec)
    st_np = sim.state_numpy()
    sa, ova = sim._rebin(sim.state)
    sb, ovb = jsim._rebin(_to_jax(st_np))
    assert bool(ova) == bool(ovb) == False  # noqa: E712
    _assert_same(sa, sb)


def test_rebin_overflow_on_skin_violation_and_fallback():
    """A molecule teleported two cells along x latches the overflow in
    both implementations; RMMSimulation.rebin then falls back to the
    global rebin, which places it in the right cell."""
    sim, jsim = _sims(0.2, "f64", steps=0)
    st_np = sim.state_numpy()
    p = st_np["planes"]
    zi, yi, li = np.argwhere(p[:, :, 3, :] > 0.5)[0]
    mid = p[zi, yi, 7, li]
    p[zi, yi, 0, li] += 2.0 * float(sim.spec.cell_len[0])
    sim.state = rmm_state_from_numpy(**st_np)
    _, ova = sim._rebin_shift(sim.state)
    _, ovb = jsim._rebin_shift(_to_jax(st_np))
    assert bool(ova) and bool(ovb)
    sim.rebin()
    assert sim.n_rebin_fallback == 1
    cap = sim.spec.cap
    q = sim.state.planes.numpy()
    z2, y2, l2 = np.argwhere(q[:, :, 7, :] == mid)[0]
    assert (z2, y2) == (zi, yi) and l2 // cap == (li // cap + 2) % sim.spec.dims[0]
    np.testing.assert_allclose(q[z2, y2, 0, l2], p[zi, yi, 0, li]
                               - 2.0 * sim.spec.cell_len[0], atol=1e-12)


def test_rebin_wrapper_rejects_bad_input():
    big = torch.zeros((4, 4, 11, 128), dtype=torch.float64)
    kw = dict(dims=(4, 4, 4), cap=32, cell_len=(3.0,) * 3, sentinel=False)
    with pytest.raises(ValueError):
        rebin_shift(big[:, :, :10], **kw)
    with pytest.raises(ValueError):
        rebin_shift(big.transpose(0, 1).contiguous().transpose(0, 1), **kw)
    with pytest.raises(TypeError):
        rebin_shift(big.to(torch.int64), **kw)
