"""The port's FMM solvers (ls1_mardyn_tpu_torch/ops/fmm.py and
ops/fmm_adaptive.py) against the JAX package's (ls1_mardyn_tpu/ops/fmm.py,
ops/fmm_adaptive.py), f64 on the CPU: the M2M, L2L, M2L and lattice
operator matrices bit-identical; the uniform solver at depths 2 and 3
and periodic equal to JAX's to rounding and within the JAX tests'
tolerances of the direct sum (tests/test_fmm.py); the adaptive solver's
build_plan lists equal to JAX's and its result equal to JAX's and within
tests/test_fmm_adaptive.py's tolerances of the direct sum.

JAX compiles each solver shape once and builds its operators in Python
loops, so the JAX side runs at low orders and few lattice scales; the
accuracy checks against the direct sum run on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops import fmm as jax_fmm
from ls1_mardyn_tpu.ops import fmm_adaptive as jax_afmm
from ls1_mardyn_tpu_torch.ops.fmm import (
    FMMSolver,
    _l2l_matrix,
    _m2l_matrix,
    _m2m_matrix,
    direct_coulomb,
)
from ls1_mardyn_tpu_torch.ops import fmm_adaptive
from ls1_mardyn_tpu_torch.ops.fmm_adaptive import AdaptiveFMMSolver
from test_fmm import _cluster
from test_fmm_adaptive import _clustered, _direct

torch.set_num_threads(1)
F64 = torch.float64


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_operator_builders_bit_identical():
    rng = np.random.default_rng(1)
    for p in (2, 5, 8):
        for _ in range(3):
            t = rng.normal(size=3)
            assert _same(_m2m_matrix(t, p), jax_fmm._m2m_matrix(t, p))
            assert _same(_l2l_matrix(t, p), jax_fmm._l2l_matrix(t, p))
            assert _same(_m2l_matrix(t * 3, p), jax_fmm._m2l_matrix(t * 3, p))


@pytest.mark.parametrize("periodic", [False, True])
def test_solver_operators_bit_identical(periodic):
    kw = dict(box=5.0, depth=3, order=3, cap=32, periodic=periodic,
              lattice_scales=3)
    s = FMMSolver(dtype=F64, **kw, device="cpu")
    j = jax_fmm.FMMSolver(dtype=jnp.float64, **kw)
    for name in ("_m2m", "_l2l", "_m2l") + (("_lat_m2m", "_lat_m2l")
                                            if periodic else ()):
        assert len(getattr(s, name)) == len(getattr(j, name))
        for a, b in zip(getattr(s, name), getattr(j, name)):
            assert _same(a, b), name
    assert s._m2l_offsets == j._m2l_offsets
    if periodic:
        assert _same(s._lat_d0, j._lat_d0)
    assert _same(s._neighbor_table(), j._neighbor_table())
    s32 = FMMSolver(dtype=torch.float32, **kw, device="cpu")
    j32 = jax_fmm.FMMSolver(dtype=jnp.float32, **kw)
    assert all(_same(a, b) for a, b in zip(s32._m2l, j32._m2l))


def _port_vs_jax(r, q, kw, valid=None):
    """(port U, F, phi) and (JAX U, F, phi) of one solver configuration."""
    U, F, phi = FMMSolver(dtype=F64, **kw, device="cpu").compute(r, q, valid)
    jv = None if valid is None else jnp.asarray(valid)
    jU, jF, jphi = jax_fmm.FMMSolver(dtype=jnp.float64, **kw).compute(r, q, jv)
    return (float(U), F.numpy(), phi.numpy()), (float(jU), np.asarray(jF),
                                                np.asarray(jphi))


def _close(a, b, tol=1e-11):
    for x, y in zip(a, b):
        assert np.abs(np.asarray(x) - np.asarray(y)).max() <= tol * max(
            np.abs(np.asarray(y)).max(), 1e-300), (x, y)


def test_fmm_depth2_vs_jax_and_direct():
    r, q = _cluster(300, 8.0, seed=7)
    port, jax_ = _port_vs_jax(r, q, dict(box=8.0, depth=2, order=4, cap=64))
    _close(port, jax_)
    U, F, phi = FMMSolver(box=8.0, depth=2, order=6, cap=64, dtype=F64,
                          device="cpu").compute(r, q)
    phi_d, F_d, U_d = direct_coulomb(r, q)
    scale = 0.5 * np.abs(q * phi_d).sum()
    assert abs(float(U) - U_d) / scale < 1e-4
    assert np.abs(F.numpy() - F_d).max() / np.abs(F_d).max() < 2e-3
    assert np.abs(phi.numpy() - phi_d).max() / np.abs(phi_d).max() < 1e-3


def test_fmm_depth3_vs_jax_and_direct():
    r, q = _cluster(600, 16.0, seed=9, neutral=False)
    port, jax_ = _port_vs_jax(r, q, dict(box=16.0, depth=3, order=4, cap=32))
    _close(port, jax_)
    U, F, _ = port
    phi_d, F_d, U_d = direct_coulomb(r, q)
    scale = 0.5 * np.abs(q * phi_d).sum()
    assert abs(U - U_d) / scale < 1e-3
    assert np.abs(F - F_d).max() / np.abs(F_d).max() < 2e-2


def test_fmm_periodic_vs_jax_and_madelung():
    cells = 4
    idx = np.arange(cells)
    g = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    r = (g + 0.5).astype(float)
    q = np.where(g.sum(1) % 2 == 0, 1.0, -1.0)
    rng = np.random.default_rng(2)
    r_j = (r + rng.normal(0, 0.1, r.shape)) % cells
    port, jax_ = _port_vs_jax(r_j, q, dict(box=float(cells), depth=2, order=3,
                                           cap=16, periodic=True,
                                           lattice_scales=4))
    _close(port, jax_)
    U, F, _ = FMMSolver(box=float(cells), depth=2, order=6, cap=16, dtype=F64,
                        periodic=True, lattice_scales=8, device="cpu").compute(r, q)
    np.testing.assert_allclose(-2.0 * float(U) / len(q), 1.7475645946, rtol=5e-5)
    assert np.abs(F.numpy()).max() < 5e-4


def test_fmm_valid_mask_and_overflow():
    r, q = _cluster(64, 8.0, seed=13)
    valid = np.ones(64, bool)
    valid[50:] = False
    port, jax_ = _port_vs_jax(r, q, dict(box=8.0, depth=2, order=4, cap=64),
                              valid=valid)
    _close(port, jax_)
    phi_d, F_d, U_d = direct_coulomb(r[:50], q[:50])
    assert abs(port[0] - U_d) / (0.5 * np.abs(q[:50] * phi_d).sum()) < 1e-3
    s2 = FMMSolver(box=8.0, depth=2, order=2, cap=4, dtype=F64, device="cpu")
    r_cram = np.full((64, 3), 1.0) + np.random.default_rng(0).uniform(0, 0.5, (64, 3))
    with pytest.raises(RuntimeError, match="capacity"):
        s2.compute(r_cram, q)


def test_f32_periodic_lattice_scaling():
    n_side = 4
    idx = np.arange(n_side)
    g = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    r = (g + 0.5).astype(float)
    q = np.where(g.sum(1) % 2 == 0, 1.0, -1.0).astype(float)
    # order 6 and 8 scales: the Madelung test's operators (cached); raw
    # lattice entries would overflow f32 by scale ~8
    solver = FMMSolver(box=float(n_side), depth=2, order=6, cap=16,
                       dtype=torch.float32, periodic=True, lattice_scales=8,
                       device="cpu")
    assert all(np.isfinite(a).all() for a in solver._lat_m2m + solver._lat_m2l)
    U, F, _ = solver.compute(r, q)
    assert np.isfinite(F.numpy()).all()
    assert abs(-float(U) * 2 / len(r) - 1.7475646) < 2e-4


# -- adaptive ---------------------------------------------------------------


def _plan_np(plan):
    return {k: np.asarray(v) for k, v in plan._asdict().items()}


def test_adaptive_plan_lists_equal_jax():
    """build_plan of the gid scene (threshold 4: deep splits, the gid guard
    active) and of a plain clustered scene with invalid slots: every list
    equal to the JAX solver's."""
    rng = np.random.default_rng(7)
    nmol, box = 120, 8.0
    com = _clustered(rng, 3 * nmol, box)[:nmol]
    r = np.clip((com[:, None, :] + rng.normal(0, 0.25, (nmol, 3, 3))).reshape(-1, 3),
                1e-6, box * (1 - 1e-6))
    gid = np.repeat(np.arange(nmol, dtype=np.int32), 3)
    valid = np.ones(len(r), bool)
    valid[::11] = False
    for kw, args in ((dict(threshold=4), dict(gid=gid)),
                     (dict(threshold=16), dict(valid=valid))):
        port = AdaptiveFMMSolver(box=box, order=4, dtype=F64, device="cpu",
                                 **kw).build_plan(r, **args)
        jplan = jax_afmm.AdaptiveFMMSolver(box=box, order=4, dtype=jnp.float64,
                                           **kw).build_plan(r, **args)
        a, b = _plan_np(port), _plan_np(jplan)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def test_adaptive_fmm_vs_jax_and_direct():
    rng = np.random.default_rng(11)
    n, box = 480, 10.0
    r = _clustered(rng, n, box)
    q = rng.uniform(-1.0, 1.0, n)
    q -= q.mean()
    U, F, phi = AdaptiveFMMSolver(box=box, order=4, threshold=24,
                                  dtype=F64, device="cpu").compute(r, q)
    jU, jF, jphi = jax_afmm.AdaptiveFMMSolver(
        box=box, order=4, threshold=24, dtype=jnp.float64).compute(r, q)
    _close((float(U), F.numpy(), phi.numpy()),
           (float(jU), np.asarray(jF), np.asarray(jphi)))
    # at the JAX test's order, against the direct sum
    U, F, phi = AdaptiveFMMSolver(box=box, order=8, threshold=24,
                                  dtype=F64, device="cpu").compute(r, q)
    U0, F0, phi0 = _direct(r, q)
    assert float(U) == pytest.approx(U0, rel=2e-4)
    fs = np.linalg.norm(F0, axis=1).max()
    assert np.max(np.linalg.norm(F.numpy() - F0, axis=1)) / fs < 5e-3
    assert np.max(np.abs(phi.numpy() - phi0)) / np.abs(phi0).max() < 1e-3


def test_adaptive_fmm_gid_exclusion_and_valid_mask():
    rng = np.random.default_rng(7)
    nmol, box = 120, 8.0
    com = _clustered(rng, 3 * nmol, box)[:nmol]
    r = np.clip((com[:, None, :] + rng.normal(0, 0.25, (nmol, 3, 3))).reshape(-1, 3),
                1e-6, box * (1 - 1e-6))
    q = np.tile([0.8, -0.4, -0.4], nmol)
    gid = np.repeat(np.arange(nmol, dtype=np.int32), 3)
    U, F, _ = AdaptiveFMMSolver(box=box, order=8, threshold=4,
                                dtype=F64, device="cpu").compute(r, q, gid=gid)
    U0, F0, _ = _direct(r, q, gid=gid)
    assert float(U) == pytest.approx(U0, rel=5e-4)
    fs = np.linalg.norm(F0, axis=1).max()
    assert np.max(np.linalg.norm(F.numpy() - F0, axis=1)) / fs < 5e-3
    # invalid slots contribute nothing, through a reused plan
    valid = np.ones(len(r), bool)
    valid[::7] = False
    solver = AdaptiveFMMSolver(box=box, order=6, threshold=16, dtype=F64, device="cpu")
    plan = solver.build_plan(r, valid)
    U, F, _ = solver.compute(r, q, valid=valid, plan=plan)
    U0, F0, _ = _direct(r[valid], q[valid])
    assert float(U) == pytest.approx(U0, rel=5e-4)
    assert np.allclose(F.numpy()[~valid], 0.0)


def test_adaptive_fmm_chunks_change_only_rounding(monkeypatch):
    """The M2L and P2P passes take chunks sized by PASS_BYTES: a budget
    that cuts them into many small chunks gives the one-chunk result to
    rounding."""
    rng = np.random.default_rng(11)
    n, box = 480, 10.0
    r = _clustered(rng, n, box)
    q = rng.uniform(-1.0, 1.0, n)
    q -= q.mean()
    solver = AdaptiveFMMSolver(box=box, order=4, threshold=24, dtype=F64,
                               device="cpu")
    plan = solver.build_plan(r)
    one = solver.compute(r, q, plan=plan)
    # ~100 M2L pairs and ~20 leaf pairs a chunk at order 4
    monkeypatch.setattr(fmm_adaptive, "PASS_BYTES", 2 * 10 ** 6)
    many = solver.compute(r, q, plan=plan)
    assert plan.m2l_tgt.shape[0] > 1000 and plan.p2p_tgt.shape[0] > 1000
    np.testing.assert_allclose(float(many[0]), float(one[0]), rtol=1e-12)
    for a, b in zip(many[1:], one[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()))
