"""Kernel K1's plain PyTorch version (ls1_mardyn_tpu_torch/ops/cuda_lj.py)
against the JAX TPU kernel lj_cell_forces_pallas_cwn3l in interpret
mode, f64 on the CPU, on the scene of
tests/test_pallas_lj.py::test_pallas_lj_cwn3l_matches_cw (nd=4 random
cell-local coordinates, a tail of empty slots per cell).

Tolerances are those of the JAX kernel tests: forces atol 1e-12 after
scaling by max|F| (the two sum the same pair terms in another order),
u6 and virial rtol 1e-11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops.pallas_lj import (
    SENTINEL_SCALE,
    lj_cell_forces_pallas_cwn3l,
)
from ls1_mardyn_tpu_torch.models import potentials
from ls1_mardyn_tpu_torch.ops import cuda_lj
from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

ND, CL = 4, 2.8
LJ = dict(eps24=24.0, sig2=1.0, shift6=0.1, rc2=2.5 ** 2)


def _scene(cap, sentinel, seed=5):
    """r_i [nd, nd, 4, nd*cap] as numpy: uniform cell-local coordinates,
    slots past ~5/8 of cap empty (zeros or the y sentinel)."""
    W = ND * cap
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, CL, size=(ND, ND, 3, W))
    slot = np.arange(W) % cap
    invalid = slot >= (5 * cap) // 8
    if sentinel:
        ysent = SENTINEL_SCALE * (1.0 + slot.astype(np.float64))
        r[:, :, 1, :] = np.where(invalid[None, None], ysent, r[:, :, 1, :])
        r[:, :, 0, :] = np.where(invalid[None, None], 0.0, r[:, :, 0, :])
        r[:, :, 2, :] = np.where(invalid[None, None], 0.0, r[:, :, 2, :])
    w = np.where(invalid, 0.0, 1.0)
    return np.concatenate(
        [r, np.broadcast_to(w, (ND, ND, W))[:, :, None, :]], axis=2
    )


def _jax(r_i, cap, sentinel, macro):
    ri = jnp.asarray(r_i)
    left = ri[:, :, :, (ND - 1) * cap:]
    r_j = jnp.concatenate([left, ri, ri[:, :, :, : 3 * cap]], axis=3)
    out, u6, vir = lj_cell_forces_pallas_cwn3l(
        ri, r_j, nx=ND, ny=ND, nz=ND, cap=cap, tx=4, box=(ND * CL,) * 3,
        interpret=True, compute_macro=macro, sentinel=sentinel,
        fast_recip=False, **LJ,
    )
    return np.asarray(out)[:, :, :3], float(u6), float(vir)


def _port(r_i, cap, macro):
    return lj_cell_forces(
        torch.as_tensor(r_i), dims=(ND, ND, ND), cap=cap,
        cell_len=(CL, CL, CL), compute_macro=macro, **LJ,
    )


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("cap", [32, 64])
def test_lj_reference_matches_jax_cwn3l(cap, sentinel, macro):
    r_i = _scene(cap, sentinel)
    fa, u6a, vira = _jax(r_i, cap, sentinel, macro)
    fb, u6b, virb = _port(r_i, cap, macro)
    fb = fb.numpy()
    assert fb.shape == fa.shape
    scale = np.abs(fa).max()
    np.testing.assert_allclose(fb / scale, fa / scale, atol=1e-12)
    if macro:
        np.testing.assert_allclose(float(u6b), u6a, rtol=1e-11)
        np.testing.assert_allclose(float(virb), vira, rtol=1e-11)
    else:
        assert float(u6b) == 0.0 and float(virb) == 0.0


def test_lj_reference_matches_pair_function_brute_force():
    """Independent check of the cell traversal: every slot's force from
    a minimum-image sweep over all molecules with the LJ-12-6 pair
    function of models/potentials.py."""
    cap = 32
    r_i = _scene(cap, sentinel=False, seed=11)
    f, u6, vir = _port(r_i, cap, True)
    L = ND * CL
    g = r_i.reshape(ND, ND, 4, ND, cap).transpose(0, 1, 3, 4, 2)
    iz, iy, ix, _ = np.meshgrid(*(np.arange(n) for n in g.shape[:4]),
                                indexing="ij")
    absr = g[..., :3] + np.stack([ix, iy, iz], -1) * CL
    valid = g[..., 3] > 0.5
    pos = torch.as_tensor(absr[valid])
    dr = pos[:, None, :] - pos[None, :, :]
    dr = dr - L * torch.round(dr / L)
    dr2 = (dr * dr).sum(-1)
    m = (dr2 < LJ["rc2"]) & ~torch.eye(len(pos), dtype=torch.bool)
    fp, u6p = potentials.lj(dr, torch.where(m, dr2, 1.0), LJ["eps24"], LJ["sig2"])
    fp = fp * m[..., None]
    F = fp.sum(1).numpy()
    got = f.numpy().reshape(ND, ND, 3, ND, cap).transpose(0, 1, 3, 4, 2)[valid]
    scale = np.abs(F).max()
    np.testing.assert_allclose(got / scale, F / scale, atol=1e-12)
    u6_ref = 0.5 * float(((u6p + LJ["shift6"]) * m).sum())
    vir_ref = 0.5 * float((fp * dr).sum())
    np.testing.assert_allclose(float(u6), u6_ref, rtol=1e-11)
    np.testing.assert_allclose(float(vir), vir_ref, rtol=1e-11)


def test_lj_wrapper_reads_plane_slice_and_counts_only_cuda_launches():
    """The wrapper takes planes [:, :, :4, :] of the 8-plane RMM state
    in place; on a CPU tensor it runs the plain version and does not
    count a launch."""
    cap = 32
    r_i = _scene(cap, sentinel=True)
    planes = np.concatenate([r_i, np.ones_like(r_i)], axis=2)  # 8 planes
    before = cuda_lj.lj_cell_forces.launches
    fa = _port(r_i, cap, True)
    fb = lj_cell_forces(
        torch.as_tensor(planes)[:, :, :4, :], dims=(ND,) * 3, cap=cap,
        cell_len=(CL,) * 3, **LJ,
    )
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_lj.lj_cell_forces.launches == before


@pytest.mark.parametrize(
    "shape,dims,cap",
    [
        ((4, 4, 3, 128), (4, 4, 4), 32),  # 3 planes, not 4
        ((4, 4, 4, 4 * 48), (4, 4, 4), 48),  # cap not a multiple of 32
        ((2, 2, 4, 64), (2, 2, 2), 32),  # fewer than 3 cells per axis
    ],
)
def test_lj_wrapper_rejects_bad_shape(shape, dims, cap):
    r = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        lj_cell_forces(r, dims=dims, cap=cap, cell_len=(CL,) * 3, **LJ)


def test_lj_wrapper_rejects_bad_dtype():
    with pytest.raises(TypeError):
        lj_cell_forces(torch.zeros((4, 4, 4, 128), dtype=torch.int32),
                       dims=(4, 4, 4), cap=32, cell_len=(CL,) * 3, **LJ)
