"""Kernels K7, K8 and K9: their plain PyTorch versions
(ls1_mardyn_tpu_torch/ops/cuda_lj_variants.py) against the JAX TPU
kernels lj_cell_forces_pallas_lanej, lj_cell_forces_pallas_n3l and
lj_cell_forces_pallas_zb in interpret mode, f64 on the CPU.

The planes are tests/test_torch_lj_kernel.py's (nd=4 random cell-local
coordinates, slots past 5/8 of cap empty: zeros or the y sentinel).
Tolerances are the JAX kernel tests': forces atol 1e-12 after scaling
by max|F| (the same pair terms summed in another order), u6 and virial
rtol 1e-11; in gram mode 1e-9 for all three, as
tests/test_pallas_lj.py::test_pallas_lj_zb_matches_row_kernel has it
(the Gram form |r_i|^2 + |r_j|^2 - 2 r_i.r_j cancels on the random,
overlapping positions, where u6 reaches 1e20, and the two sides centre
their coordinates differently).
The JAX package has no test of lanej or n3l: these are the first to
hold them against anything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops.pallas_lj import (
    lj_cell_forces_pallas_lanej,
    lj_cell_forces_pallas_n3l,
    lj_cell_forces_pallas_zb,
)
from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V
from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces

from test_torch_lj_kernel import CL, LJ, ND, _scene

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)


def _xhalo(r, nx, cap):
    """One periodic x halo cell per side (plain copies, cell-local)."""
    return np.concatenate([r[..., (nx - 1) * cap:], r, r[..., :cap]], axis=-1)


def _close(port, jax_out, gram=False):
    f, u6, vir = port
    fa = np.asarray(jax_out[0])[:, :, :3]
    f = f.numpy()
    assert f.shape == fa.shape
    scale = np.abs(fa).max()
    np.testing.assert_allclose(f / scale, fa / scale, atol=1e-9 if gram else 1e-12)
    rtol = 1e-9 if gram else 1e-11
    np.testing.assert_allclose(float(u6), float(jax_out[1]), rtol=rtol)
    np.testing.assert_allclose(float(vir), float(jax_out[2]), rtol=rtol)


def _jax_kw(nd, cap, tx, sentinel):
    return dict(nx=nd[0], ny=nd[1], nz=nd[2], cap=cap, tx=tx,
                box=tuple(CL * n for n in nd), interpret=True,
                compute_macro=True, sentinel=sentinel, fast_recip=False, **LJ)


@pytest.mark.parametrize(
    "cap,sentinel,defer",
    [(32, False, True), (32, True, False), (64, True, True), (64, False, False)],
)
def test_lanej_reference_matches_jax(cap, sentinel, defer):
    r_i = _scene(cap, sentinel)
    r_j = _xhalo(r_i, ND, cap)
    ref = lj_cell_forces_pallas_lanej(
        jnp.asarray(r_i), jnp.asarray(r_j), defer=defer,
        **_jax_kw((ND,) * 3, cap, 4, sentinel))
    got = V.lj_cell_forces_lanej(
        torch.as_tensor(r_i), torch.as_tensor(r_j), dims=(ND,) * 3, cap=cap,
        box=(ND * CL,) * 3, defer=defer, **LJ)
    _close(got, ref)


@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("cap", [32, 64])
def test_n3l_reference_matches_jax(cap, sentinel):
    r_i = _scene(cap, sentinel)
    ref = lj_cell_forces_pallas_n3l(
        jnp.asarray(r_i), jnp.asarray(_xhalo(r_i, ND, cap)),
        **_jax_kw((ND,) * 3, cap, 4, sentinel))
    got = V.lj_cell_forces_n3l(torch.as_tensor(r_i), dims=(ND,) * 3, cap=cap,
                               cell_len=(CL,) * 3, **LJ)
    _close(got, ref)


def test_n3l_smallest_grid_matches_jax_and_k1():
    """3x3x3, the smallest grid K8 (and the TPU kernel) accepts: the
    forward offsets +1 and -1 reach different cells, and every pair
    still counts once."""
    cap, nd = 32, (3, 3, 3)
    W = 3 * cap
    rng = np.random.default_rng(3)
    r = rng.uniform(0, CL, size=(3, 3, 3, W))
    w = (np.arange(W) % cap < 18).astype(float)
    r[:, :, :, :] *= w
    r_i = np.concatenate([r, np.broadcast_to(w, (3, 3, W))[:, :, None]], axis=2)
    ref = lj_cell_forces_pallas_n3l(
        jnp.asarray(r_i), jnp.asarray(_xhalo(r_i, 3, cap)),
        **_jax_kw(nd, cap, 1, False))
    kw = dict(dims=nd, cap=cap, cell_len=(CL,) * 3, **LJ)
    got = V.lj_cell_forces_n3l(torch.as_tensor(r_i), **kw)
    _close(got, ref)
    _close(got, lj_cell_forces(torch.as_tensor(r_i), **kw))


@pytest.mark.parametrize(
    "cap,sentinel,gram",
    [(32, False, False), (32, True, False), (64, False, False), (64, True, False),
     (32, True, True), (64, False, True)],
)
def test_zb_reference_matches_jax(cap, sentinel, gram):
    """K9 on the first 4 planes of an 8-plane state, as the RMM engine
    passes it; the JAX side gets the 8-plane x-halo view (pj = 8).  In
    gram mode the JAX kernel reads validity (its sentinel flag off, as
    rmm.py sets it) while the data may still carry the sentinel fill."""
    r_i = _scene(cap, sentinel)
    planes = np.concatenate([r_i, np.ones_like(r_i)], axis=2)
    ref = lj_cell_forces_pallas_zb(
        jnp.asarray(r_i), jnp.asarray(_xhalo(planes, ND, cap)), gram=gram,
        **_jax_kw((ND,) * 3, cap, 4, sentinel and not gram))
    got = V.lj_cell_forces_zb(
        torch.as_tensor(planes)[:, :, :4], dims=(ND,) * 3, cap=cap,
        cell_len=(CL,) * 3, gram=gram, **LJ)
    _close(got, ref, gram=gram)


def test_variants_agree_with_k1_and_skip_macro():
    """All three variants against K1's plain version on one state
    (forces and both sums), and compute_macro=False gives zero sums;
    a CPU call counts no launch."""
    cap = 32
    r4 = torch.as_tensor(_scene(cap, True, seed=9))
    kw = dict(dims=(ND,) * 3, cap=cap, cell_len=(CL,) * 3, **LJ)
    ref = lj_cell_forces(r4, **kw)
    r_j = torch.as_tensor(_xhalo(r4.numpy(), ND, cap))
    counts = [fn.launches for fn in (V.lj_cell_forces_lanej, V.lj_cell_forces_n3l,
                                     V.lj_cell_forces_zb)]
    outs = {
        "lanej": lambda m: V.lj_cell_forces_lanej(
            r4, r_j, dims=(ND,) * 3, cap=cap, box=(ND * CL,) * 3,
            compute_macro=m, **LJ),
        "n3l": lambda m: V.lj_cell_forces_n3l(r4, compute_macro=m, **kw),
        "zb": lambda m: V.lj_cell_forces_zb(r4, compute_macro=m, **kw),
        "gram": lambda m: V.lj_cell_forces_zb(r4, gram=True, compute_macro=m, **kw),
    }
    for tag, fn in outs.items():
        got = fn(True)
        scale = float(ref[0].abs().max())
        tol = 1e-9 if tag == "gram" else 1e-13
        assert float((got[0] - ref[0]).abs().max()) / scale <= tol, tag
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-11, err_msg=tag)
        f, u6, vir = fn(False)
        np.testing.assert_array_equal(f.numpy(), got[0].numpy())
        assert float(u6) == 0.0 and float(vir) == 0.0
    assert counts == [fn.launches for fn in (V.lj_cell_forces_lanej,
                                             V.lj_cell_forces_n3l,
                                             V.lj_cell_forces_zb)]


def test_variant_wrappers_reject_what_their_kernels_cannot_take():
    z = torch.zeros((2, 4, 4, 4 * 32), dtype=torch.float64)
    with pytest.raises(ValueError):  # K8 needs 3 cells a side
        V.lj_cell_forces_n3l(z, dims=(4, 4, 2), cap=32, cell_len=(CL,) * 3, **LJ)
    r = torch.zeros((4, 4, 4, 4 * 32), dtype=torch.float64)
    with pytest.raises(ValueError):  # cell edge below the cutoff
        V.lj_cell_forces_zb(r, dims=(4, 4, 4), cap=32, cell_len=(2.0,) * 3, **LJ)
    with pytest.raises(ValueError):  # j view without its x halo
        V.lj_cell_forces_lanej(r, r, dims=(4, 4, 4), cap=32,
                               box=(4 * CL,) * 3, **LJ)
    # a cap that needs more shared memory than a block has raises from
    # the launch on the card (chip_smoke.py's K9 phase); the CPU runs the
    # plain version at any cap
