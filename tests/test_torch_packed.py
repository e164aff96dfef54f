"""Kernel K10 and the packed-pencil layout (ls1_mardyn_tpu_torch/ops/
cuda_packed.py) against the JAX package's ops/pallas_packed.py, f64 on
the CPU.

The scenes are tests/test_pallas_packed.py's `_dense_state` (nd = 6,
cap 32, ragged occupancy, sentinel-filled empty slots), which have
groups at both periodic x ends.  pack_pencils, build_tables and
unpack_pencils are module-boundary layouts: every plane and table, and
the occupancy, start and count arrays, must be bit-identical.  The plain
K10 against the JAX kernel in interpret mode: forces atol 1e-12 after
scaling by max|F|, u6 and virial rtol 1e-11 (the JAX packed kernel
test's tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops import pallas_packed as JP
from ls1_mardyn_tpu_torch.ops import cuda_packed as PK
from ls1_mardyn_tpu_torch.ops.cuda_lj import SENTINEL_SCALE
from ls1_mardyn_tpu_torch.ops.cuda_lj_variants import lj_cell_forces_n3l

from test_pallas_packed import _dense_state

# pytest-xdist puts several workers on one CPU: one intra-op thread
# each keeps torch's OpenMP pool from oversubscribing the cores
torch.set_num_threads(1)

LJ = dict(eps24=24.0, sig2=1.0, shift6=0.1, rc2=2.5 ** 2)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _fill_jax(lane):
    """An empty-slot fill: zeros and the sentinel y (JAX arrays)."""
    z = jnp.zeros(lane.shape, jnp.float64)
    return [z, SENTINEL_SCALE * (1.0 + (lane % 32).astype(jnp.float64))] + [z] * 9


def _fill_port(lane):
    z = torch.zeros(lane.shape, dtype=torch.float64)
    return [z, SENTINEL_SCALE * (1.0 + (lane % 32).to(torch.float64))] + [z] * 9


@pytest.mark.parametrize("seed,Wp", [(7, 256), (11, 128)])
def test_pack_tables_unpack_bit_identical_to_jax(seed, Wp):
    """Wp = 256 pads the 192-lane pencils, Wp = 128 cuts them."""
    planes, f0, nd, cap, _ = _dense_state(seed=seed)
    jout = JP.pack_pencils(planes, f0, nd, cap, Wp)
    pout = PK.pack_pencils(torch.as_tensor(np.asarray(planes)),
                           torch.as_tensor(np.asarray(f0)), nd, cap, Wp)
    for what, a, b in zip(("packed", "pforces", "occ", "starts", "cnt",
                           "overflow"), pout, jout):
        _same(a, b, what)
    assert not bool(pout[5])
    packed, pf, occ, starts, cnt, _ = pout
    jt = JP.build_tables(jout[2], jout[3], jout[4], nx=nd, Wp=Wp)
    pt = PK.build_tables(occ, starts, cnt, nx=nd, Wp=Wp)
    for what, a, b in zip(("tab", "meta", "feasible"), pt, jt):
        _same(a, b, what)
    assert int(pt[1][:, :, 0, PK.M_ELO].sum()) > 0
    assert int(pt[1][:, :, 0, PK.M_EHI].sum()) > 0
    pb = PK.unpack_pencils(packed, pf, occ, starts, nd, cap)
    jb = JP.unpack_pencils(jout[0], jout[1], jout[2], jout[3], nd, cap)
    _same(pb[0], jb[0], "unpacked planes")
    _same(pb[1], jb[1], "unpacked forces")
    # the JAX package's filler option: the port fills empty slots with
    # zeros, so the same fill laid over its empty slots must give JAX's
    jb = JP.unpack_pencils(jout[0], jout[1], jout[2], jout[3], nd, cap,
                           empty_fill=_fill_jax)
    lane = torch.arange(nd * cap).expand(nd, nd, -1)
    empty = (lane % cap >= torch.repeat_interleave(occ, cap, dim=-1))[:, :, None]
    fill = torch.stack(_fill_port(lane), dim=2)
    _same(torch.where(empty, fill[:, :, :8], pb[0]), jb[0], "filled planes")
    _same(torch.where(empty, fill[:, :, 8:], pb[1]), jb[1], "filled forces")


@pytest.mark.parametrize("seed", [7, 11])
def test_packed_reference_matches_jax_kernel(seed):
    planes, f0, nd, cap, cl = _dense_state(seed=seed)
    Wp = 256
    packed, _, occ, starts, cnt, _ = JP.pack_pencils(
        planes, jnp.zeros_like(f0), nd, cap, Wp)
    tab, meta, feas = JP.build_tables(occ, starts, cnt, nx=nd, Wp=Wp)
    assert bool(feas)
    kw = dict(nx=nd, ny=nd, nz=nd, Wp=Wp, box=(nd * cl,) * 3, **LJ)
    fj, u6j, virj = JP.lj_forces_packed(packed[:, :, :4, :], tab, meta,
                                        interpret=True, compute_macro=True,
                                        fast_recip=False, **kw)
    f, u6, vir = PK.lj_forces_packed(
        torch.as_tensor(np.asarray(packed[:, :, :4, :])),
        torch.as_tensor(np.asarray(tab)), torch.as_tensor(np.asarray(meta)), **kw)
    fj = np.asarray(fj)
    # lanes past each pencil's count carry no molecule
    live = np.arange(Wp)[None, None, :] < np.asarray(cnt)[:, :, None]
    scale = np.abs(fj).max()
    np.testing.assert_allclose(np.where(live[:, :, None], f.numpy(), 0.0) / scale,
                               np.where(live[:, :, None], fj, 0.0) / scale,
                               atol=1e-12)
    np.testing.assert_allclose(float(u6), float(u6j), rtol=1e-11)
    np.testing.assert_allclose(float(vir), float(virj), rtol=1e-11)


def test_packed_reference_needs_no_feasible_table():
    """nd = 4 (nx < 6) and groups that wrap at both ends: the JAX tables
    call the state infeasible, the port's K10 computes it whole.  Against
    K8 on the dense state (each pair once in both)."""
    planes, _, _, cap, cl = _dense_state(nd=4, seed=5)
    nd, Wp = 4, 128
    p = torch.as_tensor(np.asarray(planes))
    packed, _, occ, starts, cnt, _ = PK.pack_pencils(
        p, torch.zeros_like(p[:, :, :3]), nd, cap, Wp)
    tab, meta, feas = PK.build_tables(occ, starts, cnt, nx=nd, Wp=Wp)
    assert not bool(feas)
    f, u6, vir = PK.lj_forces_packed(packed[:, :, :4].contiguous(), tab, meta,
                                     nx=nd, ny=nd, nz=nd, Wp=Wp,
                                     box=(nd * cl,) * 3, **LJ)
    _, fd = PK.unpack_pencils(packed, f, occ, starts, nd, cap)
    ref = lj_cell_forces_n3l(p[:, :, :4], dims=(nd,) * 3, cap=cap,
                             cell_len=(cl,) * 3, **LJ)
    w = p[:, :, 3:4] > 0.5
    scale = float(ref[0].abs().max())
    assert float((torch.where(w, fd - ref[0], 0.0)).abs().max()) / scale <= 1e-12
    np.testing.assert_allclose(float(u6), float(ref[1]), rtol=1e-11)
    np.testing.assert_allclose(float(vir), float(ref[2]), rtol=1e-11)
    assert PK.lj_forces_packed.launches == 0


def test_packed_wrapper_rejects_what_its_kernel_cannot_take():
    pos = torch.zeros((3, 3, 4, 64), dtype=torch.float64)
    tab = torch.zeros((3, 3, 2, PK.NT), dtype=torch.int32)
    meta = torch.zeros((3, 3, 1, PK.NMETA), dtype=torch.int32)
    kw = dict(nx=3, ny=3, nz=3, Wp=64, box=(8.4,) * 3, **LJ)
    with pytest.raises(TypeError):  # tables must be int32
        PK.lj_forces_packed(pos, tab.long(), meta, **kw)
    with pytest.raises(ValueError):  # fewer than 3 cells on an axis
        PK.lj_forces_packed(pos[:2], tab[:2], meta[:2], **dict(kw, nz=2))
    with pytest.raises(ValueError):  # cell edge below the cutoff
        PK.lj_forces_packed(pos, tab, meta, **dict(kw, box=(6.0,) * 3))
