"""The port's cell container and general traversal
(ls1_mardyn_tpu_torch/ops/cells.py, ops/cellforce.py) against the JAX
package's, f64 on the CPU.

bin_particles / neighbor_table: integer tables, equal element for
element (the port's argsort is stable, as jnp.argsort).
compute_forces_cells on the three scenes of test_torch_models.py: the
same pair terms summed in another order, so F, M, Vi agree to 1e-11 of
their max and u6, uX, myRF, virial to rtol 1e-11; the same against the
port's own N^2 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.ops import cells as jcells
from ls1_mardyn_tpu.ops.cellforce import compute_forces_cells as jax_forces_cells
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops import cells as pcells
from ls1_mardyn_tpu_torch.ops.cellforce import compute_forces_cells
from test_torch_models import _scene

torch.set_num_threads(1)


def _specs(box, cap, z_edges=None, cutoff=2.5):
    js = jcells.CellGridSpec.create(box, cutoff, cap=cap)
    ps = pcells.CellGridSpec.create(box, cutoff, cap=cap)
    if z_edges is not None:
        dims = (js.dims[0], js.dims[1], len(z_edges) - 1)
        js = jcells.CellGridSpec(dims=dims, box=js.box, cap=cap, z_edges=z_edges)
        ps = pcells.CellGridSpec(dims=dims, box=ps.box, cap=cap, z_edges=z_edges)
    assert js.dims == ps.dims and js.cell_len == ps.cell_len
    return js, ps


def _assert_bins_equal(pb, jb):
    for name in ("slots", "counts", "cell_of", "slot_of"):
        got = getattr(pb, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb, name)),
                                      name)
    assert bool(pb.overflow) == bool(jb.overflow)


@pytest.mark.parametrize("case", ["uniform", "z_edges", "invalid", "overflow"])
def test_bin_particles_equals_jax(case):
    rng = np.random.default_rng(2)
    box = (10.4, 7.9, 13.1)
    n = 600
    r = rng.uniform(0, 1, (n, 3)) * np.asarray(box)
    # lattice planes exactly on cell boundaries
    r[:40, 0] = np.repeat(np.arange(4) * (box[0] / 4), 10)
    valid = np.ones(n, bool)
    cap, z_edges = 32, None
    if case == "z_edges":
        z_edges = (0.0, 2.6, 5.3, 9.9, 13.1)
    elif case == "invalid":
        valid[rng.permutation(n)[:150]] = False
    elif case == "overflow":
        cap = 8
    js, ps = _specs(box, cap, z_edges)
    jb = jcells.bin_particles(jnp.asarray(r), jnp.asarray(valid), js)
    pb = pcells.bin_particles(torch.as_tensor(r), torch.as_tensor(valid), ps)
    _assert_bins_equal(pb, jb)
    assert bool(pb.overflow) == (case == "overflow")
    if case == "invalid":
        assert int(pb.counts.sum()) == 450
        assert (pb.slot_of[~torch.as_tensor(valid)] == ps.n_cells * cap).all()


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 2, 1), (5, 3, 2)])
def test_neighbor_table_equals_jax(dims):
    box = tuple(2.7 * d for d in dims)
    ji, jshift = jcells.neighbor_table(jcells.CellGridSpec(dims, box, 8))
    pi, pshift = pcells.neighbor_table(pcells.CellGridSpec(dims, box, 8))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pshift, jshift)


def test_wrap_positions_and_adaptive_edges_equal_jax():
    rng = np.random.default_rng(3)
    box = (6.0, 7.0, 30.0)
    r = rng.uniform(-3, 12, (200, 3))
    np.testing.assert_array_equal(
        pcells.wrap_positions(torch.as_tensor(r), box).numpy(),
        np.asarray(jcells.wrap_positions(jnp.asarray(r), box)))
    r = rng.uniform(0, 1, (800, 3)) * np.asarray(box)
    r[:, 2] = np.where(rng.uniform(size=800) < 0.9, r[:, 2] * 0.2, r[:, 2])
    assert pcells.adaptive_z_edges(r, box, (2, 2), 2.5, 40) == \
        jcells.adaptive_z_edges(r, box, (2, 2), 2.5, 40)


@pytest.mark.parametrize("kind", ["1clj", "2cljq", "charged"])
def test_compute_forces_cells_matches_jax_and_oracle(kind):
    jmol, jpp, pmol, ppp, box, _ = _scene(kind)
    js, ps = _specs(tuple(box), 32)
    ids, shift = jcells.neighbor_table(js)
    jb = jcells.bin_particles(jmol.r, jmol.valid, js)
    jf, jm = jax.jit(
        lambda mol, bins: jax_forces_cells(
            mol, jpp, js, bins, jnp.asarray(ids), jnp.asarray(shift), cell_chunk=9)
    )(jmol, jb)
    pb = pcells.bin_particles(pmol.r, pmol.valid, ps)
    _assert_bins_equal(pb, jb)
    pf, pm = compute_forces_cells(
        pmol, ppp, ps, pb, torch.as_tensor(ids), torch.as_tensor(shift),
        cell_chunk=10)
    of, om = compute_forces_n2(pmol, ppp, box, images=0)
    for name in ("F", "M", "Vi"):
        want = np.asarray(getattr(jf, name))
        scale = max(np.abs(want).max(), 1e-300)
        got = getattr(pf, name).numpy()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-11,
                                   err_msg=name)
        np.testing.assert_allclose(got / scale,
                                   getattr(of, name).numpy() / scale,
                                   atol=1e-11, err_msg=name + " vs oracle")
    for name in ("upot6lj", "upot_xpoles", "virial", "my_rf"):
        np.testing.assert_allclose(float(getattr(pm, name)),
                                   float(getattr(jm, name)), rtol=1e-11,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(float(getattr(pm, name)),
                                   float(getattr(om, name)), rtol=1e-11,
                                   atol=1e-11, err_msg=name + " vs oracle")


def test_compute_forces_cells_chunking_and_reserve_slots():
    """The lane-budget chunking does not change the sums, and invalid
    reserve slots feel and exert nothing."""
    _, _, pmol, ppp, box, _ = _scene("2cljq")
    spec = pcells.CellGridSpec.create(tuple(box), 2.5, cap=32)
    ids, shift = (torch.as_tensor(a) for a in pcells.neighbor_table(spec))
    bins = pcells.bin_particles(pmol.r, pmol.valid, spec)
    fa, ma = compute_forces_cells(pmol, ppp, spec, bins, ids, shift)
    fb, mb = compute_forces_cells(pmol, ppp, spec, bins, ids, shift, cell_chunk=4)
    np.testing.assert_allclose(fa.F.numpy(), fb.F.numpy(), atol=1e-12)
    np.testing.assert_allclose(float(ma.upot), float(mb.upot), rtol=1e-13)
    pmol.valid[100:] = False
    bins = pcells.bin_particles(pmol.r, pmol.valid, spec)
    fc, _ = compute_forces_cells(pmol, ppp, spec, bins, ids, shift)
    assert float(fc.F[100:].abs().max()) == 0.0
    assert float(fc.M[100:].abs().max()) == 0.0
