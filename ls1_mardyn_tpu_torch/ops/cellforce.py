"""Cell-list force computation, the general multi-site traversal (the
counterpart of ls1_mardyn_tpu/ops/cellforce.py).

The correctness-first replacement for the reference's traversal +
vectorized kernel stack (LinkedCells::traverseCells ->
C08CellPairTraversal -> VectorizedCellProcessor::_calculatePairs,
src/particleContainer/LinkedCells.cpp:564-575,
adapter/VectorizedCellProcessor.cpp:797):

  - no colored traversal: each cell writes only its own molecules
  - no Newton-3rd-law halving: each ordered pair is evaluated from both
    sides
  - periodic images via neighbor-table shifts instead of halo cells

This is plain tensor code, no kernel: the shape-flexible path for rigid
multi-site molecules, and the golden reference for the cell kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ls1_mardyn_tpu_torch.models.interaction import (
    PairParams,
    add_pairs,
    pair_sums,
    pair_sums_result,
    site_offsets,
)
from ls1_mardyn_tpu_torch.ops.cells import CellBins, CellGridSpec
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState

# candidate lanes (cells x cap x 27 cap) per chunk of cells when the
# caller gives no cell_chunk: bounds the dense distance temporaries
_LANES = 1 << 23


def default_cell_chunk(spec: CellGridSpec) -> int:
    """Cells per pass under the lane budget."""
    return max(1, min(spec.n_cells, _LANES // (27 * spec.cap * spec.cap)))


def compute_forces_cells(
    mol: MoleculeState,
    pp: PairParams,
    spec: CellGridSpec,
    bins: CellBins,
    nbr_ids: torch.Tensor,  # [n_cells, 27]
    nbr_shift: torch.Tensor,  # [n_cells, 27, 3]
    cell_chunk: int = 0,
    screen_alpha: float = 0.0,
) -> Tuple[Forces, Macroscopic]:
    """Forces, torques, virials and energies of all pairs within the
    cutoffs, found through the cell table.  Cells are walked in chunks
    (the JAX package's lax.map over vmapped cells): per chunk the
    candidate distances of every slot against the 27 neighbour cells'
    slots are formed densely, [chunk, cap, 27*cap], and the pair
    function runs on the pairs inside a cutoff."""
    n = mol.capacity
    cap = spec.cap
    dtype, dev = mol.r.dtype, mol.r.device
    sites_all = site_offsets(pp, mol.q, mol.cid)
    cid = mol.cid.long()
    slots = bins.slots.long()
    nbr_ids = nbr_ids.long()
    nbr_shift = nbr_shift.to(dtype)
    acc = pair_sums(n, dtype, dev)
    n_cells = spec.n_cells
    chunk = cell_chunk if cell_chunk else default_cell_chunk(spec)
    for c0 in range(0, n_cells, chunk):
        c1 = min(n_cells, c0 + chunk)
        i_idx = slots[c0:c1]  # [C, cap]
        j_idx = slots[nbr_ids[c0:c1]].reshape(c1 - c0, 27 * cap)
        j_shift = nbr_shift[c0:c1].repeat_interleave(cap, dim=1)  # [C,27cap,3]
        i_safe = torch.clamp(i_idx, 0, n - 1)
        j_safe = torch.clamp(j_idx, 0, n - 1)
        i_ok = (i_idx >= 0) & mol.valid[i_safe]
        j_ok = (j_idx >= 0) & mol.valid[j_safe]
        rj = mol.r[j_safe] + j_shift
        drm = mol.r[i_safe][:, :, None, :] - rj[:, None, :, :]  # [C,cap,27cap,3]
        com2 = (drm * drm).sum(-1)
        # exclude self pairs (same molecule, any image): valid because
        # the grid guarantees cutoff <= box/2, so a molecule's periodic
        # image is never inside the cutoff
        pair_ok = (
            i_ok[:, :, None] & j_ok[:, None, :]
            & (i_safe[:, :, None] != j_safe[:, None, :])
        )
        mask_lj = pair_ok & (com2 < pp.rc2_lj)
        mask_el = pair_ok & (com2 < pp.rc2)
        sel = (mask_lj | mask_el).nonzero(as_tuple=True)
        add_pairs(acc, sites_all, cid, pp, i_safe[sel[0], sel[1]],
                  j_safe[sel[0], sel[2]], drm[sel], mask_lj[sel], mask_el[sel],
                  screen_alpha)
    return pair_sums_result(acc)
