"""Cell-grid particle container (the counterpart of
ls1_mardyn_tpu/ops/cells.py).

Molecules live in flat fixed-capacity arrays; a dense [n_cells, cap]
slot table is rebuilt by a stable sort ("rebinning" == the reference's
LinkedCells::update, LinkedCells.h:150-153).  The sort runs as plain
torch (argsort + searchsorted): the JAX package computes it in XLA, not
in a Pallas kernel.  No halo cells on one device: periodicity is exact
integer cell arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CellGridSpec:
    """Static uniform grid geometry (hashable): cell edge = box / dims.

    Mirrors LinkedCells' cell geometry (LinkedCells.h:101-131).  The
    JAX package's non-uniform z rows (z_edges) serve only the general
    engine and come with ROADMAP slice 2; the cell-local 1CLJ path needs
    a uniform grid.
    """

    dims: Tuple[int, int, int]  # cells per axis
    box: Tuple[float, float, float]
    cap: int  # max molecules per cell

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def cell_len(self) -> Tuple[float, float, float]:
        return tuple(b / d for b, d in zip(self.box, self.dims))


def adaptive_z_edges(r, box, dims_xy, min_h: float, occ_limit: int):
    """Density-adaptive z rows (the ALL 'tensor mesh' one-axis
    balancing): greedily widen each row until some (x, y) CELL inside
    it would exceed `occ_limit` molecules (so dense regions keep
    ~min_h pitch, like the uniform grid, and the capacity never grows),
    never thinner than min_h.  Sparse regions collapse into few wide
    rows, shrinking the total cell count at unchanged capacity.

    r [N,3] positions; box (3,); dims_xy = (nx, ny) of the uniform
    grid's xy cells.  Returns a tuple of nz+1 edges (0 ... bz), or None
    when fewer than two rows fit."""
    r = np.asarray(r, float)
    box = np.asarray(box, float)
    bz = float(box[2])
    if bz < 2 * min_h or len(r) == 0:
        return None
    nx, ny = int(dims_xy[0]), int(dims_xy[1])
    cxy = np.clip(
        (r[:, :2] / (box[:2] / [nx, ny])).astype(int), 0, [nx - 1, ny - 1]
    )
    colid = cxy[:, 1] * nx + cxy[:, 0]
    # per-column sorted z lists (padded 2-D table + pointers)
    order = np.lexsort((r[:, 2], colid))
    col_s = colid[order]
    z_s = r[order, 2]
    ncol = nx * ny
    starts = np.searchsorted(col_s, np.arange(ncol + 1))
    counts = np.diff(starts)
    limit = max(int(occ_limit), 1)

    edges = [0.0]
    ptr = starts[:-1].copy()  # per-column index of first z above the edge
    while bz - edges[-1] >= 2 * min_h:
        # for each column, the z of its (limit+1)-th molecule above the
        # current edge: the cut must stay below the smallest of these
        idx = ptr + limit
        has = idx < starts[1:]  # column still has > limit molecules left
        if not has.any():
            break  # every column fits one wide final row
        nxt = np.min(z_s[idx[has]])
        cut = max(edges[-1] + min_h, float(nxt) - 1e-9)
        cut = min(cut, bz - min_h)
        if cut <= edges[-1] + 1e-12:
            break
        edges.append(float(cut))
        # advance pointers past the cut
        for c in np.nonzero(counts)[0]:
            ptr[c] = starts[c] + np.searchsorted(
                z_s[starts[c]:starts[c + 1]], cut
            )
    edges.append(float(bz))
    if len(edges) < 3:
        return None
    return tuple(edges)


@dataclasses.dataclass
class CellBins:
    """Result of rebinning: dense per-cell molecule index table."""

    slots: torch.Tensor  # [n_cells, cap] int64 molecule index, -1 = empty
    overflow: torch.Tensor  # bool scalar: True if any cell exceeded cap


def wrap_positions(r: torch.Tensor, box) -> torch.Tensor:
    """Periodic wraparound into [0, L); the single-device analogue of
    DomainDecompBase::handleDomainLeavingParticles
    (DomainDecompBase.h:300-332)."""
    box = torch.as_tensor(box, dtype=r.dtype, device=r.device)
    return r - torch.floor(r / box) * box


def bin_by_id(cell: torch.Tensor, valid: torch.Tensor, spec: CellGridSpec) -> CellBins:
    """Rebin from precomputed linear cell ids (z-major: (cz*ny+cy)*nx+cx).

    Stable: inside a cell, molecules keep their input order, which is
    what makes the slot layout identical to the JAX package's.
    Molecules beyond `cap` in a cell get no slot; `overflow` reports
    it."""
    n = cell.shape[0]
    dev = cell.device
    cell = torch.where(valid, cell.long(), torch.full_like(cell.long(), spec.n_cells))
    order = torch.argsort(cell, stable=True)
    sorted_cell = cell[order]
    cell_ids = torch.arange(spec.n_cells + 2, device=dev)
    starts_all = torch.searchsorted(sorted_cell, cell_ids, right=False)
    starts = starts_all[: spec.n_cells + 1]
    counts = starts_all[1:] - starts_all[:-1]
    k = torch.arange(spec.cap, device=dev)[None, :]
    src = starts[: spec.n_cells, None] + k
    filled = k < counts[: spec.n_cells, None]
    slots = torch.where(filled, order[torch.clamp(src, 0, max(n - 1, 0))], -1)
    overflow = counts[: spec.n_cells].max() > spec.cap
    return CellBins(slots=slots, overflow=overflow)
