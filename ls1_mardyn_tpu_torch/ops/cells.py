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
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CellGridSpec:
    """Static grid geometry (hashable).

    Mirrors LinkedCells' cell geometry: cell edge >= cutoff
    (LinkedCells.h:101-131), one cell per cutoff.

    z_edges (optional, len nz+1, first 0 and last box[2]) makes the z
    rows NON-uniform -- the analogue of the ALL load balancer's tensor
    mesh.  Rows can never be thinner than the cutoff (the +-1
    neighbour-row reach must cover them), so dense regions keep the
    uniform pitch; the win is in SPARSE regions, where one wide row
    replaces many near-empty cutoff-pitch rows: the dense design's cost
    is cells x cap^2, so fewer cells at unchanged cap is a direct
    compute cut.  Paths using absolute coordinates (the general
    traversal) work unchanged; the cell-local 1CLJ paths require a
    uniform grid.
    """

    dims: Tuple[int, int, int]  # cells per axis
    box: Tuple[float, float, float]
    cap: int  # max molecules per cell
    z_edges: Optional[Tuple[float, ...]] = None

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def cell_len(self) -> Tuple[float, float, float]:
        """Cell edge per axis; for non-uniform z this is the MINIMUM
        row height (the quantity cutoff-eligibility checks need)."""
        uni = tuple(b / d for b, d in zip(self.box, self.dims))
        if self.z_edges is None:
            return uni
        e = np.asarray(self.z_edges)
        return (uni[0], uni[1], float(np.min(np.diff(e))))

    @staticmethod
    def create(box, cutoff: float, cap: int) -> "CellGridSpec":
        """One cell per cutoff: every traversal reaches +-1 cell only."""
        dims = tuple(max(1, int(np.floor(b / cutoff))) for b in box)
        return CellGridSpec(dims=dims, box=tuple(float(b) for b in box), cap=cap)


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
    """Result of rebinning: dense per-cell molecule index table.  Index
    tensors are int32 as in the JAX package; users convert to int64 at
    the gather."""

    slots: torch.Tensor  # [n_cells, cap] int32 molecule index, -1 = empty
    counts: torch.Tensor  # [n_cells] int32
    overflow: torch.Tensor  # bool scalar: True if any cell exceeded cap
    cell_of: torch.Tensor  # [N] int32 linear cell id per molecule
    slot_of: torch.Tensor  # [N] int32 flat slot (cell*cap+rank) per molecule


def wrap_positions(r: torch.Tensor, box) -> torch.Tensor:
    """Periodic wraparound into [0, L); the single-device analogue of
    DomainDecompBase::handleDomainLeavingParticles
    (DomainDecompBase.h:300-332)."""
    box = torch.as_tensor(box, dtype=r.dtype, device=r.device)
    return r - torch.floor(r / box) * box


def bin_particles(r: torch.Tensor, valid: torch.Tensor, spec: CellGridSpec) -> CellBins:
    """Rebin molecules into cells (sort-based; replaces
    LinkedCells::update)."""
    dev = r.device
    dims = torch.tensor(spec.dims, dtype=torch.int32, device=dev)
    uni = tuple(b / d for b, d in zip(spec.box, spec.dims))
    cell_len = torch.tensor(uni, dtype=r.dtype, device=dev)
    c3 = torch.clamp(torch.floor(r / cell_len).to(torch.int32), min=0)
    c3 = torch.minimum(c3, dims - 1)
    cz = c3[:, 2]
    if spec.z_edges is not None:
        # non-uniform z rows: row index by binary search over the
        # static edge table
        interior = torch.tensor(spec.z_edges[1:-1], dtype=r.dtype, device=dev)
        cz = torch.searchsorted(interior, r[:, 2].contiguous(), right=True)
        cz = torch.clamp(cz.to(torch.int32), 0, spec.dims[2] - 1)
    # z-major linear id (matches the kernels' [nz, ny, nx] rows)
    cell = (cz * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
    return bin_by_id(cell, valid, spec)


def bin_by_id(
    cell: torch.Tensor,
    valid: torch.Tensor,
    spec: CellGridSpec,
    need_inverse: bool = True,
) -> CellBins:
    """Rebin from precomputed linear cell ids (z-major: (cz*ny+cy)*nx+cx).

    Stable: inside a cell, molecules keep their input order
    (torch.argsort is stable only when asked), which is what makes the
    slot layout identical to the JAX package's.  Molecules beyond `cap`
    in a cell get no slot; `overflow` reports it.

    need_inverse=False skips the molecule->slot inverse map (a second
    full argsort) for callers that only consume the dense slot table
    (the RMM rebin)."""
    n = cell.shape[0]
    dev = cell.device
    i32 = torch.int32
    # invalid molecules go to a virtual overflow cell
    cell = torch.where(valid, cell.long(), spec.n_cells)
    order = torch.argsort(cell, stable=True)
    sorted_cell = cell[order]
    # per-cell [start, end) ranges via ONE binary search: for integer
    # keys, end(c) == start(c+1)
    cell_ids = torch.arange(spec.n_cells + 2, device=dev)
    starts_all = torch.searchsorted(sorted_cell, cell_ids, right=False)
    starts = starts_all[: spec.n_cells + 1]
    counts = starts_all[1:] - starts_all[:-1]  # [n_cells + 1]
    # dense slot table by gather: slots[c, k] = order[starts[c] + k]
    k = torch.arange(spec.cap, device=dev)[None, :]
    src = starts[: spec.n_cells, None] + k
    filled = k < counts[: spec.n_cells, None]
    slots = torch.where(filled, order[torch.clamp(src, 0, max(n - 1, 0))], -1)
    overflow = counts[: spec.n_cells].max() > spec.cap
    if need_inverse:
        # inverse map molecule -> flat slot, also gather-only
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=dev)  # sorted pos of mol m
        rank = inv - starts[cell]
        slot_of = cell * spec.cap + torch.clamp(rank, 0, spec.cap - 1)
        slot_of = torch.where(
            valid & (rank < spec.cap), slot_of, spec.n_cells * spec.cap
        )
    else:
        slot_of = torch.zeros((n,), dtype=i32, device=dev)
    return CellBins(
        slots=slots.to(i32),
        counts=counts[: spec.n_cells].to(i32),
        overflow=overflow,
        cell_of=cell.to(i32),
        slot_of=slot_of.to(i32),
    )


def neighbor_table(spec: CellGridSpec):
    """Precompute, for every cell, its 27 neighbor cell ids and the
    periodic position shift to apply to their contents.

    The analogue of LinkedCells' neighbor-offset precomputation
    (LinkedCells.h:302-305), with periodic wrap folded in instead of
    halo cells.  Returns numpy arrays (static data):
      nbr_ids   [n_cells, 27] int32
      nbr_shift [n_cells, 27, 3] float (multiples of box length)
    """
    nx, ny, nz = spec.dims
    bx, by, bz = spec.box
    cz, cy, cx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    coords = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], -1)  # [n_cells,3]
    offs = np.stack(
        np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"), -1
    ).reshape(-1, 3)  # [27,3]
    nc = coords[:, None, :] + offs[None, :, :]  # [n_cells,27,3]
    dims = np.array([nx, ny, nz])
    wrapped = np.mod(nc, dims)
    # a neighbor whose raw coordinate wrapped must have its contents
    # translated by a whole box length so distances come out right:
    # image position = p + floor(raw/dims) * L
    shift = np.floor_divide(nc, dims).astype(np.float64) * np.array([bx, by, bz])
    ids = (wrapped[..., 2] * ny + wrapped[..., 1]) * nx + wrapped[..., 0]
    # With dims <= 2 on an axis, distinct offsets reach the same cell
    # through different periodic images (different shifts); both are
    # genuine candidates and the cutoff mask selects the right ones.
    # Requires cutoff <= box/2 (as does the reference's cell setup).
    return ids.astype(np.int32), shift
