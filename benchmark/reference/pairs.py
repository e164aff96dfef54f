"""The molecule pairs whose centres of mass lie within the cutoff, each
unordered pair once, in blocks.

Cells of edge >= rc (at least 3 a side), molecules sorted by cell, and
for each cell its own pairs (a < b) and the pairs with the 13 cells of
its forward half shell.  A block is a run of cells whose candidate
pairs stay under `max_candidates`; its pairs come out exactly, with no
padding: (i, j, drm) with drm = r_i - r_j to the nearest periodic image
and |drm|^2 < rc^2 (strict, as in ls1-MarDyn's cell processor).
"""

from __future__ import annotations

import itertools

import torch

HALF_SHELL = [o for o in itertools.product((-1, 0, 1), repeat=3)
              if o > (0, 0, 0)]  # 13 forward offsets (dz, dy, dx) > 0


def minimum_image(d, box):
    return d - box * torch.round(d / box)


def cell_sort(r, box, rc):
    """(order, counts, starts, dims) of r [N,3] on the coarsest cubic
    cell grid of edge >= rc."""
    dims = [int(b // rc) for b in box.tolist()]
    if min(dims) < 3:
        raise ValueError(f"cell grid {dims}: the half shell needs 3 cells a side")
    d = torch.tensor(dims, device=r.device)
    c3 = torch.floor(torch.remainder(r, box) / (box / d)).long()
    c3 = torch.minimum(torch.clamp(c3, min=0), d - 1)
    cell = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
    order = torch.argsort(cell)
    counts = torch.bincount(cell, minlength=dims[0] * dims[1] * dims[2])
    starts = torch.cumsum(counts, 0) - counts
    return order, counts, starts, dims


def _neighbour(cells, dims, off):
    nx, ny, nz = dims
    x = cells % nx
    y = (cells // nx) % ny
    z = cells // (nx * ny)
    dz, dy, dx = off
    return (((z + dz) % nz) * ny + (y + dy) % ny) * nx + (x + dx) % nx


def _cell_pairs(cells, nbr, counts, starts, same):
    """Slot pairs (a, b) of the cells `cells` with the cells `nbr`, in
    sorted order; a < b where `same`."""
    ca, cb = counts[cells], counts[nbr]
    prod = ca * cb
    total = int(prod.sum())
    if total == 0:
        e = torch.empty(0, dtype=torch.long, device=cells.device)
        return e, e
    rep = torch.repeat_interleave(torch.arange(len(cells), device=cells.device), prod)
    k = torch.arange(total, device=cells.device) - (torch.cumsum(prod, 0) - prod)[rep]
    a = k // cb[rep]
    b = k - a * cb[rep]
    if same:
        keep = a < b
        a, b, rep = a[keep], b[keep], rep[keep]
    return starts[cells][rep] + a, starts[nbr][rep] + b


def pair_blocks(r, box, rc, max_candidates=1 << 25):
    """Yield (i, j, drm) blocks of the unordered pairs of r [N,3]
    (float64 or lower) in the periodic box [3] inside rc: i, j index r."""
    order, counts, starts, dims = cell_sort(r.double(), box.double(), rc)
    ncell = len(counts)
    mean = max(1.0, float((counts.double() ** 2).mean()))
    chunk = max(1, int(max_candidates // (14 * mean)))
    rc2 = rc * rc
    for c0 in range(0, ncell, chunk):
        cells = torch.arange(c0, min(ncell, c0 + chunk), device=r.device)
        for off in [(0, 0, 0)] + HALF_SHELL:
            nbr = cells if off == (0, 0, 0) else _neighbour(cells, dims, off)
            a, b = _cell_pairs(cells, nbr, counts, starts, off == (0, 0, 0))
            if len(a) == 0:
                continue
            i, j = order[a], order[b]
            drm = minimum_image(r[i] - r[j], box)
            inside = (drm * drm).sum(-1) < rc2
            if bool(inside.any()):
                yield i[inside], j[inside], drm[inside]


def brute_force_pairs(r, box, rc):
    """All unordered pairs inside rc by an O(N^2) sweep (tests)."""
    n = len(r)
    i, j = torch.triu_indices(n, n, 1, device=r.device)
    drm = minimum_image(r[i] - r[j], box)
    inside = (drm * drm).sum(-1) < rc * rc
    return i[inside], j[inside], drm[inside]
