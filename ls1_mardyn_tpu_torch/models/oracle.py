"""N^2 scalar-path force oracle (the counterpart of
ls1_mardyn_tpu/models/oracle.py).

The golden numerics reference for all fast force paths, playing the
role of the reference's LegacyCellProcessor + potforce.h
(src/particleContainer/adapter/LegacyCellProcessor.cpp) in the test
strategy, and the driver's force path for small scenes with huge
cutoffs.

Computes all ordered pairs with minimum-image periodic boundary
conditions (valid while cutoff <= box/2), or the 27-image sum.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import (
    PairParams,
    add_pairs,
    pair_sums,
    pair_sums_result,
    site_offsets,
)
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState

# pair lanes (rows x N x images) per chunk when the caller gives none
_LANES = 1 << 20


def min_image(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image convention for a periodic box (round half to even,
    as the JAX package's jnp.round)."""
    return dr - box * torch.round(dr / box)


def auto_images(pp: PairParams, box) -> int:
    """1 (minimum image) when both cutoffs are <= box/2, else 27."""
    rc = math.sqrt(float(pp.rc2))
    rc_lj = math.sqrt(float(pp.rc2_lj))
    return 1 if max(rc, rc_lj) <= min(float(b) for b in box) / 2 else 27


def compute_forces_n2(
    mol: MoleculeState,
    pp: PairParams,
    box,
    chunk: int = 0,
    images: int = 1,
    screen_alpha: float = 0.0,
) -> Tuple[Forces, Macroscopic]:
    """All-pairs forces/torques/virials and global energies.

    Args:
      mol: molecule state (capacity N; invalid slots masked out).
      pp: pair parameters.
      box: [3] box lengths.
      chunk: i-molecules per pass (bounds the N^2 pair arrays); 0 picks
        a chunk from a lane budget.
      images: 1 => minimum-image convention (valid for cutoff <= box/2);
        27 => sum over all first-shell periodic images per pair, matching
        the reference's halo-copy semantics when cutoff > box/2.
        0 => chosen from the cutoffs.  Self-interaction with one's own
        image is excluded either way (requires cutoff < box).
    """
    n = mol.capacity
    dtype, dev = mol.r.dtype, mol.r.device
    if not torch.is_tensor(box):
        box = np.array(box, dtype=np.float64)
    box_t = torch.as_tensor(box, dtype=dtype, device=dev)
    if images == 0:
        images = auto_images(pp, box_t.tolist())
    if images == 1:
        shifts = None
    elif images == 27:
        offs = list(itertools.product((-1.0, 0.0, 1.0), repeat=3))
        shifts = torch.tensor(offs, dtype=dtype, device=dev) * box_t
    else:
        raise ValueError("images must be 0, 1 or 27")
    if not chunk:
        chunk = max(1, _LANES // max(1, n * images))

    sites_all = site_offsets(pp, mol.q, mol.cid)
    cid = mol.cid.long()
    acc = pair_sums(n, dtype, dev)
    ids = torch.arange(n, device=dev)
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        dr0 = mol.r[i0:i1, None, :] - mol.r[None, :, :]  # [c,N,3]
        if shifts is None:
            drm = min_image(dr0, box_t)[:, :, None, :]  # [c,N,1,3]
        else:
            drm = dr0[:, :, None, :] + shifts  # [c,N,27,3]
        com2 = (drm * drm).sum(-1)
        valid_pair = (
            mol.valid[i0:i1, None] & mol.valid[None, :]
            & (ids[i0:i1, None] != ids[None, :])
        )[:, :, None]
        mask_lj = valid_pair & (com2 < pp.rc2_lj)
        mask_el = valid_pair & (com2 < pp.rc2)
        # the pair function runs on the pairs inside a cutoff only
        sel = (mask_lj | mask_el).nonzero(as_tuple=True)
        add_pairs(acc, sites_all, cid, pp, sel[0] + i0, sel[1], drm[sel],
                  mask_lj[sel], mask_el[sel], screen_alpha)
    return pair_sums_result(acc)
