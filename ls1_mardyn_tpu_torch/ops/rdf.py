"""Pair-distance histograms and pair counts over the cell neighbour
table (the counterpart of ls1_mardyn_tpu/ops/rdf.py).

The role of the reference's RDF plugin + RDFCellProcessor
(src/io/RDF.{h,cpp} + adapter/RDFCellProcessor): a binned histogram of
molecule-molecule (COM) distances, normalised against the ideal-gas
shell count; and the measuring half of FlopCounter
(adapter/FlopCounter.h:60), which counts the pairs inside each cutoff.

Each cell's molecules are held against its 27 neighbour cells
(ops/cells.neighbor_table) in chunks of cells, in plain torch: the JAX
package computes these in XLA (one-hot matmuls), not in a Pallas
kernel.  Here the histogram and the counts are ``bincount``s of the
pairs a chunk keeps, so every count is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from ls1_mardyn_tpu_torch.state import MoleculeState


def _cell_pairs(r, valid, spec, nbr_ids, nbr_shift, chunk):
    """Yield, per chunk of cells, (i index [C,cap,1], j index [C,1,27cap],
    ok [C,cap,27cap], r^2 [C,cap,27cap]) over the cell neighbourhoods:
    ok marks real pairs of two valid molecules that are not one
    molecule.  r^2 is summed x, y, z in that order, as the JAX
    package's reduction over the last axis."""
    n = r.shape[0]
    cap = spec.cap
    dev = r.device
    bins = bin_particles(r, valid, spec)
    slots = bins.slots.long()
    ids = torch.as_tensor(np.asarray(nbr_ids), dtype=torch.long, device=dev)
    shift = torch.as_tensor(np.asarray(nbr_shift), dtype=r.dtype, device=dev)
    for c0 in range(0, spec.n_cells, chunk):
        c1 = min(c0 + chunk, spec.n_cells)
        i_idx = slots[c0:c1]  # [C, cap]
        j_idx = slots[ids[c0:c1]].reshape(c1 - c0, -1)  # [C, 27cap]
        j_shift = shift[c0:c1].repeat_interleave(cap, dim=1)  # [C,27cap,3]
        si = i_idx.clamp(0, max(n - 1, 0))
        sj = j_idx.clamp(0, max(n - 1, 0))
        oki = (i_idx >= 0) & valid[si]
        okj = (j_idx >= 0) & valid[sj]
        rj = r[sj] + j_shift
        d = r[si][:, :, None, :] - rj[:, None, :, :]
        dr2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        ok = (oki[:, :, None] & okj[:, None, :]
              & (si[:, :, None] != sj[:, None, :]))
        yield si[:, :, None], sj[:, None, :], ok, dr2, bins.overflow


def pair_distance_histogram(
    mol: MoleculeState,
    spec: CellGridSpec,
    nbr_ids,
    nbr_shift,
    rmax: float,
    nbins: int,
    chunk: int = 32,
) -> torch.Tensor:
    """Histogram of pair COM distances < rmax over cell neighbourhoods.
    Returns [nbins] counts of unordered pairs in the state's dtype."""
    dr_bin = rmax / nbins
    h = torch.zeros(nbins, dtype=torch.long, device=mol.r.device)
    for _si, _sj, ok, dr2, _ovf in _cell_pairs(
            mol.r, mol.valid, spec, nbr_ids, nbr_shift, chunk):
        dist = torch.sqrt(dr2)
        keep = ok & (dist < rmax)
        b = (dist[keep] / dr_bin).to(torch.int32).clamp(0, nbins - 1)
        h += torch.bincount(b, minlength=nbins)
    return 0.5 * h.to(mol.r.dtype)  # unordered pairs


def pair_count_by_component(
    r: torch.Tensor,
    valid: torch.Tensor,
    cid: torch.Tensor,
    spec: CellGridSpec,
    nbr_ids,
    nbr_shift,
    rc2_lj,
    rc2_c,
    ncomp: int,
    chunk: int = 32,
):
    """Exact unordered pair counts per component pair, within the LJ and
    the electrostatic cutoff separately: two [ncomp, ncomp] tensors in
    r's dtype, and the binning's overflow flag (a bool tensor; where it
    is set, molecules beyond the cap were not counted)."""
    K = ncomp
    dev = r.device
    cidc = cid.long().clamp(0, K - 1)
    lj = torch.zeros(K * K, dtype=torch.long, device=dev)
    cc = torch.zeros(K * K, dtype=torch.long, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for si, sj, ok, dr2, ovf in _cell_pairs(
            r, valid, spec, nbr_ids, nbr_shift, chunk):
        kl = (cidc[si] * K + cidc[sj]).expand_as(ok)
        lj += torch.bincount(kl[ok & (dr2 < rc2_lj)], minlength=K * K)
        cc += torch.bincount(kl[ok & (dr2 < rc2_c)], minlength=K * K)
    half = 0.5 * torch.ones((), dtype=r.dtype, device=dev)
    return (half * lj.view(K, K).to(r.dtype), half * cc.view(K, K).to(r.dtype),
            ovf)


def normalize_rdf(hist: np.ndarray, n: int, volume: float, rmax: float, samples: int):
    """g(r) normalisation against the ideal-gas shell
    (RDF.cpp accumulation/normalisation)."""
    nbins = len(hist)
    dr = rmax / nbins
    edges = np.arange(nbins + 1) * dr
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rho = n / volume
    ideal = 0.5 * n * rho * shell * samples
    r_mid = 0.5 * (edges[1:] + edges[:-1])
    g = np.where(ideal > 0, hist / np.maximum(ideal, 1e-300), 0.0)
    return r_mid, g
