"""Cavity sampling ensemble and the CavityWriter plugin (the
counterpart of ls1_mardyn_tpu/ensemble/cavity.py).

The reference's CavityEnsemble + CavityWriter
(src/ensemble/CavityEnsemble.{h,cpp}, src/io/CavityWriter.h): a static
Nx x Ny x Nz grid of probe positions; a probe is an active cavity when
at most `max_neighbours` molecules sit within `radius` of it
(countNeighbours + decideActivity, CavityEnsemble.cpp:313-330).

The counts are exact integers, the JAX package's: the distance of each
probe-molecule pair is formed as there (dr - round(dr / box) * box).
Where the periodic box holds >= 3 cells of edge >= radius on every
axis, each probe reads only its 27 cells of a cell table of the state
(a table whose cells overflow is rebuilt with twice the capacity);
otherwise the [probes, N] distance rows run in chunks sized by the
probes' byte budget (grand_canonical.PASS_BYTES), where the JAX package's one [n_probe, N, 3]
expression would hold ~50 GB at 1,000 probes and N = 4.2e6.
"""

from __future__ import annotations

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ensemble.grand_canonical import (
    _neighbour_slots,
    cell_probe_geometry,
    pass_rows,
    probe_table,
)
from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory


def _pair_counts(probe_r, r, valid, box, r2):
    """Per probe, the valid molecules of r [..., M, 3] within r2:
    probe_r [P, 3] against r [M, 3] (shared) or [P, M, 3]."""
    dr = probe_r[:, None, :] - r
    dr = dr - torch.round(dr / box) * box
    d2 = (dr * dr).sum(-1)
    return (valid & (d2 < r2)).sum(1)


def count_neighbours(probe_r, mol, wrap_box, radius):
    """Neighbour counts [n_probe] (int64) of the probe positions (a
    tensor on the state's device) within `radius`, minimum image in
    `wrap_box`."""
    dev, dtype = mol.r.device, mol.r.dtype
    box = torch.as_tensor(np.asarray(wrap_box, float), dtype=dtype, device=dev)
    r2 = float(radius) ** 2
    geom = cell_probe_geometry(mol.capacity, float(np.prod(wrap_box)), wrap_box,
                               float(radius))
    if geom is not None:
        slots, (dims, _), _ = probe_table(mol, wrap_box, geom)
        cand = _neighbour_slots(slots, dims, box, probe_r)  # [P, 27 cap]
        safe = torch.clamp(cand, 0, mol.capacity - 1).long()
        return _pair_counts(probe_r, mol.r[safe], (cand >= 0) & mol.valid[safe],
                            box, r2)
    step = pass_rows(mol.capacity * 3 * 3 * mol.r.element_size())
    return torch.cat([
        _pair_counts(probe_r[a:a + step], mol.r, mol.valid, box, r2)
        for a in range(0, probe_r.shape[0], step)])


class CavityEnsemble:
    """Probe grid + activity decision (CavityEnsemble.cpp)."""

    def __init__(self, box, grid=(10, 10, 10), radius=1.0, max_neighbours=0,
                 wrap_box=None):
        """box: extent the probe grid spans (the control volume).
        wrap_box: the periodic domain box for minimum-image distances;
        defaults to box and must be the full domain when the probe grid
        is restricted to a sub-volume."""
        self.box = np.asarray(box, float)
        self.wrap_box = (
            self.box if wrap_box is None else np.asarray(wrap_box, float)
        )
        self.grid = tuple(int(g) for g in grid)
        self.radius = float(radius)
        self.max_neighbours = int(max_neighbours)
        nx, ny, nz = self.grid
        ix, iy, iz = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        frac = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], -1) + 0.5
        self.probe_r = frac / np.array(self.grid) * self.box
        self._probe_dev = None

    def cavity_step(self, mol):
        """(active mask [n_probe] bool, neighbour counts), numpy."""
        key = (mol.r.device, mol.r.dtype)
        if (self._probe_dev is None or self._probe_dev[0] is not self.probe_r
                or self._probe_dev[1] != key):
            # sent once for a probe grid (the writer shifts it in init)
            self._probe_dev = (self.probe_r, key, torch.as_tensor(
                self.probe_r, dtype=mol.r.dtype, device=mol.r.device))
        counts = count_neighbours(self._probe_dev[2], mol, self.wrap_box,
                                  self.radius).cpu().numpy()
        return counts <= self.max_neighbours, counts

    def num_cavities(self, mol) -> int:
        active, _ = self.cavity_step(mol)
        return int(active.sum())


# per-component element letter in the cavity .xyz output
# (CavityWriter.cpp:223-227)
_CAV_ELEMENT = {0: "C", 1: "N", 2: "O", 3: "F"}


@PluginFactory.register("CavityWriter")
class CavityWriter(PluginBase):
    """Writes active cavity positions per frame (CavityWriter.h:13-40):
    xyz-like output of probe points classified as cavities.

    Reference refinements (CavityWriter.cpp:48-130, 176-229): the probe
    grid spans the configured ControlVolume instead of the whole domain;
    per-component ensembles (repeated <componentid> entries) get one
    file each, <prefix>-c<cid>-<zero-padded frame>.cav.xyz, with the
    component's element letter (C/N/O/F/Ne).  The state is read at the
    write frequency only (the counts)."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.grid = (
            int(float(p.get("Nx", 10))),
            int(float(p.get("Ny", 10))),
            int(float(p.get("Nz", 10))),
        )
        self.radius = float(p.get("radius", 1.0))
        self.max_neighbours = int(float(p.get("maxNeighbours", 0)))
        cv = p.get("ControlVolume", {})
        self.control_volume = cv if isinstance(cv, dict) else {}
        cids = p.get("componentid", [0])
        if not isinstance(cids, list):
            cids = [cids]
        self.cids = [int(float(c)) for c in cids]

    def init(self, sim):
        box = np.asarray(sim.box, float)
        cv = self.control_volume
        lo = np.array([float(cv.get(k, 0.0)) for k in ("x0", "y0", "z0")])
        hi = np.array([
            float(cv.get(k, d))
            for k, d in (("x1", box[0]), ("y1", box[1]), ("z1", box[2]))
        ])
        if (lo > hi).any() or (lo < 0).any() or (hi > box).any():
            raise ValueError(
                f"CavityWriter: bad ControlVolume {lo} .. {hi}"
            )
        self.ensembles = {}
        for cid in self.cids:
            # the probe grid spans the control volume; the minimum image
            # stays on the full domain box
            ens = CavityEnsemble(
                hi - lo,
                grid=self.grid,
                radius=self.radius,
                max_neighbours=self.max_neighbours,
                wrap_box=box,
            )
            ens.probe_r = ens.probe_r + lo
            self.ensembles[cid] = ens
        self._frame = 0

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        self._frame += 1
        mol = sim.molecules()
        for cid, ens in self.ensembles.items():
            active, _counts = ens.cavity_step(mol)
            pos = ens.probe_r[active]
            elem = _CAV_ELEMENT.get(cid, "Ne")
            name = (f"{self.output_prefix}-c{cid}-"
                    f"{self._frame:04d}.cav.xyz")
            with open(name, "w") as f:
                f.write(f"{len(pos)}\n")
                f.write(
                    f"cavities step {step} component {cid} (radius "
                    f"{self.radius}, maxNeighbours "
                    f"{self.max_neighbours})\n"
                )
                for p_ in pos:
                    f.write(
                        f"{elem} {p_[0]:.6g}\t{p_[1]:.6g}\t{p_[2]:.6g}\n"
                    )
