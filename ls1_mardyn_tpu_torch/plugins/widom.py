"""Widom test-particle insertion: excess chemical potential sampling
(the counterpart of ls1_mardyn_tpu/plugins/widom.py).

The reference samples Widom insertions through ChemicalPotential's
_widom mode (src/ensemble/ChemicalPotential.cpp:281, 329: trial
insertions that are never accepted) with per-bin accumulators
Sum exp(-dU/T) and instance counts (Domain.cpp:820-827).  Here it is a
plugin with the same statistics:

- every `samplefrequency` steps, `insertions` virtual test molecules at
  uniform positions and orientations inside an optional restricted
  control volume (`cv`); all probes of a sample are one batched probe
  on the state's device: through a cell table's 27 cells from
  GrandCanonicalEnsemble.CELL_PROBE_MIN_N molecules on, else the O(N)
  rows in chunks (grand_canonical.probe_energies);
- accumulators: n, Sum exp(-dU/T), and per-write-block partial sums,
  from which the .widom file reports the block mu, the running mu and
  the standard error of mu across completed blocks;
- mu_ex = -T ln <exp(-dU/T)>  (Widom 1963).

The draws (draws(): uniforms [n, 3] for the positions, normals [n, 4]
for the quaternions) come from a torch.Generator on the run's device
seeded by `seed` (4711, as the JAX package's key).  A sample reads the
energies back once.
"""

from __future__ import annotations

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ensemble.grand_canonical import (
    GrandCanonicalEnsemble,
    cell_probe_geometry,
    probe_energies,
    probe_reach,
    probe_table,
)
from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory


@PluginFactory.register("WidomInsertion")
class WidomInsertion(PluginBase):
    def __init__(self, params=None):
        super().__init__(params)
        self.component = int(float(self.params.get("cid", 1))) - 1
        self.insertions = int(float(self.params.get("insertions", 16)))
        self.sampling_frequency = int(
            float(self.params.get("samplefrequency", 10))
        )
        self.temperature = float(self.params.get("temperature", 0.0))
        # restricted control volume (ChemicalPotential setControlVolume)
        cv = self.params.get("cv", {})
        self._cv = None
        if isinstance(cv, dict) and cv:
            self._cv = tuple(
                float(cv.get(k, d))
                for k, d in (("x0", 0.0), ("y0", 0.0), ("z0", 0.0),
                             ("x1", -1.0), ("y1", -1.0), ("z1", -1.0))
            )

    def init(self, sim):
        self.generator = torch.Generator(device=sim.device)
        self.generator.manual_seed(int(float(self.params.get("seed", 4711))))
        # global accumulators + per-block partials
        self._acc = 0.0
        self._n = 0
        self._blk_acc = 0.0
        self._blk_n = 0
        self._block_means = []  # <exp(-dU/T)> of each completed block
        self._consts = None
        self._geom = None
        self._path = f"{self.output_prefix}.widom"
        self._f = open(self._path, "w")
        self._f.write(
            "#step\tsamples\tmu_block\tmu_running\tstderr_mu\n"
        )

    def draws(self, n, dtype, device):
        """Uniforms [n, 3] (positions) and normals [n, 4] (quaternions)."""
        kw = dict(generator=self.generator, dtype=dtype, device=device)
        return torch.rand((n, 3), **kw), torch.randn((n, 4), **kw)

    def _bounds(self, sim):
        box = np.asarray(sim.box, np.float64)
        if self._cv is None:
            return np.zeros(3), box
        x0, y0, z0, x1, y1, z1 = self._cv
        lo = np.array([x0, y0, z0])
        hi = np.array([
            x1 if x1 > 0 else box[0],
            y1 if y1 > 0 else box[1],
            z1 if z1 > 0 else box[2],
        ])
        return lo, hi

    def _constants(self, sim, mol):
        """(box, lo, hi - lo, cid) on the device, sent once."""
        if self._consts is None:
            dtype, dev = mol.r.dtype, mol.r.device
            lo, hi = self._bounds(sim)
            self._consts = tuple(
                torch.as_tensor(x, dtype=dtype, device=dev)
                for x in (np.asarray(sim.box, float), lo, hi - lo)) + (
                torch.tensor(self.component, dtype=torch.int32, device=dev),)
        return self._consts

    def _energies(self, sim, mol, r, q):
        """dU of the test molecules r [n, 3], q [n, 4]."""
        box, _lo, _span, cid = self._constants(sim, mol)
        if self._geom is None:
            self._geom = cell_probe_geometry(
                mol.capacity, float(np.prod(sim.box)), sim.box, probe_reach(sim.pp),
                GrandCanonicalEnsemble.CELL_PROBE_MIN_N) or ()
        if not self._geom:
            return probe_energies(mol, sim.pp, box, r, q, cid)
        slots, self._geom, _ = probe_table(mol, sim.box, self._geom)
        return probe_energies(mol, sim.pp, box, r, q, cid, table=slots,
                              dims=self._geom[0])

    def end_step(self, sim, step):
        if step % self.sampling_frequency:
            return
        mol = sim.engine.mol
        T = self.temperature or sim.config.temperature
        u, z = self.draws(self.insertions, mol.r.dtype, mol.r.device)
        _box, lo, span, _cid = self._constants(sim, mol)
        r = lo + u * span
        q = z / torch.sqrt((z * z).sum(1, keepdim=True))
        du = self._energies(sim, mol, r, q).cpu().numpy().astype(np.float64)
        w = np.exp(-du / T)
        self._acc += float(np.sum(w))
        self._n += len(w)
        self._blk_acc += float(np.sum(w))
        self._blk_n += len(w)
        if step % self.write_frequency == 0 and self._n:
            blk_mean = (
                self._blk_acc / self._blk_n if self._blk_n else np.nan
            )
            if self._blk_n:
                self._block_means.append(blk_mean)
            self._blk_acc, self._blk_n = 0.0, 0
            mu_blk = -T * np.log(max(blk_mean, 1e-300))
            mu_run = -T * np.log(max(self._acc / self._n, 1e-300))
            # standard error of mu across completed blocks, propagated
            # through the log: sigma_mu ~= T * sigma_<w> / <w>
            if len(self._block_means) >= 2:
                bm = np.asarray(self._block_means)
                sem_w = bm.std(ddof=1) / np.sqrt(len(bm))
                err = T * sem_w / max(bm.mean(), 1e-300)
            else:
                err = np.nan
            if self._f.closed:  # a later run() of the same driver
                self._f = open(self._path, "a")
            self._f.write(
                f"{step}\t{self._n}\t{mu_blk:.10e}\t{mu_run:.10e}\t"
                f"{err:.4e}\n"
            )
            self._f.flush()

    def finish(self, sim):
        self._f.close()

    @property
    def mu_excess(self):
        T = self.temperature
        if not self._n:
            return float("nan")
        return -T * np.log(max(self._acc / self._n, 1e-300))

    @property
    def stderr_mu(self):
        if len(self._block_means) < 2:
            return float("nan")
        bm = np.asarray(self._block_means)
        T = self.temperature
        return float(
            T * bm.std(ddof=1) / np.sqrt(len(bm))
            / max(bm.mean(), 1e-300)
        )
