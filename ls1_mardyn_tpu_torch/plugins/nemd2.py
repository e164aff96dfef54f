"""NEMD control plugins, part 2: interface tracking and drift control
(the counterpart of ls1_mardyn_tpu/plugins/nemd2.py; the reference's
src/plugins/NEMD/):
  - DistControl.{h,cpp}: track vapour-liquid interface positions from a
    y density profile ('density' midpoint or 'denderiv' max-slope
    method), log them, and notify observer plugins
  - DriftCtrl.{h,cpp}: relax the per-bin mean velocity of a component
    toward a target drift inside a y range
  - PosNegComp.{h,cpp}: reassign the component id by the sign of v_y
  - ExtractPhase.{h,cpp}: delete molecules outside the liquid film

The state stays on the device: DistControl histograms y there (the
bins of numpy.histogram, edges made once on the host) and reads the
nbins counts at its update frequency; the others are tensor operations
with no read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory


def _replace_mol(sim, **kw):
    sim.engine.mol = dataclasses.replace(sim.engine.mol, **kw)


def histogram(y, keep, edges):
    """Counts [nbins] (int64, on y's device) of y where keep, in the bins
    of numpy.histogram(y, bins=edges): edges[i] <= y < edges[i+1], the
    last bin closed; edges is a device f64 tensor (numpy's linspace)."""
    yd = y.to(torch.float64).contiguous()
    keep = keep & (yd >= edges[0]) & (yd <= edges[-1])
    idx = torch.bucketize(yd, edges[1:-1], right=True)
    out = torch.zeros(edges.shape[0] - 1, dtype=torch.int64, device=y.device)
    return out.index_add_(0, idx, keep.to(torch.int64))


@PluginFactory.register("DistControl")
class DistControl(PluginBase):
    """Interface-position tracker (DistControl.h 'density' and
    'denderiv' methods).  Exposes .left/.right in box units and calls
    registered observers with (left, right) on every update."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        ctl = p.get("control", {}) if isinstance(p.get("control"), dict) else {}
        self.update_freq = int(float(ctl.get("update", p.get("update", 5000))))
        sub = p.get("subdivision", {}) if isinstance(p.get("subdivision"), dict) else {}
        self.nbins = int(float(sub.get("number", 100)))
        meth = p.get("method", {})
        self.method = (
            meth.get("type", "density") if isinstance(meth, dict) else "density"
        )
        self.left = 0.0
        self.right = 0.0
        self._observers = []
        self._log = []
        self._edges = None
        self.reads = 0  # device reads so far (one an update)

    def register_observer(self, fn):
        """fn(left, right) -- the SubjectBase/ObserverBase mechanism."""
        self._observers.append(fn)

    def init(self, sim):
        self.Ly = float(sim.box[1])
        self._area = float(sim.box[0] * sim.box[2])
        self.update(sim, 0)

    def update(self, sim, step):
        mol = sim.molecules()
        if self._edges is None:
            self._edges = torch.as_tensor(
                np.histogram_bin_edges([], bins=self.nbins, range=(0.0, self.Ly)),
                dtype=torch.float64, device=mol.r.device)
        hist = histogram(mol.r[:, 1], mol.valid, self._edges).cpu().numpy()
        self.reads += 1
        edges = self._edges.cpu().numpy()
        width = self.Ly / self.nbins
        rho = hist / (self._area * width)
        centers = 0.5 * (edges[:-1] + edges[1:])
        if rho.max() <= 0:
            return
        if self.method == "denderiv":
            d = np.gradient(rho, width)
            self.left = float(centers[np.argmax(d)])
            self.right = float(centers[np.argmin(d)])
        else:
            # density midpoint: first/last bins above (rho_v+rho_l)/2
            mid = 0.5 * (np.percentile(rho, 10) + np.percentile(rho, 90))
            above = np.where(rho >= mid)[0]
            if len(above):
                self.left = float(centers[above[0]])
                self.right = float(centers[above[-1]])
        self._log.append((step, self.left, self.right))
        for fn in self._observers:
            fn(self.left, self.right)

    def after_forces(self, sim, step):
        if step % self.update_freq == 0:
            self.update(sim, step)

    def finish(self, sim):
        with open(f"{self.output_prefix}.dat", "w") as f:
            f.write("# step left right\n")
            for s, l, r in self._log:
                f.write(f"{s} {l:.6g} {r:.6g}\n")


@PluginFactory.register("DriftCtrl")
class DriftCtrl(PluginBase):
    """Per-bin drift relaxation (DriftCtrl.cpp): every `control` steps,
    for each y bin in [yl, yr], shift the target component's velocities
    so the bin's mean velocity equals the target drift (bins taken in
    order, each from the velocities the one before left)."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        ctl = p.get("control", {}) if isinstance(p.get("control"), dict) else {}
        freq = ctl.get("freq", {}) if isinstance(ctl.get("freq"), dict) else {}
        self.control_freq = int(float(freq.get("control", 100)))
        tgt = p.get("target", {}) if isinstance(p.get("target"), dict) else {}
        self.cid = int(float(tgt.get("cid", 1))) - 1
        drift = tgt.get("drift", {}) if isinstance(tgt.get("drift"), dict) else {}
        self.v_target = np.array(
            [float(drift.get(k, 0.0)) for k in ("vx", "vy", "vz")]
        )
        rng = p.get("range", {}) if isinstance(p.get("range"), dict) else {}
        self.yl = float(rng.get("yl", 0.0))
        self.yr = float(rng.get("yr", 1e30))
        sub = rng.get("subdivision", {}) if isinstance(rng.get("subdivision"), dict) else {}
        self.binwidth = float(sub.get("binwidth", 1.0))
        self._target = None

    def before_forces(self, sim, step):
        if step % self.control_freq:
            return
        mol = sim.engine.mol
        if self._target is None:
            self._target = torch.as_tensor(self.v_target, dtype=mol.v.dtype,
                                           device=mol.v.device)
        yr_eff = min(self.yr, float(sim.box[1]))
        nbins = max(1, int(np.ceil((yr_eff - self.yl) / self.binwidth)))
        sel_all = mol.valid & (mol.cid == self.cid)
        y = mol.r[:, 1]
        v = mol.v
        for b in range(nbins):
            lo = self.yl + b * self.binwidth
            hi = min(lo + self.binwidth, yr_eff)
            sel = (sel_all & (y >= lo) & (y < hi))[:, None]
            cnt = sel.sum()
            vmean = torch.where(sel, v, 0.0).sum(0) / torch.clamp(cnt, min=1)
            v = torch.where(sel, v + (self._target - vmean), v)
        _replace_mol(sim, v=v)


@PluginFactory.register("PosNegComp")
class PosNegComp(PluginBase):
    """Reassign the component by the sign of v_y (PosNegComp.cpp): cid1
    for v_y >= 0, cid2 for v_y < 0."""

    def __init__(self, params=None):
        super().__init__(params)
        self.cid_pos = int(float(self.params.get("cid_ub_pos", 1))) - 1
        self.cid_neg = int(float(self.params.get("cid_ub_neg", 2))) - 1

    def before_forces(self, sim, step):
        mol = sim.engine.mol
        cid = torch.where(mol.v[:, 1] >= 0, self.cid_pos, self.cid_neg)
        _replace_mol(sim, cid=torch.where(mol.valid, cid.to(mol.cid.dtype), mol.cid))


@PluginFactory.register("ExtractPhase")
class ExtractPhase(PluginBase):
    """Delete molecules outside the liquid film [left, right] along y
    (ExtractPhase.cpp, its density criterion simplified).  Runs once at
    the configured step."""

    def __init__(self, params=None):
        super().__init__(params)
        self.at_step = int(float(self.params.get("step", 1)))
        self.left = float(self.params.get("left", 0.0))
        self.right = float(self.params.get("right", 1e30))
        self.done = False

    def before_forces(self, sim, step):
        if self.done or step != self.at_step:
            return
        mol = sim.engine.mol
        y = mol.r[:, 1]
        _replace_mol(sim, valid=mol.valid & (y >= self.left) & (y <= self.right))
        self.done = True
