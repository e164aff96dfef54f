"""Small NEMD utilities of the plugin registry (the counterpart of four
classes of ls1_mardyn_tpu/plugins/extra.py): Dropaligner,
Dropaccelerator, MirrorSystem and MettDeamonFeedrateDirector.  The
first three are tensor operations on the engine's device with no read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory
from ls1_mardyn_tpu_torch.plugins.mettdeamon import MettDeamon


def _sphere(mol, center, radius):
    """Valid molecules within `radius` of `center` (a device tensor)."""
    return mol.valid & (((mol.r - center) ** 2).sum(1) < radius ** 2)


class _Centered(PluginBase):
    def _center(self, like):
        if getattr(self, "_center_t", None) is None:
            self._center_t = torch.as_tensor(self.center, dtype=like.dtype,
                                             device=like.device)
        return self._center_t


@PluginFactory.register("Dropaligner")
class Dropaligner(_Centered):
    """Re-centre a droplet's centre of mass to a fixed point (the
    src/plugins/NEMD/Dropaligner role; COMaligner with a spherical
    selection)."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.center = np.array(
            [float(p.get("xpos", 0)), float(p.get("ypos", 0)),
             float(p.get("zpos", 0))]
        )
        self.radius = float(p.get("radius", 1e30))
        self.interval = int(float(p.get("interval", 1)))

    def before_forces(self, sim, step):
        if step % self.interval:
            return
        mol = sim.engine.mol
        c = self._center(mol.r)
        sel = _sphere(mol, c, self.radius)
        cnt = sel.sum()
        shift = c - torch.where(sel[:, None], mol.r, 0.0).sum(0) / torch.clamp(cnt, min=1)
        box = torch.as_tensor(np.asarray(sim.box, float), dtype=mol.r.dtype,
                              device=mol.r.device)
        # nobody in the sphere: nothing moves
        moved = (mol.valid & (cnt > 0))[:, None]
        sim.engine.mol = dataclasses.replace(
            mol, r=torch.where(moved, torch.remainder(mol.r + shift, box), mol.r))


@PluginFactory.register("Dropaccelerator")
class Dropaccelerator(_Centered):
    """Accelerate the molecules inside a sphere by a fixed velocity
    increment (along y) over a step window (src/plugins/NEMD/
    Dropaccelerator)."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.center = np.array(
            [float(p.get("xposition", 0)), float(p.get("yposition", 0)),
             float(p.get("zposition", 0))]
        )
        self.radius = float(p.get("dropradius", 1.0))
        self.velocity = float(p.get("velocity", 0.0))  # total dv (y)
        self.start = int(float(p.get("starttime", 0)))
        self.steps = max(1, int(float(p.get("steps", 1))))

    def before_forces(self, sim, step):
        if not (self.start <= step < self.start + self.steps):
            return
        mol = sim.engine.mol
        sel = _sphere(mol, self._center(mol.r), self.radius)
        v = mol.v.clone()
        v[:, 1] = torch.where(sel, v[:, 1] + self.velocity / self.steps, v[:, 1])
        sim.engine.mol = dataclasses.replace(mol, v=v)


@PluginFactory.register("MirrorSystem")
class MirrorSystem(PluginBase):
    """One-shot system mirroring about a plane (the src/plugins/NEMD/
    MirrorSystem role): reflects positions and the normal velocity
    component across y = yPos."""

    def __init__(self, params=None):
        super().__init__(params)
        self.ypos = float(self.params.get("yPos", 0.0))
        self.done = False

    def before_forces(self, sim, step):
        if self.done:
            return
        mol = sim.engine.mol
        r, v = mol.r.clone(), mol.v.clone()
        r[:, 1] = torch.remainder(2.0 * self.ypos - r[:, 1], float(sim.box[1]))
        v[:, 1] = -v[:, 1]
        sim.engine.mol = dataclasses.replace(mol, r=r, v=v)
        self.done = True


@PluginFactory.register("MettDeamonFeedrateDirector")
class MettDeamonFeedrateDirector(PluginBase):
    """Sets the feed rate of the run's MettDeamon plugins to the measured
    outflow (the src/plugins/NEMD/MettDeamonFeedrateDirector role): every
    `updatefreq` steps, the molecules a MettDeamon counted as deleted
    since the last update, per step, over (reservoir density * area_xz):
    the balance of MettDeamon's deleted-molecules feed method.

    The JAX package's version imports MettDeamon from plugins/nemd2.py,
    which has no such class, and reads attributes MettDeamon does not
    have (`deleted`, `interval`, `feed_rate`): it raises ImportError at
    its first update."""

    def __init__(self, params=None):
        super().__init__(params)
        self.update_freq = int(float(self.params.get("updatefreq", 100)))
        self._last_deleted = {}
        self.reads = 0

    def end_step(self, sim, step):
        if step % self.update_freq:
            return
        for p in sim._plugins:
            if isinstance(p, MettDeamon):
                deleted = p.deleted_sum  # one read
                self.reads += 1
                outflow = deleted - self._last_deleted.get(id(p), 0)
                self._last_deleted[id(p)] = deleted
                p.feed_actual = outflow / self.update_freq / (
                    p.res_density * p.area_xz)
