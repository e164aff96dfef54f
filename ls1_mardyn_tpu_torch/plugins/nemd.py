"""NEMD and boundary-condition plugins (the counterpart of
ls1_mardyn_tpu/plugins/nemd.py): Mirror, WallPotential, FixRegion,
COMaligner, InMemoryCheckpointing (the reference's src/plugins/
Mirror.cpp, WallPotential.cpp, FixRegion.cpp, COMaligner.cpp,
InMemoryCheckpointing.h).

They act on the engine's tensors on its device.  Only Mirror types 5
and 6 read the device on a step: they draw one number a crossing
molecule from numpy, as the JAX package does, so they need the count
(one read a step, none when nobody crosses, and the draws are sent to
the device only then).  Counters stay on the device until asked for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.ops.cells import wrap_positions
from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory
from ls1_mardyn_tpu_torch.state import MoleculeState


def _replace_mol(sim, **kw):
    sim.engine.mol = dataclasses.replace(sim.engine.mol, **kw)


def _set_column(a, axis, col):
    """a with column `axis` replaced by col (a new tensor)."""
    out = a.clone()
    out[:, axis] = col
    return out


class DeviceCount:
    """An integer counter whose increments (0-d device tensors) stay on
    the device until the value is read."""

    def __init__(self):
        self._host = 0
        self._dev = None

    def add(self, x):
        x = x.to(torch.int64)
        self._dev = x if self._dev is None else self._dev + x

    @property
    def value(self) -> int:
        if self._dev is not None:
            self._host += int(self._dev)
            self._dev = None
        return self._host

    def tensor(self, device):
        """The value as a 0-d device tensor (no read)."""
        t = torch.full((), self._host, dtype=torch.int64, device=device)
        return t if self._dev is None else t + self._dev


class _Consts:
    """Host arrays sent to a device once per (dtype, device)."""

    def __init__(self, **arrays):
        self._arrays = arrays
        self._made = {}

    def on(self, like: torch.Tensor):
        """The arrays on like's device, floating ones in like's dtype."""
        key = (like.dtype, like.device)
        if key not in self._made:
            self._made[key] = {
                k: torch.as_tensor(np.asarray(v), device=like.device,
                                   dtype=like.dtype if np.asarray(v).dtype.kind == "f"
                                   else None)
                for k, v in self._arrays.items()}
        return self._made[key]


@PluginFactory.register("Mirror")
class Mirror(PluginBase):
    """Mirror boundary at a plane (src/plugins/Mirror.{h:26-33,cpp}).

    The four live reference types:
      1 MT_REFLECT        velocity reversal of outward movers beyond
                          the plane (afterForces, Mirror.cpp:459-463)
      2 MT_FORCE_CONSTANT restoring force k*(pos - r) beyond the plane,
                          through the siteWiseForces hook
                          (Mirror.cpp:464-476)
      5 MT_MELAND_2004    probabilistic reflection toward a target
                          hydrodynamic velocity; non-reflected movers
                          are deleted (Mirror.cpp:193-291)
      6 MT_RAMPING        reflection probability ramps 1 -> 0 between
                          start/stop steps; the rest are deleted or
                          transmitted (Mirror.cpp:295-371)

    Reference XML names are accepted (type/dir/position.coord/
    forceConstant/meland.velo_target/ramping.*); `position`/`axis`/
    `direction` shortcuts are kept for programmatic configs.  dir
    'o-|' = right mirror (keeps molecules below), '|-o' = left."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.type = int(float(p.get("type", 1)))
        pos = p.get("position", 0.0)
        if isinstance(pos, dict):  # reference schema <position><coord>
            pos = pos.get("coord", 0.0)
        self.position = float(pos)
        self.axis = int(float(p.get("axis", 1)))
        d = p.get("dir", "")
        if d:
            # 'o-|' reflects to the left (right mirror: keep below)
            self.direction = 1 if d.strip() == "o-|" else -1
        else:
            self.direction = int(float(p.get("direction", 1)))
        self.cid = int(float(p.get("cid", 0)))  # 0 == all components
        self.force_constant = float(p.get("forceConstant", 0.0))
        mel = p.get("meland", {}) if isinstance(p.get("meland"), dict) else {}
        self.velo_target = float(mel.get("velo_target",
                                         p.get("velo_target", 0.0)))
        self.fixed_prob = float(mel.get("fixed_probability",
                                        p.get("fixed_probability", 0.0)))
        ram = p.get("ramping", {}) if isinstance(p.get("ramping"), dict) else {}
        self.ramp_start = int(float(ram.get("start", 0)))
        self.ramp_stop = int(float(ram.get("stop", 0)))
        self.ramp_treatment = int(float(ram.get("treatment", 0)))
        self._reflected = DeviceCount()
        self._deleted = DeviceCount()
        self._rng = np.random.default_rng(int(float(p.get("seed", 71))))
        # device reads so far (types 5 and 6: one a step)
        self.reads = 0

    @property
    def reflected(self) -> int:
        return self._reflected.value

    @property
    def deleted(self) -> int:
        return self._deleted.value

    def _beyond_outward(self, mol):
        """Mask of considered molecules beyond the plane AND moving
        outward (the reference's region + velocity-sign test)."""
        r = mol.r[:, self.axis]
        v = mol.v[:, self.axis]
        if self.direction > 0:  # right mirror: keep below the plane
            m = mol.valid & (r > self.position) & (v > 0.0)
        else:
            m = mol.valid & (r < self.position) & (v < 0.0)
        if self.cid > 0:
            m = m & (mol.cid == self.cid - 1)
        return m

    def site_wise_forces_fn(self, table, box):
        if self.type != 2:
            return None
        axis, pos, k = self.axis, self.position, self.force_constant
        sign, cid = self.direction, self.cid

        def wall_force(mol, pp):
            r = mol.r[:, axis]
            beyond = (r > pos) if sign > 0 else (r < pos)
            m = mol.valid & beyond
            if cid > 0:
                m = m & (mol.cid == cid - 1)
            F = torch.zeros_like(mol.r)
            F[:, axis] = torch.where(m, k * (pos - r), 0.0)
            zero = torch.zeros((), dtype=mol.r.dtype, device=mol.r.device)
            return zero, F, torch.zeros_like(F)

        return wall_force

    def before_forces(self, sim, step):
        if self.type not in (5, 6):
            return
        mol = sim.engine.mol
        idx = torch.nonzero(self._beyond_outward(mol)).flatten()  # the read
        self.reads += 1
        n = idx.numel()
        if n == 0:
            return
        v = mol.v[idx, self.axis]
        frnd = torch.as_tensor(self._rng.random(n), dtype=mol.v.dtype,
                               device=mol.v.device)
        if self.type == 5:  # Meland 2004
            v_ref = 2.0 * self.velo_target - v
            inward = (v_ref < 0.0) if self.direction > 0 else (v_ref > 0.0)
            pbf = (
                torch.full_like(v, self.fixed_prob)
                if self.fixed_prob > 0
                else torch.abs(v_ref / torch.where(v != 0, v, 1.0))
            )
            reflect = inward & (frnd < pbf)
            delete = ~reflect
            new_v = v_ref
        else:  # ramping
            if step <= self.ramp_start:
                ratio = 1.0
            elif step < self.ramp_stop:
                ratio = (self.ramp_stop - step) / max(
                    self.ramp_stop - self.ramp_start, 1
                )
            else:
                ratio = 0.0
            reflect = frnd <= ratio
            delete = ~reflect if self.ramp_treatment == 0 else torch.zeros_like(reflect)
            new_v = -v
        self._reflected.add(reflect.sum())
        self._deleted.add(delete.sum())
        vcol = mol.v[:, self.axis].index_put((idx,), torch.where(reflect, new_v, v))
        _replace_mol(
            sim,
            v=_set_column(mol.v, self.axis, vcol),
            valid=mol.valid.index_put((idx,), mol.valid[idx] & ~delete),
        )

    def end_step(self, sim, step):
        if self.type != 1:
            return
        # MT_REFLECT: velocity reversal only (Mirror.cpp:459-463); the
        # position stays, matching the reference's VelocityChange
        mol = sim.engine.mol
        m = self._beyond_outward(mol)
        self._reflected.add(m.sum())
        v = mol.v[:, self.axis]
        _replace_mol(sim, v=_set_column(mol.v, self.axis, torch.where(m, -v, v)))


@PluginFactory.register("WallPotential")
class WallPotential(PluginBase):
    """Structureless LJ-9-3 / LJ-10-4-3 wall
    (src/plugins/WallPotential.{h:124,cpp}): a one-body potential on
    every LJ site, through the siteWiseForces hook, so that it enters
    U_pot and the torques.

    Reference parameters: density (wall), sigma, epsilon, yoff (wall
    centre), ycut (cutoff distance from the wall face), width (wall slab
    thickness), delta (10-4-3 interlayer spacing), potential (93 | 104),
    per-component <component id=..><xi/><eta/>.  Wall-fluid parameters
    follow initializeLJ93/initializeLJ1043 (WallPotential.cpp:105-190):
    eps_wi = xi*sqrt(epsWall*eps_c), sig_wi = 0.5*eta*(sigWall + sig_c),
    from each component's first LJ centre.  The 10-4-3 energy uses the
    intended 2/5, where the reference's C++ integer division
    `(2 / 5) * term1` (WallPotential.cpp:315) drops it, as the JAX
    package does."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.potential = int(float(p.get("potential", 93)))
        self.rho_w = float(p.get("density", 1.0))
        self.sig_w = float(p.get("sigma", 1.0))
        self.eps_w = float(p.get("epsilon", 1.0))
        self.yoff = float(p.get("yoff", p.get("yc", 0.0)))
        self.ycut = float(p.get("ycut", 2.5))
        self.width = float(p.get("width", 0.0))
        self.delta = float(p.get("delta", 1.0))
        self.axis = int(float(p.get("axis", 1)))
        comps = p.get("component", [])
        if isinstance(comps, dict):
            comps = [comps]
        self.comp_xi_eta = {
            int(float(c.get("id", 1))) - 1: (
                float(c.get("xi", 1.0)), float(c.get("eta", 1.0))
            )
            for c in comps
        }

    def site_wise_forces_fn(self, table, box):
        K = table.K
        S = int(np.asarray(table.lj_pos).shape[1])
        eps_wi = np.zeros(K)
        sig_wi = np.zeros(K)
        consider = np.zeros(K, bool)
        site_mask = np.zeros((K, S), bool)
        for k, comp in enumerate(table.components):
            if not comp.ljcenters:
                continue
            if self.comp_xi_eta and k not in self.comp_xi_eta:
                continue
            xi, eta = self.comp_xi_eta.get(k, (1.0, 1.0))
            eps_wi[k] = xi * np.sqrt(self.eps_w * comp.ljcenters[0].eps)
            sig_wi[k] = 0.5 * eta * (self.sig_w + comp.ljcenters[0].sigma)
            consider[k] = True
            site_mask[k, : len(comp.ljcenters)] = True
        consts = _Consts(eps=eps_wi, sig=sig_wi, consider=consider,
                         site_mask=site_mask)
        axis, yoff, ycut = self.axis, self.yoff, self.ycut
        half_w = self.width * 0.5
        rho_w, delta, pot = self.rho_w, self.delta, self.potential

        def wall(mol, pp):
            c = consts.on(mol.r)
            cid = mol.cid.long()
            eps_c, sig_c = c["eps"][cid], c["sig"][cid]
            # world-frame LJ site offsets; sites beyond a component's
            # count carry zero offsets and are masked
            d_lj = qrotate(mol.q[:, None, :], pp.lj_pos[cid])  # [N, S, 3]
            ry = mol.r[:, axis][:, None] + d_lj[..., axis]
            ry_rel = torch.where(ry > yoff, ry - (yoff + half_w),
                                 ry - (yoff - half_w))
            y = torch.clamp(torch.abs(ry_rel), min=1e-6)
            active = ((y < ycut) & c["site_mask"][cid]
                      & c["consider"][cid][:, None] & mol.valid[:, None])
            e = eps_c[:, None]
            if pot == 93:
                s3 = sig_c[:, None] ** 3
                s9 = s3 ** 3
                y3 = y ** 3
                y9 = y3 ** 3
                pref = 4.0 * np.pi * rho_w * e * s3
                # uShift: u(ycut), so that the potential vanishes there
                yc3 = ycut ** 3
                yc9 = yc3 ** 3
                u_site = pref * (s9 / (45.0 * y9) - s3 / (6.0 * y3)) - (
                    pref * (s9 / (45.0 * yc9) - s3 / (6.0 * yc3))
                )
                f_mag = pref * (s9 / (5.0 * y9) - s3 / (2.0 * y3)) / y
            else:  # 10-4-3
                s = sig_c[:, None]
                s2 = s * s
                s4 = s2 * s2
                s10 = s4 * s4 * s2
                y2 = y * y
                y4 = y2 * y2
                y5 = y4 * y
                y10 = y5 * y5
                y11 = y10 * y
                br = y + 0.61 * delta
                br3 = br ** 3
                pref = 2.0 * np.pi * e * rho_w * s2 * delta
                t3 = s4 / (3.0 * delta * br3)
                ycb = ycut + 0.61 * delta
                u_cut = pref * (
                    0.4 * s10 / ycut ** 10 - s4 / ycut ** 4
                    - s4 / (3.0 * delta * ycb ** 3)
                )
                u_site = pref * (0.4 * s10 / y10 - s4 / y4 - t3) - u_cut
                f_mag = pref * (
                    4.0 * s10 / y11 - 4.0 * s4 / y5 - 3.0 * t3 / br
                )
            f_site = torch.where(active, f_mag * torch.sign(ry_rel), 0.0)
            u = torch.where(active, u_site, 0.0).sum()
            F = torch.zeros_like(mol.r)
            F[:, axis] = f_site.sum(1)
            # torque: site lever arm x site force (along `axis`)
            Fs = torch.zeros_like(d_lj)
            Fs[..., axis] = f_site
            M = torch.linalg.cross(d_lj, Fs, dim=-1).sum(1)
            return u, F, M

        return wall


@PluginFactory.register("FixRegion")
class FixRegion(PluginBase):
    """Freeze molecules inside a box region (src/plugins/FixRegion.cpp):
    zero their velocities and angular momenta every step."""

    def __init__(self, params=None):
        super().__init__(params)
        g = lambda k, d: float(self.params.get(k, d))  # noqa: E731
        self.lo = np.array([g("xmin", 0), g("ymin", 0), g("zmin", 0)])
        self.hi = np.array(
            [g("xmax", 1e30), g("ymax", 1e30), g("zmax", 1e30)]
        )
        self._consts = _Consts(lo=self.lo, hi=self.hi)

    def end_step(self, sim, step):
        mol = sim.engine.mol
        c = self._consts.on(mol.r)
        inside = ((mol.r >= c["lo"]) & (mol.r < c["hi"])).all(-1)[:, None]
        _replace_mol(sim, v=torch.where(inside, 0.0, mol.v),
                     L=torch.where(inside, 0.0, mol.L))


@PluginFactory.register("COMaligner")
class COMaligner(PluginBase):
    """Re-centre the centre of mass (src/plugins/COMaligner.cpp): every
    interval, shift all molecules so the COM returns to the box centre
    (fraction `alignmentCorrection`)."""

    def __init__(self, params=None):
        super().__init__(params)
        self.interval = int(float(self.params.get("interval", 25)))
        self.factor = float(self.params.get("alignmentCorrection", 1.0))
        self._consts = None

    def end_step(self, sim, step):
        if step % self.interval:
            return
        mol = sim.engine.mol
        if self._consts is None:
            self._consts = _Consts(target=np.asarray(sim.box, float) / 2.0)
        target = self._consts.on(mol.r)["target"]
        w = sim.pp.mass[mol.cid.long()] * mol.valid.to(mol.r.dtype)
        com = (mol.r * w[:, None]).sum(0) / w.sum()
        shift = (target - com) * self.factor
        _replace_mol(sim, r=wrap_positions(mol.r + shift[None, :], tuple(sim.box)))


@PluginFactory.register("InMemoryCheckpointing")
class InMemoryCheckpointing(PluginBase):
    """In-memory snapshot and restore (src/plugins/
    InMemoryCheckpointing.h:18-70): keeps the last
    `writefrequency`-aligned snapshot of the molecule state (a copy on
    the device) and restores it at `restartAtIteration`, once.  On the
    RMM engine the restore goes through its mol setter (re-bin and force
    evaluation)."""

    def __init__(self, params=None):
        super().__init__(params)
        self.restart_at = int(float(self.params.get("restartAtIteration", -1)))
        self._snapshot = None
        self._snapshot_step = -1

    @staticmethod
    def _copy(mol):
        return MoleculeState(*(getattr(mol, f.name).clone()
                               for f in dataclasses.fields(mol)))

    def end_step(self, sim, step):
        if step % self.write_frequency == 0:
            self._snapshot = self._copy(sim.engine.mol)
            self._snapshot_step = step
            self._snapshot_time = sim.time

    def before_event_new_timestep(self, sim, step):
        if step == self.restart_at and self._snapshot is not None:
            sim.engine.mol = self._copy(self._snapshot)
            sim.engine.forces = None
            sim.engine.prepare_start()
            sim.time = self._snapshot_time
            self.restart_at = -1  # restore once
