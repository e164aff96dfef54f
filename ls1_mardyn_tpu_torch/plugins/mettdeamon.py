"""MettDeamon: reservoir-slab molecule feed for steady-state evaporation
(the counterpart of ls1_mardyn_tpu/plugins/mettdeamon.py; the
reference's src/plugins/NEMD/MettDeamon.{h,cpp}).

  - a RESERVOIR of liquid (read from an ASCII phase-space file or cut
    from the start state, Reservoir::readParticleData) is sliced into
    y-bins of ``binwidth``; bin positions are normalised to the slab
    origin (MettDeamon.cpp:1495);
  - each step the feed sum advances by the feed rate; when it exceeds
    one bin width, the active reservoir bin is inserted at the feed
    boundary (y + feed.sum - binwidth, MettDeamon.cpp:1186), the bin
    queue advances cyclically, and the inserted molecules become FROZEN
    component variants (<changes><change><from>/<to>);
  - frozen (trapped) molecules ride with the feed: every step their
    x/z/orientation reset to the stored values, y advances by the feed
    rate, velocities reset to the stored values and angular momentum is
    zeroed (beforeEventNewTimestep refreshes the store, preForce_action
    applies it: MettDeamon.cpp:447,535-559,656-697);
  - crossing the TRANSITION PLANE (2 bin widths from the feed wall,
    MettDeamon.cpp:1046-1048) releases them: the component switches
    back and the release velocity applies (unchanged / fix_value /
    add_fix_value, releaseTrappedMolecule:573-631);
  - feed-rate methods: ``constant`` (4: feed = init) and
    ``deleted-molecules`` (1: feed = deletions per step / (area_xz *
    reservoir density), MettDeamon.cpp:1017);
  - a ``manipfree`` y-window is never touched.

The per-step work (deletion count, trap store, ride, release) is tensor
operations on the engine's device with no read; a scene without frozen
components skips it.  The host takes part only at a bin insertion (one
read of the validity mask and the largest molecule id; the ins_percent
draws from numpy, as the JAX package's; the bin's rows sent to the
device), at a feed update of the deleted-molecules method and at a log
line (one read each).  The JAX package reads and rewrites the whole
state on the host every step.

The engine's forces are kept across a change: a trapped molecule's
motion is reset by the ride every step, and an inserted molecule's slot
holds the zero force of an invalid slot until the next force
evaluation.  (The JAX package sets the engine's forces to None after a
change, and its next step fails: ROADMAP Queue 3.)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory
from ls1_mardyn_tpu_torch.plugins.nemd import DeviceCount
from ls1_mardyn_tpu_torch.utils.logger import global_log


def _get(d, path, default=None):
    cur = d
    for k in path.split("/"):
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


@PluginFactory.register("MettDeamon")
class MettDeamon(PluginBase):
    """Reservoir-slab feeder (reference semantics)."""

    def __init__(self, params=None):
        super().__init__(params)
        p = self.params
        self.update_freq = int(float(_get(p, "control/updatefreq", 100)))
        self.numvals = int(float(_get(p, "control/numvals", 100)))
        self.feed_init = float(_get(p, "control/feed/init", 0.0))
        self.direction = int(float(_get(p, "control/feed/direction", 1)))
        method = int(float(_get(p, "control/feed/method", 4)))
        self.feed_method = {1: "deleted", 3: "density", 4: "constant",
                            5: "directed"}.get(method, "constant")
        if self.feed_method in ("density", "directed"):
            # density/directed control reduce to the deleted-molecules
            # balance under the dense bookkeeping
            self.feed_method = "deleted"
        self.rv_method = int(float(
            _get(p, "control/feed/release_velo/method", 1)))
        self.rv_fix = float(_get(
            p, "control/feed/release_velo/fix_value", 0.0))
        self.manip_ymin = float(_get(p, "control/manipfree/ymin", -1e30))
        self.manip_ymax = float(_get(p, "control/manipfree/ymax", -1e30))
        res = p.get("reservoir", {}) if isinstance(
            p.get("reservoir"), dict) else {}
        self.res_file = _get(res, "file/data") or (
            res.get("file") if isinstance(res.get("file"), str) else None)
        self.res_width = float(res.get("width", 0.0) or 0.0)
        self.bin_width = float(res.get("binwidth", 0.0) or 0.0)
        self.ins_percent = float(res.get("ins_percent", 1.0) or 1.0)
        # component freeze/unfreeze maps (1-based ids in the XML)
        self.changes = []
        ch = p.get("changes", {}) or {}
        for ce in (ch.get("change") if isinstance(
                ch.get("change"), list) else [ch.get("change")]):
            if isinstance(ce, dict):
                self.changes.append((int(float(ce.get("from", 1))) - 1,
                                     int(float(ce.get("to", 1))) - 1))
        self.inserted = 0
        self._released = DeviceCount()
        self._deleted = DeviceCount()
        # device reads so far (insertions, feed updates, log lines)
        self.reads = 0
        self._rng = np.random.default_rng(
            int(float(p.get("seed", 17))))

    @property
    def released(self) -> int:
        return self._released.value

    @property
    def deleted_sum(self) -> int:
        return self._deleted.value

    # -- lifecycle ----------------------------------------------------

    def init(self, sim):
        K = sim.table.K
        self.freeze = np.arange(K)
        self.unfreeze = np.arange(K)
        for a, b in self.changes:
            if 0 <= a < K and 0 <= b < K:
                self.freeze[a] = b
                self.unfreeze[b] = a
        self.trapped_cids = np.flatnonzero(
            self.unfreeze != np.arange(K))
        box = np.asarray(sim.box, float)
        self.boxy = box[1]
        self.area_xz = box[0] * box[2]
        if not self.bin_width:
            self.bin_width = max(self.res_width / 4.0, 1.0)
        if self.direction == 1:
            self.transition_y = 2 * self.bin_width
        else:
            self.transition_y = self.boxy - 2 * self.bin_width

        self._load_reservoir(sim)
        self.feed_actual = self.feed_init
        self.feed_sum = 0.0
        mol = sim.engine.mol
        dev = mol.r.device
        self._unfreeze_t = torch.as_tensor(self.unfreeze, dtype=mol.cid.dtype,
                                           device=dev)
        self._trapped_t = torch.as_tensor(self.trapped_cids,
                                          dtype=mol.cid.dtype, device=dev)
        # the last `numvals` deletion events (a ring) and their count
        self._del_ring = torch.zeros(self.numvals, dtype=torch.int64, device=dev)
        self._del_count = torch.zeros((), dtype=torch.int64, device=dev)
        self._prev_n = None
        n = mol.capacity
        self._stored = torch.zeros((n, 10), dtype=mol.r.dtype, device=dev)  # r v q
        self._has_store = torch.zeros(n, dtype=torch.bool, device=dev)
        self._log_path = os.path.abspath("MettDeamon_feed.dat")
        self._log = open(self._log_path, "w")
        self._log.write("# step feed_actual feed_sum inserted "
                        "released deleted_window\n")

    def _load_reservoir(self, sim):
        if self.res_file:
            from ls1_mardyn_tpu_torch.io.ascii_reader import read_inp

            data = read_inp(self.res_file)
            r, v, q = (np.asarray(data.r, float),
                       np.asarray(data.v, float),
                       np.asarray(data.q, float))
            cid = np.asarray(data.cid, np.int64)
            y0 = r[:, 1].min()
            width = r[:, 1].max() - y0 + 1e-12
        else:
            mol = sim.engine.mol
            valid = mol.valid.cpu().numpy()

            def host(x):
                return x.cpu().numpy()[valid]

            r, v, q = (host(mol.r).astype(float), host(mol.v).astype(float),
                       host(mol.q).astype(float))
            cid = host(mol.cid).astype(np.int64)
            width = self.res_width or self.bin_width * 4
            if self.direction == 1:
                sel = r[:, 1] < width
                y0 = 0.0
            else:
                sel = r[:, 1] > self.boxy - width
                y0 = self.boxy - width
            r, v, q, cid = r[sel], v[sel], q[sel], cid[sel]
        if len(r) == 0:
            raise ValueError("MettDeamon: empty reservoir")
        self.res_density = len(r) / (self.area_xz * width)
        nbins = max(1, int(round(width / self.bin_width)))
        yrel = r[:, 1] - y0
        bidx = np.minimum((yrel / self.bin_width).astype(int), nbins - 1)
        self.bins = []
        for b in range(nbins):
            m = bidx == b
            rb = r[m].copy()
            # positions normalised to the slab origin
            # (MettDeamon.cpp:1495)
            rb[:, 1] = yrel[m] - b * self.bin_width
            self.bins.append(dict(r=rb, v=v[m].copy(), q=q[m].copy(),
                                  cid=cid[m].copy()))
        self.active_bin = 0

    # -- helpers ------------------------------------------------------

    def _trapped_mask(self, mol):
        return torch.isin(mol.cid, self._trapped_t) & mol.valid

    # -- hooks --------------------------------------------------------

    def before_event_new_timestep(self, sim, step):
        mol = sim.engine.mol
        if self._stored.shape[0] != mol.capacity:
            # a re-spec rebuilt the state (new slots): the trapped
            # molecules are stored again below
            self._stored = torch.zeros((mol.capacity, 10), dtype=mol.r.dtype,
                                       device=mol.r.device)
            self._has_store = torch.zeros(mol.capacity, dtype=torch.bool,
                                          device=mol.r.device)
        n_now = mol.valid.sum()
        if self._prev_n is not None:
            # a fall in N is one deletion event of the window
            d = self._prev_n - n_now
            dec = d > 0
            self._deleted.add(torch.where(dec, d, 0))
            pos = (self._del_count % self.numvals).view(1)
            self._del_ring.index_put_((pos,), torch.where(dec, d, self._del_ring[pos]))
            self._del_count = self._del_count + dec.to(torch.int64)
        self._prev_n = n_now
        if len(self.trapped_cids):
            # refresh the trap store (beforeEventNewTimestep:447)
            t = self._trapped_mask(mol)
            self._stored = torch.where(
                t[:, None], torch.cat([mol.r, mol.v, mol.q], 1), self._stored)
            self._has_store = (self._has_store | t) & mol.valid
        else:
            self._has_store = self._has_store & mol.valid

    def before_forces(self, sim, step):
        if len(self.trapped_cids):
            self._trap(sim)
        self.feed_sum += self.feed_actual
        if self.bins and self.feed_sum >= self.bin_width:
            self._insert_bin(sim)

    def _trap(self, sim):
        mol = sim.engine.mol
        y = mol.r[:, 1]
        manip_ok = ~((y > self.manip_ymin) & (y < self.manip_ymax))
        t = self._trapped_mask(mol) & self._has_store & manip_ok
        behind = (y > self.transition_y) if self.direction == 1 \
            else (y < self.transition_y)
        rel, stay = t & behind, t & ~behind
        st = self._stored
        cid = torch.where(rel, self._unfreeze_t[mol.cid.long()], mol.cid)
        v = torch.where(rel[:, None], st[:, 3:6], mol.v)
        if self.rv_method == 2:
            v[:, 1] = torch.where(rel, self.rv_fix, v[:, 1])
        elif self.rv_method == 3:
            v[:, 1] = torch.where(rel, v[:, 1] + self.rv_fix, v[:, 1])
        self._has_store = self._has_store & ~rel
        self._released.add(rel.sum())
        # ride with the feed: lateral pinning + stored orientation and
        # velocity (preForce_action:729-739)
        dy = self.feed_actual if self.direction == 1 else -self.feed_actual
        s1 = stay[:, None]
        r = torch.where(s1, st[:, 0:3], mol.r)
        r[:, 1] = torch.where(stay, st[:, 1] + dy, mol.r[:, 1])
        sim.engine.mol = dataclasses.replace(
            mol, r=r, cid=cid,
            v=torch.where(s1, st[:, 3:6], v),
            q=torch.where(s1, st[:, 6:10], mol.q),
            L=torch.where(s1, 0.0, mol.L))

    def _insert_bin(self, sim):
        """Insert the active reservoir bin into free slots (the host
        part of the plugin: one read, numpy draws, the rows sent)."""
        mol = sim.engine.mol
        mx = torch.where(mol.valid, mol.mid, torch.iinfo(mol.mid.dtype).min).max()
        packed = torch.cat([mol.valid.to(torch.int64), mx.view(1).to(torch.int64)])
        packed = packed.cpu().numpy()
        self.reads += 1
        valid, any_valid = packed[:-1].astype(bool), packed[:-1].any()
        b = self.bins[self.active_bin]
        nb = len(b["r"])
        keep = self._rng.random(nb) < self.ins_percent
        free = np.flatnonzero(~valid)
        n_ins = int(keep.sum())
        if n_ins > len(free):
            global_log.warning(
                "MettDeamon: %d free slots for %d reservoir "
                "molecules; inserting what fits (raise the "
                "capacity reserve)", len(free), n_ins)
            ki = np.flatnonzero(keep)[: len(free)]
            keep = np.zeros(nb, bool)
            keep[ki] = True
            n_ins = len(free)
        if n_ins:
            rb = b["r"][keep].copy()
            if self.direction == 1:
                rb[:, 1] = rb[:, 1] + self.feed_sum - self.bin_width
            else:
                rb[:, 1] = self.boxy - self.bin_width + rb[:, 1] \
                    - (self.feed_sum - self.bin_width)
            mx = int(packed[-1]) if any_valid else 0
            dev, dtype = mol.r.device, mol.r.dtype
            slots = torch.as_tensor(free[:n_ins], device=dev)
            rows = torch.as_tensor(np.concatenate(
                [rb, b["v"][keep], b["q"][keep]], 1), dtype=dtype, device=dev)
            ids = torch.as_tensor(np.stack(
                [self.freeze[b["cid"][keep]], mx + 1 + np.arange(n_ins)]),
                dtype=mol.cid.dtype, device=dev)
            sim.engine.mol = dataclasses.replace(
                mol,
                r=mol.r.index_put((slots,), rows[:, 0:3]),
                v=mol.v.index_put((slots,), rows[:, 3:6]),
                q=mol.q.index_put((slots,), rows[:, 6:10]),
                L=mol.L.index_put((slots,), torch.zeros_like(rows[:, 0:3])),
                cid=mol.cid.index_put((slots,), ids[0]),
                mid=mol.mid.index_put((slots,), ids[1]),
                valid=mol.valid.index_put(
                    (slots,), torch.ones_like(slots, dtype=torch.bool)),
            )
            self._stored = self._stored.index_put((slots,), rows)
            self._has_store = self._has_store.index_put(
                (slots,), torch.ones_like(slots, dtype=torch.bool))
        self.inserted += n_ins
        self.feed_sum -= self.bin_width
        self.active_bin = (self.active_bin + 1) % len(self.bins)

    def _window(self):
        """(sum, length) of the deletion window, as device tensors."""
        return self._del_ring.sum(), torch.clamp(self._del_count, max=self.numvals)

    def after_forces(self, sim, step):
        update = (self.feed_method == "deleted" and step
                  and step % self.update_freq == 0)
        log = step % max(self.write_frequency, 1) == 0 and hasattr(self, "_log")
        if not (update or log):
            return
        # feed-rate update (postForce_action:796-849 + calcDeltaY:1017):
        # deleted molecules per step / (rho * A); one read for both
        w_sum, w_len = self._window()
        w_sum, w_len, released = torch.stack(
            [w_sum, w_len, self._released.tensor(w_sum.device)]).tolist()
        self.reads += 1
        if update and w_len:
            self.feed_actual = w_sum / max(w_len, 1) / (
                self.res_density * self.area_xz)
        if log:
            if self._log.closed:  # a later run() of the same driver
                self._log = open(self._log_path, "a")
            self._log.write("%d %.8g %.8g %d %d %d\n" % (
                step, self.feed_actual, self.feed_sum, self.inserted,
                released, w_sum))
            self._log.flush()

    def finish(self, sim):
        if hasattr(self, "_log"):
            self._log.close()
