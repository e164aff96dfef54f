"""Default output plugins (writers; the counterpart of
ls1_mardyn_tpu/plugins/writers.py).

Re-creations of the reference's observable/trajectory writers
(src/io/): ResultWriter, EnergyLogWriter, XyzWriter, CheckpointWriter,
MaxWriter, FlopRateWriter.  Headers and column layouts are the JAX
package's, byte for byte apart from timestamps, so downstream tooling
reads both.

Nothing here waits for the device on the main path: per-step values
stay in device tensors, reductions run on the device, and a write step
stacks its row's numbers and starts their copy to pinned host memory
without waiting (_Rows); the row reaches the file once its copy is done,
at a later write step or at the end of the run.  Only the writers whose
file holds the whole state (XyzWriter, CheckpointWriter) and the pair
counter of FlopRateWriter wait for it.
"""

from __future__ import annotations

import time as _time
from collections import deque

import numpy as np
import torch

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory


def _stack64(xs):
    """0-d tensors (any float dtypes) as one f64 vector, one stack per
    dtype (f32 values convert exactly), and the index in xs of each of
    its entries.  The order is undone on the host: an index tensor sent
    to the device would wait for it."""
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    parts = [torch.stack([xs[i] for i in idx]).to(torch.float64)
             for idx in groups.values()]
    order = [i for idx in groups.values() for i in idx]
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), order


class _Rows:
    """Rows of a file whose numbers are on the device.  push() stacks a
    row's 0-d tensors and starts their copy into pinned host memory
    without waiting (a CUDA event marks its end); a row is written, in
    order, once its copy is done: at a later push or at drain().  On the
    CPU the row is written at once."""

    def __init__(self):
        self.pending = deque()

    def push(self, values, write):
        """write(list of floats, in the order of `values`) formats and
        writes the row."""
        dev, order = _stack64(values)
        if dev.device.type != "cuda":
            self._write(dev, order, write)
            return
        host = torch.empty(dev.shape, dtype=torch.float64, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self.pending.append((host, order, done, write))
        self.drain(wait=False)

    def drain(self, wait=True):
        while self.pending:
            host, order, done, write = self.pending[0]
            if not (wait or done.query()):
                return
            done.synchronize()
            self.pending.popleft()
            self._write(host, order, write)

    @staticmethod
    def _write(vec, order, write):
        row = [0.0] * len(order)
        for k, v in zip(order, vec.tolist()):
            row[k] = v
        write(row)


class _FileWriter(PluginBase):
    """A writer of one file of rows: opened with its header in init;
    finish writes the rows still in flight and closes it; a later run()
    of the same driver opens it again for appending (the JAX package's
    writers fail there)."""

    suffix = ""

    def _open(self, header: str):
        self._path = f"{self.output_prefix}{self.suffix}"
        self._rows = _Rows()
        self._f = open(self._path, "w")
        self._f.write(header)

    def _write(self, line: str):
        if self._f.closed:
            self._f = open(self._path, "a")
        self._f.write(line)
        self._f.flush()

    def finish(self, sim):
        self._rows.drain()
        self._f.close()


class _Accumulator:
    """Sliding-window average over the last `window` values
    (src/utils/Accumulator.h analogue) held on the device.  A step only
    keeps a reference to its 0-d value (no launch, no read); the values
    are stacked into the f64 window when the average is asked for, at
    the write frequency."""

    def __init__(self, window: int, device):
        self.window = window
        self.hist = torch.zeros(0, dtype=torch.float64, device=device)
        self.pending = []

    def add(self, v: torch.Tensor):
        self.pending.append(v)
        if len(self.pending) >= self.window:
            self._fold()

    def _fold(self):
        if self.pending:
            new = torch.stack(self.pending).to(torch.float64)
            self.hist = torch.cat([self.hist, new])[-self.window:]
            self.pending = []

    def average(self) -> torch.Tensor:
        self._fold()
        if not len(self.hist):
            return torch.zeros((), dtype=torch.float64, device=self.hist.device)
        return self.hist.sum() / len(self.hist)


@PluginFactory.register("ResultWriter")
class ResultWriter(_FileWriter):
    """Global U/p/T/beta time series -> <prefix>.res
    (src/io/ResultWriter.cpp:32-85)."""

    suffix = ".res"

    def init(self, sim):
        self._u_acc = _Accumulator(1000, sim.device)
        self._p_acc = _Accumulator(1000, sim.device)
        cols = ["# step", "time", "U_pot", "U_pot_avg", "p", "p_avg",
                "beta_trans", "beta_rot", "c_v", "N"]
        # the JAX package's header lines, kept byte-identical
        self._open(
            f"# ls1 MarDyn (TPU) simulation started at {_time.ctime()}\n"
            "# Averages are accumulated over 1000 time steps.\n"
            + " ".join(f"{c:>16}" for c in cols) + "\n"
        )

    def end_step(self, sim, step):
        gv = sim.last_globals
        if gv is None:
            return
        # whatever gv holds on this step, as the JAX writer averages it
        self._u_acc.add(gv.upot)
        self._p_acc.add(gv.pressure)
        if step % self.write_frequency:
            return
        # c_v from the driver's device-held Upot sums, as of this step
        cv_terms, cv_samples = sim.cv_terms()
        t = float(sim.time)

        def write(got):
            u, ua, p, pa, bt, br, n = got[:7]
            cv = sim.cv_value(cv_samples, *got[7:])
            vals = [t, u, ua, p, pa, bt, br, cv, int(n)]
            self._write(
                f"{step:>10} " + " ".join(f"{v:>16.9e}" if not isinstance(v, int)
                                          else f"{v:>16}" for v in vals) + "\n"
            )

        self._rows.push([gv.upot, self._u_acc.average(), gv.pressure,
                         self._p_acc.average(), gv.beta_trans, gv.beta_rot,
                         gv.n, *cv_terms], write)

    def finish(self, sim):
        self._rows.drain()
        self._write(f"# simulation finished at {_time.ctime()}\n")
        self._f.close()


@PluginFactory.register("EnergyLogWriter")
class EnergyLogWriter(_FileWriter):
    """Global energy log -> <prefix>.elog (src/io/EnergyLogWriter.cpp):
    N, U_pot, U_kinTrans, U_kinRot, T, p per written step."""

    suffix = ".elog"

    def init(self, sim):
        self._open("#step\tN\tU_pot\tU_kinTrans\tU_kinRot\tT\tp\n")

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        gv = sim.last_globals
        if gv is None:
            return

        def write(got):
            n, u, mv2, iw2, t, p = got
            self._write(
                f"{step}\t{int(n)}\t{u:.10e}\t"
                f"{0.5 * mv2:.10e}\t{0.5 * iw2:.10e}\t"
                f"{t:.10e}\t{p:.10e}\n"
            )

        self._rows.push([gv.n, gv.upot, gv.summv2, gv.sum_iw2,
                         gv.temperature, gv.pressure], write)


def _text_column(a: np.ndarray) -> list:
    """Each value as numpy prints a scalar of the array's dtype (an f64
    value as repr(float), an f32 one by its own shortest repr): the
    text the JAX package's f-strings give its numpy scalars."""
    if a.dtype == np.float64:
        return [repr(x) for x in a.tolist()]
    return [str(x) for x in a]


@PluginFactory.register("XyzWriter")
class XyzWriter(PluginBase):
    """XYZ trajectory (src/io/XyzWriter.cpp): element guessed from
    component id, positions per frame."""

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        mol = sim.molecules()
        valid = mol.valid.cpu().numpy()
        r = mol.r.detach().cpu().numpy()[valid]
        cid = mol.cid.cpu().numpy()[valid]
        fname = f"{self.output_prefix}.buildup.xyz"
        mode = "a" if getattr(self, "_started", False) else "w"
        self._started = True
        elements = np.array(["Ar", "He", "Xe", "Kr", "Ne"])
        el = elements[cid.astype(np.int64) % len(elements)].tolist()
        x, y, z = (_text_column(r[:, k]) for k in range(3))
        with open(fname, mode) as f:
            f.write(f"{len(r)}\n")
            f.write(f"comment: step {step}\n")
            f.writelines(f"{e} {a} {b} {c}\n" for e, a, b, c in zip(el, x, y, z))


@PluginFactory.register("CheckpointWriter")
class CheckpointWriter(PluginBase):
    """Periodic checkpoints (src/io/CheckpointWriter.cpp); restart by
    pointing <phasespacepoint><file> at the output.  <type>binary</type>
    writes the reference's binary records and <file>.header.xml (the
    JAX package's writer knows only ASCII)."""

    def end_step(self, sim, step):
        if step == 0 or step % self.write_frequency:
            return
        incremental = str(self.params.get("incremental", "true")).lower() in (
            "1", "true", "yes",
        )
        binary = str(self.params.get("type", "ASCII")).lower() == "binary"
        suffix = f"-{step}" if incremental else ""
        sim.write_checkpoint(f"{self.output_prefix}{suffix}.restart.dat",
                             binary=binary)


@PluginFactory.register("MaxWriter")
class MaxWriter(_FileWriter):
    """Max velocity/force magnitudes per output interval
    (src/io/MaxWriter.cpp).  Both maxima are reduced on the device;
    two scalars reach the host."""

    suffix = ".max"

    def init(self, sim):
        self._open("#step\tvmax\tfmax\n")

    @staticmethod
    def _max_norm(x, valid):
        """max |x_i| over the valid entries of the components x = (x, y,
        z), in their dtype as numpy computes sqrt((x * x).sum(axis=1))
        .max() (sqrt is monotone, so the square root of the largest sum
        is the largest root)."""
        s = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
        if not s.numel():
            return s.new_zeros(())
        return torch.sqrt(torch.where(valid, s, 0.0).amax())

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        v, F, valid = sim.velocities_and_forces()
        vals = [self._max_norm(v, valid)]
        if F is not None:
            vals.append(self._max_norm(F, valid))

        def write(got):
            vmax, fmax = got[0], (got[1] if len(got) > 1 else 0.0)
            self._write(f"{step}\t{vmax:.10e}\t{fmax:.10e}\n")

        self._rows.push(vals, write)


@PluginFactory.register("FlopRateWriter")
class FlopRateWriter(_FileWriter):
    """Measured FLOP rate (src/io/FlopRateWriter.cpp +
    adapter/FlopCounter.h:60): a cell traversal (ops/rdf) counts the
    ACTUAL cutoff pairs per component pair on write steps, converts them
    to flops with FlopCounter's per-interaction costs, and divides by
    wall time.  Falls back to the mean-density pair model only if the
    counting traversal's private binning overflows."""

    # flop counts per interaction type (FlopCounter's model)
    FLOPS = {"lj": 30, "charge": 14, "dipole": 98, "quadrupole": 128}
    suffix = ".floprate"

    def init(self, sim):
        self._t0 = _time.time()
        self._open("#step\tFLOP/step(measured)\tGFLOPS\n")
        self._spec = None
        self._overflow = False

    def _count_pairs(self, sim):
        """Exact [K,K] LJ/electrostatic pair counts via
        ops.rdf.pair_count_by_component; None on binning overflow."""
        from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, neighbor_table
        from ls1_mardyn_tpu_torch.ops.rdf import pair_count_by_component

        mol = sim.molecules()
        rc = max(float(sim.config.lj_cutoff), float(sim.config.cutoff))
        box = tuple(float(b) for b in np.asarray(sim.box))
        if self._spec is None or self._overflow:
            # size the cell capacity from the live occupancy (2x margin,
            # multiple of 8); only rebuilt on overflow
            r = mol.r.detach().cpu().numpy()
            valid = mol.valid.cpu().numpy()
            dims = tuple(max(1, int(np.floor(b / rc))) for b in box)
            cl = np.asarray(box) / np.asarray(dims)
            c3 = np.clip(
                (r[valid] / cl).astype(np.int64), 0, np.asarray(dims) - 1,
            )
            lin = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
            occ = np.bincount(lin, minlength=int(np.prod(dims))).max() \
                if valid.any() else 1
            cap = max(8, int(-(-2 * int(occ) // 8) * 8))
            if self._spec is None or cap > self._spec.cap:
                self._spec = CellGridSpec(dims=dims, box=box, cap=cap)
                self._nbr = neighbor_table(self._spec)
        lj, cc, ovf = pair_count_by_component(
            mol.r, mol.valid, mol.cid, self._spec, self._nbr[0], self._nbr[1],
            float(sim.config.lj_cutoff) ** 2, float(sim.config.cutoff) ** 2,
            sim.table.K,
        )
        self._overflow = bool(ovf)
        if self._overflow:
            return None
        return lj.cpu().numpy(), cc.cpu().numpy()

    def _model_pairs(self, sim):
        """Mean-density fallback: [K,K] pair counts from composition."""
        mol = sim.molecules()
        cid = mol.cid.cpu().numpy()
        valid = mol.valid.cpu().numpy()
        K = sim.table.K
        nk = np.array([np.sum(valid & (cid == k)) for k in range(K)], float)
        pairs_kl = np.outer(nk, nk)
        np.fill_diagonal(pairs_kl, nk * (nk - 1))
        pairs_kl *= 0.5
        vol = sim.volume or 1.0

        def frac(rc):
            return (4.0 / 3.0) * np.pi * rc ** 3 / vol

        return (pairs_kl * frac(float(sim.config.lj_cutoff)),
                pairs_kl * frac(float(sim.config.cutoff)))

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        counted = self._count_pairs(sim)
        if counted is None:  # overflow: retry once with the regrown cap
            counted = self._count_pairs(sim)
        lj_kl, cc_kl = counted if counted is not None else self._model_pairs(sim)
        comps = sim.table.components
        nl = np.array([len(c.ljcenters) for c in comps], float)
        nc = np.array([len(c.charges) for c in comps], float)
        nd = np.array([len(c.dipoles) for c in comps], float)
        nq = np.array([len(c.quadrupoles) for c in comps], float)
        # per-pair site-interaction flops, exact per component pair
        # (the 7 potforce.h loop bodies FlopCounter tallies)
        f_lj = np.outer(nl, nl) * self.FLOPS["lj"]
        f_cc = (
            np.outer(nc, nc) * self.FLOPS["charge"]
            + (np.outer(nc, nd) + np.outer(nd, nc) + np.outer(nd, nd))
            * self.FLOPS["dipole"]
            + (np.outer(nc, nq) + np.outer(nq, nc) + np.outer(nd, nq)
               + np.outer(nq, nd) + np.outer(nq, nq))
            * self.FLOPS["quadrupole"]
        )
        flops = float((lj_kl * f_lj).sum() + (cc_kl * f_cc).sum())
        dt = max(_time.time() - self._t0, 1e-9)
        self._write(f"{step}\t{flops:.4e}\t{flops * step / dt / 1e9:.4f}\n")


@PluginFactory.register("TestPlugin")
class TestPlugin(PluginBase):
    """Hook-order canary (src/plugins/TestPlugin.cpp)."""

    def init(self, sim):
        self.calls = []

    def before_event_new_timestep(self, sim, step):
        self.calls.append(("beforeEventNewTimestep", step))

    def before_forces(self, sim, step):
        self.calls.append(("beforeForces", step))

    def after_forces(self, sim, step):
        self.calls.append(("afterForces", step))

    def end_step(self, sim, step):
        self.calls.append(("endStep", step))
