"""Top-level MD driver: XML config -> scene -> step loop -> plugins,
observables and checkpoints (the counterpart of
ls1_mardyn_tpu/driver.py: MDSimulation, its 1CLJ branch).

The reference's Simulation class and main loop (Simulation.cpp:
initConfigXML :675-750, prepare_start :764-918, simulate :920-1202)
with the device executing each step and the host orchestrating
plugins, logging, checkpoints and timers.

Slice 1 runs single-component 1CLJ scenes on the RMM dense engine
(rmm_engine.RMMEngine).  Every scene outside that slice raises
NotImplementedError naming the ROADMAP slice that brings it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData, read_inp, write_inp
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig, read_xml_config
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, adaptive_z_edges
from ls1_mardyn_tpu_torch.ops.lrc import HomogeneousLRC, NoLRC
from ls1_mardyn_tpu_torch.ops.rmm import CellCapacityError
from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine, pick_rmm_grid
from ls1_mardyn_tpu_torch.simulation import SimConfig
from ls1_mardyn_tpu_torch.state import MoleculeState
from ls1_mardyn_tpu_torch.utils.logger import global_log
from ls1_mardyn_tpu_torch.utils.timers import TimerProfiler


def _out_of_slice(what: str, slice_: str):
    return NotImplementedError(
        f"{what} is not ported to ls1_mardyn_tpu_torch yet "
        f"(ROADMAP {slice_}); run it with ls1_mardyn_tpu"
    )


def resolve_device(device) -> torch.device:
    """The run's device.  A CUDA device must exist: nothing falls back
    to the CPU on its own (pass device='cpu' for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev


class MDSimulation:
    """User-facing simulation: build from an XML config (reference
    schema) or assemble programmatically."""

    def __init__(
        self,
        config: XMLConfig,
        dtype: torch.dtype = torch.float32,
        # auto | rmm: both run the RMM dense engine in this slice
        force_mode: str = "auto",
        cell_cap: int = 0,
        phase_space_data: Optional[PhaseSpaceData] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if force_mode not in ("auto", "rmm"):
            raise _out_of_slice(f"force_mode={force_mode!r}", "slice 2/3")
        self.config = config
        self.dtype = dtype
        self._force_mode = force_mode
        self.timers = TimerProfiler()
        for t in (
            "SIMULATION_LOOP",
            "SIMULATION_DECOMPOSITION",
            "SIMULATION_COMPUTATION",
            "SIMULATION_FORCE_CALCULATION",
            "SIMULATION_IO",
        ):
            self.timers.register(t)

        data = (
            phase_space_data
            if phase_space_data is not None
            else self._load_phasespace(config)
        )
        if self._detect_swap_axis(data, config) is not None:
            raise _out_of_slice(
                "a vacuum-dominated scene (engine-frame axis swap)", "slice 2"
            )
        self.phase_space = data
        self.table = ComponentTable(
            data.components,
            mixing_xi=data.mixing_xi,
            mixing_eta=data.mixing_eta,
            eps_rf=config.eps_rf if config.eps_rf else data.eps_rf,
            cutoff=config.cutoff,
            lj_cutoff=config.lj_cutoff,
        )
        if not (
            self.table.K == 1
            and len(self.table.components[0].ljcenters) == 1
            and not self.table.has_electrostatics()
        ):
            raise _out_of_slice(
                "a multi-component, multi-site or polar scene", "slice 3"
            )
        if config.electrostatic_solver == "Ewald":
            raise _out_of_slice("long-range electrostatics", "slice 4")
        if config.longrange.lower() == "planar":
            raise _out_of_slice("the planar long-range correction", "slice 4")
        if config.ensemble_type == "muVT":
            raise _out_of_slice("the muVT ensemble", "slice 5")
        if config.temp_control:
            raise _out_of_slice("TemperatureControl regions", "slice 2")
        if data.component_thermostats or getattr(data, "undirected_thermostats", None):
            raise _out_of_slice(
                "component-wise or undirected thermostats", "slice 2"
            )
        specs = list(config.output_plugins) + list(config.plugins)
        if specs:
            raise _out_of_slice(
                "plugins (%s)" % ", ".join(s.name for s in specs), "slice 6"
            )

        self.pp = PairParams.from_table(self.table, dtype=dtype, device=self.device)
        self.box = np.asarray(data.box, float)
        self.volume = float(np.prod(self.box))
        n = len(data.mid)
        if n == 0:
            raise _out_of_slice("an empty scene", "slice 2")
        self.mol = MoleculeState.from_numpy(
            r=data.r, v=data.v, q=data.q, L=data.L,
            cid=data.cid, mid=data.mid.astype(np.int32),
            dtype=dtype, device=self.device,
        )

        # long-range correction (Simulation.cpp:514-552 longrange switch)
        ncomp = np.bincount(data.cid, minlength=self.table.K)
        if config.longrange.lower() in ("homogeneous", ""):
            self.lrc = HomogeneousLRC(self.table, ncomp, self.volume)
        else:
            self.lrc = NoLRC()

        # container sizing, as the JAX driver measures it: inhomogeneous
        # scenes that would take non-uniform z rows run the general
        # engine there, which this slice does not have
        if not cell_cap:
            dims = np.maximum(
                1, np.floor(self.box * config.cells_in_cutoff /
                            config.lj_cutoff).astype(int)
            )
            cl = self.box / dims
            c3 = np.clip((data.r / cl).astype(int), 0, dims - 1)
            lin = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
            max_occ = int(np.bincount(lin).max())
            mean_occ = n / max(float(np.prod(dims)), 1.0)
            if dims[2] >= 4 and max_occ > 3.0 * max(mean_occ, 1.0):
                min_h = max(config.cutoff, config.lj_cutoff)
                edges = adaptive_z_edges(
                    data.r, self.box, (dims[0], dims[1]), min_h,
                    occ_limit=max_occ,
                )
                if edges and (len(edges) - 1) <= 0.75 * dims[2]:
                    cz = np.clip(
                        np.searchsorted(np.asarray(edges)[1:-1], data.r[:, 2],
                                        side="right"),
                        0, len(edges) - 2,
                    )
                    lin2 = (cz * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
                    occ2 = int(np.bincount(lin2).max())

                    def _cap(occ):
                        return max(32, int(2 ** math.ceil(
                            math.log2(max(1.5 * occ, 8)))))

                    if _cap(occ2) <= _cap(max_occ):
                        raise _out_of_slice(
                            "an inhomogeneous scene (adaptive z rows)", "slice 2"
                        )
        thermo = config.ensemble_type.upper() == "NVT" and (
            config.temperature > 0 or bool(data.thermostat_temps)
        )
        sim_cfg = SimConfig(
            dt=config.timestep,
            target_temperature=config.temperature or data.temperature,
            thermostat=thermo,
            cell_cap=cell_cap or 32,
            upot_corr=self.lrc.upot_corr,
            virial_corr=self.lrc.virial_corr,
        )
        self._plugins = []

        # -- RMM dense engine (the VCP1CLJRMM + LeapfrogRMM pipeline,
        # Simulation.cpp:819-854).  An explicit cell_cap (the adaptive
        # re-spec passes the doubled one) is the floor of the grid's
        # capacity; the JAX driver ignores it on this path, so its
        # re-spec cannot raise the capacity of an RMM grid.
        rc = config.lj_cutoff
        dims_r, cap_r = pick_rmm_grid(data.r, self.box, rc, cap=max(32, cell_cap))
        if dims_r is None:
            raise _out_of_slice(
                "a box too small for a >= 4-cell RMM grid", "slice 2"
            )
        spec_r = CellGridSpec(
            dims=dims_r, box=tuple(float(b) for b in self.box), cap=cap_r,
        )
        skin = float(min(spec_r.cell_len)) - rc
        # drift bound per step: ~4 thermal sigmas of the fastest
        # molecules (measured from the start velocities)
        v = np.asarray(data.v, float)
        vq = float(np.quantile(np.linalg.norm(v, axis=1), 0.9999))
        drift = max(vq, 1e-9) * config.timestep
        rebin_every = int(max(1, min(16, skin / (2 * drift))))
        self.engine = RMMEngine(
            self.mol, self.pp, self.table, self.box, sim_cfg,
            spec_r, rebin_every=rebin_every, device=self.device,
        )
        global_log.info(
            "engine: RMM dense fast path on %s, grid %s cap %d "
            "rebin_every %d", self.device, dims_r, cap_r, rebin_every,
        )
        self.last_globals = None
        self.time = float(data.current_time)
        self.step = 0
        for p in self._plugins:
            p.init(self)

    # -- construction helpers ----------------------------------------------
    @classmethod
    def _detect_swap_axis(cls, data, config):
        """Return x or y when it is markedly emptier (row-occupancy-wise)
        than z: the JAX driver swaps such an axis onto z, a general-engine
        feature.  None for homogeneous scenes."""
        n = len(data.mid)
        if n == 0 or config.longrange.lower() == "planar":
            return None
        if config.temp_control:
            return None
        for c in data.components:
            if c.dipoles or c.quadrupoles or c.is_stockmayer:
                return None
            for s in list(c.ljcenters) + list(c.charges):
                if np.any(np.abs(np.asarray(s.r)) > 1e-12):
                    return None
        box = np.asarray(data.box, float)
        rc = max(config.cutoff, config.lj_cutoff)
        if rc <= 0:
            return None
        empties = []
        for a in range(3):
            rows = max(4, int(box[a] / rc))
            hist = np.histogram(data.r[:, a], bins=rows, range=(0, box[a]))[0]
            empties.append((hist == 0).mean())
        best = int(np.argmax(empties))
        if best != 2 and empties[best] > max(0.5, empties[2] + 0.25):
            return best
        return None

    @staticmethod
    def from_xml(path: str, **kw) -> "MDSimulation":
        return MDSimulation(read_xml_config(path), **kw)

    def _load_phasespace(self, cfg: XMLConfig) -> PhaseSpaceData:
        if cfg.phasespace_file:
            if cfg.phasespace_file_type.upper() != "ASCII":
                raise _out_of_slice(
                    f"phasespacepoint type {cfg.phasespace_file_type}", "slice 6"
                )
            data = read_inp(cfg.phasespace_file)
            if cfg.components:
                # XML components override the file header's
                data.components = cfg.components
                data.mixing_xi = cfg.mixing_xi
                data.mixing_eta = cfg.mixing_eta
            if cfg.box is not None and (cfg.box > 0).all():
                data.box = cfg.box
            return data
        if cfg.generator is not None:
            p = cfg.generator.params
            comps = cfg.components or None
            name = cfg.generator.name
            if name == "CubicGridGenerator":
                rho = float(p.get("density", 0.5))
                n = int(float(p.get("numMolecules", 0)) or rho * np.prod(cfg.box))
                return cubic_grid(n, cfg.box, cfg.temperature, components=comps)
            raise _out_of_slice(f"generator {name}", "slice 6")
        raise ValueError("config has neither phasespacepoint file nor generator")

    # -- plugin-facing accessors -------------------------------------------
    def molecules(self) -> MoleculeState:
        return self.engine.mol

    def _export_phasespace(self) -> PhaseSpaceData:
        """Current device state -> PhaseSpaceData (the in-memory
        snapshot used by checkpoints and the adaptive re-spec)."""
        mol = self.molecules()
        valid = mol.valid.cpu().numpy()

        def host(x):
            return x.detach().cpu().numpy()[valid]

        return PhaseSpaceData(
            components=self.table.components,
            mixing_xi=self.table.mixing_xi,
            mixing_eta=self.table.mixing_eta,
            eps_rf=self.table.eps_rf,
            box=self.box,
            # the EFFECTIVE target (scenes whose target came from the
            # phase-space file have config.temperature == 0)
            temperature=(
                self.config.temperature
                or float(self.engine.config.target_temperature)
            ),
            current_time=self.time,
            mid=host(mol.mid).astype(np.int64),
            cid=host(mol.cid),
            r=host(mol.r).astype(np.float64),
            v=host(mol.v).astype(np.float64),
            q=host(mol.q).astype(np.float64),
            L=host(mol.L).astype(np.float64),
        )

    def _respec_cell_cap(self, new_cap: int):
        """Adaptive container re-specification: rebuild the cell grid
        and engine with a larger capacity, carrying the current molecule
        state over, and resume (forces are recomputed exactly at the
        current positions, so the trajectory is unchanged)."""
        global_log.warning(
            "cell capacity exceeded at step %d: re-spec cell_cap -> %d "
            "and resume", self.step, new_cap,
        )
        data = self._export_phasespace()
        rebuilt = MDSimulation(
            self.config, dtype=self.dtype, force_mode=self._force_mode,
            cell_cap=new_cap, phase_space_data=data, device=self.device,
        )
        self.engine = rebuilt.engine
        self.engine._step_count = self.step
        self.engine.prepare_start()

    def write_checkpoint(self, path: str):
        """ASCII .inp checkpoint, compatible with the reference's format."""
        data = self._export_phasespace()
        with self.timers["SIMULATION_IO"]:
            write_inp(path, data)
        global_log.info("wrote checkpoint %s (N=%d)", path, len(data.mid))

    # -- main loop (Simulation::simulate, Simulation.cpp:920-1202) ----------
    def run(
        self,
        steps: Optional[int] = None,
        print_every: int = 100,
        final_checkpoint: Optional[str] = None,
    ):
        steps = steps if steps is not None else self.config.steps
        self.total_steps = steps
        eng = self.engine
        if not eng.started:
            with self.timers["SIMULATION_FORCE_CALCULATION"]:
                eng.prepare_start()
        loop_timer = self.timers["SIMULATION_LOOP"]
        loop_timer.start()
        self.run_abort = False
        # NaN watchdog cadence: decoupled from print_every (a readback
        # syncs the device, so per-step checking would stall the queue)
        check_every = min(print_every, 100) if print_every else 100
        # macro (Upot/virial) cadence: the kernel skips the energy and
        # virial sums on steps nobody reads
        plugin_freqs = sorted(
            {max(1, int(getattr(p, "write_frequency", 1)))
             for p in self._plugins}
        )
        for k in range(1, steps + 1):
            self.step += 1
            for p in self._plugins:
                p.before_event_new_timestep(self, self.step)
                p.before_forces(self, self.step)
            need_macro = (
                k == steps
                or (print_every and self.step % print_every == 0)
                or self.step % check_every == 0
                or any(self.step % f == 0 for f in plugin_freqs)
            )
            try:
                gv = eng.advance(need_macro)
            except CellCapacityError:
                # adaptive re-spec instead of aborting; the engine left
                # its state untouched, so nothing is lost
                cap = eng.config.cell_cap
                if cap >= 2048:
                    raise RuntimeError(
                        "cell capacity exceeded at cap=%d; giving up" % cap
                    )
                self._respec_cell_cap(2 * cap)
                eng = self.engine
                gv = eng.advance(need_macro)
            self.last_globals = gv
            self.time += self.config.timestep
            for p in self._plugins:
                p.after_forces(self, self.step)
                p.end_step(self, self.step)
            if print_every and self.step % print_every == 0:
                # per-step summary line (Simulation.cpp:1231-1234)
                global_log.info(
                    "Simstep = %d\tT = %g\tU_pot = %g\tp = %g",
                    self.step,
                    float(gv.temperature),
                    float(gv.upot),
                    float(gv.pressure),
                )
            if self.step % check_every == 0 or k == steps:
                # NaN watchdog (Simulation.cpp:1236-1239)
                if not (
                    np.isfinite(float(gv.upot))
                    and np.isfinite(float(gv.temperature))
                ):
                    raise RuntimeError(
                        f"NaN/Inf detected at step {self.step} "
                        f"(T={float(gv.temperature)}, "
                        f"Upot={float(gv.upot)}); aborting"
                    )
            if self.run_abort:
                global_log.info("run aborted by plugin at step %d", self.step)
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        loop_timer.stop()
        for p in self._plugins:
            p.finish(self)
        if final_checkpoint:
            self.write_checkpoint(final_checkpoint)
        # speed report (MarDyn.cpp:262-270)
        el = max(loop_timer.elapsed, 1e-12)
        n = int(float(self.last_globals.n)) if self.last_globals else 0
        global_log.info(
            "Simulation loop took: %.3f s (%.3f steps/s)", el, steps / el
        )
        global_log.info("Molecule-updates per second: %.3e", n * steps / el)
        global_log.info("\n%s", self.timers.report())
        return self.last_globals
