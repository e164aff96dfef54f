"""Top-level MD driver: XML config -> scene -> step loop -> plugins,
observables and checkpoints (the counterpart of
ls1_mardyn_tpu/driver.py: MDSimulation).

The reference's Simulation class and main loop (Simulation.cpp:
initConfigXML :675-750, prepare_start :764-918, simulate :920-1202)
with the device executing each step and the host orchestrating
plugins, logging, checkpoints and timers.

Two engines: single-component 1CLJ scenes run the RMM dense engine
(rmm_engine.RMMEngine, kernels K1/K2); everything else, and every scene
under force_mode "pallas", "ms_packed", "ms_dense" or "cells", runs the
general single-device engine (simulation.SingleChipSimulation) with one
of four force paths: the 1CLJ cell kernels K3/K4 (ops/lj_path.CudaLJPath),
the multi-site kernels K5 (occupancy-packed rows,
ops/cuda_ms_packed.CudaMultiSitePackedPath) and K6 (dense cap-padded
rows, ops/ms_path.CudaMultiSitePath) for multi-component, multi-site and
polar scenes and for 1CLJ scenes on non-uniform z rows, the N^2 oracle
sweep for small scenes with huge cutoffs, or the plain general
multi-site cell traversal ("cells").

Long-range electrostatics (`<electrostatic type="Ewald">`: direct Ewald,
SPME or the periodic FMM, ops/ewald.py, ops/pme.py, ops/fmm.py) and the
planar slab correction (ops/lrc_planar.py) enter through the general
engine's extra-force hook, so such a scene never takes the RMM engine;
Ewald and SPME also turn on the erfc screening of every pair path.

Plugins are built from the config before the engine and initialised
after it; a plugin that is not RMM-safe keeps a 1CLJ scene on the
general engine, and a plugin's siteWiseForces contribution (Mirror type
2, WallPotential) enters the general engine's extra force, summed before
the long-range ones.  The muVT ensemble (ensemble/grand_canonical.py)
runs on the general engine with reserve slots for insertions; its cycle
runs after the step's forces and before the plugins' afterForces hooks.
The observer plugins of a later slice raise NotImplementedError naming
the ROADMAP slice that brings them.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time as _time
from typing import Optional, Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ensemble.grand_canonical import (
    GrandCanonicalEnsemble,
    _build_chemical_potentials,
)
from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData, read_inp, write_inp
from ls1_mardyn_tpu_torch.io.generators import (
    cubic_grid,
    mkesfera,
    mktcts,
    multi_object,
    per_cell,
)
from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig, read_xml_config
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.models.oracle import compute_forces_n2
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, adaptive_z_edges
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
    CudaMultiSitePackedPath,
    pick_ms_grid_packed,
)
from ls1_mardyn_tpu_torch.ops.ewald import EwaldParams, EwaldSolver
from ls1_mardyn_tpu_torch.ops.fmm import FMMElectrostatics
from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
from ls1_mardyn_tpu_torch.ops.lrc import HomogeneousLRC, NoLRC
from ls1_mardyn_tpu_torch.ops.lrc_planar import PlanarLRC
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath, pick_ms_grid
from ls1_mardyn_tpu_torch.ops.pme import PMEParams, PMESolver
from ls1_mardyn_tpu_torch.ops.rmm import CellCapacityError
from ls1_mardyn_tpu_torch.ops.thermostat import TemperatureControlRegion
from ls1_mardyn_tpu_torch.plugins import PluginFactory
from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine, pick_rmm_grid
from ls1_mardyn_tpu_torch.simulation import SimConfig, SingleChipSimulation
from ls1_mardyn_tpu_torch.state import MoleculeState, resolve_device
from ls1_mardyn_tpu_torch.utils.logger import global_log
from ls1_mardyn_tpu_torch.utils.timers import TimerProfiler

_FORCE_MODES = ("auto", "pallas", "ms_packed", "ms_dense", "cells", "rmm")
# scenes up to this size may run the N^2 oracle sweep
_N2_MAX = 16384


def _cap_for(occ: int) -> int:
    """Cell capacity for a measured max occupancy: 1.5x drift headroom,
    rounded up to a power of two, at least 32."""
    return max(32, int(2 ** math.ceil(math.log2(max(1.5 * occ, 8)))))


# the plugins of the JAX package's registry that this package does not
# register yet (ROADMAP slice 6b, the observers): a config naming one is
# refused
LATER_PLUGINS = frozenset({
    "CommunicationPartnerWriter", "DecompWriter", "DirectedPM",
    "DomainProfiles", "ExamplePlugin", "GammaWriter", "HaloParticleWriter",
    "KDTreePrinter", "LoadbalanceWriter", "MPICheckpointWriter",
    "MmpldWriter", "MmspdBinWriter", "MmspdWriter", "ODF", "Permittivity",
    "PovWriter", "RDF", "RegionSampling", "SpatialProfile", "SteereoControl",
    "VISWriter", "VTKGridWriter", "VTKMoleculeWriter",
})


def _out_of_slice(what: str, slice_: str):
    return NotImplementedError(
        f"{what} is not ported to ls1_mardyn_tpu_torch yet "
        f"(ROADMAP {slice_}); run it with ls1_mardyn_tpu"
    )


class _ProfileWindow:
    """torch.profiler trace over a step window (the TaskTimingProfiler /
    PAPI role, src/Simulation.cpp:1249-1254 and src/utils/Timer.h:14-23):
    host and device timelines of the steps after `window[0]` up to
    `window[1]`, written as a Chrome trace ``trace.json`` into the
    directory (view with ui.perfetto.dev).  The device is synchronised
    before the window starts and before it stops, so the trace holds
    exactly its steps' work.  No-op when the directory is None."""

    def __init__(self, trace_dir, window, total_steps, device):
        self.dir = trace_dir
        self.device = device
        a, b = window
        # clamp into the run (short runs still produce a trace)
        if total_steps < b:
            b = total_steps
            a = max(1, b - 5)
        self.start_at, self.stop_at = a, b
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, k):
        if not self.dir:
            return
        if k == self.start_at and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()  # drain queued work so the trace starts clean
            self.prof = profile(activities=acts)
            self.prof.start()
        elif k >= self.stop_at and self.prof is not None:
            self.finish()

    def finish(self):
        if self.prof is None:
            return
        self._sync()  # capture through the last traced step
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        global_log.info("wrote torch.profiler trace to %s", path)


class MDSimulation:
    """User-facing simulation: build from an XML config (reference
    schema) or assemble programmatically."""

    def __init__(
        self,
        config: XMLConfig,
        dtype: torch.dtype = torch.float32,
        # auto | pallas | ms_packed | ms_dense | cells | rmm.  "pallas"
        # keeps the JAX driver's name for "the cell kernels on the
        # general engine" (K3/K4 for 1CLJ, K5/K6 otherwise); ms_packed /
        # ms_dense ask for K5 / K6; here "cells" always runs the general
        # traversal (the JAX driver replaces it by its N^2 sweep up to
        # 16384 molecules)
        force_mode: str = "auto",
        cell_cap: int = 0,
        phase_space_data: Optional[PhaseSpaceData] = None,
        allow_axis_swap: bool = True,
        device="cuda",
        # the adaptive re-spec hands its plugins and its grand-canonical
        # ensemble to the rebuilt driver: they are neither built again
        # nor initialised again
        _plugins: Optional[list] = None,
        _gc: Optional[GrandCanonicalEnsemble] = None,
    ):
        self.device = resolve_device(device)
        if force_mode not in _FORCE_MODES:
            raise ValueError(
                f"force_mode={force_mode!r}: one of {', '.join(_FORCE_MODES)}"
            )
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
        # plugins are built BEFORE the engine (their write cadence and
        # their RMM safety pick it); init(sim) runs after the engine
        # exists, at the end of __init__ (JAX driver.py:654-659, 815-816)
        if _plugins is None:
            self._plugins = self._build_plugins(config)
        else:
            self._plugins = _plugins
        if config.cells_in_cutoff > 1:
            # every traversal reaches +-1 cell only, so cells finer than
            # the cutoff drop pairs (ROADMAP Queue 3: the JAX package
            # does; this driver refuses instead)
            raise ValueError(
                f"cellsInCutoffRadius={config.cells_in_cutoff}: only 1 is "
                "supported (the cell traversals reach one cell)"
            )

        data = (
            phase_space_data
            if phase_space_data is not None
            else self._load_phasespace(config)
        )
        # vacuum-dominated scenes with the inhomogeneity along x or y
        # (a thin y-slab in an elongated box): the adaptive non-uniform
        # rows only exist along z, so swap the emptiest axis onto z in
        # the ENGINE frame.  Only orientation-free scenes (all sites at
        # the molecular origin, no dipoles/quadrupoles) are swap-safe,
        # and checkpoints see the original frame (accessors swap back).
        self._axis_swap = (
            self._detect_swap_axis(data, config) if allow_axis_swap else None
        )
        if self._axis_swap is not None:
            perm = self._swap_perm()
            data = dataclasses.replace(
                data, r=data.r[:, perm], v=data.v[:, perm], L=data.L[:, perm],
                box=np.asarray(data.box, float)[perm],
            )
            global_log.info(
                "engine frame: axis %d swapped onto z (vacuum-dominated "
                "scene; adaptive rows are z-native)", self._axis_swap,
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
        self.pp = PairParams.from_table(self.table, dtype=dtype, device=self.device)
        self.box = np.asarray(data.box, float)
        self.volume = float(np.prod(self.box))
        n = len(data.mid)
        # muVT needs free slots for insertions (the reserve-slot design:
        # insertion activates a masked slot; JAX driver.py:152-161)
        muvt = config.ensemble_type == "muVT"
        self.mol = MoleculeState.from_numpy(
            r=data.r, v=data.v, q=data.q, L=data.L,
            cid=data.cid, mid=data.mid.astype(np.int32),
            capacity=n + max(64, n // 8) if muvt else None,
            dtype=dtype, device=self.device,
        )

        # long-range correction (Simulation.cpp:514-552 longrange switch)
        ncomp = np.bincount(data.cid, minlength=self.table.K)
        self.planar_lrc = None
        if config.longrange.lower() in ("homogeneous", ""):
            self.lrc = HomogeneousLRC(self.table, ncomp, self.volume)
        elif config.longrange.lower() == "planar":
            # Janecek slab correction as per-step forces and energy
            # (Planar.{h,cpp}); the scalar correction terms stay zero
            nslabs = int(float(config.longrange_params.get("slabs", 100)))
            self.planar_lrc = PlanarLRC(
                self.table, self.box, nslabs=nslabs, axis=1, dtype=dtype,
                device=self.device,
            )
            self.lrc = NoLRC()
        else:
            self.lrc = NoLRC()

        # container sizing: measure the actual max cell occupancy of the
        # initial state (mean-density heuristics underestimate clustered
        # scenes) and leave drift headroom
        self._z_edges = None
        cap_floor = cell_cap
        # an explicit capacity skips the multi-site grid choosers
        self._cap_forced = bool(cell_cap)
        if not cell_cap:
            cell_cap = self._measure_cell_cap(data, config, n)
        sim_cfg = self._sim_config(data, config, cell_cap)
        # long-range electrostatics: the solver, the real-space screening
        # of every pair path, and (FMM) the charge-free pair tables
        self._screen_alpha = self._build_electrostatics(config, ncomp)
        sim_cfg = dataclasses.replace(sim_cfg, screen_alpha=self._screen_alpha)

        is_1clj = (
            self.table.K == 1
            and len(self.table.components[0].ljcenters) == 1
            and not self.table.has_electrostatics()
        )
        if force_mode == "rmm" and not is_1clj:
            # the RMM engine is the single-component 1CLJ pipeline; any
            # other scene must not slide onto another path unasked
            raise ValueError(
                "force_mode='rmm' needs a single-component 1CLJ scene "
                "(force_mode='cells' runs this one on the plain general "
                "traversal)"
            )
        rmm_safe = all(
            type(p).__name__ in self._RMM_SAFE_PLUGINS
            or getattr(p, "name", "") in self._RMM_SAFE_PLUGINS
            for p in self._plugins
        )
        if force_mode == "rmm" and muvt:
            raise ValueError(
                "force_mode='rmm': the muVT ensemble inserts into and deletes "
                "from the flat state, which the RMM engine does not keep "
                "(auto runs this scene on the general engine)")
        if force_mode == "rmm" and not rmm_safe:
            raise ValueError(
                "force_mode='rmm': plugin(s) %s write the state or need "
                "per-molecule data the RMM engine does not keep (auto runs "
                "this scene on the general engine)" % ", ".join(
                    p.name for p in self._plugins
                    if p.name not in self._RMM_SAFE_PLUGINS)
            )
        force_fn = self._pick_force_fn(data, config, cell_cap, n, is_1clj)
        extra = self._extra_force_fn()

        # -- RMM dense engine (the VCP1CLJRMM + LeapfrogRMM pipeline,
        # Simulation.cpp:819-854): single-component 1CLJ scenes run on
        # the dense cell layout (verlet-skin rebin cadence, kernels
        # K1/K2); CudaLJPath re-bins the whole system with a global sort
        # EVERY step.  "auto" upgrades exactly the scenes the cell
        # kernel path would have taken; "rmm" forces it.  An explicit
        # cell_cap (the adaptive re-spec passes the doubled one) is the
        # floor of the grid's capacity.
        self.engine = None
        rmm_ok = (
            is_1clj
            and not self._z_edges
            and (
                force_mode == "rmm"
                or (force_mode == "auto" and isinstance(force_fn, CudaLJPath))
            )
            # long-range forces (Ewald/PME/FMM, the planar correction)
            # need the general engine's extra-force hook
            and extra is None
            and sim_cfg.component_thermostat is None
            and not sim_cfg.undirected_thermostats
            and not sim_cfg.temp_control_regions
            and n > 0
            and rmm_safe
            and not muvt
        )
        if rmm_ok:
            rc = config.lj_cutoff
            dims_r, cap_r = pick_rmm_grid(
                data.r, self.box, rc, cap=max(32, cap_floor))
            rmm_ok = dims_r is not None
        if rmm_ok:
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
        else:
            self.engine = SingleChipSimulation(
                self.mol, self.pp, self.box, sim_cfg, force_fn=force_fn,
                extra_force_fn=extra,
            )
            global_log.info(
                "engine: general single-device engine on %s, grid %s cap %d",
                self.device, self.engine.spec.dims, self.engine.spec.cap,
            )
        if isinstance(self.ewald, FMMElectrostatics):
            # a leaf beyond its capacity raises here, before any step
            self.ewald.validate(self.mol, self.pp)
        # muVT: grand-canonical moves after the step's forces
        self.gc = _gc
        if muvt and _gc is None:
            self.gc = GrandCanonicalEnsemble(
                self._chemical_potentials(config), config.temperature,
                self.box, device=self.device)
        self.last_globals = None
        self.time = float(data.current_time)
        self.step = 0
        # heat-capacity sampling (Domain::record_cv, Domain.cpp:779-798),
        # gated on <equilibration><steps> (Simulation.cpp:196 +
        # CanonicalEnsemble.cpp:211-215).  Per-step Upot values stay on
        # the device and are folded, at the watchdog cadence, into f64
        # sums [sum U, sum U^2] that stay there too.
        self._cv_sums = None
        self._cv_n = 0
        self._cv_win = []
        if _plugins is None:
            for p in self._plugins:
                p.init(self)

    # plugins known to be frame-agnostic (they read state via
    # molecules()/write_checkpoint, which un-swap); anything else blocks
    # the axis swap (JAX driver.py:825-833)
    _SWAP_SAFE_PLUGINS = {
        "ResultWriter", "CheckpointWriter", "XyzWriter",
        "EnergyLogWriter", "MaxWriter", "SysMonOutput", "TimerWriter",
        "FlopRateWriter", "TestPlugin", "ExamplePlugin",
        "SteereoControl", "MaxCheck",
    }

    # plugins compatible with the RMM dense engine: observers that read
    # state via molecules()/engine.mol at their own write cadence (the
    # property gathers the dense planes on demand) and mutate it at most
    # rarely (the mol setter re-bins).  Per-step mutators (MaxCheck) and
    # the pair counter of FlopRateWriter keep the general engine (JAX
    # driver.py:835-847).
    _RMM_SAFE_PLUGINS = {
        "ResultWriter", "CheckpointWriter", "XyzWriter",
        "EnergyLogWriter", "MaxWriter", "SysMonOutput", "TimerWriter",
        "TestPlugin", "ExamplePlugin", "SteereoControl",
        "MmpldWriter", "MmspdWriter", "MmspdBinWriter", "PovWriter",
        "VISWriter", "VTKMoleculeWriter", "InMemoryCheckpointing",
    }

    @staticmethod
    def _build_plugins(config) -> list:
        """The config's plugins, in config order.  A plugin of the JAX
        package's registry that this package does not register yet
        raises; a name neither package knows is logged and ignored, as
        in the JAX driver."""
        plugins = []
        for spec in list(config.output_plugins) + list(config.plugins):
            if spec.name in LATER_PLUGINS:
                raise _out_of_slice(f"plugin {spec.name}", "slice 6b")
            try:
                plugins.append(PluginFactory.create(spec.name, spec.params))
            except KeyError:
                global_log.warning("ignoring unknown plugin %r", spec.name)
        return plugins

    # -- construction helpers ----------------------------------------------
    def _measure_cell_cap(self, data, config, n: int) -> int:
        """Cell capacity from the start state's max occupancy; adopts
        non-uniform z rows (self._z_edges) for inhomogeneous scenes."""
        dims = np.maximum(
            1, np.floor(self.box / config.lj_cutoff).astype(int)
        )
        cl = self.box / dims
        c3 = np.clip((data.r / cl).astype(int), 0, dims - 1)
        lin = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
        max_occ = int(np.bincount(lin).max()) if n else 8
        # inhomogeneous scenes (vapor-dominated: evaporation, droplets,
        # two-phase slabs): non-uniform z rows (ops/cells.adaptive_z_edges)
        # collapse sparse regions into few wide rows -- fewer cells at
        # unchanged capacity is a direct compute cut (the dense design's
        # cost is cells x cap^2)
        mean_occ = n / max(float(np.prod(dims)), 1.0) if n else 1.0
        if n and dims[2] >= 4 and max_occ > 3.0 * max(mean_occ, 1.0):
            min_h = max(config.cutoff, config.lj_cutoff)
            edges = adaptive_z_edges(
                data.r, self.box, (dims[0], dims[1]), min_h, occ_limit=max_occ,
            )
            if edges and (len(edges) - 1) <= 0.75 * dims[2]:
                cz = np.clip(
                    np.searchsorted(np.asarray(edges)[1:-1], data.r[:, 2],
                                    side="right"),
                    0, len(edges) - 2,
                )
                lin2 = (cz * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
                occ2 = int(np.bincount(lin2).max())
                # adopt when the POWER-OF-2 CAPACITY doesn't grow
                # (forced min-height rows can beat the uniform max
                # occupancy by lattice-plane aliasing without changing
                # the capacity class)
                if _cap_for(occ2) <= _cap_for(max_occ):
                    self._z_edges = edges
                    global_log.info(
                        "adaptive z rows: %d non-uniform rows replace %d "
                        "uniform (max cell occupancy %d vs %d, cap %d)",
                        len(edges) - 1, int(dims[2]), occ2, max_occ,
                        _cap_for(occ2),
                    )
                    max_occ = max(max_occ, occ2)
        return _cap_for(max_occ)

    def _sim_config(self, data, config, cell_cap: int) -> SimConfig:
        """SimConfig with the thermostat set-up of the scene."""
        thermo = config.ensemble_type.upper() == "NVT" and (
            config.temperature > 0 or bool(data.thermostat_temps)
        )
        # component-wise thermostats from the .inp header
        # (ASCIIReader.cpp ComponentThermostat/ThermostatTemperature tokens)
        comp_therm = therm_temps = undirected = None
        if data.component_thermostats and data.thermostat_temps:
            K = len(data.components)
            tids = sorted(set(data.component_thermostats.values()))
            remap = {t: i for i, t in enumerate(tids)}
            comp_therm = tuple(
                remap.get(data.component_thermostats.get(c, tids[0]), 0)
                for c in range(K)
            )
            therm_temps = tuple(
                data.thermostat_temps.get(t, config.temperature) for t in tids
            )
            # Undirected flags follow the same id remap
            # (ASCIIReader.cpp:125-129 'Undirected'/'U')
            if data.undirected_thermostats:
                undirected = tuple(
                    t in data.undirected_thermostats for t in tids
                )
        elif data.undirected_thermostats:
            # global thermostat flagged Undirected
            undirected = (True,)
        # TemperatureControl regions (region coords follow the engine
        # frame when an axis swap is active); they REPLACE the global
        # velocity-scaling thermostat (Simulation.cpp:1137-1140)
        tc_regions = ()
        if config.temp_control:
            perm = self._swap_perm() if self._axis_swap is not None else [0, 1, 2]

            def resolve(coords):
                # the literal 'box' anchors a coordinate at the domain
                # edge (TemperatureControl.cpp:105)
                return np.asarray(
                    [self.box[i] if c == "box" else float(c)
                     for i, c in enumerate(coords)]
                )

            tc_regions = tuple(
                TemperatureControlRegion(
                    lower=tuple(resolve(d["lower"])[perm]),
                    upper=tuple(resolve(d["upper"])[perm]),
                    target_temperature=float(d["target_temperature"]),
                    frequency=int(d["frequency"]),
                    exponent=float(d["exponent"]),
                    component=int(d["component"]),
                    nslabs=int(d.get("nslabs", 1)),
                    directions=tuple(d.get("directions", (0, 1, 2))),
                    ramp_start_t=float(d.get("ramp_start_t", 0.0)),
                    ramp_end_t=float(d.get("ramp_end_t", 0.0)),
                    ramp_update_start=int(d.get("ramp_update_start", 0)),
                    ramp_update_stop=int(d.get("ramp_update_stop", 0)),
                    ramp_update_freq=int(d.get("ramp_update_freq", 1)),
                    start=int(d.get("start", 0)),
                    stop=int(d.get("stop", 2**31 - 1)),
                )
                for d in config.temp_control
            )
            thermo = False
        return SimConfig(
            dt=config.timestep,
            target_temperature=config.temperature or data.temperature,
            thermostat=thermo,
            cell_cap=cell_cap,
            upot_corr=self.lrc.upot_corr,
            virial_corr=self.lrc.virial_corr,
            component_thermostat=comp_therm,
            thermostat_temps=therm_temps,
            undirected_thermostats=undirected,
            z_edges=tuple(self._z_edges) if self._z_edges else None,
            temp_control_regions=tc_regions,
        )

    def _pick_force_fn(self, data, config, cell_cap: int, n: int, is_1clj: bool):
        """The general engine's force path: CudaLJPath (kernels K3/K4),
        CudaMultiSitePackedPath (K5) or CudaMultiSitePath (K6), the N^2
        oracle sweep, or None for the built-in general cell traversal.
        A static rule, taken and logged before any launch."""
        force_fn = None
        if n and self._force_mode in ("auto", "pallas", "ms_packed", "ms_dense"):
            spec = CellGridSpec.create(
                tuple(self.box), config.lj_cutoff, cap=cell_cap
            )
            if self._z_edges:
                spec = dataclasses.replace(
                    spec, dims=(spec.dims[0], spec.dims[1],
                                len(self._z_edges) - 1),
                    z_edges=tuple(self._z_edges))
            # cost-based path choice (the TraversalTuner role,
            # src/particleContainer/TraversalTuner.h:135): tiny dense
            # scenes with huge cutoffs (3x3x3 cells at cap 256) make the
            # dense cell kernel evaluate far more candidate lanes
            # (27 cap^2 a cell) than the N^2 sweep touches pairs
            kernel_pairs = spec.n_cells * 27 * spec.cap * spec.cap
            rc_any = max(config.cutoff, config.lj_cutoff)
            n2_pairs = n * n * (27 if rc_any > min(self.box) / 2 else 1)
            if n <= _N2_MAX and n2_pairs * 2 < kernel_pairs:
                global_log.info(
                    "force path: N^2 beats the cell kernel here "
                    "(%.2g vs %.2g candidate pairs)", n2_pairs, kernel_pairs,
                )
            elif is_1clj and not self._z_edges:
                force_fn = CudaLJPath(self._table_pair, spec)
                global_log.info(
                    "force path: 1CLJ cell kernel (%s), grid %s cap %d",
                    "cell-window K3" if force_fn.cw else "row K4",
                    spec.dims, spec.cap,
                )
            else:
                force_fn = self._multisite_path(data, config, spec)
        if force_fn is None and (
            n == 0 or (self._force_mode != "cells" and n <= _N2_MAX)
        ):
            # small-N fallback: chunked N^2 oracle (the
            # LegacyCellProcessor role).  Small scenes with huge cutoffs
            # blow the cell-pair paths' cap^2 memory; the minimum-image
            # N^2 sweep is both exact and cheap at this size.
            images = (
                27 if max(config.cutoff, config.lj_cutoff) > min(self.box) / 2
                else 1
            )
            pp, box, sa = self._pp_pair, self.box, self._screen_alpha

            def force_fn(mol, _images=images):
                f, m = compute_forces_n2(mol, pp, box, images=_images,
                                         screen_alpha=sa)
                return f, m, torch.zeros((), dtype=torch.bool, device=mol.r.device)

            global_log.info(
                "force path: N^2 oracle sweep (N=%d, images=%d)", n, images
            )
        elif force_fn is None:
            global_log.info("force path: general multi-site cell traversal")
        return force_fn

    def _build_electrostatics(self, config, ncomp) -> float:
        """The long-range electrostatics solver (self.ewald) of an Ewald
        config with charged components (JAX driver.py:337-462); returns
        the real-space screening alpha of the pair paths (0 without a
        solver, and under the FMM, which owns all Coulomb work).

        ewald_method: "direct" (EwaldSolver), "pme" (PMESolver), "fmm"
        (FMMElectrostatics; the pair paths run LJ only on a charge-free
        copy of the tables) or "auto": SPME once N_sites * K > 2e8, the
        JAX package's crossover (its direct k-space costs O(N_sites * K),
        the mesh O(N_sites p^3 + G^3 log G))."""
        self.ewald = None
        self._table_pair, self._pp_pair = self.table, self.pp
        if not (config.electrostatic_solver == "Ewald"
                and self.table.has_electrostatics()):
            return 0.0
        # Kolafa-Perram tuning from the charge content
        q2_sum = sum(int(ncomp[k]) * sum(s.q ** 2 for s in c.charges)
                     for k, c in enumerate(self.table.components))
        n_q = sum(int(ncomp[k]) * len(c.charges)
                  for k, c in enumerate(self.table.components))
        eparams = EwaldParams.tune(self.box, config.cutoff, q2_sum, n_q,
                                   accuracy=config.ewald_accuracy)
        method = config.ewald_method
        dev, dtype = self.device, self.dtype
        if method == "fmm":
            if self._force_mode == "cells":
                raise ValueError(
                    "ewald_method='fmm' needs the pallas/oracle force path "
                    "(force_mode auto); the internal cells path would "
                    "double-count in-cutoff Coulomb"
                )
            if config.fmm_adaptive:
                # the adaptive container is free-space only, and driver
                # scenes are periodic (FastMultipoleMethod.cpp:41-43)
                global_log.warning(
                    "FastMultipoleMethod: <adaptiveContainer> is IGNORED for "
                    "this run (threshold=%d): the adaptive solver "
                    "(ops/fmm_adaptive.AdaptiveFMMSolver) is free-space only "
                    "and driver scenes are periodic; the uniform periodic "
                    "octree runs instead", config.fmm_threshold,
                )
            self.ewald = FMMElectrostatics(
                self.box, self.table, self.pp, n_hint=self.mol.capacity,
                dtype=dtype, order=config.fmm_order, device=dev,
            )
            comps = copy.deepcopy(self.table.components)
            for c in comps:
                c.charges = []
            t = self.table
            self._table_pair = ComponentTable(
                comps, mixing_xi=t.mixing_xi, mixing_eta=t.mixing_eta,
                eps_rf=t.eps_rf, cutoff=t.cutoff, lj_cutoff=t.lj_cutoff,
            )
            self._pp_pair = PairParams.from_table(self._table_pair, dtype=dtype,
                                                  device=dev)
            global_log.info(
                "electrostatics: solid-harmonics FMM depth=%d order=%d cap=%d "
                "(pair path runs LJ only)", self.ewald.depth,
                self.ewald.solver.order, self.ewald.solver.cap,
            )
            return 0.0
        if method == "auto":
            K = 4.0 / 3.0 * np.pi * eparams.kmax ** 3
            nsites = self.mol.capacity * int(self.pp.charge_q.shape[1])
            method = "pme" if nsites * K > 2e8 else "direct"
        if method == "pme":
            pparams = PMEParams.tune(self.box, config.cutoff, q2_sum, n_q,
                                     accuracy=config.ewald_accuracy)
            self.ewald = PMESolver(self.box, pparams, dtype=dtype, device=dev)
            global_log.info("electrostatics: SPME alpha=%.4f grid=%s order=%d",
                            pparams.alpha, pparams.grid, pparams.order)
            return pparams.alpha
        if method != "direct":
            raise ValueError(
                f"ewald_method={method!r}: one of auto, direct, pme, fmm")
        self.ewald = EwaldSolver(self.box, eparams, dtype=dtype, device=dev)
        global_log.info("electrostatics: Ewald alpha=%.4f kmax=%d (%d k-vectors)",
                        eparams.alpha, eparams.kmax, self.ewald.kvec.shape[0])
        return eparams.alpha

    def _extra_force_fn(self):
        """The sum of the extra forces under the contract (mol, pp) ->
        (u, F, M), or None: the plugins' siteWiseForces contributions,
        then the long-range solver and the planar correction, in the JAX
        driver's order (driver.py:668-696)."""
        fns = []
        for p in self._plugins:
            fn = p.site_wise_forces_fn(self.table, self.box)
            if fn is not None:
                fns.append(fn)
        if self.ewald is not None:
            fns.append(self.ewald)
        if self.planar_lrc is not None:
            planar = self.planar_lrc

            def planar_extra(mol, pp):
                F, M, u, _vir = planar.forces_torques(mol)
                return u, F, M

            fns.append(planar_extra)
        if not fns:
            return None
        if len(fns) == 1:
            return fns[0]

        def extra(mol, pp, _fns=tuple(fns)):
            u, F, M = _fns[0](mol, pp)
            for fn in _fns[1:]:
                ui, Fi, Mi = fn(mol, pp)
                u, F, M = u + ui, F + Fi, M + Mi
            return u, F, M

        return extra

    def _multisite_path(self, data, config, spec: CellGridSpec):
        """The multi-site kernel path (the JAX driver's
        driver.py:538-610): multi-component, multi-site and polar
        scenes, and 1CLJ scenes on non-uniform z rows.  The packed K5
        wherever its rows can run; the dense K6 when asked for
        ("ms_dense"), on non-uniform z rows unless K5 is asked for, and
        on a grid below 3 cells on an axis, which the packed rows' wrap
        halos cannot take.  Each kernel's grid chooser sizes its grid
        unless a cell_cap was given or z rows are non-uniform (the given
        grid runs)."""
        # the cutoff is COM-based for LJ and electrostatics alike: the
        # cells must span the longer of the two
        rc = max(config.cutoff, config.lj_cutoff)
        if min(spec.cell_len) < rc:
            base = CellGridSpec.create(tuple(self.box), rc, cap=spec.cap)
            spec = dataclasses.replace(
                spec, dims=base.dims[:2] + spec.dims[2:]
                if spec.z_edges else base.dims)
        mode = self._force_mode
        use_packed = mode == "ms_packed" or (
            mode != "ms_dense" and not self._z_edges)
        if not self._z_edges and not self._cap_forced:
            pick = pick_ms_grid_packed(data.r, self.box, rc) if use_packed \
                else None
            if pick is None:
                pick = pick_ms_grid(data.r, self.box, rc)
            if pick is not None:
                spec = dataclasses.replace(spec, dims=pick[0], cap=pick[1])
        if use_packed and min(spec.dims) < 3:
            global_log.info(
                "force path: grid %s is below 3 cells on an axis; the "
                "packed rows need 3, the dense kernel runs", spec.dims)
            use_packed = False
        cls = CudaMultiSitePackedPath if use_packed else CudaMultiSitePath
        force_fn = cls(self._table_pair, spec, screen_alpha=self._screen_alpha)
        global_log.info(
            "force path: multi-site kernel %s, grid %s, cap %d, %d planes, "
            "screen_alpha %g",
            "K5 (occupancy-packed)" if use_packed else "K6 (dense)",
            spec.dims, spec.cap,
            force_fn.Pb if use_packed else force_fn.meta.P,
            self._screen_alpha,
        )
        return force_fn

    def _chemical_potentials(self, config):
        """The config's chemical potentials, their control volumes in the
        engine frame: under an axis swap the world-frame bounds are
        permuted like the positions (the JAX driver applies them to the
        engine frame unpermuted: ROADMAP Queue 3)."""
        perm = self._swap_perm() if self._axis_swap is not None else [0, 1, 2]
        world_box = np.asarray(self.box)[perm]  # a transposition
        cps = _build_chemical_potentials(config.chemical_potentials, world_box)
        for cp in cps:
            if cp.control_lower is not None:
                cp.control_lower = np.asarray(cp.control_lower)[perm]
            if cp.control_upper is not None:
                cp.control_upper = np.asarray(cp.control_upper)[perm]
        return cps

    def _swap_perm(self):
        """Column permutation exchanging the swap axis with z."""
        perm = [0, 1, 2]
        perm[self._axis_swap], perm[2] = perm[2], perm[self._axis_swap]
        return perm

    @classmethod
    def _detect_swap_axis(cls, data, config):
        """Pick x or y as the engine z axis when it is markedly emptier
        (row-occupancy-wise) than z itself -- the signal that the
        scene's inhomogeneity is normal to that axis.  None for
        homogeneous scenes."""
        n = len(data.mid)
        if n == 0 or config.longrange.lower() == "planar":
            return None
        # TemperatureControl regions slice slabs along y and thermostat
        # per-direction; an axis permutation would silently change both
        if config.temp_control:
            return None
        for spec in list(config.output_plugins) + list(config.plugins):
            if spec.name not in cls._SWAP_SAFE_PLUGINS:
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
            if cfg.phasespace_file_type.lower() == "binary":
                from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint

                data = read_binary_checkpoint(
                    cfg.phasespace_file,
                    cfg.phasespace_header,
                    components=cfg.components or None,
                    mixing_xi=cfg.mixing_xi,
                    mixing_eta=cfg.mixing_eta,
                    eps_rf=cfg.eps_rf,
                )
                if cfg.box is not None and (cfg.box > 0).all():
                    data.box = cfg.box
                return data
            if cfg.phasespace_file_type.upper() != "ASCII":
                raise NotImplementedError(
                    f"phasespacepoint type {cfg.phasespace_file_type}"
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
            if name in ("MkesferaGenerator", "mkesfera"):
                drop = p.get("droplet")
                radius = (drop.get("radius", p.get("radius", 1.0))
                          if isinstance(drop, dict) else p.get("radius", 1.0))
                return mkesfera(
                    float(radius),
                    float(p.get("density-liquid", p.get("rho_liq", 0.7))),
                    float(p.get("density-vapor", p.get("rho_vap", 0.01))),
                    cfg.box, cfg.temperature, components=comps,
                )
            if name in ("MkTcTSGenerator", "mkTcTS"):
                return mktcts(
                    float(p.get("density-liquid", p.get("rho_liq", 0.7))),
                    float(p.get("density-vapor", p.get("rho_vap", 0.01))),
                    cfg.box, cfg.temperature,
                    liq_fraction=float(p.get("liq_fraction", 0.5)),
                    components=comps,
                )
            if name == "PerCellGenerator":
                return per_cell(
                    int(float(p.get("numMoleculesPerCell", 0))),
                    cfg.box,
                    max(cfg.cutoff, cfg.lj_cutoff),
                    float(p.get("initTemperature", cfg.temperature)),
                    components=comps,
                    generate_at_least_two=str(
                        p.get("generateAtLeastTwoParticles", "true")
                    ).lower() in ("1", "true", "yes"),
                )
            if name in ("MultiObjectGenerator", "ObjectGenerator"):
                return multi_object(
                    p.get("objectgenerator", []), cfg.box, cfg.temperature,
                    comps, base_dir=cfg.config_dir,
                )
            raise NotImplementedError(f"generator {name}")
        raise ValueError("config has neither phasespacepoint file nor generator")

    # -- accessors (always the ORIGINAL frame) -------------------------------
    def molecules(self) -> MoleculeState:
        mol = self.engine.mol
        if self._axis_swap is not None:
            perm = self._swap_perm()
            mol = dataclasses.replace(
                mol, r=mol.r[:, perm], v=mol.v[:, perm], L=mol.L[:, perm]
            )
        return mol

    def forces_array(self):
        if self.engine.forces is None:
            return None
        F = self.engine.forces.F
        if self._axis_swap is not None:
            F = F[:, self._swap_perm()]
        return F

    def velocities_and_forces(self):
        """((vx, vy, vz), (Fx, Fy, Fz), valid): device tensors of one
        shape, for observers that reduce them (MaxWriter).  The RMM
        engine's come straight from its planes (no host round trip), the
        general engine's from its flat state; the forces are None before
        the first force evaluation.  Entries are in the engine's order and
        frame, which norms and maxima do not see."""
        eng = self.engine
        if isinstance(eng, RMMEngine) and eng.sim.state is not None:
            return eng.slot_velocities_forces()
        mol, forces = eng.mol, eng.forces
        F = forces.F.unbind(1) if forces is not None else None
        return mol.v.unbind(1), F, mol.valid

    def _export_phasespace(self) -> PhaseSpaceData:
        """Current device state -> PhaseSpaceData in the ORIGINAL frame
        (the in-memory snapshot used by checkpoints and the adaptive
        re-spec)."""
        mol = self.molecules()
        valid = mol.valid.cpu().numpy()
        box = self.box
        if self._axis_swap is not None:
            # a transposition is its own inverse
            box = np.asarray(box)[self._swap_perm()]

        def host(x):
            return x.detach().cpu().numpy()[valid]

        return PhaseSpaceData(
            components=self.table.components,
            mixing_xi=self.table.mixing_xi,
            mixing_eta=self.table.mixing_eta,
            eps_rf=self.table.eps_rf,
            box=box,
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
            thermostat_temps=self.phase_space.thermostat_temps,
            component_thermostats=self.phase_space.component_thermostats,
            undirected_thermostats=self.phase_space.undirected_thermostats,
        )

    def _respec_cell_cap(self, new_cap: int):
        """Adaptive container re-specification: rebuild the cell grid
        and engine with a larger capacity, carrying the current molecule
        state over, and resume (forces are recomputed exactly at the
        current positions, so the trajectory is unchanged).  The role of
        the reference's dynamic load balancing: in a dense static-shape
        design the quantity that drifts with density is cell
        occupancy."""
        global_log.warning(
            "cell capacity exceeded at step %d: re-spec cell_cap -> %d "
            "and resume", self.step, new_cap,
        )
        data = self._export_phasespace()
        # the rebuilt driver adopts this one's plugins: no second set is
        # built, no file is truncated, and its engine gate still sees them
        kw = dict(dtype=self.dtype, force_mode=self._force_mode,
                  phase_space_data=data, device=self.device,
                  _plugins=self._plugins, _gc=self.gc)
        # re-MEASURE from the current state first (cell_cap=0): this
        # re-runs the axis-swap/adaptive-row detection too, which an
        # explicit cap would skip; only force the doubled cap if
        # measurement made no progress
        rebuilt = MDSimulation(self.config, cell_cap=0, **kw)
        if rebuilt.engine.config.cell_cap <= self.engine.config.cell_cap:
            rebuilt = MDSimulation(self.config, cell_cap=new_cap, **kw)
        # transplant the rebuilt engine and its frame bookkeeping (the
        # accessors translate through self._axis_swap); clock and
        # counters live on self and continue
        self.engine = rebuilt.engine
        self.ewald, self.planar_lrc = rebuilt.ewald, rebuilt.planar_lrc
        self._axis_swap = rebuilt._axis_swap
        self._z_edges = rebuilt._z_edges
        self.box = rebuilt.box
        self.phase_space = rebuilt.phase_space
        self.engine._step_count = self.step
        self.engine.prepare_start()

    def _cap_or_give_up(self) -> int:
        cap = self.engine.config.cell_cap
        if cap >= 2048:
            raise RuntimeError(
                "cell capacity exceeded at cap=%d; giving up" % cap
            )
        return cap

    def _fold_cv(self):
        """The pending Upot samples into the device sums (no read)."""
        if self._cv_win:
            u = torch.stack(self._cv_win).to(torch.float64)
            self._cv_win.clear()
            s = torch.stack([u.sum(), (u * u).sum()])
            self._cv_sums = s if self._cv_sums is None else self._cv_sums + s
            self._cv_n += len(u)

    def cv_terms(self):
        """([sum U, sum U^2, N, T, rot_dof] as 0-d device tensors, number
        of samples): what cv_value needs, with no read; empty before a
        sample or a step."""
        self._fold_cv()
        gv = self.last_globals
        if not self._cv_n or gv is None:
            return [], 0
        return [self._cv_sums[0], self._cv_sums[1], gv.n, gv.temperature,
                gv.rot_dof], self._cv_n

    @staticmethod
    def cv_value(samples, su=0.0, suu=0.0, n=0.0, t=0.0, rot_dof=0.0) -> float:
        """Isochoric heat capacity from post-equilibration U statistics
        (Domain::cv, Domain.cpp:789-798)."""
        if not samples or n <= 0 or t <= 0:
            return 0.0
        ideal = 1.5 + 0.5 * rot_dof / n
        conf = (suu - su**2 / samples) / (samples * n * t * t)
        return ideal + conf

    def cv(self) -> float:
        terms, samples = self.cv_terms()
        if not samples:
            return 0.0
        return self.cv_value(
            samples, *torch.stack([x.double() for x in terms]).tolist())

    def write_checkpoint(self, path: str, binary: bool = False):
        """Checkpoint compatible with the reference's formats: ASCII
        .inp, or the binary record format + XML header when binary=True
        (writes <path> and <path>.header.xml)."""
        data = self._export_phasespace()
        with self.timers["SIMULATION_IO"]:
            if binary:
                from ls1_mardyn_tpu_torch.io.binary_io import write_binary_checkpoint

                write_binary_checkpoint(path, path + ".header.xml", data)
            else:
                write_inp(path, data)
        global_log.info("wrote checkpoint %s (N=%d)", path, len(data.mid))

    # -- main loop (Simulation::simulate, Simulation.cpp:920-1202) ----------
    def run(
        self,
        steps: Optional[int] = None,
        print_every: int = 100,
        final_checkpoint: Optional[str] = None,
        loop_abort_time: float = 0.0,
        timed_checkpoint: float = 0.0,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
    ):
        steps = steps if steps is not None else self.config.steps
        # published for plugins that extrapolate progress
        self.total_steps = steps
        eng = self.engine
        profiler = _ProfileWindow(profile_dir, profile_steps, steps, self.device)
        if not eng.started:
            with self.timers["SIMULATION_FORCE_CALCULATION"]:
                eng.prepare_start()
        t_start = _time.time()
        loop_timer = self.timers["SIMULATION_LOOP"]
        loop_timer.start()
        self.run_abort = False
        # overflow/NaN watchdog cadence: decoupled from print_every (a
        # readback syncs the device, so per-step checking would stall
        # the queue; this bounds the undetected-overflow window instead)
        check_every = min(print_every, 100) if print_every else 100
        # the general engine's per-step overflow flags accumulate as
        # device scalars (no sync) and are read back in ONE stack at
        # each check -- a transient overflow between checks must not
        # vanish (it zeroes forces of the overflowed molecules for that
        # step).  The RMM engine raises CellCapacityError instead, with
        # its state untouched.
        ovf_window = []
        # macro (Upot/virial) cadence: the RMM engine skips the energy
        # and virial sums on steps nobody reads (the general engine
        # computes them every step and ignores the hint)
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
                gv, overflow = eng.advance(need_macro)
            except CellCapacityError:
                self._respec_cell_cap(2 * self._cap_or_give_up())
                eng = self.engine
                gv, overflow = eng.advance(need_macro)
            ovf_window.append(overflow)
            self.last_globals = gv
            profiler.tick(k)
            self.time += self.config.timestep
            if self.step > self.config.equilibration_steps and eng.macro_fresh:
                self._cv_win.append(gv.upot)
            if self.gc is not None:
                eng.mol = self.gc.step(eng.mol, self.pp, self.step)
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
                self._fold_cv()
                # NaN watchdog FIRST: re-spec'ing garbage state would
                # only rebuild and re-crash (Simulation.cpp:1236-1239)
                if not (
                    np.isfinite(float(gv.upot))
                    and np.isfinite(float(gv.temperature))
                ):
                    raise RuntimeError(
                        f"NaN/Inf detected at step {self.step} "
                        f"(T={float(gv.temperature)}, "
                        f"Upot={float(gv.upot)}); aborting"
                    )
                any_ovf = bool(torch.stack(ovf_window).any())
                ovf_window.clear()
                if any_ovf:
                    self._respec_cell_cap(2 * self._cap_or_give_up())
                    eng = self.engine
            if timed_checkpoint and (_time.time() - t_start) > timed_checkpoint:
                # walltime-forced checkpoint (Simulation.cpp:1169-1175)
                self.write_checkpoint("timed.restart.dat")
                global_log.warning(
                    "walltime limit: wrote timed.restart.dat at step %d",
                    self.step,
                )
                break
            if loop_abort_time and (_time.time() - t_start) > loop_abort_time:
                global_log.warning("loop abort time reached at step %d", self.step)
                break
            if self.run_abort:
                global_log.info("run aborted by plugin at step %d", self.step)
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        loop_timer.stop()
        profiler.finish()
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
