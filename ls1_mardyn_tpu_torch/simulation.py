"""The general single-device engine (the counterpart of
ls1_mardyn_tpu/simulation.py: SimConfig, SingleChipSimulation).

The reference's Simulation class (src/Simulation.{h,cpp}): the inner
loop (Simulation::simulate, Simulation.cpp:979-1177) is one function
`_step`:

  upd_preF -> rebin (container update) -> cell-pair forces (+LRC)
  -> upd_postF (kinetic sums) -> global values (T, p, betas)
  -> thermostat

It runs eagerly, op by op, on the device of the state it was given; the
host only triggers steps and reads scalars back at an interval.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.cellforce import compute_forces_cells
from ls1_mardyn_tpu_torch.ops.cells import (
    CellGridSpec,
    bin_particles,
    neighbor_table,
    wrap_positions,
)
from ls1_mardyn_tpu_torch.ops.globals import GlobalValues, calculate_global_values
from ls1_mardyn_tpu_torch.ops.integrator import upd_post_force, upd_pre_force
from ls1_mardyn_tpu_torch.ops.thermostat import (
    apply_temperature_control,
    apply_velocity_scaling,
    apply_velocity_scaling_componentwise,
    apply_velocity_scaling_componentwise_directed,
    directed_kinetic_correction,
    thermostat_directed_velocity,
    thermostat_kinetic_sums,
)
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static per-run configuration."""

    dt: float
    target_temperature: float = 0.0
    thermostat: bool = True  # False => NVE
    cell_cap: int = 64
    cell_chunk: int = 0  # cells per pass of the general traversal (0: budget)
    upot_corr: float = 0.0  # long-range correction (ops/lrc.py)
    virial_corr: float = 0.0
    # component-wise thermostats (Domain.h:424-431): component ->
    # thermostat id, and per-thermostat target temperatures; None =>
    # one global thermostat
    component_thermostat: Optional[Tuple[int, ...]] = None
    thermostat_temps: Optional[Tuple[float, ...]] = None
    # "Undirected" thermostats (ASCIIReader.cpp:125-129 'Undirected'/'U'
    # header token; Domain.h:441-444): per-thermostat flag -- subtract
    # the thermostat's mean (directed) velocity before kinetic sampling
    # and scale only the thermal component, so flows are not
    # thermostatted as heat.  Aligned with thermostat_temps; a 1-tuple
    # applies to the single global thermostat.
    undirected_thermostats: Optional[Tuple[bool, ...]] = None
    # region thermostats (src/thermostats/TemperatureControl.{h,cpp})
    temp_control_regions: Tuple = ()
    # Ewald real-space screening for the built-in cell path
    screen_alpha: float = 0.0
    # non-uniform z rows (ops/cells.py): tuple of nz+1 edges, or None
    # for a uniform grid
    z_edges: Optional[Tuple[float, ...]] = None


class SingleChipSimulation:
    """Single-device simulation (the DomainDecompBase 'alibi
    decomposition' analogue, Simulation.cpp:1354-1356).

    force_fn(mol) -> (Forces, Macroscopic, overflow) replaces the
    built-in general cell traversal; extra_force_fn(mol, pp) ->
    (u_extra, F_extra [N,3], M_extra [N,3]) adds a long-range
    contribution."""

    def __init__(
        self,
        mol: MoleculeState,
        pp: PairParams,
        box,
        config: SimConfig,
        force_fn: Optional[Callable] = None,
        extra_force_fn: Optional[Callable] = None,
    ):
        self.pp = pp
        self.config = config
        self.box = tuple(float(b) for b in np.asarray(box, dtype=np.float64))
        self.spec = CellGridSpec.create(
            self.box, float(torch.sqrt(pp.rc2)), cap=config.cell_cap
        )
        if config.z_edges:
            self.spec = dataclasses.replace(
                self.spec,
                dims=(self.spec.dims[0], self.spec.dims[1],
                      len(config.z_edges) - 1),
                z_edges=tuple(config.z_edges),
            )
        dev = mol.r.device
        nbr_ids, nbr_shift = neighbor_table(self.spec)
        self._nbr_ids = torch.as_tensor(nbr_ids, device=dev)
        self._nbr_shift = torch.as_tensor(nbr_shift, dtype=mol.r.dtype, device=dev)
        self.volume = float(np.prod(self.box))
        self._force_fn = force_fn or self._cell_forces
        self._extra_force_fn = extra_force_fn
        self.mol = mol
        self.forces: Optional[Forces] = None
        self.macro: Optional[Macroscopic] = None
        self._step_count = 0

    # -- step bodies --------------------------------------------------------
    def _cell_forces(self, mol: MoleculeState):
        bins = bin_particles(mol.r, mol.valid, self.spec)
        forces, macro = compute_forces_cells(
            mol, self.pp, self.spec, bins, self._nbr_ids, self._nbr_shift,
            cell_chunk=self.config.cell_chunk,
            screen_alpha=self.config.screen_alpha,
        )
        return forces, macro, bins.overflow

    def _fold_extra(self, mol, forces, macro):
        """Add the long-range extra force (the role of
        FastMultipoleMethod::computeElectrostatics,
        Simulation.cpp:1070-1073) and the long-range correction
        (Simulation.cpp:1048-1049 + Domain's _UpotCorr/_VirialCorr fold,
        Domain.cpp:179-182)."""
        cfg = self.config
        u_x = 0.0
        if self._extra_force_fn is not None:
            u_x, F_x, M_x = self._extra_force_fn(mol, self.pp)
            forces = Forces(F=forces.F + F_x, M=forces.M + M_x, Vi=forces.Vi)
        macro = Macroscopic(
            upot6lj=macro.upot6lj,
            upot_xpoles=macro.upot_xpoles + u_x + cfg.upot_corr,
            virial=macro.virial + cfg.virial_corr,
            my_rf=macro.my_rf,
        )
        return forces, macro

    def _init_forces(self, mol: MoleculeState):
        mol = dataclasses.replace(mol, r=wrap_positions(mol.r, self.box))
        forces, macro, overflow = self._force_fn(mol)
        forces, macro = self._fold_extra(mol, forces, macro)
        return mol, forces, macro, overflow

    def _step(
        self, mol: MoleculeState, forces: Forces, step: int
    ) -> Tuple[MoleculeState, Forces, Macroscopic, GlobalValues, torch.Tensor]:
        cfg = self.config
        # 1. first half-kick + drift (Leapfrog transition 3->1->2)
        mol = upd_pre_force(mol, forces, self.pp, cfg.dt)
        # 2. periodic wraparound (DomainDecompBase::handleDomainLeaving...)
        mol = dataclasses.replace(mol, r=wrap_positions(mol.r, self.box))
        # 3+4. container update + force traversal
        forces, macro, overflow = self._force_fn(mol)
        forces, macro = self._fold_extra(mol, forces, macro)
        mol, gv = self._step_post(mol, forces, macro, step)
        return mol, forces, macro, gv, overflow

    def _step_post(self, mol, forces, macro, step: int):
        cfg = self.config
        dtype, dev = mol.r.dtype, mol.r.device
        # 5. second half-kick + kinetic sums (Leapfrog transition 2->3)
        mol, mv2, iw2 = upd_post_force(mol, forces, self.pp, cfg.dt)
        # 6. global values (Domain::calculateGlobalValues)
        summv2 = mv2.sum()
        sum_iw2 = iw2.sum()
        nmol = mol.num_valid()
        rdof = torch.where(
            mol.valid, self.pp.rot_dof[mol.cid.long()], 0
        ).sum().to(torch.int32)

        def global_values(s2):
            return calculate_global_values(
                macro, s2, sum_iw2, nmol, rdof, self.volume,
                cfg.target_temperature, nve=not cfg.thermostat,
            )

        gv = global_values(summv2)
        # 7. thermostat (Simulation.cpp:1108-1140)
        if cfg.thermostat and cfg.component_thermostat is not None:
            tmap = torch.tensor(cfg.component_thermostat, dtype=torch.int32,
                                device=dev)
            n_th = len(cfg.thermostat_temps)
            s2, siw2, nt, rd = thermostat_kinetic_sums(
                mol, self.pp, mv2, iw2, tmap, n_th
            )
            vbar = None
            if cfg.undirected_thermostats and any(cfg.undirected_thermostats):
                und = torch.tensor(cfg.undirected_thermostats, dtype=torch.bool,
                                   device=dev)
                vbar = thermostat_directed_velocity(mol, tmap, n_th, und)
                s2 = s2 + directed_kinetic_correction(
                    mol, self.pp, vbar, tmap, n_th
                )
            Ti = torch.tensor(cfg.thermostat_temps, dtype=dtype, device=dev)
            one = torch.ones((), dtype=dtype, device=dev)
            bt = torch.where(
                (Ti > 0) & (s2 > 0),
                torch.pow(3.0 * nt * Ti / torch.clamp(s2, min=1e-30), 0.4),
                one,
            )
            br = torch.where(
                (Ti > 0) & (siw2 > 0),
                torch.pow(rd * Ti / torch.clamp(siw2, min=1e-30), 0.4),
                one,
            )
            if vbar is not None:
                mol = apply_velocity_scaling_componentwise_directed(
                    mol, tmap, bt, br, vbar
                )
            else:
                mol = apply_velocity_scaling_componentwise(mol, tmap, bt, br)
        elif cfg.thermostat and cfg.target_temperature > 0:
            if cfg.undirected_thermostats and cfg.undirected_thermostats[0]:
                # undirected GLOBAL thermostat: thermal sampling AND
                # thermal-only scaling (the reference samples thermal
                # kinetic energy, Domain.cpp:462-470, but leaves global
                # scaling directed -- 'Undirected global thermostat not
                # implemented!', Simulation.cpp:1131; here both halves
                # are consistent, as in the JAX package)
                und = torch.ones((1,), dtype=torch.bool, device=dev)
                vbar = thermostat_directed_velocity(mol, None, 1, und)
                gv = global_values(
                    summv2
                    + directed_kinetic_correction(mol, self.pp, vbar, None, 1)[0]
                )
                mol = apply_velocity_scaling_componentwise_directed(
                    mol,
                    torch.zeros((self.pp.mass.shape[0],), dtype=torch.int32,
                                device=dev),
                    gv.beta_trans[None], gv.beta_rot[None], vbar,
                )
            else:
                mol = apply_velocity_scaling(mol, gv.beta_trans, gv.beta_rot)
        if cfg.temp_control_regions:
            mol = apply_temperature_control(
                mol, self.pp, cfg.temp_control_regions, step
            )
        return mol, gv

    # -- host API -----------------------------------------------------------
    def prepare_start(self):
        """Initial force evaluation (Simulation::prepare_start,
        Simulation.cpp:764-918)."""
        self.mol, self.forces, self.macro, _overflow = self._init_forces(self.mol)

    @property
    def started(self) -> bool:
        return self.forces is not None

    # macro (Upot/virial) is computed unconditionally by the general
    # step; the flag exists for engine-surface parity with RMMEngine
    macro_fresh = True

    def advance(self, need_macro: bool = True):
        """One leapfrog step; returns (GlobalValues, overflow device
        scalar).  The engine-protocol entry the driver loop calls
        (need_macro gates RMMEngine's Upot/virial passes; ignored
        here)."""
        self._step_count += 1
        self.mol, self.forces, self.macro, gv, overflow = self._step(
            self.mol, self.forces, self._step_count
        )
        return gv, overflow

    def run(self, steps: int, callback=None, check_overflow_every: int = 0):
        """Advance `steps` timesteps.  The device round-trips only when
        a callback or overflow check forces a readback."""
        if self.forces is None:
            self.prepare_start()
        gv = None
        for k in range(steps):
            gv, overflow = self.advance()
            if check_overflow_every and (k % check_overflow_every == 0):
                if bool(overflow):
                    raise RuntimeError(
                        "cell capacity exceeded; increase SimConfig.cell_cap"
                    )
            if callback is not None:
                callback(k, self.mol, gv)
        return gv
