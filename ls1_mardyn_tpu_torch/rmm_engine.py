"""RMM fast-path engine for the product driver (the counterpart of
ls1_mardyn_tpu/rmm_engine.py).

Adapts RMMSimulation (ops/rmm.py: dense cell-layout primary state,
verlet-skin rebin cadence, kernels K1/K2, Kahan integration) to the
engine surface MDSimulation and its plugins use, so
``python -m ls1_mardyn_tpu_torch argon.xml`` runs single-component
1CLJ scenes on the dense layout.

Contract notes:
  - ``mol`` / ``forces`` are PROPERTIES: reading gathers the dense
    planes back to flat MoleculeState/Forces arrays (cached per step);
    writing ``mol`` re-initializes the dense state (a full rebin + force
    evaluation).
  - ``advance(need_macro)``: one leapfrog step; returns (GlobalValues,
    overflow flag) as SingleChipSimulation does.  With need_macro=False
    the kernel skips the Upot/virial sums; the returned GlobalValues
    then carries kinetic-only data and ``macro_fresh`` is False.  A
    capacity overflow that even the global rebin cannot absorb raises
    CellCapacityError with the state unchanged (the driver re-specs the
    grid from it), so the flag returned is always False; the JAX engine
    instead reports a flag after the lossy global rebin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation
from ls1_mardyn_tpu_torch.state import Forces, Macroscopic, MoleculeState
from ls1_mardyn_tpu_torch.utils.logger import global_log


def pick_rmm_grid(r, box, rc, cap=32, headroom=2, skin_min=0.29):
    """Coarsest overflow-safe anisotropic grid for the dense RMM
    layout: kernel work is n_cells * cap^2 regardless of occupancy, so
    the coarsest grid whose measured per-cell occupancy (plus drift
    headroom) fits `cap` wins.  Returns (dims, cap), or (None, cap) when
    the box admits no >= 4-cell grid with a usable verlet skin."""
    box = np.asarray(box, float)
    r = np.asarray(r, float) % box

    def occ_max(dims):
        dims_a = np.asarray(dims)
        edge = box / dims_a
        c = np.clip((r / edge).astype(np.int64), 0, dims_a - 1)
        idx = (c[:, 0] * dims_a[1] + c[:, 1]) * dims_a[2] + c[:, 2]
        return int(np.bincount(idx, minlength=int(np.prod(dims_a))).max())

    # per-axis candidate counts: multiples of 4 (kept from the JAX
    # package so both pick the same geometry), edge >= rc+skin_min
    def cands_axis(L):
        hi = int(np.floor(L / (rc + skin_min)))
        return [c for c in range(4, hi + 1, 4)]

    cx, cy, cz = (cands_axis(L) for L in box)
    if not (cx and cy and cz):
        return None, cap
    best = None
    for nx in cx:
        for ny in cy:
            for nz in cz:
                if max(ny, nz) - min(ny, nz) > 8 or abs(ny - nx) > 8 \
                        or abs(nz - nx) > 8:
                    continue
                cells = nx * ny * nz
                if best is not None and cells >= best[0]:
                    continue
                if len(r) > cells * (cap - headroom):
                    continue
                if occ_max((nx, ny, nz)) <= cap - headroom:
                    best = (cells, (nx, ny, nz))
    if best is not None:
        return best[1], cap
    # nothing fits at this cap: finest admissible grid, escalate cap
    dims = tuple(
        max(4, int(np.floor(L / (rc + skin_min))) // 4 * 4) for L in box
    )
    need = occ_max(dims) + headroom
    cap2 = cap
    while cap2 < need:
        cap2 *= 2
    return dims, cap2


class RMMEngine:
    """Engine facade over RMMSimulation."""

    def __init__(
        self,
        mol: MoleculeState,
        pp,
        table,
        box,
        config,  # SimConfig
        spec: CellGridSpec,
        rebin_every: int = 8,
        device="cuda",
    ):
        self.pp = pp
        # cell_cap reflects the RMM grid's actual capacity so the
        # driver's overflow re-spec doubles from the right base
        self.config = dataclasses.replace(config, cell_cap=spec.cap)
        self.box = tuple(float(b) for b in np.asarray(box))
        self.spec = spec
        self.device = torch.device(device)
        self.volume = float(np.prod(self.box))
        self._mol0 = mol
        self.sim = RMMSimulation(
            table, pp, box, spec, dt=config.dt,
            target_temperature=config.target_temperature,
            thermostat=config.thermostat,
            rebin_every=rebin_every,
            sample_every=1,  # cadence is driven by advance(need_macro)
            upot_corr=config.upot_corr,
            virial_corr=config.virial_corr,
            device=device,
        )
        self._step_count = 0
        self._cache_step = -1
        self._mol_cache: Optional[MoleculeState] = None
        self._forces_cache: Optional[Forces] = None
        self.macro: Optional[Macroscopic] = None
        self.macro_fresh = False
        self.last_globals = None
        self._no_overflow = torch.zeros((), dtype=torch.bool, device=self.device)

    @property
    def started(self) -> bool:
        return self.sim.state is not None and self.macro is not None

    def _macro(self) -> Macroscopic:
        st = self.sim.state
        zero = torch.zeros_like(st.u6)
        return Macroscopic(
            upot6lj=st.u6,
            upot_xpoles=zero + self.config.upot_corr,
            virial=st.vir + self.config.virial_corr,
            my_rf=zero,
        )

    # -- engine surface -----------------------------------------------------
    def prepare_start(self):
        if self.sim.state is None:
            self.sim.init_from_molecules(self._mol0)
            self._mol0 = None  # free the flat copy
        self.macro = self._macro()
        self.macro_fresh = True
        self._invalidate()

    def advance(self, need_macro: bool = True):
        """One step (preceded by the rebin when due); returns
        (GlobalValues, overflow flag).  Raises CellCapacityError on a
        real overflow, so the flag is always False."""
        gv = self.sim.step(compute_macro=need_macro)
        self._step_count += 1
        if need_macro:
            self.macro = self._macro()
        self.macro_fresh = bool(need_macro)
        self.last_globals = gv
        self._invalidate()
        return gv, self._no_overflow

    def retarget(self, t: float):
        """Thermostat retarget mid-run (SteereoControl set_t)."""
        self.sim.target_temperature = float(t)
        self.sim.thermostat = True
        self.config = dataclasses.replace(
            self.config, target_temperature=float(t), thermostat=True
        )

    # -- flat-state round-trip ----------------------------------------------
    def _invalidate(self):
        self._cache_step = -1
        self._mol_cache = None
        self._forces_cache = None

    def _gather(self):
        """Dense planes -> flat MoleculeState + Forces (slot order),
        cached per step.  Rare path: plugin reads at write cadence."""
        st = self.sim.state
        # same slot order as to_molecules: (z, y, lane) of the valid slots
        valid = st.planes[:, :, 3, :] > 0.5
        F = st.forces.permute(0, 1, 3, 2)[valid]
        self._mol_cache = self.sim.to_molecules()
        self._forces_cache = Forces(F=F, M=torch.zeros_like(F), Vi=torch.zeros_like(F))
        self._cache_step = self._step_count

    def slot_velocities_forces(self):
        """((vx, vy, vz), (Fx, Fy, Fz), valid): views of the dense planes,
        each [nz, ny, nx*cap], on the device and without the host round
        trip of `mol`; for observers that only reduce them (MaxWriter)."""
        p, f = self.sim.state.planes, self.sim.state.forces
        return ((p[:, :, 4], p[:, :, 5], p[:, :, 6]),
                (f[:, :, 0], f[:, :, 1], f[:, :, 2]), p[:, :, 3] > 0.5)

    @property
    def mol(self) -> MoleculeState:
        if self.sim.state is None:
            return self._mol0
        if self._cache_step != self._step_count or self._mol_cache is None:
            self._gather()
        return self._mol_cache

    @mol.setter
    def mol(self, new_mol: Optional[MoleculeState]):
        """Plugin state mutation (e.g. checkpoint restore): exact but
        expensive -- re-bins and re-evaluates forces."""
        if new_mol is None:
            raise ValueError("RMMEngine.mol cannot be None")
        if self.sim.state is None:
            self._mol0 = new_mol
            return
        global_log.info(
            "RMMEngine: flat-state write-back (re-bin + force re-eval)"
        )
        self.sim.init_from_molecules(new_mol)
        self._invalidate()

    @property
    def forces(self) -> Optional[Forces]:
        if self.sim.state is None:
            return None
        if self._cache_step != self._step_count or self._forces_cache is None:
            self._gather()
        return self._forces_cache

    @forces.setter
    def forces(self, value):
        # plugins assign None to request a fresh prepare_start; the RMM
        # state always carries forces, so only the macro freshness
        # resets
        if value is None:
            self.macro_fresh = False
            return
        raise ValueError("RMMEngine.forces is derived state")
