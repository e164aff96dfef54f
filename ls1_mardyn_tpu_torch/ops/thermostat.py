"""Thermostats (the counterpart of ls1_mardyn_tpu/ops/thermostat.py).

The reference's velocity-scaling thermostat
(src/thermostats/VelocityScalingThermostat.{h,cpp}, applied in the main
loop at src/Simulation.cpp:1108-1140): scale translational velocities
by beta_trans and angular momenta by beta_rot each step.
Component-wise thermostats map component -> thermostat id
(Domain.h:424-431); each thermostat id gets its own betas.

Region-based TemperatureControl (slab thermostats,
src/thermostats/TemperatureControl.{h,cpp}) is layered on top: regions
are static boxes; per-region kinetic sums are masked reductions and the
scaling is a masked multiply.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.state import MoleculeState


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Sum rows of x by segment id (jax.ops.segment_sum).  index_add_ on
    a CUDA tensor adds in no fixed order: the sums agree with the CPU's
    to rounding, not bit for bit."""
    out = torch.zeros((num,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def _thermostat_ids(mol: MoleculeState, thermostat_of_component):
    if thermostat_of_component is None:
        return torch.zeros_like(mol.cid, dtype=torch.long)
    return thermostat_of_component.long()[mol.cid.long()]


def apply_velocity_scaling(
    mol: MoleculeState, beta_trans, beta_rot
) -> MoleculeState:
    """Global velocity scaling (VelocityScalingThermostat::apply)."""
    return dataclasses.replace(mol, v=mol.v * beta_trans, L=mol.L * beta_rot)


def apply_velocity_scaling_componentwise(
    mol: MoleculeState,
    thermostat_of_component: torch.Tensor,  # [K] thermostat id
    beta_trans: torch.Tensor,  # [T] per-thermostat
    beta_rot: torch.Tensor,  # [T]
) -> MoleculeState:
    """Component-wise scaling (Simulation.cpp:1108-1136 with
    severalThermostats)."""
    tid = _thermostat_ids(mol, thermostat_of_component)
    v = mol.v * beta_trans[tid][:, None]
    L = mol.L * beta_rot[tid][:, None]
    return dataclasses.replace(mol, v=v, L=L)


@dataclasses.dataclass(frozen=True)
class TemperatureControlRegion:
    """One control region (TemperatureControl.cpp 'ControlRegionT'):
    molecules inside (lower, upper) are velocity-scaled toward the
    target every `frequency` steps, with the reference's full feature
    set: y-slab subdivision (numslabs), thermostated translational
    directions, target ramping, and the control start/stop window
    (TemperatureControl.h:41-63,155)."""

    lower: Tuple[float, float, float]
    upper: Tuple[float, float, float]
    target_temperature: float
    frequency: int = 1
    exponent: float = 0.4
    component: int = -1  # -1 == all components
    nslabs: int = 1  # region subdivided along y (TemperatureControl.cpp:386)
    directions: Tuple[int, ...] = (0, 1, 2)  # <directions>xyz</directions>
    # target ramp (Ramp struct, TemperatureControl.h:155)
    ramp_start_t: float = 0.0
    ramp_end_t: float = 0.0
    ramp_update_start: int = 0
    ramp_update_stop: int = 0
    ramp_update_freq: int = 1
    # thermostat ON/OFF window (<control><start>/<stop>)
    start: int = 0
    stop: int = 2**31 - 1

    def target_at(self, step: int) -> float:
        """Ramped target temperature at `step` (quantized to
        ramp_update_freq, TemperatureControl.cpp:267-277)."""
        if self.ramp_update_stop <= self.ramp_update_start:
            return float(self.target_temperature)
        span = self.ramp_update_stop - self.ramp_update_start
        slope = (self.ramp_end_t - self.ramp_start_t) / span
        el = min(max(int(step) - self.ramp_update_start, 0), span)
        el = (el // self.ramp_update_freq) * self.ramp_update_freq
        return float(self.ramp_start_t) + el * slope


def apply_temperature_control(
    mol: MoleculeState,
    pp: PairParams,
    regions: Tuple[TemperatureControlRegion, ...],
    step: int,
) -> MoleculeState:
    """Region thermostats (src/thermostats/TemperatureControl.{h,cpp}):
    per-slab kinetic sampling (MeasureKineticEnergy + CalcGlobalValues)
    then velocity scaling by vcorr = 2 - 1/beta on the thermostated
    directions and angular-momentum scaling by Dcorr = 2 - 1/betaRot
    (ControlTemperature, TemperatureControl.cpp:364-430), as masked
    segment reductions + masked multiplies.  `step` is a plain int."""
    v = mol.v
    L = mol.L
    dtype, dev = v.dtype, v.device
    cid = mol.cid.long()
    mass = pp.mass[cid]
    iw2_mol = (L * L * pp.inv_inertia[cid]).sum(-1)
    rdof_mol = pp.rot_dof[cid].to(dtype)
    step = int(step)
    for reg in regions:
        lo = torch.tensor(reg.lower, dtype=dtype, device=dev)
        hi = torch.tensor(reg.upper, dtype=dtype, device=dev)
        inside = ((mol.r > lo) & (mol.r < hi)).all(-1) & mol.valid
        if reg.component >= 0:
            inside = inside & (mol.cid == reg.component)
        active = (
            step % reg.frequency == 0
            and reg.start <= step <= min(int(reg.stop), 2**31 - 1)
        )
        nsl = max(int(reg.nslabs), 1)
        slab_w = (reg.upper[1] - reg.lower[1]) / nsl
        s_idx = torch.clamp(
            torch.floor((mol.r[:, 1] - reg.lower[1]) / slab_w).long(),
            0, nsl - 1,
        )
        m = inside.to(dtype)
        dirs = tuple(reg.directions)
        v2_dirs = sum(v[:, d] * v[:, d] for d in dirs)
        ekin_t = _segment_sum(mass * v2_dirs * m, s_idx, nsl)  # 2x E_kin,trans
        ekin_r = _segment_sum(iw2_mol * m, s_idx, nsl)
        n_s = _segment_sum(m, s_idx, nsl)
        rdof_s = _segment_sum(rdof_mol * m, s_idx, nsl)
        target = reg.target_at(step)
        one = torch.ones((), dtype=dtype, device=dev)
        if active:
            beta_t = torch.where(
                (n_s >= 1) & (ekin_t > 0),
                torch.pow(
                    len(dirs) * n_s * target / torch.clamp(ekin_t, min=1e-30),
                    reg.exponent,
                ),
                one,
            )
            beta_r = torch.where(
                (rdof_s >= 1) & (ekin_r > 0),
                torch.pow(
                    rdof_s * target / torch.clamp(ekin_r, min=1e-30),
                    reg.exponent,
                ),
                one,
            )
        else:
            beta_t = beta_r = torch.ones((nsl,), dtype=dtype, device=dev)
        # the reference scales by 2 - 1/beta (a damped correction that
        # converges to beta for beta ~ 1, TemperatureControl.cpp:395).
        # Guard: for beta < 0.5 the raw form flips sign and AMPLIFIES
        # (runaway); clamp to a small positive quench instead (the
        # reference is only ever used in the stable regime)
        vc = torch.clamp(2.0 - 1.0 / beta_t, min=0.05)
        dc = torch.clamp(2.0 - 1.0 / beta_r, min=0.05)
        vcorr = torch.where(inside, vc[s_idx], one)
        dcorr = torch.where(inside, dc[s_idx], one)
        vnew = v.clone()
        for d in dirs:
            vnew[:, d] = v[:, d] * vcorr
        v = vnew
        L = L * dcorr[:, None]
    return dataclasses.replace(mol, v=v, L=L)


def thermostat_directed_velocity(
    mol: MoleculeState,
    thermostat_of_component: Optional[torch.Tensor],
    num_thermostats: int,
    undirected: torch.Tensor,  # [T] bool: thermostat is "Undirected"
) -> torch.Tensor:
    """Per-thermostat mean (directed) velocity v_bar [T, 3] -- the
    NUMBER mean over the thermostat's molecules, zero for thermostats
    without the Undirected flag (Domain::
    calculateThermostatDirectedVelocity, Domain.cpp:368-408: sum of
    velocities / N, not mass-weighted).

    As in the JAX package, v_bar is recomputed every step (the
    reference amortizes the O(N) pass over a 100-step cadence,
    Simulation.h:327-331)."""
    dtype = mol.v.dtype
    tid = _thermostat_ids(mol, thermostat_of_component)
    valid_f = mol.valid.to(dtype)
    sv = _segment_sum(mol.v * valid_f[:, None], tid, num_thermostats)  # [T,3]
    n = _segment_sum(valid_f, tid, num_thermostats)  # [T]
    vbar = sv / torch.clamp(n, min=1.0)[:, None]
    return torch.where(undirected[:, None], vbar, 0.0)


def directed_kinetic_correction(
    mol: MoleculeState,
    pp: PairParams,
    vbar: torch.Tensor,  # [T, 3]
    thermostat_of_component: Optional[torch.Tensor],
    num_thermostats: int,
) -> torch.Tensor:
    """Per-thermostat correction c so that summv2_thermal = summv2 + c:
    sum_i m(v_i - vbar)^2 = sum m v^2 - 2 vbar . sum(m v) + |vbar|^2
    sum m (calculate_mv2_Iw2's directed overload, FullMolecule.h;
    sampling the THERMAL kinetic energy only, Domain.cpp:462-470)."""
    dtype = mol.v.dtype
    tid = _thermostat_ids(mol, thermostat_of_component)
    m = pp.mass[mol.cid.long()] * mol.valid.to(dtype)
    smv = _segment_sum(mol.v * m[:, None], tid, num_thermostats)  # [T,3]
    sm = _segment_sum(m, tid, num_thermostats)  # [T]
    return -2.0 * (vbar * smv).sum(-1) + (vbar * vbar).sum(-1) * sm


def apply_velocity_scaling_componentwise_directed(
    mol: MoleculeState,
    thermostat_of_component: torch.Tensor,
    beta_trans: torch.Tensor,
    beta_rot: torch.Tensor,
    vbar: torch.Tensor,  # [T, 3]
) -> MoleculeState:
    """v <- vbar + beta (v - vbar): scale only the thermal component,
    preserving the directed flow (VelocityScalingThermostat.cpp:60-67
    vsub/scale_v/vadd)."""
    tid = _thermostat_ids(mol, thermostat_of_component)
    vb = vbar[tid]
    v = vb + (mol.v - vb) * beta_trans[tid][:, None]
    L = mol.L * beta_rot[tid][:, None]
    return dataclasses.replace(mol, v=v, L=L)


def thermostat_kinetic_sums(
    mol: MoleculeState,
    pp: PairParams,
    mv2: torch.Tensor,  # [N] per-molecule m*v^2
    iw2: torch.Tensor,  # [N] per-molecule I*w^2
    thermostat_of_component: Optional[torch.Tensor],
    num_thermostats: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-thermostat (summv2, sumIw2, N, rotDOF) segment sums; the local
    half of Domain::calculateGlobalValues's per-thermostat loop
    (Domain.cpp:207-235)."""
    tid = _thermostat_ids(mol, thermostat_of_component)
    valid_f = mol.valid.to(mv2.dtype)
    summv2 = _segment_sum(mv2 * valid_f, tid, num_thermostats)
    sum_iw2 = _segment_sum(iw2 * valid_f, tid, num_thermostats)
    n = _segment_sum(valid_f, tid, num_thermostats)
    rdof = _segment_sum(
        pp.rot_dof[mol.cid.long()].to(mv2.dtype) * valid_f, tid, num_thermostats
    )
    return summv2, sum_iw2, n, rdof
