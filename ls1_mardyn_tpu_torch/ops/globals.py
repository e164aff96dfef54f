"""Global (macroscopic) values: temperature, pressure, thermostat
scaling factors (the counterpart of ls1_mardyn_tpu/ops/globals.py;
Domain::calculateGlobalValues, Domain.cpp:152-262)."""

from __future__ import annotations

import dataclasses

import torch

from ls1_mardyn_tpu_torch.state import Macroscopic


@dataclasses.dataclass
class GlobalValues:
    """Per-step global thermodynamic state (thermostat id 0 == whole
    system, Domain.cpp:186).  Every field is a 0-d tensor on the
    device of the step that produced it."""

    n: torch.Tensor  # number of molecules
    rot_dof: torch.Tensor
    upot: torch.Tensor
    virial: torch.Tensor
    summv2: torch.Tensor  # 2*KE_trans
    sum_iw2: torch.Tensor  # 2*KE_rot
    temperature: torch.Tensor
    pressure: torch.Tensor
    beta_trans: torch.Tensor
    beta_rot: torch.Tensor


def calculate_global_values(
    macro: Macroscopic,
    summv2: torch.Tensor,
    sum_iw2: torch.Tensor,
    n: torch.Tensor,
    rot_dof: torch.Tensor,
    volume: float,
    target_temperature: float,
    nve: bool = False,
) -> GlobalValues:
    """Temperature / pressure / velocity-scaling betas.

    Mirrors Domain.cpp:
      T = (summv2 + sumIw2) / (3N + rotDOF)            (:236-238)
      beta_trans = (3 N T_target / summv2)^0.4          (:244)
      beta_rot   = (rotDOF T_target / sumIw2)^0.4       (:248)
      p = rho T + rho <virial>/3                        (:136-140)
    """
    dtype = summv2.dtype
    nf = n.to(dtype)
    rdof = rot_dof.to(dtype)
    denom = 3.0 * nf + rdof
    T = torch.where(
        denom > 0, (summv2 + sum_iw2) / torch.clamp(denom, min=1.0), 0.0
    )
    ok = target_temperature > 0 and not nve
    one = torch.ones((), dtype=dtype, device=summv2.device)
    if ok:
        beta_trans = torch.where(
            (nf > 0) & (summv2 > 0),
            torch.pow(
                3.0 * nf * target_temperature / torch.clamp(summv2, min=1e-30),
                0.4,
            ),
            one,
        )
        beta_rot = torch.where(
            (nf > 0) & (sum_iw2 > 0),
            torch.pow(
                rdof * target_temperature / torch.clamp(sum_iw2, min=1e-30),
                0.4,
            ),
            one,
        )
    else:
        beta_trans = beta_rot = one
    rho = nf / volume
    avg_virial = torch.where(
        nf > 0, macro.total_virial / torch.clamp(nf, min=1.0), 0.0
    )
    pressure = rho * T + rho * avg_virial / 3.0
    return GlobalValues(
        n=n,
        rot_dof=rot_dof,
        upot=macro.upot,
        virial=macro.total_virial,
        summv2=summv2,
        sum_iw2=sum_iw2,
        temperature=T,
        pressure=pressure,
        beta_trans=beta_trans,
        beta_rot=beta_rot,
    )
