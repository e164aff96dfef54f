"""Scene assembly: turn parsed phase-space data into device state (the
counterpart of ls1_mardyn_tpu/scene.py).

Bridges I/O (PhaseSpaceData) and the compute layer (MoleculeState +
PairParams), the role Simulation::initConfigXML plays in the reference
(src/Simulation.cpp:675-750).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.models.components import ComponentTable
from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.state import MoleculeState, resolve_device


def build_scene(
    data: PhaseSpaceData,
    cutoff: float,
    lj_cutoff: Optional[float] = None,
    capacity: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> Tuple[MoleculeState, PairParams, ComponentTable, torch.Tensor]:
    """Returns (state, pair_params, table, box), on the card unless the
    caller passes device="cpu" (a machine without a card raises)."""
    device = resolve_device(device)
    table = ComponentTable(
        data.components,
        mixing_xi=data.mixing_xi,
        mixing_eta=data.mixing_eta,
        eps_rf=data.eps_rf,
        cutoff=cutoff,
        lj_cutoff=lj_cutoff if lj_cutoff is not None else cutoff,
    )
    pp = PairParams.from_table(table, dtype=dtype, device=device)
    mol = MoleculeState.from_numpy(
        r=data.r, v=data.v, q=data.q, L=data.L, cid=data.cid,
        mid=data.mid.astype(np.int64), capacity=capacity,
        dtype=dtype, device=device,
    )
    box = torch.as_tensor(np.asarray(data.box, np.float64), dtype=dtype,
                          device=device)
    return mol, pp, table, box
