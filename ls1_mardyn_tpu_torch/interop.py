"""Carry state across from the JAX package, as numpy arrays.

`pair_params_from_numpy` takes the JAX PairParams fields and
`rmm_state_from_numpy` the JAX RMMState leaves (each converted with
``np.asarray``), so the port can start from exactly the JAX state.  The
reverse direction is RMMSimulation.state_numpy().  Nothing here imports
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.rmm import RMMState


def pair_params_from_numpy(fields: dict, dtype=None, device="cpu") -> PairParams:
    """PairParams from a dict of numpy arrays keyed like the JAX
    PairParams fields (extra keys, the multipole tables, are
    ignored)."""
    def a(k):
        return torch.as_tensor(np.array(fields[k], copy=True), dtype=dtype,
                               device=device)

    return PairParams(
        eps24=a("eps24"), sig2=a("sig2"), shift6=a("shift6"),
        mass=a("mass"), rc2=a("rc2"), rc2_lj=a("rc2_lj"),
    )


def rmm_state_from_numpy(planes, forces, vcomp, rcomp, u6, vir,
                         device="cpu") -> RMMState:
    """RMMState from the JAX RMMState leaves as numpy arrays."""
    def t(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)

    return RMMState(planes=t(planes), forces=t(forces), vcomp=t(vcomp),
                    rcomp=t(rcomp), u6=t(u6), vir=t(vir))
