"""Carry state across from the JAX package, as numpy arrays.

`pair_params_from_numpy` takes the JAX PairParams fields,
`molecule_state_from_numpy` / `forces_from_numpy` the MoleculeState /
Forces leaves and `rmm_state_from_numpy` the JAX RMMState leaves (each
converted with ``np.asarray``), so the port can start from exactly the
JAX state.  The reverse direction is `to_numpy` (and
RMMSimulation.state_numpy()).  Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams
from ls1_mardyn_tpu_torch.ops.rmm import RMMState
from ls1_mardyn_tpu_torch.state import Forces, MoleculeState


def _tensor(x, dtype=None, device="cpu"):
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def pair_params_from_numpy(fields: dict, dtype=None, device="cpu") -> PairParams:
    """PairParams from a dict of numpy arrays keyed like the JAX
    PairParams fields.  dtype converts the floating tables; rot_dof
    stays int32."""
    out = {}
    for f in dataclasses.fields(PairParams):
        if f.name.startswith("_"):
            continue
        is_int = f.name == "rot_dof"
        out[f.name] = _tensor(fields[f.name], torch.int32 if is_int else dtype,
                              device)
    return PairParams(**out)


def molecule_state_from_numpy(fields: dict, dtype=None, device="cpu") -> MoleculeState:
    """MoleculeState from a dict of numpy arrays keyed like the JAX
    MoleculeState leaves (r, v, q, L, cid, mid, valid)."""
    return MoleculeState(
        **{k: _tensor(fields[k], dtype, device) for k in ("r", "v", "q", "L")},
        cid=_tensor(fields["cid"], torch.int32, device),
        mid=_tensor(fields["mid"], torch.int32, device),
        valid=_tensor(fields["valid"], torch.bool, device),
    )


def forces_from_numpy(fields: dict, dtype=None, device="cpu") -> Forces:
    """Forces from a dict of numpy arrays keyed F, M, Vi."""
    return Forces(**{k: _tensor(fields[k], dtype, device) for k in ("F", "M", "Vi")})


def to_numpy(obj) -> dict:
    """The tensor leaves of a state dataclass as numpy arrays."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))}


def rmm_state_from_numpy(planes, forces, vcomp, rcomp, u6, vir,
                         device="cpu") -> RMMState:
    """RMMState from the JAX RMMState leaves as numpy arrays."""
    def t(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)

    return RMMState(planes=t(planes), forces=t(forces), vcomp=t(vcomp),
                    rcomp=t(rcomp), u6=t(u6), vir=t(vir))
