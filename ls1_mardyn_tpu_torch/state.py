"""Simulation state: dataclasses of tensors.

Fixed-capacity dense SoA arrays with a validity mask (the counterpart
of ls1_mardyn_tpu/state.py): deleted or unfilled slots are masked out
(valid=False) and carry neutral values.  Fields mirror the reference's
FullMolecule r, v, q, D(=L), plus component and molecule ids.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MoleculeState:
    """Dense molecule arrays (every slot live in this slice: the
    reserve slots of muVT come with ROADMAP slice 5)."""

    r: torch.Tensor  # [N,3] center-of-mass position (world)
    v: torch.Tensor  # [N,3] velocity
    q: torch.Tensor  # [N,4] orientation quaternion (w,x,y,z)
    L: torch.Tensor  # [N,3] angular momentum (world frame)
    cid: torch.Tensor  # [N] int32 component index (0-based)
    mid: torch.Tensor  # [N] int32 molecule id
    valid: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.r.shape[0]

    @staticmethod
    def from_numpy(
        r: np.ndarray,
        v: np.ndarray,
        q: Optional[np.ndarray] = None,
        L: Optional[np.ndarray] = None,
        cid: Optional[np.ndarray] = None,
        mid: Optional[np.ndarray] = None,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ) -> "MoleculeState":
        n = r.shape[0]

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        if q is None:
            q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
        if L is None:
            L = np.zeros((n, 3))
        if cid is None:
            cid = np.zeros((n,), np.int32)
        if mid is None:
            mid = np.arange(1, n + 1, dtype=np.int32)
        return MoleculeState(
            r=f(r), v=f(v), q=f(q), L=f(L),
            cid=torch.as_tensor(np.asarray(cid, np.int32), device=device),
            mid=torch.as_tensor(np.asarray(mid, np.int32), device=device),
            valid=torch.ones((n,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class Forces:
    """Per-molecule force/torque/virial of one force pass (FullMolecule's
    F, M, Vi)."""

    F: torch.Tensor  # [N,3]
    M: torch.Tensor  # [N,3]
    Vi: torch.Tensor  # [N,3]


@dataclasses.dataclass
class Macroscopic:
    """Global scalars of one force evaluation.

    The reference accumulates upot6lj / upotXpoles / virial / myRF in
    the cell processor and combines them in endTraversal
    (VectorizedCellProcessor.cpp:119-156):
      U_pot  = upot6lj/6 + upotXpoles + myRF
      virial = virial + 3*myRF
    """

    upot6lj: torch.Tensor
    upot_xpoles: torch.Tensor
    virial: torch.Tensor
    my_rf: torch.Tensor

    @property
    def upot(self):
        return self.upot6lj / 6.0 + self.upot_xpoles + self.my_rf

    @property
    def total_virial(self):
        return self.virial + 3.0 * self.my_rf
