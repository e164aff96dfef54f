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


def canonical_device(device) -> torch.device:
    """resolve_device with the card's index filled in, so that it
    compares equal to a tensor's .device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(x, device: torch.device, what: str, **kw) -> torch.Tensor:
    """x as a tensor on `device` (a solver's, from canonical_device): a
    host array is sent there; a tensor on another device raises, so
    that no work moves off the card unasked."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"{what} is on {x.device}, the solver on {device}")
    return torch.as_tensor(x, device=device, **kw)


@dataclasses.dataclass
class MoleculeState:
    """Dense molecule arrays; capacity N may exceed the live count
    (reserve slots are invalid and carry neutral values)."""

    r: torch.Tensor  # [N,3] center-of-mass position (world)
    v: torch.Tensor  # [N,3] velocity
    q: torch.Tensor  # [N,4] orientation quaternion (w,x,y,z), body->world
    L: torch.Tensor  # [N,3] angular momentum (world frame)
    cid: torch.Tensor  # [N] int32 component index (0-based)
    mid: torch.Tensor  # [N] int32 molecule id
    valid: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.r.shape[0]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum().to(torch.int32)

    @staticmethod
    def from_numpy(
        r: np.ndarray,
        v: np.ndarray,
        q: Optional[np.ndarray] = None,
        L: Optional[np.ndarray] = None,
        cid: Optional[np.ndarray] = None,
        mid: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ) -> "MoleculeState":
        device = resolve_device(device)
        n = r.shape[0]
        if capacity is None:
            capacity = n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} molecules")

        def padf(a):
            out = np.zeros((capacity,) + np.shape(a)[1:], dtype=np.float64)
            out[:n] = a
            return torch.as_tensor(out, dtype=dtype, device=device)

        def padi(a):
            out = np.zeros((capacity,), np.int32)
            out[:n] = a
            return torch.as_tensor(out, device=device)

        if q is None:
            q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
        if L is None:
            L = np.zeros((n, 3))
        if cid is None:
            cid = np.zeros((n,), np.int32)
        if mid is None:
            mid = np.arange(1, n + 1, dtype=np.int32)
        valid = np.zeros((capacity,), bool)
        valid[:n] = True
        qp = padf(q)
        # padded quaternions must stay normalized for safe math
        qp[n:, 0] = 1.0
        return MoleculeState(
            r=padf(r), v=padf(v), q=qp, L=padf(L),
            cid=padi(cid), mid=padi(mid),
            valid=torch.as_tensor(valid, device=device),
        )


@dataclasses.dataclass
class Forces:
    """Per-molecule force/torque/virial of one force pass (FullMolecule's
    F, M, Vi)."""

    F: torch.Tensor  # [N,3]
    M: torch.Tensor  # [N,3]
    Vi: torch.Tensor  # [N,3]

    @staticmethod
    def zeros(n: int, dtype: torch.dtype = torch.float32, device="cpu") -> "Forces":
        z = torch.zeros((n, 3), dtype=dtype, device=device)
        return Forces(z, z, z)


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

    @staticmethod
    def zeros(dtype: torch.dtype = torch.float32, device="cpu") -> "Macroscopic":
        z = torch.zeros((), dtype=dtype, device=device)
        return Macroscopic(z, z, z, z)

    def __add__(self, o: "Macroscopic") -> "Macroscopic":
        return Macroscopic(
            self.upot6lj + o.upot6lj,
            self.upot_xpoles + o.upot_xpoles,
            self.virial + o.virial,
            self.my_rf + o.my_rf,
        )


@dataclasses.dataclass
class SimState:
    """Full per-step simulation state (the step counter is a plain int:
    the step runs eagerly)."""

    mol: MoleculeState
    forces: Forces
    macro: Macroscopic
    step: int
    time: float

    @staticmethod
    def create(mol: MoleculeState, dtype: Optional[torch.dtype] = None) -> "SimState":
        if dtype is None:
            dtype = mol.r.dtype
        dev = mol.r.device
        return SimState(
            mol=mol,
            forces=Forces.zeros(mol.capacity, dtype, dev),
            macro=Macroscopic.zeros(dtype, dev),
            step=0,
            time=0.0,
        )
