"""Pair parameters on the device (the counterpart of
ls1_mardyn_tpu/models/interaction.py: PairParams).

Slice 1 carries only what the single-site LJ path reads: the LJ
coupling tables, the component masses and the two cutoffs.  The
multipole tables and the molecule-pair physics come with the
multi-site slice (ROADMAP slice 3).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PairParams:
    """Device-side mirror of the LJ part of ComponentTable."""

    eps24: torch.Tensor  # [K, K, S_i, S_j]
    sig2: torch.Tensor
    shift6: torch.Tensor
    mass: torch.Tensor  # [K]
    rc2: torch.Tensor  # electrostatics cutoff^2 (ref _cutoffRadiusSquare)
    rc2_lj: torch.Tensor  # LJ cutoff^2 (ref _LJCutoffRadiusSquare)

    @staticmethod
    def from_table(table, dtype: torch.dtype = torch.float32, device="cpu") -> "PairParams":
        def a(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return PairParams(
            eps24=a(table.eps24),
            sig2=a(table.sig2),
            shift6=a(table.shift6),
            mass=a(table.mass),
            rc2=a(table.cutoff ** 2),
            rc2_lj=a(table.lj_cutoff ** 2),
        )
