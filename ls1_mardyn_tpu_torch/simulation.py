"""Per-run configuration (the counterpart of
ls1_mardyn_tpu/simulation.py: SimConfig), with the fields the RMM
engine reads.  The general single-device engine (SingleChipSimulation)
and the fields for its thermostats, screening and non-uniform rows come
with ROADMAP slice 2."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static per-run configuration."""

    dt: float
    target_temperature: float = 0.0
    thermostat: bool = True  # False => NVE
    cell_cap: int = 32
    upot_corr: float = 0.0  # long-range correction (ops/lrc.py)
    virial_corr: float = 0.0
