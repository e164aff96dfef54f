"""SI-unit-aware value conversion for XML configs.

The role of src/utils/xmlfileUnits.{h,cpp}: a config
declares reference units

    <refunits type="SI">
      <length unit="nm">0.1</length>
      <mass unit="u">1</mass>
      <energy unit="K">1</energy>
    </refunits>

and any value element may carry a unit attribute (<timestep
unit="fs">5</timestep>); the parser divides the SI value by the
matching reference quantity to obtain reduced units.  Derived
reference quantities follow from the MD reduced-unit system:
time* = l*.sqrt(m*/e*), T* = e*/kB, v* = l*/t*, F* = e*/l*, etc.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

KB = 1.380649e-23  # J/K (exact, SI 2019)
AMU = 1.66053906660e-27  # kg
EV = 1.602176634e-19  # J

_PREFIX = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12,
    "n": 1e-9, "u": 1e-6, "µ": 1e-6, "m": 1e-3, "c": 1e-2,
    "d": 1e-1, "": 1.0, "da": 1e1, "h": 1e2, "k": 1e3, "M": 1e6,
    "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18, "Z": 1e21, "Y": 1e24,
}

# base symbol -> (dimension, factor to SI base)
_BASES = [
    ("eV", "energy", EV),
    ("mol", "amount", 1.0),
    ("m", "length", 1.0),
    ("s", "time", 1.0),
    ("K", "temperature", 1.0),
    ("J", "energy", 1.0),
    ("g", "mass", 1e-3),
    ("u", "mass", AMU),
    ("bar", "pressure", 1e5),
    ("Pa", "pressure", 1.0),
    ("N", "force", 1.0),
]


def parse_si_unit(unit: str) -> Tuple[float, str]:
    """'fs' -> (1e-15, 'time'); 'nm' -> (1e-9, 'length'); raises
    ValueError for unknown symbols."""
    for base, dim, base_f in _BASES:
        if unit.endswith(base):
            pre = unit[: -len(base)]
            if pre in _PREFIX:
                return _PREFIX[pre] * base_f, dim
    raise ValueError(f"unknown SI unit {unit!r}")


@dataclasses.dataclass(frozen=True)
class RefUnits:
    """Reference quantities in SI; convert() maps SI-tagged values to
    reduced units (xmlfileUnits.cpp:379-424)."""

    length_m: float = 1.0
    mass_kg: float = 1.0
    energy_J: float = 1.0

    @staticmethod
    def from_config(refunits: Dict[str, tuple]) -> "RefUnits":
        """From XMLConfig.refunits {'length': (unit, value), ...}."""

        def get(name, expect_dim, default):
            if name not in refunits:
                return default
            unit, value = refunits[name]
            if unit in ("", "reduced", None):
                return float(value)
            f, dim = parse_si_unit(unit)
            if expect_dim == "energy" and dim == "temperature":
                # energy declared in Kelvin means kB*T (the reference's
                # usual '<energy unit="K">1</energy>')
                f, dim = f * KB, "energy"
            if dim != expect_dim:
                raise ValueError(
                    f"refunits <{name}> has unit {unit!r} of dimension "
                    f"{dim}, expected {expect_dim}"
                )
            return float(value) * f

        return RefUnits(
            length_m=get("length", "length", 1.0),
            mass_kg=get("mass", "mass", 1.0),
            energy_J=get("energy", "energy", 1.0),
        )

    # derived reference quantities ------------------------------------
    @property
    def time_s(self) -> float:
        return self.length_m * math.sqrt(self.mass_kg / self.energy_J)

    @property
    def temperature_K(self) -> float:
        return self.energy_J / KB

    def quantity(self, dim: str) -> float:
        if dim == "length":
            return self.length_m
        if dim == "mass":
            return self.mass_kg
        if dim == "energy":
            return self.energy_J
        if dim == "time":
            return self.time_s
        if dim == "temperature":
            return self.temperature_K
        if dim == "velocity":
            return self.length_m / self.time_s
        if dim == "force":
            return self.energy_J / self.length_m
        if dim == "pressure":
            return self.energy_J / self.length_m**3
        if dim == "amount":
            return 1.0
        raise ValueError(f"unknown dimension {dim!r}")

    def convert(self, value: float, unit: Optional[str]) -> float:
        """SI-tagged value -> reduced units; 'reduced'/'' pass through."""
        if unit in ("reduced", "", None):
            return value
        f, dim = parse_si_unit(unit)
        return value * f / self.quantity(dim)
