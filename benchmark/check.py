"""The numbers that decide `correct`: the program's outputs held against
the plain reference (reference/), each beside its limit.

The window's thousands of steps cannot be followed by a reference (the
dynamics is chaotic), so the check takes three readings:
  start   the program's state after set-up against the inputs the
          benchmark made from the seed (positions to the nearest image,
          velocities, orientations);
  final   the forces (and torques) the program holds for its state at
          the end of the window, against the reference's forces of that
          same state, and then one more step through the program's own
          MDSimulation.run against one reference step from that state:
          displacements, velocities, orientation changes, angular
          momenta, and the step's temperature, potential energy and
          pressure;
  ids     every molecule id of the start present exactly once at the end.
Each float number is a largest gap relative to the reference's largest
magnitude (start_r and the globals excepted, see below); `molecules` is
a count, exact.
"""

from __future__ import annotations

import torch

from benchmark.reference.integrate import leapfrog_step
from benchmark.reference.pairs import minimum_image


def rel_max(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def start_numbers(prog, inputs, box, rotates):
    """prog, inputs: dict(r, v, q) of the same molecules in id order.
    start_r is the largest position gap in sigma, to the nearest image."""
    d = minimum_image(prog["r"] - inputs["r"], box)
    out = {"start_r": float(d.abs().max()), "start_v": rel_max(prog["v"], inputs["v"])}
    if rotates:
        out["start_q"] = float((prog["q"] - inputs["q"]).abs().max())
    return out


def id_mismatches(mid, n):
    """Molecules of ids 1..n missing, doubled or foreign in `mid` (sorted)."""
    want = torch.arange(1, n + 1, device=mid.device)
    m = min(len(mid), n)
    return abs(len(mid) - n) + int((mid[:m] != want[:m]).sum())


def final_numbers(model, s, s1, g1, box, dt, target_t, rotates, ref=None):
    """s: the program's state at the end of the window with the forces it
    holds for it; s1, g1: the program's state and globals one step
    later.  ref: the reference's forces of s (computed when not given).
    Returns (numbers, reference forces of s, number of pairs inside rc)."""
    if ref is None:
        ref = model.forces(s["r"], s["q"], box)
    r1, g, _ = leapfrog_step(model, s, box, dt, target_t, forces=ref)
    r1 = {k: x.double() for k, x in r1.items()}
    out = {"force": rel_max(s["F"], ref["F"].double())}
    if rotates:
        out["torque"] = rel_max(s["M"], ref["M"].double())
    out["step_r"] = rel_max(minimum_image(s1["r"] - s["r"], box),
                            minimum_image(r1["r"] - s["r"], box))
    out["step_v"] = rel_max(s1["v"], r1["v"])
    if rotates:
        out["step_q"] = rel_max(s1["q"] - s["q"], r1["q"] - s["q"])
        out["step_L"] = rel_max(s1["L"], r1["L"])
    out["temperature"] = abs(g1["temperature"] / g["temperature"] - 1)
    out["upot"] = abs(g1["upot"] / g["upot"] - 1)
    # relative to the larger of |p| and the ideal-gas part rho*T, so that
    # a pressure near zero does not blow the number up
    rho = len(s["r"]) / float(torch.prod(box.double()))
    out["pressure"] = abs(g1["pressure"] - g["pressure"]) / max(
        abs(g["pressure"]), rho * g["temperature"])
    return out, ref


def verdict(numbers, limits):
    """[(name, value, limit)] in the limits' order, and whether every
    value is within its limit.  A number without a limit, or a limit
    without its number, fails (NaN)."""
    nan = float("nan")
    rows = [(k, float(numbers.get(k, nan)), float(limits[k])) for k in limits]
    rows += [(k, float(numbers[k]), nan) for k in numbers if k not in limits]
    return rows, all(v <= lim for _, v, lim in rows)
