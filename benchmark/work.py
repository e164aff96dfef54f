"""The work a step needs, counted on the program's state by the
benchmark's own code, and the card's published peaks: the yardstick of
the roofline and mfu metrics.

Operations count only what the physics needs: each unordered molecule
pair whose centres lie inside the cutoff once (Newton's third law),
times the operations of its site-pair terms.  A candidate pair that an
implementation tests and rejects is that implementation's cost and not
counted, so a pair list, a finer grid or another kernel leaves the count
as it is.  Bytes count what a force call needs: the validity flag of
every slot of the kernel's cell grid, the coordinates (and for a rigid
multi-site model the orientations) of the occupied slots, and the
output planes over every slot written once.
"""

from __future__ import annotations

from benchmark.scene import rotates as multisite

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

# operations of one in-cutoff UNORDERED pair of the 1CLJ kernels: 22 for
# the LJ term and the sums on i, 3 for the reaction on j
LJ_1CLJ_OPS = 25
# operations of one in-cutoff unordered pair per site-pair term of the
# multi-site kernels, by term (frozen from the site-pair program of
# ls1_mardyn_tpu_torch/csrc/ms_pair.cuh, body codes LJ=0 .. DD=9): the
# site separation (12), the body, the sums on i and the reaction on j
MS_TERM_OPS = {"LJ": 74, "CC": 67, "CQ": 107, "CD": 97, "QC": 110, "QQ": 186,
               "QD": 180, "DC": 100, "DQ": 177, "DD": 175}


def pair_ops(cfg) -> int:
    """Operations of one in-cutoff unordered molecule pair of the model."""
    if not multisite(cfg):
        return LJ_1CLJ_OPS
    s = cfg["sites"]
    n_lj, n_q = len(s["lj"]), len(s.get("quadrupoles", []))
    return n_lj * n_lj * MS_TERM_OPS["LJ"] + n_q * n_q * MS_TERM_OPS["QQ"]


def force_bytes(cfg, n, slots):
    """Bytes a force call needs on a grid of `slots` slots holding n
    molecules (float32)."""
    per_mol = 3 + (4 if multisite(cfg) else 0)
    out_planes = 9 if multisite(cfg) else 3
    return (slots + per_mol * n + out_planes * slots) * F32


def bound_s(cfg, work):
    """Least time of one force call on the card: the larger of its
    operations over the f32 peak and its bytes over the memory rate."""
    ops = work["pairs"] * pair_ops(cfg)
    nbytes = force_bytes(cfg, work["n"], work["slots"])
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def roofline_percent(trace, pattern):
    """The force kernel's share of its roofline, in %: the bound over its
    mean device time per launch; None where no such kernel ran."""
    total, launches = trace.kernel_time_s(pattern)
    if not launches or total <= 0:
        return None
    return 100.0 * bound_s(trace.work["cfg"], trace.work) / (total / launches)


def nonforce_ms(trace, pattern):
    """Device busy time per step outside the force kernel, in ms."""
    total, launches = trace.kernel_time_s(pattern)
    if not launches:
        return None
    return (trace.busy_s - total) / trace.steps * 1e3


def step_mfu(trace):
    """The whole step's share of the card's float32 peak, in %: the
    operations the state's in-cutoff pairs need times the steps, over
    the traced window's wall time."""
    w = trace.work
    if not trace.steps or trace.window_s <= 0 or not w.get("pairs"):
        return None
    ops = w["pairs"] * pair_ops(w["cfg"]) * trace.steps
    return 100.0 * ops / trace.window_s / PEAK_F32_FLOPS
