"""The long-range phases of chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/longrange_times.py [--phases small,full,solvers]

Builds the CUDA kernels, then runs chip_smoke's longrange-small (the
molten salt under direct Ewald, SPME and FMM, water-class N = 4096 on K5,
a planar 1CLJ slab on K3: card against CPU, f64), longrange (water-class
N = 1,000,000 on SPME + K5, f32, a step timed part by part) and
longrange-solvers (SPME against direct Ewald, the periodic FMM against
SPME, the adaptive FMM against the direct sum, the direct/SPME
crossover).  Each phase prints its line(s); a failed check raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="small,full,solvers")
    phases = ap.parse_args().phases.split(",")
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    cs.phase_build()
    if "small" in phases:
        cs.phase_longrange_small("cuda")
    if "full" in phases:
        cs.phase_longrange("cuda", smi)
    if "solvers" in phases:
        cs.phase_longrange_solvers("cuda", smi)


if __name__ == "__main__":
    main()
