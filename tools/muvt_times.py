"""The ensemble and state-changing-plugin phases of chip_smoke.py alone,
on one NVIDIA GPU.

    python3 tools/muvt_times.py [--phases small,nemd-small,muvt,nemd]

Builds the CUDA kernels, then runs chip_smoke's ensembles-small (the
muVT driver on the card against the CPU, f64: 1CLJ with CavityWriter
and WidomInsertion on K3, 2CLJQ on K5, the cell-table probe),
nemd-small (the sixteen plugins on the JAX tests' scenes, card against
CPU), muvt (the evaporation-class muVT film, N ~ 4.2e6, on K3: ms/step
with and without GCMC, a cycle's launches, K3 against its plain
version) and nemd (the film under MettDeamon, its FeedrateDirector, a
Mirror type 5 sink and DistControl, on K5; K5 against its plain
version).  Each phase prints its line(s); a
failed check raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="small,nemd-small,muvt,nemd")
    phases = ap.parse_args().phases.split(",")
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    cs.phase_build()
    if "small" in phases:
        cs.phase_ensembles_small("cuda")
    if "nemd-small" in phases:
        cs.phase_nemd_small("cuda")
    if "muvt" in phases:
        cs.phase_muvt("cuda", smi)
    if "nemd" in phases:
        cs.phase_nemd("cuda", smi)


if __name__ == "__main__":
    main()
