"""Equilibrated start states of the benchmark's configurations.

    python3 benchmark/make_start.py --config <name> --steps <n> [--out <file>]

A configuration whose start is of kind "npz" (configs/<name>.json) runs
from a committed state of one periodic cell, tiled.  This script makes
that state: n / tiles^3 molecules on the lattice of scene.py at the
configuration's density, uniformly random orientations, Maxwell-
Boltzmann velocities (a fixed seed), then `--steps` steps of
ls1_mardyn_tpu_torch's MDSimulation at the configuration's temperature
(velocity scaling) on the card, so that the lattice melts and the fluid
relaxes.  It writes positions, orientations and angular momenta
(float32) and the cell's edge to the configuration's start file (or
--out), prints its SHA-256 for the configuration, and the temperature
and potential energy every --every steps on standard error.
"""

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from benchmark import harness, program, scene  # noqa: E402

SEED = 20011226  # the draws of the lattice's orientations and velocities


def libs_of(config):
    """The kernels of every cell that runs `config`."""
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
    out = []
    for w in spec["workloads"]:
        if w["config"] == config:
            cell = harness.load_json(harness.BENCH, "cells", w["name"] + ".json")
            out += [x for x in cell["libs"] if x not in out]
    return out


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--every", type=int, default=1000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.cache_env()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cfg = harness.load_json(harness.BENCH, "configs", args.config + ".json")
    t = int(cfg["start"]["tiles"])
    small = dict(cfg, n=int(cfg["n"]) // t ** 3, start={"kind": "lattice"})
    if small["n"] * t ** 3 != int(cfg["n"]):
        raise ValueError(f"n = {cfg['n']} is not {t}^3 times a whole cell")
    start = scene.start_state(small, SEED)
    md = program.build(small, {"force_mode": "auto"}, {"libs": libs_of(args.config)},
                       start, "cuda")
    md.engine.prepare_start()
    t0 = time.time()
    done = 0
    while done < args.steps:
        k = min(args.every, args.steps - done)
        gv = md.run(steps=k, print_every=0)
        done += k
        print(f"step {done}: T {float(gv.temperature):.6f} U/N {float(gv.upot):.6f} "
              f"p {float(gv.pressure):.6f} ({time.time() - t0:.1f} s; engine "
              f"{type(md.engine).__name__})", file=sys.stderr, flush=True)
    s = program.snapshot(md, "cpu")
    box = float(start["box"][0])
    out = args.out or os.path.join(harness.ROOT, cfg["start"]["file"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    arrays = dict(r=(s["r"].numpy() % box).astype(np.float32), box=np.float64(box))
    if scene.rotates(cfg):
        arrays.update(q=s["q"].numpy().astype(np.float32),
                      angmom=s["L"].numpy().astype(np.float32))
    with open(out, "wb") as f:
        np.savez(f, **arrays)
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(json.dumps({"config": args.config, "file": out, "sha256": digest,
                      "n": len(s["r"]), "box": box, "steps": done,
                      "temperature": float(gv.temperature), "upot": float(gv.upot),
                      "pressure": float(gv.pressure)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
