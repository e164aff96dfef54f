"""Command-line interface (the counterpart of ls1_mardyn_tpu/cli.py).

Mirrors the reference binary's UX (MarDyn.cpp:35-57, 134-279):
``python -m ls1_mardyn_tpu_torch [options] <config.xml>`` with
--steps/-N, --final-checkpoint, --precision, --force-mode and
--print-every, plus --device (default cuda; the CPU only on request).
"""

from __future__ import annotations

import argparse
import sys

import torch


def build_parser():
    p = argparse.ArgumentParser(
        prog="ls1-mardyn-tpu-torch",
        description="Molecular dynamics on PyTorch + CUDA "
                    "(ls1-MarDyn capability set)",
    )
    p.add_argument("config", nargs="?", help="XML config file")
    p.add_argument("-N", "--steps", type=int, default=None,
                   help="override number of timesteps")
    p.add_argument("--final-checkpoint", metavar="FILE", default=None,
                   help="write an ASCII .inp checkpoint after the last step")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails when CUDA is "
                        "absent unless --device cpu is given)")
    p.add_argument("--precision", choices=("f32", "f64"), default="f32")
    p.add_argument("--force-mode",
                   choices=("auto", "pallas", "ms_packed", "ms_dense", "cells",
                            "rmm"),
                   default="auto",
                   help="auto: RMM engine for 1CLJ scenes, else the general "
                        "engine; pallas: the cell kernels on the general "
                        "engine; ms_packed / ms_dense: the packed (K5) / "
                        "dense (K6) multi-site kernel; cells: plain general "
                        "multi-site traversal")
    p.add_argument("--print-every", type=int, default=100)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ls1_mardyn_tpu_torch.utils.logger import init_logger

    init_logger()
    if not args.config:
        build_parser().print_help()
        return 1

    from ls1_mardyn_tpu_torch.driver import MDSimulation

    dtype = torch.float64 if args.precision == "f64" else torch.float32
    sim = MDSimulation.from_xml(args.config, dtype=dtype, device=args.device,
                                force_mode=args.force_mode)
    sim.run(
        steps=args.steps,
        print_every=args.print_every,
        final_checkpoint=args.final_checkpoint,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
