"""Command-line interface (the counterpart of ls1_mardyn_tpu/cli.py).

Mirrors the reference binary's UX (MarDyn.cpp:35-57, 134-279):
``python -m ls1_mardyn_tpu_torch [options] <config.xml>`` with
--steps/-N, --final-checkpoint, --loop-abort-time, --timed-checkpoint,
--print-meminfo, --profile/--profile-steps, -S, --logfile,
--verbose/-v, --legacy-cell-processor (the plain general traversal),
--precision, --force-mode, --print-every and --tests, plus --device
(default cuda; the CPU only on request).  The JAX CLI's --parallel
comes with the multi-device slice.
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
    p.add_argument("--loop-abort-time", type=float, default=0.0,
                   help="abort the loop after this many wall seconds")
    p.add_argument("--timed-checkpoint", type=float, default=0.0,
                   help="write timed.restart.dat and stop after this many "
                        "wall seconds (Simulation.cpp:1169-1175)")
    p.add_argument("--print-meminfo", action="store_true",
                   help="print host and device memory usage after the run "
                        "(MemoryProfiler role)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace (host and "
                        "device) of a few steady-state steps into "
                        "DIR/trace.json (the TaskTimingProfiler/PAPI role, "
                        "Simulation.cpp:1249-1254, utils/Timer.h:14-23; "
                        "view with ui.perfetto.dev)")
    p.add_argument("--profile-steps", metavar="A:B", default="10:15",
                   help="step range (A, B] traced by --profile")
    p.add_argument("-S", "--sigsegv-handler", action="store_true",
                   help="install a fault handler that prints a backtrace "
                        "on crashes (SigsegvHandler.h:26-34)")
    p.add_argument("--logfile", default=None, help="log file")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--legacy-cell-processor", action="store_true",
                   help="use the plain general cell traversal even for "
                        "1CLJ (--force-mode cells)")
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
    p.add_argument("--tests", action="store_true", help="run the unit tests")
    p.add_argument("--test-dir", default="tests", help="test directory")
    return p


def _parse_range(s: str):
    a, _, b = s.partition(":")
    return (int(a), int(b or (int(a) + 5)))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ls1_mardyn_tpu_torch.utils.logger import init_logger

    log = init_logger(verbose=args.verbose, logfile=args.logfile)

    if args.sigsegv_handler:
        import faulthandler

        faulthandler.enable()

    if args.tests:
        import pytest

        return pytest.main(["-x", "-q", args.test_dir])

    if not args.config:
        build_parser().print_help()
        return 1

    from ls1_mardyn_tpu_torch.driver import MDSimulation

    dtype = torch.float64 if args.precision == "f64" else torch.float32
    force_mode = "cells" if args.legacy_cell_processor else args.force_mode
    sim = MDSimulation.from_xml(args.config, dtype=dtype, device=args.device,
                                force_mode=force_mode)
    sim.run(
        steps=args.steps,
        print_every=args.print_every,
        final_checkpoint=args.final_checkpoint,
        loop_abort_time=args.loop_abort_time,
        timed_checkpoint=args.timed_checkpoint,
        profile_dir=args.profile,
        profile_steps=_parse_range(args.profile_steps),
    )
    if args.print_meminfo:
        from ls1_mardyn_tpu_torch.utils.meminfo import print_meminfo

        print_meminfo(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
