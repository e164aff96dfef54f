"""Readings that set the limits of `correct` (cells/<name>.json "limits").

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --steps <n> [--out <file.jsonl>]

For each seed, in one process: the cell's set-up, `--steps` steps
through MDSimulation.run, and the numbers a run compares (the program's
readings: the lower end of each limit); for the control seeds also the
control's numbers: the reference put in the program's place and computed
in bfloat16, the precision below the configurations' float32 (the upper
end).  One JSON line per seed on standard output (and appended to
--out).  Needs the card, as a run does.
"""

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import Run, cache_env  # noqa: E402


def readings(name, seeds, control_seeds, steps, device="cuda", edit=None):
    """Yield one dict per seed: the program's numbers and, for a control
    seed, the control's."""
    import torch

    for seed in seeds:
        t0 = time.time()
        run = Run(name, seed, device, edit)
        run.set_up()
        t1 = time.time()
        done, window_s = run.window(steps=steps)
        t2 = time.time()
        run.end()
        numbers, ref = run.judge()
        t3 = time.time()
        control = run.control(ref, torch.bfloat16) if seed in control_seeds else None
        yield {"workload": name, "seed": seed, "steps": done, "window_s": window_s,
               "pairs": ref["pairs"], "program": numbers, "control": control,
               "seconds": {"set_up": t1 - t0, "check": t3 - t2,
                           "control": time.time() - t3}}
        del run, ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cache_env()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (no CPU fallback)", file=sys.stderr)
        return 2
    seeds = [int(x) for x in args.seeds.split(",")]
    ctrl = {int(x) for x in args.control_seeds.split(",") if x}
    for rec in readings(args.workload, seeds, ctrl, args.steps):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
