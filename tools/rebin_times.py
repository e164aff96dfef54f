"""Kernel K2 (the shift-merge rebin) of several checkouts side by side on
one NVIDIA GPU.

    python3 tools/rebin_times.py [--variant TAG=ROOT] ... [--reps 20]
        [--check TAG] ...

ROOT is the root of a checkout of this repository (e.g. a parent commit's
from `git archive`; default: this one, tag "tree").  Each variant runs in
a process of its own (the checkouts' packages share a name), in turns
A B ... B A, on the full-width 1CLJ state of chip_smoke.py 15 steps after
its start (N = 4,194,304, f32, grid (56,60,60), cap 32; the RMM engine
rebins every 16 steps, so this is the state its next rebin takes).  It
times, with CUDA events, ops/cuda_rebin.rebin_shift alone on the folded
11-column stack and the engine's whole shift rebin (RMMSimulation.
_rebin_shift: the Kahan fold, K2, the split back into planes and
forces), and holds K2's output bit-identical to the plain version's.
With --check TAG the variant first runs its chip_smoke.py phase K2;
with --profile each run also reports the device time of each CUDA
kernel of K2 (its passes), from torch.profiler over `reps` calls.
Prints one JSON line per run and variant.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_times(fn, reps):
    """{CUDA kernel name: mean device ms a call} of fn() over reps calls,
    from torch.profiler (one warm-up call first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t > 0:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


def child(root, reps, check, prof):
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from ls1_mardyn_tpu_torch.ops import cuda_rebin

    if check:
        cs.phase_k2("cuda")
    sim = cs.make_sim(2, "cuda")
    sim.engine.prepare_start()
    rsim = sim.engine.sim
    sim.run(steps=rsim.rebin_every - 1, print_every=0)
    big = rsim._fold(rsim.state)
    kw = dict(dims=rsim.spec.dims, cap=rsim.spec.cap, cell_len=rsim.cell_len,
              sentinel=rsim.sentinel)
    out, ovf = cuda_rebin.rebin_shift(big, **kw)
    ref, ovf_ref = cuda_rebin.rebin_shift_reference(big, **kw)
    same = bool(torch.equal(out, ref)) and not bool(ovf) and not bool(ovf_ref)
    extra = {}
    if prof:
        extra["k2_kernels_ms"] = kernel_times(
            lambda: cuda_rebin.rebin_shift(big, **kw), reps)
    print(json.dumps({
        "root": str(root), "grid": list(rsim.spec.dims), "cap": rsim.spec.cap,
        "bit_identical": same,
        "moved": int((out[:, :, 7] != big[:, :, 7]).sum()),
        "k2_ms": cs.cuda_ms(lambda: cuda_rebin.rebin_shift(big, **kw), reps),
        "rebin_ms": cs.cuda_ms(lambda: rsim._rebin_shift(rsim.state), reps),
        "gpu": torch.cuda.get_device_name(0), **extra}), flush=True)
    if not same:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=ROOT, a checkout's root")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check", action="append", default=[], metavar="TAG")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child), args.reps, bool(args.check), args.profile)
        return
    variants = dict(v.split("=", 1) for v in args.variant) or {"tree": str(ROOT)}
    order = list(variants) + list(variants)[::-1]
    checked = set()
    for tag in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               str(Path(variants[tag]).resolve()), "--reps", str(args.reps)]
        if tag in args.check and tag not in checked:
            cmd += ["--check", tag]
            checked.add(tag)
        if args.profile:
            cmd.append("--profile")
        res = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(res.stderr[-3000:])
        lines = res.stdout.strip().splitlines() or ["{}"]
        print("\n".join(lines[:-1]), flush=True)
        try:
            print(json.dumps({"variant": tag, **json.loads(lines[-1])}), flush=True)
        except json.JSONDecodeError:
            print(lines[-1], flush=True)
        if res.returncode != 0:
            sys.exit(res.returncode)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
