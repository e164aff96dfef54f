"""One run of one benchmark cell (see run.py for the command line).

A cell (BENCHMARK.json "workloads") names a configuration
(configs/<config>.json: the model, its sizes and its start) and a
traffic mix (traffic/<traffic>.json: how MDSimulation is driven); its
own file cells/<name>.json names the end-to-end rate it reports
(rate_metric), says which engine, force path and kernel counters the
run must show, how many steps warm up and are traced, and gives the
limit of every number that decides `correct`.  Per-layer metrics
are readers metrics/<metric>.py, each with read(trace) -> value or None.
Nothing here names a cell, a configuration or a metric: a new one is a
new file and a new BENCHMARK.json entry.

A run, in order: the scene from --seed; MDSimulation of
ls1_mardyn_tpu_torch on the card with only the cell's kernels built;
its start held against the inputs; warm-up; the window (--trace 0:
MDSimulation.run with the CLI's print cadence until --seconds have
passed, ended by a synchronize; --trace 1: a torch.profiler window of
the cell's trace_steps); the device's peak memory; one more step
through MDSimulation.run; the program freed; the plain reference
(reference/) on the states the program produced; the last line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import check, program, scene
from benchmark import trace as tracing
from benchmark.reference.integrate import leapfrog_step
from benchmark.reference.model import Model

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ls1_mardyn_tpu")
BIG_STEPS = 10 ** 9


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name, root=ROOT):
    """(BENCHMARK.json, its workload entry, configuration, traffic, cell
    file) of the cell `name`."""
    spec = load_json(root, "BENCHMARK.json")
    match = [w for w in spec["workloads"] if w["name"] == name]
    if not match:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = match[0]
    bench = os.path.join(root, "benchmark")
    return (spec, w, load_json(bench, "configs", w["config"] + ".json"),
            load_json(bench, "traffic", w["traffic"] + ".json"),
            load_json(bench, "cells", name + ".json"))


def metric_readers(spec, workload, root=ROOT):
    """{metric: (unit, read)} of the per-layer metrics of `workload`."""
    out = {}
    for m in spec["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        out[m["name"]] = (m["unit"], mod.read)
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (ls1_mardyn_tpu_torch is not ls1_mardyn_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env():
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own into build/kernels/); no library may load JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Run:
    """One cell's run, stage by stage: set_up (the scene, the program,
    its start read back, warm-up), then a window (timed or traced), then
    end (the program's end state, one more step, the program freed),
    then judge (the reference and the numbers).  The control script
    (control.py) drives the same stages with a fixed step count."""

    def __init__(self, name, seed, device="cuda", edit=None):
        self.spec, self.w, self.cfg, self.traffic, self.cell = find_cell(name)
        if edit is not None:
            edit(self.cfg, self.traffic, self.cell)
        self.name, self.seed, self.device = name, seed, device
        self.on_card = torch.device(device).type == "cuda"
        self.every = int(self.traffic["print_every"])

    def set_up(self):
        self.start = scene.start_state(self.cfg, self.seed)
        self.md = program.build(self.cfg, self.traffic, self.cell, self.start,
                                self.device)
        program.check_path(self.md, self.cell)
        self.md.engine.prepare_start()
        self.s0 = program.snapshot(self.md, "cpu")
        self.md.run(steps=int(self.cell["warm_steps"]), print_every=self.every)

    def window(self, seconds=None, steps=None, traced=False):
        """Steps for `seconds` (MDSimulation.run with loop_abort_time),
        or `steps` steps, profiled with `traced`; returns (steps, window
        seconds).  The kernel counters must move as the cell says."""
        before = program.read_counters(self.cell)
        step0 = self.md.step
        self.trace = None
        if traced:
            self.trace = tracing.profiled_run(self.md, steps, self.every,
                                              os.environ.get("TMPDIR", "/tmp"))
            window_s = self.trace.window_s
        else:
            t1 = time.perf_counter()
            if seconds is not None:
                self.md.run(steps=BIG_STEPS, print_every=self.every,
                            loop_abort_time=float(seconds))
            else:
                self.md.run(steps=steps, print_every=self.every)
            window_s = time.perf_counter() - t1
        done = self.md.step - step0
        program.check_path(self.md, self.cell)  # a re-spec rebuilds the engine
        if self.on_card:  # the counters count CUDA launches only
            program.check_counters(self.cell, before, program.read_counters(self.cell),
                                   done)
        return done, window_s

    def end(self):
        """The program's end state s, one more step through MDSimulation.run
        (state s1, globals g1), then the program freed.  The RMM engine
        first runs on to the step that begins with its shift rebin, so
        that the step checked moves every molecule through K2."""
        ahead = program.steps_to_rebin(self.md)
        if ahead:
            self.md.run(steps=ahead, print_every=self.every)
        if program.steps_to_rebin(self.md):
            raise RuntimeError("the checked step does not begin with the rebin")
        self.s = program.snapshot(self.md)
        gv = self.md.run(steps=1, print_every=self.every)
        self.g1 = {k: float(getattr(gv, k)) for k in ("temperature", "upot", "pressure")}
        self.s1 = program.snapshot(self.md)
        self.dims, self.cap = program.grid(self.md)
        self.slots = self.dims[0] * self.dims[1] * self.dims[2] * self.cap
        del self.md, gv
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def judge(self):
        """(numbers, reference forces of s) of the program's outputs."""
        cfg, dev = self.cfg, self.s["r"].device
        self.model = Model(cfg, dev)
        self.box = torch.tensor(self.start["box"], dtype=torch.float64, device=dev)
        self.rotates = scene.rotates(cfg)
        self.inputs = {k: torch.as_tensor(self.start[k]) for k in ("r", "v", "q")}
        numbers = check.start_numbers(self.s0, self.inputs, self.box.cpu(), self.rotates)
        final, ref = check.final_numbers(
            self.model, self.s, self.s1, self.g1, self.box, float(cfg["timestep"]),
            float(cfg["temperature"]), self.rotates)
        numbers.update(final)
        numbers["molecules"] = check.id_mismatches(self.s1["mid"], len(self.start["r"]))
        return numbers, ref

    def control(self, ref, dtype):
        """The numbers of the reference put in the program's place and
        computed in `dtype` (its sums and positions in float64): inputs
        rounded to dtype for the start, its forces of s and its step
        from s."""
        cfg = self.cfg
        low = Model(cfg, self.s["r"].device, dtype)
        rounded = {k: x.to(dtype).double() for k, x in self.inputs.items()}
        # positions as offsets from their cell's corner (cells of edge
        # rc), as the program keeps them, rounded to dtype
        rc = float(cfg["cutoff"])
        corner = torch.floor(self.inputs["r"] / rc) * rc
        rounded["r"] = corner + (self.inputs["r"] - corner).to(dtype).double()
        numbers = check.start_numbers(rounded, self.inputs, self.box.cpu(), self.rotates)
        f = low.forces(self.s["r"], self.s["q"], self.box)
        s = dict(self.s, F=f["F"].double(), M=f["M"].double())
        s1, g1, _ = leapfrog_step(low, self.s, self.box, float(cfg["timestep"]),
                                  float(cfg["temperature"]), forces=f)
        s1 = {k: x.double() for k, x in s1.items()}
        final, _ = check.final_numbers(
            self.model, s, s1, g1, self.box, float(cfg["timestep"]),
            float(cfg["temperature"]), self.rotates, ref=ref)
        numbers.update(final)
        numbers["molecules"] = 0
        return numbers


def run_cell(name, seed, seconds, trace, device="cuda", t0=None, edit=None):
    """Run the cell once; returns the result dict of the last line.
    `edit(cfg, traffic, cell)` may change the loaded files (tests)."""
    t0 = time.time() if t0 is None else t0
    run = Run(name, seed, device, edit)
    readers = metric_readers(run.spec, name) if trace else {}
    run.set_up()
    setup_s = time.time() - t0
    if trace:
        steps, window_s = run.window(steps=int(run.cell["trace_steps"]), traced=True)
    else:
        steps, window_s = run.window(seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if run.on_card else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package loaded: {found}")
    t2 = time.time()
    run.end()
    numbers, ref = run.judge()
    rows, ok = check.verdict(numbers, run.cell["limits"])
    print(f"run: setup {setup_s:.2f} s, {steps} steps in {window_s:.3f} s, "
          f"check {time.time() - t2:.2f} s, {ref['pairs']} pairs, grid {run.dims} "
          f"cap {run.cap}", file=sys.stderr)

    n = len(run.start["r"])
    if trace:
        tr = run.trace
        tr.work = dict(cfg=run.cfg, pairs=ref["pairs"], n=n, slots=run.slots)
        metrics = {}
        for mname, (unit, read) in readers.items():
            value = read(tr)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": unit}
    else:
        metrics = {run.cell["rate_metric"]: {"value": n * steps / window_s,
                                             "unit": "updates/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev_info = {"platform": "gpu" if run.on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if run.on_card else "cpu",
                "count": int(run.w["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": len(rows),
              "failed": sum(1 for _, v, lim in rows if not v <= lim),
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tracing.breakdown(tr)
    result["steps"] = steps
    result["window_s"] = window_s
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv, t0):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    _, w, _, _, _ = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"error: the cell needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available (no CPU fallback)", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']:.6e} limit {c['limit']:.6e} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
