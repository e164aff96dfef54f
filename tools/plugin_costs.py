"""What the observer plugins cost the full-width RMM path on one NVIDIA GPU.

    python3 tools/plugin_costs.py [--steps 32] [--reps 2] [--freq 10]

Builds chip_smoke.py's main scene (1CLJ NVT, N = 4,194,304, f32,
MDSimulation -> RMMEngine) once and runs windows of `--steps` steps with
no plugin, with a plugin that only sets the Upot/virial cadence, with
one that also reads gv.upot on its steps, with each writer of
chip_smoke.MAIN_WRITERS alone, and with all of them, at writefrequency
`--freq`, in turns, `--reps` times (host clock + synchronize).  Each plugin's hooks are timed on the host clock
(a hook that reads the device waits for it there).  Then one window
bare and one with all writers under torch.profiler: the device's kernel
time and idle share, and launches per step.  With --no-rebin the bare
and all-writer windows run once more in turns with the rebin put off
for the window (the engine's only read of the device a step window,
its overflow flag, gone): a diagnostic of where the writers' time goes.
Each such window starts one step after a rebin and is cut to
2 x rebin_every - 2 steps, within the skin's budget of 2 x rebin_every.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


class _Cadence:
    """No file: `write_frequency` only (the Upot/virial cadence a writer
    sets), and with `read` one device read (gv.upot) on its steps."""

    def __init__(self, freq, read):
        self.name = "read" if read else "cadence"
        self.write_frequency = freq
        self.read = read

    def init(self, sim):
        pass

    def before_event_new_timestep(self, sim, step):
        pass

    before_forces = after_forces = before_event_new_timestep

    def end_step(self, sim, step):
        if self.read and step % self.write_frequency == 0:
            float(sim.last_globals.upot)

    def finish(self, sim):
        pass


def attach(sim, specs):
    """Give sim the plugins of `specs` (built and initialised as the
    driver does), each hook wrapped by a host-clock timer."""
    from ls1_mardyn_tpu_torch.plugins import PluginFactory

    plugins = []
    for spec in specs:
        if isinstance(spec, _Cadence):
            p = spec
        else:
            p = PluginFactory.create(spec.name, spec.params)
        p.init(sim)
        p.hook_s = 0.0
        for hook in ("end_step", "after_forces"):
            fn = getattr(p, hook)

            def timed(s, step, _fn=fn, _p=p):
                t0 = time.perf_counter()
                _fn(s, step)
                _p.hook_s += time.perf_counter() - t0

            setattr(p, hook, timed)
        plugins.append(p)
    sim._plugins = plugins
    return plugins


def profiled(sim, steps):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = cs.timed_window(sim, steps)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    return dict(ms_per_step=round(wall, 3),
                device_kernel_ms_per_step=round(busy / steps, 3),
                device_idle_share=round(max(0.0, 1 - busy / (wall * steps)), 3),
                launches_per_step=round(sum(e.count for e in kernels) / steps, 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--freq", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-rebin", action="store_true")
    args = ap.parse_args()
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    d = cs.fresh_dir("plugin_costs")
    sim = cs.make_sim(2, args.device)
    # warm-up through one rebin (K2's library loads at its first call)
    sim.run(steps=sim.engine.sim.rebin_every + 2, print_every=0)
    specs = {"bare": []}
    specs["cadence"] = [_Cadence(args.freq, read=False)]
    specs["read"] = [_Cadence(args.freq, read=True)]
    for name in cs.MAIN_WRITERS:
        specs[name] = cs.plugin_specs(d, (name,), args.freq)
    specs["all"] = cs.plugin_specs(d, cs.MAIN_WRITERS, args.freq)
    variants = specs
    ms = {k: [] for k in variants}
    hooks = {k: {} for k in variants}
    for _ in range(args.reps):
        for key, names in variants.items():
            plugins = attach(sim, names)
            ms[key].append(cs.timed_window(sim, args.steps)[0])
            for p in plugins:
                h = hooks[key].setdefault(p.name, [])
                h.append(p.hook_s / args.steps * 1e3)
    base = float(np.mean(ms["bare"]))
    for key in variants:
        m = float(np.mean(ms[key]))
        cs.say("plugins", variant=key, steps=args.steps, freq=args.freq,
               ms_per_step=f"{m:.3f}", windows=json.dumps([round(x, 3) for x in ms[key]]),
               over_bare=f"{m / base - 1:+.2%}",
               hook_ms_per_step=json.dumps({k: round(float(np.mean(v)), 4)
                                            for k, v in hooks[key].items()}),
               gpu=repr(smi))
    for key in ("bare", "all"):
        attach(sim, variants[key])
        cs.say("profile", variant=key, steps=args.steps,
               **profiled(sim, args.steps), gpu=repr(smi))
    if args.no_rebin:
        rsim = sim.engine.sim
        every = rsim.rebin_every
        steps = min(args.steps, 2 * every - 2)
        got = {"bare": [], "all": []}
        for _ in range(args.reps):
            for key in got:
                attach(sim, variants[key])
                # up to and through the next rebin
                sim.run(steps=every - rsim._k % every + 1, print_every=0)
                rsim.rebin_every = 10 ** 9
                got[key].append(cs.timed_window(sim, steps)[0])
                rsim.rebin_every = every
        cs.say("no-rebin", steps=steps,
               **{k: json.dumps([round(x, 3) for x in v]) for k, v in got.items()},
               over_bare=f"{np.mean(got['all']) / np.mean(got['bare']) - 1:+.2%}",
               gpu=repr(smi))


if __name__ == "__main__":
    main()
