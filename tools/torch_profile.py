"""Where the time goes in the port's engines on one NVIDIA GPU.

    python3 tools/torch_profile.py [--steps 16]

Drives chip_smoke.py's full-width scenes: the 1CLJ NVT fluid (N =
4,194,304, f32) through MDSimulation -> RMMEngine and through
MDSimulation(force_mode="pallas") -> SingleChipSimulation -> CudaLJPath,
and the 2CLJ+quadrupole fluid (N = 1,061,208, rc 6.2, f32) through
MDSimulation(force_mode="auto") -> SingleChipSimulation ->
CudaMultiSitePackedPath.  For each it prints ms/step over
a window (host clock + synchronize), a torch.profiler table of the
device kernels of that window with the device's busy share, and for the
general and multi-site engines the parts of one step timed alone with
CUDA events on the engine's own state: half-kick and drift, wrap, the
force path's build of the kernel's layout (binning included), its kernel
(K3 or K5), its gather back, and the second half-kick with global
values and thermostat.  The parts are timed back to back, each after a
synchronize, so their sum can differ from the step by what overlaps.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def profile_window(sim, steps):
    from torch.profiler import ProfilerActivity, profile

    sim.run(steps=2, print_every=0)
    ms, _ = cs.timed_window(sim, steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = cs.timed_window(sim, steps)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return ms, wall * steps, busy, rows


def report(tag, sim, steps, smi):
    ms, wall, busy, rows = profile_window(sim, steps)
    cs.say(tag, steps=steps, ms_per_step=f"{ms:.3f}",
           profiled_wall_ms=f"{wall:.1f}", device_kernel_ms=f"{busy:.1f}",
           device_idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
           launches_per_step=f"{sum(r[2] for r in rows) / steps:.0f}",
           gpu=repr(smi))
    for key, t, count in rows[:14]:
        print(f"    {t / steps:8.3f} ms/step  {count / steps:6.1f} launches/step  "
              f"{key[:90]}", flush=True)


def general_parts(sim, smi):
    """One step of the general engine, part by part, on its own state."""
    from ls1_mardyn_tpu_torch.ops.cells import bin_particles, wrap_positions
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw
    from ls1_mardyn_tpu_torch.ops.integrator import upd_pre_force

    eng = sim.engine
    path = eng._force_fn
    cfg, pp = eng.config, eng.pp
    mol, forces = eng.mol, eng.forces
    spec = path.spec
    moved = upd_pre_force(mol, forces, pp, cfg.dt)
    moved = dataclasses.replace(moved, r=wrap_positions(moved.r, eng.box))
    r_i, _ = path.layout(moved)
    f_new, macro, _ = path(moved)
    f_new, macro = eng._fold_extra(moved, f_new, macro)
    kw = dict(dims=spec.dims, cap=spec.cap, cell_len=spec.cell_len,
              eps24=path.eps24, sig2=path.sig2, shift6=path.shift6, rc2=path.rc2)
    t = {
        "upd_pre_force": cs.cuda_ms(
            lambda: upd_pre_force(mol, forces, pp, cfg.dt), 5),
        "wrap_positions": cs.cuda_ms(
            lambda: wrap_positions(moved.r, eng.box), 5),
        "bin_particles": cs.cuda_ms(
            lambda: bin_particles(moved.r, moved.valid, spec), 5),
        "layout (bin + gather)": cs.cuda_ms(lambda: path.layout(moved), 5),
        "K3": cs.cuda_ms(lambda: lj_cell_forces_cw(r_i, **kw), 5),
        "force path (layout + K3 + gather back)": cs.cuda_ms(
            lambda: path(moved), 5),
        "step_post (kick, globals, thermostat)": cs.cuda_ms(
            lambda: eng._step_post(moved, f_new, macro, 1), 5),
        "whole step": cs.cuda_ms(lambda: eng._step(mol, forces, 1), 5),
    }
    cs.say("general-parts", ms=json.dumps({k: round(v, 3) for k, v in t.items()}),
           gpu=repr(smi))


def multisite_parts(sim, smi):
    """One step of the multi-site engine (K5 path), part by part."""
    from ls1_mardyn_tpu_torch.ops.cells import bin_particles, wrap_positions
    from ls1_mardyn_tpu_torch.ops.integrator import upd_pre_force

    eng = sim.engine
    path = eng._force_fn
    cfg, pp = eng.config, eng.pp
    mol, forces = eng.mol, eng.forces
    moved = upd_pre_force(mol, forces, pp, cfg.dt)
    moved = dataclasses.replace(moved, r=wrap_positions(moved.r, eng.box))
    tbl, r_i, r_j, bins, prefix = path._build_views(moved)
    res = path.kernel_packed(tbl, r_i, r_j)
    f_new, macro = path.unpack(res, moved, bins, prefix)
    f_new, macro = eng._fold_extra(moved, f_new, macro)
    t = {
        "upd_pre_force": cs.cuda_ms(
            lambda: upd_pre_force(mol, forces, pp, cfg.dt), 5),
        "wrap_positions": cs.cuda_ms(
            lambda: wrap_positions(moved.r, eng.box), 5),
        "bin_particles": cs.cuda_ms(
            lambda: bin_particles(moved.r, moved.valid, path.spec), 5),
        "build (bin, pack, rotate, j rows)": cs.cuda_ms(
            lambda: path._build_views(moved), 5),
        "K5": cs.cuda_ms(lambda: path.kernel_packed(tbl, r_i, r_j), 5),
        "gather back": cs.cuda_ms(
            lambda: path.unpack(res, moved, bins, prefix), 5),
        "force path (build + K5 + gather back)": cs.cuda_ms(
            lambda: path(moved), 5),
        "step_post (kick, globals, thermostat)": cs.cuda_ms(
            lambda: eng._step_post(moved, f_new, macro, 1), 5),
        "whole step": cs.cuda_ms(lambda: eng._step(mol, forces, 1), 5),
    }
    cs.say("multisite-parts", grid=path.spec.dims, cap=path.spec.cap,
           planes=path.Pb, ms=json.dumps({k: round(v, 3) for k, v in t.items()}),
           gpu=repr(smi))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    cs.phase_build()
    sim = cs.make_sim(2, "cuda")
    report("rmm", sim, args.steps, smi)
    del sim
    torch.cuda.empty_cache()
    sim = cs.make_sim(2, "cuda", force_mode="pallas")
    report("general", sim, args.steps, smi)
    general_parts(sim, smi)
    del sim
    torch.cuda.empty_cache()
    from ls1_mardyn_tpu_torch.driver import MDSimulation

    data, _ = cs.lattice_scene(cs.N_MS, cs.RHO_MS, "2cljq", rc=cs.RC_MS)
    sim = MDSimulation(cs.scene_config(data.box, cs.RC_MS),
                       phase_space_data=data, device="cuda")
    report("multisite", sim, args.steps, smi)
    multisite_parts(sim, smi)


if __name__ == "__main__":
    main()
