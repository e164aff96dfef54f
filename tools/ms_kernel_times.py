"""K5 and K6 of several kernel source trees side by side on one NVIDIA GPU.

    python3 tools/ms_kernel_times.py [--variant TAG=DIR[:FLAGS] ...] [--reps 5] [--ux]

Builds csrc/ms_packed.cu (K5) and csrc/ms_dense.cu (K6) of each variant
(tools/kernel_variants.py: DIR a copy of ls1_mardyn_tpu_torch/csrc, e.g.
a parent commit's from `git archive`, and optional nvcc flags; default:
the checkout's own csrc, tag "tree") and prints each library's ptxas
report by kernel instantiation (registers, spills, shared memory; K5's
"f32 half" is the half shell, "f32 full" the double-sided walk).  Each
variant is then held against the plain versions on chip_smoke.py's K5
and K6 scenes (f32 and f64, every case).  Every variant's kernels are
timed with CUDA events, in turns A B ... B A so that the variants
compare within one call on one card, and held against the plain
versions there (each output's error relative to its max, as
chip_smoke.py reports it), on:
  K5 co2  the benchmark's CO2 state (benchmark/starts/co2_2cljq_1m.npz
          tiled as the cell co2_2cljq_1m.nvt tiles it, N = 1,048,576,
          f32), on the packed rows the benchmark's program builds
          ((27,27,27) cap 96);
  K5, K6  the full-width 2CLJ+quadrupole state of chip_smoke.py
          (N = 1,061,208, rho 0.45, rc 6.2, f32): K5 on the packed rows
          that force_mode="auto" builds, K6 on the dense rows of
          "ms_dense".
On the CO2 state it also prints the pairs inside the cutoff that the
site program runs on, on the half shell and on the double-sided walk
(counted by K5's plain version with the pair function stubbed).
With --ux, uX (the quadrupole energy sum, which nearly cancels on the
chip_smoke start state) of each variant's K5 and K6 and of the f32 plain
versions is held against the f64 plain version on the same state (the
f32 inputs cast to f64), which says which side of the f32 comparison is
off.
"""

import argparse
import json
import os
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_variants as kv  # noqa: E402

LIBS = ("ms_packed", "ms_dense")
CO2_CELL = "co2_2cljq_1m.nvt"


def k5_call(sim):
    """K5's arguments on the packed path of an MDSimulation."""
    path, mol = sim.engine._force_fn, sim.engine.mol
    nx, ny, nz = path.spec.dims
    tbl, r_i, r_j, _, _ = path._build_views(mol)
    return (tbl, r_i, r_j), dict(
        Wp=path.Wp, Wjp=path.Wjp, cell_plane=path.cell_plane, nx=nx, ny=ny,
        nz=nz, cap=path.spec.cap, box=path.spec.box, rc2=path.rc2,
        rc2_lj=path.rc2_lj, screen_alpha=path.screen_alpha, meta=path.meta)


def co2_inputs():
    """K5's arguments on the benchmark's CO2 state, built as the
    benchmark's program builds it (seed 1: the seed draws only the
    velocities)."""
    from benchmark import harness, program, scene
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath

    _, _, cfg, traffic, cell = harness.find_cell(CO2_CELL)
    sim = program.build(cfg, traffic, cell, scene.start_state(cfg, 1), "cuda")
    path = sim.engine._force_fn
    cs.check(isinstance(path, CudaMultiSitePackedPath)
             and path.spec.dims == (27, 27, 27) and path.spec.cap == 96,
             f"{CO2_CELL}: {type(path).__name__} {path.spec}")
    call = k5_call(sim)
    del sim
    return call


def full_width_inputs():
    """K5's and K6's arguments on chip_smoke.py's full-width multi-site
    state."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation

    data, _ = cs.lattice_scene(cs.N_MS, cs.RHO_MS, "2cljq", rc=cs.RC_MS)
    calls = {}
    for key, mode in (("K5", "auto"), ("K6", "ms_dense")):
        sim = MDSimulation(cs.scene_config(data.box, cs.RC_MS),
                           phase_space_data=data, device="cuda",
                           force_mode=mode)
        if key == "K5":
            calls[key] = k5_call(sim)
        else:
            path, mol = sim.engine._force_fn, sim.engine.mol
            nx, ny, nz = path.spec.dims
            r_i, _ = path.layout(mol)
            calls[key] = ((r_i, path.x_halo(r_i).contiguous()), dict(
                nx=nx, ny=ny, nz=nz, cap=path.spec.cap, box=path.spec.box,
                rc2=path.rc2, rc2_lj=path.rc2_lj,
                screen_alpha=path.screen_alpha, meta=path.meta))
        del sim
    return calls


def evaluated_pairs(args, kw, half):
    """Pairs inside the cutoff that the site program runs on in one K5
    call on the half shell (half) or on the double-sided walk, counted by
    K5's plain version with the pair function stubbed."""
    from ls1_mardyn_tpu_torch.ops import cuda_ms_packed as P

    n = [0]

    def stub(pi, pj, drm, com2, **_):
        n[0] += drm.shape[0]
        z = drm.new_zeros(())
        return drm.new_zeros((drm.shape[0], 9)), z, z, z

    saved = P.pair_block, P.ms_half_shell
    P.pair_block = stub
    P.ms_half_shell = lambda z_halo: half and not z_halo
    try:
        P.multisite_cell_forces_packed_reference(*args, **kw)
    finally:
        P.pair_block, P.ms_half_shell = saved
    # the half shell's plain version runs the pair function twice a batch
    # (i's side, then j's torque)
    return n[0] // 2 if half else n[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=DIR[:FLAGS] (tools/kernel_variants.py)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ux", action="store_true",
                    help="uX of K5, K6 and the f32 plain versions against "
                         "the f64 plain version")
    args = ap.parse_args()
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)
    from ls1_mardyn_tpu_torch.ops import _build, cuda_ms, cuda_ms_packed

    variants = kv.parse(args.variant, ROOT / "ls1_mardyn_tpu_torch" / "csrc")
    libs = kv.build(variants, LIBS)
    for tag in libs:
        for lib in LIBS:
            log = (_build.BUILD_DIR / "variants" / tag / f"lib{lib}.log").read_text()
            cs.say("ptxas", variant=tag, lib=lib,
                   kernels=json.dumps(cs.ptxas_report(lib, log=log)))
    for tag, lib in libs.items():
        kv.use(lib)
        cs.say("check", variant=tag)
        cs.phase_k5("cuda")
        cs.phase_k6("cuda")
    calls = {"K5 co2": co2_inputs(), **full_width_inputs()}
    a, kw = calls["K5 co2"]
    half, full = evaluated_pairs(a, kw, True), evaluated_pairs(a, kw, False)
    cs.say("pairs", state=CO2_CELL, half_shell=half, double_sided=full,
           ratio=f"{half / full:.6f}")
    kernels = {"K5 co2": cuda_ms_packed.multisite_cell_forces_packed,
               "K5": cuda_ms_packed.multisite_cell_forces_packed,
               "K6": cuda_ms.multisite_cell_forces}
    times = {tag: {key: [] for key in kernels} for tag in libs}
    order = list(libs) + list(libs)[::-1]
    for tag in order:
        kv.use(libs[tag])
        for key, fn in kernels.items():
            a, kw = calls[key]
            times[tag][key].append(cs.cuda_ms(lambda: fn(*a, **kw), args.reps))
    plain = {"K5 co2": cuda_ms_packed.multisite_cell_forces_packed_reference,
             "K5": cuda_ms_packed.multisite_cell_forces_packed_reference,
             "K6": cuda_ms.multisite_cell_forces_reference}
    ref = {key: fn(*calls[key][0], **calls[key][1]) for key, fn in plain.items()}
    for tag in libs:
        kv.use(libs[tag])
        for key, fn in kernels.items():
            a, kw = calls[key]
            errs = cs.ms_rel_errors(fn(*a, **kw), ref[key])
            cs.say("times", variant=tag, kernel=key,
                   ms=json.dumps([round(t, 3) for t in times[tag][key]]),
                   rel_to_plain=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                   gpu=repr(smi))
    if args.ux:
        for key in ("K5", "K6"):
            a, kw = calls[key]
            a64 = tuple(x.double() if x.is_floating_point() else x for x in a)
            ux64 = float(plain[key](*a64, **kw)[2])
            dev = {"plain_f32": float(ref[key][2])}
            for tag in libs:
                kv.use(libs[tag])
                dev[tag] = float(kernels[key](*a, **kw)[2])
            cs.say("ux", kernel=key, ux_plain_f64=f"{ux64:.9e}",
                   ux=json.dumps({k: f"{v:.9e}" for k, v in dev.items()}),
                   rel_to_plain_f64=json.dumps(
                       {k: f"{abs(v - ux64) / abs(ux64):.3e}" for k, v in dev.items()}),
                   gpu=repr(smi))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
