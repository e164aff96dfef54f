"""K1 and K3 of several kernel designs side by side on one NVIDIA GPU.

    python3 tools/lj_kernel_times.py [--variant TAG=DIR[:FLAGS]] ... [--reps 10] [--walk]

Builds csrc/lj_cells.cu (K1) and csrc/lj_cells_cw.cu (K3) of each
variant (tools/kernel_variants.py: DIR a copy of
ls1_mardyn_tpu_torch/csrc, e.g. a parent commit's from `git archive` or
an edited copy, and optional nvcc flags; default: the checkout's own
csrc, tag "tree") and prints each library's ptxas report (registers,
spills, shared memory).  Each variant is first held against the plain
versions by chip_smoke.py's K1 and K3 phases (f32 and f64, every case,
exact in-cutoff counts).  Then every variant is timed with CUDA events,
in turns A B ... B A, on the full-width 1CLJ start state of
chip_smoke.py (N = 4,194,304, f32): K1 on the RMM engine's planes (grid
(56,60,60), cap 32, without u6/virial as the RMM path runs most steps),
K3 on the general path's layout (grid (69,69,69), cap 32, with
u6/virial as that path runs it) and K3 on K1's grid (without
u6/virial); and held against the plain versions there.  With --walk the
j slots a warp of the warp skeleton (csrc/lj_warp.cuh) stages, keeps
and walks on each state are counted on the host
(chip_smoke.lj_warp_walk), for the design steps a (no box cull, no
half-warp split), b (cull, no split) and c (both, the shipped kernel).
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

LIBS = ("lj_cells", "lj_cells_cw")


def full_width_inputs():
    """The calls to time on the full-width 1CLJ start state: {key: (fn,
    plain, args, kw)}."""
    from ls1_mardyn_tpu_torch.ops import cuda_lj

    calls = {}
    sim = cs.make_sim(2, "cuda")
    sim.engine.prepare_start()
    rsim = sim.engine.sim
    lj = dict(eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    r4 = rsim.state.planes[:, :, :4, :]
    kw = dict(dims=rsim.spec.dims, cap=rsim.spec.cap, cell_len=rsim.cell_len, **lj)
    calls["K1"] = (cuda_lj.lj_cell_forces, cuda_lj.lj_cell_forces_reference,
                   (r4,), dict(kw, compute_macro=False))
    calls["K3 on K1's grid"] = (cuda_lj.lj_cell_forces_cw,
                                cuda_lj.lj_cell_forces_cw_reference,
                                (r4.contiguous(),), dict(kw, compute_macro=False))
    gen = cs.make_sim(2, "cuda", force_mode="pallas")
    gen.engine.prepare_start()
    path = gen.engine._force_fn
    r_i, _ = path.layout(gen.engine.mol)
    calls["K3"] = (cuda_lj.lj_cell_forces_cw, cuda_lj.lj_cell_forces_cw_reference,
                   (r_i,), dict(dims=path.spec.dims, cap=path.spec.cap,
                                cell_len=path.spec.cell_len, eps24=path.eps24,
                                sig2=path.sig2, shift6=path.shift6, rc2=path.rc2))
    del sim, gen
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=DIR[:FLAGS] (tools/kernel_variants.py)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--walk", action="store_true")
    args = ap.parse_args()
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    libs = kv.build(kv.parse(args.variant, ROOT / "ls1_mardyn_tpu_torch" / "csrc"),
                    LIBS)
    for tag, lib in libs.items():
        kv.use(lib)
        cs.say("check", variant=tag)
        cs.phase_k1("cuda")
        cs.phase_k3("cuda")
    calls = full_width_inputs()
    if args.walk:
        for key, (_, _, a, kw) in calls.items():
            for step, cull, split in (("a", False, False), ("b", True, False),
                                      ("c", True, True)):
                cs.say("walk", state=key, step=step,
                       walk=json.dumps(cs.lj_warp_walk(
                           a[0], kw["dims"], kw["cap"], kw["cell_len"],
                           kw["rc2"], cull=cull, split=split)))
    times = {tag: {key: [] for key in calls} for tag in libs}
    order = list(libs) + list(libs)[::-1]
    for tag in order:
        kv.use(libs[tag])
        for key, (fn, _, a, kw) in calls.items():
            times[tag][key].append(cs.cuda_ms(lambda: fn(*a, **kw), args.reps))
    ref = {key: plain(*a, **dict(kw, compute_macro=True))
           for key, (_, plain, a, kw) in calls.items()}
    for tag in libs:
        kv.use(libs[tag])
        for key, (fn, _, a, kw) in calls.items():
            rel = max(cs.rel_errors(fn(*a, **dict(kw, compute_macro=True)),
                                    ref[key]))
            cs.check(rel <= 1e-5, f"{tag} {key}: rel err {rel}")
            cs.say("times", variant=tag, kernel=key, grid=kw["dims"],
                   macro=kw.get("compute_macro", True),
                   ms=json.dumps([round(t, 3) for t in times[tag][key]]),
                   rel_to_plain=f"{rel:.2e}", gpu=repr(smi))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
