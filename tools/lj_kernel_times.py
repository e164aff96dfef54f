"""The 1CLJ kernels K1, K3, K4, K7, K8, K9 and K10 of several designs side
by side on one NVIDIA GPU.

    python3 tools/lj_kernel_times.py [--variant TAG=DIR[:FLAGS]] ...
        [--kernels K1,K3,K4,K7,K8,K9,K10] [--no-check TAG] ... [--reps 10]
        [--walk] [--gram-order]

Builds csrc/lj_cells.cu (K1, and K3's half shell),
csrc/lj_cells_cw.cu (K3), csrc/lj_cells_row.cu (K4), csrc/lj_cells_lanej.cu (K7),
csrc/lj_cells_n3l.cu (K8), csrc/lj_cells_zb.cu (K9) and
csrc/lj_packed.cu (K10) of each variant
(tools/kernel_variants.py: DIR a copy of ls1_mardyn_tpu_torch/csrc, e.g.
a parent commit's from `git archive` or an edited copy, and optional
nvcc flags; default: the checkout's own csrc, tag "tree") and prints
each library's ptxas report (registers, spills, shared memory), raw and
by kernel (chip_smoke.ptxas_report: "f32 1" is the half shell's f32
instantiation with u6/virial, "f32 0" without).  Each
variant is first held against the plain versions by chip_smoke.py's
phases of the selected kernels (f32 and f64, every case, exact in-cutoff
counts); --no-check skips that for a variant (a parent tree whose
kernels take fewer cases or compute the function another way), and its
agreement with the plain versions at full width is reported, not held.
Then every variant is timed with CUDA events, in turns A B ... B A, on
the full-width 1CLJ start state of chip_smoke.py (N = 4,194,304, f32):
  K1               the RMM engine's planes (grid (56,60,60), cap 32),
                   without u6/virial as the RMM path runs most steps;
  K1 argon, K8 argon  the RMM engine's planes at the start of the
                   benchmark cell lj_liquid_4m.rmm (chip_smoke.argon_rmm:
                   the argon example at rc 5.154, grid (36,36,36), cap
                   128), without u6/virial, and K1 with it ("K1 argon
                   u6/virial");
  K3 argon         the general path's layout of the same argon start on
                   its own grid, the benchmark cell lj_liquid_4m.general's
                   (chip_smoke.argon_general: (41,41,41) cap 128), with
                   u6/virial as that path runs it and without;
  K3 on K1's grid  the dense state, without u6/virial;
  K3               the general path's layout (grid (69,69,69), cap 32),
                   with u6/virial as that path runs it, and without;
  K4               the general path's layout and its one-cell x halo, with
                   u6/virial (the general path with cw off);
  K4 on K1's grid  the RMM state through the view of its switch cw = False,
                   without u6/virial;
  K7               the same view (the switch lanej), without u6/virial;
  K8               the RMM planes read in place, without u6/virial;
  K9, K9 gram      the RMM planes read in place, without u6/virial;
  K10              the RMM planes packed into pencils (chip_smoke.
                   packed_views), without u6/virial;
and held against the plain versions there.  With --walk the j slots a
warp of the warp skeleton (csrc/lj_warp.cuh) stages, keeps and walks on
each call's state are counted on the host (chip_smoke.lj_warp_walk), for
the design steps a (no box cull, no half-warp split), b (cull, no split)
and c (both, the shipped kernel; for K9 gram with the Gram margin; for
K1 and K8 by the half shell, and for them the full shell's as "full"),
and K10's group walk (chip_smoke.packed_warp_walk).
With --gram-order K9's Gram form in f32 is held, on chip_smoke.py's
check scenes and an 8^3 cut of the RMM state, against the plain version
on the card and on the CPU and against the f64 plain version (the f32
inputs cast), each as max|dF| / max|F|: how far the f32 Gram force moves
with the order of its sums.
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

# libraries and check phase of each kernel (K3's half shell is K1's launch)
KERNELS = {"K1": (("lj_cells",), cs.phase_k1),
           "K3": (("lj_cells_cw", "lj_cells"), cs.phase_k3),
           "K4": (("lj_cells_row",), cs.phase_k4),
           "K7": (("lj_cells_lanej",), cs.phase_k7),
           "K8": (("lj_cells_n3l",), cs.phase_k8),
           "K9": (("lj_cells_zb",), cs.phase_k9),
           "K10": (("lj_packed",), cs.phase_k10)}


def full_width_inputs(kernels):
    """The calls to time on the full-width 1CLJ start state: {key: (fn,
    plain, args, kw, walk options)} for the kernels selected."""
    import functools

    from ls1_mardyn_tpu_torch.ops import cuda_lj, cuda_lj_variants

    calls = {}
    sim = cs.make_sim(2, "cuda")
    sim.engine.prepare_start()
    rsim = sim.engine.sim
    lj = dict(eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    r4 = rsim.state.planes[:, :, :4, :]
    dims, cap = rsim.spec.dims, rsim.spec.cap
    kw = dict(dims=dims, cap=cap, cell_len=rsim.cell_len, **lj)
    fast = dict(kw, compute_macro=False)
    if "K1" in kernels:
        calls["K1"] = (cuda_lj.lj_cell_forces, cuda_lj.lj_cell_forces_reference,
                       (r4,), fast, dict(half=True))
    # K3's walk: the half shell where its inputs allow it
    if "K3" in kernels:
        calls["K3 on K1's grid"] = (cuda_lj.lj_cell_forces_cw,
                                    cuda_lj.lj_cell_forces_cw_reference,
                                    (r4.contiguous(),), fast, dict(half=True))
    V = cuda_lj_variants
    r_i, r_j = rsim._row_views(r4)
    row_walk = dict(j_cells=cuda_lj._row_j_cells(r_j, dims=dims, cap=cap,
                                                 box=rsim.box, local_coords=True))
    row = dict(dims=dims, cap=cap, box=rsim.box, compute_macro=False, **lj)
    if "K4" in kernels:
        calls["K4 on K1's grid"] = (
            cuda_lj.lj_cell_forces_row, cuda_lj.lj_cell_forces_row_reference,
            (r_i, r_j), dict(row, local_coords=True), row_walk)
    if "K7" in kernels:
        calls["K7"] = (V.lj_cell_forces_lanej,
                       functools.partial(cuda_lj.lj_cell_forces_row_reference,
                                         local_coords=True),
                       (r_i, r_j), row, row_walk)
    if "K8" in kernels:
        calls["K8"] = (V.lj_cell_forces_n3l, V.lj_cell_forces_n3l_reference,
                       (r4,), fast, dict(half=True))
    if "K9" in kernels:
        for key, gram in (("K9", False), ("K9 gram", True)):
            calls[key] = (functools.partial(V.lj_cell_forces_zb, gram=gram),
                          functools.partial(V.lj_cell_forces_zb_reference,
                                            gram=gram),
                          (r4,), fast, dict(gram=gram))
    if "K10" in kernels:
        from ls1_mardyn_tpu_torch.ops import cuda_packed as PK

        packed, _, _, tab, meta, _, Wp = cs.packed_views(rsim.state.planes, dims, cap)
        nx, ny, nz = dims
        calls["K10"] = (PK.lj_forces_packed, PK.lj_forces_packed_reference,
                        (packed[:, :, :4].contiguous(), tab, meta),
                        dict(nx=nx, ny=ny, nz=nz, Wp=Wp, box=rsim.spec.box,
                             compute_macro=False, **lj), dict(packed=True))
    if "K3" in kernels or "K4" in kernels:
        gen = cs.make_sim(2, "cuda", force_mode="pallas")
        gen.engine.prepare_start()
        path = gen.engine._force_fn
        r_i, _ = path.layout(gen.engine.mol)
        gkw = dict(dims=path.spec.dims, cap=path.spec.cap, eps24=path.eps24,
                   sig2=path.sig2, shift6=path.shift6, rc2=path.rc2)
        if "K3" in kernels:
            for key, macro in (("K3", True), ("K3 without u6/virial", False)):
                calls[key] = (cuda_lj.lj_cell_forces_cw,
                              cuda_lj.lj_cell_forces_cw_reference, (r_i,),
                              dict(gkw, cell_len=path.spec.cell_len,
                                   compute_macro=macro), dict(half=True))
        if "K4" in kernels:
            r_j = path.x_halo(r_i)
            calls["K4"] = (
                cuda_lj.lj_cell_forces_row, cuda_lj.lj_cell_forces_row_reference,
                (r_i, r_j), dict(gkw, box=path.spec.box, local_coords=True),
                dict(j_cells=cuda_lj._row_j_cells(
                    r_j, dims=path.spec.dims, cap=path.spec.cap,
                    box=path.spec.box, local_coords=True)))
        del gen
    del sim
    if "K1" in kernels or "K8" in kernels:
        md, asim = cs.argon_rmm()
        a4 = asim.state.planes[:, :, :4, :]
        akw = dict(dims=asim.spec.dims, cap=asim.spec.cap, cell_len=asim.cell_len,
                   eps24=asim.eps24, sig2=asim.sig2, shift6=asim.shift6,
                   rc2=asim.rc2, compute_macro=False)
        for k, fn in (("K1", cuda_lj.lj_cell_forces),
                      ("K8", V.lj_cell_forces_n3l)):
            if k in kernels:
                calls[k + " argon"] = (fn, cuda_lj.lj_cell_forces_reference,
                                       (a4,), akw, dict(half=True))
        if "K1" in kernels:
            calls["K1 argon u6/virial"] = (
                cuda_lj.lj_cell_forces, cuda_lj.lj_cell_forces_reference, (a4,),
                dict(akw, compute_macro=True), dict(half=True))
        del md
    if "K3" in kernels:
        md, path, r_i = cs.argon_general()
        gkw = dict(dims=path.spec.dims, cap=path.spec.cap,
                   cell_len=path.spec.cell_len, eps24=path.eps24, sig2=path.sig2,
                   shift6=path.shift6, rc2=path.rc2)
        for key, macro in (("K3 argon u6/virial", True), ("K3 argon", False)):
            calls[key] = (cuda_lj.lj_cell_forces_cw,
                          cuda_lj.lj_cell_forces_cw_reference, (r_i,),
                          dict(gkw, compute_macro=macro), dict(half=True))
        del md
    return calls


def gram_order(tag, smi):
    """K9 gram of the variant in use against its plain version on the
    card, on the CPU and in f64 (see the module docstring)."""
    import torch

    from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V

    def rel(a, b, m):
        return f"{float((a.double().cpu() - b.double().cpu()).abs().max()) / m:.2e}"

    for cap in (32, 64):
        sim = cs.cut_sim(cap, torch.float32, "cuda", nd=8)
        cases = {"state": (sim.state.planes[:, :, :4, :], sim.spec.dims,
                           sim.cell_len, dict(eps24=sim.eps24, sig2=sim.sig2,
                                              shift6=sim.shift6, rc2=sim.rc2))}
        for name, r8 in cs.check_scenes(cap, torch.float32, "cuda").items():
            cases[name] = (r8[:, :, :4, :], (6, 6, 6), (cs.SCENE_CL,) * 3,
                           cs.SCENE_LJ)
        for name, (r4, dims, cl, lj) in cases.items():
            kw = dict(dims=dims, cap=cap, cell_len=cl, gram=True, **lj)
            k = V.lj_cell_forces_zb(r4, **kw)[0]
            pg = V.lj_cell_forces_zb_reference(r4, **kw)[0]
            pc = V.lj_cell_forces_zb_reference(r4.cpu(), **kw)[0]
            f64 = V.lj_cell_forces_zb_reference(r4.double(), **kw)[0]
            m = float(f64.abs().max())
            cs.say("gram_order", variant=tag, cap=cap, scene=name,
                   kernel_vs_plain_card=rel(k, pg, m),
                   kernel_vs_plain_cpu=rel(k, pc, m),
                   plain_card_vs_cpu=rel(pg, pc, m), kernel_vs_f64=rel(k, f64, m),
                   plain_card_vs_f64=rel(pg, f64, m),
                   plain_cpu_vs_f64=rel(pc, f64, m), gpu=repr(smi))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="TAG=DIR[:FLAGS] (tools/kernel_variants.py)")
    ap.add_argument("--kernels", default="K1,K3,K4,K7,K8,K9")
    ap.add_argument("--no-check", action="append", default=[], metavar="TAG")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--gram-order", action="store_true")
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    smi = cs.phase_device()
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    names = dict.fromkeys(lib for k in kernels for lib in KERNELS[k][0])
    libs = kv.build(kv.parse(args.variant, ROOT / "ls1_mardyn_tpu_torch" / "csrc"),
                    list(names))
    for tag, built in libs.items():
        for lib, path in built.items():
            log = Path(path._name).with_suffix(".log").read_text()
            cs.say("ptxas", variant=tag, lib=lib,
                   kernels=json.dumps(cs.ptxas_report(lib, log=log)))
    for tag, lib in libs.items():
        if tag in args.no_check:
            continue
        kv.use(lib)
        cs.say("check", variant=tag)
        for k in kernels:
            KERNELS[k][1]("cuda")
    if args.gram_order:
        for tag, lib in libs.items():
            kv.use(lib)
            gram_order(tag, smi)
    calls = full_width_inputs(kernels)
    if args.walk:
        for key, (_, _, a, kw, wkw) in calls.items():
            if wkw.get("packed"):
                cs.say("walk", state=key, walk=json.dumps(cs.packed_warp_walk(
                    a[0], a[1], a[2], kw["nx"], kw["box"], kw["rc2"])))
                continue
            cl = kw.get("cell_len", (0.0,) * 3)
            for step, cull, split in (("a", False, False), ("b", True, False),
                                      ("c", True, True)):
                cs.say("walk", state=key, step=step,
                       walk=json.dumps(cs.lj_warp_walk(
                           a[0], kw["dims"], kw["cap"], cl, kw["rc2"],
                           cull=cull, split=split, **wkw)))
            if wkw.get("half"):
                cs.say("walk", state=key, step="full",
                       walk=json.dumps(cs.lj_warp_walk(
                           a[0], kw["dims"], kw["cap"], cl, kw["rc2"])))
    times = {tag: {key: [] for key in calls} for tag in libs}
    order = list(libs) + list(libs)[::-1]
    for tag in order:
        kv.use(libs[tag])
        for key, (fn, _, a, kw, _) in calls.items():
            times[tag][key].append(cs.cuda_ms(lambda: fn(*a, **kw), args.reps))
    ref = {key: plain(*a, **dict(kw, compute_macro=True))
           for key, (_, plain, a, kw, _) in calls.items()}
    for tag in libs:
        kv.use(libs[tag])
        for key, (fn, _, a, kw, _) in calls.items():
            rel = max(cs.rel_errors(fn(*a, **dict(kw, compute_macro=True)),
                                    ref[key]))
            cs.say("times", variant=tag, kernel=key,
                   grid=kw.get("dims", (kw.get("nx"), kw.get("ny"), kw.get("nz"))),
                   macro=kw.get("compute_macro", True),
                   ms=json.dumps([round(t, 3) for t in times[tag][key]]),
                   rel_to_plain=f"{rel:.2e}", gpu=repr(smi))
            # a variant under --no-check may compute the function another
            # way (a parent's K1 by the full shell rounds each pair from
            # both sides): reported, not held to the plain version
            if tag not in args.no_check:
                cs.check(rel <= 1e-5, f"{tag} {key}: rel err {rel}")


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
