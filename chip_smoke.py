"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ls1_mardyn_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, then drives the
main path -- MDSimulation -> RMMEngine -> RMMSimulation, a 1CLJ NVT
fluid of N = 4,194,304 molecules (rho 0.8, rc 2.5, T 1.1) started from
the committed equilibrated seed assets/bench_seed_524288.npz tiled
2x2x2 -- and checks that every kernel of that path was launched by it.

Phases (each prints one line; any failure raises, so the script exits
non-zero and never prints the result line):
  device  GPU name and power limit, torch / CUDA versions
  build   nvcc build of every kernel, seconds
  K1      LJ cell forces vs plain, 16^3 cells cut from the seed, cap 32
          and 64, f32 (max|dF|/max|F| <= 1e-5) and f64 (<= 1e-12)
  K2      shift-merge rebin vs plain on a state drifted 12 steps,
          bit-identical, f32 and f64; overflow on a two-cell hop
  small   the whole driver on the card vs on the CPU (plain versions),
          N=1024, f64, 20 steps: T, p, Upot rtol 1e-9, r and v 1e-9
  main    the main path at N=4,194,304 for 2*rebin_every+2 steps
  times   K1 and K2 against their plain versions at the main path's
          shapes (CUDA events)
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no
result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = os.path.join(HERE, "assets", "bench_seed_524288.npz")
N_MAIN = 4_194_304
RHO, RC, TEMP, DT = 0.8, 2.5, 1.1, 0.002
K1_SRC = "ls1_mardyn_tpu_torch/csrc/lj_cells.cu"
K2_SRC = "ls1_mardyn_tpu_torch/csrc/rebin_shift.cu"
K1_TPU = "ls1_mardyn_tpu/ops/pallas_lj.py:2206"
K2_TPU = "ls1_mardyn_tpu/ops/pallas_rebin.py:275"


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def seed_state(tiles=1):
    """Seed positions/velocities tiled tiles^3 times (bench.py's
    _load_state): each octant is a periodic replica."""
    z = np.load(SEED)
    r0 = z["r"].astype(np.float64)
    v0 = z["v"].astype(np.float64)
    Ls = float(z["L"])
    offs = np.array([(i, j, k) for i in range(tiles) for j in range(tiles)
                     for k in range(tiles)], np.float64) * Ls
    r = (r0[None] + offs[:, None]).reshape(-1, 3) % (Ls * tiles)
    v = np.tile(v0, (tiles ** 3, 1))
    return r, v, Ls * tiles


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def cut_sim(cap, dtype, device, nd=16, edge=2.9):
    """RMMSimulation on nd^3 cells of edge `edge` cut from the seed.
    Molecules within 0.9 of the far faces are dropped, so the cut box's
    periodic images stay apart."""
    from ls1_mardyn_tpu_torch.models.components import Component, ComponentTable
    from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
    from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation
    from ls1_mardyn_tpu_torch.state import MoleculeState

    r, v, _ = seed_state()
    Lc = nd * edge
    keep = np.all(r < Lc - 0.9, axis=1)
    c = Component(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, RC, True)
    table = ComponentTable([c], cutoff=RC, lj_cutoff=RC)
    box = tuple(float(b) for b in np.full(3, Lc, dtype=np.float64))
    sim = RMMSimulation(
        table, None, box, CellGridSpec(dims=(nd,) * 3, box=box, cap=cap),
        dt=DT, target_temperature=TEMP, rebin_every=10 ** 9, sample_every=1,
        device=device,
    )
    sim.init_from_molecules(MoleculeState.from_numpy(
        r=r[keep], v=v[keep], dtype=dtype, device=device))
    return sim


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build():
    from ls1_mardyn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in ("lj_cells", "rebin_shift"):
        _build.load(name)
    secs = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for name in ("lj_cells", "rebin_shift")
            for ln in _build.build_log(name).splitlines() if "Used" in ln]
    say("build", seconds=round(secs, 2),
        nvcc={k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()},
        ptxas=json.dumps(regs))


def phase_k1(device):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces, lj_cell_forces_reference

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64):
            sim = cut_sim(cap, dtype, device)
            r4 = sim.state.planes[:, :, :4, :]
            kw = dict(dims=sim.spec.dims, cap=cap, cell_len=sim.cell_len,
                      eps24=sim.eps24, sig2=sim.sig2, shift6=sim.shift6,
                      rc2=sim.rc2)
            fa, ua, va = lj_cell_forces(r4, **kw)
            fb, ub, vb = lj_cell_forces_reference(r4, **kw)
            torch.cuda.synchronize()
            ef = float((fa - fb).abs().max() / fb.abs().max())
            eu = abs(float(ua - ub) / float(ub))
            ev = abs(float(va - vb) / float(vb))
            check(bool(torch.isfinite(fa).all()), "K1 non-finite forces")
            say("K1", dtype=str(dtype).split(".")[1], cap=cap,
                grid=sim.spec.dims, rel_F=f"{ef:.3e}", rel_u6=f"{eu:.3e}",
                rel_vir=f"{ev:.3e}", limit=lim)
            check(ef <= lim and eu <= lim and ev <= lim,
                  f"K1 disagrees with its plain version ({dtype}, cap {cap})")
    say("K1", launches=lj_cell_forces.launches)


def phase_k2(device):
    from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift, rebin_shift_reference

    for dtype in (torch.float32, torch.float64):
        sim = cut_sim(32, dtype, device)
        for _ in range(12):
            sim.state, _ = sim._step(sim.state)
        big = sim._fold(sim.state)
        kw = dict(dims=sim.spec.dims, cap=32, cell_len=sim.cell_len,
                  sentinel=sim.sentinel)
        oa, fa = rebin_shift(big, **kw)
        ob, fb = rebin_shift_reference(big, **kw)
        moved = int((oa[:, :, 7] != big[:, :, 7]).sum())
        same = bool(torch.equal(oa, ob))
        say("K2", dtype=str(dtype).split(".")[1], grid=sim.spec.dims,
            bit_identical=same, overflow=(bool(fa), bool(fb)),
            slots_changed=moved)
        check(same and not bool(fa) and not bool(fb) and moved > 0,
              f"K2 disagrees with its plain version ({dtype})")
        # a two-cell hop must latch the overflow in both
        bad = big.clone()
        z, y, lane = [int(i) for i in torch.nonzero(bad[:, :, 3] > 0.5)[0]]
        bad[z, y, 0, lane] += 2.0 * sim.cell_len[0]
        check(bool(rebin_shift(bad, **kw)[1])
              and bool(rebin_shift_reference(bad, **kw)[1]),
              "K2 overflow not latched on a two-cell hop")
    say("K2", overflow_on_two_cell_hop=True, launches=rebin_shift.launches)


def make_sim(tiles, device, dtype=torch.float32):
    """MDSimulation on the seed tiled tiles^3 times (bench.py:250-259
    settings)."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid
    from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig

    r, v, L = seed_state(tiles)
    data = cubic_grid(len(r), [L, L, L], TEMP, seed=7)
    data.r, data.v = r, v
    cfg = XMLConfig(timestep=DT, temperature=TEMP,
                    box=np.asarray(data.box, float), cutoff=RC,
                    lj_cutoff=RC, ensemble_type="NVT")
    return MDSimulation(cfg, dtype=dtype, phase_space_data=data, device=device)


def phase_small(device):
    """The whole driver on the card against the same driver on the CPU
    (plain versions), f64, on a small lattice scene."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    n, L = 1024, (1024 / 0.6) ** (1 / 3)
    out = {}
    for dev in (device, "cpu"):
        data = cubic_grid(n, [L, L, L], TEMP, seed=3)
        cfg = XMLConfig(timestep=DT, temperature=TEMP, box=np.full(3, L),
                        cutoff=RC, lj_cutoff=RC, ensemble_type="NVT")
        sim = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                           device=dev)
        gv = sim.run(steps=20, print_every=0)
        mol = sim.molecules()
        o = torch.argsort(mol.mid.cpu())
        out[dev] = (gv, mol.r.cpu()[o].numpy(), mol.v.cpu()[o].numpy())
    (ga, ra, va), (gb, rb, vb) = out[device], out["cpu"]
    rel = {k: abs(float(getattr(ga, k)) / float(getattr(gb, k)) - 1)
           for k in ("temperature", "pressure", "upot")}
    dr = ra - rb
    dr -= L * np.round(dr / L)
    er, ev = float(np.abs(dr).max()), float(np.abs(va - vb).max())
    say("small", n=n, rel=json.dumps({k: f"{x:.2e}" for k, x in rel.items()}),
        max_dr=f"{er:.2e}", max_dv=f"{ev:.2e}")
    check(max(rel.values()) <= 1e-9 and er <= 1e-9 and ev <= 1e-9,
          "the CUDA driver disagrees with the CPU driver")


def phase_main(device, smi):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces
    from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift

    t0 = time.perf_counter()
    lj_cell_forces.launches = 0
    rebin_shift.launches = 0
    sim = make_sim(2, device)
    eng = sim.engine
    rsim = eng.sim
    check(len(sim.phase_space.mid) == N_MAIN, "main path N")
    t_build = time.perf_counter() - t0
    eng.prepare_start()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0 - t_build
    steps = 2 * rsim.rebin_every + 2
    t1 = time.perf_counter()
    gv = sim.run(steps=steps, print_every=0)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t1
    launches = {"K1": lj_cell_forces.launches, "K2": rebin_shift.launches}
    T, p, U = float(gv.temperature), float(gv.pressure), float(gv.upot)
    say("main", n=int(float(gv.n)), grid=rsim.spec.dims, cap=rsim.spec.cap,
        rebin_every=rsim.rebin_every, steps=steps, T=f"{T:.6f}",
        p=f"{p:.6f}", upot_per_mol=f"{U / N_MAIN:.6f}",
        rebin_fallbacks=rsim.n_rebin_fallback,
        construct_s=round(t_build, 2), prepare_start_s=round(t_prep, 2),
        run_s=round(t_run, 2), launches=json.dumps(launches))
    check(all(np.isfinite([T, p, U])), "main path: non-finite T/p/Upot")
    check(abs(T / TEMP - 1) <= 0.1, f"main path: T={T} not within 10% of {TEMP}")
    check(int(float(gv.n)) == N_MAIN, "main path lost molecules")
    check(launches["K1"] > 0 and launches["K2"] >= 6,
          f"main path did not run both kernels ({launches})")
    # steady-state window: whole rebin periods, host clock + sync
    win = 2 * rsim.rebin_every
    sim.run(steps=2, print_every=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run(steps=win, print_every=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / win * 1e3
    say("main", window_steps=win, ms_per_step=f"{ms:.3f}",
        updates_per_s=f"{N_MAIN / ms * 1e3:.4e}", gpu=repr(smi))
    return sim, launches


def phase_times(sim, smi):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces, lj_cell_forces_reference
    from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift, rebin_shift_reference

    rsim = sim.engine.sim
    st = rsim.state
    r4 = st.planes[:, :, :4, :]
    kw = dict(dims=rsim.spec.dims, cap=rsim.spec.cap, cell_len=rsim.cell_len,
              eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    res = {}
    for macro in (False, True):
        k_ms = cuda_ms(lambda: lj_cell_forces(r4, compute_macro=macro, **kw), 10)
        p_ms = cuda_ms(lambda: lj_cell_forces_reference(r4, compute_macro=macro, **kw), 1)
        res[macro] = (k_ms, p_ms)
    fa, ua, va = lj_cell_forces(r4, **kw)
    fb, ub, vb = lj_cell_forces_reference(r4, **kw)
    k1_err = float((fa - fb).abs().max())
    k1_rel = k1_err / float(fb.abs().max())
    check(k1_rel <= 1e-5, f"K1 at the main-path shape: rel err {k1_rel}")
    pairs = 27 * rsim.spec.cap ** 2 * rsim.spec.n_cells
    say("times", kernel="K1", grid=rsim.spec.dims, cap=rsim.spec.cap,
        pair_lanes=pairs, ms_fast=f"{res[False][0]:.3f}",
        plain_ms_fast=f"{res[False][1]:.3f}", ms_macro=f"{res[True][0]:.3f}",
        plain_ms_macro=f"{res[True][1]:.3f}",
        pair_lanes_per_s=f"{pairs / res[False][0] * 1e3:.4e}",
        max_abs_err=f"{k1_err:.3e}", rel_err=f"{k1_rel:.3e}", gpu=repr(smi))
    big = rsim._fold(st)
    kw2 = dict(dims=rsim.spec.dims, cap=rsim.spec.cap, cell_len=rsim.cell_len,
               sentinel=rsim.sentinel)
    k2_ms = cuda_ms(lambda: rebin_shift(big, **kw2), 10)
    p2_ms = cuda_ms(lambda: rebin_shift_reference(big, **kw2), 2)
    oa, _ = rebin_shift(big, **kw2)
    ob, _ = rebin_shift_reference(big, **kw2)
    k2_err = float((oa - ob).abs().max())
    check(k2_err == 0.0, "K2 at the main-path shape is not bit-identical")
    # one read and one write of the 11-column stack per stage
    nbytes = 3 * 2 * big.numel() * big.element_size()
    say("times", kernel="K2", ms=f"{k2_ms:.3f}", plain_ms=f"{p2_ms:.3f}",
        dram_bytes_min=nbytes, GBps=f"{nbytes / k2_ms / 1e6:.1f}",
        max_abs_err=k2_err, gpu=repr(smi))
    return {"K1": (k1_err, res[False][0], res[False][1]),
            "K2": (k2_err, k2_ms, p2_ms)}


def main():
    smi = phase_device()
    device = "cuda"
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    phase_build()
    phase_k1(device)
    phase_k2(device)
    phase_small(device)
    sim, launches = phase_main(device, smi)
    times = phase_times(sim, smi)
    kernels = []
    for name, src, tpu in (("K1 lj_cell_forces", K1_SRC, K1_TPU),
                           ("K2 rebin_shift", K2_SRC, K2_TPU)):
        key = name.split()[0]
        err, ms, plain = times[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": launches[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
