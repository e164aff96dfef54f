"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ls1_mardyn_tpu_torch/csrc (one nvcc
per source, all started together), holds each against its plain PyTorch
version on the card, then drives the port's paths at full width and
checks that every kernel of a path was launched by it:
  - a 1CLJ NVT fluid of N = 4,194,304 molecules (rho 0.8, rc 2.5, T 1.1)
    started from the committed equilibrated seed
    assets/bench_seed_524288.npz tiled 2x2x2: MDSimulation -> RMMEngine
    -> RMMSimulation (kernels K1, K2), the same state packed into pencils
    (K10), and
    MDSimulation(force_mode="pallas") -> SingleChipSimulation ->
    CudaLJPath (kernels K3, K4);
  - a rigid 2CLJ+quadrupole (CO2-class) fluid of N = 1,061,208 molecules
    (rho 0.45, rc 6.2, T 1.1): MDSimulation(force_mode="auto") ->
    SingleChipSimulation -> CudaMultiSitePackedPath (kernel K5), and
    force_mode="ms_dense" -> CudaMultiSitePath (kernel K6);
  - a water-class fluid of N = 1,000,000 (one LJ centre and three
    charges, rho 0.8, rc 3.0, Ewald accuracy 1e-4): MDSimulation(
    force_mode="auto") -> SingleChipSimulation with SPME (ops/pme.py) as
    its extra force -> CudaMultiSitePackedPath (kernel K5, erfc-screened
    charges);
  - an evaporation-class muVT film of N ~ 4,194,304 (MkTcTS: liquid
    slab at rho 0.6 over 80% of the box in vapour at 0.02, rc 2.5, T
    1.1, mu -1.0, 8 instances every 2 steps in the vapour): MDSimulation
    -> SingleChipSimulation -> CudaLJPath (kernel K3) with the
    grand-canonical ensemble, CavityWriter and WidomInsertion; and the
    same film as a steady evaporation under MettDeamon, its
    FeedrateDirector, a Mirror type 5 sink and DistControl (two
    components: kernel K5).

Phases (each prints one line; any failure raises, so the script exits
non-zero and never prints the result line):
  device   GPU name and power limit, torch / CUDA versions
  build    nvcc build of every kernel, seconds, ptxas registers
  K1       LJ cell forces (each pair once, the half shell) vs plain,
           16^3 cells cut from the seed, cap 32, 64 and 128 (a block one
           cell, whose four warps add reactions to the same slots), f32
           (max|dF|/max|F| <= 1e-5) and f64 (<= 1e-12); also on the 6^3
           scenes of check_scenes (sparse cells of 0, 1 and up to 16
           molecules, full cells, pairs within an ulp of rc), the first 4
           planes of an 8-plane tensor read in place; each case's
           unordered in-cutoff pair count equal to the plain version's
  K2       shift-merge rebin vs plain on a state drifted 12 steps,
           bit-identical, f32 and f64; every cap from 32 to 1024 in steps
           of 32 on grids with axes of 1, 2 and 3 cells (rebin_scene);
           overflow on a two-cell hop, and in the x or the y stage alone
           (rebin_stage_overflow_scene), in both
  K3       cell-window forces vs plain on 12^3 cells cut from the seed,
           cap 32 and 64, f32 and f64 (limits as K1): plain, with Vi,
           with explicit z halo rows, and at ny = 2; and on K1's sparse,
           full and near-rc scenes; in-cutoff counts as K1
  K4       row forces vs plain on the same cells in every mode of
           row_views (cell-local, absolute, z and y halo rows, two x
           halo cells, nx = 2), on K1's sparse, full and near-rc scenes,
           and on the near-rc scene in absolute coordinates at 160 sigma
           (f32 ulp 1.5e-5); in-cutoff counts as K1; absolute f32 against
           the f64 result (<= 5e-3, see phase_k4)
  K5       packed multi-site forces vs plain (F, M, Vi relative to their
           max, u6/uX/myRF relative; f32 <= 1e-5, f64 <= 1e-12): a
           two-component mixture with all seven bodies (dipole-dipole
           with the reaction field included), a screened water-like
           scene at cap 160, multi-tile rows, each on the half shell,
           and the multi-tile rows under z_halo (the double-sided
           walk); half_launches must count all but the z_halo launches
  K6       dense multi-site forces vs plain (limits as K5): the mixture
           at cap 32 and 160, the screened scene, explicit y + z halo
           rows (bit-identical to the wrapped result)
  K7       K4's function in cell-local mode (the TPU's lane-major-j
           kernel) vs plain on the K3 cells and K1's sparse, full and
           near-rc scenes, cap 32 and 64, f32 and f64 (limits as K1), with
           in-cutoff counts as K1; defer=True and False bit-identical;
           cap 1024 agrees and cap 1056 raises
  K8       Newton-3rd-law forces (K1's launch under K8's wrapper) vs
           plain on the cut RMM state read in place, on 3x3x3 cells (the
           smallest grid it takes) and on K1's sparse, full and near-rc
           scenes, with each case's unordered in-cutoff count equal to
           the plain version's
  K9       K1's function (the TPU's z-banded kernel) vs plain, direct
           and Gram r^2, on the cut RMM state's 8-plane tensor read in
           place (sentinel fill) and on K1's sparse, full and near-rc
           scenes, with in-cutoff counts as K1 (by the Gram r^2 for
           gram); cap 1024 agrees and cap 1056 raises
  K10      packed-pencil forces vs plain (limits as K1) on the cut state
           packed into pencils (cap 32 and 64), on K1's sparse, full and
           near-rc scenes packed, and on 3^3 cells where a group wraps at
           both x ends; wrap groups at both ends in every case; each
           case's in-cutoff count (each pair once) equal to the plain
           version's
  small    the RMM driver on the card vs on the CPU (plain versions),
           N=1024, f64, 20 steps: T, p, Upot rtol 1e-9, r and v 1e-9
  plugins-small  the driver with plugins on the card vs on the CPU, f64,
           N=1024, 20 steps, files written every 5 steps: the observer
           set of WRITER_SET on the RMM engine (K1), and MaxCheck +
           FlopRateWriter + ResultWriter on the general engine (K3); the
           engine of each scene asserted, every output file with the
           same lines and layout and its numbers within rtol 1e-9, the
           binary checkpoint read back bit-identical to the state
  general-small  the general engine on the card vs on the CPU, f64, 20
           steps: force_mode="pallas" (1CLJ, N=1000) and "cells" (a
           2CLJ+quadrupole fluid): T, p, Upot rtol 1e-9; r, v, q, L 1e-9
  multisite-small  the same for "ms_packed" (K5) and "ms_dense" (K6) on
           a 2CLJ+quadrupole lattice of N=4096 and a 1CLJ liquid slab in
           vapour on adaptive z rows under "auto" (K6)
  main     the RMM path at N=4,194,304 for rebin_every+2 steps and a
           timed window of rebin_every steps; one whole shift rebin
           (fold, K2, split) timed
  main/plugins  the main path with ResultWriter, EnergyLogWriter,
           MaxWriter, TimerWriter and SysMonOutput at writefrequency 10
           for 2 rebin periods (K1 and K2 launched, RMM engine), then
           windows of that length on the bare main path and on this one
           in turns (ms/step of each, the writers' cost); one binary
           checkpoint of all 4,194,304 molecules (seconds, bytes, GB/s),
           read back through the binary reader and equal to the state
  nve      the seed (one tile, N=524,288) on the RMM path without
           thermostat, LJ shifted at rc, f32, 10,000 steps at each dt of
           NVE_DTS; E sampled every 100 steps; drift max|E-E0|/max(|E0|,1)
           below 1e-4 at NVE_GATE_DT = 0.0005
  packed   pack the main state into pencils, tables, K10, unpack:
           feasible, Wp, forces against K1 on the same state
  variants K7 (with the planes' x halo), K8 and K9 (direct and Gram)
           once each on the main state, their counters set to 0 just
           before: launches 1, 1 and 2, forces against K1 on the same
           state (the limits of packed)
  general  the general engine at N=4,194,304: MDSimulation(
           force_mode="pallas"), a warm-up and a timed window of 16
           steps (K3 once per step), then 3 steps with the path's cw
           switched off (K4); peak device memory
  multisite-cells  the plain traversal (force_mode="cells", no kernel)
           on a 2CLJ+quadrupole fluid of N=97,336, 4 steps
  multisite  the full-width multi-site path: "auto" (K5), a warm-up and
           a 16-step window, then 3 steps under "ms_dense" (K6); T_trans
           within 10%, unit quaternions, peak memory above what the
           script held before
  times    K1..K10 against their plain versions at the shapes their
           paths gave them (CUDA events), and each kernel's bound (its
           in-cutoff count checked once against the plain version's); K1,
           K3, K4, K7, K8 (full and half shell) and K9 (zb and gram) also
           report what their warps walk (j slots staged, the share culled,
           j iterations; lj_warp_walk) and their ptxas registers and
           spills, K10 its groups' walk (packed_warp_walk) beside K8's and
           its ptxas report, K2 the bytes of its two passes; K3 and K4
           also against plain on K1's grid (56,60,60), K7-K10 on K1's
           state beside K1; the multi-site plain versions on a 2-row z
           slab, and at full width when that extrapolates to under 60 s;
           K5 and K6 also report the candidate tests their warp windows
           walk (and the block skeleton's windows), the pairs inside the
           cutoff the site program runs on (each once on K5's half
           shell), and the ptxas registers and spills of each
           instantiation
  longrange-small  long-range drivers on the card vs on the CPU, f64, 20
           steps: the molten salt (6^3 ions) under ewald_method direct,
           pme and fmm (N^2 oracle); water-class N=4096 under
           "ms_packed" with SPME (K5 launched 21 times, every launch with
           SPME's screen_alpha); a 1CLJ slab in vapour with
           longrange="planar" (K3 on the general engine, 21 launches):
           T, p, Upot rtol 1e-9; r, v (q, L) 1e-9
  longrange  water-class N=1,000,000, f32, "auto": SPME on 256^3 at order
           6 and K5 with its screen_alpha; 2 + 8 steps (ms/step,
           molecule-updates/s), T_trans within 10%, unit quaternions,
           peak memory; each part of a step alone (CUDA events): the K5
           path's build, K5, gather back, charge sites, splines, spread,
           the two FFTs, force gather, self/intra corrections, the
           solver as a whole, the half-kicks; then K5 against its plain
           version at this path's shapes (f32 1e-5) with its bound, a
           kernels-line record of its own ("K5 ... (water, SPME
           screen_alpha)": launches, times and bound from this path)
  longrange-solvers  SPME vs direct Ewald through the driver (N=8000:
           Upot 1e-4, F 5e-3 of max); the periodic FMM (depth 5, cap 32,
           order 8, LJ-only K5) vs SPME through the driver (N=64,000:
           Upot 2e-3, F 5e-3; ms/step of both); the adaptive FMM on
           20,000 clustered free-space charges vs the direct sum on the
           card (f64: U 2e-4, F 5e-3, phi 1e-3; its default chunks);
           direct Ewald and SPME
           timed alone from N_sites*K = 1e6 to 2.8e9 (the crossover)
  ensembles-small  the muVT driver on the card vs on the CPU, f64, 20
           steps, the same draws on both: a 1CLJ fluid (N=3000, K3, 4+4
           trials a step) with CavityWriter and WidomInsertion, a 2CLJQ
           fluid on ms_packed (N=5832, K5, multi-site probes), a 1CLJ
           liquid of N=16384 (the cell-table probe): counters identical,
           T, p, Upot rtol 1e-9, r, v, q, L 1e-9 over the valid slots,
           valid and mid identical, .cav.xyz and .widom files rtol 1e-9
  nemd-small  the sixteen state-changing plugins on the JAX tests'
           scenes, card vs CPU as ensembles-small: Mirror types 1, 2, 5
           and 6, WallPotential 93/104, MettDeamon with its
           FeedrateDirector and DistControl, DriftCtrl, PosNegComp,
           ExtractPhase, FixRegion, COMaligner, InMemoryCheckpointing
           (also alone on the RMM engine), Dropaligner, Dropaccelerator,
           MirrorSystem; the engine of each scene asserted
  muvt     the film at full width, f32: a warm-up and a 16-step window
           (ms/step, molecule-updates/s), the same window without the
           ensemble (GCMC's cost a step and a cycle), one cycle alone
           (ms, kernel launches by torch.profiler), the counters, N read
           before and after the run, T within 10%, peak memory; then K3
           against its plain version at this path's shapes (f32 1e-5)
           with its bound, a kernels-line record of its own ("K3 ...
           (muVT film)")
  nemd     the film as a steady evaporation (NVT, f32; MettDeamon feeding
           the lower vapour from a reservoir cut from the start state, a
           Mirror type 5 sink, the FeedrateDirector, DistControl): 64
           steps, then 16-step windows with and without the plugin set
           (ms/step of each), host reads a step, molecules inserted,
           released and deleted
The line before the last is {"kernels": [...]}, each kernel's
`engine_caller` false where no engine launches it (K7-K10: their
launches are those of variants and packed); the last line is
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
LIBS = ("lj_cells", "rebin_shift", "lj_cells_cw", "lj_cells_row", "ms_dense",
        "ms_packed", "lj_cells_lanej", "lj_cells_zb", "lj_packed")
# name, source, TPU kernel it replaces
KERNELS = {
    "K1": ("K1 lj_cell_forces", "ls1_mardyn_tpu_torch/csrc/lj_cells.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:2206"),
    "K2": ("K2 rebin_shift", "ls1_mardyn_tpu_torch/csrc/rebin_shift.cu",
           "ls1_mardyn_tpu/ops/pallas_rebin.py:275"),
    "K3": ("K3 lj_cell_forces_cw", "ls1_mardyn_tpu_torch/csrc/lj_cells_cw.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:1560"),
    "K4": ("K4 lj_cell_forces_row", "ls1_mardyn_tpu_torch/csrc/lj_cells_row.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:356"),
    "K5": ("K5 multisite_cell_forces_packed",
           "ls1_mardyn_tpu_torch/csrc/ms_packed.cu",
           "ls1_mardyn_tpu/ops/pallas_ms_packed.py:485"),
    "K6": ("K6 multisite_cell_forces", "ls1_mardyn_tpu_torch/csrc/ms_dense.cu",
           "ls1_mardyn_tpu/ops/pallas_multisite.py:663"),
    "K7": ("K7 lj_cell_forces_lanej", "ls1_mardyn_tpu_torch/csrc/lj_cells_lanej.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:649"),
    "K8": ("K8 lj_cell_forces_n3l", "ls1_mardyn_tpu_torch/csrc/lj_cells.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:952"),
    "K9": ("K9 lj_cell_forces_zb", "ls1_mardyn_tpu_torch/csrc/lj_cells_zb.cu",
           "ls1_mardyn_tpu/ops/pallas_lj.py:1273"),
    "K10": ("K10 lj_forces_packed", "ls1_mardyn_tpu_torch/csrc/lj_packed.cu",
            "ls1_mardyn_tpu/ops/pallas_packed.py:517"),
}
# the kernels no engine calls: their launches are those of one call
# each on the main state (phase_variants, phase_packed)
NO_ENGINE = ("K7", "K8", "K9", "K10")
# the full-width multi-site scene: a 2CLJ+quadrupole (CO2-class) fluid on
# a 102^3 lattice at the cutoff of ls1's CO2 example (33.07 a0 = 6.2 sigma)
N_MS, RHO_MS, RC_MS = 1_061_208, 0.45, 6.2
# the card's published peaks (H100 SXM data sheet): f32 outside the
# tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def lj_scene(dims, cap, cl, counts, seed, rc=RC, near_rc=0, eps=None,
             planes=4, dtype=torch.float64, device="cpu"):
    """Cell-local planes [nz, ny, planes, nx*cap] (x, y, z, valid, then
    junk planes, as the RMM state's) for the LJ kernel checks.  Cell
    (x, y, z) holds counts[z, y, x] molecules in random slots: at random
    at least 0.75 apart across the periodic box, or, in a full cell (32
    or 64 of cap), on a jittered 4x4x2 or 4x4x4 lattice.  near_rc more
    molecules each sit at distance rc (1 + k eps), k in -2..2, from a
    random one in another cell (eps: the dtype's), so that r^2 rounds to
    either side of rc^2.  Invalid slots hold junk coordinates inside
    their cell, which a kernel must never use."""
    nx, ny, nz = dims
    counts = np.asarray(counts)
    rng = np.random.default_rng(seed)
    if eps is None:
        eps = float(torch.finfo(dtype).eps)
    n_c = np.array([nx, ny, nz])
    L = n_c * cl
    pos = rng.uniform(0, cl, size=(nz, ny, nx, cap, 3))
    valid = np.zeros((nz, ny, nx, cap), bool)
    placed = {}  # cell (x, y, z) -> absolute positions

    def fits(p):
        c = np.floor(p / cl).astype(int)
        near = [q for off in np.ndindex(3, 3, 3)
                for q in placed.get(tuple((c + np.array(off) - 1) % n_c), ())]
        if not near:
            return True
        d = p - np.array(near)
        d -= np.round(d / L) * L
        return bool(((d * d).sum(1) >= 0.75 ** 2).all())

    def put(p):
        c = np.floor(p / cl).astype(int) % n_c
        x, y, z = c
        free = np.flatnonzero(~valid[z, y, x])
        if len(free) == 0:
            return False
        s = rng.choice(free)
        valid[z, y, x, s] = True
        pos[z, y, x, s] = p - c * cl
        placed.setdefault((x, y, z), []).append(p)
        return True

    for z, y, x in np.ndindex(nz, ny, nx):
        n = int(counts[z, y, x])
        base = np.array([x, y, z]) * cl
        if n in (32, 64) and n <= cap:
            g = np.array([4, 4, n // 16])
            for k in np.ndindex(*g):
                jit = rng.uniform(-0.1, 0.1, 3)
                put(base + (np.array(k) + 0.5 + jit) * cl / g)
            continue
        for _ in range(n):
            for _ in range(200):
                p = base + rng.uniform(0, cl, 3)
                if fits(p):
                    put(p)
                    break
    owners = [q for qs in placed.values() for q in qs]
    for t in range(near_rc):
        a = owners[rng.integers(len(owners))]
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        p = (a + rc * (1.0 + (t % 5 - 2) * eps) * u) % L
        if fits(p):
            put(p)
    r = np.concatenate([pos, valid[..., None].astype(np.float64)], -1)
    out = torch.as_tensor(r, dtype=dtype).permute(0, 1, 4, 2, 3).reshape(
        nz, ny, 4, nx * cap)
    if planes > 4:
        junk = torch.as_tensor(rng.normal(size=(nz, ny, planes - 4, nx * cap)),
                               dtype=dtype)
        out = torch.cat([out, junk], dim=2)
    return out.contiguous().to(device)


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
    _build.build_all(LIBS)
    for name in LIBS:
        _build.load(name)
    secs = time.perf_counter() - t0
    regs = {name: [ln.split(":", 1)[1].strip().split(",")[0]
                   for ln in _build.build_log(name).splitlines() if "Used" in ln]
            for name in LIBS}
    say("build", seconds=round(secs, 2),
        nvcc={k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()},
        ptxas=json.dumps(regs))


def rel_errors(a, b):
    """max|dF|/max|F|, |du6/u6|, |dvir/vir| of two (f, u6, vir)."""
    (fa, ua, va), (fb, ub, vb) = a, b
    torch.cuda.synchronize()
    check(bool(torch.isfinite(fa).all()), "non-finite forces")
    return (float((fa - fb).abs().max() / fb[:, :, :3].abs().max()),
            abs(float(ua - ub) / float(ub)), abs(float(va - vb) / float(vb)))


SCENE_CL, SCENE_LJ = 2.6, dict(eps24=24.0, sig2=1.0, shift6=0.1, rc2=RC ** 2)
_SCENES = {}


def check_scenes(cap, dtype, device):
    """The K1/K3 check scenes on a 6^3 grid of edge 2.6 (lj_scene), with
    8 planes (K1 reads the first 4 in place): "sparse", 0 or 1 molecule
    in a third of the cells each and up to 16 (cap 32) or 40 (cap 64)
    elsewhere, so that warps run split in two or four groups; "full",
    every cell full (32 or 64 of cap); "near_rc", 0-3 molecules a cell
    and 300 more each at rc (1 + k eps) from another, so that r^2 falls
    within an ulp of rc^2 on either side."""
    key = (cap, dtype)
    if key not in _SCENES:
        rng = np.random.default_rng(cap)
        shape = (6, 6, 6)
        pick = rng.integers(0, 3, size=shape)
        sparse = np.where(pick == 0, 0, np.where(
            pick == 1, 1, rng.integers(2, 17 if cap == 32 else 41, size=shape)))
        near = rng.integers(0, 4, size=shape)
        _SCENES[key] = {
            name: lj_scene((6, 6, 6), cap, SCENE_CL, counts, seed=cap + i,
                           near_rc=n_rc, planes=8, dtype=dtype)
            for i, (name, counts, n_rc) in enumerate((
                ("sparse", sparse, 0), ("full", np.full(shape, min(cap, 64)), 0),
                ("near_rc", near, 300)))}
    return {k: v.to(device) for k, v in _SCENES[key].items()}


def check_counts(what, r_i, r_j=None, *, kernel, **kw):
    """The pairs inside the cutoff that the kernel evaluates against the
    plain version's count, exactly (ordered pairs; unordered for K1, K8
    and K10); returns the count.  kw:
    ops/cuda_lj.inside_pairs's (dims, cap, rc2, and cell_len or K4's
    box and options)."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import inside_pairs, inside_pairs_reference

    got = inside_pairs(r_i, r_j, kernel=kernel, **kw)
    want = inside_pairs_reference(r_i, r_j, kernel=kernel, **kw)
    check(got == want, f"{what}: {got} pairs inside the cutoff, "
                       f"the plain version {want}")
    return got


def phase_k1(device):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces, lj_cell_forces_reference

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64, 128):
            sim = cut_sim(cap, dtype, device)
            cases = {"seed": (sim.state.planes[:, :, :4, :], sim.spec.dims,
                              sim.cell_len, dict(eps24=sim.eps24, sig2=sim.sig2,
                                                 shift6=sim.shift6, rc2=sim.rc2))}
            for name, r8 in check_scenes(cap, dtype, device).items():
                cases[name] = (r8[:, :, :4, :], (6, 6, 6), (SCENE_CL,) * 3,
                               SCENE_LJ)
            errs, counts = {}, {}
            for tag, (r4, dims, cl, lj) in cases.items():
                kw = dict(dims=dims, cap=cap, cell_len=cl, **lj)
                errs[tag] = max(rel_errors(lj_cell_forces(r4, **kw),
                                           lj_cell_forces_reference(r4, **kw)))
                counts[tag] = check_counts(f"K1 {tag} ({dtype}, cap {cap})",
                                           r4, kernel="K1", dims=dims, cap=cap,
                                           cell_len=cl, rc2=lj["rc2"])
            say("K1", dtype=str(dtype).split(".")[1], cap=cap,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_unordered=json.dumps(counts), counts_equal=True, limit=lim)
            check(max(errs.values()) <= lim,
                  f"K1 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    say("K1", launches=lj_cell_forces.launches)


REBIN_CL = (2.6, 2.7, 2.8)


def rebin_scene(dims, cap, dtype, device, seed=0, fill=0.3, reach=0.3):
    """An 11-column stack [nz, ny, 11, nx*cap] (x, y, z, valid, vx, vy,
    vz, mid, fx, fy, fz) for the K2 checks on cells of edge REBIN_CL: each
    cell holds up to fill*cap molecules in random slots, each coordinate
    drawn from [-reach, 1 + reach) cell edges, so that a share hops one
    cell on each axis; the other columns random, empty slots junk with
    valid 0."""
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    W = nx * cap
    big = rng.normal(size=(nz, ny, 11, W))
    cl = np.array(REBIN_CL)[None, None, :, None]
    big[:, :, 0:3] = rng.uniform(-reach, 1.0 + reach, size=(nz, ny, 3, W)) * cl
    n = rng.integers(0, int(fill * cap) + 1, size=(nz, ny, nx))
    valid = np.zeros((nz, ny, nx, cap), bool)
    for z, y, x in np.ndindex(nz, ny, nx):
        valid[z, y, x, rng.choice(cap, size=n[z, y, x], replace=False)] = True
    big[:, :, 3] = valid.reshape(nz, ny, W)
    return torch.as_tensor(big, dtype=dtype).contiguous().to(device)


def rebin_stage_overflow_scene(stage, dtype, device, cap=32, cell_len=REBIN_CL):
    """A stack on 4^3 cells (edges cell_len) that overflows cap only in
    one intermediate stage ("x" or "y") of the three: cell (1,1,1) holds
    20 molecules that hop along the next axis, and its neighbour 20 that
    hop into (1,1,1) along the stage axis and away along the next, so
    that (1,1,1) holds 40 after that stage and every cell at most 20 at
    the end."""
    nx = ny = nz = 4
    W = nx * cap
    big = np.zeros((nz, ny, 11, W))
    a = 0 if stage == "x" else 1  # the stage axis; the next one moves them on
    cl = np.array(cell_len)

    def put(cell, hop):
        x, y, z = cell
        s = slice(x * cap, x * cap + 20)
        for ax in range(3):
            big[z, y, ax, s] = (0.5 + 0.7 * hop[ax]) * cl[ax]
        big[z, y, 3, s] = 1.0
        big[z, y, 4:11, s] = np.arange(7)[:, None] + 1.0 + 0.01 * np.arange(20)

    own, nbr = [0, 0, 0], [0, 0, 0]
    own[a + 1] = 1
    nbr[a], nbr[a + 1] = 1, -1
    src = [1, 1, 1]
    src[a] = 0
    put((1, 1, 1), own)
    put(tuple(src), nbr)
    return torch.as_tensor(big, dtype=dtype).contiguous().to(device)


# grids of the K2 cap sweep: axes of 1, 2 and 3 cells
REBIN_GRIDS = ((3, 2, 1), (1, 3, 2), (2, 1, 3), (2, 2, 2))


def phase_k2(device):
    """K2 vs its plain version: the cut RMM state drifted 12 steps in f32
    and f64 (bit-identical, overflow clear), every cap the wrapper takes
    (32 to 1024 in steps of 32) on grids with axes of 1, 2 and 3 cells
    (rebin_scene), overflow on a two-cell hop, and overflow in the x or
    the y stage alone (rebin_stage_overflow_scene) in both."""
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
    caps = list(range(32, 1025, 32))
    for i, cap in enumerate(caps):
        dims = REBIN_GRIDS[i % len(REBIN_GRIDS)]
        dtype = (torch.float32, torch.float64)[i % 2]
        big = rebin_scene(dims, cap, dtype, device, seed=cap)
        kw = dict(dims=dims, cap=cap, cell_len=REBIN_CL, sentinel=bool(i % 3))
        oa, fa = rebin_shift(big, **kw)
        ob, fb = rebin_shift_reference(big, **kw)
        check(not bool(fa) and not bool(fb) and bool(torch.equal(oa, ob)),
              f"K2 at cap {cap} on {dims} ({dtype}): overflow {bool(fa)} / "
              f"{bool(fb)}, bit-identical {bool(torch.equal(oa, ob))}")
    flags = {}
    for stage in ("x", "y"):
        big = rebin_stage_overflow_scene(stage, torch.float64, device)
        kw = dict(dims=(4, 4, 4), cap=32, cell_len=REBIN_CL, sentinel=False)
        flags[stage] = (bool(rebin_shift(big, **kw)[1]),
                        bool(rebin_shift_reference(big, **kw)[1]))
        check(all(flags[stage]), f"K2 overflow after the {stage} stage alone: "
                                 f"{flags[stage]}")
    say("K2", caps_bit_identical=f"{caps[0]}..{caps[-1]} step 32",
        grids=json.dumps(REBIN_GRIDS), overflow_on_two_cell_hop=True,
        overflow_in_one_stage_alone=json.dumps(flags),
        launches=rebin_shift.launches)


def cut_planes(cap, dtype, device, nd=12):
    """Contiguous r_i [nd, nd, 4, nd*cap] (cell-local coordinates) of
    nd^3 cells cut from the seed, with its cell edge and LJ constants."""
    sim = cut_sim(cap, dtype, device, nd=nd)
    lj = dict(eps24=sim.eps24, sig2=sim.sig2, shift6=sim.shift6, rc2=sim.rc2)
    return sim.state.planes[:, :, :4, :].contiguous(), sim.cell_len, lj


def sub_block(r_i, cap, nx, ny, nz):
    """The first nz x ny rows and nx cells of r_i, as a periodic grid of
    its own."""
    return r_i[:nz, :ny, :, : nx * cap].contiguous()


def x_halo(a, nx, cap, shift=0.0, hx=1):
    """hx periodic halo cells per side in x, shifted by -+shift where
    valid (absolute coordinates)."""
    lo = a[..., (nx - hx) * cap:].clone()
    hi = a[..., :hx * cap].clone()
    lo[:, :, 0] -= shift * lo[:, :, 3]
    hi[:, :, 0] += shift * hi[:, :, 3]
    return torch.cat([lo, a, hi], dim=-1).contiguous()


def absolute(a, cap, cell_len, origin=0.0):
    """Cell-local planes -> absolute coordinates of a box whose corner
    sits at (origin,) * 3 (valid slots only)."""
    nz, ny, _, W = a.shape
    dt, dev = a.dtype, a.device
    out = a.clone()
    w = a[:, :, 3]
    out[:, :, 0] += ((torch.arange(W, device=dev) // cap).to(dt) * cell_len[0]
                     + origin) * w
    out[:, :, 1] += (torch.arange(ny, device=dev).to(dt)
                     * cell_len[1] + origin)[None, :, None] * w
    out[:, :, 2] += (torch.arange(nz, device=dev).to(dt)
                     * cell_len[2] + origin)[:, None, None] * w
    return out


# K4's modes (row_views)
ROW_MODES = ("local", "absolute", "yz_halo", "hx2", "nx2")


def row_views(r_i, dims, cap, cell_len, mode, origin=0.0):
    """K4's inputs in one mode, from the cell-local planes r_i [nz, ny, 4,
    nx*cap] of the periodic grid `dims`: (r_i, r_j, dims, box, options).
    "local": a periodic x halo of one cell; "hx2": of two; "nx2": the
    first 2 x 3 x 3 cells as a grid of their own; "absolute": absolute
    coordinates (box corner at `origin`), the x halo shifted by -+Lx;
    "yz_halo": the same with explicit y and z halo rows, the periodic
    images put where an exchange would put them."""
    nx, ny, nz = dims
    box = tuple(c * n for c, n in zip(cell_len, dims))
    if mode == "local":
        return r_i, x_halo(r_i, nx, cap), dims, box, dict(local_coords=True)
    if mode == "hx2":
        return (r_i, x_halo(r_i, nx, cap, hx=2), dims, box,
                dict(local_coords=True, hx=2))
    if mode == "nx2":
        r2 = sub_block(r_i, cap, 2, 3, 3)
        box2 = (2 * cell_len[0], 3 * cell_len[1], 3 * cell_len[2])
        return r2, x_halo(r2, 2, cap), (2, 3, 3), box2, dict(local_coords=True)
    r_a = absolute(r_i, cap, cell_len, origin)
    if mode == "absolute":
        return r_a, x_halo(r_a, nx, cap, box[0]), dims, box, {}
    rows = torch.cat([r_a[:, -1:], r_a, r_a[:, :1]], dim=1)
    rows[:, 0, 1] -= box[1] * rows[:, 0, 3]
    rows[:, -1, 1] += box[1] * rows[:, -1, 3]
    rows = torch.cat([rows[-1:], rows, rows[:1]], dim=0)
    rows[0, :, 2] -= box[2] * rows[0, :, 3]
    rows[-1, :, 2] += box[2] * rows[-1, :, 3]
    return (r_a, x_halo(rows, nx, cap, box[0]), dims, box,
            dict(z_halo=True, y_halo=True))


# the corner of the absolute near-rc scene: an f32 coordinate in
# [128, 256) carries an ulp of 2^-16 = 1.5e-5, as at a box of 174 sigma
ABS_ORIGIN = 160.0


def near_rc_absolute(cap, dtype, device):
    """The near-rc check scene of K4 in absolute coordinates far from the
    origin: 6^3 cells of edge 2.6 with 0-3 molecules each and 300 more
    each at rc (1 + k eps) from another, eps one coordinate ulp at
    ABS_ORIGIN over rc, so that pair distances fall within an ulp of rc
    on either side; returned cell-local (row_views adds the corner)."""
    key = ("abs", cap, dtype)
    if key not in _SCENES:
        ulp = float(np.spacing(np.array(ABS_ORIGIN, dtype=str(dtype).split(".")[1])))
        counts = np.random.default_rng(cap + 5).integers(0, 4, size=(6, 6, 6))
        _SCENES[key] = lj_scene((6, 6, 6), cap, SCENE_CL, counts, seed=cap + 5,
                                near_rc=300, eps=ulp / RC, dtype=dtype)
    return _SCENES[key].to(device)


def phase_k3(device):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import (
        lj_cell_forces_cw, lj_cell_forces_cw_reference)

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64):
            r_i, cl, lj = cut_planes(cap, dtype, device)
            nd = r_i.shape[0]
            # explicit z halo rows: the inner rows against the whole cut,
            # whose first and last row are then no periodic images
            cases = {
                "plain": (r_i, None, (nd,) * 3, cl, lj, {}),
                "vi": (r_i, None, (nd,) * 3, cl, lj, dict(compute_vi=True)),
                "z_halo": (r_i[1:-1].contiguous(), r_i, (nd, nd, nd - 2), cl, lj,
                           dict(z_halo=True)),
                "ny2": (sub_block(r_i, cap, 5, 2, 1), None, (5, 2, 1), cl, lj, {}),
            }
            for name, r8 in check_scenes(cap, dtype, device).items():
                cases[name] = (r8[:, :, :4, :].contiguous(), None, (6, 6, 6),
                               (SCENE_CL,) * 3, SCENE_LJ, {})
            errs, counts = {}, {}
            for tag, (ri, rj, dims, c, p, extra) in cases.items():
                kw = dict(dims=dims, cap=cap, cell_len=c, **p, **extra)
                errs[tag] = max(rel_errors(
                    lj_cell_forces_cw(ri, rj, **kw),
                    lj_cell_forces_cw_reference(ri, rj, **kw)))
                counts[tag] = check_counts(
                    f"K3 {tag} ({dtype}, cap {cap})", ri, rj, kernel="K3",
                    dims=dims, cap=cap, cell_len=c, rc2=p["rc2"],
                    z_halo=bool(extra.get("z_halo")))
            say("K3", dtype=str(dtype).split(".")[1], cap=cap, grid=(nd,) * 3,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_ordered=json.dumps(counts), counts_equal=True, limit=lim)
            check(max(errs.values()) <= lim,
                  f"K3 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    say("K3", launches=lj_cell_forces_cw.launches)


def phase_k4(device):
    """K4 vs its plain version in every mode of row_views on 12^3 cells
    cut from the seed, and in cell-local mode on the check scenes (sparse,
    full, near-rc); the near-rc scene also in absolute coordinates at
    ABS_ORIGIN.  Each case's in-cutoff count equals the plain version's."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import (
        lj_cell_forces_row, lj_cell_forces_row_reference)

    f64_abs = {}
    for dtype, lim in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for cap in (32, 64):
            r_i, cl, lj = cut_planes(cap, dtype, device)
            nd = r_i.shape[0]
            dims = (nd,) * 3
            cases = {m: (*row_views(r_i, dims, cap, cl, m), lj) for m in ROW_MODES}
            scl = (SCENE_CL,) * 3
            for name, r8 in check_scenes(cap, dtype, device).items():
                cases[name] = (*row_views(r8[:, :, :4].contiguous(), (6, 6, 6),
                                          cap, scl, "local"), SCENE_LJ)
            cases["near_rc_abs"] = (*row_views(
                near_rc_absolute(cap, dtype, device), (6, 6, 6), cap, scl,
                "yz_halo", origin=ABS_ORIGIN), SCENE_LJ)
            errs, outs, counts = {}, {}, {}
            for tag, (ri, rj, dm, bx, extra, p) in cases.items():
                kw = dict(dims=dm, cap=cap, box=bx, **p, **extra)
                outs[tag] = lj_cell_forces_row(ri, rj, **kw)
                errs[tag] = max(rel_errors(
                    outs[tag], lj_cell_forces_row_reference(ri, rj, **kw)))
                counts[tag] = check_counts(
                    f"K4 {tag} ({dtype}, cap {cap})", ri, rj, kernel="row",
                    dims=dm, cap=cap, box=bx, rc2=p["rc2"], **extra)
            # the three full-grid views describe the same periodic fluid
            errs["yz_halo=absolute"] = max(rel_errors(outs["yz_halo"],
                                                     outs["absolute"]))
            if dtype == torch.float64:
                f64_abs[cap] = outs["absolute"]
            else:
                # f32 absolute coordinates against the f64 result: at
                # |r| ~ 35 an f32 coordinate carries an ulp of 4e-6, and a
                # pair that changes side of the cutoff moves a force by
                # the unshifted LJ's step at rc (0.039 eps/sigma), about
                # 1e-3 of max|F| here
                f64 = tuple(t.to(dtype) for t in f64_abs[cap])
                errs["absolute_f32_vs_f64"] = max(rel_errors(outs["absolute"], f64))
            say("K4", dtype=str(dtype).split(".")[1], cap=cap, grid=dims,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_ordered=json.dumps(counts), counts_equal=True, limit=lim)
            loose = errs.pop("absolute_f32_vs_f64", 0.0)
            check(max(errs.values()) <= lim and loose <= 5e-3,
                  f"K4 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    say("K4", launches=lj_cell_forces_row.launches)


def phase_k7(device):
    """K7 vs its plain version (K4's, cell-local mode, one x halo cell) on
    the K3 cells and the check scenes (sparse, full, near-rc), with each
    case's in-cutoff count equal to the plain version's; `defer` (where
    the TPU kernel reduced over its j lanes) changes nothing, so both
    values must give bit-identical results.  The warp skeleton takes
    every cap the wrappers take: cap 1024 on 3^3 cells agrees, cap 1056
    raises."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_row_reference
    from ls1_mardyn_tpu_torch.ops.cuda_lj_variants import lj_cell_forces_lanej

    def run(tag, r_i, dims, cap, cl, lj, errs, counts):
        r_j = x_halo(r_i, dims[0], cap)
        kw = dict(dims=dims, cap=cap, box=tuple(c * d for c, d in zip(cl, dims)),
                  **lj)
        a = lj_cell_forces_lanej(r_i, r_j, defer=True, **kw)
        b = lj_cell_forces_lanej(r_i, r_j, defer=False, **kw)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"K7 {tag} ({r_i.dtype}, cap {cap}): defer changes the result")
        errs[tag] = max(rel_errors(a, lj_cell_forces_row_reference(
            r_i, r_j, local_coords=True, **kw)))
        counts[tag] = check_counts(f"K7 {tag} ({r_i.dtype}, cap {cap})", r_i, r_j,
                                   kernel="lanej", dims=dims, cap=cap,
                                   box=kw["box"], rc2=lj["rc2"])

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64):
            r_i, cl, lj = cut_planes(cap, dtype, device)
            nd = r_i.shape[0]
            errs, counts = {}, {}
            run("seed", r_i, (nd,) * 3, cap, cl, lj, errs, counts)
            for name, r8 in check_scenes(cap, dtype, device).items():
                run(name, r8[:, :, :4, :].contiguous(), (6, 6, 6), cap,
                    (SCENE_CL,) * 3, SCENE_LJ, errs, counts)
            say("K7", dtype=str(dtype).split(".")[1], cap=cap, grid=(nd,) * 3,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_ordered=json.dumps(counts), counts_equal=True,
                defer_bit_identical=True, limit=lim)
            check(max(errs.values()) <= lim,
                  f"K7 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    # the cap limit is the wrappers' (<= 1024), not shared memory
    big = lj_scene((3, 3, 3), 1024, SCENE_CL,
                   np.random.default_rng(1).integers(0, 40, size=(3, 3, 3)),
                   seed=1, dtype=torch.float64, device=device)
    errs, counts = {}, {}
    run("cap1024", big, (3, 3, 3), 1024, (SCENE_CL,) * 3, SCENE_LJ, errs, counts)
    check(max(errs.values()) <= 1e-12, f"K7 at cap 1024: {errs}")
    try:
        r = torch.zeros((3, 3, 4, 3 * 1056), dtype=torch.float64, device=device)
        lj_cell_forces_lanej(r, x_halo(r, 3, 1056), dims=(3, 3, 3), cap=1056,
                             box=(3 * SCENE_CL,) * 3, **SCENE_LJ)
        raised = False
    except ValueError:
        raised = True
    check(raised, "K7 took cap 1056")
    say("K7", cap1024=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
        inside_ordered_cap1024=json.dumps(counts), cap1056_raises=raised,
        launches=lj_cell_forces_lanej.launches)


def phase_k8(device):
    """K8 (K1's launch under K8's wrapper) vs its plain version on the
    RMM state's planes read in place, on 3x3x3 cells (the smallest grid
    it takes) as a periodic grid of their own, and on the check scenes
    (sparse, full, near-rc), with each case's unordered in-cutoff count
    equal to the plain version's."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj_variants import (
        lj_cell_forces_n3l, lj_cell_forces_n3l_reference)

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64):
            sim = cut_sim(cap, dtype, device)
            r4 = sim.state.planes[:, :, :4, :]
            lj = dict(eps24=sim.eps24, sig2=sim.sig2, shift6=sim.shift6,
                      rc2=sim.rc2)
            cases = {"state": (r4, sim.spec.dims, sim.cell_len, lj),
                     "3x3x3": (sub_block(r4, cap, 3, 3, 3), (3, 3, 3),
                               sim.cell_len, lj)}
            for name, r8 in check_scenes(cap, dtype, device).items():
                cases[name] = (r8[:, :, :4, :], (6, 6, 6), (SCENE_CL,) * 3,
                               SCENE_LJ)
            errs, counts = {}, {}
            for tag, (r, dims, cl, ljc) in cases.items():
                kw = dict(dims=dims, cap=cap, cell_len=cl, **ljc)
                errs[tag] = max(rel_errors(lj_cell_forces_n3l(r, **kw),
                                           lj_cell_forces_n3l_reference(r, **kw)))
                counts[tag] = check_counts(f"K8 {tag} ({dtype}, cap {cap})", r,
                                           kernel="n3l", dims=dims, cap=cap,
                                           cell_len=cl, rc2=ljc["rc2"])
            say("K8", dtype=str(dtype).split(".")[1], cap=cap, grid=sim.spec.dims,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_unordered=json.dumps(counts), counts_equal=True,
                limit=lim)
            check(max(errs.values()) <= lim,
                  f"K8 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    say("K8", launches=lj_cell_forces_n3l.launches)


def phase_k9(device):
    """K9 vs its plain version, plain and gram, on the RMM state's 8-plane
    tensor read in place (empty slots carry the sentinel fill) and on the
    check scenes (sparse, full, near-rc); each case's in-cutoff count
    equals the plain version's (the Gram r^2's for gram).  The warp
    skeleton takes every cap the wrappers take: cap 1024 on 3^3 cells
    agrees, cap 1056 raises."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj_variants import (
        lj_cell_forces_zb, lj_cell_forces_zb_reference)

    def run(tag, r4, dims, cap, cl, lj, errs, counts):
        kw = dict(dims=dims, cap=cap, cell_len=cl, **lj)
        for gram, mode in ((False, "zb"), (True, "zb_gram")):
            errs[f"{tag}/{mode}"] = max(rel_errors(
                lj_cell_forces_zb(r4, gram=gram, **kw),
                lj_cell_forces_zb_reference(r4, gram=gram, **kw)))
            counts[f"{tag}/{mode}"] = check_counts(
                f"K9 {tag} {mode} ({r4.dtype}, cap {cap})", r4, kernel=mode,
                dims=dims, cap=cap, cell_len=cl, rc2=lj["rc2"])

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for cap in (32, 64):
            sim = cut_sim(cap, dtype, device)
            check(sim.sentinel and sim.state.planes.shape[2] == 8,
                  "K9: the cut state carries no sentinel fill")
            errs, counts = {}, {}
            run("state", sim.state.planes[:, :, :4, :], sim.spec.dims, cap,
                sim.cell_len, dict(eps24=sim.eps24, sig2=sim.sig2,
                                   shift6=sim.shift6, rc2=sim.rc2), errs, counts)
            for name, r8 in check_scenes(cap, dtype, device).items():
                run(name, r8[:, :, :4, :], (6, 6, 6), cap, (SCENE_CL,) * 3,
                    SCENE_LJ, errs, counts)
            say("K9", dtype=str(dtype).split(".")[1], cap=cap, grid=sim.spec.dims,
                rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
                inside_ordered=json.dumps(counts), counts_equal=True, limit=lim)
            check(max(errs.values()) <= lim,
                  f"K9 disagrees with its plain version ({dtype}, cap {cap}): {errs}")
    # the cap limit is the wrappers' (<= 1024), not shared memory
    big = lj_scene((3, 3, 3), 1024, SCENE_CL,
                   np.random.default_rng(1).integers(0, 40, size=(3, 3, 3)),
                   seed=1, dtype=torch.float64, device=device)
    errs, counts = {}, {}
    run("cap1024", big, (3, 3, 3), 1024, (SCENE_CL,) * 3, SCENE_LJ, errs, counts)
    check(max(errs.values()) <= 1e-12, f"K9 at cap 1024: {errs}")
    try:
        lj_cell_forces_zb(torch.zeros((3, 3, 4, 3 * 1056), dtype=torch.float64,
                                      device=device),
                          dims=(3, 3, 3), cap=1056, cell_len=(SCENE_CL,) * 3,
                          **SCENE_LJ)
        raised = False
    except ValueError:
        raised = True
    check(raised, "K9 took cap 1056")
    say("K9", cap1024=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
        inside_ordered_cap1024=json.dumps(counts), cap1056_raises=raised,
        launches=lj_cell_forces_zb.launches)


def packed_views(planes, dims, cap):
    """The RMM state `planes` as packed pencils (Wp the smallest multiple
    of 32 lanes that holds every pencil) with their tables: (packed, occ,
    starts, tab, meta, feasible, Wp)."""
    from ls1_mardyn_tpu_torch.ops.cuda_packed import build_tables, pack_pencils

    nx = dims[0]
    Wp = -(-int((planes[:, :, 3] > 0.5).sum(-1).max()) // 32) * 32
    packed, _, occ, starts, cnt, ovf = pack_pencils(
        planes, torch.zeros_like(planes[:, :, :3]), nx, cap, Wp)
    check(not bool(ovf), "packed pencils overflow")
    tab, meta, feas = build_tables(occ, starts, cnt, nx=nx, Wp=Wp)
    return packed, occ, starts, tab, meta, bool(feas), Wp


def nx3_scene(dtype, device):
    """Dense planes [3, 3, 8, 3*32] of 0-9 molecules a cell on 3^3 cells
    of edge SCENE_CL, with 40 more at rc (1 + k eps) from others
    (lj_scene): packed, each pencil is one group that takes both wrap
    passes."""
    counts = np.random.default_rng(3).integers(0, 10, size=(3, 3, 3))
    return lj_scene((3, 3, 3), 32, SCENE_CL, counts, seed=3, near_rc=40,
                    planes=8, dtype=dtype, device=device)


def phase_k10(device):
    """K10 vs its plain version on the cut RMM state packed into pencils
    (cap 32 and 64; its first and last groups take the periodic-x wrap
    passes), on the check scenes (sparse, full, near-rc) packed, and on
    3^3 cells where groups wrap at both ends; each case's in-cutoff count
    (each pair once) equal to the plain version's."""
    from ls1_mardyn_tpu_torch.ops.cuda_packed import (
        M_EHI, M_ELO, lj_forces_packed, lj_forces_packed_reference)

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        cases = {}
        for cap in (32, 64):
            sim = cut_sim(cap, dtype, device)
            cases[f"state{cap}"] = (sim.state.planes, sim.spec.dims, cap,
                                    sim.spec.box, dict(eps24=sim.eps24, sig2=sim.sig2,
                                                       shift6=sim.shift6, rc2=sim.rc2))
        for name, r8 in check_scenes(32, dtype, device).items():
            cases[name] = (r8, (6, 6, 6), 32, (6 * SCENE_CL,) * 3, SCENE_LJ)
        cases["nx3"] = (nx3_scene(dtype, device), (3, 3, 3), 32, (3 * SCENE_CL,) * 3,
                        SCENE_LJ)
        errs, counts, wraps = {}, {}, {}
        for tag, (planes, dims, cap, box, lj) in cases.items():
            nx, ny, nz = dims
            packed, _, _, tab, meta, feas, Wp = packed_views(planes, dims, cap)
            wraps[tag] = (int(meta[:, :, 0, M_ELO].sum()), int(meta[:, :, 0, M_EHI].sum()))
            check(min(wraps[tag]) > 0, f"K10 {tag}: no wrap groups at one end")
            pos4 = packed[:, :, :4].contiguous()
            kw = dict(nx=nx, ny=ny, nz=nz, Wp=Wp, box=box, **lj)
            errs[tag] = max(rel_errors(lj_forces_packed(pos4, tab, meta, **kw),
                                       lj_forces_packed_reference(pos4, tab, meta, **kw)))
            counts[tag] = check_counts(f"K10 {tag} ({dtype})", pos4, kernel="packed",
                                       tab=tab, meta=meta, nx=nx, ny=ny, nz=nz, Wp=Wp,
                                       box=box, rc2=lj["rc2"])
        say("K10", dtype=str(dtype).split(".")[1],
            rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
            inside_unordered=json.dumps(counts), counts_equal=True,
            wrap_groups=json.dumps(wraps), limit=lim)
        check(max(errs.values()) <= lim,
              f"K10 disagrees with its plain version ({dtype}): {errs}")
    say("K10", launches=lj_forces_packed.launches)


def ms_scene(kind, n, box, rc, dtype, device, seed=1, thin_upper_z=0.0):
    """A jittered simple-cubic start of about n rigid molecules in `box`
    with random orientations, built on `device`: "mix" (two components,
    A: LJ + charge + dipole, B: LJ + charge + quadrupole, off-COM sites,
    eps_rf = 5: all seven bodies and the reversed ones) or "water" (LJ +
    three charges, SPC/E-like geometry).  thin_upper_z keeps only that
    share of the molecules above box_z / 2 (z-inhomogeneous rows).
    Returns (mol, table, box tensor)."""
    from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
    from ls1_mardyn_tpu_torch.models.components import Component
    from ls1_mardyn_tpu_torch.scene import build_scene

    rng = np.random.default_rng(seed)
    box = np.broadcast_to(np.asarray(box, float), (3,)).copy()
    if kind == "mix":
        a = Component(cid=0)
        a.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc, False)
        a.add_charge(0.25, 0.0, 0.0, 0.1, 0.5)
        a.add_dipole(0.0, 0.1, 0.0, 0.0, 1.0, 0.0, 0.8)
        b = Component(cid=1)
        b.add_ljcenter(0.0, 0.0, 0.0, 1.2, 0.8, 1.1, rc, False)
        b.add_charge(0.0, 0.2, 0.0, 0.1, -0.5)
        b.add_quadrupole(0.05, 0.0, 0.0, 1.0, 0.0, 0.0, 0.9)
        comps = [a, b]
    else:
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc, False)
        c.add_charge(0.0, 0.0, 0.0, 0.0, -0.8476)
        c.add_charge(0.316, 0.245, 0.0, 0.01, 0.4238)
        c.add_charge(-0.316, 0.245, 0.0, 0.01, 0.4238)
        comps = [c]
    k = np.maximum(1, np.round(box * (n / box.prod()) ** (1 / 3))).astype(int)
    g = np.stack(np.meshgrid(*[np.arange(m) for m in k], indexing="ij"),
                 -1).reshape(-1, 3)
    r = ((g + 0.5) * (box / k) + rng.uniform(-0.15, 0.15, g.shape)) % box
    if thin_upper_z:
        r = r[(r[:, 2] < box[2] / 2) | (rng.random(len(r)) < thin_upper_z)]
    m = len(r)
    q = rng.normal(size=(m, 4))
    K = len(comps)
    data = PhaseSpaceData(
        components=comps, mixing_xi=np.ones((K, K)), mixing_eta=np.ones((K, K)),
        eps_rf=5.0, box=box, temperature=TEMP, current_time=0.0,
        mid=np.arange(1, m + 1), cid=(np.arange(m) % K).astype(np.int32), r=r,
        v=np.zeros((m, 3)), q=q / np.linalg.norm(q, axis=1, keepdims=True),
        L=np.zeros((m, 3)))
    mol, _, table, boxt = build_scene(data, cutoff=rc, dtype=dtype, device=device)
    return mol, table, boxt


def ms_rel_errors(a, b):
    """max|dF|/max|F|, max|dM|/max|M|, max|dVi|/max|Vi| and the relative
    errors of u6, uX, myRF of two (out, u6, uX, myRF)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(a[0]).all()), "non-finite multi-site outputs")
    errs = {}
    for tag, sl in (("F", slice(0, 3)), ("M", slice(3, 6)), ("Vi", slice(6, 9))):
        d = float((a[0][:, :, sl] - b[0][:, :, sl]).abs().max())
        ref = float(b[0][:, :, sl].abs().max())
        errs[tag] = d / ref if ref else d
    for tag, x, y in zip(("u6", "uX", "rf"), a[1:], b[1:]):
        d, ref = abs(float(x) - float(y)), abs(float(y))
        errs[tag] = d / ref if ref else d
    return errs


def yz_halo_rows(r_j, box):
    """The x-halo view r_j [nz, ny, P, W] with one explicit halo row per
    side in y and in z: the periodic images, shifted by -+by / -+bz
    where valid, put where a slab or mesh exchange would put them."""
    rows = torch.cat([r_j[:, -1:], r_j, r_j[:, :1]], dim=1)
    rows[:, 0, 1] -= box[1] * rows[:, 0, 3]
    rows[:, -1, 1] += box[1] * rows[:, -1, 3]
    rows = torch.cat([rows[-1:], rows, rows[:1]], dim=0)
    rows[0, :, 2] -= box[2] * rows[0, :, 3]
    rows[-1, :, 2] += box[2] * rows[-1, :, 3]
    return rows.contiguous()


def phase_k6(device):
    """K6 vs its plain version: the mixture (all seven bodies) at cap 32
    and 160, the screened water-like scene, and explicit y + z halo rows
    (which must give the wrapped result bit for bit)."""
    from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
    from ls1_mardyn_tpu_torch.ops.cuda_ms import (
        multisite_cell_forces, multisite_cell_forces_reference)
    from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath

    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        errs = {}
        for tag, kind, cap, alpha in (("mix", "mix", 32, 0.0),
                                      ("mix_cap160", "mix", 160, 0.0),
                                      ("water_screened", "water", 64, 0.9)):
            mol, table, box = ms_scene(kind, 1000, 12.0, 3.0, dtype, device)
            spec = CellGridSpec.create(box.cpu().numpy(), 3.0, cap=cap)
            path = CudaMultiSitePath(table, spec, screen_alpha=alpha)
            r_i, _ = path.layout(mol)
            r_j = path.x_halo(r_i).contiguous()
            nx, ny, nz = spec.dims
            kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, box=spec.box, rc2=path.rc2,
                      rc2_lj=path.rc2_lj, screen_alpha=alpha, meta=path.meta)
            got = multisite_cell_forces(r_i, r_j, **kw)
            errs[tag] = max(ms_rel_errors(
                got, multisite_cell_forces_reference(r_i, r_j, **kw)).values())
            if tag == "mix":
                rows = yz_halo_rows(r_j, spec.box)
                hk = dict(kw, z_halo=True, y_halo=True)
                halo = multisite_cell_forces(r_i, rows, **hk)
                errs["yz_halo"] = max(ms_rel_errors(
                    halo, multisite_cell_forces_reference(r_i, rows, **hk)
                ).values())
                errs["yz_halo=wrapped"] = max(ms_rel_errors(halo, got).values())
        say("K6", dtype=str(dtype).split(".")[1], grid=spec.dims,
            rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}), limit=lim)
        check(max(errs.values()) <= lim,
              f"K6 disagrees with its plain version ({dtype}): {errs}")
    say("K6", launches=multisite_cell_forces.launches)


def phase_k5(device):
    """K5 vs its plain version: on the half shell the mixture, the
    screened water-like scene at cap 160 and multi-tile rows (> 128
    molecules a row, z-inhomogeneous counts); the same multi-tile rows
    under z_halo (the inner z rows of a periodic packed build against
    all of its rows as explicit halo rows: the double-sided walk).
    half_launches must count every launch but the z_halo ones."""
    from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
        CudaMultiSitePackedPath, multisite_cell_forces_packed,
        multisite_cell_forces_packed_reference)

    k5 = multisite_cell_forces_packed
    k5.launches = k5.half_launches = 0
    for dtype, lim in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        errs = {}
        for tag, kind, box, cap, alpha, thin, zh in (
                ("mix", "mix", 12.0, 32, 0.0, 0.0, False),
                ("water_screened_cap160", "water", 12.0, 160, 0.9, 0.0, False),
                ("multitile", "mix", (36.0, 9.6, 12.0), 48, 0.0, 0.4, False),
                ("multitile_z_halo", "mix", (36.0, 9.6, 12.0), 48, 0.0, 0.4,
                 True)):
            mol, table, boxt = ms_scene(kind, 1000 if thin == 0 else 3500, box,
                                        3.0, dtype, device, thin_upper_z=thin)
            spec = CellGridSpec.create(boxt.cpu().numpy(), 3.0, cap=cap)
            path = CudaMultiSitePackedPath(table, spec, screen_alpha=alpha)
            tbl, r_i, r_j, _, _ = path._build_views(mol)
            nx, ny, nz = spec.dims
            kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, Wp=path.Wp, Wjp=path.Wjp,
                      cell_plane=path.cell_plane, box=spec.box, rc2=path.rc2,
                      rc2_lj=path.rc2_lj, screen_alpha=alpha, meta=path.meta)
            if thin:
                counts = (r_i[:, :, 3] > 0.5).sum(-1)
                check(int(counts.max()) > 128 and
                      int(counts[1].max()) != int(counts[-2].max()),
                      f"K5 multi-tile case: row counts {counts.tolist()}")
            if zh:
                r_i = r_i[1:-1].contiguous()
                kw.update(nz=nz - 2, z_halo=True)
            got = multisite_cell_forces_packed(tbl, r_i, r_j, **kw)
            errs[tag] = max(ms_rel_errors(
                got, multisite_cell_forces_packed_reference(tbl, r_i, r_j, **kw)
            ).values())
        say("K5", dtype=str(dtype).split(".")[1],
            rel=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}), limit=lim)
        check(max(errs.values()) <= lim,
              f"K5 disagrees with its plain version ({dtype}): {errs}")
    say("K5", launches=k5.launches, half_launches=k5.half_launches)
    check((k5.launches, k5.half_launches) == (8, 6),
          f"K5: {k5.half_launches} of {k5.launches} launches on the half shell")


def scene_config(box, rc=RC):
    from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig

    return XMLConfig(timestep=DT, temperature=TEMP, box=np.asarray(box, float),
                     cutoff=rc, lj_cutoff=rc, ensemble_type="NVT")


def make_sim(tiles, device, dtype=torch.float32, force_mode="auto",
             plugins=(), components=None, **config):
    """MDSimulation on the seed tiled tiles^3 times (bench.py:250-259
    settings), with the config's output plugins `plugins` and its other
    fields overridden by `config`."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    r, v, L = seed_state(tiles)
    data = cubic_grid(len(r), [L, L, L], TEMP, seed=7, components=components)
    data.r, data.v = r, v
    cfg = scene_config(data.box)
    cfg.output_plugins = list(plugins)
    for k, val in config.items():
        setattr(cfg, k, val)
    return MDSimulation(cfg, dtype=dtype, phase_space_data=data, device=device,
                        force_mode=force_mode)


def lattice_scene(n, rho, kind, seed=3, rc=RC):
    """A cubic-lattice start of n molecules: "1clj", or "2cljq" (two LJ
    sites 0.4 sigma apart and an axial quadrupole) with orientations
    drawn from `seed`; LJ shifted at rc."""
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid
    from ls1_mardyn_tpu_torch.models.components import Component

    L = (n / rho) ** (1 / 3)
    c = Component(cid=0)
    if kind == "1clj":
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc, False)
    else:
        c.add_ljcenter(0.0, 0.0, -0.2, 0.5, 1.0, 1.0, rc, True)
        c.add_ljcenter(0.0, 0.0, 0.2, 0.5, 1.0, 1.0, rc, True)
        c.add_quadrupole(0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.2)
    data = cubic_grid(n, [L, L, L], TEMP, components=[c], seed=seed)
    if kind != "1clj":
        q = np.random.default_rng(seed).normal(size=(len(data.mid), 4))
        data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return data, L


def compare_devices(phase, build, device, keys):
    """Run build(dev) for 20 steps on the card and on the CPU (plain
    versions), f64, and hold the results together."""
    out = {}
    for dev in (device, "cpu"):
        sim, L = build(dev)
        gv = sim.run(steps=20, print_every=0)
        mol = sim.molecules()
        o = torch.argsort(mol.mid.cpu())
        out[dev] = (gv, {k: getattr(mol, k).cpu()[o].numpy() for k in keys},
                    type(sim.engine).__name__)
    (ga, ma, eng), (gb, mb, _) = out[device], out["cpu"]
    rel = {k: abs(float(getattr(ga, k)) / float(getattr(gb, k)) - 1)
           for k in ("temperature", "pressure", "upot")}
    err = {}
    for k in keys:
        d = ma[k] - mb[k]
        if k == "r":
            d -= L * np.round(d / L)
        err[k] = float(np.abs(d).max())
    say(phase, engine=eng, n=len(ma["r"]),
        rel=json.dumps({k: f"{x:.2e}" for k, x in rel.items()}),
        max_abs=json.dumps({k: f"{x:.2e}" for k, x in err.items()}))
    check(max(rel.values()) <= 1e-9 and max(err.values()) <= 1e-9,
          f"{phase}: the CUDA driver disagrees with the CPU driver")


def phase_small(device):
    """The RMM driver on the card against the same driver on the CPU
    (plain versions), f64, on a small lattice scene."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation

    def build(dev):
        data, L = lattice_scene(1024, 0.6, "1clj")
        return MDSimulation(scene_config(data.box), dtype=torch.float64,
                            phase_space_data=data, device=dev), L

    compare_devices("small", build, device, ("r", "v"))


def phase_general_small(device):
    """The general engine on the card against the CPU: the 1CLJ kernel
    path and the plain multi-site traversal.  The traversal adds pair
    terms with index_add_, in no fixed order on the card: agreement to
    rounding over 20 steps, well inside 1e-9."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath

    for mode, kind, n, rho in (("pallas", "1clj", 1000, 0.6),
                               ("cells", "2cljq", 900, 0.45)):
        def build(dev):
            data, L = lattice_scene(n, rho, kind)
            return MDSimulation(scene_config(data.box), dtype=torch.float64,
                                phase_space_data=data, device=dev,
                                force_mode=mode), L

        sim, _ = build("cpu")
        check((mode == "pallas") == isinstance(sim.engine._force_fn, CudaLJPath),
              f"general-small/{mode}: not the force path it names")
        compare_devices(f"general-small/{mode}", build, device,
                        ("r", "v", "q", "L"))


def timed_window(sim, steps):
    """ms per step of sim.run(steps): host clock around work that ends
    in a synchronize."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gv = sim.run(steps=steps, print_every=0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) / steps * 1e3, gv


def check_globals(phase, gv, n=None):
    """Finite T/p/Upot, T within 10% of TEMP and, given n, n molecules."""
    T, p, U = float(gv.temperature), float(gv.pressure), float(gv.upot)
    check(all(np.isfinite([T, p, U])), f"{phase}: non-finite T/p/Upot")
    check(abs(T / TEMP - 1) <= 0.1, f"{phase}: T={T} not within 10% of {TEMP}")
    check(n is None or int(float(gv.n)) == n, f"{phase}: lost molecules")
    return T, p, U


# where the plugin phases write their files (build/ is git-ignored)
PLUGIN_OUT = os.path.join(HERE, "build", "chip_smoke")
# the observer set of plugins-small on the RMM engine, and the plugins
# that keep the same scene on the general engine (K3)
WRITER_SET = ("ResultWriter", "EnergyLogWriter", "MaxWriter", "XyzWriter",
              "CheckpointWriter", "CheckpointWriter:binary", "TimerWriter",
              "SysMonOutput")
LIMITER_SET = ("ResultWriter", "FlopRateWriter", "MaxCheck")
# the writers of main/plugins, at writefrequency 10
MAIN_WRITERS = ("ResultWriter", "EnergyLogWriter", "MaxWriter", "TimerWriter",
                "SysMonOutput")
# nve: the time steps run, and the one held to the drift target (the
# README's claim: < 1e-4 over 10k steps at dt <= 0.0005)
NVE_DTS = (0.001, 0.0005, 0.00025)
NVE_GATE_DT = 0.0005
NVE_STEPS, NVE_EVERY, NVE_DRIFT = 10_000, 100, 1e-4


def fresh_dir(name):
    import shutil

    d = os.path.join(PLUGIN_OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def plugin_specs(d, names, freq):
    """PluginSpecs writing into d every `freq` steps ("X:binary" is X
    with <type>binary</type>, to its own prefix)."""
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec

    out = []
    for name in names:
        name, _, kind = name.partition(":")
        params = {"writefrequency": str(freq),
                  "outputprefix": os.path.join(d, kind or "run")}
        if kind:
            params["type"] = kind
        if name == "MaxCheck":
            params = {"vmax": "2.5"}
        out.append(PluginSpec(name, params))
    return out


def _num(tok):
    try:
        return float(tok)
    except ValueError:
        return None


def text_rel_err(a, b, columns=None):
    """Largest relative difference of the numbers of two writer files;
    raises unless their lines, tokens and spacing match (timestamps and
    wall-clock columns aside)."""
    import re

    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    check(len(la) == len(lb), f"{a}: {len(la)} lines against {len(lb)}")
    worst = 0.0
    for x, y in zip(la, lb):
        if " started at " in x or " finished at " in x:
            check(x.split(" at ")[0] == y.split(" at ")[0], f"{a}: {x!r}")
            continue
        check(re.sub(r"\S+", "x", x) == re.sub(r"\S+", "x", y),
              f"{a}: layout {x!r} against {y!r}")
        for k, (p, q) in enumerate(zip(x.split(), y.split())):
            if columns is not None and k >= columns:
                break
            fp, fq = _num(p), _num(q)
            if fp is None or fq is None:
                check(p == q, f"{a}: {p!r} against {q!r}")
            elif fp != fq:
                worst = max(worst, abs(fp - fq) / max(abs(fp), abs(fq)))
    return worst


def by_mid(data):
    o = np.argsort(data.mid)
    return {k: np.asarray(getattr(data, k))[o]
            for k in ("mid", "cid", "r", "v", "q", "L")}


def state_rel_err(a, b):
    """Largest elementwise relative difference of two PhaseSpaceData
    (molecules matched by id); ids and components must be equal."""
    a, b = by_mid(a), by_mid(b)
    check(np.array_equal(a["mid"], b["mid"]) and np.array_equal(a["cid"], b["cid"]),
          "molecule ids or components differ")
    worst = 0.0
    for k in ("r", "v", "q", "L"):
        d = np.abs(a[k] - b[k])
        m = np.maximum(np.abs(a[k]), np.abs(b[k]))
        worst = max(worst, float(np.max(np.where(d > 0, d / np.where(m > 0, m, 1), 0))))
    return worst


def compare_outputs(phase, da, db):
    """Every file of the card's run (da) against the CPU run's (db)."""
    from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint

    errs = {}
    names = sorted(os.listdir(da))
    check(names == sorted(os.listdir(db)), f"{phase}: file sets differ")
    for name in names:
        a, b = os.path.join(da, name), os.path.join(db, name)
        if name.endswith(".header.xml"):
            check(open(a).read() == open(b).read(), f"{phase}: {name} differs")
            continue
        if os.path.exists(a + ".header.xml"):
            errs[name] = state_rel_err(read_binary_checkpoint(a, a + ".header.xml"),
                                       read_binary_checkpoint(b, b + ".header.xml"))
        elif name.endswith(".timers"):
            shape = [[ln.split()[0], ln.split()[-1]] for ln in open(a)]
            check(shape == [[ln.split()[0], ln.split()[-1]] for ln in open(b)],
                  f"{phase}: {name} timers differ")
        else:
            errs[name] = text_rel_err(a, b, 2 if name.endswith(".floprate") else None)
    return errs


def phase_plugins_small(device):
    """The driver with its observer plugins on the card against the same
    driver on the CPU, f64, N=1024, 20 steps: the writer set on the RMM
    engine (K1), and MaxCheck + FlopRateWriter, which keep the scene on
    the general engine (K3).  Every output file agrees within rtol 1e-9;
    the binary checkpoint read back is bit-identical to the exported
    state."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint
    from ls1_mardyn_tpu_torch.ops import cuda_lj
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath

    for tag, names, engine, counter in (
            ("rmm", WRITER_SET, "RMMEngine", cuda_lj.lj_cell_forces),
            ("general", LIMITER_SET, "SingleChipSimulation",
             cuda_lj.lj_cell_forces_cw)):
        dirs = {}
        for dev in (device, "cpu"):
            d = dirs[dev] = fresh_dir(f"small_{tag}_{dev}")
            data, L = lattice_scene(1024, 0.6, "1clj")
            cfg = scene_config(data.box)
            cfg.output_plugins = plugin_specs(d, names, 5)
            sim = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                               device=dev)
            check(type(sim.engine).__name__ == engine,
                  f"plugins-small/{tag}: engine {type(sim.engine).__name__}")
            if tag == "general":
                path = sim.engine._force_fn
                check(isinstance(path, CudaLJPath) and path.cw,
                      "plugins-small/general: not the K3 path")
            counter.launches = 0
            gv = sim.run(steps=20, print_every=0)
            if dev != "cpu":
                launches = counter.launches
                check(launches >= 20, f"plugins-small/{tag}: {launches} launches")
                if tag == "rmm":
                    ck = os.path.join(d, "binary-20.restart.dat")
                    back = read_binary_checkpoint(ck, ck + ".header.xml")
                    now = sim._export_phasespace()
                    exact = state_rel_err(back, now) == 0.0 and \
                        back.current_time == now.current_time
                    check(exact, "plugins-small: binary restart not bit-identical")
                cv = sim.cv()
        errs = compare_outputs(f"plugins-small/{tag}", dirs[device], dirs["cpu"])
        say("plugins-small", scene=tag, engine=engine, n=int(float(gv.n)),
            launches=launches, files=len(os.listdir(dirs[device])), cv=f"{cv:.9f}",
            rel=json.dumps({k: f"{e:.1e}" for k, e in errs.items()}))
        check(max(errs.values()) <= 1e-9,
              f"plugins-small/{tag}: card and CPU files differ ({errs})")


def phase_main_plugins(sim_bare, device, smi):
    """The full-width RMM path with the writers of MAIN_WRITERS at
    writefrequency 10 for 2 rebin periods (K1 and K2 counted from 0),
    then windows of that length on the bare main path and on this one in
    turns; then one binary checkpoint of the whole state, read back."""
    from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces
    from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift
    from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine

    d = fresh_dir("main_plugins")
    lj_cell_forces.launches = 0
    rebin_shift.launches = 0
    sim = make_sim(2, device, plugins=plugin_specs(d, MAIN_WRITERS, 10))
    check(isinstance(sim.engine, RMMEngine), "main/plugins: not the RMM engine")
    steps = 2 * sim.engine.sim.rebin_every
    ms0, gv = timed_window(sim, steps)
    launches = {"K1": lj_cell_forces.launches, "K2": rebin_shift.launches}
    check(launches["K1"] >= steps and launches["K2"] >= 1,
          f"main/plugins did not run both kernels ({launches})")
    T, p, U = check_globals("main/plugins", gv, N_MAIN)
    rows = [ln.split() for ln in open(os.path.join(d, "run.res"))]
    rows = [r for r in rows if r[0].isdigit()]
    check(len(rows) == steps // 10
          and np.isfinite([[float(x) for x in r] for r in rows]).all(),
          "main/plugins: result file")
    bare, plug = [], []
    for _ in range(3):
        bare.append(timed_window(sim_bare, steps)[0])
        plug.append(timed_window(sim, steps)[0])
    ms_b, ms_p = float(np.mean(bare)), float(np.mean(plug))
    say("main/plugins", writers=",".join(MAIN_WRITERS), writefrequency=10,
        steps=steps, first_window_ms_per_step=f"{ms0:.3f}",
        ms_per_step=f"{ms_p:.3f}", main_ms_per_step=f"{ms_b:.3f}",
        windows=json.dumps({"main": [round(x, 3) for x in bare],
                            "plugins": [round(x, 3) for x in plug]}),
        writer_cost=f"{ms_p / ms_b - 1:+.3%}", T=f"{T:.6f}",
        launches=json.dumps(launches), gpu=repr(smi))
    ck = os.path.join(d, "full.restart.dat")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.write_checkpoint(ck, binary=True)
    secs = time.perf_counter() - t0
    nbytes = os.path.getsize(ck) + os.path.getsize(ck + ".header.xml")
    back = read_binary_checkpoint(ck, ck + ".header.xml")
    exact = state_rel_err(back, sim._export_phasespace()) == 0.0
    say("main/plugins", checkpoint="binary", n=len(back.mid), seconds=f"{secs:.3f}",
        bytes=nbytes, GB_per_s=f"{nbytes / secs / 1e9:.3f}", read_back_exact=exact)
    check(len(back.mid) == N_MAIN and exact,
          "main/plugins: binary checkpoint read back differs")
    os.remove(ck)
    return launches


def nve_drift(device, dt):
    """max|E - E0| / max(|E0|, 1) of the seed (one tile) on the RMM path
    without thermostat, LJ shifted at rc, f32, over NVE_STEPS steps; E
    sampled at step 1 and every NVE_EVERY steps (tests/
    test_simulation_e2e.py's definition)."""
    from ls1_mardyn_tpu_torch.models.components import Component
    from ls1_mardyn_tpu_torch.rmm_engine import RMMEngine

    c = Component(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, RC, True)
    sim = make_sim(1, device, components=[c], ensemble_type="NVE", timestep=dt)
    check(isinstance(sim.engine, RMMEngine) and not sim.engine.sim.thermostat,
          "nve: not the RMM engine without thermostat")
    e = []
    t0 = time.perf_counter()
    for steps in [1, NVE_EVERY - 1] + [NVE_EVERY] * (NVE_STEPS // NVE_EVERY - 1):
        gv = sim.run(steps=steps, print_every=0)
        e.append(float(gv.upot) + 0.5 * (float(gv.summv2) + float(gv.sum_iw2)))
    secs = time.perf_counter() - t0
    check(sim.step == NVE_STEPS and np.all(np.isfinite(e)), "nve: run")
    e = np.asarray(e)
    drift = float(np.abs(e - e[0]).max() / max(abs(e[0]), 1.0))
    return drift, e, secs, sim.engine.sim.rebin_every, int(float(gv.n))


def phase_nve(device, smi):
    drifts = {}
    for dt in NVE_DTS:
        drift, e, secs, rebin_every, n = nve_drift(device, dt)
        drifts[dt] = drift
        say("nve", dt=dt, n=n, steps=NVE_STEPS, drift=f"{drift:.3e}",
            E0=f"{e[0]:.6f}", E_end=f"{e[-1]:.6f}", rebin_every=rebin_every,
            ms_per_step=f"{secs / NVE_STEPS * 1e3:.3f}", gpu=repr(smi))
    check(drifts[NVE_GATE_DT] < NVE_DRIFT,
          f"nve: drift {drifts[NVE_GATE_DT]:.3e} at dt {NVE_GATE_DT} "
          f"not below {NVE_DRIFT}")
    return drifts


def phase_main(device, smi):
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces
    from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift

    torch.cuda.reset_peak_memory_stats()
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
    steps = rsim.rebin_every + 2
    ms0, gv = timed_window(sim, steps)
    launches = {"K1": lj_cell_forces.launches, "K2": rebin_shift.launches}
    T, p, U = check_globals("main", gv, N_MAIN)
    say("main", n=int(float(gv.n)), grid=rsim.spec.dims, cap=rsim.spec.cap,
        rebin_every=rsim.rebin_every, steps=steps, T=f"{T:.6f}",
        p=f"{p:.6f}", upot_per_mol=f"{U / N_MAIN:.6f}",
        rebin_fallbacks=rsim.n_rebin_fallback,
        construct_s=round(t_build, 2), prepare_start_s=round(t_prep, 2),
        run_s=round(ms0 * steps / 1e3, 2), launches=json.dumps(launches))
    check(launches["K1"] == steps + 1 and launches["K2"] >= 2,
          f"main path did not run both kernels ({launches})")
    # steady-state window: one whole rebin period
    win = rsim.rebin_every
    ms, _ = timed_window(sim, win)
    # one whole shift rebin (ops/rmm.py: the Kahan fold, K2, the split
    # back into planes and forces) on the window's end state
    rebin_ms = cuda_ms(lambda: rsim._rebin_shift(rsim.state), 5)
    say("main", window_steps=win, ms_per_step=f"{ms:.3f}",
        updates_per_s=f"{N_MAIN / ms * 1e3:.4e}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        rebin_fold_K2_split_ms=f"{rebin_ms:.3f}", gpu=repr(smi))
    return sim, launches


def phase_packed(sim, smi):
    """K10 on the main path's state: pack the RMM planes into pencils,
    build the tables, K10, unpack; the forces against K1 on the same
    state.  In f32 the two recentre the coordinates differently (K10 on
    the group's base cell), so pairs within an ulp of the cutoff may
    count in one and not the other: a flip moves a force by the unshifted
    LJ step at rc (0.039 eps/sigma), ~2e-4 of max|F| (PERF.md)."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces
    from ls1_mardyn_tpu_torch.ops.cuda_packed import lj_forces_packed, unpack_pencils

    rsim = sim.engine.sim
    planes = rsim.state.planes
    nx, ny, nz = rsim.spec.dims
    cap = rsim.spec.cap
    lj_forces_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed, occ, starts, tab, meta, feas, Wp = packed_views(planes, rsim.spec.dims, cap)
    out = lj_forces_packed(packed[:, :, :4].contiguous(), tab, meta, nx=nx, ny=ny,
                           nz=nz, Wp=Wp, box=rsim.spec.box, eps24=rsim.eps24,
                           sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    _, f = unpack_pencils(packed, out[0], occ, starts, nx, cap)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = lj_forces_packed.launches
    ref = lj_cell_forces(planes[:, :, :4], dims=rsim.spec.dims, cap=cap,
                         cell_len=rsim.cell_len, eps24=rsim.eps24, sig2=rsim.sig2,
                         shift6=rsim.shift6, rc2=rsim.rc2)
    w = planes[:, :, 3:4] > 0.5
    errs = rel_errors((torch.where(w, f, 0.0), out[1], out[2]), ref)
    say("packed", grid=rsim.spec.dims, cap=cap, Wp=Wp, feasible=feas,
        pack_tables_K10_unpack_s=round(secs, 3),
        rel_vs_K1=json.dumps([f"{e:.2e}" for e in errs]), launches=n,
        gpu=repr(smi))
    check(n == 1 and errs[0] <= 1e-3 and max(errs[1:]) <= 1e-5,
          f"K10 on the main state against K1: {errs}, launches {n}")
    return {"K10": n}


def phase_variants(sim, smi):
    """K7, K8 and K9, which no engine calls, each launched on the main
    path's state with its counter set to 0 just before: K7 on a copy of
    the planes with their x halo, K8 (K1's launch under its own
    wrapper), K9 with direct and with Gram r^2; the forces held against
    K1 on the same state, with the limits of phase_packed (each pair
    once in K1 and K8, from both sides in K7 and K9: a pair within an
    ulp of the cutoff may count in one and not the other).  Returns the
    launches: 1 each, 2 for K9."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces
    from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V

    rsim = sim.engine.sim
    r4 = rsim.state.planes[:, :, :4, :]
    dims, cap = rsim.spec.dims, rsim.spec.cap
    lj = dict(eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    kw = dict(dims=dims, cap=cap, cell_len=rsim.cell_len, **lj)
    ref = lj_cell_forces(r4, **kw)
    r_i = r4.contiguous()
    counters = {"K7": V.lj_cell_forces_lanej, "K8": V.lj_cell_forces_n3l,
                "K9": V.lj_cell_forces_zb}
    for c in counters.values():
        c.launches = 0
    errs = {
        "K7": rel_errors(V.lj_cell_forces_lanej(
            r_i, x_halo(r_i, dims[0], cap), dims=dims, cap=cap,
            box=rsim.spec.box, **lj), ref),
        "K8": rel_errors(V.lj_cell_forces_n3l(r4, **kw), ref),
        "K9": rel_errors(V.lj_cell_forces_zb(r4, **kw), ref),
        "K9 gram": rel_errors(V.lj_cell_forces_zb(r4, gram=True, **kw), ref)}
    launches = {k: c.launches for k, c in counters.items()}
    say("variants", grid=dims, cap=cap,
        rel_vs_K1=json.dumps({k: [f"{e:.2e}" for e in v] for k, v in errs.items()}),
        launches=json.dumps(launches), gpu=repr(smi))
    check(launches == {"K7": 1, "K8": 1, "K9": 2},
          f"K7/K8/K9 on the main state: launches {launches}")
    check(all(e[0] <= 1e-3 and max(e[1:]) <= 1e-5 for e in errs.values()),
          f"K7/K8/K9 on the main state against K1: {errs}")
    return launches


def phase_general(device, smi):
    """This slice's path at full width: the general engine with the
    1CLJ kernel path on the main path's scene."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import (
        lj_cell_forces_cw, lj_cell_forces_row)
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
    from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lj_cell_forces_cw.launches = lj_cell_forces_cw.half_launches = 0
    lj_cell_forces_row.launches = 0
    sim = make_sim(2, device, force_mode="pallas")
    eng = sim.engine
    path = eng._force_fn
    check(isinstance(eng, SingleChipSimulation) and isinstance(path, CudaLJPath)
          and path.cw, "general path: engine or force path")
    t_build = time.perf_counter() - t0
    eng.prepare_start()
    warm, win = 4, 16
    ms0, _ = timed_window(sim, warm)
    ms, gv = timed_window(sim, win)
    k3 = lj_cell_forces_cw.launches
    T, p, U = check_globals("general", gv, N_MAIN)
    check(sim.engine is eng, "general path: cell capacity overflow (re-spec)")
    check(k3 == 1 + warm + win and lj_cell_forces_row.launches == 0,
          f"general path: K3 launched {k3} times in {warm + win} steps")
    # on a grid of >= 3 cells an axis every launch takes the half shell
    check(lj_cell_forces_cw.half_launches == k3,
          f"general path: {lj_cell_forces_cw.half_launches} of {k3} K3 "
          "launches on the half shell")
    say("general", n=int(float(gv.n)), grid=path.spec.dims, cap=path.spec.cap,
        T=f"{T:.6f}", p=f"{p:.6f}", upot_per_mol=f"{U / N_MAIN:.6f}",
        construct_s=round(t_build, 2), warm_ms_per_step=f"{ms0:.3f}",
        window_steps=win, ms_per_step=f"{ms:.3f}",
        updates_per_s=f"{N_MAIN / ms * 1e3:.4e}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        gpu=repr(smi))
    # the same engine through the row kernel
    path.cw = False
    ms4, gv = timed_window(sim, 3)
    path.cw = True
    k4 = lj_cell_forces_row.launches
    check_globals("general/K4", gv, N_MAIN)
    check(k4 == 3 and lj_cell_forces_cw.launches == k3,
          f"general path with cw off: K4 launched {k4} times in 3 steps")
    say("general", cw="off", steps=3, ms_per_step=f"{ms4:.3f}",
        launches=json.dumps({"K3": k3, "K4": k4}))
    return sim, {"K3": k3, "K4": k4}


def phase_multisite_cells(device, smi):
    """The plain general traversal (force_mode="cells", no kernel) on a
    2CLJ+quadrupole fluid of N = 97,336: the multi-site path before K5
    and K6, kept as their end-to-end yardstick."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cellforce import default_cell_chunk

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    data, L = lattice_scene(97336, 0.45, "2cljq")
    sim = MDSimulation(scene_config(data.box), phase_space_data=data,
                       device=device, force_mode="cells")
    eng = sim.engine
    q0 = sim.molecules().q.clone()
    eng.prepare_start()
    ms, gv = timed_window(sim, 4)
    ms_state_report("multisite-cells", sim, gv, len(data.mid), q0, ms, smi,
                    mem0, cell_chunk=default_cell_chunk(eng.spec), steps=4)


def slab_scene(seed=11):
    """A 1CLJ liquid slab in vapour: a jittered 17^3 lattice (rho ~ 0.95)
    5 sigma up the z axis of a (17.4, 17.4, 60) box, the rest empty; the
    driver lays non-uniform z rows over it.  Returns (data, box)."""
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    box = np.array([17.4, 17.4, 60.0])
    k = 17
    g = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(float)
    data = cubic_grid(len(g), box, TEMP, seed=seed)
    rng = np.random.default_rng(seed)
    data.r = (g + 0.5 + rng.uniform(-0.1, 0.1, g.shape)) * (box[0] / k)
    data.r[:, 2] += 5.0
    return data, box


def phase_multisite_small(device):
    """The multi-site kernel paths on the card against the same driver on
    the CPU (plain versions), f64, 20 steps: force_mode "ms_packed" (K5)
    and "ms_dense" (K6) on a 2CLJ+quadrupole lattice of N = 4096, and a
    1CLJ liquid slab in vapour on adaptive z rows under "auto" (K6):
    T, p, Upot rtol 1e-9; r, v, q, L 1e-9."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath
    from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath

    def lattice(mode):
        def build(dev):
            data, L = lattice_scene(4096, 0.45, "2cljq")
            return MDSimulation(scene_config(data.box), dtype=torch.float64,
                                phase_space_data=data, device=dev,
                                force_mode=mode), L
        return build

    def slab(dev):
        data, box = slab_scene()
        return MDSimulation(scene_config(box), dtype=torch.float64,
                            phase_space_data=data, device=dev), box

    for tag, build, packed in (("ms_packed", lattice("ms_packed"), True),
                               ("ms_dense", lattice("ms_dense"), False),
                               ("adaptive_z", slab, False)):
        sim, _ = build("cpu")
        path = sim.engine._force_fn
        check(isinstance(path, CudaMultiSitePath) and path.packed == packed
              and (tag != "adaptive_z" or sim._z_edges is not None),
              f"multisite-small/{tag}: not the force path it names ({path})")
        compare_devices(f"multisite-small/{tag}", build, device,
                        ("r", "v", "q", "L"))


def ms_state_report(phase, sim, gv, n, q0, ms, smi, mem0=0, **extra):
    """Checks and prints a multi-site run: finite T/p/Upot, no molecule
    lost, T_trans within 10% of the target (the start has no angular
    momentum, so the rotational share of T is still filling), unit
    quaternions that turned.  peak_mem_GB is the peak device memory
    above mem0, what the script held before the run was built."""
    T, p, U = float(gv.temperature), float(gv.pressure), float(gv.upot)
    T_trans = float(gv.summv2) / (3 * n)
    check(all(np.isfinite([T, p, U])) and int(float(gv.n)) == n,
          f"{phase}: non-finite T/p/Upot or lost molecules")
    check(abs(T_trans / TEMP - 1) <= 0.1,
          f"{phase}: T_trans={T_trans} not within 10% of {TEMP}")
    mol = sim.molecules()
    qn = float(((mol.q ** 2).sum(-1) - 1).abs().max())
    turned = float((mol.q - q0).abs().max())
    check(qn <= 1e-5 and turned > 1e-3 and bool(torch.isfinite(mol.L).all()),
          f"{phase}: quaternions not normalized or not rotating")
    spec = getattr(sim.engine._force_fn, "spec", sim.engine.spec)
    say(phase, n=n, grid=spec.dims, cap=spec.cap, T=f"{T:.6f}",
        T_trans=f"{T_trans:.6f}", p=f"{p:.6f}", upot_per_mol=f"{U / n:.6f}",
        max_q_norm_err=f"{qn:.2e}", max_q_change=f"{turned:.3f}",
        ms_per_step=f"{ms:.3f}", updates_per_s=f"{n / ms * 1e3:.4e}",
        peak_mem_GB=f"{(torch.cuda.max_memory_allocated() - mem0) / 1e9:.3f}",
        gpu=repr(smi), **extra)


def phase_multisite(device, smi):
    """This slice's path at full width: a 2CLJ+quadrupole fluid of
    N = 1,061,208 at rc = 6.2 through MDSimulation(force_mode="auto"),
    which must pick K5 (warm-up and a 16-step window), then the same
    scene under "ms_dense" through K6 (3 steps).  Returns the sims, their
    kernels' launches and K5's launches on the half shell."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_ms import multisite_cell_forces
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
        CudaMultiSitePackedPath, multisite_cell_forces_packed)

    data, L = lattice_scene(N_MS, RHO_MS, "2cljq", rc=RC_MS)
    n = len(data.mid)
    check(n == N_MS, "multisite: N")
    sims, launches = {}, {}
    for key, mode, warm, win in (("K5", "auto", 2, 16), ("K6", "ms_dense", 0, 3)):
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sim = MDSimulation(scene_config(data.box, RC_MS), phase_space_data=data,
                           device=device, force_mode=mode)
        eng = sim.engine
        path = eng._force_fn
        check(isinstance(path, CudaMultiSitePackedPath) == (key == "K5"),
              f"multisite/{mode}: force path {type(path).__name__}")
        t_build = time.perf_counter() - t0
        q0 = sim.molecules().q.clone()
        multisite_cell_forces_packed.launches = 0
        multisite_cell_forces_packed.half_launches = 0
        multisite_cell_forces.launches = 0
        eng.prepare_start()
        ms0 = timed_window(sim, warm)[0] if warm else 0.0
        ms, gv = timed_window(sim, win)
        got = {"K5": multisite_cell_forces_packed.launches,
               "K6": multisite_cell_forces.launches}
        check(sim.engine is eng, f"multisite/{mode}: cell capacity re-spec")
        check(got[key] == 1 + warm + win and sum(got.values()) == got[key],
              f"multisite/{mode}: launches {got} in {warm + win} steps")
        half = multisite_cell_forces_packed.half_launches
        check(half == got["K5"], f"multisite/{mode}: {half} of {got['K5']} K5 "
              "launches on the half shell")
        if key == "K5":
            k5_half = half
        ms_state_report(f"multisite/{key}", sim, gv, n, q0, ms, smi, mem0,
                        mode=mode, construct_s=round(t_build, 2),
                        warm_ms_per_step=f"{ms0:.3f}", window_steps=win,
                        launches=json.dumps(got))
        sims[key], launches[key] = sim, got[key]
    return sims, launches, k5_half


# operations of one in-cutoff UNORDERED pair per site-pair term, by body
# code (csrc/ms_pair.cuh: Body), counted from that source (PERF.md): the
# site separation (12), the body, the sums on i and the reaction on j
# (F, torque, Vi: ~24-27 each side); an erfc-screened charge pair counts
# its exp and erfc as one operation each and 8 more
MS_TERM_OPS = {0: 74, 1: 67, 2: 107, 3: 97, 4: 110, 5: 186, 6: 180, 7: 100,
               8: 177, 9: 175}
MS_SCREENED_CC_OPS = 77


def ms_bound(mol, spec, meta, rc2, screened, in_bytes, out_elems, size):
    """Least time the card could take for a multi-site call on this
    state: the bytes (in_bytes, the inputs once as needed_bytes counts
    them; output planes once) over the memory rate, against the operations this data needs over the f32 peak: 8 per
    candidate UNORDERED pair of two molecules in the same or neighbouring
    cells and, per pair inside the cutoff, the site-pair program's terms
    (MS_TERM_OPS, MS_SCREENED_CC_OPS).  The pairs inside the cutoff are counted by a K3
    launch on the COM positions with eps24 = 0 and shift6 = 1, whose
    halved u6 is the unordered count."""
    import types

    from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath

    nx, ny, nz = spec.dims
    occ = bin_particles(mol.r, mol.valid, spec).counts.reshape(nz, ny, nx).double()
    nb = sum(torch.roll(occ, (dz, dy, dx), (0, 1, 2))
             for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    candidates = (float((occ * nb).sum()) - float(occ.sum())) / 2.0
    cap32 = -(-spec.cap // 32) * 32
    spec32 = CellGridSpec(dims=spec.dims, box=spec.box, cap=cap32)
    r4, _ = CudaLJPath.layout(types.SimpleNamespace(spec=spec32), mol)
    _, u6, _ = lj_cell_forces_cw(r4, dims=spec.dims, cap=cap32,
                                 cell_len=spec.cell_len, eps24=0.0, sig2=0.0,
                                 shift6=1.0, rc2=rc2)
    inside = float(u6)
    per_pair = sum(MS_SCREENED_CC_OPS if b == 1 and screened else MS_TERM_OPS[b]
                   for b in meta.terms()[:, 0].tolist())
    t_bytes = (in_bytes + out_elems * size) / PEAK_BYTES * 1e3
    t_ops = (8 * candidates + per_pair * inside) / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "in_bytes": in_bytes, "out_bytes": out_elems * size,
            "candidates": candidates, "inside": inside,
            "ops_per_inside_pair": per_pair}


def plain_once_ms(fn):
    """Device time of one call (the plain versions synchronise inside,
    so a warm-up would only double the cost)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    res = fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), res


def ptxas_report(name, log=None):
    """Registers, spills and static shared memory of each kernel of
    csrc/<name>.cu, read from the ptxas report (nvcc -Xptxas -v) that
    ops/_build.py keeps beside the library (or from `log`, such a
    report): {"f32"|"f64"|entry: {...}}; a warp-skeleton kernel
    (csrc/lj_warp.cuh) as "f32 macro vi gram" with its template flags,
    e.g. "f32 100" (u6/virial, no Vi, no Gram), the half shell's (K1's,
    also K3's half-shell branch and K8, in csrc/lj_cells.cu) and K10's
    (csrc/lj_packed.cu) as "f32 macro"; the multi-site kernel
    (csrc/ms_pair.cuh) as "f32 half" (the half shell) or "f32 full" (the
    double-sided walk)."""
    import re

    from ls1_mardyn_tpu_torch.ops import _build

    out, cur = {}, None
    for ln in (_build.build_log(name) if log is None else log).splitlines():
        if "Compiling entry function" in ln:
            ent = ln.split("'")[1]
            ms = re.search(r"ms_kernelI([fd])Lb([01])E", ent)
            if ms:
                cur = ("f32 " if ms.group(1) == "f" else "f64 ") + (
                    "half" if ms.group(2) == "1" else "full")
                out[cur] = {}
                continue
            warp = re.search(
                r"(?:warp_cells|packed)_kernel(?:_half)?I([fd])((?:Lb[01]E)+)",
                ent)
            if warp:
                cur = ("f32 " if warp.group(1) == "f" else "f64 ") + "".join(
                    re.findall(r"Lb([01])E", warp.group(2))[:3])
            else:
                cur = "f32" if "IfN" in ent else ("f64" if "IdN" in ent else ent)
            out[cur] = {}
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[cur].update(stack=nums[0], spill_stores=nums[1],
                            spill_loads=nums[2])
        elif cur and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[cur]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[cur]["smem"] = int(words[words.index("smem") - 2])
    return out


def _warp_cells(valid, cell, width):
    """Per group of `width` consecutive slots of each row: the number of
    valid slots and the least and greatest cell among them (0 where the
    group holds none)."""
    pad = -valid.shape[-1] % width
    v = torch.nn.functional.pad(valid, (0, pad)).reshape(
        *valid.shape[:-1], -1, width)
    c = torch.nn.functional.pad(cell, (0, pad)).reshape(v.shape)
    n = v.sum(-1)
    lo = torch.where(v, c, torch.iinfo(c.dtype).max).amin(-1)
    hi = torch.where(v, c, -1).amax(-1)
    return n, torch.where(n > 0, lo, 0), torch.where(n > 0, hi, 0)


def ms_window_candidates(r_i, cell, nx, cap, tbl=None, width=32,
                         valid_j=True, half=False):
    """(i slot, j slot) tests the multi-site kernels' windows walk in one
    call on this state (csrc/ms_pair.cuh): per group of `width` i slots
    (32: a warp's window; 128: a block's, as PR 4's kernels walked), its
    valid slots times the j slots of cells lo-1 .. hi+1 of the 9
    neighbour rows (wrapped rows, no halo rows); with `half` (K5's half
    shell, packed rows) of the four forward rows and of the centre row
    after the group's first slot.  Packed rows (K5) read the j ranges
    from the cell-start table tbl; dense rows (K6) count the valid j
    slots (valid_j: the warps stage valid slots only) or all cap slots
    of a cell (the block skeleton tested every slot)."""
    valid = r_i[:, :, 3] > 0.5
    n, lo, hi = _warp_cells(valid, cell.long(), width)
    n = n.double()
    # packed rows keep the right wrap halo in a head range
    wrap_hi = (hi >= nx - 1) & (tbl is not None)
    if tbl is None:
        if not valid_j:
            return int(round(float((9 * n * (hi - lo + 3) * cap).sum())))
        occ = valid.reshape(*valid.shape[:2], nx, cap).sum(-1)
        ext = torch.cat([occ[..., -1:], occ, occ[..., :1]], -1)
        # start of extended cell c (cell c-1 of the row) in valid j slots
        tbl = torch.nn.functional.pad(torch.cumsum(ext, -1), (1, 0))
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import HALF_ROWS

    # a packed group's first slot is valid where the group holds one
    first = 2 * cap + width * torch.arange(lo.shape[-1], device=lo.device) + 1
    total = 0.0
    for dz, dy in HALF_ROWS if half else [(dz, dy) for dz in (-1, 0, 1)
                                          for dy in (-1, 0, 1)]:
        tb = torch.roll(tbl, shifts=(-dz, -dy), dims=(0, 1)).long()
        a0 = torch.gather(tb, 2, lo)
        if half and (dz, dy) == (0, 0):
            a0 = torch.maximum(a0, first)
        a1 = torch.where(wrap_hi, tb[..., nx + 1:nx + 2],
                         torch.gather(tb, 2, torch.clamp(hi + 3, max=nx + 2)))
        head = torch.where(wrap_hi, tb[..., nx + 2:nx + 3], 0)
        total += float((n * ((a1 - a0).clamp(min=0) + head)).sum())
    return int(round(total))


def ms_times(key, kernel, plain, args, kw, nz, slab, smi, bound, **extra):
    """Kernel (CUDA events, 5 launches) and plain version at the path's
    shape; the plain version on a 2-row z slab of the same state first,
    and at full width when that extrapolates to under 60 s.  `extra` is
    printed with the times."""
    k_ms = cuda_ms(lambda: kernel(*args, **kw), 5)
    s_args, s_kw = slab(2)
    slab_ms, ref = plain_once_ms(lambda: plain(*s_args, **s_kw))
    rel = max(ms_rel_errors(kernel(*s_args, **s_kw), ref).values())
    full = slab_ms * nz / 2 <= 60e3
    plain_ms = slab_ms
    if full:
        plain_ms, ref = plain_once_ms(lambda: plain(*args, **kw))
        rel = max(ms_rel_errors(kernel(*args, **kw), ref).values())
    got = kernel(*args, **kw)
    err = float((got[0] - ref[0]).abs().max()) if full else float("nan")
    check(rel <= 1e-5, f"{key} at its path's shape: rel err {rel}")
    say("times", kernel=key, ms=f"{k_ms:.3f}", plain_ms=f"{plain_ms:.1f}",
        plain_on="full width" if full else f"z slab of 2 of {nz} rows",
        plain_slab_ms=f"{slab_ms:.1f}", max_abs_err=f"{err:.3e}",
        rel_err=f"{rel:.3e}", bound=json.dumps(bound), gpu=repr(smi),
        **{k: json.dumps(v) for k, v in extra.items()})
    return dict(max_abs_err=err if full else rel, ms=k_ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def k5_times(sim, key, smi):
    """K5 beside its plain version at the shapes the packed path of `sim`
    gave it (its screen_alpha included), with its bound."""
    from ls1_mardyn_tpu_torch.ops import cuda_ms_packed

    path = sim.engine._force_fn
    mol = sim.engine.mol
    nx, ny, nz = path.spec.dims
    tbl, r_i, r_j, _, _ = path._build_views(mol)
    kw = dict(nx=nx, ny=ny, nz=nz, cap=path.spec.cap, Wp=path.Wp, Wjp=path.Wjp,
              cell_plane=path.cell_plane, box=path.spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=path.screen_alpha, meta=path.meta)

    def slab5(ns):
        return ((tbl[:ns + 2].contiguous(), r_i[1:ns + 1].contiguous(),
                 r_j[:ns + 2].contiguous()), dict(kw, nz=ns, z_halo=True))

    size = r_i.element_size()
    b5 = ms_bound(mol, path.spec, path.meta, max(path.rc2, path.rc2_lj),
                  path.screen_alpha > 0,
                  tbl.numel() * 4 + needed_bytes(r_i) + needed_bytes(r_j),
                  r_i.shape[0] * r_i.shape[1] * 10 * r_i.shape[3], size)
    cells = r_i[:, :, path.cell_plane].round().long()
    return ms_times(key, cuda_ms_packed.multisite_cell_forces_packed,
                    cuda_ms_packed.multisite_cell_forces_packed_reference,
                    (tbl, r_i, r_j), kw, nz, slab5, smi, b5,
                    grid=list(path.spec.dims), cap=path.spec.cap,
                    screen_alpha=path.screen_alpha,
                    **ms_walk_report("ms_packed", b5, r_i, cells, nx,
                                     path.spec.cap, tbl, half=True))


def phase_times_ms(sims, smi):
    """K5 and K6 beside their plain versions at the shapes the full-width
    paths gave them, each with its bound."""
    from ls1_mardyn_tpu_torch.ops import cuda_ms

    out = {"K5": k5_times(sims["K5"], "K5", smi)}
    path = sims["K6"].engine._force_fn
    mol = sims["K6"].engine.mol
    nx, ny, nz = path.spec.dims
    r_i, _ = path.layout(mol)
    r_j = path.x_halo(r_i).contiguous()
    size = r_i.element_size()
    kw6 = dict(nx=nx, ny=ny, nz=nz, cap=path.spec.cap, box=path.spec.box,
               rc2=path.rc2, rc2_lj=path.rc2_lj,
               screen_alpha=path.screen_alpha, meta=path.meta)

    def slab6(ns):
        return ((r_i[1:ns + 1].contiguous(), r_j[:ns + 2].contiguous()),
                dict(kw6, nz=ns, z_halo=True))

    b6 = ms_bound(mol, path.spec, path.meta, max(path.rc2, path.rc2_lj),
                  path.screen_alpha > 0,
                  needed_bytes(r_i) + needed_bytes(r_j),
                  r_i.numel() // r_i.shape[2] * 10, size)
    slots = torch.arange(r_i.shape[-1], device=r_i.device) // path.spec.cap
    out["K6"] = ms_times("K6", cuda_ms.multisite_cell_forces,
                         cuda_ms.multisite_cell_forces_reference, (r_i, r_j),
                         kw6, nz, slab6, smi, b6,
                         **ms_walk_report("ms_dense", b6, r_i,
                                          slots.expand(r_i.shape[0], r_i.shape[1], -1),
                                          nx, path.spec.cap))
    return out


def ms_walk_report(lib, bound, r_i, cells, nx, cap, tbl=None, half=False):
    """What a K5/K6 call walks on this state: the (i, j) candidate tests
    of the warp windows (`half`: K5's half shell; and of the block
    skeleton's windows, every j slot, double-sided), the pairs inside
    the cutoff that the site program runs on (the bound's unordered count
    on the half shell, twice it on the double-sided walk), and the ptxas
    report of the library."""
    return dict(
        window_candidates=ms_window_candidates(r_i, cells, nx, cap, tbl, 32,
                                               half=half),
        pr4_window_candidates=ms_window_candidates(r_i, cells, nx, cap, tbl,
                                                   128, valid_j=False),
        site_program_pairs=(1 if half else 2) * int(bound["inside"]),
        ptxas=ptxas_report(lib))


# the bound's in-cutoff count, checked against the plain version's once
# per state: {(dims, cap): ordered pairs}
_BOUND_CHECKED = {}


def lj_warp_walk(r_i, dims, cap, cell_len, rc2, cull=True, split=True,
                 j_cells=None, gram=False, half=False):
    """What the warp skeleton of K1, K3, K4, K7, K8 and K9
    (csrc/lj_warp.cuh) walks on this state, counted here with torch from
    the same data: per warp (32 slots of an i cell holding n_i valid
    ones), the valid j slots of its 27 neighbour cells (with `half` K8's
    half shell: the own cell's slots above the warp's first valid i slot
    and the 13 forward cells) staged, those kept by the box cull
    (boxdist2 < rc^2, rounded as the kernel rounds it; with `gram` below
    the Gram form's threshold rc^2 + kappa (max s_i + s_j); all with
    cull=False), and the j iterations walked, with the warp split in two
    halves (ways = 2) for n_i <= 16: 32/ways iterations for each full
    ring of 32 kept slots and ceil(rest/ways) for the last.  j_cells:
    the neighbour cells as ops/cuda_lj's plain versions stage them (K1's
    periodic cell-local ones by default; K4's j view via
    ops/cuda_lj._row_j_cells).  cull=False and split=False count the
    earlier design steps without the cull or the split
    (tools/lj_kernel_times.py --walk); the kernel has both.  Returns the
    totals and the means per warp with a valid i (the block skeleton
    walked 27 * cap iterations per i slot, K8's 13.5 * cap on average)."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import _cells, _local_j_cells
    from ls1_mardyn_tpu_torch.ops.cuda_lj import FORWARD

    nx, ny, nz = dims
    nch = cap // 32
    pos, val = _cells(r_i, nx, cap)
    pw = pos.reshape(nz, ny, nx, nch, 32, 3)
    vw = val.reshape(nz, ny, nx, nch, 32)
    big = torch.finfo(pos.dtype).max
    lo = torch.where(vw[..., None], pw, big).amin(4)
    hi = torch.where(vw[..., None], pw, -big).amax(4)
    n_i = vw.sum(-1)
    kept = torch.zeros_like(n_i)
    staged = torch.zeros_like(n_i)
    if j_cells is None:
        j_cells = _local_j_cells(pos, val, cell_len, nz, False)
    thr = rc2
    if gram:
        kappa = 2.0 ** (-18 if pos.dtype == torch.float32 else -47)
        s_i = pw[..., 0] * pw[..., 0] + pw[..., 1] * pw[..., 1] \
            + pw[..., 2] * pw[..., 2]
        smax = torch.where(vw, s_i, 0.0).amax(4)[..., None]
    if half:
        # the first valid i slot of each warp; own-cell j slots above it
        lane = torch.arange(32, device=pos.device)
        first = torch.where(vw, lane, 32).amin(-1)
        smin = first + 32 * torch.arange(nch, device=pos.device)
        above = torch.arange(cap, device=pos.device) > smin[..., None]
    offsets = ((0, 0, 0),) + FORWARD if half else [
        (dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for off in offsets:
        pj, vj = j_cells(0, nz, off)
        pj = pj[:, :, :, None]  # [z, y, x, 1, cap, 3]
        a = lo[:, :, :, :, None] - pj
        b = pj - hi[:, :, :, :, None]
        g = torch.where(a > 0, a, torch.where(b > 0, b, 0.0))
        bd2 = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] \
            + g[..., 2] * g[..., 2]
        if gram:
            s_j = pj[..., 0] * pj[..., 0] + pj[..., 1] * pj[..., 1] \
                + pj[..., 2] * pj[..., 2]
            thr = rc2 + kappa * (smax + s_j)
        vj = vj[:, :, :, None]
        if half and off == (0, 0, 0):
            vj = vj & above
        staged += vj.sum(-1)
        kept += (vj & ((bd2 < thr) | (not cull))).sum(-1)
    ways = torch.where((n_i <= 16) & split, 2, 1)
    iters = (kept // 32) * (32 // ways) + (kept % 32 + ways - 1) // ways
    live = n_i > 0
    nw = int(live.sum())
    return {"warps_with_i": nw, "j_staged": int(staged[live].sum()),
            "j_kept": int(kept[live].sum()),
            "culled_share": round(1.0 - float(kept[live].sum())
                                  / float(staged[live].sum()), 4),
            "j_iterations": int(iters[live].sum()),
            "j_iterations_per_warp": round(float(iters[live].sum()) / nw, 1),
            "j_kept_per_warp": round(float(kept[live].sum()) / nw, 1),
            "split_share": round(float(((ways == 2) & live).sum()) / nw, 4),
            "block_skeleton_iterations_per_warp": 13.5 * cap if half else 27 * cap}


def needed_bytes(planes):
    """Bytes a function must read of a [..., P, slots] plane set whose
    plane 3 is the validity flag (the LJ kernels' xyz + valid; the
    multi-site kernels' rows): the flag of every slot and the other
    planes of the occupied ones (an empty slot's are never used)."""
    P = planes.shape[-2]
    occupied = int((planes[..., 3, :] > 0.5).sum())
    return (planes.numel() // P + (P - 1) * occupied) * planes.element_size()


def lj_bound(r_i, dims, cap, lj, out_planes, r_j=None, nbytes=None):
    """Least time the card could take for an LJ cell-force call on these
    inputs: bytes (the inputs read once, as needed_bytes counts them for
    r_i and for a kernel's j copy r_j; the force planes written once)
    over the memory rate, against the operations this data needs over
    the f32 peak.  The function needs each UNORDERED pair once (Newton's
    third law; the kernels evaluate every pair from both sides, which is
    their choice and not the function's): 8 operations per candidate
    pair of two different occupied slots in the same or neighbouring
    cells (3 subtractions, 3 products, 2 sums for r^2), and 25 more per
    pair inside the cutoff (22 for the LJ term and the sums on i, 3 for
    the reaction on j).  The pairs inside the cutoff are counted by K3's
    launch with eps24 = 0 and shift6 = 1 (ops/cuda_lj.inside_pairs; half
    the ordered count); since K3 is a kernel under test, the first call
    on each state (grid and cap) also counts them with the plain version
    and fails if the two differ.  `nbytes` replaces the byte count where the inputs are not
    the dense planes (K10's packed pencils and tables)."""
    from ls1_mardyn_tpu_torch.ops.cuda_lj import inside_pairs

    nx, ny, nz = dims
    occ = (r_i[:, :, 3] > 0.5).reshape(nz, ny, nx, cap).sum(-1).double()
    nb = sum(torch.roll(occ, (dz, dy, dx), (0, 1, 2))
             for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    # ordered slot pairs incl. each slot with itself -> unordered, no self
    candidates = (float((occ * nb).sum()) - float(occ.sum())) / 2.0
    kw = dict(dims=dims, cap=cap, cell_len=lj["cell_len"], rc2=lj["rc2"])
    key = (tuple(dims), cap)
    if key not in _BOUND_CHECKED:
        ordered = check_counts(f"the bound's count on {dims}", r_i,
                               kernel="K3", **kw)
        _BOUND_CHECKED[key] = ordered
        say("times", bound_count_checked=True, grid=dims, cap=cap,
            inside_ordered_K3_and_plain=ordered)
    else:
        ordered = inside_pairs(r_i, **kw)
    inside = ordered / 2.0
    if nbytes is None:
        nbytes = needed_bytes(r_i) + (0 if r_j is None else needed_bytes(r_j)) \
            + out_planes * r_i.numel() // 4 * r_i.element_size()
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (8 * candidates + 25 * inside) / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "candidates": candidates, "inside": inside}


def lj_times(key, fn, ref, args, kw, rel_lim=1e-5):
    """An LJ kernel fn and its plain version ref on (args, kw), without
    and with u6/virial (CUDA events; 10 launches of the kernel, one of
    the plain version): ({macro: (kernel ms, plain ms)}, max|dF|, the
    largest relative error), held to rel_lim."""
    res = {}
    for macro in (False, True):
        res[macro] = (
            cuda_ms(lambda: fn(*args, compute_macro=macro, **kw), 10),
            cuda_ms(lambda: ref(*args, compute_macro=macro, **kw), 1))
    a, b = fn(*args, **kw), ref(*args, **kw)
    err = float((a[0] - b[0]).abs().max())
    rel = max(rel_errors(a, b))
    check(rel <= rel_lim, f"{key} at its path's shape: rel err {rel}")
    return res, err, rel


def phase_times(sim_rmm, sim_gen, smi):
    """Each kernel beside its plain version at the shape its path gave
    it, with the kernel's bound; no single PyTorch call computes an LJ
    cell-force sum or the shift-merge rebin, so library_ms is null.
    (The paths' launch counts were read before this phase.)"""
    from ls1_mardyn_tpu_torch.ops import cuda_lj, cuda_rebin

    out = {}

    # K1: the RMM state's planes, read in place
    rsim = sim_rmm.engine.sim
    st = rsim.state
    r4 = st.planes[:, :, :4, :]
    dims, cap = rsim.spec.dims, rsim.spec.cap
    lj = dict(eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    res, err, rel = lj_times("K1", cuda_lj.lj_cell_forces,
                             cuda_lj.lj_cell_forces_reference, (r4,),
                             dict(dims=dims, cap=cap, cell_len=rsim.cell_len, **lj))
    bound = lj_bound(r4.contiguous(), dims, cap,
                     dict(cell_len=rsim.cell_len, rc2=rsim.rc2), 3)
    pairs = 27 * cap ** 2 * rsim.spec.n_cells
    say("times", kernel="K1", grid=dims, cap=cap, pair_lanes=pairs,
        ms_fast=f"{res[False][0]:.3f}", plain_ms_fast=f"{res[False][1]:.3f}",
        ms_macro=f"{res[True][0]:.3f}", plain_ms_macro=f"{res[True][1]:.3f}",
        pair_lanes_per_s=f"{pairs / res[False][0] * 1e3:.4e}",
        max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        bound=json.dumps(bound), gpu=repr(smi),
        walk=json.dumps(lj_warp_walk(r4, dims, cap, rsim.cell_len, rsim.rc2,
                                     half=True)),
        walk_full_shell=json.dumps(lj_warp_walk(r4, dims, cap, rsim.cell_len,
                                                rsim.rc2)),
        ptxas=json.dumps(ptxas_report("lj_cells")))
    out["K1"] = dict(max_abs_err=err, ms=res[False][0], plain_ms=res[False][1],
                     bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    argon_times(smi)

    # K2: one read and one write of the 11-column stack is what the
    # function must move; its passes move about that: the hop pass reads
    # the valid and coordinate columns and writes a byte a slot, the
    # gather pass reads the codes (once from memory) and the occupied
    # slots' 11 columns and writes every slot
    big = rsim._fold(st)
    kw2 = dict(dims=dims, cap=cap, cell_len=rsim.cell_len, sentinel=rsim.sentinel)
    k2_ms = cuda_ms(lambda: cuda_rebin.rebin_shift(big, **kw2), 10)
    p2_ms = cuda_ms(lambda: cuda_rebin.rebin_shift_reference(big, **kw2), 2)
    oa, _ = cuda_rebin.rebin_shift(big, **kw2)
    ob, _ = cuda_rebin.rebin_shift_reference(big, **kw2)
    k2_err = float((oa - ob).abs().max())
    check(k2_err == 0.0, "K2 at the main-path shape is not bit-identical")
    size = big.element_size()
    nbytes = 2 * big.numel() * size
    slots = big.numel() // cuda_rebin.NCOLS
    occupied = int((big[:, :, 3] > 0.5).sum())
    hop_bytes = 4 * slots * size + slots
    gather_bytes = slots + cuda_rebin.NCOLS * (occupied + slots) * size
    say("times", kernel="K2", ms=f"{k2_ms:.3f}", plain_ms=f"{p2_ms:.3f}",
        bytes_in_and_out=nbytes, bytes_of_passes=hop_bytes + gather_bytes,
        hop_pass_bytes=hop_bytes, gather_pass_bytes=gather_bytes,
        GBps_of_passes=f"{(hop_bytes + gather_bytes) / k2_ms / 1e6:.1f}",
        GBps_in_and_out=f"{nbytes / k2_ms / 1e6:.1f}",
        bound_ms=f"{nbytes / PEAK_BYTES * 1e3:.4f}", max_abs_err=k2_err,
        gpu=repr(smi))
    out["K2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=p2_ms,
                     bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")

    # K3, K4: the layout the general path gathers from its state; the
    # path computes u6/virial every step, so `ms` is the macro time
    eng = sim_gen.engine
    path = eng._force_fn
    r_i, _ = path.layout(eng.mol)
    r_j = path.x_halo(r_i)
    dims, cap = path.spec.dims, path.spec.cap
    lj = dict(eps24=path.eps24, sig2=path.sig2, shift6=path.shift6, rc2=path.rc2)
    pairs = 27 * cap ** 2 * path.spec.n_cells
    for key, fn, ref, args, kw, jpl in (
        ("K3", cuda_lj.lj_cell_forces_cw, cuda_lj.lj_cell_forces_cw_reference,
         (r_i,), dict(dims=dims, cap=cap, cell_len=path.spec.cell_len, **lj), None),
        ("K4", cuda_lj.lj_cell_forces_row, cuda_lj.lj_cell_forces_row_reference,
         (r_i, r_j), dict(dims=dims, cap=cap, box=path.spec.box,
                          local_coords=True, **lj), r_j),
    ):
        res, err, rel = lj_times(key, fn, ref, args, kw)
        bound = lj_bound(r_i, dims, cap,
                         dict(cell_len=path.spec.cell_len, rc2=path.rc2), 3, jpl)
        extra = {}
        if key == "K3":
            extra["ms_macro_vi"] = "%.3f" % cuda_ms(
                lambda: fn(*args, compute_vi=True, **kw), 10)
            extra["walk"] = json.dumps(lj_warp_walk(
                r_i, dims, cap, path.spec.cell_len, path.rc2))
        else:
            extra["walk"] = json.dumps(lj_warp_walk(
                r_i, dims, cap, path.spec.cell_len, path.rc2,
                j_cells=cuda_lj._row_j_cells(r_j, dims=dims, cap=cap,
                                             box=path.spec.box,
                                             local_coords=True)))
        extra["ptxas"] = json.dumps(ptxas_report(
            "lj_cells_cw" if key == "K3" else "lj_cells_row"))
        say("times", kernel=key, grid=dims, cap=cap, pair_lanes=pairs,
            ms_fast=f"{res[False][0]:.3f}", plain_ms_fast=f"{res[False][1]:.3f}",
            ms_macro=f"{res[True][0]:.3f}", plain_ms_macro=f"{res[True][1]:.3f}",
            pair_lanes_per_s=f"{pairs / res[False][0] * 1e3:.4e}",
            max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
            bound=json.dumps(bound), gpu=repr(smi), **extra)
        out[key] = dict(max_abs_err=err, ms=res[True][0], plain_ms=res[True][1],
                        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    # K3 and K4 on K1's grid: held against their plain versions there
    # too, then timed for the comparison with K1
    dims1, cap1 = rsim.spec.dims, rsim.spec.cap
    r1 = r4.contiguous()
    kw1 = dict(dims=dims1, cap=cap1, eps24=rsim.eps24, sig2=rsim.sig2,
               shift6=rsim.shift6, rc2=rsim.rc2)
    nx1 = dims1[0]
    rj1 = torch.cat([r1[..., (nx1 - 1) * cap1:], r1, r1[..., :cap1]], -1)
    rel3 = max(rel_errors(
        cuda_lj.lj_cell_forces_cw(r1, cell_len=rsim.cell_len, **kw1),
        cuda_lj.lj_cell_forces_cw_reference(r1, cell_len=rsim.cell_len, **kw1)))
    kw4 = dict(box=rsim.spec.box, local_coords=True, **kw1)
    rel4 = max(rel_errors(cuda_lj.lj_cell_forces_row(r1, rj1, **kw4),
                          cuda_lj.lj_cell_forces_row_reference(r1, rj1, **kw4)))
    check(rel3 <= 1e-5 and rel4 <= 1e-5,
          f"K3/K4 on grid {dims1}: rel err {rel3}, {rel4}")
    kw1["compute_macro"] = False
    say("times", on_grid=dims1, cap=cap1, K3_rel_err=f"{rel3:.3e}",
        K4_rel_err=f"{rel4:.3e}", limit=1e-5,
        K1_ms=f"{out['K1']['ms']:.3f}",
        K3_ms="%.3f" % cuda_ms(lambda: cuda_lj.lj_cell_forces_cw(
            r1, cell_len=rsim.cell_len, **kw1), 10),
        K3_ms_macro="%.3f" % cuda_ms(lambda: cuda_lj.lj_cell_forces_cw(
            r1, cell_len=rsim.cell_len, **dict(kw1, compute_macro=True)), 10),
        K4_ms="%.3f" % cuda_ms(lambda: cuda_lj.lj_cell_forces_row(
            r1, rj1, box=rsim.spec.box, local_coords=True, **kw1), 10))
    out.update(variant_times(rsim, r4, smi))
    return out


def packed_warp_walk(pos4, tab, meta, nx, box, rc2):
    """What K10's warps (csrc/lj_packed.cu) walk on this state, counted
    here with torch from the same data: per group of 32 packed i (its
    live lanes), the j lanes of its exact ranges in the 5 forward pencils
    and the wrap passes staged (own-pencil lanes above the group's first),
    those kept by the box cull against the live i's bounding box with
    the pencil's y/z shift on the i side (boxdist2 < rc^2, rounded as the
    kernel rounds it), and the j iterations walked: 32 steps for each
    full round of 32 kept entries and one for each entry of the last.
    Returns the totals and the means per group."""
    from ls1_mardyn_tpu_torch.ops.cuda_packed import (
        GSZ, M_CNT, M_EHI, M_ELO, M_NG, PCX, POFFS, PX, PY, PZ, T_CB)

    nz, ny, _, Wp = pos4.shape
    dtype, dev = pos4.dtype, pos4.device
    clx, cly, clz = (float(b) / n for b, n in zip(box, (nx, ny, nz)))
    G = Wp // GSZ
    cnt = meta[:, :, 0, M_CNT].long()
    t = torch.arange(G, device=dev)
    gvalid = t < meta[:, :, 0, M_NG, None].long()
    wlo = t < meta[:, :, 0, M_ELO, None].long()
    whi = t >= (meta[:, :, 0, M_NG] - meta[:, :, 0, M_EHI])[..., None].long()
    q = torch.arange(Wp, device=dev)
    live = (q < cnt[..., None]).reshape(nz, ny, G, GSZ)
    cxl = torch.where(q < cnt[..., None], pos4[:, :, PCX].long(), nx)
    starts = torch.searchsorted(
        cxl.reshape(-1, Wp).contiguous(),
        torch.arange(nx + 1, device=dev).expand(nz * ny, -1).contiguous(),
    ).reshape(nz, ny, nx + 1)
    cb = tab[:, :, :, T_CB].long()
    cbl = cb.repeat_interleave(GSZ, dim=2).to(dtype)
    xi = (pos4[:, :, PX] + (pos4[:, :, PCX] - cbl) * clx).reshape(nz, ny, G, GSZ)
    yi = pos4[:, :, PY].reshape(nz, ny, G, GSZ)
    zi = pos4[:, :, PZ].reshape(nz, ny, G, GSZ)
    big = torch.finfo(dtype).max

    def box_of(a):
        return (torch.where(live, a, big).amin(-1)[..., None],
                torch.where(live, a, -big).amax(-1)[..., None])

    (lox, hix), (loy, hiy), (loz, hiz) = box_of(xi), box_of(yi), box_of(zi)
    first = t * GSZ
    n_i = torch.clamp(cnt[..., None] - first, 0, GSZ)
    cf = torch.gather(cxl, 2, first.expand(nz, ny, -1))
    cl = torch.gather(cxl, 2, torch.clamp(first + n_i - 1, min=0))
    staged = torch.zeros((nz, ny, G), dtype=torch.long, device=dev)
    kept = torch.zeros_like(staged)

    def gap(x, lo, hi):
        a, b = lo - x, x - hi
        return torch.where(a > 0, a, torch.where(b > 0, b, torch.zeros_like(x)))

    for pas, gm, cbj, ca, ce in (
            (0, gvalid, cb, torch.clamp(cf - 1, min=0), torch.clamp(cl + 1, max=nx - 1)),
            (1, gvalid & wlo, cb + nx, torch.full_like(cf, nx - 1),
             torch.full_like(cf, nx - 1)),
            (2, gvalid & whi, cb - nx, torch.zeros_like(cf), cl + 1 - nx)):
        for k, (dz, dy) in enumerate(POFFS):
            sk = torch.roll(starts, (-dz, -dy), (0, 1))
            pk = torch.roll(pos4, (-dz, -dy), (0, 1))
            j0 = torch.gather(sk, 2, torch.clamp(ca, 0, nx))
            j1 = torch.gather(sk, 2, torch.clamp(ce + 1, 0, nx))
            if k == 0:
                j0 = torch.maximum(j0, first + 1)
            n = torch.where(gm, torch.clamp(j1 - j0, min=0), 0)
            L = int(n.max()) if n.numel() else 0
            if L == 0:
                continue
            lanes = j0[..., None] + torch.arange(L, device=dev)
            inr = torch.arange(L, device=dev) < n[..., None]
            lanes = torch.clamp(lanes, 0, Wp - 1).reshape(nz, ny, -1)

            def jcol(c):
                return torch.gather(pk[:, :, c], 2, lanes).reshape(nz, ny, G, L)

            xj = jcol(PX) + (jcol(PCX) - cbj[..., None].to(dtype)) * clx
            sy = torch.tensor(dy * cly, dtype=dtype, device=dev)
            sz = torch.tensor(dz * clz, dtype=dtype, device=dev)
            gx = gap(xj, lox, hix)
            gy = gap(jcol(PY), loy - sy, hiy - sy)
            gz = gap(jcol(PZ), loz - sz, hiz - sz)
            bd2 = gx * gx + gy * gy + gz * gz
            staged += inr.sum(-1)
            kept += (inr & (bd2 < rc2)).sum(-1)
    ng = int(gvalid.sum())
    return {"groups": ng, "live_i_per_group": round(float(n_i.sum()) / ng, 2),
            "j_staged": int(staged.sum()), "j_kept": int(kept.sum()),
            "culled_share": round(1.0 - float(kept.sum()) / float(staged.sum()), 4),
            "j_staged_per_group": round(float(staged.sum()) / ng, 1),
            "j_kept_per_group": round(float(kept.sum()) / ng, 1),
            "j_iterations": int(kept.sum()),
            "full_rounds_share": round(float((kept // 32 * 32).sum())
                                       / float(kept.sum()), 4)}


def argon_rmm(seed=0):
    """The RMM engine of the benchmark cell lj_liquid_4m.rmm at its start,
    built by the benchmark's own scene and program code: ls1-MarDyn's
    argon example (200 K, 18 mol/l, rc 5.154 sigma), N = 4,194,304, f32,
    on the engine's own grid ((36,36,36) cap 128, about 90 molecules a
    cell, so a block of K1 is one cell).  Returns (MDSimulation,
    RMMSimulation)."""
    from benchmark import harness, program, scene

    _, _, cfg, traffic, cell = harness.find_cell("lj_liquid_4m.rmm")
    md = program.build(cfg, traffic, cell, scene.start_state(cfg, seed), "cuda")
    md.engine.prepare_start()
    return md, md.engine.sim


def argon_general(seed=0):
    """The general engine of the benchmark cell lj_liquid_4m.general at its
    start, built by the benchmark's own scene and program code: the argon
    state of argon_rmm on the general path's own grid ((41,41,41) cap
    128, about 61 molecules a cell).  Returns (MDSimulation, CudaLJPath,
    r_i: the path's layout of the start, K3's input)."""
    from benchmark import harness, program, scene

    _, _, cfg, traffic, cell = harness.find_cell("lj_liquid_4m.general")
    md = program.build(cfg, traffic, cell, scene.start_state(cfg, seed), "cuda")
    path = md.engine._force_fn
    r_i, _ = path.layout(md.engine.mol)
    return md, path, r_i


def argon_times(smi):
    """K1 (the half shell) beside its plain version on the argon state
    of the benchmark (argon_rmm): times without and with u6/virial, the
    bound, and what its warps walk by the half shell and, for the
    comparison, by the full one.  Then K3 on the general cell's own grid
    of the same state (argon_general, the half shell): held to its plain
    version with and without u6/virial, its in-cutoff count checked,
    timed."""
    from ls1_mardyn_tpu_torch.ops import cuda_lj

    md, rsim = argon_rmm()
    r4 = rsim.state.planes[:, :, :4, :]
    dims, cap = rsim.spec.dims, rsim.spec.cap
    kw = dict(dims=dims, cap=cap, cell_len=rsim.cell_len, eps24=rsim.eps24,
              sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    bound = lj_bound(r4.contiguous(), dims, cap,
                     dict(cell_len=rsim.cell_len, rc2=rsim.rc2), 3)
    walk = dict(half=json.dumps(lj_warp_walk(r4, dims, cap, rsim.cell_len,
                                             rsim.rc2, half=True)),
                full=json.dumps(lj_warp_walk(r4, dims, cap, rsim.cell_len,
                                             rsim.rc2)))
    res, err, rel = lj_times("K1 argon", cuda_lj.lj_cell_forces,
                             cuda_lj.lj_cell_forces_reference, (r4,), kw)
    say("times", kernel="K1", state="argon", grid=dims, cap=cap,
        n=int((r4[:, :, 3] > 0.5).sum()),
        ms_fast=f"{res[False][0]:.3f}", plain_ms_fast=f"{res[False][1]:.3f}",
        ms_macro=f"{res[True][0]:.3f}", plain_ms_macro=f"{res[True][1]:.3f}",
        max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        bound=json.dumps(bound), walk_half_shell=walk["half"],
        walk_full_shell=walk["full"], ptxas=json.dumps(ptxas_report("lj_cells")),
        gpu=repr(smi))
    del md, rsim

    md, path, r_i = argon_general()
    dims, cap = path.spec.dims, path.spec.cap
    kw = dict(dims=dims, cap=cap, cell_len=path.spec.cell_len, eps24=path.eps24,
              sig2=path.sig2, shift6=path.shift6, rc2=path.rc2)
    check(cuda_lj.cw_half_shell(None, dims), f"K3 argon: {dims} not on the half shell")
    res, err, rel = lj_times("K3 argon", cuda_lj.lj_cell_forces_cw,
                             cuda_lj.lj_cell_forces_cw_reference, (r_i,), kw)
    a = cuda_lj.lj_cell_forces_cw(r_i, **dict(kw, compute_macro=False))[0]
    b = cuda_lj.lj_cell_forces_cw_reference(r_i, **dict(kw, compute_macro=False))[0]
    rel_fast = float((a - b).abs().max() / b.abs().max())
    check(rel_fast <= 1e-5, f"K3 argon without u6/virial: rel err {rel_fast}")
    inside = check_counts(f"K3 argon on {dims}", r_i, kernel="K3", dims=dims,
                          cap=cap, cell_len=path.spec.cell_len, rc2=path.rc2)
    say("times", kernel="K3", state="argon", grid=dims, cap=cap,
        n=int((r_i[:, :, 3] > 0.5).sum()), half_shell=True,
        ms_fast=f"{res[False][0]:.3f}", plain_ms_fast=f"{res[False][1]:.3f}",
        ms_macro=f"{res[True][0]:.3f}", plain_ms_macro=f"{res[True][1]:.3f}",
        max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        rel_err_fast=f"{rel_fast:.3e}", inside_ordered_K3_and_plain=inside,
        walk_half_shell=json.dumps(lj_warp_walk(r_i, dims, cap, path.spec.cell_len,
                                                path.rc2, half=True)),
        gpu=repr(smi))
    del md, path, r_i


def variant_times(rsim, r4, smi):
    """K7-K10 beside their plain versions on the RMM state K1 was timed
    on (K1's grid; K7 with a copied i view and its x halo, K10 on the
    state packed into pencils).  They compute K1's physics, so K1's
    bound; `ms` without u6/virial, as the RMM path runs most steps.  K7,
    K8 and K9 also report what their warps walk (lj_warp_walk; K8 by the
    full and the half shell) and their ptxas report."""
    import functools

    from ls1_mardyn_tpu_torch.ops import cuda_lj, cuda_lj_variants as V
    from ls1_mardyn_tpu_torch.ops import cuda_packed as PK

    out = {}
    dims, cap = rsim.spec.dims, rsim.spec.cap
    nx, ny, nz = dims
    lj = dict(eps24=rsim.eps24, sig2=rsim.sig2, shift6=rsim.shift6, rc2=rsim.rc2)
    local = dict(dims=dims, cap=cap, cell_len=rsim.cell_len, **lj)
    r_i = r4.contiguous()
    r_j = torch.cat([r_i[..., (nx - 1) * cap:], r_i, r_i[..., :cap]], -1)
    packed, _, _, tab, meta, feas, Wp = packed_views(rsim.state.planes, dims, cap)
    pos4 = packed[:, :, :4].contiguous()
    size = r4.element_size()
    p_bytes = (pos4.numel() + 3 * pos4.numel() // 4) * size \
        + (tab.numel() + meta.numel()) * 4
    row_ref = functools.partial(cuda_lj.lj_cell_forces_row_reference,
                                local_coords=True)
    k1_ms = cuda_ms(lambda: cuda_lj.lj_cell_forces(
        r4, **dict(local, compute_macro=False)), 10)
    cases = (
        ("K7", V.lj_cell_forces_lanej, row_ref, (r_i, r_j),
         dict(dims=dims, cap=cap, box=rsim.spec.box, **lj),
         dict(r_j=r_j), {}),
        ("K8", V.lj_cell_forces_n3l, V.lj_cell_forces_n3l_reference, (r4,), local,
         {}, {}),
        ("K9", V.lj_cell_forces_zb, V.lj_cell_forces_zb_reference, (r4,), local, {},
         {"gram": (functools.partial(V.lj_cell_forces_zb, gram=True),
                   functools.partial(V.lj_cell_forces_zb_reference, gram=True))}),
        ("K10", PK.lj_forces_packed, PK.lj_forces_packed_reference,
         (pos4, tab, meta), dict(nx=nx, ny=ny, nz=nz, Wp=Wp, box=rsim.spec.box, **lj),
         dict(nbytes=p_bytes), {}),
    )
    for key, fn, ref, args, kw, bkw, extra in cases:
        res, err, rel = lj_times(key, fn, ref, args, kw)
        bound = lj_bound(r_i, dims, cap, dict(cell_len=rsim.cell_len, rc2=rsim.rc2),
                         3, **bkw)
        more = {}
        for mode, (f, g) in extra.items():
            more["ms_" + mode] = "%.3f" % cuda_ms(
                lambda: f(*args, compute_macro=False, **kw), 10)
            e = max(rel_errors(f(*args, **kw), g(*args, **kw)))
            check(e <= 1e-5, f"{key} {mode} at its path's shape: rel err {e}")
            more["rel_err_" + mode] = "%.3e" % e
        if key == "K7":
            more.update(walk=json.dumps(lj_warp_walk(
                r_i, dims, cap, rsim.cell_len, rsim.rc2,
                j_cells=cuda_lj._row_j_cells(r_j, dims=dims, cap=cap,
                                             box=rsim.spec.box,
                                             local_coords=True))),
                ptxas=json.dumps(ptxas_report("lj_cells_lanej")))
        if key == "K8":
            k8_half = lj_warp_walk(r4, dims, cap, rsim.cell_len, rsim.rc2, half=True)
            more.update(walk=json.dumps(lj_warp_walk(
                r4, dims, cap, rsim.cell_len, rsim.rc2)),
                walk_half=json.dumps(k8_half),
                ptxas=json.dumps(ptxas_report("lj_cells")))
        if key == "K9":
            more.update(walk=json.dumps(lj_warp_walk(
                r4, dims, cap, rsim.cell_len, rsim.rc2)),
                walk_gram=json.dumps(lj_warp_walk(
                    r4, dims, cap, rsim.cell_len, rsim.rc2, gram=True)),
                ptxas=json.dumps(ptxas_report("lj_cells_zb")))
        if key == "K10":
            more.update(Wp=Wp, feasible=feas, walk=json.dumps(packed_warp_walk(
                pos4, tab, meta, nx, rsim.spec.box, rsim.rc2)),
                K8_j_iterations=k8_half["j_iterations"],
                ptxas=json.dumps(ptxas_report("lj_packed")))
        say("times", kernel=key, grid=dims, cap=cap, ms_fast=f"{res[False][0]:.3f}",
            plain_ms_fast=f"{res[False][1]:.3f}", ms_macro=f"{res[True][0]:.3f}",
            plain_ms_macro=f"{res[True][1]:.3f}", K1_ms=f"{k1_ms:.3f}",
            max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", bound=json.dumps(bound),
            gpu=repr(smi), **more)
        out[key] = dict(max_abs_err=err, ms=res[False][0], plain_ms=res[False][1],
                        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    return out


# the long-range scenes: the water class of tools/bench_ms.py (one LJ
# centre at the COM and three charges of SPC/E geometry at sigma = 1,
# rho 0.8, rc 3.0, Ewald accuracy 1e-4) and the molten salt of
# tests/test_ewald_driver.py (6^3 ions of charge +-1 with a small LJ core)
N_LR, RHO_LR, RC_LR, ACC_LR = 1_000_000, 0.8, 3.0, 1e-4
# what EwaldParams.tune gives there (alpha 0.987, kmax 64: N_sites * K =
# 3.3e12), so that "auto" picks SPME on this mesh at order 6
LR_GRID, LR_ORDER = (256, 256, 256), 6
WATER_SITES = ((0.0, 0.0, 0.0, -0.8476), (0.316, 0.245, 0.0, 0.4238),
               (-0.316, 0.245, 0.0, 0.4238))
# water sizes of the direct-against-SPME crossover (N_sites * K from
# 1e6 to 2.8e9 at the tuned kmax)
CROSSOVER_N = (250, 500, 1000, 2000, 3000, 4096, 5000, 8000, 16000)


def water_component():
    from ls1_mardyn_tpu_torch.models.components import Component

    c = Component(cid=0)
    c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
    for x, y, z, q in WATER_SITES:
        c.add_charge(x, y, z, 0.0 if q < 0 else 0.01, q)
    return c


def water_scene(n, method="auto", seed=11):
    """(config, data, L): n water-class molecules on cubic_grid's lattice
    with random orientations, electrostatic_solver Ewald."""
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    L = (n / RHO_LR) ** (1 / 3)
    data = cubic_grid(n, [L] * 3, TEMP, components=[water_component()],
                      seed=seed)
    q = np.random.default_rng(5).normal(size=(n, 4))
    data.q = q / np.linalg.norm(q, axis=1, keepdims=True)
    cfg = scene_config(data.box, RC_LR)
    cfg.electrostatic_solver, cfg.ewald_accuracy = "Ewald", ACC_LR
    cfg.ewald_method = method
    return cfg, data, L


def salt_scene(method, n_side=6, d=1.1):
    """(config, data, L): the molten salt, jittered by up to 0.05 and at
    T ~ 1 (a perfect lattice at rest has zero forces), rc 2.5, accuracy
    1e-5, dt 0.001."""
    from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
    from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
    from ls1_mardyn_tpu_torch.models.components import Component

    comps = []
    for sign in (1.0, -1.0):
        c = Component(cid=len(comps))
        c.add_ljcenter(0, 0, 0, 1.0, 0.2, 1.0)
        c.add_charge(0, 0, 0, 0.0, sign)
        comps.append(c)
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3)
    rng = np.random.default_rng(17)
    r = (g + 0.5) * d + rng.uniform(-0.05, 0.05, g.shape)
    L = n_side * d
    ones = np.ones((2, 2))
    cfg = XMLConfig(timestep=0.001, temperature=1.0, box=np.full(3, L),
                    cutoff=2.5, lj_cutoff=2.5, components=comps, mixing_xi=ones,
                    mixing_eta=ones, electrostatic_solver="Ewald",
                    ewald_accuracy=1e-5, ewald_method=method)
    data = PhaseSpaceData(
        components=comps, mixing_xi=ones, mixing_eta=ones, eps_rf=1.0,
        box=np.full(3, L), temperature=1.0, current_time=0.0,
        mid=np.arange(1, len(r) + 1, dtype=np.int64),
        cid=np.where(g.sum(1) % 2 == 0, 0, 1).astype(np.int32), r=r,
        v=rng.normal(0.0, 1.0, r.shape), q=np.tile([1.0, 0, 0, 0], (len(r), 1)),
        L=np.zeros_like(r))
    return cfg, data, L


def planar_slab_scene(seed=11):
    """A 1CLJ liquid slab in vapour across y, the axis of the planar
    correction: a jittered 17^3 lattice (spacing 1.1, rho ~0.75) 5 sigma
    up y in a (18.7, 60, 18.7) box."""
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    k, a = 17, 1.1
    box = np.array([k * a, 60.0, k * a])
    g = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(float)
    data = cubic_grid(len(g), box, TEMP, seed=seed)
    rng = np.random.default_rng(seed)
    data.r = (g + 0.5 + rng.uniform(-0.1, 0.1, g.shape)) * a
    data.r[:, 1] += 5.0
    return data, box


class _AlphaSpy:
    """Records the screen_alpha of every K5 launch (wraps
    cuda_ms_packed.launch_packed, which the K5 wrapper calls once per
    counted launch); the counts stay the wrapper's."""

    def __enter__(self):
        from ls1_mardyn_tpu_torch.ops import cuda_ms_packed as cmp

        self.mod, self.orig, self.seen = cmp, cmp.launch_packed, []

        def spy(*a, **kw):
            self.seen.append(float(kw["screen_alpha"]))
            return self.orig(*a, **kw)

        cmp.launch_packed = spy
        return self

    def __exit__(self, *exc):
        self.mod.launch_packed = self.orig


def phase_longrange_small(device):
    """Long-range scenes on the card against the same driver on the CPU
    (plain versions), f64, 20 steps: the molten salt under ewald_method
    direct, pme and fmm (the N^2 oracle, erfc-screened for direct and
    pme, LJ only for fmm); water-class N = 4096 under force_mode
    "ms_packed" with SPME (K5 with screen_alpha = SPME's alpha); a 1CLJ
    slab with longrange="planar" (K3 on the general engine).  T, p, Upot
    rtol 1e-9; r, v (and q, L of the water) 1e-9: the atomic spread moves
    the last bits between runs, so nothing is compared bit for bit."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
        CudaMultiSitePackedPath, multisite_cell_forces_packed)
    from ls1_mardyn_tpu_torch.ops.ewald import EwaldSolver
    from ls1_mardyn_tpu_torch.ops.fmm import FMMElectrostatics
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
    from ls1_mardyn_tpu_torch.ops.pme import PMESolver
    from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation

    solvers = {"direct": EwaldSolver, "pme": PMESolver, "fmm": FMMElectrostatics}
    for method, solver in solvers.items():
        def build(dev, method=method):
            cfg, data, L = salt_scene(method)
            return MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                                device=dev), L

        sim, _ = build("cpu")
        check(isinstance(sim.engine, SingleChipSimulation)
              and type(sim.ewald) is solver
              and not hasattr(sim.engine._force_fn, "spec")
              and (sim._screen_alpha > 0) == (method != "fmm"),
              f"longrange-small/salt-{method}: engine {type(sim.engine).__name__}, "
              f"solver {type(sim.ewald).__name__}, alpha {sim._screen_alpha}")
        compare_devices(f"longrange-small/salt-{method}", build, device, ("r", "v"))

    def water(dev):
        cfg, data, L = water_scene(4096, method="pme")
        # an explicit capacity: the measured one (128) would hand the
        # scene to the N^2 sweep
        return MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                            device=dev, force_mode="ms_packed", cell_cap=64), L

    sim, _ = water("cpu")
    alpha = sim.ewald.params.alpha
    check(isinstance(sim.engine._force_fn, CudaMultiSitePackedPath)
          and isinstance(sim.ewald, PMESolver)
          and sim.engine._force_fn.screen_alpha == alpha > 0,
          "longrange-small/water: not K5 with SPME's screening")
    multisite_cell_forces_packed.launches = 0
    multisite_cell_forces_packed.half_launches = 0
    with _AlphaSpy() as spy:
        compare_devices("longrange-small/water-ms_packed", water, device,
                        ("r", "v", "q", "L"))
    k5 = multisite_cell_forces_packed.launches
    half = multisite_cell_forces_packed.half_launches
    check(k5 == 21 and spy.seen == [alpha] * k5 and half == k5,
          f"longrange-small/water: K5 launches {k5} ({half} on the half "
          f"shell), screen_alpha {set(spy.seen)}")
    say("longrange-small/water-ms_packed", K5_launches=k5,
        K5_half_launches=half, screen_alpha=alpha)

    def slab(dev):
        data, box = planar_slab_scene()
        cfg = scene_config(box)
        cfg.longrange = "planar"
        return MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                            device=dev, cell_cap=32), box

    sim, _ = slab("cpu")
    path = sim.engine._force_fn
    check(isinstance(sim.engine, SingleChipSimulation) and sim.planar_lrc
          and isinstance(path, CudaLJPath) and path.cw and not sim._z_edges,
          f"longrange-small/planar: engine {type(sim.engine).__name__}, "
          f"path {type(path).__name__}")
    lj_cell_forces_cw.launches = 0
    compare_devices("longrange-small/planar-slab", slab, device, ("r", "v"))
    k3 = lj_cell_forces_cw.launches
    check(k3 == 21, f"longrange-small/planar: K3 launches {k3}")
    say("longrange-small/planar-slab", engine="SingleChipSimulation", kernel="K3",
        K3_launches=k3)


def longrange_parts(sim, reps=3):
    """Device ms (CUDA events) of each part of an SPME + K5 step, each
    alone on the current state: the K5 path's build, K5, its gather back;
    the charge sites, B-spline columns, spread, the two FFTs (with the
    influence function between them), the force gather, the self and
    intramolecular corrections; the two half-kicks."""
    from ls1_mardyn_tpu_torch.ops import pme
    from ls1_mardyn_tpu_torch.ops.ewald import charge_sites, self_intra_corrections
    from ls1_mardyn_tpu_torch.ops.integrator import upd_post_force, upd_pre_force

    eng, solver = sim.engine, sim.ewald
    path, mol, pp, forces = eng._force_fn, eng.mol, eng.pp, eng.forces
    p, grid = solver.params.order, solver.params.grid
    tbl, r_i, r_j, bins, prefix = path._build_views(mol)
    res = path.kernel_packed(tbl, r_i, r_j)
    offs, rs, wq = charge_sites(mol, pp)
    rsf, wqf = rs.reshape(-1, 3), wq.reshape(-1)
    giw = pme._grid_indices_weights(rsf, solver.box, grid, p, with_derivs=True)
    Q = pme.spread_charges(giw["bw"], giw["w3"], wqf, grid, p)
    conv = solver.kern * torch.fft.fftn(Q)
    phi = torch.fft.ifftn(conv).real * float(np.prod(grid))
    parts = {
        "build": lambda: path._build_views(mol),
        "K5": lambda: path.kernel_packed(tbl, r_i, r_j),
        "gather_back": lambda: path.unpack(res, mol, bins, prefix),
        "sites": lambda: charge_sites(mol, pp),
        "splines": lambda: pme._grid_indices_weights(rsf, solver.box, grid, p,
                                                     with_derivs=True),
        "spread": lambda: pme.spread_charges(giw["bw"], giw["w3"], wqf, grid, p),
        "fft": lambda: torch.fft.fftn(Q),
        "ifft": lambda: torch.fft.ifftn(conv),
        "force_gather": lambda: pme.gather_forces(
            giw["bw"], giw["w3"], giw["dw3"], giw["scale"], wqf, phi, grid, p),
        "self_intra": lambda: self_intra_corrections(mol, solver.params.alpha,
                                                     rs, wq),
        "solver_total": lambda: solver(mol, pp),
        "half_kick_1": lambda: upd_pre_force(mol, forces, pp, DT),
        "half_kick_2": lambda: upd_post_force(mol, forces, pp, DT),
    }
    return {k: round(cuda_ms(fn, reps), 3) for k, fn in parts.items()}


def phase_longrange(device, smi):
    """This slice's path at full width: water-class N = 1,000,000, f32,
    force_mode "auto" through MDSimulation, which must pick SPME (256^3
    mesh, order 6) and K5 with SPME's screen_alpha; a warm-up of 2 steps
    and a window of 8; each part of a step timed alone; then K5 held
    against its plain version at this path's shapes, with its bound.
    Returns K5's launches in that run, its times there and its launches
    on the half shell."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
        CudaMultiSitePackedPath, multisite_cell_forces_packed)
    from ls1_mardyn_tpu_torch.ops.pme import PMESolver

    cfg, data, _ = water_scene(N_LR)
    n = len(data.mid)
    check(n == N_LR, "longrange: N")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim = MDSimulation(cfg, phase_space_data=data, device=device, force_mode="auto")
    t_build = time.perf_counter() - t0
    eng, solver = sim.engine, sim.ewald
    path = eng._force_fn
    check(isinstance(solver, PMESolver) and solver.params.grid == LR_GRID
          and solver.params.order == LR_ORDER,
          f"longrange: solver {type(solver).__name__} "
          f"{getattr(solver, 'params', None)}")
    alpha = solver.params.alpha
    check(isinstance(path, CudaMultiSitePackedPath) and path.screen_alpha == alpha > 0,
          f"longrange: force path {type(path).__name__}")
    q0 = sim.molecules().q.clone()
    multisite_cell_forces_packed.launches = 0
    multisite_cell_forces_packed.half_launches = 0
    with _AlphaSpy() as spy:
        eng.prepare_start()
        ms0 = timed_window(sim, 2)[0]
        ms, gv = timed_window(sim, 8)
    k5 = multisite_cell_forces_packed.launches
    half = multisite_cell_forces_packed.half_launches
    check(sim.engine is eng, "longrange: cell capacity re-spec")
    check(k5 == 11 and spy.seen == [alpha] * k5 and half == k5,
          f"longrange: K5 launches {k5} ({half} on the half shell), "
          f"screen_alpha {set(spy.seen)}")
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    parts = longrange_parts(sim)
    ms_state_report(
        "longrange", sim, gv, n, q0, ms, smi, mem0, solver="SPME",
        alpha=f"{alpha:.6f}", mesh=solver.params.grid, order=solver.params.order,
        construct_s=round(t_build, 2), warm_ms_per_step=f"{ms0:.3f}",
        window_steps=8, K5_launches=k5, K5_half_launches=half,
        screen_alpha_of_K5=json.dumps(sorted(set(spy.seen))),
        run_peak_mem_GB=f"{peak:.3f}", parts_ms=json.dumps(parts))
    return k5, k5_times(sim, "K5 water/SPME", smi), half


def clustered_charges(n, box, seed=11):
    """tests/test_fmm_adaptive.py's free-space set: three dense clusters
    and a sparse background (leaves at very different depths), charges
    uniform in [-1, 1] made neutral."""
    rng = np.random.default_rng(seed)
    k = n // 4
    pts = [np.asarray(c) * box + rng.normal(0, 0.015 * box, (k, 3))
           for c in ((0.2, 0.2, 0.2), (0.75, 0.7, 0.3), (0.5, 0.55, 0.8))]
    pts.append(rng.uniform(0.02 * box, 0.98 * box, (n - 3 * k, 3)))
    r = np.clip(np.concatenate(pts), 1e-6, box * (1 - 1e-6))
    q = rng.uniform(-1.0, 1.0, n)
    return r, q - q.mean()


def direct_sum(r, q, chunk=2048):
    """Free-space O(N^2) Coulomb sum on the card: (U, F, phi)."""
    n = r.shape[0]
    phi = torch.zeros_like(q)
    F = torch.zeros_like(r)
    ids = torch.arange(n, device=r.device)
    for i0 in range(0, n, chunk):
        d = r[i0:i0 + chunk, None, :] - r[None, :, :]
        r2 = (d * d).sum(-1)
        self_ = ids[i0:i0 + chunk, None] == ids[None, :]
        inv = torch.where(self_, 0.0, 1.0 / torch.sqrt(torch.where(self_, 1.0, r2)))
        phi[i0:i0 + chunk] = inv @ q
        F[i0:i0 + chunk] = q[i0:i0 + chunk, None] * torch.einsum(
            "ij,ijk->ik", q[None, :] * inv ** 3, d)
    return 0.5 * float((q * phi).sum()), F, phi


def water_state(n, device, dtype=torch.float32):
    """(mol, pp, box, q2_sum, n_q) of water_scene(n) without a driver."""
    from ls1_mardyn_tpu_torch.models.components import ComponentTable
    from ls1_mardyn_tpu_torch.models.interaction import PairParams
    from ls1_mardyn_tpu_torch.state import MoleculeState

    _, data, L = water_scene(n)
    table = ComponentTable([water_component()], cutoff=RC_LR, lj_cutoff=RC_LR)
    mol = MoleculeState.from_numpy(r=data.r, v=data.v, q=data.q, dtype=dtype,
                                   device=device)
    pp = PairParams.from_table(table, dtype=dtype, device=device)
    q2 = n * sum(q * q for *_, q in WATER_SITES)
    return mol, pp, np.full(3, L), q2, 3 * n


def phase_longrange_solvers(device, smi):
    """Each solver on the card against another: SPME against direct
    Ewald through the driver (water-class N = 8000, f32, Upot within 1e-4
    relative, forces within 5e-3 of the largest; the reciprocal energies
    alone are reported: direct Ewald at the tuned kmax is the less
    accurate of the two); the periodic FMM against SPME through the driver (N =
    64,000, f32: total energy within 2e-3 and forces within 5e-3 of the
    largest, tests/test_ewald_driver.py's and tests/test_fmm.py's
    limits; ms/step of each); the adaptive FMM on ~20,000 clustered
    free-space charges against the direct sum (f64, tests/
    test_fmm_adaptive.py's limits); then direct Ewald and SPME timed
    alone at N_sites * K around the driver's 2e8 crossover."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath
    from ls1_mardyn_tpu_torch.ops.ewald import (
        EwaldParams, EwaldSolver, charge_sites, self_intra_corrections)
    from ls1_mardyn_tpu_torch.ops.fmm import FMMElectrostatics
    from ls1_mardyn_tpu_torch.ops import fmm_adaptive
    from ls1_mardyn_tpu_torch.ops.fmm_adaptive import AdaptiveFMMSolver
    from ls1_mardyn_tpu_torch.ops.pme import PMEParams, PMESolver

    def solvers(n):
        mol, pp, box, q2, nq = water_state(n, device)
        ep = EwaldParams.tune(box, RC_LR, q2, nq, ACC_LR)
        pm = PMEParams.tune(box, RC_LR, q2, nq, ACC_LR)
        return (mol, pp, EwaldSolver(box, ep, torch.float32, device),
                PMESolver(box, pm, torch.float32, device))

    # SPME against direct Ewald, through the driver (K5 + the solver)
    runs = {}
    for method, cls in (("direct", EwaldSolver), ("pme", PMESolver)):
        cfg, data, _ = water_scene(8000, method=method)
        sim = MDSimulation(cfg, phase_space_data=data, device=device,
                           force_mode="auto")
        check(type(sim.ewald) is cls
              and isinstance(sim.engine._force_fn, CudaMultiSitePackedPath),
              f"longrange-solvers/{method}: {type(sim.ewald).__name__}")
        sim.engine.prepare_start()
        mol, pp = sim.engine.mol, sim.engine.pp
        u_k = float(sim.ewald(mol, pp)[0])
        runs[method] = (float(sim.engine.macro.upot), sim.engine.forces.F.clone(),
                        u_k, cuda_ms(lambda: sim.ewald(mol, pp), 3), sim.ewald)
        del sim
    (ud, Fd, ukd, msd, direct), (um, Fm, ukm, msm, mesh) = runs["direct"], runs["pme"]
    _, rs, wq = charge_sites(mol, pp)
    uc = float(self_intra_corrections(mol, direct.params.alpha, rs, wq)[0])
    rel_u = abs(um - ud) / abs(ud)
    rel_F = float((Fm - Fd).abs().max() / Fd.abs().max())
    say("longrange-solvers/pme-vs-direct", n=8000, kmax=direct.params.kmax,
        n_k=direct.kvec.shape[0], grid=mesh.params.grid, upot_direct=f"{ud:.6f}",
        upot_pme=f"{um:.6f}", rel_upot=f"{rel_u:.2e}", rel_F=f"{rel_F:.2e}",
        u_recip_direct=f"{ukd - uc:.6f}", u_recip_pme=f"{ukm - uc:.6f}",
        rel_u_recip=f"{abs(ukm - ukd) / abs(ukd - uc):.2e}",
        ms_direct=f"{msd:.3f}", ms_pme=f"{msm:.3f}", gpu=repr(smi))
    check(rel_u <= 1e-4 and rel_F <= 5e-3,
          f"longrange-solvers: SPME against direct: Upot {rel_u:.2e}, F {rel_F:.2e}")
    del mol, pp, direct, mesh, runs

    # the periodic FMM against SPME, through the driver
    runs = {}
    for method in ("pme", "fmm"):
        cfg, data, _ = water_scene(64000, method=method)
        sim = MDSimulation(cfg, phase_space_data=data, device=device,
                           force_mode="auto")
        path = sim.engine._force_fn
        check(isinstance(path, CudaMultiSitePackedPath)
              and (path.screen_alpha > 0) == (method == "pme"),
              f"longrange-solvers/{method}: path {type(path).__name__}")
        if method == "fmm":
            check(isinstance(sim.ewald, FMMElectrostatics)
                  and not sim._table_pair.has_electrostatics()
                  and sim.ewald.depth == 5 and sim.ewald.solver.cap == 32,
                  "longrange-solvers/fmm: not the depth-5, cap-32 FMM on an "
                  "LJ-only K5")
        sim.engine.prepare_start()
        u0 = float(sim.engine.macro.upot)
        F0 = sim.engine.forces.F.clone()
        timed_window(sim, 1)
        ms, gv = timed_window(sim, 4)
        runs[method] = (u0, F0, ms)
        say(f"longrange-solvers/{method}", n=64000, u0=f"{u0:.6f}",
            ms_per_step=f"{ms:.3f}", T=f"{float(gv.temperature):.6f}",
            **({"depth": sim.ewald.depth, "cap": sim.ewald.solver.cap,
                "order": sim.ewald.solver.order} if method == "fmm" else
               {"grid": sim.ewald.params.grid}))
        del sim
    (up, Fp, msp), (uf, Ff, msf) = runs["pme"], runs["fmm"]
    rel_u = abs(uf - up) / abs(up)
    rel_F = float((Ff - Fp).abs().max() / Fp.abs().max())
    say("longrange-solvers/fmm-vs-pme", rel_u=f"{rel_u:.2e}", rel_F=f"{rel_F:.2e}",
        ms_pme=f"{msp:.3f}", ms_fmm=f"{msf:.3f}", gpu=repr(smi))
    check(rel_u <= 2e-3 and rel_F <= 5e-3,
          f"longrange-solvers: FMM against SPME u {rel_u:.2e}, F {rel_F:.2e}")

    # the adaptive FMM against the direct sum
    n_a, box_a = 20000, 10.0
    r_np, q_np = clustered_charges(n_a, box_a)
    solver = AdaptiveFMMSolver(box=box_a, order=8, threshold=24,
                               dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    plan = solver.build_plan(r_np)
    t_plan = time.perf_counter() - t0
    r = torch.as_tensor(r_np, device=device)
    q = torch.as_tensor(q_np, device=device)
    U, F, phi = solver.compute(r, q, plan=plan)
    U0, F0, phi0 = direct_sum(r, q)
    rel_U = abs(float(U) - U0) / abs(U0)
    rel_F = float((F - F0).norm(dim=1).max() / F0.norm(dim=1).max())
    rel_phi = float((phi - phi0).abs().max() / phi0.abs().max())
    say("longrange-solvers/adaptive-fmm", n=n_a, nodes=int(plan.node_w.sum()),
        leaves=int((plan.slots >= 0).any(1).sum()),
        m2l_pairs=int(plan.m2l_w.sum()), p2p_pairs=int(plan.p2p_w.sum()),
        plan_s=round(t_plan, 2), rel_U=f"{rel_U:.2e}", rel_F=f"{rel_F:.2e}",
        rel_phi=f"{rel_phi:.2e}", cap=int(plan.slots.shape[1]),
        pass_bytes=fmm_adaptive.PASS_BYTES,
        ms_adaptive=f"{cuda_ms(lambda: solver.compute(r, q, plan=plan), 2):.3f}",
        ms_direct=f"{cuda_ms(lambda: direct_sum(r, q), 2):.3f}")
    check(rel_U <= 2e-4 and rel_F <= 5e-3 and rel_phi <= 1e-3,
          "longrange-solvers: adaptive FMM against the direct sum")

    # the auto crossover: each solver alone, f32
    rows = []
    for n in CROSSOVER_N:
        mol, pp, direct, mesh = solvers(n)
        nk = direct.kvec.shape[0]
        rows.append(dict(n=n, kmax=direct.params.kmax, n_k=nk,
                         n_sites_k=f"{3 * n * nk:.3g}", grid=mesh.params.grid[0],
                         ms_direct=round(cuda_ms(lambda: direct(mol, pp), 3), 3),
                         ms_pme=round(cuda_ms(lambda: mesh(mol, pp), 3), 3)))
    first = next((x for x in rows if x["ms_pme"] < x["ms_direct"]), None)
    say("longrange-solvers/crossover", rows=json.dumps(rows),
        pme_first_faster=json.dumps(first), gpu=repr(smi))


# -- ensembles and the plugins that change the molecule set --------------
# the evaporation-class muVT film (tools/muvt_scale.py's "evap" scene,
# the MkTcTS film of ls1's Evaporation/Adsorption examples): a liquid
# slab of 80% of the box along y in vapour, the chemical potential's
# control volume in the vapour (y >= 0.95 L), 8 instances every 2 steps
N_MUVT = 4_194_304
RHO_LIQ, RHO_VAP, LIQ_FRAC = 0.60, 0.02, 0.80
MU_EVAP, INSTANCES_EVAP, EVERY_EVAP = -1.0, 8, 2
MUVT_WARM, MUVT_WIN = 4, 16
# nemd: the steps before its windows (MettDeamon's first bin at ~60)
NEMD_WARM = 64
# the samplers of the film: CavityWriter's 10^3 probes and 16 Widom
# insertions, both every 10 steps
SAMPLE_EVERY = 10


def film_data(n_target, seed=42, frozen_planes=0):
    """The port's MkTcTS film (io/generators.mktcts) of about n_target
    molecules: (data, L, lattice period along y).  frozen_planes > 0
    (the nemd phase): the lattice planes of the vapour at the bottom,
    y < frozen_planes * period / 2, belong to a second, identical
    component (MettDeamon's frozen variant) and start at rest."""
    from ls1_mardyn_tpu_torch.io.generators import mktcts

    rho_eff = RHO_LIQ * LIQ_FRAC + RHO_VAP * (1 - LIQ_FRAC)
    L = (n_target / rho_eff) ** (1 / 3)
    comps = _two_lj(rc=RC) if frozen_planes else None
    data = mktcts(RHO_LIQ, RHO_VAP, [L, L, L], TEMP, liq_fraction=LIQ_FRAC,
                  components=comps, seed=seed)
    # the generator's two interleaved lattices put a plane every half period
    period = 2.0 * float(np.diff(np.unique(np.round(data.r[:, 1], 6))).min())
    if frozen_planes:
        frozen = data.r[:, 1] < frozen_planes * period / 2
        data.cid = np.where(frozen, 1, 0).astype(data.cid.dtype)
        data.v[frozen] = 0.0
    return data, L, period


def muvt_config(box, mu, instances, every, lower_y=None, plugins=()):
    """scene_config under muVT with one chemical potential of component
    1 (control volume y >= lower_y when given) and output plugins."""
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec

    cfg = scene_config(box)
    cfg.ensemble_type = "muVT"
    p = {"mu": str(mu), "cid": "1", "everyNTimesteps": str(every),
         "instances": str(instances)}
    if lower_y is not None:
        p["control"] = {"lower": {"x": 0.0, "y": lower_y, "z": 0.0},
                        "upper": {"x": box[0], "y": box[1], "z": box[2]}}
    cfg.chemical_potentials = [PluginSpec("ChemicalPotential", p)]
    cfg.output_plugins = list(plugins)
    return cfg


def sampler_specs(d, freq, grid=10, insertions=16):
    """CavityWriter (grid^3 probes) and WidomInsertion (insertions) into
    d every freq steps."""
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec

    return [PluginSpec("CavityWriter", {
                "writefrequency": str(freq), "outputprefix": os.path.join(d, "cav"),
                "Nx": str(grid), "Ny": str(grid), "Nz": str(grid),
                "radius": "1.0", "maxNeighbours": "0"}),
            PluginSpec("WidomInsertion", {
                "cid": "1", "insertions": str(insertions),
                "samplefrequency": str(freq), "writefrequency": str(freq),
                "temperature": str(TEMP), "outputprefix": os.path.join(d, "widom")})]


def inject_draws(sim, seed):
    """The ensemble's and Widom's draws made on the host from seed and
    sent to the run's device: a run on the card and one on the CPU then
    take every decision alike."""
    if sim.gc is not None:
        rng, gc = np.random.default_rng(seed), sim.gc

        def draws(icp, dtype):
            cp = gc.chem_pots[icp]
            nd, ni = cp.deletions_per_interval, cp.insertions_per_interval
            return (torch.as_tensor(rng.uniform(size=(nd + ni, 4)), dtype=dtype,
                                    device=gc.device),
                    torch.as_tensor(rng.normal(size=(ni, 7)), dtype=dtype,
                                    device=gc.device))

        gc.draws = draws
    for p in sim._plugins:
        if p.name == "WidomInsertion":
            wrng = np.random.default_rng(seed + 1)
            p.draws = lambda n, dtype, device, wrng=wrng: (
                torch.as_tensor(wrng.uniform(size=(n, 3)), dtype=dtype, device=device),
                torch.as_tensor(wrng.normal(size=(n, 4)), dtype=dtype, device=device))


def slot_state(sim):
    mol = sim.engine.mol
    return {k: getattr(mol, k).cpu().numpy() for k in
            ("r", "v", "q", "L", "cid", "mid", "valid")}


def compare_slots(phase, a, b, box):
    """Two runs' states slot by slot: validity, ids and components
    identical; r (minimum image), v, q, L over the valid slots within
    1e-9 of their largest magnitude.  Returns the worst differences."""
    for k in ("valid", "mid", "cid"):
        check(np.array_equal(a[k], b[k]), f"{phase}: {k} differs slot by slot")
    ok = a["valid"]
    err = {}
    for k in ("r", "v", "q", "L"):
        d = a[k][ok] - b[k][ok]
        if k == "r":
            d -= box * np.round(d / box)
        err[k] = float(np.abs(d).max() / max(1.0, np.abs(b[k][ok]).max()))
    check(max(err.values()) <= 1e-9, f"{phase}: states differ ({err})")
    return err


def run_on_both(phase, build, device, steps=20):
    """build(dev, dir) -> sim on the card and on the CPU, f64, run for
    `steps` steps from its directory with the same draws; globals within
    rtol 1e-9, states slot by slot, every file of the two directories
    within rtol 1e-9.  Returns the card's sim, the worst differences and
    the CPU sim."""
    out = []
    here = os.getcwd()
    for dev in (device, "cpu"):
        d = fresh_dir(f"{phase.replace('/', '_')}_{dev}_{len(out)}")
        os.chdir(d)
        try:
            sim = build(dev, d)
            inject_draws(sim, 5)
            gv = sim.run(steps=steps, print_every=0)
        finally:
            os.chdir(here)
        out.append((sim, gv, slot_state(sim), d))
    (sa, ga, xa, da), (sb, gb, xb, db) = out
    rel = {k: abs(float(getattr(ga, k)) / float(getattr(gb, k)) - 1)
           for k in ("temperature", "pressure", "upot")}
    check(max(rel.values()) <= 1e-9, f"{phase}: globals differ ({rel})")
    err = compare_slots(phase, xa, xb, np.asarray(sa.box))
    files = compare_outputs(phase, da, db)
    check(max(files.values(), default=0.0) <= 1e-9,
          f"{phase}: card and CPU files differ ({files})")
    err.update(rel)
    return sa, {**err, **{f: e for f, e in files.items()}}, sb


def phase_ensembles_small(device):
    """The muVT driver on the card against the CPU, f64, 20 steps, the
    same draws on both: a 1CLJ fluid (K3; four insertions and
    four deletions a step; N = 3000 at rho 0.35) with CavityWriter and
    WidomInsertion, a 2CLJQ fluid on ms_packed (K5; multi-site probes;
    N = 5832 at rho 0.2) and a 1CLJ liquid of CELL_PROBE_MIN_N molecules
    (the cell-table probe).  Counters identical,
    T/p/Upot rtol 1e-9, states slot by slot, files within rtol 1e-9."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ensemble.grand_canonical import GrandCanonicalEnsemble
    from ls1_mardyn_tpu_torch.ops import cuda_lj, cuda_ms_packed
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath

    t0 = time.perf_counter()
    scenes = (
        # tag, n, rho, kind, force_mode, mu, instances, every, path, counter
        # (the smallest sizes and densities at which the cost rule runs
        # the kernel, not the N^2 sweep, and mu accepts both moves)
        ("1clj", 3000, 0.35, "1clj", "pallas", -2.0, 4, 1, CudaLJPath,
         cuda_lj.lj_cell_forces_cw),
        ("2cljq", 5832, 0.2, "2cljq", "ms_packed", -2.5, 2, 2,
         CudaMultiSitePackedPath, cuda_ms_packed.multisite_cell_forces_packed),
        ("cell", GrandCanonicalEnsemble.CELL_PROBE_MIN_N, 0.5, "1clj", "pallas",
         -3.0, 4, 2, CudaLJPath, cuda_lj.lj_cell_forces_cw),
    )
    for tag, n, rho, kind, mode, mu, inst, every, path_t, counter in scenes:
        def build(dev, d):
            data, L = lattice_scene(n, rho, kind)
            plugins = sampler_specs(d, 5, grid=5, insertions=32) if tag == "1clj" else ()
            sim = MDSimulation(muvt_config(data.box, mu, inst, every, plugins=plugins),
                               dtype=torch.float64, phase_space_data=data,
                               device=dev, force_mode=mode)
            check(isinstance(sim.engine._force_fn, path_t) and sim.gc is not None,
                  f"ensembles-small/{tag}: path {type(sim.engine._force_fn)}")
            if dev != "cpu":  # the card's run, before the CPU's
                counter.launches = 0
            return sim

        sim, err, cpu = run_on_both(f"ensembles-small/{tag}", build, device)
        launches = counter.launches
        counts = [(s.gc.attempted, s.gc.accepted_ins, s.gc.accepted_del)
                  for s in (sim, cpu)]
        check(counts[0] == counts[1], f"ensembles-small/{tag}: counters {counts}")
        check(counts[0][1] > 0 and counts[0][2] > 0,
              f"ensembles-small/{tag}: no insertion or no deletion accepted")
        check(launches >= 20, f"ensembles-small/{tag}: {launches} kernel launches")
        cell = sim.gc._probe_caps[0] is not None
        check(cell == (tag == "cell"), f"ensembles-small/{tag}: probe {sim.gc._probe_caps}")
        say("ensembles-small", scene=tag, n=n, capacity=sim.engine.mol.capacity,
            engine=type(sim.engine).__name__, path=path_t.__name__,
            launches=launches, probe="cell" if cell else "row",
            attempted=counts[0][0], accepted_ins=counts[0][1],
            accepted_del=counts[0][2],
            rel=json.dumps({k: f"{e:.1e}" for k, e in err.items()}))
    say("ensembles-small", seconds=round(time.perf_counter() - t0, 1))


def _lattice(n, box, T=1.0, seed=42, shift_y=0.0, side_y=None, components=None):
    from ls1_mardyn_tpu_torch.io.generators import cubic_grid

    box = np.asarray(box, float)
    extent = [box[0], side_y or box[1], box[2]]
    data = cubic_grid(n, extent, T, seed=seed, components=components)
    data.r[:, 1] += shift_y
    data.box = box
    return data


def _two_lj(n=2, rc=0.0):
    """n identical one-centre LJ components (eps = sigma = m = 1)."""
    from ls1_mardyn_tpu_torch.models.components import Component

    comps = []
    for k in range(n):
        c = Component(cid=k)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, rc)
        comps.append(c)
    return comps


def _merge(a, b):
    """Two PhaseSpaceData of one box as one (ids renumbered)."""
    import dataclasses

    cat = {k: np.concatenate([getattr(a, k), getattr(b, k)])
           for k in ("r", "v", "q", "L", "cid")}
    return dataclasses.replace(a, mid=np.arange(1, len(cat["r"]) + 1), **cat)


def mett_small_scene():
    """nemd-small's evaporation: a lattice film in y [10, 20) (component
    1), and MettDeamon's reservoir, one lattice plane at the bottom of
    the box (component 2, frozen, at rest), with nothing between them, so
    that the riding molecules meet no one; the sink (Mirror type 5) sits
    just below the film's top plane.  Returns (data, lattice period of
    the reservoir along y, the sink's y)."""
    comps = _two_lj()
    film = _lattice(448, [8.0, 30.0, 8.0], 0.8, seed=12, shift_y=10.0, side_y=10.0,
                    components=comps)
    res = _lattice(2000, [8.0, 30.0, 8.0], 0.8, seed=3, components=comps)
    period = 2.0 * float(np.diff(np.unique(np.round(res.r[:, 1], 6))).min())
    bottom = res.r[:, 1] < 0.5 * period
    res.r, res.q, res.L = res.r[bottom], res.q[bottom], res.L[bottom]
    res.v = np.zeros_like(res.r)
    res.cid = np.ones(len(res.r), film.cid.dtype)
    return _merge(film, res), period, float(film.r[:, 1].max()) - 0.1


def nemd_small_scenes():
    """(tag, data, T, plugins, engine) of nemd-small (NVT, dt 0.002, rc 2.5):
    the scenes of the JAX package's tests of these plugins
    (tests/test_plugins_nemd.py, test_nemd2.py, test_extra_plugins.py,
    test_wallpotential.py)."""
    L = (216 / 0.4) ** (1 / 3)
    L5 = (125 / 0.4) ** (1 / 3)
    wall = {"potential": "93", "density": "0.9", "sigma": "1.0", "epsilon": "1.0",
            "yoff": "0.0", "ycut": "2.0", "width": "0.0"}

    def mirror(t, pos, d, **kw):
        return ("Mirror", dict({"type": str(t), "position": str(pos), "axis": "1",
                                "direction": str(d)}, **kw))

    mett, period, sink_y = mett_small_scene()
    # bins of one lattice period, fed in 8 steps: a bin goes in where its
    # riding original was
    feed = {"control": {"feed": {"init": str(period / 8), "direction": "1",
                                 "method": "4"}},
            "reservoir": {"width": str(2 * period), "binwidth": str(period)},
            "changes": {"change": {"from": "1", "to": "2"}}, "writefrequency": "5"}
    film = _lattice(448, [8.0, 30.0, 8.0], 0.8, seed=12, shift_y=10.0, side_y=10.0,
                    components=_two_lj())
    return (
        ("mirror1", _lattice(216, [L, 8.0, L], 1.0, shift_y=2.2, side_y=3.6), 1.0,
         [mirror(1, 5.5, 1), mirror(1, 2.5, -1)], "general"),
        ("mirror2_wall93", _lattice(216, [L, 8.0, L], 1.0, shift_y=2.2, side_y=3.6),
         1.0,
         [mirror(2, 5.5, 1, forceConstant="50.0"),
          mirror(2, 2.5, -1, forceConstant="50.0"),
          ("WallPotential", dict(wall, yoff="1.0"))],
         "general"),
        ("mirror6_wall104", _lattice(216, [L, 8.0, L], 1.5, shift_y=0.3, side_y=4.0),
         1.5,
         [mirror(6, 3.9, 1, ramping={"start": "0", "stop": "10", "treatment": "0"}),
          ("WallPotential", dict(wall, potential="104", delta="0.7"))], "general"),
        ("mettdeamon", mett, 0.8,
         [("MettDeamon", feed),
          ("Mirror", {"type": "5", "position": str(sink_y), "axis": "1",
                      "dir": "o-|", "meland": {"velo_target": "0.5"}}),
          ("MettDeamonFeedrateDirector", {"updatefreq": "20"}),
          ("DistControl", {"control": {"update": "5"}, "subdivision": {"number": "30"},
                           "outputprefix": "dist"})], "general"),
        ("drift", film, 0.8,
         [("DriftCtrl", {"control": {"freq": {"control": "3"}},
                         "target": {"cid": "1", "drift": {"vx": "0.5"}},
                         "range": {"yl": "10", "yr": "20",
                                   "subdivision": {"binwidth": "2.5"}}}),
          ("PosNegComp", {"cid_ub_pos": "1", "cid_ub_neg": "2"}),
          ("ExtractPhase", {"step": "4", "left": "10.5", "right": "19.5"})],
         "general"),
        ("fix", _lattice(216, [L, L, L]), 1.0,
         [("FixRegion", {"ymin": "0", "ymax": "2.0"}), ("COMaligner", {"interval": "5"}),
          ("InMemoryCheckpointing", {"writefrequency": "5",
                                     "restartAtIteration": "12"})], "general"),
        ("drop", _lattice(125, [L5, L5, L5]), 1.0,
         [("MirrorSystem", {"yPos": "0.0"}),
          ("Dropaccelerator", {"xposition": "3", "yposition": "3", "zposition": "3",
                               "dropradius": "2", "velocity": "1.0",
                               "starttime": "1", "steps": "3"}),
          ("Dropaligner", {"xpos": "4.5", "ypos": "4.5", "zpos": "4.5",
                           "radius": "3", "interval": "2"})], "general"),
        ("checkpoint_rmm", _lattice(1500, [(1500 / 0.6) ** (1 / 3)] * 3), 1.0,
         [("InMemoryCheckpointing", {"writefrequency": "5",
                                     "restartAtIteration": "12"})], "rmm"),
    )


def plugin_counts(sim):
    """The counters of a run's state-changing plugins."""
    out = {}
    for i, p in enumerate(sim._plugins):
        for a in ("reflected", "deleted", "inserted", "released", "deleted_sum",
                  "active_bin", "left", "right", "feed_actual", "feed_sum"):
            if hasattr(type(p), a) or a in vars(p):
                out[f"{i}:{p.name}.{a}"] = getattr(p, a)
    return out


def phase_nemd_small(device):
    """The sixteen plugins' scenes (the JAX tests' scenes) on the card
    against the CPU, f64, 20 steps: the engine of each scene asserted,
    every plugin counter identical, T/p/Upot rtol 1e-9, states slot by
    slot within 1e-9, files (DistControl, MettDeamon_feed.dat) within
    rtol 1e-9."""
    import copy

    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec, XMLConfig

    t0 = time.perf_counter()
    for tag, data0, T, plugins, engine in nemd_small_scenes():
        def build(dev, d):
            data = copy.deepcopy(data0)
            cfg = XMLConfig(timestep=DT, temperature=T, box=np.asarray(data.box),
                            cutoff=RC, lj_cutoff=RC, ensemble_type="NVT",
                            components=data.components,
                            plugins=[PluginSpec(nm, copy.deepcopy(pr))
                                     for nm, pr in plugins])
            sim = MDSimulation(cfg, dtype=torch.float64, phase_space_data=data,
                               device=dev)
            name = type(sim.engine).__name__
            check(name == {"general": "SingleChipSimulation",
                           "rmm": "RMMEngine"}[engine],
                  f"nemd-small/{tag}: engine {name}")
            return sim

        sim, err, cpu = run_on_both(f"nemd-small/{tag}", build, device)
        counts = plugin_counts(sim)
        check(counts == plugin_counts(cpu),
              f"nemd-small/{tag}: counters {counts} against {plugin_counts(cpu)}")
        say("nemd-small", scene=tag, engine=type(sim.engine).__name__,
            n=int(sim.engine.mol.valid.sum()),
            plugins=",".join(p.name for p in sim._plugins),
            counts=json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in counts.items()}),
            rel=json.dumps({k: f"{e:.1e}" for k, e in err.items()}))
    say("nemd-small", seconds=round(time.perf_counter() - t0, 1))


def count_launches(fn):
    """(kernels on the device, kernel launches by the host) of fn(),
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = host = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            host += 1
    return dev, host


def k3_path_times(sim, smi, phase):
    """K3 against its plain version at the shapes the general path gives
    it on sim's state (f32 1e-5), with its bound; the kernels-line
    record's numbers."""
    from ls1_mardyn_tpu_torch.ops import cuda_lj

    eng = sim.engine
    path = eng._force_fn
    r_i, _ = path.layout(eng.mol)
    dims, cap = path.spec.dims, path.spec.cap
    kw = dict(dims=dims, cap=cap, cell_len=path.spec.cell_len, eps24=path.eps24,
              sig2=path.sig2, shift6=path.shift6, rc2=path.rc2)
    fn, ref = cuda_lj.lj_cell_forces_cw, cuda_lj.lj_cell_forces_cw_reference
    ms = cuda_ms(lambda: fn(r_i, compute_macro=True, **kw), 10)
    plain = cuda_ms(lambda: ref(r_i, compute_macro=True, **kw), 1)
    a, b = fn(r_i, **kw), ref(r_i, **kw)
    err = float((a[0] - b[0]).abs().max())
    rel = max(rel_errors(a, b))
    check(rel <= 1e-5, f"{phase}: K3 at its path's shape: rel err {rel}")
    bound = lj_bound(r_i, dims, cap, dict(cell_len=path.spec.cell_len, rc2=path.rc2),
                     3)
    say(phase, kernel="K3", grid=dims, cap=cap, ms_macro=f"{ms:.3f}",
        plain_ms_macro=f"{plain:.3f}", max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        bound=json.dumps(bound), gpu=repr(smi))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"])


def film_report(phase, gv, n):
    """check_globals on a film whose molecule set changes (its counts
    are checked against the counters), as printed fields."""
    T, p, U = check_globals(phase, gv)
    return dict(T=f"{T:.6f}", p=f"{p:.6f}", upot_per_mol=f"{U / n:.6f}")


def phase_muvt(device, smi):
    """This slice's path at full width: the evaporation-class muVT film
    (N ~ 4.2e6, f32) on the general engine with K3, CavityWriter and
    WidomInsertion every 10 steps.  A warm-up and a 16-step window, then
    the same window with the ensemble switched off (GCMC's cost a step
    and a cycle), one cycle alone (its launches and ms), the counters, N
    read before the run and again after it (two readbacks), T within 10%
    and peak memory; then K3 against its plain version at this path's
    shapes with its bound.  Returns K3's launches in the run and its
    times there."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.ops.cuda_lj import lj_cell_forces_cw, lj_cell_forces_row
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
    from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    data, L, _period = film_data(N_MUVT)
    d = fresh_dir("muvt")
    cfg = muvt_config(data.box, MU_EVAP, INSTANCES_EVAP, EVERY_EVAP,
                      lower_y=(LIQ_FRAC + 0.15) * L,
                      plugins=sampler_specs(d, SAMPLE_EVERY))
    sim = MDSimulation(cfg, phase_space_data=data, device=device, force_mode="auto")
    eng, gc = sim.engine, sim.gc
    path = eng._force_fn
    check(isinstance(eng, SingleChipSimulation) and isinstance(path, CudaLJPath)
          and path.cw and gc is not None, "muvt: engine, force path or ensemble")
    n_before = int(eng.mol.valid.sum())  # readback 1
    t_build = time.perf_counter() - t0
    lj_cell_forces_cw.launches = lj_cell_forces_row.launches = 0
    eng.prepare_start()
    ms_warm, _ = timed_window(sim, MUVT_WARM)
    ms_gc, gv = timed_window(sim, MUVT_WIN)
    k3 = lj_cell_forces_cw.launches
    check(k3 == 1 + MUVT_WARM + MUVT_WIN and lj_cell_forces_row.launches == 0,
          f"muvt: K3 launched {k3} times in {MUVT_WARM + MUVT_WIN} steps")
    check(sim.engine is eng, "muvt: cell capacity re-spec")
    cycles = gc.cycles
    sim.gc = None
    ms_md, gv_md = timed_window(sim, MUVT_WIN)
    sim.gc = gc
    check(gc.cycles == cycles, "muvt: the ensemble ran while switched off")
    # one cycle alone on the current state (its result discarded)
    saved = (gc.attempted, gc.accepted_ins, gc.accepted_del, gc.cycles)
    step = sim.step + (-sim.step % EVERY_EVAP)
    dev_k, host_k = count_launches(lambda: gc.step(eng.mol, sim.pp, step))
    cyc_ms = cuda_ms(lambda: gc.step(eng.mol, sim.pp, step), 3)
    gc.attempted, gc.accepted_ins, gc.accepted_del, gc.cycles = saved
    n_after = int(sim.engine.mol.valid.sum())  # readback 2
    check(n_after == n_before + gc.accepted_ins - gc.accepted_del,
          f"muvt: N {n_before} -> {n_after} against the counters")
    check(gc.attempted == cycles * 2 * INSTANCES_EVAP and gc.accepted_ins > 0,
          f"muvt: attempted {gc.attempted}, accepted {gc.accepted_ins}")
    rep = film_report("muvt", gv_md, n_after)
    files = sorted(os.listdir(d))
    check(any(f.endswith(".cav.xyz") for f in files) and "widom.widom" in files,
          f"muvt: sampler files {files}")
    widom = [p for p in sim._plugins if p.name == "WidomInsertion"][0]
    say("muvt", n_before=n_before, n_after=n_after, capacity=eng.mol.capacity,
        box=f"{L:.4f}", grid=path.spec.dims, cap=path.spec.cap,
        probe=json.dumps(gc._probe_caps.get(0)), construct_s=round(t_build, 2),
        warm_ms_per_step=f"{ms_warm:.3f}", window_steps=MUVT_WIN,
        ms_per_step=f"{ms_gc:.3f}", updates_per_s=f"{n_after / ms_gc * 1e3:.4e}",
        ms_per_step_without_gcmc=f"{ms_md:.3f}",
        gcmc_ms_per_step=f"{ms_gc - ms_md:.3f}",
        gcmc_ms_per_cycle=f"{(ms_gc - ms_md) * EVERY_EVAP:.3f}",
        cycle_alone_ms=f"{cyc_ms:.3f}", cycle_device_kernels=dev_k,
        cycle_host_launches=host_k, cycles=gc.cycles, attempted=gc.attempted,
        accepted_ins=gc.accepted_ins, accepted_del=gc.accepted_del,
        K3_launches=k3, mu_excess=f"{widom.mu_excess:.6f}", files=len(files),
        peak_mem_GB=f"{(torch.cuda.max_memory_allocated() - mem0) / 1e9:.3f}",
        gpu=repr(smi), **rep)
    times = k3_path_times(sim, smi, "muvt")
    say("muvt", seconds=round(time.perf_counter() - t0, 1))
    return k3, times


def phase_nemd(device, smi):
    """The film as a steady evaporation (NVT, f32, N ~ 4.2e6): a Mirror
    type 5 sink at y = 0.95 L deletes most outward movers of the upper
    vapour; MettDeamon feeds the lower vapour from a reservoir cut from
    the start state (the 4 lattice planes below y = 2 periods, frozen and
    at rest, in bins of one lattice period, so that a bin goes in exactly
    where the lattice continues) at a constant feed of one period in 60
    steps (a ride slower than thermal motion: a pinned molecule does not
    ram its neighbours); the FeedrateDirector resets the feed from the
    outflow at step 80; DistControl tracks the interfaces every 8 steps.
    A warm-up of 64 steps (the first bin goes in at step ~60, into the
    slots the sink freed), a 16-step window with the set and one without
    it; the host reads a step, and the counts inserted, released and
    deleted.  Two components: the multi-site path (K5); then K5 held
    against its plain version at this path's shapes, with its bound.
    Returns K5's launches in the run, its times there and its launches on
    the half shell."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation
    from ls1_mardyn_tpu_torch.io.xml_config import PluginSpec
    from ls1_mardyn_tpu_torch.ops import cuda_ms_packed
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    data, L, period = film_data(N_MUVT, frozen_planes=4)
    warm = NEMD_WARM
    d = fresh_dir("nemd")
    cfg = scene_config(data.box)
    cfg.components = data.components
    cfg.plugins = [
        PluginSpec("MettDeamon", {
            "control": {"feed": {"init": str(period / 60), "direction": "1",
                                 "method": "4"}},
            "reservoir": {"width": str(2 * period), "binwidth": str(period)},
            "changes": {"change": {"from": "1", "to": "2"}},
            "writefrequency": "8"}),
        PluginSpec("MettDeamonFeedrateDirector",
                   {"updatefreq": str(warm + MUVT_WIN)}),
        PluginSpec("Mirror", {"type": "5", "position": str(0.95 * L), "axis": "1",
                              "dir": "o-|", "meland": {"velo_target": "0.5"}}),
        PluginSpec("DistControl", {"control": {"update": "8"},
                                   "subdivision": {"number": "100"},
                                   "outputprefix": os.path.join(d, "dist")}),
    ]
    here = os.getcwd()
    os.chdir(d)  # MettDeamon_feed.dat
    try:
        sim = MDSimulation(cfg, phase_space_data=data, device=device, force_mode="auto")
        md, director, sink, dist = sim._plugins
        path = sim.engine._force_fn
        check(isinstance(path, CudaMultiSitePackedPath),
              f"nemd: force path {type(path).__name__}")
        n0 = int(sim.engine.mol.valid.sum())
        cuda_ms_packed.multisite_cell_forces_packed.launches = 0
        cuda_ms_packed.multisite_cell_forces_packed.half_launches = 0
        sim.engine.prepare_start()
        ms_warm, _ = timed_window(sim, warm)
        reads0 = md.reads + director.reads + sink.reads + dist.reads
        ms_set, gv = timed_window(sim, MUVT_WIN)
        reads = md.reads + director.reads + sink.reads + dist.reads - reads0
        counts = dict(inserted=md.inserted, released=md.released,
                      sink_deleted=sink.deleted, sink_reflected=sink.reflected,
                      net_deleted=md.deleted_sum, feed_after_director=f"{md.feed_actual:.6g}",
                      left=f"{dist.left:.4f}", right=f"{dist.right:.4f}")
        n1 = int(sim.engine.mol.valid.sum())
        plugins, sim._plugins = sim._plugins, []
        ms_bare, gv_bare = timed_window(sim, MUVT_WIN)
        sim._plugins = plugins
    finally:
        os.chdir(here)
    k5 = cuda_ms_packed.multisite_cell_forces_packed.launches
    half = cuda_ms_packed.multisite_cell_forces_packed.half_launches
    check(half == k5, f"nemd: {half} of {k5} K5 launches on the half shell")
    check(md.inserted > 0 and md.released > 0 and sink.deleted > 0,
          f"nemd: counts {counts}")
    check(n1 == n0 - sink.deleted + md.inserted, f"nemd: N {n0} -> {n1}, {counts}")
    check(k5 == 1 + warm + 2 * MUVT_WIN, f"nemd: K5 launched {k5} times")
    rep = film_report("nemd", gv, n1)
    say("nemd", n_before=n0, n_after=n1, box=f"{L:.4f}", period=f"{period:.6f}",
        engine=type(sim.engine).__name__,
        path=type(sim.engine._force_fn).__name__, K5_launches=k5,
        K5_half_launches=half,
        warm_steps=warm, warm_ms_per_step=f"{ms_warm:.3f}", window_steps=MUVT_WIN,
        ms_per_step_with_set=f"{ms_set:.3f}", ms_per_step_without=f"{ms_bare:.3f}",
        set_ms_per_step=f"{ms_set - ms_bare:.3f}",
        host_reads_per_step=f"{reads / MUVT_WIN:.3f}", counts=json.dumps(counts),
        T_without=f"{float(gv_bare.temperature):.6f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        gpu=repr(smi), **rep)
    times = k5_times(sim, "K5 NEMD film", smi)
    say("nemd", seconds=round(time.perf_counter() - t0, 1))
    return k5, times, half


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    device = "cuda"
    import ls1_mardyn_tpu_torch  # noqa: F401  (precision flags)

    phase_build()
    phase_k1(device)
    phase_k2(device)
    phase_k3(device)
    phase_k4(device)
    phase_k5(device)
    phase_k6(device)
    phase_k7(device)
    phase_k8(device)
    phase_k9(device)
    phase_k10(device)
    phase_small(device)
    phase_general_small(device)
    phase_multisite_small(device)
    phase_plugins_small(device)
    sim_rmm, launches = phase_main(device, smi)
    launches.update(phase_packed(sim_rmm, smi))
    # no engine calls K7, K8 or K9: their launches on the main state
    launches.update(phase_variants(sim_rmm, smi))
    # the main path with its writers: K1 and K2 launched by it too
    for k, n in phase_main_plugins(sim_rmm, device, smi).items():
        launches[k] += n
    phase_nve(device, smi)
    sim_gen, launches_gen = phase_general(device, smi)
    launches.update(launches_gen)
    phase_multisite_cells(device, smi)
    # K5's launches on the half shell, per path of the kernels line
    half = {}
    sims_ms, launches_ms, half["K5"] = phase_multisite(device, smi)
    launches.update(launches_ms)
    times = phase_times(sim_rmm, sim_gen, smi)
    del sim_rmm, sim_gen
    times.update(phase_times_ms(sims_ms, smi))
    del sims_ms
    phase_longrange_small(device)
    # this slice's path: K5 under SPME's screening, a record of its own
    # (its launches, times and bound all from the water path)
    launches["K5 water"], times["K5 water"], half["K5 water"] = phase_longrange(
        device, smi)
    phase_longrange_solvers(device, smi)
    phase_ensembles_small(device)
    phase_nemd_small(device)
    # this slice's path: K3 on the muVT film, a record of its own
    launches["K3 muVT film"], times["K3 muVT film"] = phase_muvt(device, smi)
    # and K5 on the NEMD film, a record of its own
    launches["K5 NEMD film"], times["K5 NEMD film"], half["K5 NEMD film"] = \
        phase_nemd(device, smi)
    kernels = []
    for key, (name, src, tpu) in {
            **KERNELS, "K5 water": (KERNELS["K5"][0] + " (water, SPME screen_alpha)",
                                    *KERNELS["K5"][1:]),
            "K3 muVT film": (KERNELS["K3"][0] + " (muVT film, general engine)",
                             *KERNELS["K3"][1:]),
            "K5 NEMD film": (KERNELS["K5"][0] + " (NEMD film, two components)",
                             *KERNELS["K5"][1:])}.items():
        check(launches[key] > 0, f"{key} was launched by no path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "engine_caller": key not in NO_ENGINE,
                        "launches": launches[key],
                        **({"half_launches": half[key]} if key in half else {}),
                        **times[key], "library_ms": None})
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
