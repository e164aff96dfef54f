"""Kernel K10's device code on the CPU: csrc/lj_packed.cu (the packed-
pencil half shell on the pieces of csrc/lj_warp.cuh), compiled by g++
under the CUDA emulation shim tools/cuda_emu.h (tools/cuda_emu.py) and
run through the port's own launch code (ops/cuda_packed.launch_lj_packed)
on CPU tensors, against its plain version lj_forces_packed_reference.

A full round of kept j entries meets the group's i by register rotation
(the i and their forces pass through the lanes by shuffles); the last,
partial round adds its reactions with shared-memory atomics; every case
runs both.  Cases: the scenes of tests/test_torch_packed.py
(test_pallas_packed._dense_state, seeds 7 and 11 on 6^3 cells, and the
4^3 one whose tables the JAX package calls infeasible), the RMM engine's
own state (chip_smoke.cut_sim, 4^3 cells) packed at cap 32 and 64 in f64
and f32, with wrap groups at both x ends, chip_smoke's near-rc scene
(pairs within an ulp of rc) in f64 and f32, and a 3^3 grid on which
groups wrap at both ends.  Tolerance: 1e-12 of max|F| and relative on u6
and the virial in f64, 1e-5 in f32.  Every case also holds the pairs
inside the cutoff that the kernel evaluates (a launch with eps24 = 0 and
shift6 = 1, each pair once) to the plain version's count, exactly.

The shim runs a warp's lanes as fibers that switch only at barriers, so
it cannot show a race between lanes; the kernel adds its reactions with
atomics or through shuffles and assumes no lockstep.  Three mutants must
be caught: the own-pencil test j > i turned into j != i (pairs counted
twice), the flush of the last, partial round dropped (reactions lost),
and the wrap passes recentred on the group's base cell instead of one
box length away (pairs across the x wrap lost).
"""

import ctypes
import importlib.util
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_lj  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_packed as PK  # noqa: E402
from test_pallas_packed import _dense_state  # noqa: E402
from test_torch_lj_emu import assert_close  # noqa: E402
from test_torch_packed import LJ  # noqa: E402

torch.set_num_threads(1)

CASES = ["seed7", "seed11", "nd4", "cut32", "cut64", "cut32_f32", "near_rc",
         "near_rc_f32", "nx3"]


def _own_pencil_neq(text):
    """The half shell's pair test j > i turned into j != i."""
    old = "if (dr2 < lj.rc2 && j.w > me.w) {"
    assert text.count(old) == 1
    return text.replace(old, "if (dr2 < lj.rc2 && j.w != me.w) {")


def _no_last_flush(text):
    """The flush of the last, partial round dropped."""
    old = "    flush(re, tail, nst, f, Wp);\n"
    assert text.count(old) == 1
    return text.replace(old, "")


def _wrap_on_cb(text):
    """The wrap passes recentred on cb instead of cb + nx / cb - nx."""
    old = "const int cbj = pass == 0 ? cb : (pass == 1 ? cb + nx : cb - nx);"
    assert text.count(old) == 1
    return text.replace(old, "const int cbj = cb;")


MUTANTS = {"own_neq": _own_pencil_neq, "no_flush": _no_last_flush,
           "wrap_cb": _wrap_on_cb}


@pytest.fixture(scope="module")
def emu_packed(tmp_path_factory):
    """csrc/lj_packed.cu built for the CPU, and its three mutants (skips
    without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernel cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    def build(outdir, edit):
        edits = {"lj_packed.cu": edit} if edit else None
        return emu.build(["lj_packed"], outdir, edits=edits)["lj_packed"]

    variants = {"tree": None, **MUTANTS}
    with ThreadPoolExecutor(len(variants)) as pool:  # one g++ each, at once
        dirs = [tmp_path_factory.mktemp(tag) for tag in variants]
        paths = dict(zip(variants, pool.map(build, dirs, variants.values())))
    return {tag: PK.type_lib(ctypes.CDLL(str(p))) for tag, p in paths.items()}


def use(monkeypatch, lib):
    monkeypatch.setattr(PK, "_lib", lambda: lib)


def _packed(planes, dims, cap, Wp=None):
    """pos4, tab, meta of dense planes [nz, ny, 8, nx*cap] packed into
    pencils (Wp: chip_smoke.packed_views' unless given)."""
    if Wp is None:
        packed, _, _, tab, meta, _, _ = chip_smoke.packed_views(planes, dims, cap)
    else:
        packed, _, occ, starts, cnt, ovf = PK.pack_pencils(
            planes, torch.zeros_like(planes[:, :, :3]), dims[0], cap, Wp)
        assert not bool(ovf)
        tab, meta, _ = PK.build_tables(occ, starts, cnt, nx=dims[0], Wp=Wp)
    return packed[:, :, :4].contiguous(), tab, meta


_CASES = {}


def case_inputs(case):
    """(pos4, tab, meta, kw, lim) of a case: kw the wrapper's keywords
    without the tables."""
    if case not in _CASES:
        f32 = case.endswith("_f32")
        dtype, lim = (torch.float32, 1e-5) if f32 else (torch.float64, 1e-12)
        name = case[:-4] if f32 else case
        if name.startswith("seed") or name == "nd4":
            nd, seed, Wp = (4, 5, 128) if name == "nd4" else (6, int(name[4:]), 256)
            planes, _, _, cap, cl = _dense_state(nd=nd, seed=seed)
            planes = torch.as_tensor(np.array(planes))
            dims, box, lj = (nd,) * 3, (nd * cl,) * 3, LJ
        elif name.startswith("cut"):
            cap = int(name[3:])
            sim = chip_smoke.cut_sim(cap, dtype, "cpu", nd=4)
            planes, dims, box, Wp = sim.state.planes, sim.spec.dims, sim.spec.box, None
            lj = dict(eps24=sim.eps24, sig2=sim.sig2, shift6=sim.shift6,
                      rc2=sim.rc2)
        elif name == "near_rc":
            planes = chip_smoke.check_scenes(32, dtype, "cpu")["near_rc"]
            cap, dims, Wp = 32, (6, 6, 6), None
            box, lj = (6 * chip_smoke.SCENE_CL,) * 3, chip_smoke.SCENE_LJ
        else:  # nx3: 0-9 molecules a cell, so a pencil is one group
            counts = np.random.default_rng(3).integers(0, 10, size=(3, 3, 3))
            planes = chip_smoke.lj_scene((3, 3, 3), 32, chip_smoke.SCENE_CL, counts,
                                         seed=3, near_rc=40, planes=8, dtype=dtype)
            cap, dims, Wp = 32, (3, 3, 3), None
            box, lj = (3 * chip_smoke.SCENE_CL,) * 3, chip_smoke.SCENE_LJ
        pos4, tab, meta = _packed(planes.to(dtype), dims, cap, Wp)
        nx, ny, nz = dims
        kw = dict(nx=nx, ny=ny, nz=nz, Wp=pos4.shape[-1], box=box, **lj)
        _CASES[case] = (pos4, tab, meta, kw, lim)
    return _CASES[case]


def kernel_count(pos4, tab, meta, kw):
    _, part = PK.launch_lj_packed(
        pos4, tab, meta, parts=True, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0))
    return cuda_lj.pairs_from_part(part, halved=False)


def plain_count(pos4, tab, meta, kw):
    return cuda_lj.inside_pairs_reference(
        pos4, kernel="packed", tab=tab, meta=meta,
        **{k: kw[k] for k in ("nx", "ny", "nz", "Wp", "box", "rc2")})


def test_scenes_wrap_at_both_ends():
    """The cut state has groups that take the low and the high wrap
    pass; on the 3^3 grid some group takes both."""
    for case in ("cut32", "nx3"):
        _, _, meta, _, _ = case_inputs(case)
        assert int(meta[:, :, 0, PK.M_ELO].sum()) > 0, case
        assert int(meta[:, :, 0, PK.M_EHI].sum()) > 0, case
    _, _, meta, _, _ = case_inputs("nx3")
    ng, e_lo, e_hi = (meta[:, :, 0, c] for c in (PK.M_NG, PK.M_ELO, PK.M_EHI))
    assert bool(((e_lo > 0) & (e_hi > 0) & (e_lo + e_hi > ng)).any())


@pytest.mark.parametrize("case", CASES)
def test_k10_device_code_matches_plain(emu_packed, monkeypatch, case):
    """K10 with u6/virial (and without, but on the two dense 6^3 scenes)
    against its plain version, and its in-cutoff count against the plain
    version's."""
    use(monkeypatch, emu_packed["tree"])
    pos4, tab, meta, kw, lim = case_inputs(case)
    want = PK.lj_forces_packed_reference(pos4, tab, meta, **kw)
    assert_close(PK.launch_lj_packed(pos4, tab, meta, **kw), want, lim)
    if not case.startswith("seed"):
        f, _, _ = PK.launch_lj_packed(pos4, tab, meta, compute_macro=False, **kw)
        torch.testing.assert_close(f, want[0], rtol=0,
                                   atol=lim * float(want[0].abs().max()))
    assert kernel_count(pos4, tab, meta, kw) == plain_count(pos4, tab, meta, kw) > 0


def test_k10_mutants_caught(emu_packed, monkeypatch):
    """The own-pencil test j != i adds pairs twice; without the last
    flush the reactions of the last round are lost; the wrap passes
    recentred on cb lose the pairs across the x wrap.  Each changes the
    counts or the forces of some case; the shipped kernel passes the
    same checks."""
    caught = {tag: set() for tag in MUTANTS}
    for case in ("near_rc_f32", "nx3"):
        pos4, tab, meta, kw, lim = case_inputs(case)
        want = PK.lj_forces_packed_reference(pos4, tab, meta, compute_macro=False,
                                             **kw)
        n_want = plain_count(pos4, tab, meta, kw)
        scale = float(want[0].abs().max())
        for tag in ("tree", *MUTANTS):
            use(monkeypatch, emu_packed[tag])
            f, _, _ = PK.launch_lj_packed(pos4, tab, meta, compute_macro=False, **kw)
            bad = (kernel_count(pos4, tab, meta, kw) != n_want
                   or float((f - want[0]).abs().max()) > lim * scale)
            if tag == "tree":
                assert not bad, case
            elif bad:
                caught[tag].add(case)
    assert all(caught.values()), caught
