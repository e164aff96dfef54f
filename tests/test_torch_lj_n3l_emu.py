"""Kernel K8's device code on the CPU: csrc/lj_cells_n3l.cu (Newton's
third law by the half shell on the warp skeleton csrc/lj_warp.cuh),
compiled by g++ under the CUDA emulation shim tools/cuda_emu.h
(tools/cuda_emu.py) and run through the port's own launch code
(ops/cuda_lj_variants.launch_lj_cells_n3l) on CPU tensors, against its
plain version lj_cell_forces_n3l_reference.

A full round of j slots passes its reactions through the lanes by
shuffles, the last, partial round adds them with shared-memory atomics;
every case runs both.  Cases: the scenes of tests/test_torch_lj_emu.py
(sparse cells of 0, 1 and up to 16 molecules, cap 64, full cells on
3x3x3, pairs within an ulp of rc), f32, an 8-plane tensor read in place,
the RMM engine's own state (chip_smoke.cut_sim, 4^3 cells), cap 96 (three
warps share the own cell) and 3x3x3 cells cut from the sparse scene.
Tolerance: 1e-12 of max|F| and relative on u6 and the virial in f64,
1e-5 in f32.  Every case also holds the unordered pairs inside the
cutoff that the kernel evaluates (a launch with eps24 = 0 and
shift6 = 1) to the plain version's count, exactly.

The shim runs a warp's lanes as fibers that switch only at barriers, so
it cannot show a race between lanes; the kernel adds its reactions with
atomics or through shuffles and assumes no lockstep.  Two mutants must
be caught: the own-cell test j > i turned into j != i (pairs counted
twice), and the flush of the last, partial round of j slots dropped
(reactions lost).
"""

import ctypes
import importlib.util
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_lj  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V  # noqa: E402
from test_torch_lj_emu import assert_close  # noqa: E402
from test_torch_lj_variants_emu import case_inputs, use  # noqa: E402

torch.set_num_threads(1)

CASES = ["sparse32", "sparse64", "full32", "near_rc", "near_rc_f32",
         "sparse32_f32", "planes8", "rmm_state", "cap96", "sub3"]


def _own_cell_neq(text):
    """The half shell's pair test j > i (lj_warp.cuh's half_pair) turned
    into j != i."""
    old = "if (dr2 < lj.rc2 && j.w > me.w) {"
    assert text.count(old) == 1
    return text.replace(old, "if (dr2 < lj.rc2 && j.w != me.w) {")


def _no_last_flush(text):
    """The flush of the last, partial round (lj_warp.cuh's half_shell,
    the kernel body K8 shares with K1) dropped."""
    old = "      flush(re, head - cnt, cnt, f, W);\n"
    assert text.count(old) == 1
    return text.replace(old, "")


@pytest.fixture(scope="module")
def emu_n3l(tmp_path_factory):
    """csrc/lj_cells_n3l.cu built for the CPU, and its two mutants (skips
    without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernel cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    libs = {}
    for tag, edit in (("tree", None), ("own_neq", _own_cell_neq),
                      ("no_flush", _no_last_flush)):
        edits = {"lj_warp.cuh": edit} if edit else None
        path = emu.build(["lj_cells_n3l"], tmp_path_factory.mktemp(tag),
                         edits=edits)["lj_cells_n3l"]
        libs[tag] = cuda_lj.type_lib(ctypes.CDLL(str(path)), "lj_cells_n3l")
    return libs


def n3l_inputs(case):
    """(r4, kw, lim) of a case (test_torch_lj_variants_emu.case_inputs),
    and "sub3": the first 3x3x3 cells of the sparse scene as a periodic
    grid of their own."""
    if case == "sub3":
        r4, kw, lim = case_inputs("sparse32")
        r4 = chip_smoke.sub_block(r4, kw["cap"], 3, 3, 3)
        return r4, dict(kw, dims=(3, 3, 3)), lim
    return case_inputs(case)


def kernel_count(r4, kw):
    _, part = V.launch_lj_cells_n3l(
        r4, parts=True, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0))
    return cuda_lj.pairs_from_part(part, halved=False)


def plain_count(r4, kw):
    return cuda_lj.inside_pairs_reference(
        r4, kernel="n3l", dims=kw["dims"], cap=kw["cap"],
        cell_len=kw["cell_len"], rc2=kw["rc2"])


@pytest.mark.parametrize("case", CASES)
def test_k8_device_code_matches_plain(emu_n3l, monkeypatch, case):
    """K8 with and without u6/virial against its plain version, and its
    unordered in-cutoff count against the plain version's."""
    use(monkeypatch, emu_n3l["tree"])
    r4, kw, lim = n3l_inputs(case)
    want = V.lj_cell_forces_n3l_reference(r4, **kw)
    assert_close(V.launch_lj_cells_n3l(r4, **kw), want, lim)
    f, _, _ = V.launch_lj_cells_n3l(r4, compute_macro=False, **kw)
    torch.testing.assert_close(f, want[0], rtol=0,
                               atol=lim * float(want[0].abs().max()))
    assert kernel_count(r4, kw) == plain_count(r4, kw) > 0


def test_k8_mutants_caught(emu_n3l, monkeypatch):
    """The own-cell test j != i adds own-cell pairs twice: the counts of
    every case with three or more close molecules in a cell differ.
    Without the last flush the reactions of the last round are lost: the
    forces differ.  The shipped kernel passes both checks on the same
    cases."""
    caught = {"own_neq": set(), "no_flush": set()}
    for case in ("sparse32", "full32", "near_rc_f32"):
        r4, kw, lim = n3l_inputs(case)
        want = V.lj_cell_forces_n3l_reference(r4, **kw)
        n_want = plain_count(r4, kw)
        scale = float(want[0].abs().max())
        for tag in ("tree", "own_neq", "no_flush"):
            use(monkeypatch, emu_n3l[tag])
            f, _, _ = V.launch_lj_cells_n3l(r4, compute_macro=False, **kw)
            bad = (kernel_count(r4, kw) != n_want
                   or float((f - want[0]).abs().max()) > lim * scale)
            if tag == "tree":
                assert not bad, case
            elif bad:
                caught[tag].add(case)
    assert caught["own_neq"] and caught["no_flush"], caught
