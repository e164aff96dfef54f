"""Kernels K9's and K7's device code on the CPU: csrc/lj_cells_zb.cu
(plain and in the Gram form) and csrc/lj_cells_lanej.cu on the warp
skeleton csrc/lj_warp.cuh, compiled by g++ under the CUDA emulation shim
tools/cuda_emu.h (tools/cuda_emu.py) and run through the port's own
launch code (ops/cuda_lj_variants.launch_lj_cells_zb,
launch_lj_cells_lanej) on CPU tensors, against their plain versions
lj_cell_forces_zb_reference (gram=False and True) and, for K7,
lj_cell_forces_row_reference in cell-local mode on the cells and a
one-cell periodic x halo (K4's j view in cell-local mode).

Cases: the scenes of tests/test_torch_lj_emu.py (sparse cells of 0, 1 and
up to 16 molecules, cap 64, full cells, pairs within an ulp of rc), f32,
an 8-plane tensor read in place, and the RMM engine's own state
(chip_smoke.cut_sim, 4^3 cells) whose empty slots carry the sentinel
fill.  Tolerance: 1e-12 of max|F| and relative on u6 and the virial in
f64, 1e-5 in f32.  Every case also holds the ordered pairs inside the
cutoff that the kernel evaluates (a launch with eps24 = 0 and shift6 = 1)
to the plain version's count, exactly; in the Gram form both count by
the Gram r^2 (inside_pairs_reference(kernel="zb_gram")).  K7's `defer`
(the TPU kernel's place of its lane reduction) must not change a bit.

The Gram form's box cull keeps a margin (csrc/lj_warp.cuh), because the
Gram r^2 can come out below the true distance.  A mutant built with a
margin of 0 drops pairs that the plain Gram version counts: the test
shows that the near-rc scenes catch it and the others do not.
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

from ls1_mardyn_tpu_torch.ops import cuda_lj  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V  # noqa: E402
from test_torch_lj_emu import assert_close, case_inputs  # noqa: E402

torch.set_num_threads(1)


def _margin_zero(text):
    """lj_warp.cuh with the Gram cull's margin factor kappa set to 0."""
    out = text.replace("return T(0x1p-18);", "return T(0);").replace(
        "return T(0x1p-47);", "return T(0);")
    assert out.count("return T(0);") == 2
    return out


@pytest.fixture(scope="module")
def emu_zb(tmp_path_factory):
    """csrc/lj_cells_zb.cu built for the CPU, and its margin-0 mutant
    (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernel cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    libs = {}
    for tag, edits in (("tree", None), ("margin0", {"lj_warp.cuh": _margin_zero})):
        path = emu.build(["lj_cells_zb"], tmp_path_factory.mktemp(tag),
                         edits=edits)["lj_cells_zb"]
        libs[tag] = cuda_lj.type_lib(ctypes.CDLL(str(path)), "lj_cells_zb")
    return libs


@pytest.fixture(scope="module")
def emu_lanej(tmp_path_factory):
    """csrc/lj_cells_lanej.cu built for the CPU (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernel cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    path = emu.build(["lj_cells_lanej"],
                     tmp_path_factory.mktemp("lanej"))["lj_cells_lanej"]
    return cuda_lj.type_lib(ctypes.CDLL(str(path)), "lj_cells_lanej")


def use(monkeypatch, lib):
    """The port's launch code, loading `lib` for csrc/lj_cells_zb.cu."""
    monkeypatch.setattr(cuda_lj, "_lib", lambda name: lib)


def kernel_count(r4, kw, gram):
    _, part = V.launch_lj_cells_zb(
        r4, gram=gram, parts=True, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0))
    return cuda_lj.pairs_from_part(part)


def plain_count(r4, kw, gram):
    return cuda_lj.inside_pairs_reference(
        r4, kernel="zb_gram" if gram else "zb", dims=kw["dims"], cap=kw["cap"],
        cell_len=kw["cell_len"], rc2=kw["rc2"])


@pytest.mark.parametrize("gram", [False, True], ids=["zb", "gram"])
@pytest.mark.parametrize("case", ["sparse32", "sparse64", "full32", "near_rc",
                                  "near_rc_f32", "sparse32_f32", "planes8",
                                  "rmm_state", "cap96"])
def test_k9_device_code_matches_plain(emu_zb, monkeypatch, case, gram):
    """K9 with and without u6/virial against its plain version, and its
    in-cutoff count against the plain version's (the Gram r^2's in the
    Gram form)."""
    use(monkeypatch, emu_zb["tree"])
    r4, kw, lim = case_inputs(case)
    assert r4.is_contiguous() == (case not in ("planes8", "rmm_state"))
    want = V.lj_cell_forces_zb_reference(r4, gram=gram, **kw)
    assert_close(V.launch_lj_cells_zb(r4, gram=gram, **kw), want, lim)
    f, _, _ = V.launch_lj_cells_zb(r4, gram=gram, compute_macro=False, **kw)
    torch.testing.assert_close(f, want[0], rtol=0,
                               atol=lim * float(want[0].abs().max()))
    assert kernel_count(r4, kw, gram) == plain_count(r4, kw, gram) > 0


def test_gram_margin_zero_mutant_caught_only_near_rc(emu_zb, monkeypatch):
    """The Gram cull without its margin drops pairs whose Gram r^2 falls
    below rc^2 while their box distance does not: only the scenes with
    pairs within an ulp of rc show it, in f64 and f32, and the shipped
    margin keeps every count."""
    cases = ("sparse32", "sparse64", "full32", "near_rc", "sparse32_f32",
             "near_rc_f32")
    caught = set()
    for case in cases:
        r4, kw, _ = case_inputs(case)
        want = plain_count(r4, kw, True)
        use(monkeypatch, emu_zb["tree"])
        assert kernel_count(r4, kw, True) == want
        use(monkeypatch, emu_zb["margin0"])
        got = kernel_count(r4, kw, True)
        assert got <= want
        if got != want:
            caught.add(case)
    assert caught == {"near_rc", "near_rc_f32"}


def row_inputs(case):
    """(r_i, r_j, kw, lim) of K7 on a case: the contiguous i planes, the
    j view with one periodic x halo cell per side, and K4's cell-local
    arguments."""
    r4, kw, lim = case_inputs(case)
    nx, cap = kw["dims"][0], kw["cap"]
    r_i = r4.contiguous()
    r_j = torch.cat([r_i[..., (nx - 1) * cap:], r_i, r_i[..., :cap]], -1)
    box = tuple(c * d for c, d in zip(kw.pop("cell_len"), kw["dims"]))
    return r_i, r_j, dict(kw, box=box), lim


@pytest.mark.parametrize("case", ["sparse32", "sparse64", "full32", "near_rc",
                                  "near_rc_f32", "sparse32_f32", "planes8",
                                  "rmm_state", "cap96"])
def test_k7_device_code_matches_plain(emu_lanej, monkeypatch, case):
    """K7 with and without u6/virial against K4's plain version in
    cell-local mode, its in-cutoff count against the plain version's,
    and both values of `defer` bit-identical."""
    use(monkeypatch, emu_lanej)
    r_i, r_j, kw, lim = row_inputs(case)
    want = cuda_lj.lj_cell_forces_row_reference(r_i, r_j, local_coords=True, **kw)
    got = V.launch_lj_cells_lanej(r_i, r_j, defer=True, **kw)
    assert_close(got, want, lim)
    other = V.launch_lj_cells_lanej(r_i, r_j, defer=False, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, other))
    f, _, _ = V.launch_lj_cells_lanej(r_i, r_j, compute_macro=False, **kw)
    torch.testing.assert_close(f, want[0], rtol=0,
                               atol=lim * float(want[0].abs().max()))
    _, part = V.launch_lj_cells_lanej(
        r_i, r_j, parts=True, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0))
    assert cuda_lj.pairs_from_part(part) == cuda_lj.inside_pairs_reference(
        r_i, r_j, kernel="lanej", dims=kw["dims"], cap=kw["cap"], box=kw["box"],
        rc2=kw["rc2"]) > 0
