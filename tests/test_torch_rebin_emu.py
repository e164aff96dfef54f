"""Kernel K2's device code on the CPU: csrc/rebin_shift.cu (the hop-code
pass and the gather pass), compiled by g++ under the CUDA emulation shim
tools/cuda_emu.h (tools/cuda_emu.py) and run through the port's own
launch code (ops/cuda_rebin.launch_rebin_shift) on CPU tensors, against
its plain version rebin_shift_reference (the three stages of the JAX
package's RMMSimulation._rebin_shift).

Wherever the overflow flag is clear the output must be BIT-identical, in
f64 and f32, and the flag must always agree.  Cases: states drifted 12
steps by the port, in f64 and f32: tests/test_torch_rebin.py's (4^3
cells, cap 32, no sentinel fill) and chip_smoke.cut_sim's (4^3 cells cut
from the seed, sentinel fill, cap 32 and 64); the first one's columns cut
to grids with an axis of 2 cells and of 1; chip_smoke.rebin_scene (a
share of molecules hopping one cell on each axis, random slots) at caps
96 and 1024 on grids down to 1x2x2 cells.  Overflow: a molecule two cells from its own
latches it; chip_smoke.rebin_stage_overflow_scene overflows cap only after
the x stage, or only after the y stage, and every cell holds at most 20
at the end: the kernel's flag must equal the plain version's and the JAX
RMMSimulation._rebin_shift's.  A mutant that latches only the final
count must be caught by those scenes.
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
from ls1_mardyn_tpu_torch.ops import cuda_rebin as R  # noqa: E402
from test_torch_rebin import _sims, _to_jax  # noqa: E402

torch.set_num_threads(1)


def _final_count_only(text):
    """Overflow latched by the final count only: no x or y stage count."""
    old = "if (lane == 0 && (n > cap || n_xy > cap || n_x > cap))"
    assert text.count(old) == 1
    return text.replace(old, "if (lane == 0 && n > cap)")


@pytest.fixture(scope="module")
def emu_rebin(tmp_path_factory):
    """csrc/rebin_shift.cu built for the CPU, and its mutant (skips
    without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernel cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)

    def build(outdir, edit):
        edits = {"rebin_shift.cu": edit} if edit else None
        return emu.build(["rebin_shift"], outdir, edits=edits)["rebin_shift"]

    variants = {"tree": None, "final_only": _final_count_only}
    with ThreadPoolExecutor(len(variants)) as pool:
        dirs = [tmp_path_factory.mktemp(tag) for tag in variants]
        paths = dict(zip(variants, pool.map(build, dirs, variants.values())))
    return {tag: R.type_lib(ctypes.CDLL(str(p))) for tag, p in paths.items()}


def use(monkeypatch, lib):
    monkeypatch.setattr(R, "_lib", lambda: lib)


_STATES = {}


def drifted(case):
    """(11-column stack, rebin keywords) of a state drifted 12 steps by
    the port: "f64"/"f32", tests/test_torch_rebin.py's (4^3 cells of edge
    2.5, cap 32, no sentinel fill); "sent_f64"/"sent_f32"/"cap64",
    chip_smoke.cut_sim's (4^3 cells of edge 2.9 cut from the seed,
    sentinel fill) at cap 32 or 64."""
    if case not in _STATES:
        if case in ("f64", "f32"):
            sim, _ = _sims(0.8, case)
        else:
            dtype = torch.float32 if case == "sent_f32" else torch.float64
            sim = chip_smoke.cut_sim(64 if case == "cap64" else 32, dtype, "cpu",
                                     nd=4)
            for _ in range(12):
                sim.state, _ = sim._step(sim.state)
        _STATES[case] = (sim._fold(sim.state), dict(
            dims=sim.spec.dims, cap=sim.spec.cap, cell_len=sim.cell_len,
            sentinel=sim.sentinel))
    return _STATES[case]


def case_inputs(case):
    """(big, kw) of a case."""
    if case.startswith("drift_"):
        return drifted(case[6:])
    if case.startswith("cut"):  # the f64 state's columns on a smaller grid
        big, kw = drifted("f64")
        nx, ny, nz = dims = {"cut_x2": (2, 4, 4), "cut_y1z2": (4, 1, 2)}[case]
        return big[:nz, :ny, :, : nx * kw["cap"]].contiguous(), dict(kw, dims=dims)
    cap, dims = {"cap96": (96, (2, 1, 3)), "cap1024": (1024, (1, 2, 2))}[case]
    big = chip_smoke.rebin_scene(dims, cap, torch.float32, "cpu", seed=cap)
    return big, dict(dims=dims, cap=cap, cell_len=chip_smoke.REBIN_CL,
                     sentinel=cap != 96)


CASES = ["drift_f64", "drift_f32", "drift_sent_f64", "drift_sent_f32",
         "drift_cap64", "cut_x2", "cut_y1z2", "cap96", "cap1024"]


def test_drifted_states_cover_both_fills():
    assert not drifted("f64")[1]["sentinel"]
    assert drifted("sent_f32")[1]["sentinel"] and drifted("cap64")[1]["sentinel"]


@pytest.mark.parametrize("case", CASES)
def test_k2_device_code_bit_identical(emu_rebin, monkeypatch, case):
    use(monkeypatch, emu_rebin["tree"])
    big, kw = case_inputs(case)
    oa, fa = R.launch_rebin_shift(big, **kw)
    ob, fb = R.rebin_shift_reference(big, **kw)
    assert not bool(fa) and not bool(fb)
    assert torch.equal(oa, ob)
    # molecules moved: the rebin did work
    assert bool((oa[:, :, 7] != big[:, :, 7]).any())


def test_k2_overflow_on_a_two_cell_hop(emu_rebin, monkeypatch):
    use(monkeypatch, emu_rebin["tree"])
    big, kw = drifted("sent_f64")
    bad = big.clone()
    z, y, lane = [int(i) for i in torch.nonzero(bad[:, :, 3] > 0.5)[0]]
    bad[z, y, 1, lane] -= 2.0 * kw["cell_len"][1]
    assert bool(R.launch_rebin_shift(bad, **kw)[1])
    assert bool(R.rebin_shift_reference(bad, **kw)[1])


@pytest.mark.parametrize("stage", ["x", "y"])
def test_k2_overflow_in_an_intermediate_stage(emu_rebin, monkeypatch, stage):
    """Cell (1,1,1) holds 40 molecules after one stage and none holds
    more than 20 at the end: the three stages latch overflow, and so must
    the kernel; JAX's flag on the same state agrees.  The mutant that
    counts the final cells only misses it."""
    sim, jsim = _sims(0.2, "f64", steps=0)
    kw = dict(dims=sim.spec.dims, cap=sim.spec.cap, cell_len=sim.cell_len,
              sentinel=sim.sentinel)
    big = chip_smoke.rebin_stage_overflow_scene(stage, torch.float64, "cpu",
                                                cap=sim.spec.cap,
                                                cell_len=sim.cell_len)
    st_np = sim.state_numpy()
    st_np["planes"] = big[:, :, :8].numpy().copy()
    st_np["forces"] = big[:, :, 8:].numpy().copy()
    st_np["vcomp"] = np.zeros_like(st_np["forces"])
    st_np["rcomp"] = np.zeros_like(st_np["forces"])
    _, jflag = jsim._rebin_shift(_to_jax(st_np))
    assert bool(jflag)
    assert bool(R.rebin_shift_reference(big, **kw)[1])
    use(monkeypatch, emu_rebin["tree"])
    assert bool(R.launch_rebin_shift(big, **kw)[1])
    use(monkeypatch, emu_rebin["final_only"])
    assert not bool(R.launch_rebin_shift(big, **kw)[1])
