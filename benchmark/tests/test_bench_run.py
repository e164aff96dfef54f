"""Whole runs on the CPU at a small size (the program's plain versions
stand in for its CUDA kernels; the harness's look for a card is
skipped): a sound run is correct, each fault a cell can have, planted
under the timed path, makes `correct` false, and so does the control,
the reference put in the program's place in bfloat16.  Without a card
the command fails and prints no result.  On a card, the control at a
small size fails while the program passes."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import check, harness
from benchmark.control import readings

SMALL = {"lj_liquid_4m.rmm": 5000, "co2_2cljq_1m.nvt": 4000, "lj_liquid_4m.general": 5000}
CELLS = list(SMALL)


def small(cell, n=None):
    def edit(cfg, traffic, c):
        cfg["n"] = n or SMALL[cell]
        cfg["start"] = {"kind": "lattice"}
        cfg["cutoff"] = min(cfg["cutoff"], 2.5)
        traffic["cell_cap"] = 0
        c["warm_steps"] = 2
    return edit


def run_small(cell, seed=2 ** 31 + 5):
    return harness.run_cell(cell, seed, 0.3, False, device="cpu", edit=small(cell))


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
         "lj_liquid_4m.rmm", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=120)
    if out.returncode == 0:
        pytest.skip("a CUDA device is visible here")
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "no CPU fallback" in out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    rate = harness.find_cell(cell)[4]["rate_metric"]
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["metrics"][rate]["value"] > 0 and res["steps"] > 0


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation
    from ls1_mardyn_tpu_torch.simulation import SingleChipSimulation

    rmm_step, gen_step = RMMSimulation._step, SingleChipSimulation._step
    monkeypatch.setattr(RMMSimulation, "_step", lambda self, st, compute_macro=True:
                        (st, rmm_step(self, st, compute_macro)[1]))
    monkeypatch.setattr(SingleChipSimulation, "_step", lambda self, mol, forces, step:
                        (mol, forces) + gen_step(self, mol, forces, step)[2:])


def _forces(monkeypatch, fault):
    """Plant `fault` on the forces every force path produces: fault(F)
    changes F [molecules, 3] in place."""
    from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import CudaMultiSitePackedPath
    from ls1_mardyn_tpu_torch.ops.lj_path import CudaLJPath
    from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation

    kernel = RMMSimulation._kernel

    def rmm(self, planes, compute_macro=True):
        f, u6, vir = kernel(self, planes, compute_macro)
        f = f.permute(0, 1, 3, 2).clone()  # [nz, ny, slots, 3]
        valid = planes[:, :, 3, :] > 0.5
        flat = f[valid]
        fault(flat)
        f[valid] = flat
        return f.permute(0, 1, 3, 2).contiguous(), u6, vir

    monkeypatch.setattr(RMMSimulation, "_kernel", rmm)
    for cls in (CudaLJPath, CudaMultiSitePackedPath):
        call = cls.__call__

        def general(self, mol, _call=call):
            forces, macro, overflow = _call(self, mol)
            F = forces.F[mol.valid]
            fault(F)
            forces.F[mol.valid] = F
            return forces, macro, overflow

        monkeypatch.setattr(cls, "__call__", general)


def _half(F):
    """Half of the batch left out: every other molecule gets no force."""
    F[::2] = 0.0


def _altered(F):
    """One answer altered where it is produced: one molecule's force."""
    F[len(F) // 2, 0] += F.abs().max()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_makes_correct_false(cell, fault, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    else:
        _forces(monkeypatch, {"half": _half, "altered": _altered}[fault])
    res = run_small(cell)
    assert not res["correct"], res["checks"]


def test_rebin_fault_makes_correct_false(monkeypatch):
    """The RMM engine's shift rebin (K2) hops one molecule a cell edge
    too far, keeping every id: the checked step begins with a rebin, so
    the displacement shows."""
    from ls1_mardyn_tpu_torch.ops.rmm import RMMSimulation

    shift = RMMSimulation._rebin_shift
    hops = []

    def rebin(self, st):
        st2, overflow = shift(self, st)
        valid = torch.nonzero(st2.planes[:, :, 3, :] > 0.5)
        z, y, lane = valid[len(valid) // 2].tolist()
        st2.planes[z, y, 0, lane] += self.cell_len[0]
        hops.append(self._k)
        return st2, overflow

    monkeypatch.setattr(RMMSimulation, "_rebin_shift", rebin)
    res = run_small("lj_liquid_4m.rmm")
    assert hops and not res["correct"], res["checks"]
    assert res["checks"]["step_r"]["value"] > res["checks"]["step_r"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    rec = next(readings(cell, [7], {7}, 2, device="cpu", edit=small(cell)))
    limits = harness.find_cell(cell)[4]["limits"]
    assert check.verdict(rec["program"], limits)[1], rec["program"]
    assert not check.verdict(rec["control"], limits)[1], rec["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    """The control at a small size on the card: the program within every
    limit, the bfloat16 reference in its place outside one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    harness.cache_env()
    for rec in readings(cell, [11, 12, 13], {11, 12, 13}, 20, device="cuda",
                        edit=small(cell, n=60000)):
        limits = harness.find_cell(cell)[4]["limits"]
        assert check.verdict(rec["program"], limits)[1], json.dumps(rec)
        assert not check.verdict(rec["control"], limits)[1], json.dumps(rec)
