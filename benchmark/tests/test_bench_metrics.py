"""Metric arithmetic on synthetic traces: the union of device intervals
(overlapping kernels, memcpy, memset), the idle share, launches per
step, the breakdown, and the roofline against hand-counted pairs and
bytes."""

import json

import pytest
import torch

from benchmark import work
from benchmark.harness import metric_readers, load_json, ROOT
from benchmark.reference.pairs import pair_blocks
from benchmark.trace import Trace, breakdown, parse_chrome_trace, union

LJ_CFG = load_json(ROOT, "benchmark", "configs", "lj_liquid_4m.json")
CO2_CFG = load_json(ROOT, "benchmark", "configs", "co2_2cljq_1m.json")


def all_readers():
    spec = load_json(ROOT, "BENCHMARK.json")
    out = {}
    for w in spec["workloads"]:
        out.update({k: r for k, (_, r) in metric_readers(spec, w["name"]).items()})
    return out


def synthetic():
    """Two steps in a 100 us window: K1 0-30 and 40-70 us, an overlapping
    elementwise kernel 20-35, a memcpy 80-85 inside a memset 82-90."""
    device = [("void warp_cells_kernel<float>", "kernel", 0.0, 30.0),
              ("elementwise_kernel", "kernel", 20.0, 35.0),
              ("void warp_cells_kernel<float>", "kernel", 40.0, 70.0),
              ("Memcpy DtoH", "gpu_memcpy", 80.0, 85.0),
              ("Memset", "gpu_memset", 82.0, 90.0)]
    host = [("aten::add", 30.0, 45.0), ("cudaStreamSynchronize", 70.0, 95.0),
            ("aten::item", 72.0, 79.0)]
    return Trace(device=device, host=host, steps=2, window_s=100e-6)


def test_union_merges_overlaps_and_counts_copies():
    t = synthetic()
    assert union(t.device) == [[0.0, 35.0], [40.0, 70.0], [80.0, 90.0]]
    assert t.busy_s == pytest.approx(75e-6)


def test_idle_share_and_launches_per_step():
    t = synthetic()
    r = all_readers()
    assert r["device.idle_share"](t) == pytest.approx(0.25)
    # memcpy and memset are not launches
    assert r["dispatch.launches_per_step"](t) == pytest.approx(1.5)


def test_multisite_twins_read_as_their_1clj_metrics():
    t = synthetic()
    t.work = dict(cfg=CO2_CFG, pairs=1000, n=10, slots=100)
    r = all_readers()
    for name in ("device.idle_share", "dispatch.launches_per_step", "step_mfu"):
        assert r[name + ".multisite"](t) == r[name](t)
    t.device = [("void msk::ms_kernel<float>", "kernel", 0.0, 30.0)] + t.device[1:]
    # busy 75 us, K5 30 us, over 2 steps -> 22.5 us a step
    assert r["general_engine.nonforce_ms.multisite"](t) == pytest.approx(22.5e-3)


def test_nonforce_is_busy_time_outside_the_force_kernel():
    t = synthetic()
    r = all_readers()
    # busy 75 us, K1 60 us, over 2 steps -> 7.5 us a step
    assert r["rmm_engine.nonforce_ms"](t) == pytest.approx(7.5e-3)
    assert r["general_engine.nonforce_ms"](t) == pytest.approx(7.5e-3)


def test_breakdown_names_gaps_by_the_host_op():
    b = breakdown(synthetic())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "void warp_cells_kernel<float>"
    assert b["device_ops"][0][1] == pytest.approx(60e-6)
    # gaps 70-80 (sync 70-95 overlaps all 10 us, item 72-79 7 us) and 35-40
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(10e-6)]
    assert b["idle_gaps"][1] == ["aten::add", pytest.approx(5e-6)]


def test_chrome_trace_parsing():
    obj = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 20.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 9.0, "dur": 2.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
        {"ph": "X", "cat": "python_function", "name": "f", "ts": 0.0, "dur": 50.0}]}
    device, host = parse_chrome_trace(json.loads(json.dumps(obj)))
    assert device == [("k", "kernel", 10.0, 15.0), ("m", "gpu_memset", 20.0, 21.0)]
    assert host == [("aten::mul", 9.0, 11.0)]


def line_state():
    """Five molecules in a box of 10 (rc 2.5): 0-1 at 1.0, 1-2 at 2.0,
    0-2 at 3.0 (out), 3-4 at 2.4 across the periodic boundary, and no
    other pair within 2.5: three hand-counted pairs."""
    r = torch.tensor([[1.0, 1.0, 1.0], [2.0, 1.0, 1.0], [4.0, 1.0, 1.0],
                      [9.0, 6.0, 6.0], [1.4, 6.0, 6.0]], dtype=torch.float64)
    return r, torch.full((3,), 10.0, dtype=torch.float64)


def test_pairs_hand_counted():
    r, box = line_state()
    got = sum(len(i) for i, _, _ in pair_blocks(r, box, 2.5))
    assert got == 3


def test_roofline_against_hand_counted_pairs_and_bytes():
    # 3 pairs of the line state; a kernel grid of 4x4x4 cells, cap 8
    slots, n, pairs = 4 * 4 * 4 * 8, 5, 3
    t = synthetic()
    t.work = dict(cfg=LJ_CFG, pairs=pairs, n=n, slots=slots)
    # bytes: a flag per slot, xyz per molecule, 3 force planes per slot
    nbytes = 4 * (slots + 3 * n + 3 * slots)
    ops = 25 * pairs
    bound = max(nbytes / 3.35e12, ops / 67e12)
    assert work.bound_s(LJ_CFG, t.work) == pytest.approx(bound)
    share = all_readers()["k1_roofline"](t)
    assert share == pytest.approx(100 * bound / 30e-6)
    # 2CLJQ: 4 LJ site pairs and one quadrupole pair, orientations read
    assert work.pair_ops(CO2_CFG) == 4 * 74 + 186 == 482
    nb = 4 * (slots + 7 * n + 9 * slots)
    assert work.force_bytes(CO2_CFG, n, slots) == nb


def test_readers_find_nothing_in_an_empty_trace():
    t = Trace(device=[], host=[], steps=4, window_s=1.0,
              work=dict(cfg=LJ_CFG, pairs=0, n=0, slots=0))
    for name, read in all_readers().items():
        assert read(t) is None, name


def test_step_mfu():
    t = synthetic()
    t.work = dict(cfg=CO2_CFG, pairs=1000, n=10, slots=100)
    assert all_readers()["step_mfu"](t) == pytest.approx(
        100 * 1000 * 482 * 2 / 100e-6 / 67e12)
