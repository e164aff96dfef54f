"""A torch.profiler window of whole steps and what the per-layer metrics
read from it.

Device activity is every kernel, memcpy and memset of the CUDA trace;
busy time is the length of the union of their intervals (overlapping
kernels count once), so the idle share is 1 - busy / window, with the
window taken by the host clock around the profiled run (which ends in
a synchronize).  The breakdown lists the device operations that took
the most time by name, and the longest idle gaps between device
intervals, each named by the host operation that overlapped it most
(ties to the shortest, i.e. innermost, one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160  # a kernel's name in the breakdown, cut (templates run long)


@dataclasses.dataclass
class Trace:
    """Device intervals (name, category, start_us, end_us), host
    intervals (name, start_us, end_us), steps and window, and the work
    the benchmark counted on the program's state (work.py)."""

    device: list
    host: list
    steps: int
    window_s: float
    work: dict = dataclasses.field(default_factory=dict)

    @property
    def kernels(self):
        return [e for e in self.device if e[1] == "kernel"]

    def kernel_time_s(self, pattern):
        """(total seconds, launches) of kernels whose name holds pattern."""
        ks = [e for e in self.kernels if pattern in e[0]]
        return sum(e[3] - e[2] for e in ks) * 1e-6, len(ks)

    @property
    def busy_s(self):
        return sum(b - a for a, b in union(self.device)) * 1e-6


def union(events):
    """Merged [start, end] intervals of (name, cat, start, end) events."""
    spans = sorted((e[2], e[3]) for e in events)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse_chrome_trace(obj):
    """(device, host) intervals of a chrome trace's events."""
    device, host = [], []
    for e in obj.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        t0 = float(e["ts"])
        iv = (e.get("name", ""), cat, t0, t0 + float(e["dur"]))
        if cat in DEVICE_CATS:
            device.append(iv)
        elif cat in HOST_CATS:
            host.append((iv[0], iv[2], iv[3]))
    return device, host


def profiled_run(md, steps, print_every, tmpdir):
    """Profile md.run(steps) on the card; returns a Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        md.run(steps=steps, print_every=print_every)
        window = time.perf_counter() - t0
    path = os.path.join(tmpdir, "benchmark_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            device, host = parse_chrome_trace(json.load(f))
    finally:
        os.remove(path)
    return Trace(device=device, host=host, steps=steps, window_s=window)


def breakdown(t: Trace, top=10):
    """{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}; names
    cut to NAME_CHARS characters."""
    by_name = {}
    for name, _, a, b in t.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = union(t.device)
    gaps = sorted(((spans[k][1], spans[k + 1][0]) for k in range(len(spans) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        best, key = "device idle, host op not traced", None
        for name, h0, h1 in t.host:
            ov = min(b, h1) - max(a, h0)
            if ov > 0:
                k = (ov, -(h1 - h0))
                if key is None or k > key:
                    best, key = name, k
        named.append([best, (b - a) * 1e-6])
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops], "idle_gaps": named}


def idle_share(t: Trace):
    """Share of the traced window in which no kernel, memcpy or memset ran
    on the card: 1 - union of device intervals / window."""
    if t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s / t.window_s


def launches_per_step(t: Trace):
    """Device kernel launches per step over the traced window."""
    if not t.steps or not t.kernels:
        return None
    return len(t.kernels) / t.steps
