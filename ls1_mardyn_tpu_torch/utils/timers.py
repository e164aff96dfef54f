"""Hierarchical named-timer registry.

The role of TimerProfiler (src/io/TimerProfiler.h:28-80):
named timers with parent/child structure, activate/deactivate, and an
end-of-run report (Simulation.cpp:934-951 registers SIMULATION_LOOP /
DECOMPOSITION / COMPUTATION / FORCE_CALCULATION / ...).

Device work is asynchronous; timers that wrap device calls measure
dispatch+sync only if the caller syncs.  Use `sync_fn` for honest
sections (e.g. lambda: float(x)).
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class Timer:
    def __init__(self, name: str, parent: Optional["Timer"] = None):
        self.name = name
        self.parent = parent
        self.children = []
        self.elapsed = 0.0
        self.count = 0
        self._t0 = None
        self.active = True

    def start(self):
        if self.active:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.active and self._t0 is not None:
            self.elapsed += time.perf_counter() - self._t0
            self.count += 1
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class TimerProfiler:
    def __init__(self):
        self._timers: Dict[str, Timer] = {}
        self.root = Timer("_root")
        self._timers["_root"] = self.root

    def register(self, name: str, parent: str = "_root") -> Timer:
        if name in self._timers:
            return self._timers[name]
        p = self._timers.get(parent, self.root)
        t = Timer(name, p)
        p.children.append(t)
        self._timers[name] = t
        return t

    def __getitem__(self, name: str) -> Timer:
        return self.register(name)

    def set_active(self, name: str, active: bool):
        self.register(name).active = active

    def write_csv(self, path: str):
        """Per-timer timing table as CSV (the TaskTimingProfiler role,
        src/Simulation.cpp:1249-1254 TASKTIMINGPROFILE: per-task
        timelines for gnuplot; here name,seconds,count rows)."""
        with open(path, "w") as f:
            f.write("timer,seconds,count\n")
            for name, t in self._timers.items():
                if name == "_root":
                    continue
                f.write(f"{name},{t.elapsed:.6f},{t.count}\n")

    def report(self) -> str:
        lines = ["Timer report (seconds):"]

        def walk(t: Timer, depth: int):
            if t.name != "_root":
                lines.append(
                    f"{'  ' * depth}{t.name:<32} {t.elapsed:>12.4f}  (n={t.count})"
                )
            for c in t.children:
                walk(c, depth + (t.name != "_root"))

        walk(self.root, 0)
        return "\n".join(lines)
