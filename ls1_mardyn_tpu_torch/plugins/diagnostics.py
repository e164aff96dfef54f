"""Diagnostics / tooling plugins (the counterpart of
ls1_mardyn_tpu/plugins/diagnostics.py).

References: src/io/TimerWriter.cpp, src/plugins/SysMonOutput (procfs
system monitor, src/utils/SysMon), src/plugins/MaxCheck.cpp
(velocity limiter), src/plugins/LoadImbalanceThroughSleepPlugin.h
(imbalance injection for LB testing), src/plugins/
VectorizationTuner.cpp (force-kernel microbenchmark feeding TunerLoad
load models).
"""

from __future__ import annotations

import dataclasses
import time as _time

import torch

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory


@PluginFactory.register("TimerWriter")
class TimerWriter(PluginBase):
    """Periodic dump of the hierarchical timer registry
    (TimerWriter.cpp)."""

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        with open(f"{self.output_prefix}.timers", "w") as f:
            f.write(f"# step {step}\n")
            f.write(sim.timers.report() + "\n")


@PluginFactory.register("SysMonOutput")
class SysMonOutput(PluginBase):
    """procfs system monitor (src/io/SysMonOutput.cpp + src/utils/
    SysMon): evaluates configured RPN <expression> entries over
    procfs/sysconf variables at the write frequency and logs each
    expression's [min,max] + peak window like the reference's
    InfoString.  Default expressions mirror the reference examples
    (examples/resilience-test/config.xml:64-66)."""

    def __init__(self, params=None):
        super().__init__(params)
        from ls1_mardyn_tpu_torch.utils.sysmon import SysMon

        self.sysmon = SysMon.get_sysmon()
        exprs = self.params.get("expression")
        if exprs is None:
            exprs = [
                "procloadavg:loadavg1",
                {"label": "Free+BufferRAM [MB]", "#text":
                 "sysinfo:freeram sysinfo:bufferram + "
                 "sysinfo:mem_unit * float 1048576 /"},
            ]
        elif not isinstance(exprs, list):
            exprs = [exprs]
        for e in exprs:
            if isinstance(e, dict):
                self.sysmon.add_expression(
                    e.get("#text", ""), label=e.get("label") or None
                )
            else:
                self.sysmon.add_expression(str(e))

    def _log(self, tag):
        from ls1_mardyn_tpu_torch.utils.logger import global_log

        self.sysmon.update_expression_values()
        global_log.info(
            "%s", self.sysmon.info_string(f"System Monitor ({tag})\n")
        )

    def init(self, sim):
        self._log("initial")

    def end_step(self, sim, step):
        if step % self.write_frequency:
            return
        self._log(f"simulation step {step}")

    def finish(self, sim):
        self._log("final")


@PluginFactory.register("MaxCheck")
class MaxCheck(PluginBase):
    """Velocity limiter (MaxCheck.cpp): clamp |v| above vmax (stabilises
    freshly generated scenes).  Runs on the device, no read; it writes
    the engine's state every `interval` steps, so the driver keeps it
    off the RMM engine."""

    def __init__(self, params=None):
        super().__init__(params)
        self.vmax = float(self.params.get("vmax", 1e30))
        self.interval = int(float(self.params.get("interval", 1)))

    def end_step(self, sim, step):
        if step % self.interval:
            return
        mol = sim.engine.mol
        v2 = torch.sum(mol.v * mol.v, dim=-1)
        scale = torch.where(
            v2 > self.vmax ** 2,
            self.vmax / torch.sqrt(torch.clamp(v2, min=1e-30)), 1.0,
        )
        sim.engine.mol = dataclasses.replace(mol, v=mol.v * scale[:, None])


@PluginFactory.register("LoadImbalanceThroughSleepPlugin")
class LoadImbalanceThroughSleep(PluginBase):
    """Injects artificial host-side load (sleep) to exercise
    load-balancing/timing machinery
    (LoadImbalanceThroughSleepPlugin.h)."""

    def __init__(self, params=None):
        super().__init__(params)
        self.sleep_ms = float(self.params.get("sleepTime", 1.0))

    def end_step(self, sim, step):
        _time.sleep(self.sleep_ms / 1000.0)


@PluginFactory.register("VectorizationTuner")
class VectorizationTuner(PluginBase):
    """Force-kernel microbenchmark (VectorizationTuner.cpp): times the
    general engine at several particle counts on the simulation's device
    and writes a load model table (the reference feeds this to TunerLoad
    for KD-decomposition load balancing)."""

    def __init__(self, params=None):
        super().__init__(params)
        self.counts = [
            int(x) for x in str(
                self.params.get("counts", "1024,4096,16384")
            ).split(",")
        ]

    def init(self, sim):
        from ls1_mardyn_tpu_torch.io.generators import cubic_grid
        from ls1_mardyn_tpu_torch.scene import build_scene
        from ls1_mardyn_tpu_torch.simulation import SimConfig, SingleChipSimulation

        rows = []
        for n in self.counts:
            rho = 0.6
            L = (n / rho) ** (1 / 3)
            data = cubic_grid(n, [L, L, L], 1.0, seed=1)
            data.components = sim.table.components
            mol, pp, table, box = build_scene(
                data, cutoff=sim.config.cutoff, dtype=sim.dtype,
                device=sim.device,
            )
            cfg = SimConfig(dt=0.001, thermostat=False, cell_cap=64,
                            cell_chunk=64)
            s = SingleChipSimulation(mol, pp, box.tolist(), cfg)
            s.prepare_start()
            t0 = _time.perf_counter()
            gv = s.run(3)
            float(gv.upot)  # waits for the device
            dt = (_time.perf_counter() - t0) / 3
            rows.append((n, dt))
        with open(f"{self.output_prefix}.tuner", "w") as f:
            f.write("#N\tseconds_per_step\tupdates_per_second\n")
            for n, dt in rows:
                f.write(f"{n}\t{dt:.6f}\t{n / dt:.4e}\n")
        self.results = rows
