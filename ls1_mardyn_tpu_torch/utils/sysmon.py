"""System monitor: expression-driven procfs/sysconf sampling.

Re-implementation of src/utils/SysMon.{h,cpp} (the counterpart of
ls1_mardyn_tpu/utils/sysmon.py): a
singleton registry of :class:`~ls1_mardyn_tpu_torch.utils.expression.
Expression` objects whose variables name system metrics by group
("procloadavg:loadavg1", "sysinfo:freeram", "procselfstatm:size", ...).
``update_expression_values`` refreshes exactly the variable groups in
use (SysMon.cpp:61-115), evaluates every expression, and tracks
last/peak min-max pairs; ``info_string`` formats them like the
reference's writeExpressionValues (SysMon.cpp:140-189).

Variable groups (SysMon.cpp:190-530):

- ``sysconf``: PHYS_PAGES / AVPHYS_PAGES / PAGESIZE via os.sysconf
- ``sysinfo``: uptime, loads1/5/15, totalram/freeram/sharedram/
  bufferram, totalswap/freeswap, procs, mem_unit — Python has no
  sysinfo(2), so these are derived from /proc/uptime, /proc/loadavg
  and /proc/meminfo with mem_unit=1 (values in bytes, same unit
  contract as the reference after its mem_unit multiply)
- ``procmeminfo``: every /proc/meminfo row, kB scaled to bytes
- ``procvmstat``: every /proc/vmstat row
- ``procloadavg``: loadavg1/5/15, numschedentexec/exist
- ``procselfstatm``: size/resident/share/text/lib/data (pages)
- ``procselfsched``: "label : value" rows of /proc/self/sched
- ``procselfschedstat``: runningtime/waitingtime/numtasks
- ``procselfstatus``: Vm*/Rss*/Hugetlb* rows, kB scaled to bytes

mallinfo has no portable Python analogue and is intentionally not
provided (expressions naming it keep the variable at 0).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ls1_mardyn_tpu_torch.utils.expression import Expression, VariableSet


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


class SysMon:
    _instance: Optional["SysMon"] = None

    @classmethod
    def get_sysmon(cls) -> "SysMon":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.varset = VariableSet()
        self.expressions: List[Expression] = []
        self._values: List[float] = []
        # per expression: (min, max) of the LAST update and the peak
        self._minmax: List[Tuple[float, float]] = []
        self._minmax_peak: List[Tuple[float, float]] = []
        self._init_minmax: List[bool] = []

    def clear(self):
        self.expressions = []
        self._values = []
        self._minmax = []
        self._minmax_peak = []
        self._init_minmax = []

    def add_expression(self, exprstr: str,
                       label: Optional[str] = None) -> int:
        expr = Expression(exprstr, varset=self.varset, label=label)
        if expr.root is None:
            return -1
        self.expressions.append(expr)
        self._values.append(0.0)
        self._minmax.append((0.0, 0.0))
        self._minmax_peak.append((0.0, 0.0))
        self._init_minmax.append(True)
        return len(self.expressions) - 1

    def num_expressions(self) -> int:
        return len(self.expressions)

    def get_expression_index(self, label: str) -> int:
        for i, e in enumerate(self.expressions):
            if e.label == label:
                return i
        return -1

    def get_expression_value(self, index: int) -> float:
        return self._values[index]

    def get_expression_min_max_peak_values(self, index: int):
        return self._minmax_peak[index]

    # -- variable refresh -------------------------------------------

    def update_expression_values(self, reset_minmax: bool = False):
        if not self.expressions:
            return
        if reset_minmax:
            self._init_minmax = [True] * len(self.expressions)
        vs = self.varset
        if vs.exist_variable_group("sysconf"):
            self._update_sysconf()
        if vs.exist_variable_group("sysinfo"):
            self._update_sysinfo()
        if vs.exist_variable_group("procmeminfo"):
            self._update_procmeminfo()
        if vs.exist_variable_group("procvmstat"):
            self._update_procvmstat()
        if vs.exist_variable_group("procloadavg"):
            self._update_procloadavg()
        if vs.exist_variable_group("procselfstatm"):
            self._update_procselfstatm()
        if vs.exist_variable_group("procselfschedstat"):
            self._update_procselfschedstat()
        if vs.exist_variable_group("procselfsched"):
            self._update_procselfsched()
        if vs.exist_variable_group("procselfstatus"):
            self._update_procselfstatus()
        for i, e in enumerate(self.expressions):
            v = e.evaluate_float()
            self._values[i] = v
            # single-process: the last-update min==max==v (the
            # reference's MPI reduce collapses to this at 1 rank)
            self._minmax[i] = (v, v)
            if self._init_minmax[i]:
                self._minmax_peak[i] = (v, v)
                self._init_minmax[i] = False
            else:
                lo, hi = self._minmax_peak[i]
                self._minmax_peak[i] = (min(lo, v), max(hi, v))

    # -- output ------------------------------------------------------

    def write_expression_values(self, header: str = "",
                                lineprefix: str = "",
                                sep: str = "\t",
                                eol: str = "\n") -> str:
        out = [header]
        for i, e in enumerate(self.expressions):
            out.append(lineprefix + e.label)
            if self._init_minmax[i]:
                out.append(sep + "undefined")
            else:
                lo, hi = self._minmax[i]
                plo, phi = self._minmax_peak[i]
                out.append(f"{sep}[{lo:g},{hi:g}]")
                out.append(f"{sep}[{plo:g},{phi:g}]")
            out.append(eol)
        return "".join(out)

    def info_string(self, header: str = "",
                    lineprefix: str = "\t") -> str:
        return self.write_expression_values(header, lineprefix)

    # -- variable group updaters --------------------------------------

    def _update_sysconf(self):
        for name in ("PHYS_PAGES", "AVPHYS_PAGES", "PAGESIZE"):
            try:
                self.varset.set_variable(
                    "sysconf", name, int(os.sysconf("SC_" + name
                    if name != "PAGESIZE" else "SC_PAGE_SIZE"))
                )
            except (ValueError, OSError):
                pass

    def _update_sysinfo(self):
        up = _read("/proc/uptime")
        if up:
            self.varset.set_variable("sysinfo", "uptime",
                                     float(up.split()[0]))
        la = _read("/proc/loadavg")
        if la:
            p = la.split()
            for name, v in zip(("loads1", "loads5", "loads15"), p[:3]):
                self.varset.set_variable("sysinfo", name, float(v))
        mem = _read("/proc/meminfo")
        if mem:
            kv = {}
            for line in mem.splitlines():
                parts = line.split()
                if len(parts) >= 2 and parts[0].endswith(":"):
                    kv[parts[0][:-1]] = int(parts[1]) * (
                        1024 if len(parts) > 2 and parts[2] == "kB"
                        else 1
                    )
            for name, key in (
                ("totalram", "MemTotal"), ("freeram", "MemFree"),
                ("sharedram", "Shmem"), ("bufferram", "Buffers"),
                ("totalswap", "SwapTotal"), ("freeswap", "SwapFree"),
            ):
                if key in kv:
                    self.varset.set_variable("sysinfo", name, kv[key])
        la = _read("/proc/loadavg")
        if la and "/" in la:
            self.varset.set_variable(
                "sysinfo", "procs",
                int(la.replace("/", " ").split()[4]),
            )
        self.varset.set_variable("sysinfo", "mem_unit", 1)

    def _update_procmeminfo(self):
        txt = _read("/proc/meminfo")
        if not txt:
            return
        for line in txt.splitlines():
            parts = line.split()
            if len(parts) < 2:
                break
            label = parts[0].replace(":", "").replace(" ", "")
            try:
                val = int(parts[1])
            except ValueError:
                break
            if len(parts) > 2 and parts[2] == "kB":
                val *= 1024
            self.varset.set_variable("procmeminfo", label, val)

    def _update_procvmstat(self):
        txt = _read("/proc/vmstat")
        if not txt:
            return
        for line in txt.splitlines():
            parts = line.split()
            if len(parts) < 2:
                break
            try:
                self.varset.set_variable("procvmstat", parts[0],
                                         int(parts[1]))
            except ValueError:
                break

    def _update_procloadavg(self):
        txt = _read("/proc/loadavg")
        if not txt:
            return
        p = txt.replace("/", " ").split()
        if len(p) < 6:
            return
        self.varset.set_variable("procloadavg", "loadavg1", float(p[0]))
        self.varset.set_variable("procloadavg", "loadavg5", float(p[1]))
        self.varset.set_variable("procloadavg", "loadavg15",
                                 float(p[2]))
        self.varset.set_variable("procloadavg", "numschedentexec",
                                 int(p[3]))
        self.varset.set_variable("procloadavg", "numschedentexist",
                                 int(p[4]))

    def _update_procselfstatm(self):
        txt = _read("/proc/self/statm")
        if not txt:
            return
        vals = txt.split()
        for name, v in zip(
            ("size", "resident", "share", "text", "lib", "data"), vals
        ):
            self.varset.set_variable("procselfstatm", name, int(v))

    def _update_procselfsched(self):
        txt = _read("/proc/self/sched")
        if not txt:
            return
        for line in txt.splitlines():
            parts = line.split()
            if len(parts) >= 3 and parts[1] == ":":
                try:
                    self.varset.set_variable("procselfsched", parts[0],
                                             float(parts[2]))
                except ValueError:
                    continue

    def _update_procselfschedstat(self):
        txt = _read("/proc/self/schedstat")
        if not txt:
            return
        p = txt.split()
        if len(p) < 3:
            return
        for name, v in zip(
            ("runningtime", "waitingtime", "numtasks"), p
        ):
            self.varset.set_variable("procselfschedstat", name, int(v))

    def _update_procselfstatus(self):
        txt = _read("/proc/self/status")
        if not txt:
            return
        for line in txt.splitlines():
            parts = line.split()
            if not parts:
                continue
            label = parts[0].replace(":", "").replace(" ", "")
            if not (label.startswith("Vm") or label.startswith("Rss")
                    or label.startswith("Hugetlb")):
                continue
            if len(parts) < 2:
                continue
            try:
                val = int(parts[1])
            except ValueError:
                continue
            if len(parts) > 2 and parts[2] == "kB":
                val *= 1024
            self.varset.set_variable("procselfstatus", label, val)
