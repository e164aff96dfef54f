"""Memory usage reporting (the counterpart of
ls1_mardyn_tpu/utils/meminfo.py).

The role of src/io/MemoryProfiler.{h,cpp} (registered objects report
their sizes, printed with --print-meminfo): here host RSS from procfs
plus, per CUDA device, the bytes PyTorch's allocator holds for tensors
and the device's used and total memory (``torch.cuda.mem_get_info``).
"""

from __future__ import annotations

import torch


def host_rss_mib() -> float:
    """Resident set size in MiB (procfs; the reference reads
    /proc/self/status the same way, MemoryProfiler.cpp)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_memory_stats():
    """[(device name, bytes allocated to tensors, bytes in use on the
    device, bytes total)] for every CUDA device; empty without CUDA."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append((f"cuda:{i} {torch.cuda.get_device_name(i)}",
                    int(torch.cuda.memory_allocated(i)), int(total - free),
                    int(total)))
    return out


def print_meminfo(log=None) -> str:
    lines = [f"host RSS: {host_rss_mib():.1f} MiB"]
    for dev, alloc, used, total in device_memory_stats():
        lines.append(
            f"{dev}: {alloc / 2**20:.1f} MiB allocated to tensors, "
            f"{used / 2**20:.1f} / {total / 2**20:.1f} MiB device memory"
        )
    text = "\n".join(lines)
    if log is not None:
        log.info("Memory info:\n%s", text)
    return text
