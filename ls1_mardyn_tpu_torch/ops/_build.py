"""Builds the package's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain C interface, loaded through ctypes.
The library lands in ``build/kernels/`` at the repository root (listed
in .gitignore) under a name that carries a hash of the source text, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused within a checkout.  ``load``
builds one library at first use; ``build_all`` starts one ``nvcc`` per
source at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# no --use_fast_math: the rebin must stay bit-identical to its plain
# version, and the force kernel has no approximate-reciprocal mode
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: dict = {}
_LOCK = threading.Lock()
# seconds spent in nvcc by this process, per library (build report)
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "ls1_mardyn_tpu_torch are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str, out: Path):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp, t0, cmd)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter(), cmd


def _finish(name: str, out: Path, started) -> None:
    proc, tmp, t0, cmd = started
    stdout, stderr = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (see {log}):\n" + stderr[-4000:]
        )
    os.replace(tmp, out)


def build_all(names) -> None:
    """Build every missing library of `names`, one nvcc each, all
    started together."""
    with _LOCK:
        todo = {n: library_path(n) for n in names}
        started = {n: _start(n, out) for n, out in todo.items()
                   if not out.exists()}
        for n, st in started.items():
            _finish(n, todo[n], st)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        out = library_path(name)
        if not out.exists():
            _finish(name, out, _start(name, out))
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the
    library this checkout builds for csrc/<name>.cu, or ''."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def stream_of(lib: ctypes.CDLL, t, what: str):
    """The stream argument of a launch of `lib` on tensor `t`: PyTorch's
    current stream on t's card.  A CPU tensor is taken only by a library
    built for the CPU under tools/cuda_emu.h (which exports
    cuda_emu_host_build and ignores the stream): None.  Raises for a CPU
    tensor and a library built by nvcc, whose kernel would be handed
    host pointers."""
    if t.device.type == "cuda":
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream
    if t.device.type == "cpu" and hasattr(lib, "cuda_emu_host_build"):
        return None
    raise ValueError(f"{what}: a {t.device} tensor for a library built for "
                     "the card")


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
