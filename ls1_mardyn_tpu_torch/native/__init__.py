"""Native (C++) host components, bound through ctypes (the counterpart
of ls1_mardyn_tpu/native/__init__.py).

Bulk phase-space text I/O (``psio.cpp``) and the LZ4 frame codec
(``lz4f.cpp``) are built with ``g++`` at first use into ``build/native/``
at the repository root (listed in .gitignore), under a name that carries
a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one reused.  Nothing is built into the package directory
and nothing at import time.  Without a toolchain psio falls back to the
Python writer and reader (``get_psio`` returns None), and the LZ4 codec
raises at use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_lock = threading.Lock()
_libs: dict = {}


def _build(name: str) -> ctypes.CDLL:
    """Build (unless a library of the same source and flags exists) and
    load lib<name>.so.  Compiles to a per-process name and renames into
    place, so processes that build at once never load a partial file."""
    src = _DIR / f"{name}.cpp"
    h = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{h}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _get(name: str, bind):
    """The loaded library `name` bound by `bind`, or None when it cannot
    be built or loaded (tried once per process)."""
    with _lock:
        if name not in _libs:
            try:
                lib = _build(name)
                bind(lib)
            except Exception:
                lib = None
            _libs[name] = lib
        return _libs[name]


def _bind_psio(lib):
    lib.psio_read_records.restype = ctypes.c_long
    lib.psio_read_records.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.psio_write_records.restype = ctypes.c_int
    lib.psio_write_records.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
    ]


def _bind_lz4(lib):
    for fn in ("lz4f_compress", "lz4f_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_long
        f.argtypes = [ctypes.c_char_p, ctypes.c_long,
                      ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]


def get_psio():
    """The loaded psio library, or None (the callers' Python fallback)."""
    return _get("psio", _bind_psio)


def get_lz4():
    """The native LZ4-frame codec library, or None."""
    return _get("lz4f", _bind_lz4)


def lz4_compress(data: bytes) -> bytes:
    lib = get_lz4()
    if lib is None:
        raise RuntimeError("native lz4 codec unavailable (g++ missing?)")
    n = len(data)
    cap = 16 + n + n // 255 + (n // (1 << 22) + 1) * 8 + 64
    out = (ctypes.c_uint8 * cap)()
    got = lib.lz4f_compress(data, n, out, cap)
    if got < 0:
        raise RuntimeError("lz4 compression overflow")
    return bytes(bytearray(out)[:got])


def lz4_decompress(data: bytes, max_out: int = 0) -> bytes:
    lib = get_lz4()
    if lib is None:
        raise RuntimeError("native lz4 codec unavailable (g++ missing?)")
    cap = max_out or max(64, 64 * len(data))
    while True:
        out = (ctypes.c_uint8 * cap)()
        got = lib.lz4f_decompress(data, len(data), out, cap)
        if got >= 0:
            return bytes(bytearray(out)[:got])
        if max_out or cap > (1 << 33):
            raise RuntimeError("lz4 decompression failed")
        cap *= 4
