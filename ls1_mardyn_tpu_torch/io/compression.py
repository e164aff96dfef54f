"""Transparent output compression for writers.

The role of src/plugins/compression.{h,cpp} (lz4/gzip
stream wrappers selected by a 'compression' tag): here a single
open_compressed() that picks the codec from the requested extension.
gzip/bz2/xz come from the standard library; lz4 uses the package's
own NATIVE frame codec (native/lz4f.cpp, standard LZ4 frame format),
so the package needs neither liblz4 nor python-lz4.  The counterpart
of ls1_mardyn_tpu/io/compression.py.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma


class _LZ4File(io.RawIOBase):
    """Whole-file LZ4-frame wrapper over the native codec (buffered in
    memory; writer outputs are modest per file)."""

    def __init__(self, path: str, mode: str):
        self._path = path
        self._writing = "w" in mode or "a" in mode
        self._buf = io.BytesIO()
        if not self._writing:
            from ls1_mardyn_tpu_torch.native import lz4_decompress

            with open(path, "rb") as f:
                self._buf = io.BytesIO(lz4_decompress(f.read()))

    def write(self, b):
        return self._buf.write(b)

    def read(self, n=-1):
        return self._buf.read(n)

    def readable(self):
        return not self._writing

    def writable(self):
        return self._writing

    def close(self):
        if self._writing and not self.closed:
            from ls1_mardyn_tpu_torch.native import lz4_compress

            with open(self._path, "wb") as f:
                f.write(lz4_compress(self._buf.getvalue()))
        super().close()


def _open_lz4(path: str, mode: str):
    raw = _LZ4File(path, mode)
    if "b" in mode:
        return raw
    return io.TextIOWrapper(raw)


def open_compressed(path: str, mode: str = "wt", compression: str = "auto"):
    """Open `path` with the codec named by `compression` ('none',
    'gzip', 'bz2', 'xz', 'lz4') or inferred from the extension when
    'auto'.  Returns a file object usable like open()'s."""
    if compression == "auto":
        if path.endswith(".gz"):
            compression = "gzip"
        elif path.endswith(".bz2"):
            compression = "bz2"
        elif path.endswith(".xz"):
            compression = "xz"
        elif path.endswith(".lz4"):
            compression = "lz4"
        else:
            compression = "none"
    if compression == "none":
        return open(path, mode)
    if compression == "gzip":
        return gzip.open(path, mode)
    if compression == "bz2":
        return bz2.open(path, mode)
    if compression == "xz":
        return lzma.open(path, mode)
    if compression == "lz4":
        return _open_lz4(path, mode)
    raise ValueError(f"unknown compression '{compression}'")
