"""Build a kernel source of ls1_mardyn_tpu_torch/csrc for the CPU under
the CUDA emulation shim tools/cuda_emu.h, as a shared library with the
source's own C entry points (load it with ctypes and hand it CPU
pointers; the stream argument is ignored).

    python tools/cuda_emu.py ms_packed ms_dense -o /tmp/emu

The source and the csrc headers are copied into the output directory
with two rewrites g++ needs: a launch `kern<<<g, b, smem, st>>>(args)`
becomes `emu::launch(emu::Cfg(g, b, smem, st), kern, args)` and the
dynamic `extern __shared__ ... name[];` array a pointer to the block's
buffer; a `cuda_runtime.h` there includes the shim.  The compilers run
together, one per source.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "ls1_mardyn_tpu_torch" / "csrc"
SHIM = Path(__file__).resolve().parent / "cuda_emu.h"
GXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
             "-fPIC", "-x", "c++"]

# a launch, of a kernel or of a kernel template's specialization
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.+?)>>>\s*\(", re.S)
_DYN_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\]\s*;")


def rewrite(text: str) -> str:
    """The two rewrites of a CUDA source for the shim."""
    text = _DYN_SMEM.sub(
        r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem());", text)
    return _LAUNCH.sub(r"emu::launch(emu::Cfg(\2), \1, ", text)


def prepare(outdir: Path) -> None:
    """Rewritten copies of csrc's sources and headers, and the shim's
    stand-in for <cuda_runtime.h>, in outdir."""
    outdir.mkdir(parents=True, exist_ok=True)
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (outdir / src.name).write_text(rewrite(src.read_text()))
    (outdir / "cuda_runtime.h").write_text(f'#include "{SHIM}"\n')


def build(names, outdir, edits=None) -> dict:
    """Compile csrc/<name>.cu for each name into outdir/lib<name>.so
    (all compilers started together); returns {name: path}.  `edits`
    ({file name: function of its text}) changes the prepared copies
    first, e.g. to build a mutant that a test must catch.  Raises with
    the compiler's output if one fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    outdir = Path(outdir)
    prepare(outdir)
    for fname, edit in (edits or {}).items():
        path = outdir / fname
        path.write_text(edit(path.read_text()))
    procs = {}
    for name in names:
        out = outdir / f"lib{name}.so"
        cmd = [gxx, *GXX_FLAGS, "-I", str(outdir), str(outdir / f"{name}.cu"),
               "-o", str(out)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for csrc/{name}.cu:\n{log[-4000:]}")
        libs[name] = out
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", help="csrc/<name>.cu")
    ap.add_argument("-o", "--outdir", required=True)
    args = ap.parse_args()
    for name, path in build(args.names, args.outdir).items():
        print(name, path)


if __name__ == "__main__":
    main()
