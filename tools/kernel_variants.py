"""Kernel libraries of several source trees side by side, for the timing
tools tools/lj_kernel_times.py and tools/ms_kernel_times.py.

A variant is `TAG=DIR[:FLAGS]`: DIR a copy of ls1_mardyn_tpu_torch/csrc
(e.g. a parent commit's, from `git archive`, or an edited copy) and,
after a colon, comma-separated extra nvcc flags.  Each library of each
variant is built with the port's nvcc flags into
build/kernels/variants/<tag>/, one nvcc per source, all started
together; `use` puts a variant's libraries in place of the checkout's
in ops/_build.py's cache, so the port's wrappers launch them (a variant
must keep the wrappers' C signature).
"""

import ctypes
import json
import subprocess
from pathlib import Path

import chip_smoke as cs


def parse(specs, default_src):
    """{tag: (src, [flags])} of the `TAG=DIR[:FLAGS]` strings; the
    checkout's own csrc (`default_src`) as tag "tree" if there are
    none."""
    variants = {}
    for spec in specs or [f"tree={default_src}"]:
        tag, rest = spec.split("=", 1)
        src, _, flags = rest.partition(":")
        variants[tag] = (src, [f for f in flags.split(",") if f])
    return variants


def build(variants, libs):
    """{tag: {lib: CDLL}} of csrc/<lib>.cu for each lib of `libs`, built
    from each variant's sources and flags; prints the ptxas reports
    (registers, spills, shared memory)."""
    from ls1_mardyn_tpu_torch.ops import _build

    procs = {}
    for tag, (src, flags) in variants.items():
        out = _build.BUILD_DIR / "variants" / tag
        out.mkdir(parents=True, exist_ok=True)
        for lib in libs:
            so = out / f"lib{lib}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
                   str(Path(src) / f"{lib}.cu")]
            procs[tag, lib] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for (tag, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}/{lib}.cu:\n{log[-4000:]}")
        so.with_suffix(".log").write_text(log)
        built.setdefault(tag, {})[lib] = ctypes.CDLL(str(so))
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        cs.say("ptxas", variant=tag, lib=lib, report=json.dumps(regs))
    return built


def use(libs):
    """Make the port's wrappers launch these libraries ({lib: CDLL})."""
    from ls1_mardyn_tpu_torch.ops import _build

    for lib, cdll in libs.items():
        _build._LOADED[lib] = cdll
