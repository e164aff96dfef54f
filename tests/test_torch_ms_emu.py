"""The multi-site kernels' device code on the CPU: csrc/ms_packed.cu (K5)
and csrc/ms_dense.cu (K6), with their shared skeleton csrc/ms_pair.cuh,
compiled by g++ under the CUDA emulation shim tools/cuda_emu.h
(tools/cuda_emu.py) and run through the port's own launch code
(ops/cuda_ms.launch_dense, ops/cuda_ms_packed.launch_packed) on CPU
tensors, against the plain versions multisite_cell_forces_reference and
multisite_cell_forces_packed_reference, f64.

It checks what only the kernels do: the warp windows, the per-lane
in-cutoff lists, their flattening into rounds of 32 pairs and the
segmented reduction back to the owner lanes, and the one-rsqrt site
arithmetic.  Scenes: 3 x 3 x 3 cells (rc 3): the two-component mixture
with all seven bodies ("mix"), the erfc-screened water-like scene
("water"), explicit z halo rows (K5) and y + z halo rows (K6, which must
give the wrapped result bit for bit).  Tolerance: 1e-12 of each output's
max (F, M, Vi; u6, uX and myRF relative), the card's f64 limit; the
emulation's 1/sqrt stands in for the card's rsqrt.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.models.components import Component
from ls1_mardyn_tpu_torch.ops import cuda_ms
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec
from ls1_mardyn_tpu_torch.ops.cuda_ms import (
    launch_dense,
    multisite_cell_forces_reference,
)
from ls1_mardyn_tpu_torch.ops.cuda_ms_packed import (
    CudaMultiSitePackedPath,
    launch_packed,
    multisite_cell_forces_packed_reference,
)
from ls1_mardyn_tpu_torch.ops.ms_path import CudaMultiSitePath
from ls1_mardyn_tpu_torch.scene import build_scene
from test_torch_ms_kernels import _yz_halo, components, lattice

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 1e-12


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    """csrc/ms_packed.cu and ms_dense.cu built for the CPU (skips without
    g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernels cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    paths = emu.build(["ms_packed", "ms_dense"],
                      tmp_path_factory.mktemp("cuda_emu"))
    return {n: cuda_ms.type_lib(ctypes.CDLL(str(p)), n)
            for n, p in paths.items()}


@pytest.fixture
def on_emu(emu_libs, monkeypatch):
    """The port's launch code, loading the CPU builds."""
    monkeypatch.setattr(cuda_ms, "_lib", emu_libs.__getitem__)


def port_scene(kind, n, seed):
    """About n molecules of a scene kind in a 9^3 box (3 cells of rc 3 a
    side), random orientations: (mol, table, box), f64 on the CPU."""
    r, box = lattice(n, 9.0, seed)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(len(r), 4))
    comps = components(kind, Component)
    K = len(comps)
    m = len(r)
    data = PhaseSpaceData(
        components=comps, mixing_xi=np.ones((K, K)), mixing_eta=np.ones((K, K)),
        eps_rf=5.0, box=box, temperature=1.0, current_time=0.0,
        mid=np.arange(1, m + 1), cid=(np.arange(m) % K).astype(np.int32), r=r,
        v=np.zeros((m, 3)), q=q / np.linalg.norm(q, axis=1, keepdims=True),
        L=np.zeros((m, 3)))
    mol, _, table, boxt = build_scene(data, cutoff=3.0, dtype=torch.float64,
                                      device="cpu")
    return mol, table, boxt.numpy()


def assert_close(got, want):
    """F, M, Vi within LIMIT of their max; u6, uX, myRF relative."""
    for tag, sl in (("F", slice(0, 3)), ("M", slice(3, 6)), ("Vi", slice(6, 9))):
        ref = want[0][:, :, sl]
        scale = float(ref.abs().max())
        assert scale > 0, tag
        err = float((got[0][:, :, sl] - ref).abs().max()) / scale
        assert err <= LIMIT, (tag, err)
    assert float(got[0][:, :, 9].abs().max()) == 0.0
    for tag, a, b in zip(("u6", "uX", "myRF"), got[1:], want[1:]):
        a, b = float(a), float(b)
        assert abs(a - b) <= LIMIT * max(abs(b), 1e-300), (tag, a, b)


@pytest.mark.parametrize("case", ["mix", "water", "z_halo"])
def test_k5_device_code_matches_plain(on_emu, case):
    """K5 against its plain version: the mixture (cap 32), the screened
    water-like scene (cap 48), and the middle z row of a packed build
    against its three rows as explicit halo rows."""
    kind, n, cap, alpha = {"mix": ("mix", 300, 32, 0.0),
                           "water": ("water", 250, 48, 0.9),
                           "z_halo": ("mix", 400, 48, 0.0)}[case]
    mol, table, box = port_scene(kind, n, seed=3)
    spec = CellGridSpec.create(box, 3.0, cap=cap)
    assert spec.dims == (3, 3, 3)
    path = CudaMultiSitePackedPath(table, spec, screen_alpha=alpha)
    tbl, r_i, r_j, _, _ = path._build_views(mol)
    nx, ny, nz = spec.dims
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, Wp=path.Wp, Wjp=path.Wjp,
              cell_plane=path.cell_plane, box=spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=alpha, meta=path.meta)
    if case == "z_halo":
        r_i = r_i[1:2].contiguous()
        kw.update(nz=1, z_halo=True)
    got = launch_packed(tbl, r_i, r_j, **kw)
    assert_close(got, multisite_cell_forces_packed_reference(tbl, r_i, r_j, **kw))


@pytest.mark.parametrize("case", ["mix", "water", "yz_halo"])
def test_k6_device_code_matches_plain(on_emu, case):
    """K6 against its plain version: the mixture (cap 32: a dead warp in
    every tile), the screened water-like scene (cap 48: two tiles a row),
    and explicit y + z halo rows, which give the wrapped result bit for
    bit."""
    kind, n, cap, alpha = {"mix": ("mix", 300, 32, 0.0),
                           "water": ("water", 250, 48, 0.9),
                           "yz_halo": ("mix", 300, 32, 0.0)}[case]
    mol, table, box = port_scene(kind, n, seed=4)
    spec = CellGridSpec.create(box, 3.0, cap=cap)
    assert spec.dims == (3, 3, 3)
    path = CudaMultiSitePath(table, spec, screen_alpha=alpha)
    r_i, _ = path.layout(mol)
    r_j = path.x_halo(r_i).contiguous()
    nx, ny, nz = spec.dims
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, box=spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=alpha, meta=path.meta)
    if case == "yz_halo":
        wrapped = launch_dense(r_i, r_j, **kw)
        r_j = _yz_halo(r_j, spec.box).contiguous()
        kw.update(z_halo=True, y_halo=True)
    got = launch_dense(r_i, r_j, **kw)
    assert_close(got, multisite_cell_forces_reference(r_i, r_j, **kw))
    if case == "yz_halo":
        for a, b in zip(got, wrapped):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
