"""The multi-site kernels' device code on the CPU: csrc/ms_packed.cu (K5)
and csrc/ms_dense.cu (K6), with their shared skeleton csrc/ms_pair.cuh,
compiled by g++ under the CUDA emulation shim tools/cuda_emu.h
(tools/cuda_emu.py) and run through the port's own launch code
(ops/cuda_ms.launch_dense, ops/cuda_ms_packed.launch_packed) on CPU
tensors, against the plain versions multisite_cell_forces_reference and
multisite_cell_forces_packed_reference, f64.

It checks what only the kernels do: the warp windows, the per-lane
in-cutoff lists, their flattening into rounds of 32 pairs and the
segmented reduction back to the owner lanes, the one-rsqrt site
arithmetic, and K5's half shell (the forward rows, the centre row's j
after i, the right wrap halo, the reactions gathered per j and added by
atomics).  Scenes: 3 x 3 x 3 cells (rc 3): the two-component mixture
with all seven bodies ("mix"), the erfc-screened water-like scene
("water"), rows of ~190 molecules over three wide cells (two live
128-slot tiles and a dead one, warps over two cells, both wrap halos:
"multitile"), explicit z halo rows (K5, the double-sided walk) and
y + z halo rows (K6, which must give the wrapped result bit for bit).
Tolerance: 1e-12 of each output's max (F, M, Vi; u6, uX and myRF
relative), the card's f64 limit; the emulation's 1/sqrt stands in for
the card's rsqrt.  Two mutants of the half shell must be caught: j's
torque without its orbital term drm x F (j's torque comes from the
pair's angular momentum balance, M_j = -(M_i + drm x F); the plain
version evaluates it from j's side), and the centre row's forward
filter (j after i) dropped.
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
from ls1_mardyn_tpu_torch.ops import cuda_ms, cuda_ms_packed
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
from test_torch_lj_emu import OnCard

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 1e-12


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    """csrc/ms_packed.cu and ms_dense.cu built for the CPU (skips without
    g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernels cannot be built for the CPU")
    paths = _emu_module().build(["ms_packed", "ms_dense"],
                                tmp_path_factory.mktemp("cuda_emu"))
    return {n: cuda_ms.type_lib(ctypes.CDLL(str(p)), n)
            for n, p in paths.items()}


def _emu_module():
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    return emu


@pytest.fixture
def on_emu(emu_libs, monkeypatch):
    """The port's launch code, loading the CPU builds."""
    monkeypatch.setattr(cuda_ms, "_lib", emu_libs.__getitem__)


def port_scene(kind, n, seed, box=9.0):
    """About n molecules of a scene kind in a box (9^3: 3 cells of rc 3 a
    side), random orientations: (mol, table, box), f64 on the CPU."""
    r, box = lattice(n, box, seed)
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


# K5's cases: scene kind, molecules, box, cell edges (None: rc), cap,
# screen_alpha
K5_CASES = {"mix": ("mix", 300, 9.0, None, 32, 0.0),
            "water": ("water", 250, 9.0, None, 48, 0.9),
            "multitile": ("mix", 1700, (9.3, 15.0, 15.0), (3, 3, 3), 96, 0.0),
            "z_halo": ("mix", 400, 9.0, None, 48, 0.0)}


def k5_inputs(case):
    """(tbl, r_i, r_j, kw) of a K5 case: the packed build of its scene;
    for "z_halo" the middle z row against its three rows as explicit halo
    rows."""
    kind, n, box, dims, cap, alpha = K5_CASES[case]
    mol, table, box = port_scene(kind, n, seed=3, box=box)
    spec = (CellGridSpec.create(box, 3.0, cap=cap) if dims is None else
            CellGridSpec(dims=dims, box=tuple(float(b) for b in box), cap=cap))
    assert spec.dims == (3, 3, 3)
    path = CudaMultiSitePackedPath(table, spec, screen_alpha=alpha)
    tbl, r_i, r_j, _, _ = path._build_views(mol)
    nx, ny, nz = spec.dims
    kw = dict(nx=nx, ny=ny, nz=nz, cap=cap, Wp=path.Wp, Wjp=path.Wjp,
              cell_plane=path.cell_plane, box=spec.box, rc2=path.rc2,
              rc2_lj=path.rc2_lj, screen_alpha=alpha, meta=path.meta)
    if case == "multitile":
        counts = (r_i[:, :, 3] > 0.5).sum(-1)
        assert int(counts.min()) > 128 and path.Wp // 128 == 3
    if case == "z_halo":
        r_i = r_i[1:2].contiguous()
        kw.update(nz=1, z_halo=True)
    return tbl, r_i, r_j, kw


@pytest.mark.parametrize("case", ["mix", "water", "multitile", "z_halo"])
def test_k5_device_code_matches_plain(on_emu, monkeypatch, case):
    """K5 through its wrapper against its plain version: the mixture (cap
    32), the screened water-like scene (cap 48), rows of two live tiles
    over three cells (cap 96), each on the half shell (half_launches
    counts the launch), and the middle z row of a packed build against
    its three rows as explicit halo rows (the double-sided walk: no
    half_launches)."""
    tbl, r_i, r_j, kw = k5_inputs(case)
    launch = cuda_ms_packed.launch_packed
    monkeypatch.setattr(
        cuda_ms_packed, "launch_packed",
        lambda *a, **k: launch(*(t.as_subclass(torch.Tensor) for t in a), **k))
    k5 = cuda_ms_packed.multisite_cell_forces_packed
    n0, h0 = k5.launches, k5.half_launches
    got = k5(*(t.as_subclass(OnCard) for t in (tbl, r_i, r_j)), **kw)
    half = case != "z_halo"
    assert (k5.launches - n0, k5.half_launches - h0) == (1, int(half))
    assert_close(got, multisite_cell_forces_packed_reference(tbl, r_i, r_j, **kw))


def _no_orbital_term(text):
    """j's torque without the orbital term of the balance: -M_i."""
    old = "a.Mj = -(a.M + cross(drm, a.F));"
    assert text.count(old) == 1
    return text.replace(old, "a.Mj = -a.M;")


def _no_forward_filter(text):
    """The centre row's pair test j after i turned into j != i."""
    old = "if (HALF ? jidx[q] <= self_j : jidx[q] == self_j) continue;"
    assert text.count(old) == 1
    return text.replace(old, "if (jidx[q] == self_j) continue;")


@pytest.fixture(scope="module")
def emu_k5_mutants(tmp_path_factory):
    """csrc/ms_packed.cu built for the CPU with each mutant (skips without
    g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernels cannot be built for the CPU")
    emu = _emu_module()
    libs = {}
    for tag, edit in (("no_orbital_term", _no_orbital_term),
                      ("no_forward_filter", _no_forward_filter)):
        path = emu.build(["ms_packed"], tmp_path_factory.mktemp(tag),
                         edits={"ms_pair.cuh": edit})["ms_packed"]
        libs[tag] = cuda_ms.type_lib(ctypes.CDLL(str(path)), "ms_packed")
    return libs


@pytest.mark.parametrize("mutant", ["no_orbital_term", "no_forward_filter"])
def test_k5_mutants_caught(emu_libs, emu_k5_mutants, monkeypatch, mutant):
    """Without the orbital term, j's torques differ (every pair with a
    net force has one); without the centre row's forward filter, pairs of
    one row after the warp's first i are evaluated twice and the forces
    differ.  The shipped kernel
    passes the same comparison on the same case."""
    tbl, r_i, r_j, kw = k5_inputs("mix")
    want = multisite_cell_forces_packed_reference(tbl, r_i, r_j, **kw)
    for lib, caught in ((emu_libs["ms_packed"], False),
                        (emu_k5_mutants[mutant], True)):
        monkeypatch.setattr(cuda_ms, "_lib", lambda name, lib=lib: lib)
        got = launch_packed(tbl, r_i, r_j, **kw)
        try:
            assert_close(got, want)
        except AssertionError:
            assert caught, "the shipped kernel disagrees with its plain version"
        else:
            assert not caught, f"the mutant {mutant} was not caught"


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
