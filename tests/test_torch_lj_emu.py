"""The 1CLJ cell kernels' device code on the CPU: csrc/lj_cells.cu (K1),
csrc/lj_cells_cw.cu (K3) and csrc/lj_cells_row.cu (K4) on their warp
skeleton csrc/lj_warp.cuh, compiled by g++ under the CUDA emulation shim
tools/cuda_emu.h (tools/cuda_emu.py) and run through the port's own
launch code (ops/cuda_lj.launch_lj_cells, launch_lj_cells_cw,
launch_lj_cells_row) on CPU tensors, against the plain versions
lj_cell_forces_reference, lj_cell_forces_cw_reference and
lj_cell_forces_row_reference.  K8 (the TPU's half-shell variant) is
K1's launch, so its cases run here as cases of K1.

It checks what only the kernels do: the i compaction and the two- and
four-group split of a warp (cells of 0, 1 and <= 16 molecules), the
full-warp path (32 of 32), a cell of cap 64 as two warps, the box
culling of j slots (pairs within an ulp of rc), the ring of staged j
slots, Vi, explicit z halo rows, ny = 2 with nz = 1 (both periodic
images count) and K1 reading the first 4 planes of an 8-plane tensor in
place; K3's two branches (the half shell where its inputs allow it, on
grids of 3x3x3 and 4x5x6 cells at cap 32 and 128, and the double-sided
walk under Vi, z halo rows and ny = 2) and its launch counters; for K4
its j view in every mode of chip_smoke.row_views (cell-local,
absolute, explicit y and z halo rows, two x halo cells, nx = 2)
and pairs within a coordinate ulp of rc in absolute coordinates near
160 sigma.  K1 evaluates each pair once by the half shell and sends
each warp's reactions to f by atomics: cap 32, 64 and 96 (blocks across
cells) and cap 128 (a block is one cell, whose warps add reactions to
the same slots), with cells of up to 110 molecules.  K8's cases add f32
pairs within an ulp of rc, the RMM engine's own state
(chip_smoke.cut_sim, 4^3 cells, sentinel fill) read in place, cap 96
with three warps in the own cell, and 3x3x3 cells cut from the sparse
scene (the smallest grid the half shell takes).  Tolerance: 1e-12 of
max|F| and relative on u6 and the virial in f64, 1e-5 in f32.  Every
case also holds the number of pairs inside the cutoff that the kernel
evaluates (a launch with eps24 = 0 and shift6 = 1,
ops/cuda_lj.pairs_from_part; ordered for K3 and K4, unordered for K1)
to the plain version's count (inside_pairs_reference), exactly: a j
slot culled wrongly would lose its pairs there.  Two mutants of K1 must
be caught: the own-cell test j > i turned into j != i (pairs twice),
and the flush of the last, partial round of j slots dropped (reactions
lost), on K1's cases and on K8's.  The shim runs a warp's lanes as
fibers that switch only at barriers, so it cannot show a race between
lanes; K1 adds its reactions with atomics or through shuffles and
assumes no lockstep.  Scenes:
chip_smoke.lj_scene, cell edge 2.6 (5.0 at cap 128), rc 2.5.
"""
import ctypes
import importlib.util
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ls1_mardyn_tpu_torch.io.generators import cubic_grid  # noqa: E402
from ls1_mardyn_tpu_torch.ops import _build, cuda_lj, lj_path  # noqa: E402
from ls1_mardyn_tpu_torch.ops import cuda_lj_variants as V  # noqa: E402
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec  # noqa: E402
from ls1_mardyn_tpu_torch.scene import build_scene  # noqa: E402

torch.set_num_threads(1)

CL = 2.6
LJ = dict(eps24=24.0, sig2=1.0, shift6=0.1, rc2=2.5 ** 2)
LIBS = ("lj_cells", "lj_cells_cw", "lj_cells_row")


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    """csrc/lj_cells*.cu built for the CPU (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernels cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    paths = emu.build(LIBS, tmp_path_factory.mktemp("cuda_emu"))
    return {n: cuda_lj.type_lib(ctypes.CDLL(str(p)), n) for n, p in paths.items()}


@pytest.fixture
def on_emu(emu_libs, monkeypatch):
    """The port's launch code, loading the CPU builds."""
    monkeypatch.setattr(cuda_lj, "_lib", emu_libs.__getitem__)


def sparse_counts(shape, hi, seed):
    """Molecules a cell: 0 or 1 in a third of the cells each, else up to
    hi."""
    rng = np.random.default_rng(seed)
    c = rng.integers(2, hi + 1, size=shape)
    pick = rng.integers(0, 3, size=shape)
    return np.where(pick == 0, 0, np.where(pick == 1, 1, c))


def assert_close(got, want, lim):
    """Forces (and Vi) within lim of max|F|; u6 and virial relative."""
    f, u6, vir = got
    scale = float(want[0][:, :, :3].abs().max())
    assert scale > 0
    err = float((f - want[0]).abs().max()) / scale
    assert err <= lim, err
    for a, b in ((u6, want[1]), (vir, want[2])):
        assert abs(float(a) - float(b)) <= lim * abs(float(b)), (float(a), float(b))


def check_kernel(launch, plain, args, kw, lim, count_kw=None, halved=True):
    """The kernel with and without u6/virial against its plain version,
    and its in-cutoff pair count against the plain version's (ordered;
    halved=False: a kernel that evaluates each pair once, unordered)."""
    want = plain(*args, **kw)
    assert_close(launch(*args, **kw), want, lim)
    f, _, _ = launch(*args, **dict(kw, compute_macro=False))
    torch.testing.assert_close(f, want[0], rtol=0,
                               atol=lim * float(want[0][:, :, :3].abs().max()))
    _, part = launch(*args, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0),
                     parts=True)
    ref = cuda_lj.inside_pairs_reference(*args[:1], **count_kw)
    assert cuda_lj.pairs_from_part(part, halved=halved) == ref > 0


def block_counts(shape, seed=4):
    """Cap 128 on cells of edge CL128: cells of 0 to 110 molecules in
    random slots, so that a cell's four warps hold 0 to 32 valid slots
    each (none, split, whole), and several cells have all four live."""
    rng = np.random.default_rng(seed)
    return rng.choice([0, 1, 12, 40, 70, 97, 104, 110], size=shape)


# the cell edge of the cap-128 scene: room for 110 molecules 0.75 apart
CL128 = 5.0

SCENES = {
    # name: (dims, cap, counts(shape) , near_rc pairs)
    "sparse32": ((5, 4, 3), 32, lambda s: sparse_counts(s, 16, 1), 0),
    "sparse64": ((4, 3, 3), 64, lambda s: sparse_counts(s, 40, 2), 0),
    "full32": ((3, 3, 3), 32, lambda s: np.full(s, 32), 0),
    "near_rc": ((4, 4, 3), 32, lambda s: sparse_counts(s, 3, 3), 80),
    "cap96": ((4, 3, 3), 96, lambda s: np.random.default_rng(4).choice(
        [0, 1, 17, 32], s), 0),
    "block128": ((3, 3, 3), 128, block_counts, 60),
    "small128": ((3, 3, 3), 128, lambda s: np.random.default_rng(5).choice(
        [0, 1, 12, 40], s), 30),
    "grid456": ((4, 5, 6), 32, lambda s: sparse_counts(s, 30, 6), 40),
    "grid456_128": ((4, 5, 6), 128, lambda s: block_counts(s, seed=8), 60),
}


def edge(name):
    return CL128 if SCENES[name][1] == 128 else CL


def scene(name, dtype=torch.float64, planes=4):
    dims, cap, counts, near = SCENES[name]
    r = chip_smoke.lj_scene(dims, cap, edge(name), counts(dims[::-1]), seed=7,
                            near_rc=near, planes=planes, dtype=dtype)
    return r, dims, cap


def case_inputs(case):
    """(r4, kw, lim) of a case: the scenes, f32, an 8-plane tensor, the
    RMM state with the sentinel fill, cap 96 (3 chunks a cell, which the
    band order does not divide: K1's order), and 3x3x3 cells cut from the
    sparse scene as a periodic grid of their own."""
    if case == "cap96":
        counts = chip_smoke.np.random.default_rng(4).choice([0, 1, 17, 64],
                                                             (3, 3, 4))
        r = chip_smoke.lj_scene((4, 3, 3), 96, CL, counts, seed=4)
        return r, dict(dims=(4, 3, 3), cap=96, cell_len=(CL,) * 3, **LJ), 1e-12
    if case == "rmm_state":
        sim = chip_smoke.cut_sim(32, torch.float64, "cpu", nd=4)
        assert sim.sentinel and sim.state.planes.shape[2] == 8
        kw = dict(dims=sim.spec.dims, cap=32, cell_len=sim.cell_len,
                  eps24=sim.eps24, sig2=sim.sig2, shift6=sim.shift6, rc2=sim.rc2)
        return sim.state.planes[:, :, :4, :], kw, 1e-12
    if case == "sub3":
        r4, kw, lim = case_inputs("sparse32")
        r4 = chip_smoke.sub_block(r4, kw["cap"], 3, 3, 3)
        return r4, dict(kw, dims=(3, 3, 3)), lim
    name = case.split("_f32")[0] if case != "planes8" else "sparse32"
    dtype = torch.float32 if case.endswith("_f32") else torch.float64
    r, dims, cap = scene(name, dtype, planes=8 if case == "planes8" else 4)
    kw = dict(dims=dims, cap=cap, cell_len=(CL,) * 3, **LJ)
    return r[:, :, :4, :], kw, 1e-5 if dtype == torch.float32 else 1e-12


def k1_inputs(case):
    """(r4, kw, lim) of a K1 case, or with the prefix "k8_" of a K8 case
    (case_inputs)."""
    if case.startswith("k8_"):
        return case_inputs(case.removeprefix("k8_"))
    name = case.removesuffix("_f32") if case.removesuffix("_f32") in SCENES \
        else "sparse32"
    dtype = torch.float32 if case.endswith("f32") else torch.float64
    r, dims, cap = scene(name, dtype, planes=8 if case == "planes8" else 4)
    r4 = r[:, :, :4, :]
    assert r4.is_contiguous() == (case != "planes8")
    kw = dict(dims=dims, cap=cap, cell_len=(edge(name),) * 3, **LJ)
    return r4, kw, 1e-5 if dtype == torch.float32 else 1e-12


K8_CASES = ["sparse32", "sparse64", "full32", "near_rc", "near_rc_f32",
            "sparse32_f32", "planes8", "rmm_state", "cap96", "sub3"]


@pytest.mark.parametrize("case", ["sparse32", "sparse64", "full32", "near_rc",
                                  "f32", "planes8", "cap96", "block128",
                                  "small128_f32"]
                         + ["k8_" + c for c in K8_CASES])
def test_k1_device_code_matches_plain(on_emu, case):
    """K1 against its plain version: sparse cells (the split paths), cap
    64, full cells, pairs within an ulp of rc, f32, the first 4 planes of
    an 8-plane tensor read in place, cap 96 (blocks across cells), and
    cap 128, where a block is one cell: cells of up to 110 molecules (all
    four warps live) in f64, and of up to 40 with pairs within an ulp of
    rc in f32.  K8's cases (k8_*) under K8's names for the plain version
    and the count: K8's scenes, the RMM engine's state, cap 96 with three
    warps in the own cell, and a 3x3x3 grid."""
    r4, kw, lim = k1_inputs(case)
    k8 = case.startswith("k8_")
    plain = (V.lj_cell_forces_n3l_reference if k8
             else cuda_lj.lj_cell_forces_reference)
    check_kernel(cuda_lj.launch_lj_cells, plain, (r4,), kw, lim,
                 dict(kernel="n3l" if k8 else "K1", dims=kw["dims"],
                      cap=kw["cap"], cell_len=kw["cell_len"], rc2=kw["rc2"]),
                 halved=False)


# K3 cases that keep the double-sided walk
K3_FULL = ("vi", "vi_near_rc", "z_halo", "ny2")


@pytest.mark.parametrize("case", ["sparse32", "sparse64", "full32", "near_rc",
                                  "block128", "grid456", "grid456_128",
                                  *K3_FULL])
def test_k3_device_code_matches_plain(on_emu, case):
    """K3 against its plain version.  The half shell (cw_half_shell): the
    K1 scenes, (3, 3, 3) and (4, 5, 6) at cap 32 (full32, grid456) and
    cap 128 (block128, grid456_128: partly filled cells, own cells of up
    to four live warps); each such call writes one row of part a warp.
    The double-sided walk: Vi (also on the near_rc scene, whose ordered
    count differs from twice the half shell's), the inner z rows against
    the whole scene as explicit halo rows, and (5, 2, 1); one row a
    block.  The in-cutoff count follows the branch taken."""
    name = {"vi_near_rc": "near_rc"}.get(case, case)
    name = name if name in SCENES else "sparse32"
    r, dims, cap = scene(name)
    r_i, r_j, extra = r, None, {}
    if case in ("vi", "vi_near_rc"):
        extra = dict(compute_vi=True)
    elif case == "z_halo":
        r_i, r_j = r[1:-1].contiguous(), r
        dims = (dims[0], dims[1], dims[2] - 2)
        extra = dict(z_halo=True)
    elif case == "ny2":
        dims = (5, 2, 1)
        r_i = r[:1, :2].contiguous()
    cl = (edge(name),) * 3
    kw = dict(dims=dims, cap=cap, cell_len=cl, **LJ, **extra)
    count_kw = dict(dims=dims, cap=cap, cell_len=cl, rc2=LJ["rc2"], r_j=r_j,
                    **extra)
    half = cuda_lj.cw_half_shell(r_j, dims, **extra)
    assert half == (case not in K3_FULL)
    check_kernel(cuda_lj.launch_lj_cells_cw, cuda_lj.lj_cell_forces_cw_reference,
                 (r_i, r_j), kw, 1e-12, count_kw)
    _, part = cuda_lj.launch_lj_cells_cw(r_i, r_j, parts=True, **kw)
    nx, ny, nz = dims
    warps = nx * ny * nz * cap // 32
    rows = warps if half else -(-warps // 4)
    assert part.shape == (rows, 2)


@pytest.mark.parametrize("case", ["sparse32", "full32"])
def test_k4_block_skeleton_control(on_emu, case):
    """K4 in cell-local mode on the K1 scenes through a one-cell periodic
    x halo (the control of the block skeleton K4 ran on before it moved
    to the warp skeleton): its in-cutoff count is K3's on the same
    cells."""
    r, dims, cap = scene(case)
    nx = dims[0]
    r_j = torch.cat([r[..., (nx - 1) * cap:], r, r[..., :cap]], -1).contiguous()
    kw = dict(dims=dims, cap=cap, box=tuple(CL * d for d in dims),
              local_coords=True, **LJ)
    check_kernel(cuda_lj.launch_lj_cells_row, cuda_lj.lj_cell_forces_row_reference,
                 (r, r_j), kw, 1e-12,
                 dict(dims=dims, cap=cap, cell_len=(CL,) * 3, rc2=LJ["rc2"]))


@pytest.mark.parametrize("case", ["absolute", "yz_halo", "hx2", "nx2",
                                  "sparse64", "near_rc_abs"])
def test_k4_device_code_matches_plain(on_emu, case):
    """K4 on the warp skeleton in the modes of chip_smoke.row_views on
    the sparse scene (cells of 0, 1 and up to 16 molecules), cap 64, and
    the near-rc scene in absolute coordinates with y and z halo rows near
    160 sigma, in f32 (pairs within a coordinate ulp of rc)."""
    lim, lj = 1e-12, LJ
    if case == "near_rc_abs":
        lim, lj, cap = 1e-5, chip_smoke.SCENE_LJ, 32
        dims = (6, 6, 6)
        r = chip_smoke.near_rc_absolute(cap, torch.float32, "cpu")
        views = chip_smoke.row_views(r, dims, cap, (CL,) * 3, "yz_halo",
                                     origin=chip_smoke.ABS_ORIGIN)
    else:
        r, dims, cap = scene("sparse64" if case == "sparse64" else "sparse32")
        views = chip_smoke.row_views(r, dims, cap, (CL,) * 3,
                                     "local" if case == "sparse64" else case)
    r_i, r_j, dims, box, extra = views
    kw = dict(dims=dims, cap=cap, box=box, **lj, **extra)
    check_kernel(cuda_lj.launch_lj_cells_row, cuda_lj.lj_cell_forces_row_reference,
                 (r_i, r_j), kw, lim,
                 dict(r_j=r_j, kernel="row", dims=dims, cap=cap, box=box,
                      rc2=lj["rc2"], **extra))


class OnCard(torch.Tensor):
    """A CPU tensor that the K3 wrapper takes for one on the card, so that
    it launches (the CPU build) and counts."""

    @property
    def device(self):
        return torch.device("cuda")


def test_k3_counts_its_half_shell_launches(on_emu, monkeypatch):
    """CudaLJPath on a grid of >= 3 cells a side counts one
    half_launches a force call (one a step), equal to launches, with the
    plain version's forces; calls with z halo rows, an explicit r_j,
    ny < 3 or Vi count a launch and no half_launches."""
    launch = cuda_lj.launch_lj_cells_cw

    def plain(t):
        return None if t is None else t.as_subclass(torch.Tensor)

    monkeypatch.setattr(cuda_lj, "launch_lj_cells_cw",
                        lambda r_i, r_j=None, **kw: launch(plain(r_i), plain(r_j),
                                                           **kw))
    k3 = cuda_lj.lj_cell_forces_cw
    monkeypatch.setattr(lj_path, "lj_cell_forces_cw",
                        lambda r_i, **kw: k3(r_i.as_subclass(OnCard), **kw))
    data = cubic_grid(1000, [11.9] * 3, 1.1)
    mol, _, table, box = build_scene(data, cutoff=2.5, dtype=torch.float64,
                                     device="cpu")
    path = lj_path.CudaLJPath(table, CellGridSpec.create(box.tolist(), 2.5, cap=32))
    assert min(path.spec.dims) >= 3 and path.cw

    def counts():
        return k3.launches, k3.half_launches

    n0, h0 = counts()
    for _ in range(3):
        forces, _, _ = path(mol)
    assert counts() == (n0 + 3, h0 + 3)
    monkeypatch.setattr(lj_path, "lj_cell_forces_cw", k3)
    want, _, _ = path(mol)
    assert counts() == (n0 + 3, h0 + 3)  # the plain version counts nothing
    torch.testing.assert_close(forces.F, want.F, rtol=0,
                               atol=1e-12 * float(want.F.abs().max()))
    r, dims, cap = scene("sparse32")
    kw = dict(cap=cap, cell_len=(CL,) * 3, **LJ)
    on = r.as_subclass(OnCard)
    k3(on[1:-1].contiguous(), on, dims=(5, 4, 1), z_halo=True, **kw)
    k3(on, on, dims=dims, **kw)
    k3(r[:1, :2].contiguous().as_subclass(OnCard), dims=(5, 2, 1), **kw)
    k3(on, dims=dims, compute_vi=True, **kw)
    assert counts() == (n0 + 7, h0 + 3)
    k3(on, dims=dims, **kw)
    assert counts() == (n0 + 8, h0 + 4)


def test_cpu_tensor_only_for_a_library_built_for_the_cpu(emu_libs):
    """The launch code hands a CPU tensor only to a library built under
    the shim (no stream); a library built for the card raises there
    instead of taking host pointers."""
    t = torch.zeros(4, dtype=torch.float64)
    assert _build.stream_of(emu_libs["lj_cells"], t, "lj_cells") is None
    with pytest.raises(ValueError, match="built for the card"):
        _build.stream_of(types.SimpleNamespace(), t, "lj_cells")


def _own_cell_neq(text):
    """The half shell's pair test j > i (lj_warp.cuh's half_pair) turned
    into j != i."""
    old = "if (dr2 < lj.rc2 && j.w > me.w) {"
    assert text.count(old) == 1
    return text.replace(old, "if (dr2 < lj.rc2 && j.w != me.w) {")


def _no_last_flush(text):
    """The flush of the last, partial round (lj_warp.cuh's half_shell)
    dropped."""
    old = "      flush(re, head - cnt, cnt, f, W);\n"
    assert text.count(old) == 1
    return text.replace(old, "")


@pytest.fixture(scope="module")
def emu_k1_mutants(tmp_path_factory):
    """csrc/lj_cells.cu built for the CPU with each of its two mutants
    (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the kernels cannot be built for the CPU")
    spec = importlib.util.spec_from_file_location(
        "cuda_emu", ROOT / "tools" / "cuda_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    libs = {}
    for tag, edit in (("own_neq", _own_cell_neq), ("no_flush", _no_last_flush)):
        path = emu.build(["lj_cells"], tmp_path_factory.mktemp(tag),
                         edits={"lj_warp.cuh": edit})["lj_cells"]
        libs[tag] = cuda_lj.type_lib(ctypes.CDLL(str(path)), "lj_cells")
    return libs


# the cases each mutant test runs: K1's (cap 32, and cap 128 where a block
# is one cell) and K8's
MUTANT_CASES = {"k1": ("sparse32", "small128"),
                "k8": ("k8_sparse32", "k8_full32", "k8_near_rc_f32")}


@pytest.mark.parametrize("cases", list(MUTANT_CASES))
def test_k1_mutants_caught(emu_libs, emu_k1_mutants, monkeypatch, cases):
    """The own-cell test j != i adds own-cell pairs twice: the count of a
    case with three or more close molecules in a cell differs.  Without
    the last flush the reactions of the last round are lost: the forces
    differ.  The shipped kernel passes both checks on the same cases."""
    libs = dict(emu_k1_mutants, tree=emu_libs["lj_cells"])
    caught = {"own_neq": set(), "no_flush": set()}
    for case in MUTANT_CASES[cases]:
        r4, kw, lim = k1_inputs(case)
        want = cuda_lj.lj_cell_forces_reference(r4, compute_macro=False, **kw)[0]
        n_want = cuda_lj.inside_pairs_reference(
            r4, kernel="K1", dims=kw["dims"], cap=kw["cap"],
            cell_len=kw["cell_len"], rc2=kw["rc2"])
        scale = float(want.abs().max())
        for tag in ("tree", "own_neq", "no_flush"):
            monkeypatch.setattr(cuda_lj, "_lib", lambda name, lib=libs[tag]: lib)
            f, _, _ = cuda_lj.launch_lj_cells(r4, compute_macro=False, **kw)
            _, part = cuda_lj.launch_lj_cells(
                r4, parts=True, **dict(kw, eps24=0.0, sig2=0.0, shift6=1.0))
            bad = (cuda_lj.pairs_from_part(part, halved=False) != n_want
                   or float((f - want).abs().max()) > lim * scale)
            if tag == "tree":
                assert not bad, case
            elif bad:
                caught[tag].add(case)
    assert caught["own_neq"] and caught["no_flush"], caught
