"""Binary checkpoints, the MPI checkpoint, the LZ4 frame codec and
open_compressed of the port against the JAX package's (CPU).

The writers get the same PhaseSpaceData (a 1CLJ component and a rigid
2CLJ + quadrupole component, random orientations and angular momenta)
and must produce the same bytes; each package reads the other's files.
A driver restart from a binary checkpoint gives the same state in the
port and in the JAX package, whichever of them wrote it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ls1_mardyn_tpu.driver import MDSimulation as JaxMD
from ls1_mardyn_tpu.io import binary_io as jbio
from ls1_mardyn_tpu.io.ascii_reader import PhaseSpaceData as JaxPSD
from ls1_mardyn_tpu.models.components import Component as JaxComponent
from ls1_mardyn_tpu.native import lz4_compress as jax_lz4
from ls1_mardyn_tpu_torch.driver import MDSimulation
from ls1_mardyn_tpu_torch.io import binary_io as bio
from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.io.compression import open_compressed
from ls1_mardyn_tpu_torch.io.generators import cubic_grid
from ls1_mardyn_tpu_torch.models.components import Component
from ls1_mardyn_tpu_torch.native import get_lz4, lz4_compress, lz4_decompress
from test_torch_driver import XML

torch.set_num_threads(1)


def _components(cls):
    a = cls(cid=0)
    a.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 2.5, False)
    b = cls(cid=1)
    b.add_ljcenter(0.0, 0.0, -0.2, 0.5, 1.0, 1.0, 2.5, True)
    b.add_ljcenter(0.0, 0.0, 0.2, 0.5, 1.0, 1.0, 2.5, True)
    b.add_quadrupole(0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.2)
    return [a, b]


def _data(cls, comp_cls, n=257, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return cls(
        components=_components(comp_cls), mixing_xi=np.ones((2, 2)),
        mixing_eta=np.ones((2, 2)), eps_rf=1e10,
        box=np.array([9.5, 10.25, 11.0]), temperature=1.1,
        current_time=0.123456789,
        mid=rng.permutation(np.arange(1, n + 1)).astype(np.int64),
        cid=rng.integers(0, 2, n).astype(np.int32),
        r=rng.random((n, 3)) * [9.5, 10.25, 11.0], v=rng.normal(size=(n, 3)),
        q=q / np.linalg.norm(q, axis=1, keepdims=True),
        L=rng.normal(size=(n, 3)) * 0.1,
    )


def _same_state(a, b, atol=0.0):
    """Equal molecules (matched by id), box and time."""
    oa, ob = np.argsort(a.mid), np.argsort(b.mid)
    for k in ("mid", "cid", "r", "v", "q", "L"):
        np.testing.assert_allclose(np.asarray(getattr(a, k))[oa],
                                   np.asarray(getattr(b, k))[ob], rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_array_equal(np.asarray(a.box), np.asarray(b.box))
    assert float(a.current_time) == float(b.current_time)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["ICRVQD", "ICRV", "IRV"])
def test_binary_checkpoint_bytes_match_jax(tmp_path, fmt):
    port, ref = tmp_path / "port", tmp_path / "jax"
    bio.write_binary_checkpoint(str(port), str(port) + ".xml",
                                _data(PhaseSpaceData, Component), fmt)
    jbio.write_binary_checkpoint(str(ref), str(ref) + ".xml",
                                 _data(JaxPSD, JaxComponent), fmt)
    assert _bytes(port) == _bytes(ref)
    assert _bytes(str(port) + ".xml") == _bytes(str(ref) + ".xml")
    # each package reads the other's file
    mine = bio.read_binary_checkpoint(str(ref), str(ref) + ".xml",
                                      components=_components(Component))
    theirs = jbio.read_binary_checkpoint(str(port), str(port) + ".xml")
    _same_state(mine, theirs)
    if fmt == "ICRVQD":
        _same_state(mine, _data(PhaseSpaceData, Component))


def test_mpi_checkpoint_bytes_match_jax(tmp_path):
    port, ref = tmp_path / "port.dat", tmp_path / "jax.dat"
    bio.write_mpi_checkpoint(str(port), _data(PhaseSpaceData, Component))
    jbio.write_mpi_checkpoint(str(ref), _data(JaxPSD, JaxComponent))
    assert _bytes(port) == _bytes(ref)
    got = bio.read_mpi_checkpoint(str(ref))
    want = _data(PhaseSpaceData, Component)
    for k in ("mid", "cid", "r", "v", "q", "L"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.box, want.box)


def test_lz4_frames_match_the_jax_codec():
    assert get_lz4() is not None
    rng = np.random.default_rng(0)
    for data in (b"", b"ls1 " * 5000, rng.integers(0, 4, 1 << 20,
                                                     dtype=np.uint8).tobytes()):
        c = lz4_compress(data)
        assert c == jax_lz4(data)
        assert lz4_decompress(c) == data


@pytest.mark.parametrize("ext", ["", ".gz", ".bz2", ".xz", ".lz4"])
def test_open_compressed_round_trips(tmp_path, ext):
    text = "".join(f"{i}\t{i * 0.5!r}\n" for i in range(2000))
    path = str(tmp_path / f"out.txt{ext}")
    with open_compressed(path, "wt") as f:
        f.write(text)
    with open_compressed(path, "rt") as f:
        assert f.read() == text
    blob = bytes(range(256)) * 64
    with open_compressed(path, "wb") as f:
        f.write(blob)
    with open_compressed(path, "rb") as f:
        assert f.read() == blob
    if ext == ".lz4":
        assert _bytes(path) == jax_lz4(blob)


def _restart_xml(d, data, header):
    """The test_torch_driver scene restarted from a binary checkpoint."""
    L = 11.9
    text = XML.format(n=1000, L=repr(L), steps=5, shifted=0, ensemble="NVT",
                      extra_site="")
    i, j = text.index("<phasespacepoint>"), text.index("</phasespacepoint>")
    text = (text[:i] + f'<phasespacepoint><file type="binary"><header>{header}'
            f"</header><data>{data}</data></file>" + text[j:])
    path = os.path.join(d, "restart.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def test_driver_binary_restart(tmp_path):
    """The port writes a binary checkpoint after 5 steps: the port and the
    JAX package restart from it with the same state.  The JAX package
    writes one after 5 steps: the port restarts from it with JAX's state."""
    d = str(tmp_path)
    start = _restart_xml(d, "start.dat", "start.xml")
    # a 1000-molecule lattice to start from, written by the port
    seed = cubic_grid(1000, [11.9] * 3, 1.1, seed=3)
    bio.write_binary_checkpoint(os.path.join(d, "start.dat"),
                                os.path.join(d, "start.xml"), seed)
    port = MDSimulation.from_xml(start, dtype=torch.float64, device="cpu")
    assert type(port.engine).__name__ == "RMMEngine"
    port.run(steps=5, print_every=0)
    port.write_checkpoint(os.path.join(d, "p.dat"), binary=True)
    ref = JaxMD.from_xml(start, dtype=jnp.float64)
    assert type(ref.engine).__name__ == "SingleChipSimulation"
    ref.run(steps=5, print_every=0)
    ref.write_checkpoint(os.path.join(d, "j.dat"), binary=True)

    from_port = _restart_xml(d, "p.dat", "p.dat.header.xml")
    a = MDSimulation.from_xml(from_port, dtype=torch.float64, device="cpu")
    b = JaxMD.from_xml(from_port, dtype=jnp.float64)
    _same_state(a._export_phasespace(), port._export_phasespace())
    _same_state(b._export_phasespace(), port._export_phasespace())

    from_jax = _restart_xml(d, "j.dat", "j.dat.header.xml")
    c = MDSimulation.from_xml(from_jax, dtype=torch.float64, device="cpu")
    _same_state(c._export_phasespace(), ref._export_phasespace())
    # the two 5-step runs (the port's RMM engine, JAX's N^2 sweep) agree
    # to rounding
    _same_state(c.phase_space, a.phase_space, atol=1e-12)
