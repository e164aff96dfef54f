"""Binary checkpoint format (reference-compatible; the counterpart of
ls1_mardyn_tpu/io/binary_io.py).

Byte-level parity with the reference's BinaryReader / binary
CheckpointWriter (src/io/BinaryReader.cpp:163-240 +
Domain::writeCheckpointHeaderXML, src/Domain.cpp:572): packed
little-endian records
    ICRVQD: u64 id | u32 cid(1-based) | f64 x y z vx vy vz q0 q1 q2 q3 Dx Dy Dz
    ICRV:   u64 id | u32 cid | f64 x y z vx vy vz
    IRV:    u64 id | f64 x y z vx vy vz
plus an XML header file:
    <mardyn version="20100525"><headerinfo>
      <time>..</time><length><x/><y/><z/></length>
      <number>N</number><format type="ICRVQD"/>
    </headerinfo></mardyn>
Component definitions are not part of the binary header (the reference
takes them from the simulation XML); callers supply them.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.models.components import Component

_DTYPES = {
    "ICRVQD": np.dtype(
        [("id", "<u8"), ("cid", "<u4")]
        + [(n, "<f8") for n in
           ("x", "y", "z", "vx", "vy", "vz", "q0", "q1", "q2", "q3",
            "Dx", "Dy", "Dz")]
    ),
    "ICRV": np.dtype(
        [("id", "<u8"), ("cid", "<u4")]
        + [(n, "<f8") for n in ("x", "y", "z", "vx", "vy", "vz")]
    ),
    "IRV": np.dtype(
        [("id", "<u8")]
        + [(n, "<f8") for n in ("x", "y", "z", "vx", "vy", "vz")]
    ),
}


def write_binary_checkpoint(
    data_path: str,
    header_path: str,
    data: PhaseSpaceData,
    mol_format: str = "ICRVQD",
):
    n = len(data.mid)
    dt = _DTYPES[mol_format]
    rec = np.zeros(n, dtype=dt)
    rec["id"] = data.mid.astype(np.uint64)
    if "cid" in dt.names:
        rec["cid"] = (data.cid + 1).astype(np.uint32)
    for i, c in enumerate(("x", "y", "z")):
        rec[c] = data.r[:, i]
    for i, c in enumerate(("vx", "vy", "vz")):
        rec[c] = data.v[:, i]
    if mol_format == "ICRVQD":
        for i, c in enumerate(("q0", "q1", "q2", "q3")):
            rec[c] = data.q[:, i]
        for i, c in enumerate(("Dx", "Dy", "Dz")):
            rec[c] = data.L[:, i]
    rec.tofile(data_path)

    root = ET.Element("mardyn", version="20100525")
    hi = ET.SubElement(root, "headerinfo")
    ET.SubElement(hi, "time").text = repr(float(data.current_time))
    ln = ET.SubElement(hi, "length")
    for ax, v in zip("xyz", data.box):
        ET.SubElement(ln, ax).text = repr(float(v))
    ET.SubElement(hi, "number").text = str(n)
    ET.SubElement(hi, "format", type=mol_format)
    ET.ElementTree(root).write(header_path, encoding="UTF-8", xml_declaration=True)


def read_binary_checkpoint(
    data_path: str,
    header_path: str,
    components: Optional[List[Component]] = None,
    mixing_xi=None,
    mixing_eta=None,
    eps_rf: float = 1.0e10,
) -> PhaseSpaceData:
    root = ET.parse(header_path).getroot()
    hi = root.find("headerinfo")
    t = float(hi.findtext("time", "0"))
    box = np.array([float(hi.find("length").findtext(ax)) for ax in "xyz"])
    n = int(hi.findtext("number"))
    fmt = hi.find("format").get("type", "ICRVQD")
    rec = np.fromfile(data_path, dtype=_DTYPES[fmt], count=n)
    if len(rec) != n:
        raise ValueError(
            f"{data_path}: expected {n} records, found {len(rec)}"
        )
    r = np.stack([rec["x"], rec["y"], rec["z"]], -1)
    v = np.stack([rec["vx"], rec["vy"], rec["vz"]], -1)
    if fmt == "ICRVQD":
        q = np.stack([rec["q0"], rec["q1"], rec["q2"], rec["q3"]], -1)
        L = np.stack([rec["Dx"], rec["Dy"], rec["Dz"]], -1)
    else:
        q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
        L = np.zeros((n, 3))
    cid = (
        rec["cid"].astype(np.int32) - 1
        if "cid" in rec.dtype.names
        else np.zeros(n, np.int32)
    )
    if components is None:
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 6.0, False)
        components = [c]
    K = len(components)
    return PhaseSpaceData(
        components=components,
        mixing_xi=mixing_xi if mixing_xi is not None else np.ones((K, K)),
        mixing_eta=mixing_eta if mixing_eta is not None else np.ones((K, K)),
        eps_rf=eps_rf,
        box=box,
        temperature=0.0,
        current_time=t,
        mid=rec["id"].astype(np.int64),
        cid=cid,
        r=r,
        v=v,
        q=q,
        L=L,
    )


# ---------------------------------------------------------------------------
# MPICheckpointWriter .dat format (byte-parity with the reference)
# ---------------------------------------------------------------------------

MPI_CKPT_MAGIC = b"MarDyn20150211trunk"
_ENDIANNESS_TEST = 0x0A0B0C0D


def write_mpi_checkpoint(path, data: PhaseSpaceData) -> None:
    """Write the reference's MPICheckpointWriter binary format
    (src/io/MPICheckpointWriter.cpp:330-393, sequential
    branch; the MPI-IO branch produces the same bytes with one
    bounding-box record per rank): 64-byte header (magic, zero pad,
    endianness int, gap), "ICRVQD\\0", "BB\\0", #bb, per-bb (min[3],
    max[3], startidx, count), then per molecule id/cid as uint64 and
    r/v/q(wxyz)/D as float64 (ICRVQD record, 120 bytes).

    One host gathers everything here (numbb = 1); the reference's
    rank-parallel MPI-IO is a multi-host concern this single-host
    framework serializes."""
    n = len(data.mid)
    gap = 7 + 3 + 8 + 1 * (6 * 8 + 2 * 8)
    with open(path, "wb") as f:
        f.write(MPI_CKPT_MAGIC)
        f.write(b"\0" * (64 - len(MPI_CKPT_MAGIC) - 8 - 4))
        f.write(np.int32(_ENDIANNESS_TEST).tobytes())
        f.write(np.uint64(gap).tobytes())
        f.write(b"ICRVQD\0")
        f.write(b"BB\0")
        f.write(np.uint64(1).tobytes())
        f.write(np.zeros(3, np.float64).tobytes())  # bb min
        f.write(np.asarray(data.box, np.float64).tobytes())  # bb max
        f.write(np.uint64(0).tobytes())  # start index
        f.write(np.uint64(n).tobytes())
        rec = np.zeros((n, 15), np.float64)
        rec[:, 0] = np.asarray(data.mid, np.uint64).view(np.float64)
        rec[:, 1] = np.asarray(data.cid, np.uint64).view(np.float64)
        rec[:, 2:5] = data.r
        rec[:, 5:8] = data.v
        rec[:, 8:12] = data.q
        rec[:, 12:15] = data.L
        f.write(rec.tobytes())


def read_mpi_checkpoint(path) -> PhaseSpaceData:
    """Read the MPICheckpointWriter .dat format (the MPI_IOReader role,
    src/io/MPI_IOReader.cpp).  Returns a PhaseSpaceData
    without components (the caller supplies them from the XML, exactly
    like the reference which keeps components in the XML header)."""
    with open(path, "rb") as f:
        raw = f.read()

    def need(ok, what):
        if not ok:
            raise ValueError(f"{path}: not an MPI checkpoint ({what})")

    need(raw[: len(MPI_CKPT_MAGIC)] == MPI_CKPT_MAGIC, "bad magic")
    endian = np.frombuffer(raw[52:56], np.int32)[0]
    need(endian == _ENDIANNESS_TEST, "endianness mismatch")
    off = 64
    fmt = raw[off : off + 7]
    need(fmt == b"ICRVQD\0", f"format {fmt!r}")
    off += 7
    need(raw[off : off + 3] == b"BB\0", "no bounding boxes")
    off += 3
    numbb = int(np.frombuffer(raw[off : off + 8], np.uint64)[0])
    off += 8
    box = None
    total = 0
    for _ in range(numbb):
        bbmax = np.frombuffer(raw[off + 24 : off + 48], np.float64)
        box = bbmax if box is None else np.maximum(box, bbmax)
        total += int(np.frombuffer(raw[off + 56 : off + 64], np.uint64)[0])
        off += 64
    rec = np.frombuffer(
        raw[off : off + total * 120], np.float64
    ).reshape(total, 15)
    return PhaseSpaceData(
        components=[], mixing_xi=np.ones((0, 0)), mixing_eta=np.ones((0, 0)),
        eps_rf=0.0, box=np.asarray(box), temperature=0.0, current_time=0.0,
        mid=rec[:, 0].view(np.uint64).astype(np.int64).copy(),
        cid=rec[:, 1].view(np.uint64).astype(np.int32).copy(),
        r=rec[:, 2:5].copy(), v=rec[:, 5:8].copy(),
        q=rec[:, 8:12].copy(), L=rec[:, 12:15].copy(),
    )
