"""Reader/writer for the mardyn ASCII phase-space (`.inp`) format.

Format parity with src/io/ASCIIReader.cpp:
  header: ``mardyn trunk <version>`` then tokens (long or one-letter):
    currentTime/t, Temperature/T, ThermostatTemperature/ThT/h,
    ComponentThermostat/CT/o, Length/L, NumberOfComponents/C (followed
    by component blocks, mixing coefficients, and epsilonRF),
    NumberOfMolecules/N, MoleculeFormat/M
  component block (ASCIIReader.cpp:146-204):
    nLJ nCharge nDipole nQuadrupole nTersoff(=0)
    per LJ center:   x y z m eps sigma tcutoff do_shift
    per charge:      x y z m q
    per dipole:      x y z ex ey ez |mu|
    per quadrupole:  x y z ex ey ez |Q|
    I11 I22 I33 (overrides if > 0)
  molecule records (ASCIIReader.cpp:283-383) in MoleculeFormat:
    ICRVQDV: id cid r(3) v(3) q(4) D(3) Vi(3)
    ICRVQD:  id cid r(3) v(3) q(4) D(3)
    ICRV:    id cid r(3) v(3)
    IRV:     id r(3) v(3)
  component ids are 1-based in files, 0-based internally
  (ASCIIReader.cpp:363).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np

from ls1_mardyn_tpu_torch.models.components import Component


@dataclasses.dataclass
class PhaseSpaceData:
    """Parsed scene: components + molecule arrays (host-side numpy)."""

    components: List[Component]
    mixing_xi: np.ndarray  # [K,K]
    mixing_eta: np.ndarray  # [K,K]
    eps_rf: float
    box: np.ndarray  # [3]
    temperature: float
    current_time: float
    # molecule data
    mid: np.ndarray  # [N]
    cid: np.ndarray  # [N] 0-based
    r: np.ndarray  # [N,3]
    v: np.ndarray  # [N,3]
    q: np.ndarray  # [N,4]
    L: np.ndarray  # [N,3]
    # optional per-thermostat config
    thermostat_temps: Optional[dict] = None
    component_thermostats: Optional[dict] = None
    # thermostat ids flagged "Undirected" (ASCIIReader.cpp:125-129):
    # subtract the directed (mean) velocity before kinetic sampling
    undirected_thermostats: Optional[set] = None


class _Tokens:
    """Tokenizer that remembers byte offsets, so the record section can be
    handed to the native scanner (ls1_mardyn_tpu_torch/native) or a
    header-only scan resume on the full text at the first record."""

    def __init__(self, text: str):
        self.toks = []
        self.ends = []  # byte offset just past each token
        off = 0
        for ln in text.splitlines(keepends=True):
            if not ln.lstrip().startswith("#"):
                base = off
                col = 0
                for t in ln.split():
                    col = ln.index(t, col)
                    self.toks.append(t)
                    self.ends.append(base + col + len(t))
                    col += len(t)
            off += len(ln)
        self.pos = 0

    def consumed_offset(self) -> int:
        """Byte offset just past the last consumed token."""
        return self.ends[self.pos - 1] if self.pos else 0

    def next(self) -> str:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def next_f(self) -> float:
        return float(self.next())

    def next_i(self) -> int:
        return int(self.next())

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def eof(self) -> bool:
        return self.pos >= len(self.toks)


def read_inp(path: str) -> PhaseSpaceData:
    with open(path) as f:
        text = f.read()
    # tokenize only the header region (records are scanned natively);
    # fall back to the full text for header-only files
    head = text[: 1 << 22]
    tk = _Tokens(head)
    if len(tk.toks) < 4:
        tk = _Tokens(text)

    magic = tk.next()
    if magic != "mardyn":
        raise ValueError(f"{path}: not a mardyn input file (got {magic!r})")
    tag = tk.next()
    version = tk.next()
    if tag != "trunk":
        raise ValueError(f"{path}: bad specifier {tag!r}")
    if int(version) < 20080701:
        raise ValueError(f"{path}: input version too old ({version})")

    components: List[Component] = []
    mixing_xi = None
    mixing_eta = None
    eps_rf = 1.0
    box = np.zeros(3)
    temperature = 0.0
    current_time = 0.0
    thermostat_temps: dict = {}
    component_thermostats: dict = {}
    undirected: set = set()
    num_molecules = 0
    mol_format = "ICRVQD"

    # --- header ----------------------------------------------------------
    while not tk.eof():
        token = tk.next()
        if token in ("currentTime", "t"):
            current_time = tk.next_f()
        elif token in ("Temperature", "T"):
            temperature = tk.next_f()
        elif token in ("ThermostatTemperature", "ThT", "h"):
            tid = tk.next_i()
            thermostat_temps[tid] = tk.next_f()
        elif token in ("ComponentThermostat", "CT", "o"):
            comp_id = tk.next_i() - 1
            tid = tk.next_i()
            if tid >= 0:
                component_thermostats[comp_id] = tid
        elif token in ("Undirected", "U"):
            # Domain::enableUndirectedThermostat analogue
            undirected.add(tk.next_i())
        elif token in ("Length", "L"):
            box = np.array([tk.next_f(), tk.next_f(), tk.next_f()])
        elif token in ("HeatCapacity", "cv", "I"):
            tk.next_i(), tk.next_f(), tk.next_f()
        elif token in ("NumberOfComponents", "C"):
            k = tk.next_i()
            for i in range(k):
                c = Component(cid=i)
                nlj, nc, nd, nq, nt = (tk.next_i() for _ in range(5))
                if nt != 0:
                    raise ValueError("tersoff no longer supported")
                for _ in range(nlj):
                    x, y, z, m, eps, sig, tcut, do_shift = (
                        tk.next_f() for _ in range(8)
                    )
                    c.add_ljcenter(x, y, z, m, eps, sig, tcut, do_shift != 0)
                for _ in range(nc):
                    x, y, z, m, qv = (tk.next_f() for _ in range(5))
                    c.add_charge(x, y, z, m, qv)
                for _ in range(nd):
                    x, y, z, ex, ey, ez, amy = (tk.next_f() for _ in range(7))
                    c.add_dipole(x, y, z, ex, ey, ez, amy)
                for _ in range(nq):
                    x, y, z, ex, ey, ez, aq = (tk.next_f() for _ in range(7))
                    c.add_quadrupole(x, y, z, ex, ey, ez, aq)
                I = np.array([tk.next_f(), tk.next_f(), tk.next_f()])
                if (I > 0).any():
                    c.I_override = I
                components.append(c)
            # mixing coefficients: upper triangle (ASCIIReader.cpp:214-223),
            # then epsilonRF.  Several shipped scenes (e.g.
            # VectorizationMultiComponentMultiPotentials*.inp) omit the
            # mixing block entirely and go straight to epsilonRF, so
            # count the float tokens ahead to decide the layout.
            mixing_xi = np.ones((k, k))
            mixing_eta = np.ones((k, k))
            n_pairs = k * (k - 1) // 2

            def _is_float(s):
                try:
                    float(s)
                    return True
                except (TypeError, ValueError):
                    return False

            nfloats = 0
            while (
                tk.pos + nfloats < len(tk.toks)
                and _is_float(tk.toks[tk.pos + nfloats])
            ):
                nfloats += 1
            if nfloats >= 2 * n_pairs + 1:
                for i in range(k):
                    for j in range(i + 1, k):
                        xi = tk.next_f()
                        eta = tk.next_f()
                        mixing_xi[i, j] = mixing_xi[j, i] = xi
                        mixing_eta[i, j] = mixing_eta[j, i] = eta
            eps_rf = tk.next_f()
        elif token in ("NumberOfMolecules", "N"):
            num_molecules = tk.next_i()
            break
        else:
            raise ValueError(f"{path}: invalid header token {token!r}")

    # --- molecule records ------------------------------------------------
    if tk.peek() in ("MoleculeFormat", "M"):
        tk.next()
        mol_format = tk.next()
    if mol_format not in ("ICRVQDV", "ICRVQD", "ICRV", "IRV"):
        raise ValueError(f"unknown molecule format {mol_format!r}")

    if not components:
        # ASCIIReader.cpp:330-336: default single 1CLJ component
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 6.0, False)
        components = [c]
        mixing_xi = np.ones((1, 1))
        mixing_eta = np.ones((1, 1))

    n = num_molecules
    mid = np.zeros(n, np.int64)
    cid = np.zeros(n, np.int32)
    r = np.zeros((n, 3))
    v = np.zeros((n, 3))
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
    L = np.zeros((n, 3))

    ncols = {"ICRVQDV": 18, "ICRVQD": 15, "ICRV": 8, "IRV": 7}[mol_format]
    raw = None
    if n > 0:
        # the record section through the native scanner (native/psio.cpp)
        from ls1_mardyn_tpu_torch.native import get_psio

        lib = get_psio()
        if lib is not None:
            out = np.empty(n * ncols, dtype=np.float64)
            got = lib.psio_read_records(
                path.encode(), tk.consumed_offset(), n, ncols,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            if got == n * ncols:
                raw = out.reshape(n, ncols)
    if raw is None:
        if len(tk.toks) - tk.pos < n * ncols:
            off = tk.consumed_offset()
            tk = _Tokens(text[off:])
        raw = np.array([tk.next_f() for _ in range(n * ncols)]).reshape(n, ncols)
    mid[:] = raw[:, 0].astype(np.int64)
    if mol_format == "IRV":
        cid[:] = 0
        r[:] = raw[:, 1:4]
        v[:] = raw[:, 4:7]
    else:
        cid[:] = raw[:, 1].astype(np.int32) - 1  # 1-based in file
        r[:] = raw[:, 2:5]
        v[:] = raw[:, 5:8]
        if mol_format in ("ICRVQD", "ICRVQDV"):
            q[:] = raw[:, 8:12]
            L[:] = raw[:, 12:15]

    if (cid < 0).any() or (cid >= len(components)).any():
        raise ValueError(f"{path}: molecule with componentid out of range")

    return PhaseSpaceData(
        components=components,
        mixing_xi=mixing_xi,
        mixing_eta=mixing_eta,
        eps_rf=eps_rf,
        box=box,
        temperature=temperature,
        current_time=current_time,
        mid=mid,
        cid=cid,
        r=r,
        v=v,
        q=q,
        L=L,
        thermostat_temps=thermostat_temps or None,
        component_thermostats=component_thermostats or None,
        undirected_thermostats=undirected or None,
    )


def _f(x) -> str:
    """Full-precision float formatting (repr of python float)."""
    return repr(float(x))


def write_inp(path: str, data: PhaseSpaceData, mol_format: str = "ICRVQD"):
    """ASCII checkpoint writer; format parity with
    Domain::writeCheckpointHeader (src/Domain.cpp:485-)
    + CheckpointWriter molecule records."""
    K = len(data.components)
    with open(path, "w") as f:
        f.write("mardyn trunk 20120726\n")
        f.write(f"currentTime\t{_f(data.current_time)}\n")
        f.write(f"Length\t{_f(data.box[0])} {_f(data.box[1])} {_f(data.box[2])}\n")
        f.write(f"Temperature\t{_f(data.temperature)}\n")
        f.write(f"NumberOfComponents\t{K}\n")
        for c in data.components:
            f.write(
                f"{len(c.ljcenters)} {len(c.charges)} {len(c.dipoles)} "
                f"{len(c.quadrupoles)} 0\n"
            )
            for s in c.ljcenters:
                do_shift = 1 if s.shift6 != 0.0 else 0
                # tcutoff is not recoverable from shift6; store 0 when
                # unshifted (matches Domain.cpp checkpoint behavior of
                # writing the original site parameters)
                f.write(
                    f"{_f(s.r[0])} {_f(s.r[1])} {_f(s.r[2])}\t{_f(s.m)} "
                    f"{_f(s.eps)} {_f(s.sigma)} {_f(0.0)} {do_shift}\n"
                )
            for s in c.charges:
                f.write(f"{_f(s.r[0])} {_f(s.r[1])} {_f(s.r[2])}\t{_f(s.m)} {_f(s.q)}\n")
            for s in c.dipoles:
                f.write(
                    f"{_f(s.r[0])} {_f(s.r[1])} {_f(s.r[2])}\t{_f(s.e[0])} "
                    f"{_f(s.e[1])} {_f(s.e[2])} {_f(s.abs_my)}\n"
                )
            for s in c.quadrupoles:
                f.write(
                    f"{_f(s.r[0])} {_f(s.r[1])} {_f(s.r[2])}\t{_f(s.e[0])} "
                    f"{_f(s.e[1])} {_f(s.e[2])} {_f(s.abs_q)}\n"
                )
            I = c.inertia()
            f.write(f"{_f(I[0])} {_f(I[1])} {_f(I[2])}\n")
        for i in range(K):
            for j in range(i + 1, K):
                f.write(f"{_f(data.mixing_xi[i, j])} {_f(data.mixing_eta[i, j])}\n")
        f.write(f"{_f(data.eps_rf)}\n")
        n = len(data.mid)
        f.write(f"NumberOfMolecules\t{n}\n")
        f.write(f"MoleculeFormat\t{mol_format}\n")
        f.flush()
        # the records through the native writer (%.17g, as the JAX
        # package's write_inp when its toolchain is there)
        from ls1_mardyn_tpu_torch.native import get_psio

        lib = get_psio()
        if lib is not None and n > 0:
            cols = [data.mid.astype(np.float64)[:, None]]
            int_cols = [0]
            if mol_format != "IRV":
                cols.append((data.cid + 1).astype(np.float64)[:, None])
                int_cols.append(1)
            cols += [data.r, data.v]
            if mol_format in ("ICRVQD", "ICRVQDV"):
                cols += [data.q, data.L]
            if mol_format == "ICRVQDV":
                cols.append(np.zeros((n, 3)))
            rec = np.ascontiguousarray(np.concatenate(cols, axis=1))
            ic = np.asarray(int_cols, dtype=np.int64)
            rc_ = lib.psio_write_records(
                path.encode(), n, rec.shape[1],
                rec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ic.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                len(int_cols),
            )
            if rc_ == 0:
                return
        for i in range(n):
            rec = [str(int(data.mid[i]))]
            if mol_format != "IRV":
                rec.append(str(int(data.cid[i]) + 1))
            rec += [_f(x) for x in data.r[i]]
            rec += [_f(x) for x in data.v[i]]
            if mol_format in ("ICRVQD", "ICRVQDV"):
                rec += [_f(x) for x in data.q[i]]
                rec += [_f(x) for x in data.L[i]]
            if mol_format == "ICRVQDV":
                rec += ["0.0", "0.0", "0.0"]
            f.write("\t".join(rec) + "\n")
