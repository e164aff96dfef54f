"""Grand-canonical (muVT) ensemble: Metropolis insertions and deletions
(the counterpart of ls1_mardyn_tpu/ensemble/grand_canonical.py).

The reference's GrandCanonicalEnsemble + ChemicalPotential
(src/ensemble/GrandCanonicalEnsemble.cpp:92-137 afterForces hook,
ChemicalPotential.{h,cpp}): every `interval` steps, attempt deletions
and insertions in a control volume with Metropolis acceptance at
chemical potential mu.

Acceptance (standard GCMC, reduced units, Lambda == 1):
  insert:  acc = min(1, V/(N+1) * exp((mu - dU)/T))
  delete:  acc = min(1, N/V * exp((-mu + E_mol)/T))
with dU the insertion energy and E_mol the deleted molecule's
interaction energy (the detailed-balance sign, as in the JAX package;
the reference's decideDeletion, ChemicalPotential.cpp:294, uses
exp(+mu/T + E/T)).

The molecule array has a fixed capacity with a validity mask:
insertion activates a free slot, deletion clears the mask.  A cycle is
`deletions_per_interval` deletions followed by
`insertions_per_interval` insertions, each trial seeing the state the
one before it left (the reference's _instances loop,
ChemicalPotential.h:23,101).  It runs on the state's device: the
trials' picks, probe energies, decisions and slot writes are tensor
operations, and the host reads the three counters and the probe
table's overflow flag once per cycle.

A cycle is a function of the state and of explicit draws (draws()):
per deletion a uniform for the pick (the pick is 1 + floor(u * total)
among the `total` candidates, computed on the device) and one for the
acceptance; per insertion three uniforms for the position, one for the
acceptance and seven normals (quaternion, velocity).  They come from a
torch.Generator on the ensemble's device, seeded as the JAX package's
key (seed 1234).

Probes: small scenes use the O(N) minimum-image row
(single_molecule_energy); from CELL_PROBE_MIN_N the cycle bins the
state once into a cell table and each trial reads only its 27-cell
neighbourhood (cell_probe_energy, the LinkedCells::getEnergy
analogue), with the same-cycle insertions taken from a delta list.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ls1_mardyn_tpu_torch.models.interaction import PairParams, molecule_pair
from ls1_mardyn_tpu_torch.models.quaternion import qrotate
from ls1_mardyn_tpu_torch.models.oracle import min_image
from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_particles
from ls1_mardyn_tpu_torch.state import MoleculeState, resolve_device

_OFFS27 = np.array(
    [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
     for dx in (-1, 0, 1)],
    np.int32,
)


@functools.lru_cache(maxsize=None)
def _grid_consts(dims, dtype, device):
    """The 27 neighbour offsets and the grid's dims (int and float) on
    the device, made once: a host tensor sent to the card waits for its
    queue."""
    return (torch.as_tensor(_OFFS27, device=device),
            torch.tensor(dims, dtype=torch.int32, device=device),
            torch.tensor(dims, dtype=dtype, device=device))


# site_offsets' kinds and the body-frame tables they rotate
_SITE_TABLES = dict(lj="lj_pos", charge="charge_pos", dip="dip_pos",
                    dip_e="dip_e", quad="quad_pos", quad_e="quad_e")


class _Sites(dict):
    """models.interaction.site_offsets, kind by kind on first use: a
    probe's pair terms read only their kinds, and a kind whose table is
    all zero (every 1CLJ offset) is zeros without a rotation.  The
    values are site_offsets' (a rotated zero is zero)."""

    def __init__(self, pp, q, cid):
        super().__init__()
        self.pp, self.qb, self.cid = pp, q[..., None, :], cid.long()

    def __missing__(self, kind):
        table = getattr(self.pp, _SITE_TABLES[kind])
        d = table[self.cid]
        if self.pp.has(_SITE_TABLES[kind]):
            d = qrotate(self.qb, d)
        else:
            d = torch.zeros(torch.broadcast_shapes(self.qb.shape[:-1], d.shape[:-1])
                            + (3,), dtype=d.dtype, device=d.device)
        self[kind] = d
        return d


def _pair_energy(pp, box, r_p, q_p, cid_p, r_j, q_j, cid_j, ok):
    """Energy of probe(s) r_p [..., 3] with candidates r_j [..., M, 3]
    (ok [..., M]: the candidates that count), each pair once: the
    FluidPot sum (potforce.h:506-651)."""
    drm_raw = min_image(r_p[..., None, :] - r_j, box)
    com2 = (drm_raw * drm_raw).sum(-1)
    mask_lj = ok & (com2 < pp.rc2_lj)
    mask_el = ok & (com2 < pp.rc2)
    fill = torch.cat([(3.0 * torch.sqrt(pp.rc2) + 1.0).reshape(1),
                      torch.zeros(2, dtype=r_j.dtype, device=r_j.device)])
    drm = torch.where((mask_lj | mask_el)[..., None], drm_raw, fill)
    sites_j = _Sites(pp, q_j, cid_j)
    sites_p = _Sites(pp, q_p[..., None, :], cid_p[..., None])
    out = molecule_pair(drm, sites_p, sites_j, cid_p[..., None], cid_j, pp,
                        mask_lj, mask_el)
    return (out["u6lj"].sum(-1) / 6.0 + out["uX"].sum(-1)
            + out["my_rf"].sum(-1))


def single_molecule_energy(mol: MoleculeState, pp: PairParams, box,
                           r_probe, q_probe, cid_probe, exclude_idx):
    """Interaction energy of one (possibly virtual) molecule with the
    whole system, the O(N) minimum-image row (used by ChemicalPotential
    via ParticleContainer::getEnergy).  cid_probe: a 0-d int tensor;
    exclude_idx: a slot index tensor ([1] or 0-d), -1 for none."""
    ok = mol.valid & (torch.arange(mol.capacity, device=mol.r.device)
                      != exclude_idx)
    return _pair_energy(pp, box, r_probe, q_probe, cid_probe, mol.r, mol.q,
                        mol.cid, ok)


def _neighbour_slots(slots, dims, box, r_probe):
    """The probe table's entries of the 27 cells around r_probe
    [..., 3]: [..., 27 * cap] molecule indices, -1 for empty."""
    nx, ny, _nz = dims
    offs, dims_i, dims_f = _grid_consts(tuple(dims), r_probe.dtype,
                                        r_probe.device)
    cl = box / dims_f
    c3 = torch.floor(r_probe / cl).to(torch.int32)
    c3 = torch.minimum(torch.clamp(c3, min=0), dims_i - 1)
    nb = torch.remainder(c3[..., None, :] + offs, dims_i)  # [..., 27, 3]
    lin = (nb[..., 2] * ny + nb[..., 1]) * nx + nb[..., 0]
    return slots[lin.long()].flatten(-2)


def cell_probe_energy(mol: MoleculeState, pp: PairParams, box, slots, dims,
                      r_probe, q_probe, cid_probe, exclude_idx, freed=None):
    """Probe energy against the 27-cell neighbourhood of r_probe instead
    of the whole molecule array (LinkedCells::getEnergy is cell-local
    too).  Needs cell edges >= the cutoff.  Cost per trial O(27*cap),
    independent of N.

    freed: optional [capacity] bool, the slots whose table entry is
    stale because a deletion of this cycle freed them; such a row is
    masked even if the slot is live again (a same-cycle insertion that
    reused it sits at a new position and is counted by the caller's
    delta list)."""
    return _pair_energy(pp, box, r_probe, q_probe, cid_probe, *_cell_candidates(
        mol, slots, dims, box, r_probe, exclude_idx, freed))


def _cell_candidates(mol, slots, dims, box, r_probe, exclude_idx, freed=None):
    """(r, q, cid, ok) of the probe table's entries in the 27 cells
    around r_probe; ok masks empty entries, invalid and excluded slots
    and (with freed) the stale rows."""
    cand = _neighbour_slots(slots, dims, box, r_probe)
    safe = torch.clamp(cand, 0, mol.capacity - 1).long()
    ok = (cand >= 0) & mol.valid[safe] & (cand != exclude_idx)
    if freed is not None:
        ok = ok & ~freed[safe]
    return mol.r[safe], mol.q[safe], mol.cid[safe], ok


# bytes of the [chunk, N] pair rows of one pass of a dense probe (the
# Widom sampler's batched probe, the cavity count)
PASS_BYTES = 1 << 30


def pass_rows(row_bytes):
    """Probes a pass of rows of row_bytes each takes under PASS_BYTES."""
    return max(1, int(PASS_BYTES // max(row_bytes, 1)))


def probe_reach(pp: PairParams) -> float:
    """The longest cutoff of pp: the probe table's least cell edge."""
    return float(np.sqrt(max(float(pp.rc2), float(pp.rc2_lj))))


def cell_probe_geometry(capacity, volume, box, reach, min_n=0):
    """(dims, cap) of a probe table, or None: edges >= reach, >= 3
    cells an axis (the 27-stencil would count a cell twice under the
    periodic wrap otherwise), capacity from the mean density with 2x
    headroom (doubled on a measured overflow, probe_table)."""
    box = np.asarray(box, float)
    if reach <= 0:
        return None
    dims = tuple(max(1, int(np.floor(b / reach))) for b in box)
    if capacity < min_n or min(dims) < 3:
        return None
    edge_vol = float(np.prod(box / np.asarray(dims)))
    rho = capacity / volume  # upper bound on the density
    cap = int(2 ** np.ceil(np.log2(max(2.0 * rho * edge_vol, 8))))
    return dims, cap


def probe_table(mol: MoleculeState, box, geom, checked=True):
    """The state binned into the probe table of geom = (dims, cap):
    (slots, geom, overflow).  checked: a table whose cells overflow is
    built again with twice the capacity (a host read a build) and geom
    is the one that fit; unchecked (the GCMC cycle, which reads the flag
    with its counters and reruns), one build."""
    dims, cap = geom
    while True:
        bins = bin_particles(mol.r, mol.valid, CellGridSpec(
            dims=tuple(dims), box=tuple(float(b) for b in box), cap=cap))
        if not checked or not bool(bins.overflow):
            return bins.slots, (dims, cap), bins.overflow
        cap *= 2


def probe_energies(mol: MoleculeState, pp: PairParams, box, r_probe, q_probe,
                   cid_probe, table=None, dims=None):
    """Energies [B] of B test molecules (no exclusion) with the system:
    through the probe table's 27 cells when one is given, else the O(N)
    rows, a pass of PASS_BYTES at a time (the widom sampler's batched
    probe)."""
    if table is not None:
        cand = _neighbour_slots(table, dims, box, r_probe)
        safe = torch.clamp(cand, 0, mol.capacity - 1).long()
        ok = (cand >= 0) & mol.valid[safe]
        return _pair_energy(pp, box, r_probe, q_probe, cid_probe,
                            mol.r[safe], mol.q[safe], mol.cid[safe], ok)
    S = int(pp.lj_pos.shape[1]) + int(pp.charge_pos.shape[1])
    step = pass_rows(mol.capacity * (3 + S * S * 3) * 4 * mol.r.element_size())
    out = []
    for a in range(0, r_probe.shape[0], step):
        out.append(_pair_energy(pp, box, r_probe[a:a + step],
                                q_probe[a:a + step], cid_probe, mol.r, mol.q,
                                mol.cid, mol.valid))
    return torch.cat(out)


@dataclasses.dataclass
class ChemicalPotential:
    """Per-component muVT control (ChemicalPotential.h)."""

    mu: float
    component: int = 0
    interval: int = 100
    insertions_per_interval: int = 1
    deletions_per_interval: int = 1
    control_lower: Optional[np.ndarray] = None  # default: whole box
    control_upper: Optional[np.ndarray] = None


@dataclasses.dataclass
class _CycleConsts:
    """A chemical potential's device constants (made once)."""

    box: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    comp: torch.Tensor  # 0-d int32
    vscale: torch.Tensor  # sqrt(T / m) of the component


class GrandCanonicalEnsemble:
    """GCMC moves on top of the MD engine, run in the afterForces slot of
    the step loop (GrandCanonicalEnsemble.cpp:92-137).  step() takes and
    returns a MoleculeState; the input is not modified (a cycle whose
    probe table overflowed is run again on it with a doubled table)."""

    # molecule capacities from this one on use the cell-table probe;
    # below, the O(N) row is cheaper than building the table
    CELL_PROBE_MIN_N = 16384

    def __init__(self, chem_pots, temperature: float, box, seed: int = 1234,
                 device="cuda"):
        self.chem_pots = list(chem_pots)
        self.T = float(temperature)
        self.box = np.asarray(box, float)
        self.volume = float(np.prod(self.box))
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.attempted = 0
        self.accepted_ins = 0
        self.accepted_del = 0
        self.cycles = 0
        self._probe_caps = {}
        self._consts = {}

    def draws(self, icp: int, dtype):
        """The explicit draws of one cycle of chemical potential icp:
        u [nd + ni, 4] uniforms (deletion i: u[i, 0] the pick, u[i, 1]
        the acceptance; insertion j: u[nd + j, :3] the position,
        u[nd + j, 3] the acceptance) and z [ni, 7] normals (insertion
        j: z[j, :4] the quaternion, z[j, 4:] the velocity)."""
        cp = self.chem_pots[icp]
        nd, ni = cp.deletions_per_interval, cp.insertions_per_interval
        kw = dict(generator=self.generator, dtype=dtype, device=self.device)
        return torch.rand((nd + ni, 4), **kw), torch.randn((ni, 7), **kw)

    def _probe_geometry(self, mol, pp):
        return cell_probe_geometry(mol.capacity, self.volume, self.box,
                                   probe_reach(pp), self.CELL_PROBE_MIN_N)

    def _constants(self, icp, pp, dtype, device) -> _CycleConsts:
        key = (icp, dtype, device)
        if key not in self._consts:
            cp = self.chem_pots[icp]
            lo = cp.control_lower if cp.control_lower is not None else np.zeros(3)
            hi = cp.control_upper if cp.control_upper is not None else self.box

            def t(x):
                return torch.as_tensor(np.asarray(x, float), dtype=dtype,
                                       device=device)

            T = torch.full((), self.T, dtype=dtype, device=device)
            self._consts[key] = _CycleConsts(
                box=t(self.box), lo=t(lo), hi=t(hi),
                comp=torch.tensor(cp.component, dtype=torch.int32,
                                  device=device),
                vscale=torch.sqrt(T / pp.mass[cp.component]),
            )
        return self._consts[key]

    def step(self, mol: MoleculeState, pp: PairParams, step: int) -> MoleculeState:
        for icp, cp in enumerate(self.chem_pots):
            if step % cp.interval:
                continue
            if icp not in self._probe_caps:
                self._probe_caps[icp] = self._probe_geometry(mol, pp)
            u, z = self.draws(icp, mol.r.dtype)
            while True:
                geom = self._probe_caps[icp]
                out, n_del, n_ins, ovf = self._cycle(mol, pp, icp, geom, u, z)
                # the one read of the cycle
                n_del, n_ins, ovf = torch.stack(
                    [n_del, n_ins, ovf.to(torch.int64)]).tolist()
                if geom is None or not ovf:
                    mol = out
                    break
                # probe-table overflow: the cycle's result is discarded;
                # double the table capacity and run it again on the
                # untouched input with the same draws
                self._probe_caps[icp] = (geom[0], 2 * geom[1])
            self.attempted += cp.deletions_per_interval + cp.insertions_per_interval
            self.accepted_del += n_del
            self.accepted_ins += n_ins
            self.cycles += 1
        return mol

    def _cycle(self, mol: MoleculeState, pp: PairParams, icp: int, probe, u, z):
        """One grand-canonical cycle on the state's device: returns the
        new state and the device counters (deletions, insertions, probe
        table overflow).  probe=(dims, cap) selects the cell-table
        probe: the molecules are binned once a cycle, deletions need no
        table upkeep (the table stores indices; validity and positions
        are read live), and same-cycle insertions join each probe's
        candidates from a delta list."""
        cp = self.chem_pots[icp]
        dev, dtype = mol.r.device, mol.r.dtype
        c = self._constants(icp, pp, dtype, dev)
        nd = int(cp.deletions_per_interval)
        ni = int(cp.insertions_per_interval)
        table = None
        ovf = torch.zeros((), dtype=torch.bool, device=dev)
        if probe is not None:
            table, _, ovf = probe_table(mol, self.box, probe, checked=False)
        # the cycle writes its own copy; the input stays for a rerun
        if ni:
            st = MoleculeState(*(x.clone() for x in (
                mol.r, mol.v, mol.q, mol.L, mol.cid, mol.mid, mol.valid)))
        else:
            st = dataclasses.replace(mol, valid=mol.valid.clone())
        freed = (torch.zeros((mol.capacity,), dtype=torch.bool, device=dev)
                 if probe is not None else None)
        deltas = None
        if probe is not None and ni:
            deltas = (torch.zeros((ni, 3), dtype=dtype, device=dev),
                      torch.zeros((ni, 4), dtype=dtype, device=dev),
                      torch.full((ni,), -1, dtype=torch.int32, device=dev))

        def probe_e(r_p, q_p, cid_p, excl):
            if probe is None:
                return single_molecule_energy(st, pp, c.box, r_p, q_p, cid_p,
                                              excl)
            r_j, q_j, cid_j, ok = _cell_candidates(st, table, probe[0], c.box,
                                                   r_p, excl, freed)
            if deltas is not None:
                # same-cycle insertions are absent from the table: their
                # rows join the candidates (validity read live)
                d_r, d_q, d_idx = deltas
                dsafe = torch.clamp(d_idx, 0, mol.capacity - 1).long()
                okd = (d_idx >= 0) & st.valid[dsafe] & (d_idx != excl)
                r_j, q_j = torch.cat([r_j, d_r]), torch.cat([q_j, d_q])
                cid_j = torch.cat([cid_j, st.cid[dsafe]])
                ok = torch.cat([ok, okd])
            return _pair_energy(pp, c.box, r_p, q_p, cid_p, r_j, q_j, cid_j, ok)

        # positions and components stay while the deletions run (they
        # clear validity only): their candidates' mask once; the live
        # count carried along
        n_live = st.valid.sum()
        if nd:
            in_cv = (st.cid == c.comp) & ((st.r >= c.lo) & (st.r < c.hi)).all(-1)
        n_del = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(nd):
            cand = st.valid & in_cv
            cnt = torch.cumsum(cand, 0)
            total = cnt[-1]
            tmax = torch.clamp(total, min=1)
            pick = 1 + torch.minimum(
                torch.floor(u[i, 0].double() * tmax.double()).long(), tmax - 1)
            idx = torch.clamp(torch.searchsorted(cnt, pick.view(1)),
                              0, mol.capacity - 1)
            # (a gather and a view: indexing by a 0-d tensor would read it)
            e_mol = probe_e(st.r[idx][0], st.q[idx][0], st.cid[idx][0], idx)
            acc = torch.clamp(
                n_live.to(dtype) / self.volume * torch.exp((-cp.mu + e_mol) / self.T),
                max=1.0)
            do = (total > 0) & (u[i, 1] < acc)
            n_live = n_live - do.to(n_live.dtype)
            st.valid.index_put_((idx,), st.valid[idx] & ~do)
            if freed is not None:
                # the slot's table entry is stale from here on
                freed.index_put_((idx,), freed[idx] | do)
            n_del = n_del + do.to(torch.int32)

        n_ins = torch.zeros((), dtype=torch.int32, device=dev)
        if ni:
            mid_max = st.mid.max()  # an accepted insertion raises it
        for j in range(ni):
            uj, zj = u[nd + j], z[j]
            free = ~st.valid
            has_free = free.any()
            if freed is not None:
                # prefer slots that were not freed this cycle (a reused
                # freed slot's stale row is masked, so this keeps table
                # hits, not correctness)
                fresh = free & ~freed
                idx = torch.where(fresh.any(), fresh.to(torch.uint8).argmax(),
                                  free.to(torch.uint8).argmax())
            else:
                idx = free.to(torch.uint8).argmax()  # first free slot
            idx = idx.view(1)
            r_new = torch.maximum(c.lo, uj[:3] * (c.hi - c.lo) + c.lo)
            q_new = zj[:4] / torch.sqrt((zj[:4] * zj[:4]).sum())
            du = probe_e(r_new, q_new, c.comp,
                         torch.full((1,), -1, dtype=torch.int64, device=dev))
            acc = torch.clamp(
                self.volume / (n_live.to(dtype) + 1.0) * torch.exp((cp.mu - du) / self.T),
                max=1.0)
            do = has_free & (uj[3] < acc)
            n_live = n_live + do.to(n_live.dtype)
            v_new = zj[4:] * c.vscale
            mid_new = mid_max + 1
            mid_max = torch.where(do, mid_new, mid_max)

            def w(a, val):
                a.index_put_((idx,), torch.where(do, val, a[idx]))

            w(st.r, r_new)
            w(st.v, v_new)
            w(st.q, q_new)
            w(st.L, torch.zeros((3,), dtype=dtype, device=dev))
            w(st.cid, c.comp)
            w(st.mid, mid_new)
            w(st.valid, torch.ones((), dtype=torch.bool, device=dev))
            if deltas is not None:
                d_r, d_q, d_idx = deltas
                d_r[j] = torch.where(do, r_new, d_r[j])
                d_q[j] = torch.where(do, q_new, d_q[j])
                d_idx[j] = torch.where(do, idx[0].to(torch.int32), d_idx[j])
            n_ins = n_ins + do.to(torch.int32)
        return st, n_del, n_ins, ovf


def _build_chemical_potentials(specs, box):
    """XML <chemicalpotential> blocks -> ChemicalPotential list with the
    reference's full semantics: per-component mu, cycle interval,
    trial-instance counts (ChemicalPotential.h:23,101 _instances) and an
    optional restricted control volume (setControlVolume role; nested
    <control><lower>/<upper> x/y/z).  box: the world frame's."""
    cps = []
    for spec_ in specs:
        p_ = spec_.params
        inst = int(float(p_.get("instances", 1)))
        lo = hi = None
        ctl = p_.get("control")
        if isinstance(ctl, dict):
            low, up = ctl.get("lower"), ctl.get("upper")
            if isinstance(low, dict):
                lo = np.array([float(low.get(a, 0.0)) for a in "xyz"])
            if isinstance(up, dict):
                hi = np.array(
                    [float(up.get(a, b)) for a, b in zip("xyz", box)]
                )
        cps.append(
            ChemicalPotential(
                mu=float(p_.get("mu", 0.0)),
                component=int(p_.get("cid", p_.get("componentid", 1))) - 1,
                # "everyNTimesteps" is the spelling some legacy-style
                # configs use for ChemicalPotential::setInterval
                interval=int(float(
                    p_.get("interval", p_.get("everyNTimesteps", 100))
                )),
                insertions_per_interval=int(
                    float(p_.get("insertions", inst))
                ),
                deletions_per_interval=int(
                    float(p_.get("deletions", inst))
                ),
                control_lower=lo,
                control_upper=hi,
            )
        )
    return cps
