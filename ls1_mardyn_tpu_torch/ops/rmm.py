"""Reduced-memory-mode (RMM) dense-state simulation for 1CLJ fluids
(the counterpart of ls1_mardyn_tpu/ops/rmm.py: RMMSimulation, its
production configuration).

The primary state lives in the kernels' dense cell layout
  planes [nz, ny, 8, nx*cap]  =  (x, y, z, valid, vx, vy, vz, mid)
with CELL-LOCAL coordinates: each slot stores its position relative to
its own cell's origin, so f32 keeps ~1e-7 absolute precision whatever
the box size, and periodicity is exact integer cell arithmetic.

Per step: Kahan-compensated leapfrog, forces through kernel K1
(ops/cuda_lj.py: each pair once by the half shell, the reactions added
to j by atomics, so the last bits of the forces vary from run to run),
global values and the global velocity-scaling thermostat.  Every `rebin_every` steps the nearest-neighbour
shift-merge rebin, kernel K2 (ops/cuda_rebin.py), re-packs the cells;
when it overflows (a cell full, or a molecule hopped more than one
cell) the global-sort rebin `_rebin` runs on the same state.

The JAX engine's kernel switches (cw, cwn3l, lanej, n3l, zb, ...) are
not carried over: every force evaluation runs K1.  The kernels behind
them (K3, K4, K7, K8, K9) are library functions with their plain
versions, held against their JAX kernels at kernel level
(tests/test_torch_lj_variants.py, tests/test_torch_lj_cw_row.py); on
the H100 K1 takes as long as the fastest of them or less (PERF.md,
section 6).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ls1_mardyn_tpu_torch.ops.cells import CellGridSpec, bin_by_id, wrap_positions
from ls1_mardyn_tpu_torch.ops.cuda_lj import (
    SENTINEL_SCALE,
    lj_cell_forces,
    sentinel_eligible,
)
from ls1_mardyn_tpu_torch.ops.cuda_rebin import rebin_shift
from ls1_mardyn_tpu_torch.ops.globals import GlobalValues, calculate_global_values
from ls1_mardyn_tpu_torch.state import Macroscopic, MoleculeState

NP_RMM = 8  # planes: x, y, z, valid, vx, vy, vz, mid


class CellCapacityError(RuntimeError):
    """Cell occupancy exceeds the grid capacity.  Distinct from plain
    RuntimeError so capacity-escalation retry loops don't swallow
    unrelated failures."""


@dataclasses.dataclass
class RMMState:
    planes: torch.Tensor  # [nz, ny, 8, nx*cap]
    forces: torch.Tensor  # [nz, ny, 3, nx*cap] from the previous evaluation
    # Kahan compensation planes for velocity and position accumulation
    # (f32 compute, effectively-f64 accumulate; the reference's SPDP
    # mixed-precision mode, SIMD_TYPES.h:110-113)
    vcomp: torch.Tensor  # [nz, ny, 3, nx*cap]
    rcomp: torch.Tensor  # [nz, ny, 3, nx*cap]
    u6: torch.Tensor
    vir: torch.Tensor


class RMMSimulation:
    """Single-device dense-state 1CLJ NVT/NVE engine."""

    def __init__(
        self,
        table,
        pp,
        box,
        spec: CellGridSpec,
        dt: float,
        target_temperature: float = 0.0,
        thermostat: bool = True,
        rebin_every: int = 8,
        sample_every: int = 8,
        upot_corr: float = 0.0,
        virial_corr: float = 0.0,
        device="cuda",
    ):
        assert table.K == 1 and len(table.components[0].ljcenters) == 1
        self.spec = spec
        self.device = torch.device(device)
        self.box = tuple(float(b) for b in np.asarray(box))
        self.dt = float(dt)
        self.volume = float(np.prod(self.box))
        self.mass = float(table.mass[0])
        self.target_temperature = float(target_temperature)
        self.thermostat = thermostat
        self.rebin_every = rebin_every
        self.sample_every = sample_every
        self.upot_corr = float(upot_corr)
        self.virial_corr = float(virial_corr)
        self.eps24 = float(table.eps24[0, 0, 0, 0])
        self.sig2 = float(table.sig2[0, 0, 0, 0])
        self.shift6 = float(table.shift6[0, 0, 0, 0])
        self.rc2 = float(table.lj_cutoff ** 2)
        self.cell_len = tuple(float(c) for c in spec.cell_len)
        # the 27-cell traversal needs cell edge >= rc (up to rounding:
        # an edge of exactly rc misses no pair, the cutoff being strict)
        if min(self.cell_len) < float(table.lj_cutoff) * (1.0 - 1e-12):
            raise ValueError(
                f"RMM grid {spec.dims}: cell edge {min(self.cell_len)} < rc"
            )
        # empty slots carry y_local = SENTINEL_SCALE*(1+slot) where the
        # layout admits it, as in the JAX package (state parity)
        self.sentinel = sentinel_eligible(spec.cell_len, self.rc2, spec.cap)
        self.state: RMMState = None
        self._k = 0
        # how often the shift rebin overflowed into the global rebin
        self.n_rebin_fallback = 0

    # -- kernel -------------------------------------------------------------
    def _kernel(self, planes, compute_macro=True):
        """(f [nz,ny,3,nx*cap], u6, vir) of the state `planes` by K1."""
        return lj_cell_forces(
            planes[:, :, :4, :], dims=self.spec.dims, cap=self.spec.cap,
            cell_len=self.cell_len, eps24=self.eps24, sig2=self.sig2,
            shift6=self.shift6, rc2=self.rc2, compute_macro=compute_macro)

    # -- step ---------------------------------------------------------------
    @staticmethod
    def _kahan(x, comp, inc):
        """Compensated accumulation x += inc (Kahan-Neumaier)."""
        y = inc - comp
        t = x + y
        comp_new = (t - x) - y
        return t, comp_new

    def _step(self, st: RMMState, compute_macro=True) -> Tuple[RMMState, GlobalValues]:
        dt = self.dt
        inv2m = 0.5 * dt / self.mass
        p = st.planes
        w = p[:, :, 3:4, :]
        v, vc = self._kahan(p[:, :, 4:7, :], st.vcomp, inv2m * st.forces * w)
        r, rc_ = self._kahan(p[:, :, 0:3, :], st.rcomp, dt * v * w)
        planes = torch.cat([r, w, v, p[:, :, 7:8, :]], dim=2)

        f, u6, vir = self._kernel(planes, compute_macro)

        v, vc = self._kahan(v, vc, inv2m * f * w)

        dtype = p.dtype
        summv2 = self.mass * torch.sum(v * v * w)
        nmol = torch.sum(w)
        zero = torch.zeros((), dtype=dtype, device=p.device)
        macro = Macroscopic(
            upot6lj=u6,
            upot_xpoles=zero + self.upot_corr,
            virial=vir + self.virial_corr,
            my_rf=zero,
        )
        gv = calculate_global_values(
            macro, summv2, zero, nmol, zero, self.volume,
            self.target_temperature, nve=not self.thermostat,
        )
        if self.thermostat and self.target_temperature > 0:
            v = v * gv.beta_trans
            vc = vc * gv.beta_trans
        # r and w are unchanged since the kernel read them: update the
        # velocity planes of the kernel's input in place
        planes[:, :, 4:7, :] = v
        return (
            RMMState(planes=planes, forces=f, vcomp=vc, rcomp=rc_,
                     u6=u6, vir=vir),
            gv,
        )

    def _empty_fill(self, ncols, dtype):
        """Fill rows for empty slots: zeros, or the sentinel
        y_local = SENTINEL_SCALE*(1 + slot_in_cell)."""
        if not self.sentinel:
            return torch.zeros((), dtype=dtype, device=self.device)
        cap = self.spec.cap
        slot = torch.arange(self.spec.n_cells * cap, device=self.device) % cap
        fill = torch.zeros((slot.shape[0], ncols), dtype=dtype, device=self.device)
        fill[:, 1] = SENTINEL_SCALE * (1.0 + slot.to(dtype))
        return fill

    def _slot_cells(self) -> torch.Tensor:
        """Per-slot cell coordinates [slots, 3] (z-major rows, x-cell =
        lane // cap), int64."""
        nx, ny, nz = self.spec.dims
        cap = self.spec.cap
        z = np.repeat(np.arange(nz), ny * nx * cap)
        y = np.tile(np.repeat(np.arange(ny), nx * cap), nz)
        x = np.tile(np.repeat(np.arange(nx), cap), nz * ny)
        return torch.as_tensor(np.stack([x, y, z], -1), device=self.device)

    # -- rebin (every k steps) ----------------------------------------------
    def _fold(self, st: RMMState) -> torch.Tensor:
        """Fold the Kahan compensators into their primaries: the
        11-column stack [nz, ny, 11, nx*cap] the rebins move."""
        p = st.planes
        r = p[:, :, 0:3, :] + st.rcomp
        v = p[:, :, 4:7, :] + st.vcomp
        return torch.cat([r, p[:, :, 3:4, :], v, p[:, :, 7:8, :], st.forces], dim=2)

    def _from_stack(self, out, st: RMMState) -> RMMState:
        planes = out[:, :, 0:NP_RMM, :].contiguous()
        forces = out[:, :, NP_RMM:, :].contiguous()
        zero3 = torch.zeros_like(forces)
        return RMMState(planes=planes, forces=forces, vcomp=zero3,
                        rcomp=zero3.clone(), u6=st.u6, vir=st.vir)

    def _rebin_shift(self, st: RMMState):
        """3-stage nearest-neighbour shift-merge rebin through kernel
        K2.  Returns (state, overflow 0-d bool tensor)."""
        out, overflow = rebin_shift(
            self._fold(st),
            dims=self.spec.dims,
            cap=self.spec.cap,
            cell_len=self.cell_len,
            sentinel=self.sentinel,
        )
        return self._from_stack(out, st), overflow

    def _rebin(self, st: RMMState):
        """Global-sort rebin: the fallback when the shift rebin
        overflows.  Returns (state, overflow)."""
        nx, ny, nz = self.spec.dims
        cap = self.spec.cap
        big = self._fold(st)
        dtype = big.dtype
        NPX = NP_RMM + 3
        flat = big.permute(0, 1, 3, 2).reshape(-1, NPX)  # [slots, 11]
        valid = flat[:, 3] > 0.5
        cl = torch.tensor(self.cell_len, dtype=dtype, device=big.device)
        dims = torch.tensor(self.spec.dims, device=big.device)
        local = flat[:, 0:3]
        # exact cell hop: the new local coordinate never round-trips
        # through an absolute position
        delta = torch.floor(local / cl).long()
        new_local = local - delta.to(dtype) * cl
        c3 = torch.remainder(self._slot_cells() + delta, dims)
        cell = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
        flat = torch.cat([new_local, flat[:, 3:]], dim=1)
        bins = bin_by_id(cell, valid, self.spec, need_inverse=False)
        idx = bins.slots.reshape(-1).long()
        safe = torch.clamp(idx, 0, flat.shape[0] - 1)
        ok = (idx >= 0) & valid[safe]
        g = torch.where(ok[:, None], flat[safe], self._empty_fill(NPX, dtype))
        gre = g.reshape(nz, ny, nx * cap, NPX).permute(0, 1, 3, 2)
        return self._from_stack(gre, st), bins.overflow

    def rebin(self):
        """Rebin the current state: the shift rebin, or on overflow the
        global rebin of the same state.  Raises CellCapacityError when
        even the global rebin cannot place every molecule; the state is
        then left as it was, so nothing is lost."""
        st2, ovf = self._rebin_shift(self.state)
        if bool(ovf):
            self.n_rebin_fallback += 1
            st2, ovf = self._rebin(self.state)
            if bool(ovf):
                raise CellCapacityError(
                    f"cell capacity {self.spec.cap} exceeded at rebin"
                )
        self.state = st2

    # -- host API -------------------------------------------------------------
    def init_from_molecules(self, mol: MoleculeState):
        spec = self.spec
        nx, ny, nz = spec.dims
        cap = spec.cap
        dtype = mol.r.dtype
        dev = self.device
        # absolute -> (cell, local) split in f64 on the host so the
        # one-time conversion adds no rounding noise
        r64 = mol.r.detach().cpu().to(torch.float64).numpy()
        cl = np.asarray(spec.cell_len, np.float64)
        c3 = np.clip(np.floor(r64 / cl).astype(np.int64), 0,
                     np.asarray(spec.dims) - 1)
        local = r64 - c3 * cl
        # bin by the SAME host-f64 cell assignment that defined the
        # locals: an independent f32 binning can disagree on
        # boundary-exact coordinates (lattice scenes), and a slot whose
        # local is relative to a different cell's origin is displaced by
        # a whole cell edge
        cell_host = (c3[:, 2] * spec.dims[1] + c3[:, 1]) * spec.dims[0] + c3[:, 0]
        valid = mol.valid.to(dev)
        bins = bin_by_id(torch.as_tensor(cell_host, device=dev), valid, spec,
                         need_inverse=False)
        if bool(bins.overflow):
            raise CellCapacityError("cell capacity exceeded at init")
        idx = bins.slots.reshape(-1).long()
        safe = torch.clamp(idx, 0, mol.capacity - 1)
        ok = (idx >= 0) & valid[safe]
        packed = torch.cat(
            [
                torch.as_tensor(local, dtype=dtype, device=dev),
                valid.to(dtype)[:, None],
                mol.v.to(dev),
                mol.mid.to(dev).to(dtype)[:, None],
            ],
            dim=1,
        )
        g = torch.where(ok[:, None], packed[safe], self._empty_fill(NP_RMM, dtype))
        planes = g.reshape(nz, ny, nx * cap, NP_RMM).permute(0, 1, 3, 2).contiguous()
        f, u6, vir = self._kernel(planes)
        z3 = torch.zeros_like(f)
        self.state = RMMState(planes=planes, forces=f, vcomp=z3,
                              rcomp=z3.clone(), u6=u6, vir=vir)
        self._k = 0

    def step(self, compute_macro=True) -> GlobalValues:
        """One step, preceded by the rebin when it is due."""
        if self._k and (self._k % self.rebin_every == 0):
            self.rebin()
        self.state, gv = self._step(self.state, compute_macro)
        self._k += 1
        return gv

    def run(self, steps: int):
        gv = None
        last_full = None
        for i in range(steps):
            full = (self._k % self.sample_every == 0) or (i == steps - 1)
            gv = self.step(compute_macro=full)
            if full:
                last_full = gv
        return last_full if last_full is not None else gv

    def state_numpy(self) -> dict:
        """The state as numpy arrays, keyed as the JAX RMMState leaves."""
        return {k: getattr(self.state, k).detach().cpu().numpy()
                for k in ("planes", "forces", "vcomp", "rcomp", "u6", "vir")}

    def to_molecules(self) -> MoleculeState:
        """Flatten the dense state back to molecule arrays
        (checkpointing); absolute positions rebuilt in f64 on the
        host."""
        p = self.state.planes.detach().cpu().numpy()
        nz, ny, C, W = p.shape
        flat = p.transpose(0, 1, 3, 2).reshape(-1, C)
        valid = flat[:, 3] > 0.5
        cells = self._slot_cells().cpu().numpy()
        cl = np.asarray(self.spec.cell_len, np.float64)
        r_abs = cells.astype(np.float64) * cl + flat[:, 0:3].astype(np.float64)
        r = wrap_positions(torch.as_tensor(r_abs[valid]), self.box).numpy()
        return MoleculeState.from_numpy(
            r=r,
            v=flat[valid, 4:7],
            mid=flat[valid, 7].astype(np.int64).astype(np.int32),
            dtype=self.state.planes.dtype,
            device=self.device,
        )
