"""The system under test, ls1_mardyn_tpu_torch, as the benchmark drives
and reads it: build MDSimulation from a cell's inputs, hold the run to
its cell (engine, force path, kernel launch counters) and read the
program's state back (positions, velocities, orientations, angular
momenta, forces and torques by molecule id, in float64)."""

from __future__ import annotations

import importlib

import torch

from benchmark import scene


def build(cfg, traffic, cell, start, device):
    """MDSimulation of the cell on `device`, its kernels built first."""
    from ls1_mardyn_tpu_torch.driver import MDSimulation

    if torch.device(device).type == "cuda":
        from ls1_mardyn_tpu_torch.ops import _build
        _build.build_all(cell["libs"])
    xml, data = scene.program_inputs(cfg, start)
    dtype = getattr(torch, cfg["dtype"])
    return MDSimulation(xml, dtype=dtype, phase_space_data=data, device=device,
                        force_mode=traffic["force_mode"],
                        cell_cap=int(traffic.get("cell_cap", 0)))


def check_path(md, cell):
    """Raise unless md runs the cell's engine and force path."""
    eng = md.engine
    path = getattr(eng, "_force_fn", None)
    got = (type(eng).__name__, None if path is None else type(path).__name__)
    want = (cell["engine"], cell["force_path"])
    if got != want:
        raise RuntimeError(f"engine/force path {got}, the cell runs {want}")


def _counter(spec):
    mod, name = spec.split(":")
    return getattr(importlib.import_module(mod), name)


def read_counters(cell):
    return {k: int(_counter(k).launches) for k in cell["counters"]}


def check_counters(cell, before, after, steps):
    """Raise unless each kernel counter moved as the cell says over
    `steps` steps: 'steps' (every step, and once more for each re-spec,
    whose rebuilt engine evaluates its start), 'some' (at least once) or
    'none'."""
    for k, rule in cell["counters"].items():
        d = after[k] - before[k]
        ok = {"steps": d >= steps, "some": d > 0, "none": d == 0}[rule]
        if not ok:
            raise RuntimeError(f"{k}: {d} launches in {steps} steps, the cell "
                               f"asks for {rule!r}: it measured another path")


def steps_to_rebin(md):
    """Steps until the RMM engine's next step begins with its shift
    rebin (K2): 0 when the next step does; 0 for the general engine,
    which bins every step."""
    eng = md.engine
    if type(eng).__name__ != "RMMEngine":
        return 0
    every = int(eng.sim.rebin_every)
    return (-int(eng.sim._k)) % every


def grid(md):
    """(dims, cap) of the force kernel's cell grid."""
    spec = getattr(md.engine, "_force_fn", None)
    spec = getattr(spec, "spec", None) or md.engine.spec
    return tuple(int(d) for d in spec.dims), int(spec.cap)


def snapshot(md, device=None):
    """The program's state in float64, sorted by molecule id: dict(mid,
    r, v, q, L, F, M); F and M are the forces and torques the program
    holds for these positions.  On `device` (default: the program's);
    the program's tensors are moved there before any arithmetic, so a
    snapshot to the host adds nothing to the card's peak memory."""
    eng = md.engine
    if type(eng).__name__ == "RMMEngine":
        return _rmm_snapshot(eng.sim, device)
    mol, f = eng.mol, eng.forces
    dev = device or mol.r.device
    keep = mol.valid.to(dev)
    out = dict(mid=mol.mid.to(dev)[keep].long(), r=mol.r.to(dev)[keep],
               v=mol.v.to(dev)[keep], q=mol.q.to(dev)[keep], L=mol.L.to(dev)[keep],
               F=f.F.to(dev)[keep], M=f.M.to(dev)[keep])
    return _sorted(out)


def _rmm_snapshot(rsim, device):
    """Positions of the dense RMM planes: cell origin + cell-local
    coordinate + Kahan compensation, in float64."""
    st = rsim.state
    nx, ny, nz = rsim.spec.dims
    cap = rsim.spec.cap
    dev = device or st.planes.device
    p = st.planes.to(dev).double()
    valid = p[:, :, 3, :] > 0.5
    cl = torch.tensor(rsim.cell_len, dtype=torch.float64, device=dev)
    cx = (torch.arange(nx * cap, device=dev) // cap).double()
    cy = torch.arange(ny, device=dev).double()
    cz = torch.arange(nz, device=dev).double()
    local = p[:, :, 0:3, :] + st.rcomp.to(dev).double()
    x = local[:, :, 0] + cx[None, None] * cl[0]
    y = local[:, :, 1] + cy[None, :, None] * cl[1]
    z = local[:, :, 2] + cz[:, None, None] * cl[2]
    r = torch.stack([x[valid], y[valid], z[valid]], -1)
    v = (p[:, :, 4:7, :] + st.vcomp.to(dev).double()).permute(0, 1, 3, 2)[valid]
    F = st.forces.to(dev).double().permute(0, 1, 3, 2)[valid]
    n = len(r)
    q = torch.zeros((n, 4), dtype=torch.float64, device=dev)
    q[:, 0] = 1.0
    zero = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    mid = p[:, :, 7, :][valid].round().long()
    return _sorted(dict(mid=mid, r=r, v=v, q=q, L=zero, F=F, M=zero.clone()))


def _sorted(s):
    o = torch.argsort(s["mid"])
    return {k: (x[o] if k == "mid" else x[o].double()) for k, x in s.items()}
