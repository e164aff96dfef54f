"""Scenario generators: in-situ phase-space creation.

Host-side equivalents of the reference's generator family
(src/io/CubicGridGeneratorInternal.cpp: face-centered
lattice filling the box to a target density with Maxwell-Boltzmann
velocities; src/utils/generator/ velocity assigners).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
from ls1_mardyn_tpu_torch.models.components import Component


def maxwell_velocities(
    n: int, temperature: float, mass, rng: np.random.Generator
) -> np.ndarray:
    """Maxwell-Boltzmann velocity draw at temperature T (kB == 1 in
    reduced units; MaxwellVelocityAssigner analogue)."""
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    sigma = np.sqrt(temperature / mass)
    v = rng.normal(size=(n, 3)) * sigma[:, None]
    # zero net momentum (CubicGridGeneratorInternal::removeMomentum)
    p = (mass[:, None] * v).sum(axis=0)
    v -= p / mass.sum()
    return v


def mkesfera(
    radius_liq: float,
    rho_liq: float,
    rho_vap: float,
    box: Sequence[float],
    temperature: float,
    components: Optional[Sequence[Component]] = None,
    seed: int = 42,
) -> PhaseSpaceData:
    """Liquid droplet in vapor (MkesferaGenerator analogue,
    src/io/MkesferaGenerator.cpp): a sphere of liquid
    density centered in the box, vapor elsewhere."""
    box = np.asarray(box, float)
    center = box / 2.0
    n_total_liq = int(rho_liq * np.prod(box))
    base = cubic_grid(n_total_liq, box, temperature, components, seed=seed)
    d = base.r - center
    inside = (d * d).sum(1) < radius_liq ** 2
    rng = np.random.default_rng(seed + 1)
    keep = inside | (rng.uniform(size=len(base.r)) < rho_vap / rho_liq)
    return _subset(base, keep)


def mktcts(
    rho_liq: float,
    rho_vap: float,
    box: Sequence[float],
    temperature: float,
    liq_fraction: float = 0.5,
    axis: int = 1,
    components: Optional[Sequence[Component]] = None,
    seed: int = 42,
) -> PhaseSpaceData:
    """Two-phase liquid slab + vapor (MkTcTSGenerator analogue,
    src/io/MkTcTSGenerator.cpp): liquid occupies the
    central `liq_fraction` of the box along `axis`."""
    box = np.asarray(box, float)
    n_total = int(rho_liq * np.prod(box))
    base = cubic_grid(n_total, box, temperature, components, seed=seed)
    L = box[axis]
    lo = L * (0.5 - liq_fraction / 2)
    hi = L * (0.5 + liq_fraction / 2)
    in_liq = (base.r[:, axis] >= lo) & (base.r[:, axis] < hi)
    rng = np.random.default_rng(seed + 1)
    keep = in_liq | (rng.uniform(size=len(base.r)) < rho_vap / rho_liq)
    return _subset(base, keep)


def replicate(data: PhaseSpaceData, nx: int, ny: int, nz: int) -> PhaseSpaceData:
    """Replicate an equilibrated cell (ReplicaGenerator analogue,
    src/io/ReplicaGenerator.cpp)."""
    reps = []
    n0 = len(data.mid)
    box = np.asarray(data.box, float)
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                shift = np.array([i, j, k]) * box
                reps.append(data.r + shift)
    n_rep = nx * ny * nz
    out = PhaseSpaceData(
        components=data.components,
        mixing_xi=data.mixing_xi,
        mixing_eta=data.mixing_eta,
        eps_rf=data.eps_rf,
        box=box * np.array([nx, ny, nz]),
        temperature=data.temperature,
        current_time=data.current_time,
        mid=np.arange(1, n0 * n_rep + 1, dtype=np.int64),
        cid=np.tile(data.cid, n_rep),
        r=np.concatenate(reps),
        v=np.tile(data.v, (n_rep, 1)),
        q=np.tile(data.q, (n_rep, 1)),
        L=np.tile(data.L, (n_rep, 1)),
    )
    return out


def _subset(data: PhaseSpaceData, keep: np.ndarray) -> PhaseSpaceData:
    return PhaseSpaceData(
        components=data.components,
        mixing_xi=data.mixing_xi,
        mixing_eta=data.mixing_eta,
        eps_rf=data.eps_rf,
        box=data.box,
        temperature=data.temperature,
        current_time=data.current_time,
        mid=np.arange(1, int(keep.sum()) + 1, dtype=np.int64),
        cid=data.cid[keep],
        r=data.r[keep],
        v=data.v[keep],
        q=data.q[keep],
        L=data.L[keep],
    )


def cubic_grid(
    num_molecules: int,
    box: Sequence[float],
    temperature: float,
    components: Optional[Sequence[Component]] = None,
    cid: int = 0,
    seed: int = 42,
) -> PhaseSpaceData:
    """Face-centered-cubic-ish grid of `>= num_molecules` sites, then
    truncated to exactly num_molecules (the reference generator's
    binary-search sizing simplified: two interleaved simple-cubic
    lattices, CubicGridGeneratorInternal.cpp).
    """
    box = np.asarray(box, float)
    if components is None:
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
        components = [c]
    # two interleaved lattices with per-axis counts PROPORTIONAL to the
    # box edges (2*kx*ky*kz >= n); a single shared count would squeeze
    # the short axes of anisotropic boxes into overlapping spacings
    vol = float(np.prod(box))
    base = (num_molecules / (2.0 * vol)) ** (1.0 / 3.0)
    k3 = np.maximum(1, np.ceil(base * box).astype(int))
    while 2 * int(np.prod(k3)) < num_molecules:
        k3[int(np.argmin(k3 / box))] += 1
    spacing = box / k3
    g = np.stack(
        np.meshgrid(
            np.arange(k3[0]), np.arange(k3[1]), np.arange(k3[2]),
            indexing="ij",
        ),
        -1,
    ).reshape(-1, 3)
    a = (g + 0.25) * spacing
    b = (g + 0.75) * spacing
    r = np.concatenate([a, b], axis=0)[:num_molecules]
    n = len(r)
    rng = np.random.default_rng(seed)
    mass = components[cid].mass
    v = maxwell_velocities(n, temperature, mass, rng)
    K = len(components)
    return PhaseSpaceData(
        components=list(components),
        mixing_xi=np.ones((K, K)),
        mixing_eta=np.ones((K, K)),
        eps_rf=1.0e10,
        box=box,
        temperature=temperature,
        current_time=0.0,
        mid=np.arange(1, n + 1, dtype=np.int64),
        cid=np.full(n, cid, np.int32),
        r=r,
        v=v,
        q=np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1)),
        L=np.zeros((n, 3)),
    )


def per_cell(
    num_per_cell: int,
    box: Sequence[float],
    cutoff: float,
    temperature: float,
    components: Optional[Sequence[Component]] = None,
    cid: int = 0,
    seed: int = 42,
    generate_at_least_two: bool = True,
) -> PhaseSpaceData:
    """PerCellGenerator (src/io/PerCellGenerator.h:14):
    exactly `num_per_cell` uniformly random molecules in every linked
    cell (cell edges >= cutoff), Maxwell velocities at `temperature`.
    With num_per_cell == 0 and generate_at_least_two, places two random
    molecules so the simulation has something to integrate."""
    box = np.asarray(box, float)
    if components is None:
        c = Component(cid=0)
        c.add_ljcenter(0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, False)
        components = [c]
    rng = np.random.default_rng(seed)
    dims = np.maximum(1, np.floor(box / cutoff).astype(int))
    cl = box / dims
    if num_per_cell > 0:
        # per-cell uniform placement: cell origins + U(0,1)*cell_len
        g = np.stack(
            np.meshgrid(
                np.arange(dims[0]), np.arange(dims[1]),
                np.arange(dims[2]), indexing="ij",
            ),
            -1,
        ).reshape(-1, 3)
        origins = np.repeat(g * cl, num_per_cell, axis=0)
        r = origins + rng.random(origins.shape) * cl
    elif generate_at_least_two:
        r = rng.random((2, 3)) * box
    else:
        r = np.zeros((0, 3))
    n = len(r)
    mass = components[cid].mass
    v = maxwell_velocities(n, temperature, mass, rng)
    K = len(components)
    return PhaseSpaceData(
        components=list(components),
        mixing_xi=np.ones((K, K)),
        mixing_eta=np.ones((K, K)),
        eps_rf=1.0e10,
        box=box,
        temperature=temperature,
        current_time=0.0,
        mid=np.arange(1, n + 1, dtype=np.int64),
        cid=np.full(n, cid, np.int32),
        r=r,
        v=v,
        q=np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1)),
        L=np.zeros((n, 3)),
    )


# -- composable object generators ---------------------------------------
# The role of src/io/ObjectGenerator.h:22 +
# src/utils/generator/ (GridFiller, Lattice, Objects, velocity
# assigners): fill geometric objects with lattice sites.

_CENTERINGS = {
    "primitive": np.array([[0.0, 0.0, 0.0]]),
    "face": np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    ),
    "body": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
}


def _object_mask(obj: dict, r: np.ndarray) -> np.ndarray:
    """Point-in-object predicate (utils/generator/Objects.{h,cpp}:
    Cuboid, Sphere, Cylinder; ObjectUnion by recursion)."""
    typ = obj.get("type", "Cuboid")
    if typ == "Cuboid":
        lo = np.array([float(obj["lower"][k]) for k in ("x", "y", "z")])
        hi = np.array([float(obj["upper"][k]) for k in ("x", "y", "z")])
        return ((r >= lo) & (r < hi)).all(axis=1)
    if typ == "Sphere":
        c = np.array([float(obj["center"][k]) for k in ("x", "y", "z")])
        rad = float(obj["radius"])
        return ((r - c) ** 2).sum(axis=1) <= rad * rad
    if typ == "Cylinder":
        # axis along y (the reference's convention): radius in xz
        c = np.array(
            [float(obj["centerBase"][k]) for k in ("x", "y", "z")]
        ) if "centerBase" in obj else np.zeros(3)
        rad = float(obj.get("radius", 1.0))
        h = float(obj.get("height", 1e30))
        dx = r[:, 0] - c[0]
        dz = r[:, 2] - c[2]
        return (dx * dx + dz * dz <= rad * rad) & (r[:, 1] >= c[1]) & (
            r[:, 1] < c[1] + h
        )
    if typ == "ObjectSubtractor":
        # object1 minus object2 (Objects.h ObjectSubtractor)
        o1 = dict(obj["object1"]); o1["type"] = obj["object1"].get("type", "Cuboid")
        o2 = dict(obj["object2"]); o2["type"] = obj["object2"].get("type", "Cuboid")
        return _object_mask(o1, r) & ~_object_mask(o2, r)
    if typ == "ObjectUnion":
        masks = [
            _object_mask(o, r)
            for o in (obj.get("object") if isinstance(obj.get("object"), list)
                      else [obj.get("object")])
        ]
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        return out
    raise NotImplementedError(f"object type {typ}")


def grid_filler(filler: dict, obj: dict, box) -> tuple:
    """GridFiller (src/utils/generator/GridFiller.{h,cpp}): a Bravais
    lattice at the requested density, clipped to the object.
    Returns (positions [n,3], cids [n])."""
    box = np.asarray(box, float)
    lattice = filler.get("lattice", {})
    centering = lattice.get("centering", "primitive")
    cent = _CENTERINGS[centering]
    basis = filler.get("basis", {}).get("site", {"componentid": "1",
                                                 "coordinate": None})
    if not isinstance(basis, list):
        basis = [basis]
    occupancy = float(filler.get("latticeOccupancy", 1.0))
    rho = float(filler.get("density", 0.5))
    nb = len(basis) * len(cent)
    a = (nb * occupancy / rho) ** (1.0 / 3.0)  # cubic lattice constant
    dims = np.maximum(1, np.ceil(box / a).astype(int))
    ii = [np.arange(d) for d in dims]
    g = np.stack(np.meshgrid(*ii, indexing="ij"), -1).reshape(-1, 3)
    pos = []
    cids = []
    for site in basis:
        coord = site.get("coordinate")
        frac = (
            np.array([float(coord[k]) for k in ("x", "y", "z")])
            if coord else np.full(3, 0.5)
        )
        cid = int(float(site.get("componentid", 1))) - 1
        for c in cent:
            p = (g + c + frac) * a
            pos.append(p)
            cids.append(np.full(len(p), cid, np.int32))
    r = np.concatenate(pos)
    cid = np.concatenate(cids)
    inside = (r < box).all(axis=1) & _object_mask(obj, r)
    r, cid = r[inside], cid[inside]
    if occupancy < 1.0:
        rng = np.random.default_rng(1729)
        keep = rng.random(len(r)) < occupancy
        r, cid = r[keep], cid[keep]
    return r, cid


def replica_filler(filler: dict, obj: dict, box, base_dir: str = ".") -> tuple:
    """ReplicaFiller (src/utils/generator/ReplicaFiller.{h,cpp}): tile an
    equilibrated input cell (binary or ASCII restart) periodically over
    the object's bounding region, keeping molecules inside the object.
    Returns (positions, cids, velocities, quaternions, angular momenta)."""
    import os

    inp = filler.get("input", {})
    typ = inp.get("type", "BinaryReader")
    if typ == "BinaryReader":
        from ls1_mardyn_tpu_torch.io.binary_io import read_binary_checkpoint

        hdr = inp["header"]
        dat = inp["data"]
        if not os.path.isabs(hdr):
            hdr = os.path.join(base_dir, hdr)
        if not os.path.isabs(dat):
            dat = os.path.join(base_dir, dat)
        cell = read_binary_checkpoint(dat, hdr)
    else:
        from ls1_mardyn_tpu_torch.io.ascii_reader import read_inp

        fname = inp.get("file", inp.get("data"))
        if not os.path.isabs(fname):
            fname = os.path.join(base_dir, fname)
        cell = read_inp(fname)
    box = np.asarray(box, float)
    cbox = np.asarray(cell.box, float)
    reps = np.maximum(1, np.ceil(box / cbox).astype(int))
    rs, cids, vs, qs, Ls = [], [], [], [], []
    for ix in range(reps[0]):
        for iy in range(reps[1]):
            for iz in range(reps[2]):
                off = np.array([ix, iy, iz]) * cbox
                r = cell.r + off
                keep = (r < box).all(axis=1) & _object_mask(obj, r)
                rs.append(r[keep])
                cids.append(cell.cid[keep])
                vs.append(cell.v[keep])
                qs.append(cell.q[keep])
                Ls.append(cell.L[keep])
    return (
        np.concatenate(rs),
        np.concatenate(cids),
        np.concatenate(vs),
        np.concatenate(qs),
        np.concatenate(Ls),
    )


def multi_object(
    objectgens,
    box,
    temperature: float,
    components: Sequence[Component],
    seed: int = 42,
    base_dir: str = ".",
) -> PhaseSpaceData:
    """MultiObjectGenerator (src/io/MultiObjectGenerator + ObjectGenerator):
    concatenate the fills of several <objectgenerator> blocks, each with
    its own filler, object, and velocity assigner."""
    box = np.asarray(box, float)
    rng = np.random.default_rng(seed)
    if not isinstance(objectgens, list):
        objectgens = [objectgens]
    rs, cids, vs, qs, Ls = [], [], [], [], []
    for og in objectgens:
        filler = og.get("filler", {})
        obj = og.get("object", {"type": "Cuboid",
                                "lower": {"x": 0, "y": 0, "z": 0},
                                "upper": {k: str(b) for k, b in
                                          zip("xyz", box)}})
        if filler.get("type") == "ReplicaFiller" or "input" in filler:
            r, cid, v, q, L = replica_filler(filler, obj, box, base_dir)
            rs.append(r)
            cids.append(cid)
            vs.append(v)
            qs.append(q)
            Ls.append(L)
            continue
        r, cid = grid_filler(filler, obj, box)
        va = og.get("velocityAssigner", {})
        va_type = va.get("type", "MaxwellVelocityDistribution") if isinstance(
            va, dict) else "MaxwellVelocityDistribution"
        v = np.zeros_like(r)
        for k in np.unique(cid):
            sel = cid == k
            mass = components[int(k)].mass
            if va_type.startswith("Equal"):
                # EqualVelocityAssigner: same speed sqrt(3T/m), random
                # direction, zero net momentum
                speed = np.sqrt(3.0 * temperature / mass)
                d = rng.normal(size=(sel.sum(), 3))
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                vv = speed * d
                vv -= vv.mean(axis=0)
                v[sel] = vv
            else:
                v[sel] = maxwell_velocities(
                    int(sel.sum()), temperature, mass, rng
                )
        rs.append(r)
        cids.append(cid)
        vs.append(v)
        qs.append(np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (len(r), 1)))
        Ls.append(np.zeros((len(r), 3)))
    r = np.concatenate(rs)
    cid = np.concatenate(cids)
    v = np.concatenate(vs)
    q = np.concatenate(qs)
    L = np.concatenate(Ls)
    n = len(r)
    K = len(components)
    return PhaseSpaceData(
        components=list(components),
        mixing_xi=np.ones((K, K)),
        mixing_eta=np.ones((K, K)),
        eps_rf=1.0e10,
        box=box,
        temperature=temperature,
        current_time=0.0,
        mid=np.arange(1, n + 1, dtype=np.int64),
        cid=cid.astype(np.int32),
        r=r,
        v=v,
        q=q,
        L=L,
    )
