"""Start states of the benchmark's configurations, made from --seed.

Frozen copies of the scene builders the port's smoke run proved on the
card (seed tiling, the cubic lattice, Maxwell-Boltzmann velocities,
random orientations), so that no change to the program moves the
inputs.  A configuration file (configs/<name>.json) names its start:

  npz       an equilibrated state of one periodic cell of the
            configuration's density and temperature (positions, and for
            a rigid multi-site model orientations and angular momenta),
            made by make_start.py and committed beside the configuration,
            tiled `tiles`^3 times; the same for every seed (the seed
            draws the velocities: a seed must not change the work, and
            the positions set the program's cell grid); the file is
            checked against its SHA-256;
  lattice   two interleaved simple-cubic lattices with per-axis counts
            proportional to the box, truncated to n, and, for a rigid
            multi-site model, uniformly random orientations (the start
            make_start.py relaxes, and the tests' small scenes).

Velocities are Maxwell-Boltzmann at the configuration's temperature
with zero net momentum, drawn from the seed.  Everything is numpy on
the host: the program takes its start as a PhaseSpaceData.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one seed (any integer, negative ones folded into
    64 bits) and one stream of draws."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def mass(cfg) -> float:
    return float(sum(s["mass"] for s in cfg["sites"]["lj"]))


def maxwell_velocities(n, temperature, m, rng):
    v = rng.normal(size=(n, 3)) * np.sqrt(temperature / m)
    return v - v.mean(axis=0)


def random_quaternions(n, rng):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def lattice_positions(n, box):
    """Two interleaved simple-cubic lattices, counts proportional to the
    box edges (2*kx*ky*kz >= n), truncated to n."""
    box = np.asarray(box, float)
    base = (n / (2.0 * float(np.prod(box)))) ** (1.0 / 3.0)
    k3 = np.maximum(1, np.ceil(base * box).astype(int))
    while 2 * int(np.prod(k3)) < n:
        k3[int(np.argmin(k3 / box))] += 1
    spacing = box / k3
    g = np.stack(np.meshgrid(np.arange(k3[0]), np.arange(k3[1]),
                             np.arange(k3[2]), indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([(g + 0.25) * spacing, (g + 0.75) * spacing])[:n]


def start_cell(start):
    """dict(r, q, angmom, box) of a configuration's start file, its
    SHA-256 checked; q and angmom are None where the file has none."""
    path = os.path.join(ROOT, start["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != start["sha256"]:
        raise RuntimeError(f"{start['file']}: SHA-256 {digest} is not the "
                           f"configuration's {start['sha256']}")
    z = np.load(path)
    return dict(r=z["r"].astype(np.float64), box=float(z["box"]),
                q=z["q"].astype(np.float64) if "q" in z else None,
                angmom=z["angmom"].astype(np.float64) if "angmom" in z else None)


def tile(x, t, shift=None):
    """x [n, k] repeated for t^3 periodic images (image-major), plus
    `shift` [t^3, k] per image where given."""
    out = np.broadcast_to(x[None], (t ** 3,) + x.shape)
    if shift is not None:
        out = out + shift[:, None]
    return out.reshape(-1, x.shape[1])


def start_state(cfg, seed):
    """dict(r, v, q, L, box) of the configuration's start, as float64
    numpy arrays; the same seed gives the same arrays."""
    n, T = int(cfg["n"]), float(cfg["temperature"])
    start = cfg["start"]
    q = L = None
    if start["kind"] == "npz":
        c = start_cell(start)
        t = int(start["tiles"])
        offs = np.array([(i, j, k) for i in range(t) for j in range(t)
                         for k in range(t)], np.float64) * c["box"]
        box = c["box"] * t
        r = tile(c["r"] % c["box"], t, offs) % box
        if c["q"] is not None:
            q = tile(c["q"], t)
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        if c["angmom"] is not None:
            L = tile(c["angmom"], t)
        if len(r) != n:
            raise ValueError(f"{start['file']} tiled {t}^3 holds {len(r)} "
                             f"molecules, not {n}")
        if abs(n / box ** 3 / float(cfg["rho"]) - 1) > 1e-6:
            raise ValueError("the start file's density is not the configuration's")
    elif start["kind"] == "lattice":
        box = (n / float(cfg["rho"])) ** (1.0 / 3.0)
        r = lattice_positions(n, [box, box, box])
    else:
        raise ValueError(f"unknown start {start['kind']!r}")
    v = maxwell_velocities(n, T, mass(cfg), rng_for(seed, 2))
    if q is None:
        q = random_quaternions(n, rng_for(seed, 3)) if rotates(cfg) \
            else np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
    if L is None:
        L = np.zeros((n, 3))
    return dict(r=r, v=v, q=q, L=L, box=np.array([box, box, box]))


def rotates(cfg) -> bool:
    """Whether the model has rotational degrees of freedom (any site
    off the centre of mass, or a multipole)."""
    s = cfg["sites"]
    return bool(s.get("quadrupoles")) or any(
        any(x != 0.0 for x in site["r"]) for site in s["lj"])


def program_inputs(cfg, start):
    """The program's inputs: (XMLConfig, PhaseSpaceData) built through
    ls1_mardyn_tpu_torch's own configuration classes."""
    from ls1_mardyn_tpu_torch.io.ascii_reader import PhaseSpaceData
    from ls1_mardyn_tpu_torch.io.xml_config import XMLConfig
    from ls1_mardyn_tpu_torch.models.components import Component

    rc = float(cfg["cutoff"])
    c = Component(cid=0)
    for s in cfg["sites"]["lj"]:
        c.add_ljcenter(*s["r"], s["mass"], s["epsilon"], s["sigma"], rc,
                       bool(s["shifted"]))
    for s in cfg["sites"].get("quadrupoles", []):
        c.add_quadrupole(*s["r"], *s["e"], s["Q"])
    n = len(start["r"])
    data = PhaseSpaceData(
        components=[c], mixing_xi=np.ones((1, 1)), mixing_eta=np.ones((1, 1)),
        eps_rf=1.0e10, box=start["box"].copy(),
        temperature=float(cfg["temperature"]), current_time=0.0,
        mid=np.arange(1, n + 1, dtype=np.int64), cid=np.zeros(n, np.int32),
        r=start["r"], v=start["v"], q=start["q"], L=start["L"])
    xml = XMLConfig(timestep=float(cfg["timestep"]),
                    temperature=float(cfg["temperature"]),
                    box=start["box"].copy(), cutoff=rc, lj_cutoff=rc,
                    ensemble_type=cfg["ensemble"])
    xml.longrange = cfg["longrange"]
    return xml, data
