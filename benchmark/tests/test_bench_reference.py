"""The plain reference (benchmark/reference) against an O(N^2) sweep and
against derivatives of its energy taken by finite differences, in
float64 at small N, and its pair terms against textbook values."""

import math

import pytest
import torch

from benchmark.reference.integrate import leapfrog_step
from benchmark.reference.model import Model, rotate, tail_pair_mean
from benchmark.reference.pairs import brute_force_pairs, pair_blocks

LJ = dict(cutoff=2.5, sites=dict(lj=[dict(r=[0, 0, 0], mass=1.0, epsilon=1.0,
                                          sigma=1.0, shifted=False)]))
CO2 = dict(cutoff=2.5, sites=dict(
    lj=[dict(r=[0, 0, -0.2], mass=0.5, epsilon=1.0, sigma=1.0, shifted=True),
        dict(r=[0, 0, 0.2], mass=0.5, epsilon=1.0, sigma=1.0, shifted=True)],
    quadrupoles=[dict(r=[0, 0, 0], e=[0, 0, 1], Q=1.2)]))


def scene(n, L, seed=0):
    """n molecules on a jittered lattice in a cubic box of edge L, with
    random orientations."""
    g = torch.Generator().manual_seed(seed)
    k = math.ceil(n ** (1 / 3))
    idx = torch.stack(torch.meshgrid(*[torch.arange(k)] * 3, indexing="ij"), -1)
    r = (idx.reshape(-1, 3)[:n].double() + 0.5) * (L / k)
    r = (r + 0.1 * torch.randn(r.shape, generator=g, dtype=torch.float64)) % L
    q = torch.randn((n, 4), generator=g, dtype=torch.float64)
    return r, q / q.norm(dim=-1, keepdim=True), torch.full((3,), L, dtype=torch.float64)


def canon(i, j, drm):
    swap = i > j
    a, b = torch.where(swap, j, i), torch.where(swap, i, j)
    d = torch.where(swap[:, None], -drm, drm)
    o = torch.argsort(a * 100000 + b)
    return a[o], b[o], d[o]


def total_energy(model, r, q, box):
    return model.forces(r, q, box, pairs=[brute_force_pairs(r, box, model.rc)])["U"]


@pytest.mark.parametrize("n,L", [(216, 7.6), (400, 9.0), (150, 12.0)])
def test_cell_pairs_equal_brute_force(n, L):
    r, _, box = scene(n, L)
    got = [torch.cat(x) for x in zip(*pair_blocks(r, box, 2.5, max_candidates=5000))]
    a = canon(*got)
    b = canon(*brute_force_pairs(r, box, 2.5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.allclose(a[2], b[2], rtol=0, atol=1e-12)


@pytest.mark.parametrize("cfg", [LJ, CO2], ids=["lj", "2cljq"])
def test_blocked_forces_equal_brute_force(cfg):
    model = Model(cfg, "cpu")
    r, q, box = scene(343, 8.4)
    cell = model.forces(r, q, box, block_pairs=1000)
    brute = model.forces(r, q, box, pairs=[brute_force_pairs(r, box, model.rc)])
    assert cell["pairs"] == brute["pairs"] > 0
    for k in ("F", "M"):
        assert float((cell[k] - brute[k]).abs().max()) <= 1e-12 * max(
            1.0, float(brute[k].abs().max()))
    assert cell["U"] == pytest.approx(brute["U"], rel=1e-12)
    assert cell["W"] == pytest.approx(brute["W"], rel=1e-12)


@pytest.mark.parametrize("cfg", [LJ, CO2], ids=["lj", "2cljq"])
def test_forces_are_minus_energy_gradient(cfg):
    """F = -dU/dr by central differences of the O(N^2) energy."""
    model = Model(cfg, "cpu")
    r, q, box = scene(125, 7.6, seed=3)
    f = model.forces(r, q, box)["F"]
    h = 1e-6
    for k in (0, 17, 88):
        for a in range(3):
            rp, rm = r.clone(), r.clone()
            rp[k, a] += h
            rm[k, a] -= h
            fd = -(total_energy(model, rp, q, box) - total_energy(model, rm, q, box)) / (2 * h)
            assert fd == pytest.approx(float(f[k, a]), rel=1e-5, abs=1e-6)


def axis_angle(axis, angle):
    a = torch.tensor(axis, dtype=torch.float64)
    a = a / a.norm()
    return torch.cat([torch.tensor([math.cos(angle / 2)]), math.sin(angle / 2) * a])


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by + ay * bw + az * bx - ax * bz,
                        aw * bz + az * bw + ax * by - ay * bx], -1)


def test_torques_are_minus_energy_derivative_under_rotation():
    """tau . a = -dU/dtheta for a world-frame rotation about a."""
    model = Model(CO2, "cpu")
    r, q, box = scene(125, 7.6, seed=4)
    tau = model.forces(r, q, box)["M"]
    h = 1e-6
    for k in (3, 60):
        for axis in ([1, 0, 0], [0, 1, 0], [0.3, -0.5, 0.8]):
            qp, qm = q.clone(), q.clone()
            qp[k] = qmul(axis_angle(axis, h), q[k])
            qm[k] = qmul(axis_angle(axis, -h), q[k])
            fd = -(total_energy(model, r, qp, box) - total_energy(model, r, qm, box)) / (2 * h)
            a = torch.tensor(axis, dtype=torch.float64)
            assert fd == pytest.approx(float(tau[k] @ (a / a.norm())), rel=1e-5, abs=1e-6)


def test_pair_terms_match_textbook_values():
    """LJ at distance 1.3; linear quadrupoles end to end (6 Q^2 / r^5)
    and in a T (-3 Q^2 / r^5), Gray and Gubbins eq. 2.184."""
    lj = Model(LJ, "cpu")
    drm = torch.tensor([[1.3, 0.0, 0.0]], dtype=torch.float64)
    z = torch.zeros((1, 1, 3), dtype=torch.float64)
    e = torch.zeros((1, 0, 3), dtype=torch.float64)
    u = lj.pair_energy(drm, z, z, e, e, e, e)
    assert float(u) == pytest.approx(4 * (1.3 ** -12 - 1.3 ** -6), rel=1e-14)
    quad = dict(cutoff=5.0, sites=dict(
        lj=[dict(r=[0, 0, 0], mass=1.0, epsilon=0.0, sigma=1.0, shifted=False)],
        quadrupoles=[dict(r=[0, 0, 0], e=[0, 0, 1], Q=1.2)]))
    m = Model(quad, "cpu")
    d = 2.0
    drm = torch.tensor([[0.0, 0.0, d]], dtype=torch.float64)
    q0 = torch.zeros((1, 1, 3), dtype=torch.float64)
    ez = torch.tensor([[[0.0, 0.0, 1.0]]], dtype=torch.float64)
    ex = torch.tensor([[[1.0, 0.0, 0.0]]], dtype=torch.float64)
    assert float(m.pair_energy(drm, z, z, q0, q0, ez, ez)) == pytest.approx(
        6 * 1.44 / d ** 5, rel=1e-14)
    assert float(m.pair_energy(drm, z, z, q0, q0, ez, ex)) == pytest.approx(
        -3 * 1.44 / d ** 5, rel=1e-14)


def test_tail_correction_is_the_integral_beyond_rc():
    model = Model(LJ, "cpu")
    n, vol = 1000, 1250.0
    u, w = model.tail(n, vol)
    rs = torch.linspace(2.5, 400.0, 2_000_001, dtype=torch.float64)
    ulj = 4 * (rs ** -12 - rs ** -6)
    rdu = -4 * (12 * rs ** -12 - 6 * rs ** -6)  # r dU/dr
    rho = n / vol
    assert u == pytest.approx(float(0.5 * n * rho * torch.trapezoid(4 * math.pi * rs ** 2 * ulj, rs)),
                              rel=1e-6)
    assert w == pytest.approx(float(0.5 * n * rho * torch.trapezoid(-4 * math.pi * rs ** 2 * rdu, rs)),
                              rel=1e-6)


@pytest.mark.parametrize("t1,t2", [(0.4, 0.4), (0.405, 0.0), (0.0, 0.3), (0.25, 0.5)])
@pytest.mark.parametrize("m", [6, 12])
def test_orientational_mean_against_sampling(t1, t2, m):
    """The mean of |r e + t1 n1 - t2 n2|^-m over uniform directions,
    against 4 million sampled pairs of directions."""
    g = torch.Generator().manual_seed(m + int(100 * (t1 + 2 * t2)))

    def directions(k):
        v = torch.randn((k, 3), generator=g, dtype=torch.float64)
        return v / v.norm(dim=1, keepdim=True)

    r = 4.0
    d = torch.tensor([r, 0.0, 0.0], dtype=torch.float64) + t1 * directions(4_000_000) \
        - t2 * directions(4_000_000)
    sampled = d.norm(dim=1) ** -m
    exact = float(tail_pair_mean(torch.tensor(r, dtype=torch.float64), t1, t2, m))
    assert abs(float(sampled.mean()) / exact - 1) < 4 * float(sampled.std()) / exact / 2000


def test_two_centre_tail_is_the_integral_of_the_orientational_mean():
    """The tail of the two-centre model: its quadrature against a fine
    trapezoid of the same orientational mean beyond rc."""
    cfg = dict(CO2, sites=dict(CO2["sites"], lj=[dict(s, shifted=False)
                                                 for s in CO2["sites"]["lj"]]))
    model = Model(cfg, "cpu")
    n, vol = 1000, 4000.0
    u, w = model.tail(n, vol)
    rs = torch.linspace(2.5, 400.0, 2_000_001, dtype=torch.float64).requires_grad_(True)
    ub = sum(4 * (tail_pair_mean(rs, 0.2, 0.2, 12) - tail_pair_mean(rs, 0.2, 0.2, 6))
             for _ in range(4))
    du = torch.autograd.grad(ub.sum(), rs)[0]
    rs, ub = rs.detach(), ub.detach()
    rho = n / vol
    assert u == pytest.approx(float(0.5 * n * rho * torch.trapezoid(4 * math.pi * rs ** 2 * ub, rs)),
                              rel=1e-6)
    assert w == pytest.approx(float(0.5 * n * rho * torch.trapezoid(-4 * math.pi * rs ** 3 * du, rs)),
                              rel=1e-6)
    assert model.tail(n, vol) != Model(LJ, "cpu").tail(n, vol)


def test_free_step_moves_and_turns_without_torque():
    """Two molecules farther apart than rc: v unchanged but for the
    thermostat, r += dt v, |L| kept and q turning about L."""
    model = Model(dict(CO2, cutoff=2.5), "cpu")
    box = torch.full((3,), 20.0, dtype=torch.float64)
    s = dict(r=torch.tensor([[1.0, 1.0, 1.0], [10.0, 10.0, 10.0]], dtype=torch.float64),
             v=torch.tensor([[0.5, -0.2, 0.1], [-0.5, 0.2, -0.1]], dtype=torch.float64),
             q=torch.tensor([[1.0, 0, 0, 0], [0.0, 1, 0, 0]], dtype=torch.float64),
             L=torch.tensor([[0.02, 0.0, 0.0], [0.0, 0.03, 0.0]], dtype=torch.float64))
    s1, g, _ = leapfrog_step(model, s, box, 0.002, 1.0)
    beta = (3 * 2 * 1.0 / float((s["v"] ** 2).sum())) ** 0.4
    assert torch.allclose(s1["r"], s["r"] + 0.002 * s["v"], atol=1e-15)
    assert torch.allclose(s1["v"], s["v"] * beta, rtol=1e-12)
    axis_after = rotate(s1["q"], torch.tensor([0.0, 0, 1], dtype=torch.float64))
    axis_before = rotate(s["q"], torch.tensor([0.0, 0, 1], dtype=torch.float64))
    # the body axis turned about L, so its component along L is kept
    Lhat = s["L"] / s["L"].norm(dim=-1, keepdim=True)
    assert torch.allclose((axis_after * Lhat).sum(-1), (axis_before * Lhat).sum(-1), atol=1e-12)
    assert float((axis_after - axis_before).abs().max()) > 1e-4
    assert g["upot"] == 0.0
