"""One step of ls1-MarDyn's leapfrog integrator (velocity-Verlet form,
FullMolecule::upd_preF / upd_postF) with the global velocity-scaling
thermostat and the global values (Domain::calculateGlobalValues), in
plain PyTorch:

  v += dt/2m F;  r += dt v
  w = I^-1 R(q)^T L;  q_h = |q + dt/2 qdot(q, w)|;  L += dt/2 M
  w_h = I^-1 R(q_h)^T L;  q = |q + dt qdot(q_h, w_h)|
  F, M, U, W = forces(r, q)
  v += dt/2m F;  L += dt/2 M
  T = (sum m v^2 + sum I w^2) / (3N + rot_dof N)
  v *= (3N T0 / sum m v^2)^0.4;  L *= (rot_dof N T0 / sum I w^2)^0.4
  p = rho T + rho (W / N) / 3

qdot(q, w) = q * (0, w) / 2 for a body-frame angular velocity w.
Positions are kept in float64 and move by dt v computed in the model's
dtype (a lower dtype holds the step's arithmetic, not the coordinates
of a box 170 sigma wide).
"""

from __future__ import annotations

import torch

from benchmark.reference.model import rotate_inv


def qdot(q, w):
    qw, qx, qy, qz = q.unbind(-1)
    a, b, c = w.unbind(-1)
    return 0.5 * torch.stack([-qx * a - qy * b - qz * c,
                              qw * a - qz * b + qy * c,
                              qz * a + qw * b - qx * c,
                              -qy * a + qx * b + qw * c], -1)


def normalize(q):
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def leapfrog_step(model, s, box, dt, target_t, forces=None):
    """One step from the state s = dict(r, v, q, L) [N,...] in the
    model's dtype, whose forces and torques at s.r are forces = dict(F,
    M) (computed here when not given).  Returns (state after the step,
    globals dict(temperature, upot, pressure, virial), forces of the
    new positions)."""
    dt_ = model.dtype
    r = s["r"].double()
    s = {k: s[k].to(dt_) for k in ("v", "q", "L")}
    box = box.double()
    if forces is None:
        forces = model.forces(r, s["q"], box)
    h, m = 0.5 * dt, model.mass
    v = s["v"] + (h / m) * forces["F"].to(dt_)
    r = r + (dt * v).double()
    q, L = s["q"], s["L"]
    if model.rot_dof:
        inv_i = model.inv_inertia
        w = inv_i * rotate_inv(q, L)
        q_h = normalize(q + h * qdot(q, w))
        L = L + h * forces["M"].to(dt_)
        w_h = inv_i * rotate_inv(q_h, L)
        q = normalize(q + dt * qdot(q_h, w_h))
    r = torch.remainder(r, box)
    new = model.forces(r, q, box)
    v = v + (h / m) * new["F"]
    n = len(r)
    summv2 = m * (v.double() * v.double()).sum()
    siw2 = torch.zeros((), dtype=torch.float64, device=r.device)
    if model.rot_dof:
        L = L + h * new["M"]
        w = (model.inv_inertia * rotate_inv(q, L)).double()
        siw2 = (model.inertia.double() * w * w).sum()
    rdof = model.rot_dof * n
    T = float((summv2 + siw2) / (3 * n + rdof))
    v = v * float((3 * n * target_t / summv2) ** 0.4)
    if model.rot_dof:
        L = L * float((rdof * target_t / siw2) ** 0.4)
    volume = float(torch.prod(box))
    u_tail, w_tail = model.tail(n, volume)
    W = new["W"] + w_tail
    rho = n / volume
    glob = dict(temperature=T, upot=new["U"] + u_tail, virial=W,
                pressure=rho * T + rho * (W / n) / 3.0)
    return dict(r=r, v=v, q=q, L=L), glob, new
