"""Batched quaternion algebra for rigid-body dynamics.

The counterpart of ls1_mardyn_tpu/models/quaternion.py: the reference's
scalar Quaternion class (src/molecules/Quaternion.{h,cpp}) on tensors.

Conventions (identical to the reference):
  - quaternion stored as (w, x, y, z), last axis of size 4
  - ``rotate``   maps body-frame vectors to world frame
    (Quaternion.cpp:43-63, the R matrix of getRotMatrix)
  - ``rotate_inv`` is the transpose rotation, world -> body
    (Quaternion.cpp:65-85)
  - ``differentiate(q, w)`` returns dq/dt = 0.5 * q * (0, w) for a
    *body-frame* angular velocity w (Quaternion.cpp:96-101)

All functions broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; mirrors Quaternion::operator*= (Quaternion.cpp:23-31)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
        ],
        dim=-1,
    )


def qnorm2(q: torch.Tensor) -> torch.Tensor:
    """Squared magnitude (Quaternion.h:26-28)."""
    return (q * q).sum(-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q * (1.0 / torch.sqrt(qnorm2(q))).unsqueeze(-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrotate(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) d by q (body -> world). Mirrors Quaternion::rotate
    (Quaternion.cpp:43-63) term-for-term.

    q: [..., 4], d: [..., 3] with broadcastable batch dims.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    r0 = (ww + xx - yy - zz) * d0 + 2.0 * (xy - wz) * d1 + 2.0 * (wy + xz) * d2
    r1 = 2.0 * (wz + xy) * d0 + (ww - xx + yy - zz) * d1 + 2.0 * (yz - wx) * d2
    r2 = 2.0 * (xz - wy) * d0 + 2.0 * (wx + yz) * d1 + (ww - xx - yy + zz) * d2
    return torch.stack([r0, r1, r2], dim=-1)


def qrotate_inv(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Inverse rotation (world -> body). Mirrors Quaternion::rotateinv
    (Quaternion.cpp:65-85)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    r0 = (ww + xx - yy - zz) * d0 + 2.0 * (xy + wz) * d1 + 2.0 * (xz - wy) * d2
    r1 = 2.0 * (xy - wz) * d0 + (ww - xx + yy - zz) * d1 + 2.0 * (yz + wx) * d2
    r2 = 2.0 * (xz + wy) * d0 + 2.0 * (yz - wx) * d1 + (ww - xx - yy + zz) * d2
    return torch.stack([r0, r1, r2], dim=-1)


def qdifferentiate(q: torch.Tensor, w_body: torch.Tensor) -> torch.Tensor:
    """dq/dt = 0.5 * q * (0, w_body); mirrors Quaternion::differentiate
    (Quaternion.cpp:96-101)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w0, w1, w2 = w_body[..., 0], w_body[..., 1], w_body[..., 2]
    return 0.5 * torch.stack(
        [
            -qx * w0 - qy * w1 - qz * w2,
            qw * w0 - qz * w1 + qy * w2,
            qz * w0 + qw * w1 - qx * w2,
            -qy * w0 + qx * w1 + qw * w2,
        ],
        dim=-1,
    )


def from_axis_angle(alpha_rad, n, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Quaternion for rotation of alpha_rad around axis n
    (Quaternion.cpp:4-21)."""
    n = torch.as_tensor(n, dtype=dtype)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    half = 0.5 * torch.as_tensor(alpha_rad, dtype=dtype, device=n.device)
    s = torch.sin(half)
    return torch.stack(
        [torch.cos(half), s * n[..., 0], s * n[..., 1], s * n[..., 2]], dim=-1
    )
