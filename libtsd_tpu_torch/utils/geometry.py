"""Geometry: quaternions, Cardan (Euler) angles, rotation matrices
(PyTorch), ported from ``libtsd_tpu/utils/geometry.py``.

Parity: core/include/tsd/geometrie.hpp:30-165, core/src/geometrie.cc.

Functions of tensors run on their device and compose with ``torch.func``
(the IMU model takes its Jacobians through them); other input (plain
numbers, an array) goes to ``device``: the card unless the caller names
another.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import device as _device, real_dtype

__all__ = [
    "quat_mult", "quat_conj", "quat_normalize", "quat_rotate",
    "quat_to_rotmat", "rotmat_to_quat", "quat_from_axis_angle",
    "cardan_to_rotmat", "rotmat_to_cardan", "quat_from_cardan",
    "quat_to_cardan",
]


def _args(*xs, device="cuda"):
    """The arguments as float32 tensors on the device of the first tensor
    among them, else on ``device``."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        dev = _device(device)
    return [x.to(device=dev, dtype=real_dtype) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x), dtype=real_dtype, device=dev)
            for x in xs]


def quat_mult(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [w, x, y, z] convention (parity: Quaternion::op*,
    geometrie.cc)."""
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.as_tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                               device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by unit quaternion q."""
    qv = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype,
                                device=v.device), v], dim=-1)
    return quat_mult(quat_mult(q, qv), quat_conj(q))[..., 1:]


def quat_from_axis_angle(axis, angle, device="cuda") -> torch.Tensor:
    axis, angle = _args(axis, angle, device=device)
    axis = axis / torch.linalg.norm(axis)
    half = angle / 2
    return torch.cat([torch.cos(half)[None], torch.sin(half) * axis])


def quat_to_rotmat(q, device="cuda") -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (parity:
    Quaternion::rot_mat)."""
    q, = _args(q, device=device)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def rotmat_to_quat(R, device="cuda") -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (Shepperd's method: ALL four
    branches, selected by the largest of (trace, R00, R11, R22); the
    trace-only form collapses 180-degree rotations to the identity).  The
    four branches are computed and the selected one gathered on the
    device (the JAX package's ``lax.switch``)."""
    R, = _args(R, device=device)
    t = torch.trace(R)
    eps = 1e-30
    w = torch.sqrt(torch.clamp(1 + t, min=eps)) / 2
    via_w = torch.stack([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])
    x = torch.sqrt(torch.clamp(1 + R[0, 0] - R[1, 1] - R[2, 2],
                               min=eps)) / 2
    via_x = torch.stack([(R[2, 1] - R[1, 2]) / (4 * x), x,
                         (R[0, 1] + R[1, 0]) / (4 * x),
                         (R[0, 2] + R[2, 0]) / (4 * x)])
    y = torch.sqrt(torch.clamp(1 - R[0, 0] + R[1, 1] - R[2, 2],
                               min=eps)) / 2
    via_y = torch.stack([(R[0, 2] - R[2, 0]) / (4 * y),
                         (R[0, 1] + R[1, 0]) / (4 * y), y,
                         (R[1, 2] + R[2, 1]) / (4 * y)])
    z = torch.sqrt(torch.clamp(1 - R[0, 0] - R[1, 1] + R[2, 2],
                               min=eps)) / 2
    via_z = torch.stack([(R[1, 0] - R[0, 1]) / (4 * z),
                         (R[0, 2] + R[2, 0]) / (4 * z),
                         (R[1, 2] + R[2, 1]) / (4 * z), z])
    cand = torch.stack([t, R[0, 0], R[1, 1], R[2, 2]])
    idx = torch.argmax(cand)
    q = torch.stack([via_w, via_x, via_y, via_z])[idx]
    # canonical sign: w >= 0
    q = torch.where(q[0] < 0, -q, q)
    return quat_normalize(q)


def cardan_to_rotmat(phi, theta, psi, device="cuda") -> torch.Tensor:
    """Cardan (roll phi, pitch theta, yaw psi) -> rotation matrix,
    R = R1(phi) R2(theta) R3(psi) in the PASSIVE (coordinate-transform)
    convention of Diebel, "Representing Attitude" (2006): R maps world
    coordinates to body coordinates (parity: Cardan::mat_rotation,
    geometrie.cc:228-232, with rotmat_3d_R1/R2/R3 from
    geometrie.hpp:109-141; golden-diffed in tests/test_golden_ref3.py)."""
    phi, theta, psi = _args(phi, theta, psi, device=device)
    one, zero = torch.ones_like(phi), torch.zeros_like(phi)
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    R1 = mat([[one, zero, zero], [zero, cf, sf], [zero, -sf, cf]])
    R2 = mat([[ct, zero, -st], [zero, one, zero], [st, zero, ct]])
    R3 = mat([[cp, sp, zero], [-sp, cp, zero], [zero, zero, one]])
    return R1 @ R2 @ R3


def rotmat_to_cardan(R, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation matrix (passive convention, see cardan_to_rotmat) ->
    (roll, pitch, yaw) (parity: Cardan::Cardan(Matrix3f),
    geometrie.cc:166-171)."""
    R, = _args(R, device=device)
    theta = -torch.arcsin(torch.clamp(R[0, 2], -1.0, 1.0))
    phi = torch.arctan2(R[1, 2], R[2, 2])
    psi = torch.arctan2(R[0, 1], R[0, 0])
    return phi, theta, psi


def quat_from_cardan(phi, theta, psi, device="cuda") -> torch.Tensor:
    return rotmat_to_quat(cardan_to_rotmat(phi, theta, psi, device=device))


def quat_to_cardan(q, device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quaternion -> Cardan angles via Diebel eq. (290), exactly as the
    reference (parity: Cardan::Cardan(Quaternion), geometrie.cc:173-182).

    The reference's inconsistency is kept on purpose: eq. (290) reads the
    ACTIVE rotation matrix of q while Cardan::mat_rotation builds the
    PASSIVE one, so its Cardan -> mat -> Quaternion -> Cardan roundtrip
    does not return the angles (golden g3_cardan_rt pins that output).
    cardan_to_rotmat / rotmat_to_cardan are a consistent inverse pair."""
    q, = _args(q, device=device)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    phi = torch.arctan2(2 * y * z + 2 * w * x, z * z - y * y - x * x + w * w)
    theta = -torch.arcsin(torch.clamp(2 * x * z - 2 * w * y, -1.0, 1.0))
    psi = torch.arctan2(2 * x * y + 2 * w * z, x * x + w * w - z * z - y * y)
    return phi, theta, psi
