"""IMU attitude model: quaternion state-space with gyro propagation and
accelerometer/magnetometer observations, for EKF fusion (PyTorch), ported
from ``libtsd_tpu/models/imu.py``.

Parity: core/src/kalman/modele-imu.cc:113-382 (quaternion attitude +
gyro/accel/mag).  The simulation and the filter are Python loops of device
operations (the JAX package's ``lax.scan``); the filter's Jacobians come
from ``torch.func.jacfwd`` and its gain from ``torch.linalg.solve_ex``, so
a step makes no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import as_tensor, real_dtype
from ..ops.filter_rt import _fp32_matmul
from ..utils.geometry import quat_conj, quat_mult, quat_normalize, quat_rotate
from .kalman import _gain

__all__ = ["ImuModel", "imu_simulate", "imu_ekf"]


@dataclasses.dataclass(frozen=True)
class ImuModel:
    """State = unit quaternion (world->body).  Inputs: gyro rates (rad/s);
    observations: gravity + magnetic field in body frame."""
    dt: float = 0.01
    gyro_noise: float = 1e-3
    accel_noise: float = 0.05
    mag_noise: float = 0.05
    g_world: tuple = (0.0, 0.0, 1.0)
    b_world: tuple = (1.0, 0.0, 0.0)

    def f(self, q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
        """Propagate attitude by gyro rates over dt (quaternion
        integration, parity: modele-imu.cc propagation)."""
        w = omega * self.dt / 2.0
        dq = torch.cat([torch.sqrt(
            torch.clamp(1 - torch.sum(w * w), min=1e-9))[None], w])
        return quat_normalize(quat_mult(q, dq))

    def g(self, q: torch.Tensor) -> torch.Tensor:
        """Observation: gravity and magnetic field rotated into the body
        frame (parity: modele-imu.cc observation)."""
        gw = torch.as_tensor(self.g_world, dtype=real_dtype, device=q.device)
        bw = torch.as_tensor(self.b_world, dtype=real_dtype, device=q.device)
        qc = quat_conj(q)
        gb = quat_rotate(qc, gw)
        bb = quat_rotate(qc, bw)
        return torch.cat([gb, bb])


def _omega_default(i: torch.Tensor) -> torch.Tensor:
    return torch.stack([0.5 * torch.sin(0.01 * i),
                        0.3 * torch.cos(0.013 * i),
                        torch.full((), 0.2, dtype=real_dtype,
                                   device=i.device)]).to(real_dtype)


def imu_simulate(model: ImuModel, gen: torch.Generator, n: int,
                 omega_fn=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Simulate a trajectory on the generator's device; returns
    (quaternions (n, 4), gyro_meas (n, 3), obs (n, 6)).  ``omega_fn(i)``
    gives the true rates (3,) at step i, an int32 0-d tensor on that
    device (the JAX contract, in torch; default: the JAX package's slow
    sinusoids)."""
    dev = gen.device
    if omega_fn is None:
        omega_fn = _omega_default
    gn = model.gyro_noise * torch.randn((n, 3), generator=gen,
                                        dtype=real_dtype, device=dev)
    an = model.accel_noise * torch.randn((n, 6), generator=gen,
                                         dtype=real_dtype, device=dev)
    steps = torch.arange(n, dtype=torch.int32, device=dev)
    q = torch.as_tensor([1.0, 0, 0, 0], dtype=real_dtype, device=dev)
    qs, gyro, obs = [], [], []
    for i in range(n):
        om = omega_fn(steps[i])
        q = model.f(q, om)
        qs.append(q)
        gyro.append(om + gn[i])
        obs.append(model.g(q) + an[i])
    return torch.stack(qs), torch.stack(gyro), torch.stack(obs)


def imu_ekf(model: ImuModel, gyro: torch.Tensor, obs: torch.Tensor,
            q0=None, device="cuda") -> torch.Tensor:
    """EKF attitude estimation from gyro + accel/mag observations, on the
    observations' device (arrays go to ``device``).  Returns filtered
    quaternions (n, 4)."""
    from torch.func import jacfwd
    obs = as_tensor(obs, real_dtype, device)
    dev = obs.device
    gyro = as_tensor(gyro, real_dtype, dev).to(dev)
    q = (torch.as_tensor([1.0, 0, 0, 0], dtype=real_dtype, device=dev)
         if q0 is None else torch.as_tensor(q0, dtype=real_dtype,
                                            device=dev))
    eye = torch.eye(4, dtype=real_dtype, device=dev)
    Q = (model.gyro_noise * model.dt) ** 2 * eye + 1e-12 * eye
    R = torch.diag(torch.cat([
        torch.full((3,), model.accel_noise ** 2, device=dev),
        torch.full((3,), model.mag_noise ** 2, device=dev)])).to(real_dtype)
    Jg = jacfwd(model.g)
    Jf = jacfwd(model.f)            # w.r.t. the quaternion
    P = 0.1 * eye
    qs = []
    with _fp32_matmul():
        for i in range(gyro.shape[0]):
            om, y = gyro[i], obs[i]
            # predict
            F = Jf(q, om).to(real_dtype)
            qp = model.f(q, om)
            Pp = F @ P @ F.T + Q
            # update
            G = Jg(qp).to(real_dtype)
            S = G @ Pp @ G.T + R
            K = _gain(Pp, G, S)
            q = quat_normalize(qp + K @ (y - model.g(qp)))
            P = (eye - K @ G) @ Pp
            qs.append(q)
    return torch.stack(qs)
