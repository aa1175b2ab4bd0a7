"""State estimation: state-space models, Kalman filter, extended Kalman
filter, steady-state gain, example models (PyTorch), ported from
``libtsd_tpu/models/kalman.py``.

Parity: core/src/kalman/kalman.cc:35-654, core/include/tsd/apps/kalman.hpp.

The filters are Python loops of device operations over the observations
(the JAX package's ``lax.scan``), on the observations' device.  A step
makes no host synchronisation: the gain comes from ``torch.linalg.solve_ex``
(``solve`` checks its result with a sync), or a division when the
observation is scalar.  EKF Jacobians come from ``torch.func.jacfwd``
(exact forward-mode autodiff, as ``jax.jacfwd`` in the JAX package, where
the reference differences numerically, kalman.hpp:26-160).
``kalman_steady_gain`` is a host float64 numpy copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import as_tensor, real_dtype
from ..ops.filter_rt import _fp32_matmul

__all__ = [
    "LinearSSM", "kalman_filter", "ekf_filter", "kalman_steady_gain",
    "ssm_random_walk", "ssm_constant", "kitagawa_model",
]


def _dev_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=real_dtype)
    return torch.as_tensor(np.asarray(a), dtype=real_dtype, device=device)


def _gain(Pp: torch.Tensor, G: torch.Tensor,
          S: torch.Tensor) -> torch.Tensor:
    """Kalman gain K = Pp G^T S^-1 (the JAX package's
    ``solve(S.T, (Pp G^T).T).T``) without a host sync."""
    PG = Pp @ G.T
    if S.shape[0] == 1:
        return PG / S[0, 0]
    return torch.linalg.solve_ex(S.T, PG.T)[0].T


@dataclasses.dataclass(frozen=True)
class LinearSSM:
    """x' = A x + w, y = C x + v (parity: SSMLineaire, kalman.cc:35-271).
    The matrices are host arrays, as in the JAX package."""
    A: np.ndarray
    C: np.ndarray
    Q: np.ndarray       # process noise covariance
    R: np.ndarray       # measurement noise covariance

    @property
    def nx(self) -> int:
        return self.A.shape[0]

    @property
    def ny(self) -> int:
        return self.C.shape[0]

    def simulate(self, gen: torch.Generator, n: int, x0=None):
        """Draw a trajectory and its observations on the generator's
        device: (xs (n, nx), ys (n, ny))."""
        dev = gen.device
        A = _dev_tensor(self.A, dev)
        C = _dev_tensor(self.C, dev)
        Lq = _dev_tensor(np.linalg.cholesky(
            self.Q + 1e-12 * np.eye(self.nx)), dev)
        Lr = _dev_tensor(np.linalg.cholesky(
            self.R + 1e-12 * np.eye(self.ny)), dev)
        x = (torch.zeros(self.nx, dtype=real_dtype, device=dev) if x0 is None
             else _dev_tensor(x0, dev))
        with _fp32_matmul():
            ws = torch.randn((n, self.nx), generator=gen, dtype=real_dtype,
                             device=dev) @ Lq.T
            vs = torch.randn((n, self.ny), generator=gen, dtype=real_dtype,
                             device=dev) @ Lr.T
            xs, ys = [], []
            for i in range(n):
                x = A @ x + ws[i]
                xs.append(x)
                ys.append(C @ x + vs[i])
        return torch.stack(xs), torch.stack(ys)


def kalman_filter(ssm: LinearSSM, ys: torch.Tensor, x0=None, P0=None,
                  device="cuda"):
    """Linear Kalman filter over observations ys (n, ny), on their device
    (an array goes to ``device``).
    Returns (xs_filtered (n, nx), Ps (n, nx, nx)) (parity: FiltreKalman,
    kalman.cc:456-570)."""
    ys = as_tensor(ys, real_dtype, device)
    dev = ys.device
    A = _dev_tensor(ssm.A, dev)
    C = _dev_tensor(ssm.C, dev)
    Q = _dev_tensor(ssm.Q, dev)
    R = _dev_tensor(ssm.R, dev)
    nx = ssm.nx
    eye = torch.eye(nx, dtype=real_dtype, device=dev)
    x = (torch.zeros(nx, dtype=real_dtype, device=dev) if x0 is None
         else _dev_tensor(x0, dev))
    # reference default: identity (kalman.cc:470-473)
    P = eye if P0 is None else _dev_tensor(P0, dev)
    xs, Ps = [], []
    with _fp32_matmul():
        for i in range(ys.shape[0]):
            # predict
            xp = A @ x
            Pp = A @ P @ A.T + Q
            # update
            S = C @ Pp @ C.T + R
            K = _gain(Pp, C, S)
            innov = ys[i] - C @ xp
            x = xp + K @ innov
            P = (eye - K @ C) @ Pp
            xs.append(x)
            Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


def ekf_filter(f: Callable, g: Callable, Q, R, ys: torch.Tensor,
               x0, P0=None, device="cuda"):
    """Extended Kalman filter with autodiff Jacobians, on the observations'
    device (an array goes to ``device``).

    f(x) -> next state; g(x) -> observation, both torch functions
    (parity: FiltreEKF, kalman.cc:272-455; Jacobians by
    ``torch.func.jacfwd`` instead of numeric differences, cast to float32:
    forward mode can hand back float64 tangents, e.g. for
    ``torch.cos(1.2 * s[1])`` of a float32 ``s``).
    """
    from torch.func import jacfwd
    ys = as_tensor(ys, real_dtype, device)
    dev = ys.device
    Q = _dev_tensor(Q, dev)
    R = _dev_tensor(R, dev)
    x = _dev_tensor(x0, dev)
    nx = x.shape[0]
    eye = torch.eye(nx, dtype=real_dtype, device=dev)
    # reference default: identity (kalman.cc:470-473)
    P = eye if P0 is None else _dev_tensor(P0, dev)
    Jf = jacfwd(f)
    Jg = jacfwd(g)
    xs, Ps = [], []
    with _fp32_matmul():
        for i in range(ys.shape[0]):
            F = Jf(x).to(real_dtype)
            xp = f(x)
            Pp = F @ P @ F.T + Q
            G = Jg(xp).to(real_dtype)
            yp = g(xp)
            S = G @ Pp @ G.T + R
            K = _gain(Pp, G, S)
            x = xp + K @ torch.atleast_1d(ys[i] - yp)
            P = (eye - K @ G) @ Pp
            xs.append(x)
            Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


def kalman_steady_gain(ssm: LinearSSM, iters: int = 200) -> np.ndarray:
    """Steady-state Kalman gain by Riccati iteration, host float64
    (parity: kalman_ssg, kalman.hpp:412)."""
    if iters < 1:
        raise ValueError(f"kalman_steady_gain needs iters >= 1 "
                         f"(got {iters})")
    A, C, Q, R = (np.asarray(m, np.float64)
                  for m in (ssm.A, ssm.C, ssm.Q, ssm.R))
    nx = A.shape[0]
    P = np.eye(nx)
    for _ in range(iters):
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        P = (np.eye(nx) - K @ C) @ Pp
    return K


# ------------------------------------------------------------ examples

def ssm_random_walk(q: float = 0.01, r: float = 1.0) -> LinearSSM:
    """Scalar random walk observed in noise (parity: modèle marche
    aléatoire, kalman.cc:571-600)."""
    return LinearSSM(A=np.array([[1.0]]), C=np.array([[1.0]]),
                     Q=np.array([[q]]), R=np.array([[r]]))


def ssm_constant(r: float = 1.0) -> LinearSSM:
    """Constant-state model (parity: modèle constante, kalman.cc)."""
    return LinearSSM(A=np.array([[1.0]]), C=np.array([[1.0]]),
                     Q=np.array([[0.0]]), R=np.array([[r]]))


def kitagawa_model():
    """Kitagawa's nonlinear benchmark (parity: kalman.cc:620-654):
    x' = x/2 + 25 x/(1+x^2) + 8 cos(1.2 n); y = x^2/20.
    Returns (f, g), torch functions of the state packed as [x, n]."""

    def f(s):
        x, n = s[0], s[1]
        xn = 0.5 * x + 25 * x / (1 + x * x) + 8 * torch.cos(1.2 * n)
        return torch.stack([xn, n + 1])

    def g(s):
        return torch.atleast_1d(s[0] ** 2 / 20.0)

    return f, g
