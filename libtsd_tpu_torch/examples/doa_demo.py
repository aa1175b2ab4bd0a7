"""Direction of arrival on the port: MUSIC vs Capon/MVDR on a uniform
linear array, the coherent-multipath case included.  The twin of
``examples/doa_demo.py``.

A 16-element half-wavelength ULA receives (numpy snapshots, as the JAX
demo makes them)

  (a) two incoherent sources at 70 and 110 degrees: MUSIC and Capon find
      both from the sample covariance;
  (b) a coherent pair (one envelope and its own attenuated multipath
      copy): the signal subspace collapses to rank 1, MDL counts one
      source, and forward-backward spatial smoothing restores the rank.

Covariance, smoothing, MUSIC and Capon spectra and eigenvalues run on the
device.  Gates: smoothed MUSIC within 1 degree of both sources; MDL
(raw, smoothed) counts (2, 2) and (1, 2).

    python -m libtsd_tpu_torch.examples.doa_demo [--device cpu]

Parity anchor: the reference's DOA surface (MUSIC only,
core/src/apps/doa.cc:17-84).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import device as _device
from ..models import doa as DOA
from ..models.stats import mdl_source_count
from ..ops.filter_rt import _fp32_matmul

M, D, L, T = 16, 0.5, 10, 400
NF = 2048
TRUE_DEG = (70.0, 110.0)
TOL_DEG = 1.0


def steer(theta_deg):
    k = np.arange(M)
    return np.exp(2j * np.pi * D * np.cos(np.deg2rad(theta_deg)) * k)


def snapshots(coherent: bool, seed: int = 11) -> np.ndarray:
    """(M, T) complex snapshots for the two-source scene."""
    rng = np.random.default_rng(seed)
    c1 = (rng.standard_normal(T) + 1j * rng.standard_normal(T)) / 2 ** 0.5
    if coherent:
        X = np.outer(steer(TRUE_DEG[0])
                     + 0.8 * np.exp(1j * 0.7) * steer(TRUE_DEG[1]), c1)
    else:
        c2 = (rng.standard_normal(T)
              + 1j * rng.standard_normal(T)) / 2 ** 0.5
        X = np.outer(steer(TRUE_DEG[0]), c1) + np.outer(steer(TRUE_DEG[1]), c2)
    X += 0.1 * (rng.standard_normal((M, T))
                + 1j * rng.standard_normal((M, T))) / 2 ** 0.5
    return X.astype(np.complex64)


def estimate(X: torch.Tensor) -> tuple:
    """Sample covariance -> raw and smoothed MUSIC angles, Capon angles
    (radians, sorted), raw and smoothed eigenvalues, and R, Rs."""
    with _fp32_matmul():
        R = X @ X.conj().T / X.shape[1]
    Rs = DOA.spatial_smoothing(R, L)
    music_raw = torch.sort(DOA.musicdoa_1d(R, D, 2, Nf=NF)).values
    music_sm = torch.sort(DOA.musicdoa_1d(Rs, D, 2, Nf=NF)).values
    capon = torch.sort(DOA.capondoa_1d(R, D, 2, Nf=NF)).values
    return (music_raw, music_sm, capon, torch.linalg.eigvalsh(R),
            torch.linalg.eigvalsh(Rs), R, Rs)


def run_case(name: str, coherent: bool, device) -> tuple:
    """One scene: prints the estimates; returns the MDL counts (raw,
    smoothed) and the smoothed MUSIC angles in degrees."""
    X = snapshots(coherent)
    music_raw, music_sm, capon, _, _, R, Rs = estimate(
        torch.as_tensor(X, device=device))
    n_raw = int(mdl_source_count(R, T)[0])
    n_sm = int(mdl_source_count(Rs, T)[0])
    deg = np.rad2deg(music_sm.cpu().numpy())
    print(f"--- {name} (true angles {TRUE_DEG[0]:.0f}/{TRUE_DEG[1]:.0f} deg)")
    print(f"  MDL source count: raw={n_raw}  smoothed={n_sm}")
    print(f"  MUSIC  raw     : {np.rad2deg(music_raw.cpu().numpy()).round(2)}")
    print(f"  MUSIC  smoothed: {deg.round(2)}")
    print(f"  Capon/MVDR     : {np.rad2deg(capon.cpu().numpy()).round(2)}")
    err = np.abs(deg - np.asarray(TRUE_DEG))
    assert err.max() < TOL_DEG, err
    return (n_raw, n_sm), deg


def main(device="cuda") -> dict:
    """Both scenes on ``device``; returns the MDL counts and the smoothed
    MUSIC angles of each."""
    device = _device(device)
    n1, deg1 = run_case("incoherent sources", False, device)
    n2, deg2 = run_case("coherent multipath", True, device)
    assert n1 == (2, 2), n1
    assert n2 == (1, 2), "smoothing must restore the rank"
    print("OK: smoothing restored the coherent pair's rank (MDL 1 -> 2)")
    return {"mdl": [n1, n2], "music_deg": [deg1.tolist(), deg2.tolist()]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
