"""Test assertion helpers mirroring the reference's harness.

Parity: verifie_erreur_relative / vérifie_exception,
core/src/tests-gen.cc:29-61.

Copied from ``libtsd_tpu/utils/testing.py`` (host numpy; the port keeps its
own copy so that it imports nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np

__all__ = ["check_relative_error", "check_max_error", "rms", "rms_db"]


def rms(x) -> float:
    x = np.asarray(x)
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def rms_db(x, ref) -> float:
    """RMS error in dB relative to reference RMS."""
    e = rms(np.asarray(x) - np.asarray(ref))
    r = rms(ref)
    return 20.0 * np.log10(max(e, 1e-300) / max(r, 1e-300))


def check_relative_error(value, expected, tol_percent: float, msg: str = ""):
    """Assert |value-expected| / |expected| <= tol_percent / 100
    (parity: verifie_erreur_relative, tests-gen.cc:47-61)."""
    value = np.asarray(value, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    denom = np.maximum(np.abs(expected), 1e-300)
    err = np.max(np.abs(value - expected) / denom) * 100.0
    assert err <= tol_percent, (
        f"relative error {err:.4g}% > {tol_percent}% {msg}"
    )


def check_max_error(value, expected, tol: float, msg: str = ""):
    """Assert max |value - expected| <= tol (absolute)."""
    value = np.asarray(value)
    expected = np.asarray(expected)
    err = float(np.max(np.abs(value - expected)))
    assert err <= tol, f"max abs error {err:.4g} > {tol} {msg}"
