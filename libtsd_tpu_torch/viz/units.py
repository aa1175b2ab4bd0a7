"""Engineering-unit tick/value formatting (SI prefixes, shared exponent).

Parity: tsd::vue::unites (core/src/vue/unites.cc:8-155) —
the reference uses this to label plot axes ("1.5 KHz"); here it also
serves report tables and Figure tick labels.  A copy of
``libtsd_tpu/viz/units.py``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

__all__ = ["calc_expo_ndigits", "calc_expo_ndigits_common", "unit_format",
           "si_tick_formatter"]

_PREFIX = {9: "G", 6: "M", 3: "K", 0: "", -3: "m", -6: "u"}


def _ndigits_scaled(a: float) -> int:
    """Significant decimals needed to print `a` exactly-ish (parity:
    unites.cc ndigits — first i with a*10^i integral to float eps)."""
    for i in range(8):
        at = a * 10.0 ** i
        if abs(at - round(at)) < 2 * 10.0 ** i * 1.2e-7:
            return i
    return 8


def calc_expo_ndigits(t: float, unit: str = "") -> Tuple[int, int]:
    """Choose (decimal exponent, digit count) for one value (parity:
    calc_expo_nb_chiffres, unites.cc:86-122)."""
    at = abs(t)
    if not unit:
        if t == 0:
            return 0, 0
        if at >= 0.1:
            return 0, _ndigits_scaled(at)
        p = math.floor(math.log10(at))
        return p, _ndigits_scaled(at * 10.0 ** -p)
    if 1 <= at < 1e3:
        return 0, _ndigits_scaled(at)
    if 1e3 <= at < 1e6:
        return 3, _ndigits_scaled(at * 1e-3)
    if 1e6 <= at < 1e9:
        return 6, _ndigits_scaled(at * 1e-6)
    if at >= 1e9:
        return 9, _ndigits_scaled(at * 1e-9)
    if t == 0:
        return 0, 0
    if at < 1e-3:
        return -6, _ndigits_scaled(at * 1e6)
    return -3, _ndigits_scaled(at * 1e3)


def calc_expo_ndigits_common(tics: Sequence[float],
                             unit: str = "") -> Tuple[int, int]:
    """Shared (exponent, digits) over a tick vector: the smallest nonzero
    tick's exponent, enough digits for every tick (parity:
    calc_expo_nb_chiffres_commun, unites.cc:125-155)."""
    tics = list(tics)
    if not tics:
        return 0, 0
    expo = None
    for t in tics:
        if t != 0:
            e, _ = calc_expo_ndigits(t, unit)
            expo = e if expo is None else min(expo, e)
    if expo is None:
        expo = 0
    nd = max(_ndigits_scaled(abs(t) * 10.0 ** -expo) for t in tics)
    return expo, nd


def unit_format(t: float, unit: str = "", expo: int | None = None,
                ndigits: int | None = None) -> str:
    """Format a value with an SI-prefixed unit: unit_format(1500, "Hz") ->
    "1.5 KHz" (parity: valeur_vers_chaine, unites.cc:8-59, including the
    reference's "K" capitalization and "e{expo}" fallback)."""
    if expo is None or ndigits is None:
        e, n = calc_expo_ndigits(t, unit)
        expo = e if expo is None else expo
        ndigits = n if ndigits is None else ndigits
    if unit:
        un = _PREFIX.get(expo)
        un = (un + unit) if un is not None else ("?" + unit)
    else:
        un = f"e{expo}" if expo != 0 else ""
    tv = t * 10.0 ** -expo
    un = (" " + un) if un else ""
    if ndigits == 0:
        return f"{round(tv):d}{un}"
    return f"{tv:.{ndigits}f}{un}"


def si_tick_formatter(tics: Sequence[float], unit: str = "") -> list[str]:
    """Format a whole tick vector with one shared exponent/digit count —
    what the reference's axes do (axes.cc via unites)."""
    expo, nd = calc_expo_ndigits_common(tics, unit)
    return [unit_format(t, unit, expo, nd) for t in tics]
