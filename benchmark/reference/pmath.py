"""Portable polynomial transcendentals shared by all three flatten paths.

The ESPC subdivision decision (flatten_math.espc_subdivision's
`n = ceil(...)`) is reached through sin/cos/arctan2/arcsin/arccos/cbrt.
Evaluating those through libm (numpy oracle), the XLA:TPU lowering
(device pipeline) and Mosaic (Pallas lockstep kernel) gives three
slightly different values, and a borderline `ceil` flip moves a whole
line of geometry (~1e-3 px) — the round-4 on-chip fills-parity outlier
(BASELINE.md, VERDICT r4 item #6). Every function here is built from
IEEE-exact elementwise ops only (+,-,*,/ ,sqrt, abs, where, round), so
numpy, XLA and Mosaic produce BIT-IDENTICAL results and the subdivision
decisions agree everywhere.

`poly_xp(xp)` wraps an array namespace so `xp.sin/cos/arctan2/...`
resolve to these polynomials and everything else forwards to the base
namespace; it is idempotent, and `__name__` mirrors the base so
`ops.is_jax` keeps working. Accuracy is a few f32 ulp (cbrt is the one
exception: its seed uses exp/log, but a Newton step pins it to ~1 ulp
and it only positions points along a segment, never counts them).
"""

from __future__ import annotations

import numpy as _np

_PI = 3.14159265358979323846
_PI_2 = _PI / 2.0

# 2/pi, and pi/2 split so k * _PIO2_1 is exact for |k| <= 2048
# (13-bit mantissa): bit-exact Cody-Waite reduction in f32.
_TWO_OVER_PI = 0.6366197723675814
_PIO2_1 = 1.5707855224609375
_PIO2_2 = 1.0804334124e-05


def _f32(xp, v):
    return xp.asarray(v, dtype=xp.float32)


def _sincos_polys(xp, x):
    """Range-reduce to r in [-pi/4, pi/4] + quadrant; return
    (sin_poly(r), cos_poly(r), quadrant)."""
    f = xp.float32
    k = xp.round(x * f(_TWO_OVER_PI))
    r = (x - k * f(_PIO2_1)) - k * f(_PIO2_2)
    q = k.astype(xp.int32) & 3
    s = r * r
    # cephes sinf/cosf minimax coefficients (f32, |err| ~1 ulp).
    sp = f(-1.9515295891e-4)
    sp = sp * s + f(8.3321608736e-3)
    sp = sp * s + f(-1.6666654611e-1)
    sinp = r + r * s * sp
    cp = f(2.443315711809948e-5)
    cp = cp * s + f(-1.388731625493765e-3)
    cp = cp * s + f(4.166664568298827e-2)
    cosp = 1.0 - 0.5 * s + s * s * cp
    return sinp, cosp, q


def sin(xp, x):
    sinp, cosp, q = _sincos_polys(xp, x)
    v = xp.where(q & 1 == 0, sinp, cosp)
    return xp.where(q >= 2, -v, v)


def cos(xp, x):
    sinp, cosp, q = _sincos_polys(xp, x)
    v = xp.where(q & 1 == 0, cosp, -sinp)
    return xp.where(q >= 2, -v, v)


def _atan_poly(xp, z):
    """arctan on [-1, 1], minimax (|err| < 3e-8)."""
    f = xp.float32
    s = z * z
    p = f(-0.0117212)
    p = p * s + f(0.05265332)
    p = p * s + f(-0.11643287)
    p = p * s + f(0.19354346)
    p = p * s + f(-0.33262348)
    p = p * s + f(0.99997723)
    return z * p


def arctan(xp, x):
    inv = xp.abs(x) > 1.0
    z = xp.where(inv, 1.0 / xp.where(x == 0.0, _f32(xp, 1.0), xp.abs(x)),
                 xp.abs(x))
    a = _atan_poly(xp, z)
    a = xp.where(inv, _f32(xp, _PI_2) - a, a)
    return xp.sign(x) * a


def arctan2(xp, y, x):
    ax = xp.abs(x)
    ay = xp.abs(y)
    mx = xp.maximum(ax, ay)
    mn = xp.minimum(ax, ay)
    a = _atan_poly(xp, mn / xp.where(mx == 0.0, _f32(xp, 1.0), mx))
    a = xp.where(ay > ax, _f32(xp, _PI_2) - a, a)
    a = xp.where(x < 0.0, _f32(xp, _PI) - a, a)
    a = xp.where(y < 0.0, -a, a)
    # atan2(0, x<0) = +pi by convention (numpy).
    a = xp.where((y == 0.0) & (x < 0.0), _f32(xp, _PI), a)
    a = xp.where((y == 0.0) & (x >= 0.0), _f32(xp, 0.0), a)
    return a


def arcsin(xp, x):
    xc = xp.clip(x, -1.0, 1.0)
    return arctan2(xp, xc, xp.sqrt(xp.maximum(1.0 - xc * xc, 0.0)))


def arccos(xp, x):
    return _f32(xp, _PI_2) - arcsin(xp, x)


def cbrt(xp, x):
    ax = xp.abs(x)
    safe = xp.maximum(ax, _f32(xp, 1e-30))
    c = xp.exp(xp.log(safe) * _f32(xp, 1.0 / 3.0))
    # One Newton step: c <- c - (c - a/c^2)/3 (restores ~1 ulp).
    c = c - (c - safe / (c * c)) * _f32(xp, 1.0 / 3.0)
    return xp.where(ax == 0.0, _f32(xp, 0.0), xp.sign(x) * c)


_OVERRIDES = {
    "sin": sin,
    "cos": cos,
    "arctan": arctan,
    "arctan2": arctan2,
    "arcsin": arcsin,
    "arccos": arccos,
    "cbrt": cbrt,
}


class PolyXp:
    """Array namespace with transcendentals replaced by the shared
    polynomials; everything else forwards to the base namespace."""

    def __init__(self, base):
        self._base = base
        self.__name__ = base.__name__

    def __getattr__(self, name):
        fn = _OVERRIDES.get(name)
        base = object.__getattribute__(self, "_base")
        if fn is not None:
            return lambda *a: fn(base, *a)
        return getattr(base, name)


def poly_xp(xp):
    if isinstance(xp, PolyXp):
        return xp
    return PolyXp(xp)


def base_xp(xp):
    """Unwrap PolyXp (for identity checks like `xp is numpy`)."""
    return xp._base if isinstance(xp, PolyXp) else xp
