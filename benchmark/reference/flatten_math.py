"""Euler-spiral flattening mathematics.

This is the numerical core of the `flatten` stage: fitting G1 Euler
spiral segments to cubic Béziers and computing the subdivision density
for their (possibly offset) parallel curves, following the algorithms of
the reference implementation (engine/wgpu_engine/shaders/cpu/flatten.go,
euler.go — themselves a port of the Vello stroke expansion work).

Every function is written against an array-module parameter-free style
using operators and `where`, so the same code runs under numpy (the
oracle, shaders/cpu analog) and jax.numpy (the device pipeline). All
arithmetic is float32 to match device semantics; callers are responsible
for passing float32 arrays.

Coordinates are SoA: separate x and y arrays throughout.
"""

from __future__ import annotations

import contextlib

import numpy as _np


def _quiet(xp):
    """Silence numpy invalid/overflow warnings from masked degenerate
    lanes (their results are discarded by a `where` downstream); no-op
    under jax.numpy, which doesn't emit runtime warnings."""
    from .pmath import base_xp

    if base_xp(xp) is _np:
        return _np.errstate(invalid="ignore", divide="ignore", over="ignore")
    return contextlib.nullcontext()

# Constants (reference: flatten.go:24-31, euler.go:16, cpu.go:78-86)
DERIV_THRESH = 1e-6
DERIV_EPS = 1e-6
SUBDIV_LIMIT = 1.0 / 65536.0
TANGENT_THRESH = 1e-6
ROBUST_EPSILON = 2e-7
K1_THRESH = 1e-3
DIST_THRESH = 1e-3
FLATTEN_TOL = 0.25
MAX_LINES_PER_EULER_SEG = 100.0

# Robustness regimes for the ESPC integral (flatten.go espcRobust)
ROBUST_NORMAL = 0
ROBUST_LOW_K1 = 1
ROBUST_LOW_DIST = 2

_SQRT2 = float(_np.sqrt(2.0))


def f32(xp, v):
    return xp.asarray(v, dtype=xp.float32)


def eval_cubic_and_deriv(p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y, t):
    """Point and derivative of a cubic at t (flatten.go:34-48)."""
    m = 1.0 - t
    mm = m * m
    mt = m * t
    tt = t * t
    px = p0x * (mm * m) + (p1x * (3.0 * mm) + p2x * (3.0 * mt) + p3x * tt) * t
    py = p0y * (mm * m) + (p1y * (3.0 * mm) + p2y * (3.0 * mt) + p3y * tt) * t
    qx = (p1x - p0x) * mm + (p2x - p1x) * (2.0 * mt) + (p3x - p2x) * tt
    qy = (p1y - p0y) * mm + (p2y - p1y) * (2.0 * mt) + (p3y - p2y) * tt
    return px, py, qx, qy


def cubic_start_tangent(xp, p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y):
    d01x, d01y = p1x - p0x, p1y - p0y
    d02x, d02y = p2x - p0x, p2y - p0y
    d03x, d03y = p3x - p0x, p3y - p0y
    use01 = d01x * d01x + d01y * d01y > ROBUST_EPSILON
    use02 = d02x * d02x + d02y * d02y > ROBUST_EPSILON
    tx = xp.where(use01, d01x, xp.where(use02, d02x, d03x))
    ty = xp.where(use01, d01y, xp.where(use02, d02y, d03y))
    return tx, ty


def cubic_end_tangent(xp, p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y):
    d23x, d23y = p3x - p2x, p3y - p2y
    d13x, d13y = p3x - p1x, p3y - p1y
    d03x, d03y = p3x - p0x, p3y - p0y
    use23 = d23x * d23x + d23y * d23y > ROBUST_EPSILON
    use13 = d13x * d13x + d13y * d13y > ROBUST_EPSILON
    tx = xp.where(use23, d23x, xp.where(use13, d13x, d03x))
    ty = xp.where(use23, d23y, xp.where(use13, d13y, d03y))
    return tx, ty


def cubic_params_from_points_derivs(xp, p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y, dt):
    """Fit parameters (th0, th1, chord_len, err) — euler.go:70-141."""
    chordx = p1x - p0x
    chordy = p1y - p0y
    chord_sq = chordx * chordx + chordy * chordy
    chord_len = xp.sqrt(chord_sq)
    degenerate = chord_sq < TANGENT_THRESH * TANGENT_THRESH
    # Degenerate (near-zero chord) error estimate.
    q0_ls = q0x * q0x + q0y * q0y
    q1_ls = q1x * q1x + q1y * q1y
    chord_err = xp.sqrt((9.0 / 32.0) * (q0_ls + q1_ls)) * dt

    # Happy path.
    safe_chord_sq = xp.where(degenerate, f32(xp, 1.0), chord_sq)
    scale = dt / safe_chord_sq
    h0x = q0x * chordx + q0y * chordy
    h0y = q0y * chordx - q0x * chordy
    th0 = xp.arctan2(h0y, h0x)
    d0 = xp.sqrt(h0x * h0x + h0y * h0y) * scale
    h1x = q1x * chordx + q1y * chordy
    h1y = q1x * chordy - q1y * chordx
    th1 = xp.arctan2(h1y, h1x)
    d1 = xp.sqrt(h1x * h1x + h1y * h1y) * scale

    cth0 = xp.cos(th0)
    cth1 = xp.cos(th1)
    # Error of geometric Hermite interpolation to Euler spiral.
    e0 = (2.0 / 3.0) / xp.maximum(1.0 + cth0, f32(xp, 1e-9))
    e1 = (2.0 / 3.0) / xp.maximum(1.0 + cth1, f32(xp, 1e-9))
    s0 = xp.sin(th0)
    s1 = xp.sin(th1)
    s01 = cth0 * s1 + cth1 * s0
    amin = 0.15 * (2.0 * e0 * s0 + 2.0 * e1 * s1 - e0 * e1 * s01)
    a = 0.15 * (2.0 * d0 * s0 + 2.0 * d1 * s1 - d0 * d1 * s01)
    aerr = xp.abs(a - amin)
    symm = xp.abs(th0 + th1)
    asymm = xp.abs(th0 - th1)
    dist = xp.sqrt((d0 - e0) * (d0 - e0) + (d1 - e1) * (d1 - e1))
    ctr = 4.625e-6 * symm**5 + 7.5e-3 * asymm * (symm * symm)
    halo_symm = 5e-3 * symm * dist
    halo_asymm = 7e-2 * asymm * dist
    err_happy = xp.where(
        cth0 * cth1 < 0.0,
        f32(xp, 2.0),
        ctr + 1.55 * aerr + halo_symm + halo_asymm,
    )
    err_happy = err_happy * chord_len

    th0 = xp.where(degenerate, f32(xp, 0.0), th0)
    th1 = xp.where(degenerate, f32(xp, 0.0), th1)
    chord_len = xp.where(degenerate, f32(xp, TANGENT_THRESH), chord_len)
    err = xp.where(degenerate, chord_err, err_happy)
    return th0, th1, chord_len, err


def euler_params_from_angles(th0, th1):
    """(k0, k1, ch) of the Euler spiral through angles (euler.go:143-172)."""
    k0 = th0 + th1
    dth = th1 - th0
    d2 = dth * dth
    k2 = k0 * k0
    a = 6.0 - d2 * (1.0 / 70.0) - (d2 * d2) * (1.0 / 10780.0) + (d2 * d2 * d2) * 2.769178184818219e-07
    b = -0.1 + d2 * (1.0 / 4200.0) + d2 * d2 * 1.6959677820260655e-05
    c = -1.0 / 1400.0 + d2 * 6.84915970574303e-05 - k2 * 7.936475029053326e-06
    a = a + (b + c * k2) * k2
    k1 = dth * a

    ch = (
        1.0
        - d2 * (1.0 / 40.0)
        + (d2 * d2) * 0.00034226190482569864
        - (d2 * d2 * d2) * 1.9349474568904524e-06
    )
    b = -1.0 / 24.0 + d2 * 0.0024702380951963226 - d2 * d2 * 3.7297408997537985e-05
    c = 1.0 / 1920.0 - d2 * 4.87350869747975e-05 - k2 * 3.1001936068463107e-06
    ch = ch + (b + c * k2) * k2
    return k0, k1, ch


def integrate_euler10(xp, k0, k1):
    """10th-order polynomial Euler spiral integral (euler.go:226-256)."""
    t1_1 = k0
    t1_2 = 0.5 * k1
    t2_2 = t1_1 * t1_1
    t2_3 = 2.0 * (t1_1 * t1_2)
    t2_4 = t1_2 * t1_2
    t3_4 = t2_2 * t1_2 + t2_3 * t1_1
    t3_6 = t2_4 * t1_2
    t4_4 = t2_2 * t2_2
    t4_5 = 2.0 * (t2_2 * t2_3)
    t4_6 = 2.0 * (t2_2 * t2_4) + t2_3 * t2_3
    t4_7 = 2.0 * (t2_3 * t2_4)
    t4_8 = t2_4 * t2_4
    t5_6 = t4_4 * t1_2 + t4_5 * t1_1
    t5_8 = t4_6 * t1_2 + t4_7 * t1_1
    t6_6 = t4_4 * t2_2
    t6_7 = t4_4 * t2_3 + t4_5 * t2_2
    t6_8 = t4_4 * t2_4 + t4_5 * t2_3 + t4_6 * t2_2
    t7_8 = t6_6 * t1_2 + t6_7 * t1_1
    t8_8 = t6_6 * t2_2
    u = (
        1.0
        - ((1.0 / 24.0) * t2_2 + (1.0 / 160.0) * t2_4)
        + ((1.0 / 1920.0) * t4_4 + (1.0 / 10752.0) * t4_6 + (1.0 / 55296.0) * t4_8)
        - ((1.0 / 322560.0) * t6_6 + (1.0 / 1658880.0) * t6_8)
        + (1.0 / 92897280.0) * t8_8
    )
    v = (
        (1.0 / 12.0) * t1_2
        - ((1.0 / 480.0) * t3_4 + (1.0 / 2688.0) * t3_6)
        + ((1.0 / 53760.0) * t5_6 + (1.0 / 276480.0) * t5_8)
        - (1.0 / 11612160.0) * t7_8
    )
    return u, v


def euler_eval_th(k0, k1, th0, t):
    return (k0 + 0.5 * k1 * (t - 1.0)) * t - th0


def euler_eval(xp, k0, k1, ch, th0, t):
    """Evaluate normalized Euler segment at t (euler.go:178-188)."""
    with _quiet(xp):
        thm = euler_eval_th(k0, k1, th0, t * 0.5)
        u, v = integrate_euler10(xp, (k0 + k1 * (0.5 * t - 0.5)) * t, k1 * t * t)
        s = t / ch * xp.sin(thm)
        c = t / ch * xp.cos(thm)
        x = u * c - v * s
        y = -v * c - u * s
    return x, y


def euler_eval_with_offset(xp, k0, k1, ch, th0, t, offset):
    """euler.go:190-194 (offset normalized to chord length)."""
    with _quiet(xp):
        th = euler_eval_th(k0, k1, th0, t)
        vx = offset * xp.sin(th)
        vy = offset * xp.cos(th)
    ex, ey = euler_eval(xp, k0, k1, ch, th0, t)
    return ex + vx, ey + vy


def euler_seg_eval_with_offset(
    xp, p0x, p0y, p1x, p1y, k0, k1, ch, th0, t, normalized_offset
):
    """Evaluate in the coordinate space of the endpoints (euler.go:202-210)."""
    chordx = p1x - p0x
    chordy = p1y - p0y
    x, y = euler_eval_with_offset(xp, k0, k1, ch, th0, t, normalized_offset)
    ox = p0x + chordx * x - chordy * y
    oy = p0y + chordx * y + chordy * x
    return ox, oy


# ESPC integral approximation constants (euler.go:258-267)
_BREAK1 = 0.8
_BREAK2 = 1.25
_BREAK3 = 2.1
_SIN_SCALE = 1.0976991822760038
_QUAD_A1 = 0.6406
_QUAD_B1 = -0.81
_QUAD_C1 = 0.9148117935952064
_QUAD_A2 = 0.5
_QUAD_B2 = -0.156
_QUAD_C2 = 0.16145779359520596


def espc_int_approx(xp, x):
    y = xp.abs(x)
    a_sin = xp.sin(_SIN_SCALE * xp.minimum(y, f32(xp, _BREAK1))) * (1.0 / _SIN_SCALE)
    a_mid = (xp.sqrt(f32(xp, 8.0)) / 3.0) * (y - 1.0) * xp.sqrt(xp.abs(y - 1.0)) + (
        _np.pi / 4.0
    )
    qa = xp.where(y < _BREAK3, f32(xp, _QUAD_A1), f32(xp, _QUAD_A2))
    qb = xp.where(y < _BREAK3, f32(xp, _QUAD_B1), f32(xp, _QUAD_B2))
    qc = xp.where(y < _BREAK3, f32(xp, _QUAD_C1), f32(xp, _QUAD_C2))
    a_quad = qa * y * y + qb * y + qc
    a = xp.where(y < _BREAK1, a_sin, xp.where(y < _BREAK2, a_mid, a_quad))
    return xp.where(x >= 0, a, -a)


def espc_int_inv_approx(xp, x):
    y = xp.abs(x)
    # branch 1: asin
    clamped = xp.clip(x * _SIN_SCALE, -1.0, 1.0)
    a_asin = xp.arcsin(clamped) * (1.0 / _SIN_SCALE)
    # branch 2
    b = y - _np.pi / 4.0
    u = xp.sign(b) * xp.abs(b) ** (2.0 / 3.0)
    a_mid = u * float(_np.cbrt(9.0 / 8.0)) + 1.0
    # branch 3
    b1 = 0.5 * _QUAD_B1 / _QUAD_A1
    b2 = 0.5 * _QUAD_B2 / _QUAD_A2
    u3 = xp.where(y < 2.038857793595206, f32(xp, b1 * b1 - _QUAD_C1 / _QUAD_A1), f32(xp, b2 * b2 - _QUAD_C2 / _QUAD_A2))
    v3 = xp.where(y < 2.038857793595206, f32(xp, 1.0 / _QUAD_A1), f32(xp, 1.0 / _QUAD_A2))
    w3 = xp.where(y < 2.038857793595206, f32(xp, b1), f32(xp, b2))
    a_quad = xp.sqrt(xp.maximum(u3 + v3 * y, 0.0)) - w3
    a = xp.where(
        y < 0.7010707591262915, a_asin, xp.where(y < 0.903249293595206, a_mid, a_quad)
    )
    return xp.where(x >= 0, xp.abs(a), -xp.abs(a))


def espc_subdivision(xp, k0_full, k1, ch, chord_len, offset, scale, tol=FLATTEN_TOL):
    """Number of line subdivisions for one Euler segment's offset curve.

    Mirrors flatten.go:425-463. Inputs are the euler params (k0 is the
    *raw* params.k0; this function applies the -0.5*k1 shift), the chord
    length of the source cubic piece, the stroke offset (0 for fills)
    and the coordinate scale.

    Returns (n, robust, a, b, int0, integral, normalized_offset) where n
    is the clamped line count and the rest allow recomputing the s(t)
    mapping at emission time.
    """
    k0 = k0_full - 0.5 * k1
    normalized_offset = offset / chord_len
    dist_scaled = normalized_offset * ch
    scale_multiplier = (
        0.5 * (1.0 / _SQRT2) * xp.sqrt(scale * chord_len / (ch * tol))
    )

    low_k1 = xp.abs(k1) < K1_THRESH
    low_dist = xp.abs(dist_scaled) < DIST_THRESH

    # LOW_K1 branch
    k = k0 + 0.5 * k1
    nf_low_k1 = xp.sqrt(xp.abs(k * (k * dist_scaled + 1.0)))

    # LOW_DIST branch
    f_b = k0 * xp.sqrt(xp.abs(k0))
    f_ab = (k1 + k0) * xp.sqrt(xp.abs(k1 + k0))
    safe_k1 = xp.where(xp.abs(k1) < 1e-12, f32(xp, 1e-12), k1)
    integral_ld = f_ab - f_b
    nf_low_dist = (2.0 / 3.0) * integral_ld / safe_k1

    # NORMAL branch
    a_n = -2.0 * dist_scaled * k1
    b_n = -1.0 - 2.0 * dist_scaled * k0
    int0_n = espc_int_approx(xp, b_n)
    int1_n = espc_int_approx(xp, a_n + b_n)
    integral_n = int1_n - int0_n
    safe_a_n = xp.where(xp.abs(a_n) < 1e-30, f32(xp, 1e-30), a_n)
    k_peak = k0 - k1 * b_n / safe_a_n
    integrand_peak = xp.sqrt(xp.abs(k_peak * (k_peak * dist_scaled + 1.0)))
    nf_normal = integral_n * integrand_peak / safe_a_n

    robust = xp.where(
        low_k1,
        ROBUST_LOW_K1,
        xp.where(low_dist, ROBUST_LOW_DIST, ROBUST_NORMAL),
    ).astype(xp.int32)
    n_frac = xp.where(low_k1, nf_low_k1, xp.where(low_dist, nf_low_dist, nf_normal))
    a = xp.where(robust == ROBUST_NORMAL, a_n, safe_k1)
    b = xp.where(robust == ROBUST_NORMAL, b_n, k0)
    int0 = xp.where(robust == ROBUST_NORMAL, int0_n, f_b)
    integral = xp.where(robust == ROBUST_NORMAL, integral_n, integral_ld)

    n = xp.clip(xp.ceil(n_frac * scale_multiplier), 1.0, MAX_LINES_PER_EULER_SEG)
    return n, robust, a, b, int0, integral, normalized_offset


def espc_s_of_t(xp, t, robust, a, b, int0, integral):
    """Map uniform t in (0,1] to arclength parameter s (flatten.go:472-486)."""
    # LOW_K1: s = t
    # LOW_DIST: c = cbrt(integral*t + int0); inv = c*|c|; s = (inv - b)/a
    # NORMAL: inv = espc_int_inv_approx(integral*t + int0); s = (inv - b)/a
    with _quiet(xp):
        arg = integral * t + int0
        c = xp.cbrt(arg) if hasattr(xp, "cbrt") else xp.sign(arg) * xp.abs(arg) ** (1.0 / 3.0)
        inv_ld = c * xp.abs(c)
        inv_n = espc_int_inv_approx(xp, arg)
        safe_a = xp.where(xp.abs(a) < 1e-30, f32(xp, 1e-30), a)
        s_ld = (inv_ld - b) / safe_a
        s_n = (inv_n - b) / safe_a
    return xp.where(
        robust == ROBUST_LOW_K1, t, xp.where(robust == ROBUST_LOW_DIST, s_ld, s_n)
    )
