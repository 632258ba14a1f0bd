"""Mix/compose blending (reference: shared/blend.wgsl).

All functions are xp-generic (numpy / jax.numpy) and operate on
separate channel arrays of identical shape. Colors are premultiplied
linear RGBA at the blend_mix_compose boundary, matching the fine
shader's conventions. Mode constants follow the jello enums (SRC_OVER=0,
CLEAR=3 — the swapped-zero-value convention; see gfx/blend.go).
"""

from __future__ import annotations

MIX_NORMAL = 0
MIX_MULTIPLY = 1
MIX_SCREEN = 2
MIX_OVERLAY = 3
MIX_DARKEN = 4
MIX_LIGHTEN = 5
MIX_COLOR_DODGE = 6
MIX_COLOR_BURN = 7
MIX_HARD_LIGHT = 8
MIX_SOFT_LIGHT = 9
MIX_DIFFERENCE = 10
MIX_EXCLUSION = 11
MIX_HUE = 12
MIX_SATURATION = 13
MIX_COLOR = 14
MIX_LUMINOSITY = 15
MIX_CLIP = 128

COMPOSE_SRC_OVER = 0
COMPOSE_COPY = 1
COMPOSE_DEST = 2
COMPOSE_CLEAR = 3
COMPOSE_DEST_OVER = 4
COMPOSE_SRC_IN = 5
COMPOSE_DEST_IN = 6
COMPOSE_SRC_OUT = 7
COMPOSE_DEST_OUT = 8
COMPOSE_SRC_ATOP = 9
COMPOSE_DEST_ATOP = 10
COMPOSE_XOR = 11
COMPOSE_PLUS = 12
COMPOSE_PLUS_LIGHTER = 13

BLEND_DEFAULT = (MIX_NORMAL << 8) | COMPOSE_SRC_OVER
EPSILON = 1e-15


def _screen(cb, cs):
    return cb + cs - cb * cs


def _color_dodge(xp, cb, cs):
    r = xp.minimum(1.0, cb / xp.maximum(1.0 - cs, 1e-30))
    r = xp.where(cs == 1.0, 1.0, r)
    return xp.where(cb == 0.0, 0.0, r)


def _color_burn(xp, cb, cs):
    r = 1.0 - xp.minimum(1.0, (1.0 - cb) / xp.maximum(cs, 1e-30))
    r = xp.where(cs == 0.0, 0.0, r)
    return xp.where(cb == 1.0, 1.0, r)


def _hard_light(xp, cb, cs):
    return xp.where(cs <= 0.5, cb * 2.0 * cs, _screen(cb, 2.0 * cs - 1.0))


def _soft_light(xp, cb, cs):
    d = xp.where(cb <= 0.25, ((16.0 * cb - 12.0) * cb + 4.0) * cb, xp.sqrt(xp.maximum(cb, 0.0)))
    return xp.where(
        cs <= 0.5,
        cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb),
        cb + (2.0 * cs - 1.0) * (d - cb),
    )


def _sat3(xp, r, g, b):
    return xp.maximum(r, xp.maximum(g, b)) - xp.minimum(r, xp.minimum(g, b))


def _lum3(r, g, b):
    return 0.3 * r + 0.59 * g + 0.11 * b


def _clip_color(xp, r, g, b):
    l = _lum3(r, g, b)
    n = xp.minimum(r, xp.minimum(g, b))
    x = xp.maximum(r, xp.maximum(g, b))

    def fix_low(c):
        denom = xp.where(l - n == 0.0, 1e-30, l - n)
        return xp.where(n < 0.0, l + ((c - l) * l) / denom, c)

    r, g, b = fix_low(r), fix_low(g), fix_low(b)
    x = xp.where(n < 0.0, xp.maximum(r, xp.maximum(g, b)), x)

    def fix_high(c):
        denom = xp.where(x - l == 0.0, 1e-30, x - l)
        return xp.where(x > 1.0, l + ((c - l) * (1.0 - l)) / denom, c)

    return fix_high(r), fix_high(g), fix_high(b)


def _set_lum(xp, r, g, b, l):
    d = l - _lum3(r, g, b)
    return _clip_color(xp, r + d, g + d, b + d)


def _set_sat(xp, r, g, b, s):
    """Scale the channels so max-min == s, preserving channel order.

    Branch-free reformulation of blend.wgsl set_sat (sorting network on
    three channels)."""
    cmax = xp.maximum(r, xp.maximum(g, b))
    cmin = xp.minimum(r, xp.minimum(g, b))
    cmid = r + g + b - cmax - cmin
    rng = cmax - cmin
    denom = xp.where(rng == 0.0, 1e-30, rng)
    new_mid = xp.where(rng > 0.0, ((cmid - cmin) * s) / denom, 0.0)
    new_max = xp.where(rng > 0.0, s, 0.0)

    def remap(c):
        is_max = c == cmax
        is_min = c == cmin
        # Ties: if all equal, max wins for exactly one conceptual slot but
        # the result is uniform anyway (rng == 0 -> all zeros).
        return xp.where(is_min, 0.0, xp.where(is_max, new_max, new_mid))

    # Handle two-way ties deterministically: when cmax == cmin the result
    # is all zeros (rng == 0).
    rr, gg, bb = remap(r), remap(g), remap(b)
    rr = xp.where(rng == 0.0, 0.0, rr)
    gg = xp.where(rng == 0.0, 0.0, gg)
    bb = xp.where(rng == 0.0, 0.0, bb)
    return rr, gg, bb


def blend_mix(xp, cbr, cbg, cbb, csr, csg, csb, mode):
    """Mix two separated RGB colors; `mode` is a (possibly array) mix id."""

    def mix3(f):
        return f(cbr, csr), f(cbg, csg), f(cbb, csb)

    outs = {
        MIX_MULTIPLY: mix3(lambda cb, cs: cb * cs),
        MIX_SCREEN: mix3(_screen),
        MIX_OVERLAY: (
            _hard_light(xp, csr, cbr),
            _hard_light(xp, csg, cbg),
            _hard_light(xp, csb, cbb),
        ),
        MIX_DARKEN: mix3(xp.minimum),
        MIX_LIGHTEN: mix3(xp.maximum),
        MIX_COLOR_DODGE: mix3(lambda cb, cs: _color_dodge(xp, cb, cs)),
        MIX_COLOR_BURN: mix3(lambda cb, cs: _color_burn(xp, cb, cs)),
        MIX_HARD_LIGHT: (
            _hard_light(xp, cbr, csr),
            _hard_light(xp, cbg, csg),
            _hard_light(xp, cbb, csb),
        ),
        MIX_SOFT_LIGHT: (
            _soft_light(xp, cbr, csr),
            _soft_light(xp, cbg, csg),
            _soft_light(xp, cbb, csb),
        ),
        MIX_DIFFERENCE: mix3(lambda cb, cs: xp.abs(cb - cs)),
        MIX_EXCLUSION: mix3(lambda cb, cs: cb + cs - 2.0 * cb * cs),
    }
    sat_cb = _sat3(xp, cbr, cbg, cbb)
    sat_cs = _sat3(xp, csr, csg, csb)
    lum_cb = _lum3(cbr, cbg, cbb)
    lum_cs = _lum3(csr, csg, csb)
    hr, hg, hb = _set_sat(xp, csr, csg, csb, sat_cb)
    outs[MIX_HUE] = _set_lum(xp, hr, hg, hb, lum_cb)
    sr_, sg_, sb_ = _set_sat(xp, cbr, cbg, cbb, sat_cs)
    outs[MIX_SATURATION] = _set_lum(xp, sr_, sg_, sb_, lum_cb)
    outs[MIX_COLOR] = _set_lum(xp, csr, csg, csb, lum_cb)
    outs[MIX_LUMINOSITY] = _set_lum(xp, cbr, cbg, cbb, lum_cs)

    rr, rg, rb = csr, csg, csb  # default: normal
    for m, (r, g, b) in outs.items():
        sel = mode == m
        rr = xp.where(sel, r, rr)
        rg = xp.where(sel, g, rg)
        rb = xp.where(sel, b, rb)
    return rr, rg, rb


def blend_compose(xp, cbr, cbg, cbb, csr, csg, csb, ab, as_, mode):
    """Porter-Duff composition on separated colors; output premultiplied."""
    one = xp.ones_like(ab)
    zero = xp.zeros_like(ab)
    fa = xp.where(
        mode == COMPOSE_COPY, one,
        xp.where(mode == COMPOSE_DEST, zero,
        xp.where(mode == COMPOSE_SRC_OVER, one,
        xp.where(mode == COMPOSE_DEST_OVER, 1.0 - ab,
        xp.where(mode == COMPOSE_SRC_IN, ab,
        xp.where(mode == COMPOSE_DEST_IN, zero,
        xp.where(mode == COMPOSE_SRC_OUT, 1.0 - ab,
        xp.where(mode == COMPOSE_DEST_OUT, zero,
        xp.where(mode == COMPOSE_SRC_ATOP, ab,
        xp.where(mode == COMPOSE_DEST_ATOP, 1.0 - ab,
        xp.where(mode == COMPOSE_XOR, 1.0 - ab,
        xp.where(mode == COMPOSE_PLUS, one, zero))))))))))))
    fb = xp.where(
        mode == COMPOSE_COPY, zero,
        xp.where(mode == COMPOSE_DEST, one,
        xp.where(mode == COMPOSE_SRC_OVER, 1.0 - as_,
        xp.where(mode == COMPOSE_DEST_OVER, one,
        xp.where(mode == COMPOSE_SRC_IN, zero,
        xp.where(mode == COMPOSE_DEST_IN, as_,
        xp.where(mode == COMPOSE_SRC_OUT, zero,
        xp.where(mode == COMPOSE_DEST_OUT, 1.0 - as_,
        xp.where(mode == COMPOSE_SRC_ATOP, 1.0 - as_,
        xp.where(mode == COMPOSE_DEST_ATOP, as_,
        xp.where(mode == COMPOSE_XOR, 1.0 - as_,
        xp.where(mode == COMPOSE_PLUS, one, zero))))))))))))
    as_fa = as_ * fa
    ab_fb = ab * fb
    co_r = as_fa * csr + ab_fb * cbr
    co_g = as_fa * csg + ab_fb * cbg
    co_b = as_fa * csb + ab_fb * cbb
    co_a = xp.minimum(as_fa + ab_fb, 1.0)
    # PLUS_LIGHTER special case.
    pl = mode == COMPOSE_PLUS_LIGHTER
    co_r = xp.where(pl, xp.minimum(1.0, as_ * csr + ab * cbr), co_r)
    co_g = xp.where(pl, xp.minimum(1.0, as_ * csg + ab * cbg), co_g)
    co_b = xp.where(pl, xp.minimum(1.0, as_ * csb + ab * cbb), co_b)
    co_a = xp.where(pl, xp.minimum(1.0, as_ + ab), co_a)
    return co_r, co_g, co_b, co_a


def blend_mix_compose(xp, bg, src, mode):
    """Full mix+compose of premultiplied RGBA tuples (r, g, b, a).

    `mode` is the packed (mix << 8) | compose word; may be an array
    broadcastable against the channels."""
    bgr, bgg, bgb, bga = bg
    sr, sg, sb, sa = src
    # Fast path: normal/src-over (and pure clip).
    fast = (mode & 0x7FFF) == BLEND_DEFAULT
    f_r = bgr * (1.0 - sa) + sr
    f_g = bgg * (1.0 - sa) + sg
    f_b = bgb * (1.0 - sa) + sb
    f_a = bga * (1.0 - sa) + sa

    inv_sa = 1.0 / xp.maximum(sa, EPSILON)
    csr, csg, csb = sr * inv_sa, sg * inv_sa, sb * inv_sa
    inv_ba = 1.0 / xp.maximum(bga, EPSILON)
    cbr, cbg, cbb = bgr * inv_ba, bgg * inv_ba, bgb * inv_ba
    mix_mode = mode >> 8
    mr, mg, mb = blend_mix(xp, cbr, cbg, cbb, csr, csg, csb, mix_mode)
    csr = csr + (mr - csr) * bga
    csg = csg + (mg - csg) * bga
    csb = csb + (mb - csb) * bga
    compose_mode = mode & 0xFF
    # SRC_OVER after mixing: mix(premultiplied backdrop rgb, mixed
    # separated cs, src.a) — exactly blend.wgsl:304-306.
    so_r = bgr + (csr - bgr) * sa
    so_g = bgg + (csg - bgg) * sa
    so_b = bgb + (csb - bgb) * sa
    so_a = sa + bga * (1.0 - sa)
    gc_r, gc_g, gc_b, gc_a = blend_compose(
        xp, cbr, cbg, cbb, csr, csg, csb, bga, sa, compose_mode
    )
    slow_is_srcover = compose_mode == COMPOSE_SRC_OVER
    s_r = xp.where(slow_is_srcover, so_r, gc_r)
    s_g = xp.where(slow_is_srcover, so_g, gc_g)
    s_b = xp.where(slow_is_srcover, so_b, gc_b)
    s_a = xp.where(slow_is_srcover, so_a, gc_a)
    return (
        xp.where(fast, f_r, s_r),
        xp.where(fast, f_g, s_g),
        xp.where(fast, f_b, s_b),
        xp.where(fast, f_a, s_a),
    )
