"""Mix/compose blending on torch tensors.

Counterpart of `jello_tpu/blend_math.py` (reference: shared/blend.wgsl),
operation for operation: `blend_mix` (the 16 mix modes), `blend_compose`
(the 14 Porter-Duff modes) and `blend_mix_compose`, the full blend of
two premultiplied RGBA colors under the packed word (mix << 8) |
compose. Functions take separate channel tensors of one shape; `mode`
is an int or an integer tensor that broadcasts against them. Mode
constants follow the jello enums (SRC_OVER = 0, CLEAR = 3).

The CUDA interpreter (`csrc/blend.cuh`) switches on the mode where this
file selects, with the same arithmetic in each branch.
"""

from __future__ import annotations

import torch

from .pipeline.ops import shr
from .pmath import rdiv, sqrt

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


def _min3(r, g, b):
    return torch.minimum(r, torch.minimum(g, b))


def _max3(r, g, b):
    return torch.maximum(r, torch.maximum(g, b))


def _screen(cb, cs):
    return cb + cs - cb * cs


def _color_dodge(cb, cs):
    r = torch.clamp(cb / torch.clamp(1.0 - cs, min=1e-30), max=1.0)
    r = torch.where(cs == 1.0, 1.0, r)
    return torch.where(cb == 0.0, 0.0, r)


def _color_burn(cb, cs):
    r = 1.0 - torch.clamp((1.0 - cb) / torch.clamp(cs, min=1e-30), max=1.0)
    r = torch.where(cs == 0.0, 0.0, r)
    return torch.where(cb == 1.0, 1.0, r)


def _hard_light(cb, cs):
    return torch.where(cs <= 0.5, cb * 2.0 * cs, _screen(cb, 2.0 * cs - 1.0))


def _soft_light(cb, cs):
    d = torch.where(cb <= 0.25, ((16.0 * cb - 12.0) * cb + 4.0) * cb,
                    sqrt(torch.clamp(cb, min=0.0)))
    return torch.where(cs <= 0.5, cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb),
                       cb + (2.0 * cs - 1.0) * (d - cb))


def _sat3(r, g, b):
    return _max3(r, g, b) - _min3(r, g, b)


def _lum3(r, g, b):
    return 0.3 * r + 0.59 * g + 0.11 * b


def _clip_color(r, g, b):
    lum = _lum3(r, g, b)
    n = _min3(r, g, b)
    x = _max3(r, g, b)

    def fix_low(c):
        denom = torch.where(lum - n == 0.0, 1e-30, lum - n)
        return torch.where(n < 0.0, lum + ((c - lum) * lum) / denom, c)

    r, g, b = fix_low(r), fix_low(g), fix_low(b)
    x = torch.where(n < 0.0, _max3(r, g, b), x)

    def fix_high(c):
        denom = torch.where(x - lum == 0.0, 1e-30, x - lum)
        return torch.where(x > 1.0, lum + ((c - lum) * (1.0 - lum)) / denom, c)

    return fix_high(r), fix_high(g), fix_high(b)


def _set_lum(r, g, b, lum):
    d = lum - _lum3(r, g, b)
    return _clip_color(r + d, g + d, b + d)


def _set_sat(r, g, b, s):
    """Scale the channels so that max - min == s, keeping their order (a
    branch-free form of blend.wgsl's set_sat). Ties: a channel equal to
    the minimum maps to 0 before one equal to the maximum maps to s; all
    equal gives zeros."""
    cmax = _max3(r, g, b)
    cmin = _min3(r, g, b)
    cmid = r + g + b - cmax - cmin
    rng = cmax - cmin
    denom = torch.where(rng == 0.0, 1e-30, rng)
    new_mid = torch.where(rng > 0.0, ((cmid - cmin) * s) / denom, 0.0)
    new_max = torch.where(rng > 0.0, s, 0.0)

    def remap(c):
        out = torch.where(c == cmin, 0.0, torch.where(c == cmax, new_max, new_mid))
        return torch.where(rng == 0.0, 0.0, out)

    return remap(r), remap(g), remap(b)


def blend_mix(cbr, cbg, cbb, csr, csg, csb, mode):
    """Mix two separated RGB colors; `mode` is the mix id (int or
    tensor). An id outside the table mixes as MIX_NORMAL."""
    mode = torch.as_tensor(mode, device=cbr.device)

    def mix3(f):
        return f(cbr, csr), f(cbg, csg), f(cbb, csb)

    outs = {
        MIX_MULTIPLY: mix3(lambda cb, cs: cb * cs),
        MIX_SCREEN: mix3(_screen),
        MIX_OVERLAY: mix3(lambda cb, cs: _hard_light(cs, cb)),
        MIX_DARKEN: mix3(torch.minimum),
        MIX_LIGHTEN: mix3(torch.maximum),
        MIX_COLOR_DODGE: mix3(_color_dodge),
        MIX_COLOR_BURN: mix3(_color_burn),
        MIX_HARD_LIGHT: mix3(_hard_light),
        MIX_SOFT_LIGHT: mix3(_soft_light),
        MIX_DIFFERENCE: mix3(lambda cb, cs: torch.abs(cb - cs)),
        MIX_EXCLUSION: mix3(lambda cb, cs: cb + cs - 2.0 * cb * cs),
    }
    sat_cb = _sat3(cbr, cbg, cbb)
    sat_cs = _sat3(csr, csg, csb)
    lum_cb = _lum3(cbr, cbg, cbb)
    lum_cs = _lum3(csr, csg, csb)
    outs[MIX_HUE] = _set_lum(*_set_sat(csr, csg, csb, sat_cb), lum_cb)
    outs[MIX_SATURATION] = _set_lum(*_set_sat(cbr, cbg, cbb, sat_cs), lum_cb)
    outs[MIX_COLOR] = _set_lum(csr, csg, csb, lum_cb)
    outs[MIX_LUMINOSITY] = _set_lum(cbr, cbg, cbb, lum_cs)

    rr, rg, rb = csr, csg, csb
    for m, (r, g, b) in outs.items():
        sel = mode == m
        rr = torch.where(sel, r, rr)
        rg = torch.where(sel, g, rg)
        rb = torch.where(sel, b, rb)
    return rr, rg, rb


# Porter-Duff factors (fa on the source, fb on the backdrop) per compose
# mode, as functions of the backdrop alpha ab and the source alpha as_.
_ONE = lambda ab, as_: torch.ones_like(ab)  # noqa: E731
_ZERO = lambda ab, as_: torch.zeros_like(ab)  # noqa: E731
_AB = lambda ab, as_: ab  # noqa: E731
_AS = lambda ab, as_: as_  # noqa: E731
_INV_AB = lambda ab, as_: 1.0 - ab  # noqa: E731
_INV_AS = lambda ab, as_: 1.0 - as_  # noqa: E731
_FACTORS = {
    COMPOSE_COPY: (_ONE, _ZERO),
    COMPOSE_DEST: (_ZERO, _ONE),
    COMPOSE_SRC_OVER: (_ONE, _INV_AS),
    COMPOSE_DEST_OVER: (_INV_AB, _ONE),
    COMPOSE_SRC_IN: (_AB, _ZERO),
    COMPOSE_DEST_IN: (_ZERO, _AS),
    COMPOSE_SRC_OUT: (_INV_AB, _ZERO),
    COMPOSE_DEST_OUT: (_ZERO, _INV_AS),
    COMPOSE_SRC_ATOP: (_AB, _INV_AS),
    COMPOSE_DEST_ATOP: (_INV_AB, _AS),
    COMPOSE_XOR: (_INV_AB, _INV_AS),
    COMPOSE_PLUS: (_ONE, _ONE),
}


def blend_compose(cbr, cbg, cbb, csr, csg, csb, ab, as_, mode):
    """Porter-Duff composition of separated colors; the result is
    premultiplied. A mode outside the table (CLEAR included) gives
    zero factors."""
    mode = torch.as_tensor(mode, device=ab.device)
    fa = torch.zeros_like(ab)
    fb = torch.zeros_like(ab)
    for m, (f_a, f_b) in _FACTORS.items():
        sel = mode == m
        fa = torch.where(sel, f_a(ab, as_), fa)
        fb = torch.where(sel, f_b(ab, as_), fb)
    as_fa = as_ * fa
    ab_fb = ab * fb
    co_r = as_fa * csr + ab_fb * cbr
    co_g = as_fa * csg + ab_fb * cbg
    co_b = as_fa * csb + ab_fb * cbb
    co_a = torch.clamp(as_fa + ab_fb, max=1.0)
    pl = mode == COMPOSE_PLUS_LIGHTER
    co_r = torch.where(pl, torch.clamp(as_ * csr + ab * cbr, max=1.0), co_r)
    co_g = torch.where(pl, torch.clamp(as_ * csg + ab * cbg, max=1.0), co_g)
    co_b = torch.where(pl, torch.clamp(as_ * csb + ab * cbb, max=1.0), co_b)
    co_a = torch.where(pl, torch.clamp(as_ + ab, max=1.0), co_a)
    return co_r, co_g, co_b, co_a


def blend_mix_compose(bg, src, mode):
    """Mix and compose premultiplied RGBA tuples (r, g, b, a) under the
    packed word `mode` = (mix << 8) | compose (int or tensor). Mix NORMAL
    or CLIP with SRC_OVER (word & 0x7FFF == 0) is plain src-over."""
    bgr, bgg, bgb, bga = bg
    sr, sg, sb, sa = src
    mode = torch.as_tensor(mode, device=sa.device)
    fast = (mode & 0x7FFF) == BLEND_DEFAULT
    f_r = bgr * (1.0 - sa) + sr
    f_g = bgg * (1.0 - sa) + sg
    f_b = bgb * (1.0 - sa) + sb
    f_a = bga * (1.0 - sa) + sa

    inv_sa = rdiv(1.0, torch.clamp(sa, min=EPSILON))
    csr, csg, csb = sr * inv_sa, sg * inv_sa, sb * inv_sa
    inv_ba = rdiv(1.0, torch.clamp(bga, min=EPSILON))
    cbr, cbg, cbb = bgr * inv_ba, bgg * inv_ba, bgb * inv_ba
    mr, mg, mb = blend_mix(cbr, cbg, cbb, csr, csg, csb, shr(mode, 8))
    csr = csr + (mr - csr) * bga
    csg = csg + (mg - csg) * bga
    csb = csb + (mb - csb) * bga
    compose_mode = mode & 0xFF
    # SRC_OVER after mixing: the premultiplied backdrop toward the mixed
    # separated source by the source alpha (blend.wgsl:304-306).
    so_r = bgr + (csr - bgr) * sa
    so_g = bgg + (csg - bgg) * sa
    so_b = bgb + (csb - bgb) * sa
    so_a = sa + bga * (1.0 - sa)
    gc_r, gc_g, gc_b, gc_a = blend_compose(cbr, cbg, cbb, csr, csg, csb, bga, sa,
                                           compose_mode)
    srcover = compose_mode == COMPOSE_SRC_OVER
    s_r = torch.where(srcover, so_r, gc_r)
    s_g = torch.where(srcover, so_g, gc_g)
    s_b = torch.where(srcover, so_b, gc_b)
    s_a = torch.where(srcover, so_a, gc_a)
    return (torch.where(fast, f_r, s_r), torch.where(fast, f_g, s_g),
            torch.where(fast, f_b, s_b), torch.where(fast, f_a, s_a))
