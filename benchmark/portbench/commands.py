"""Draw commands -> a Scene of a renderer's API.

A configuration's generator (`configs/<name>.py::commands`) returns the
scene as plain data: {"width", "height", "base_color", "antialiasing",
"images": [u8 [h, w, 4] arrays], "draws": [...]}, each draw one of

  ("fill", "nonzero" | "evenodd", transform or None, brush, path)
  ("stroke", {"width", "join", "cap"}, transform or None, brush, path)
  ("push", mix name, alpha, clip path)       a clip layer, src-over compose
  ("pop",)

with a transform the six affine coefficients (xx, yx, xy, yy, x0, y0), a
path a list of ("M", x, y), ("L", x, y), ("C", x1, y1, x2, y2, x3, y3),
("Z",), and a brush ("solid", rgba), ("linear", p0, p1, stops), ("radial",
centre, radius, stops) or ("image", index into images); stops are
(offset, rgba) pairs. `build` replays the list through the public API of
a module that has the program's names (`jello_tpu_torch`, or the
reference package), so the program and the reference each encode the same
input themselves.
"""

from __future__ import annotations


def _path(api, elements):
    p = api.BezPath()
    for el in elements:
        verb = el[0]
        if verb == "M":
            p.move_to(*el[1:])
        elif verb == "L":
            p.line_to(*el[1:])
        elif verb == "C":
            p.cubic_to(*el[1:])
        elif verb == "Z":
            p.close()
        else:
            raise ValueError(f"unknown path verb {verb!r}")
    return p


def _brush(api, brush, images):
    kind = brush[0]
    if kind == "solid":
        return api.SolidBrush(api.Color.rgba(*brush[1]))
    if kind == "image":
        return api.ImageBrush(images[brush[1]])
    stops = tuple(api.ColorStop(off, api.Color.rgba(*rgba)) for off, rgba in brush[-1])
    if kind == "linear":
        return api.GradientBrush(api.LinearGradient(tuple(brush[1]), tuple(brush[2]), stops))
    if kind == "radial":
        c = tuple(brush[1])
        return api.GradientBrush(api.RadialGradient(c, 0.0, c, brush[2], stops))
    raise ValueError(f"unknown brush {kind!r}")


def _affine(api, coeffs):
    return api.Affine.identity() if coeffs is None else api.Affine(tuple(map(float, coeffs)))


def build(api, cmds):
    """A new `api.Scene` holding `cmds["draws"]`."""
    scene = api.Scene()
    images = [api.Image(pixels=px) for px in cmds["images"]]
    rules = {"nonzero": api.Fill.NON_ZERO, "evenodd": api.Fill.EVEN_ODD}
    for d in cmds["draws"]:
        op = d[0]
        if op == "fill":
            _, rule, xf, brush, path = d
            scene.fill(rules[rule], _affine(api, xf), _brush(api, brush, images), None,
                       _path(api, path))
        elif op == "stroke":
            _, style, xf, brush, path = d
            stroke = api.Stroke(width=style["width"], join=api.Join[style["join"].upper()],
                                start_cap=api.Cap[style["cap"].upper()],
                                end_cap=api.Cap[style["cap"].upper()])
            scene.stroke(stroke, _affine(api, xf), _brush(api, brush, images), None,
                         _path(api, path))
        elif op == "push":
            _, mix, alpha, clip = d
            blend = api.BlendMode(api.Mix[mix.upper()], api.Compose.SRC_OVER)
            scene.push_layer(blend, alpha, api.Affine.identity(), _path(api, clip))
        elif op == "pop":
            scene.pop_layer()
        else:
            raise ValueError(f"unknown draw {op!r}")
    return scene


def params(api, cmds):
    """The `api.RenderParams` of the scene's target."""
    return api.RenderParams(width=cmds["width"], height=cmds["height"],
                            base_color=api.Color.rgba(*cmds["base_color"]),
                            antialiasing_method=api.AaConfig(cmds["antialiasing"]))
