"""Entry points of the port: one single-device frame, and a
multi-device dry run.

Counterpart of `__graft_entry__.py` (`entry`, `dryrun_multichip`).
"""

from __future__ import annotations


def entry(device="cuda"):
    """(fn, example_args) of one config 1 frame on `device`:
    fn(scene, layout, ramps) -> the fine output (compact rows and
    tile2rank; `cuda.render.assemble` takes it and the layout) through
    `pipeline/render.py::render_frame`, at the estimated class on the
    renderer's routing (`__graft_entry__.py::entry`)."""
    from .cuda.fine_v2 import fine_v2
    from .cuda.render import build_layout_dict, frame_routing, upload
    from .pipeline.gradient import stops_table_or_empty
    from .pipeline.render import render_frame
    from .renderer.estimate import estimate_caps_from_scene
    from .renderer.resolve import Resolver
    from .scenes import config1

    scene, params = config1()
    layout, ramps, _, scene_u32 = Resolver().resolve(scene.encoding)
    caps = dict(estimate_caps_from_scene(scene_u32, layout, params.width, params.height),
                **frame_routing(layout.n_clips, False, 0))
    args = upload(scene_u32, build_layout_dict(layout, params), stops_table_or_empty(ramps),
                  {}, device)[:3]

    def fn(scene, layout, ramps):
        return render_frame(scene, layout, ramps, None, caps, fine_v2)[0]

    return fn, args


def dryrun_multichip(n, device="cuda", backend="nccl"):
    """Render the geometry-sharded dry run (`cuda/sharded2.py::dryrun`
    with its full-profile scene through the image tap) on n ranks, each
    in its own process, a raised flag retried with the ranks that raised
    it grown; raises if a rank fails, a flag stays raised or the frame
    leaves the single-device one (`__graft_entry__.py::dryrun_multichip`).
    Several ranks on one card need backend "gloo"."""
    from .cuda.sharded2 import dryrun

    err = dryrun(n, device, backend, full_profile=True, image_tap=True)
    print(f"dryrun_multichip({n}, {device}, {backend}): ok, max abs difference from the "
          f"single-device frame {err:.2e}")
    return err
