"""A cut of config 5 (300 of its 10,000 paths, at its full 1920x1080
canvas) through jello_tpu_torch against the numpy oracle: long fills,
thin round-capped strokes, even-odd glyphs, gradients and image paints
in one frame, within 2e-3 and with no flag. In a file of its own: the
oracle takes over a minute at this canvas."""

from jello_tpu_torch.cuda import Renderer

from .torch_reference import check_frame


def _config5_300(jt):
    return jt.scenes.config5(n_paths=300)


def test_torch_renderer_reduced_config5_matches_oracle():
    import jello_tpu.scenes  # noqa: F401  (check_frame builds through both packages)
    import jello_tpu_torch.scenes  # noqa: F401

    r = Renderer(device="cpu")
    check_frame(r, _config5_300)
    assert r.last_stats["img_recs"] > 0 and r.last_stats["work_b"] > 0
    assert r.last_stats["arc_lines"] > 0
    assert r._caps["img_recs_cap"] >= r.last_stats["img_recs"]
