"""Config 2 (100 stroked cubic chains with every cap and join, dashes on
one in four, 512x512) through jello_tpu_torch: the host half against
jello_tpu's, and the frame against the numpy oracle within 2e-3. The
scene is built once per package and shared: its dashes are flattened in
Python on the host."""

from jello_tpu_torch.cuda import Renderer

from .test_torch_host import check_host_half
from .test_torch_sharded import check_shard_caps
from .torch_reference import check_frame, config2_both


def test_torch_config2_host_half_matches_jello_tpu():
    check_host_half(*config2_both())


def test_torch_config2_frame_matches_oracle():
    r = Renderer(device="cpu")
    check_frame(r, config2_both, tol=2e-3)
    assert r.last_stats["work_b"] > 0 and r.last_stats["arc_lines"] > 0
    assert r.last_stats["simple_lines"] > 0  # the dashes' line segments


def test_torch_config2_shard_caps_match_jello_tpu():
    """`cuda/sharded2.py::shard_caps` on config 2's estimated class equals
    jello_tpu's (the other gate scenes: tests/test_torch_sharded.py)."""
    check_shard_caps(*config2_both()[1])
