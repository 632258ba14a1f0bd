"""The harness on the CPU, at tiny cells added by data alone: the result
line's keys, a configuration, a traffic mix and a metric found by name,
and the modules a run loads."""

import json
import subprocess
import sys
import textwrap

import pytest

from portbench import harness, spec

from portbench_helpers import BENCH, ROOT

SEED = 2 ** 31 + 11


@pytest.mark.parametrize("trace", [False, True])
def test_portbench_result_line_keys(tiny, trace):
    bench_dir, bench = tiny
    result, lines = harness.run_cell("tiny_tiger_text.static", SEED, 0.3, trace, "cpu",
                                     bench_dir=bench_dir)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    listed = {m["name"] for m in spec.cell_metrics(bench, "tiny_tiger_text.static", trace)}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # On the CPU the trace holds no device operation: only the host span.
        assert set(result["metrics"]) <= listed
    else:
        assert set(result["metrics"]) == listed == {
            "frames_per_s", "frame_ms_p95", "gpu_reserved_mib", "setup_s"}
    assert [line.split(":")[0] for line in lines[-len(result["checks"]):]] == [
        f"check {k}" for k in result["checks"]]
    json.dumps(result, allow_nan=False)


def test_portbench_finds_new_files_by_name(tiny):
    """A configuration, a traffic mix and a metric added as files of their
    own, and entries in BENCHMARK.json, with no other file edited."""
    bench_dir, bench = tiny
    cfg = json.loads((bench_dir / "configs" / "tiny_clip_layers.json").read_text())
    (bench_dir / "configs" / "tmp_scene.json").write_text(json.dumps(dict(cfg, n_stacks=2)))
    (bench_dir / "configs" / "tmp_scene.py").write_text(
        (bench_dir / "configs" / "clip_layers.py").read_text())
    (bench_dir / "traffic" / "tmp_mix.json").write_text(json.dumps(
        {"scene": "append", "in_flight": 3, "warmup_frames": 4, "trace_frames": 2,
         "sample_frames": 2, "motion": {"radius_px": 5, "period_frames": 4}}))
    (bench_dir / "metrics" / "tmp_metric.py").write_text(textwrap.dedent('''
        def read(ctx):
            return 1000.0 + ctx["frames_ok"]
        '''))
    bench["configs"].append({"name": "tmp_scene", "source": "test",
                             "file": "benchmark/configs/tmp_scene.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tmp_scene.tmp_mix", "config": "tmp_scene",
                               "traffic": "tmp_mix", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "tmp_metric", "unit": "x", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tmp_scene.tmp_mix"]})
    (bench_dir.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run_cell("tmp_scene.tmp_mix", SEED, 0.3, False, "cpu",
                                 bench_dir=bench_dir)
    assert result["correct"] is True
    assert result["metrics"]["tmp_metric"]["value"] > 1000.0
    # The new metric is only in the cell its entry names.
    other, _ = harness.run_cell("tiny_clip_layers.static", SEED, 0.3, False, "cpu",
                                bench_dir=bench_dir)
    assert "tmp_metric" not in other["metrics"]


CHILD = textwrap.dedent('''
    import json, sys
    sys.path[:0] = [{bench!r}, {root!r}]
    import torch
    torch.set_num_threads(2)
    sys.argv = ["run.py"]
    import run
    {body}
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    ''')


def _child_modules(body, tiny_dir):
    code = CHILD.format(bench=str(tiny_dir), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_portbench_runs_load_no_jax(tiny):
    """A whole run (harness, program, reference) loads none of jax, jaxlib,
    flax or jello_tpu, compared by whole top-level names."""
    bench_dir, _ = tiny
    body = ("from portbench import harness\n"
            "res, _ = harness.run_cell('tiny_tiger_text.pan', 5, 0.2, False, 'cpu', "
            f"bench_dir=__import__('pathlib').Path({str(bench_dir)!r}))\n"
            "assert res['correct'], res\n")
    mods = _child_modules(body, bench_dir)
    assert "jello_tpu_torch" in mods and "portbench_reference" in mods
    assert not mods & {"jax", "jaxlib", "flax", "jello_tpu"}


def test_portbench_reference_loads_nothing_of_the_program(tiny):
    bench_dir, _ = tiny
    body = textwrap.dedent(f'''
        from pathlib import Path
        from portbench import compare, spec
        cfg, gen = spec.config("tiny_tiger_text", Path({str(bench_dir)!r}))
        ref = compare.Reference(Path({str(bench_dir)!r}), gen.commands(cfg, 3), "cpu")
        assert ref.frame(None).shape == (cfg["height"], cfg["width"], 4)
        ''')
    mods = _child_modules(body, bench_dir)
    assert "portbench_reference" in mods
    assert not mods & {"jax", "jaxlib", "flax", "jello_tpu", "jello_tpu_torch"}


def test_portbench_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "tiger_text.static", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
